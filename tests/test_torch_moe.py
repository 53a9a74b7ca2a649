"""The port's MoE layer and moe family (repro_torch.models.moe, the moe
branch of repro_torch.models.lm, ServeEngine) against the JAX reference,
on the CPU.

Weights are the reference's own ``Model.init`` trees for ``reduced``
phi3.5-moe-42b-a6.6b and qwen3-moe-235b-a22b (2 layers, d 128, 4 experts
of 128, top-2), converted with ``lm_params_from_reference``, under both
``moe_impl`` values.  Limits, as the largest absolute gap over the
reference's largest magnitude:

* float32 within 1e-4, with every routing decision (each token's experts,
  in choice order) equal to the reference's;
* bfloat16 within 5e-2, with the port's routing pinned to the reference's
  decisions (the router is discrete: a decision flipped by a rounding
  difference moves a token by O(1)), and the port's own decisions equal
  to the reference's except at a near-tie.  The gates are a bf16 product
  rounded to bf16 before the softmax, so their resolution is set by the
  product's inputs, not by the probabilities: one bf16 ulp (at most 2^-7
  relative) of every input of gate e moves it by up to
  2^-7 * A_e, A_e = sum_d |x_d| |router_de|.  A near-tie is where the
  reference's gates of two adjacent choices (in its order, among the
  first k + 1) differ by less than 2^-7 (A_i + A_j).  Any other flip
  fails, and every difference of two of the port's gates (the log of a
  ratio of its probabilities) must agree with the reference's within the
  same resolution.

The reference's routing inputs are read by wrapping
``repro.models.moe.apply_moe`` with jit off (``jax.disable_jit``, remat
"none": a training setting that changes no value), so the wrapper sees
concrete arrays.  Greedy tokens and engine stats must equal the
reference engine's, run in a child interpreter (``repro.serve`` needs the
``enable_x64`` alias).
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import build_model, param_layout
from repro_torch.models import moe as MOE
from repro_torch.serve import Request, ServeEngine
from torch_reference import run_reference

ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b")
IMPLS = ("einsum", "scatter")
LIMIT = {"float32": 1e-4, "bfloat16": 5e-2}
BF16_REL = 2.0 ** -7                  # a bf16 ulp, relative, at most
PROMPT, MAX_LEN, DECODE_STEPS = 24, 40, 6
NEW_TOKENS = [5, 8, 3, 6, 4, 7]          # 6 requests: waves of 4 and 2


def _cfgs(arch, dtype="float32", impl="einsum", **moe):
    """(reference config, port config), equal field for field."""
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced

    def make(get, red):
        c = red(get(arch))
        if moe:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
        return dataclasses.replace(c, dtype=dtype, moe_impl=impl,
                                   remat="none")
    return make(jget, jreduced), make(get_config, reduced)


@pytest.fixture(scope="module")
def ref_trees():
    """arch -> the reference's parameter tree (numpy), drawn lazily."""
    import jax
    from repro.models import build_model as jbuild
    trees = {}

    def get(arch, **moe):
        key = (arch, tuple(sorted(moe.items())))
        if key not in trees:
            jcfg, _ = _cfgs(arch, **moe)
            trees[key] = jax.tree.map(
                np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
        return trees[key]
    return get


def _gap(got, want) -> float:
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _choice(probs, k):
    """The reference's decision from its probabilities: the k largest,
    the lower index first among equal ones (``jax.lax.top_k``)."""
    return np.argsort(-probs, axis=-1, kind="stable")[..., :k]


def _near_tie(call, k):
    """Per token: whether two adjacent choices of the reference (in its
    order, among the first k + 1) have gates within bf16 resolution."""
    order = np.argsort(-call["probs"], axis=-1, kind="stable")[..., :k + 1]
    g = np.take_along_axis(call["gates"], order, axis=-1)
    res = BF16_REL * np.take_along_axis(call["reach"], order, axis=-1)
    return np.any(g[..., :-1] - g[..., 1:] < res[..., :-1] + res[..., 1:],
                  axis=-1)


@contextlib.contextmanager
def _reference_routing():
    """Every reference ``apply_moe`` call's router inputs, in call order,
    computed as ``apply_moe`` computes them: "gates" and "probs" (G, S, E)
    and "reach", sum_d |x_d| |router_de| (numpy float32)."""
    import jax
    import jax.numpy as jnp
    import repro.models.moe as JMOE
    real = JMOE.apply_moe
    calls = []

    def spy(p, x, cfg):
        router = JMOE.cast(p["router"], x.dtype)
        gates = jnp.einsum("gsd,de->gse", x, router).astype(jnp.float32)
        calls.append({
            "gates": np.asarray(gates),
            "probs": np.asarray(jax.nn.softmax(gates, axis=-1)),
            "reach": np.abs(np.asarray(x, np.float32))
            @ np.abs(np.asarray(router, np.float32))})
        return real(p, x, cfg)
    JMOE.apply_moe = spy
    try:
        with jax.disable_jit():
            yield calls
    finally:
        JMOE.apply_moe = real


@contextlib.contextmanager
def _port_routing(pinned=None):
    """The port's own routing, in call order: (probabilities, decision) as
    numpy; with ``pinned`` (one decision array per call) the model runs
    those instead."""
    real = MOE.route
    own = []
    it = iter(pinned or ())

    def spy(probs, top_k):
        idx = real(probs, top_k)
        own.append((probs.cpu().numpy(), idx.cpu().numpy()))
        if pinned is None:
            return idx
        want = next(it)
        assert want.shape == tuple(idx.shape)
        return torch.from_numpy(want)
    MOE.route = spy
    try:
        yield own
    finally:
        MOE.route = real


def _check_routing(ref, own, k, dtype):
    """f32: every decision equal.  bf16: a differing decision only at a
    near-tie, and the port's gate differences within bf16 resolution of
    the reference's."""
    assert len(own) == len(ref)
    for n, (call, (probs, idx)) in enumerate(zip(ref, own)):
        want = _choice(call["probs"], k)
        assert idx.shape == want.shape
        flipped = np.any(idx != want, axis=-1)
        if dtype == "float32":
            assert not flipped.any(), n
            continue
        assert not (flipped & ~_near_tie(call, k)).any(), n
        lp, g, res = np.log(probs), call["gates"], BF16_REL * call["reach"]
        off = np.abs((lp[..., :, None] - lp[..., None, :])
                     - (g[..., :, None] - g[..., None, :]))
        assert (off < res[..., :, None] + res[..., None, :]).all(), n


def _run_reference(jcfg, tree, toks, prefill_len=None):
    """Reference forward + loss (and, with ``prefill_len``, prefill then
    decode of the rest one token at a time) with its routing recorded."""
    import jax.numpy as jnp
    from repro.models import build_model as jbuild
    model = jbuild(jcfg)
    out = {}
    with _reference_routing() as calls:
        if prefill_len is None:
            batch = {"tokens": jnp.asarray(toks)}
            out["logits"], (out["aux"], _, _) = model.forward(tree, batch)
            out["loss"], m = model.loss(tree, batch)
            out["ce"], out["aux_loss"] = m["ce"], m["aux"]
        else:
            cache, logits = model.prefill(
                tree, {"tokens": jnp.asarray(toks[:, :prefill_len])},
                max_len=toks.shape[1])
            out["prefill"] = (logits, cache["k"], cache["v"])
            for n in range(prefill_len, toks.shape[1]):
                cache, logits = model.decode(tree, cache,
                                             jnp.asarray(toks[:, n:n + 1]))
                out[f"decode{n}"] = (logits, cache["k"], cache["v"])
    return out, calls


def _run_port(cfg, params, toks, prefill_len=None, pinned=None):
    model = build_model(cfg, device="cpu")
    out = {}
    with _port_routing(pinned) as own, torch.inference_mode():
        if prefill_len is None:
            batch = {"tokens": torch.from_numpy(toks)}
            out["logits"], (out["aux"], _, _) = model.forward(params, batch)
            out["loss"], m = model.loss(params, batch)
            out["ce"], out["aux_loss"] = m["ce"], m["aux"]
        else:
            cache, logits = model.prefill(
                params, {"tokens": torch.from_numpy(toks[:, :prefill_len])},
                max_len=toks.shape[1])
            assert cache["len"] == prefill_len
            out["prefill"] = (logits, cache["k"].clone(), cache["v"].clone())
            for n in range(prefill_len, toks.shape[1]):
                nt = torch.from_numpy(toks[:, n:n + 1])
                cache, logits = model.decode(params, cache, nt)
                out[f"decode{n}"] = (logits, cache["k"].clone(),
                                     cache["v"].clone())
    return out, own


def _assert_close(out, ref, limit):
    assert sorted(out) == sorted(ref)
    for key in ref:
        pairs = zip(out[key], ref[key]) if isinstance(ref[key], tuple) \
            else [(out[key], ref[key])]
        for got, want in pairs:
            assert tuple(got.shape) == tuple(np.shape(want)), key
            assert _gap(got, want) <= limit, (key, _gap(got, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(ref_trees, arch, impl, dtype):
    """Logits, the balance loss summed over layers, the loss and its ce
    and aux on 2 x 32 tokens."""
    jcfg, cfg = _cfgs(arch, dtype, impl)
    tree = ref_trees(arch)
    params = lm_params_from_reference(tree, cfg, device="cpu")
    toks = _tokens(2, (2, 32), cfg.vocab_size)
    ref, calls = _run_reference(jcfg, tree, toks)
    pinned = None if dtype == "float32" else [
        _choice(c["probs"], cfg.moe.top_k) for c in calls]
    out, own = _run_port(cfg, params, toks, pinned=pinned)
    _check_routing(calls, own, cfg.moe.top_k, dtype)
    assert len(own) == 2 * cfg.num_layers            # forward, then loss
    _assert_close(out, ref, LIMIT[dtype])
    assert float(out["aux"]) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(ref_trees, arch, impl, dtype):
    """Prefill logits and the K/V cache, then decode steps (logits and
    cache); decode routes each token alone (capacity 1, no drops)."""
    jcfg, cfg = _cfgs(arch, dtype, impl)
    tree = ref_trees(arch)
    params = lm_params_from_reference(tree, cfg, device="cpu")
    toks = _tokens(1, (2, PROMPT + DECODE_STEPS), cfg.vocab_size)
    ref, calls = _run_reference(jcfg, tree, toks, prefill_len=PROMPT)
    pinned = None if dtype == "float32" else [
        _choice(c["probs"], cfg.moe.top_k) for c in calls]
    out, own = _run_port(cfg, params, toks, prefill_len=PROMPT,
                         pinned=pinned)
    _check_routing(calls, own, cfg.moe.top_k, dtype)
    assert len(own) == cfg.num_layers * (1 + DECODE_STEPS)
    _assert_close(out, ref, LIMIT[dtype])


def test_shared_experts_match_reference(ref_trees):
    """``n_shared_experts=1``: the ``shared`` SwiGLU every token passes
    through, in the tree and in the forward (f32, both paths)."""
    arch = ARCHS[0]
    tree = ref_trees(arch, n_shared_experts=1)
    assert set(tree["layers"]["moe"]["shared"]) == {"wi", "wg", "wo"}
    toks = _tokens(3, (2, 16), 512)
    for impl in IMPLS:
        jcfg, cfg = _cfgs(arch, "float32", impl, n_shared_experts=1)
        params = lm_params_from_reference(tree, cfg, device="cpu")
        ref, calls = _run_reference(jcfg, tree, toks)
        out, own = _run_port(cfg, params, toks)
        _check_routing(calls, own, cfg.moe.top_k, "float32")
        _assert_close(out, ref, LIMIT["float32"])


def _layer_inputs(seed, e=4, d=128, f=128, act="swiglu", tie=False):
    """x (2, 16, d) and one layer's MoE params as numpy.  With ``tie``,
    x and the router hold small integers (exact dot products in any
    order and dtype), router columns 1-3 equal: experts 1, 2, 3 tie
    exactly on every token; column 0 is column 1 plus one at dim 0, so
    expert 0 ties with them too where x's dim 0 is 0, and leads or trails
    by 1 elsewhere."""
    rng = np.random.default_rng(seed)
    if tie:
        x = rng.integers(-1, 2, (2, 16, d)).astype(np.float32)
        col1 = rng.integers(-1, 2, d).astype(np.float32)
        col0 = col1.copy()
        col0[0] += 1.0
        router = np.stack([col0, col1, col1, col1], axis=1)[:, :e]
    else:
        x = rng.standard_normal((2, 16, d), np.float32)
        router = rng.standard_normal((d, e), np.float32) / np.sqrt(d)
    p = {"router": router,
         "wi": rng.standard_normal((e, d, f), np.float32) / np.sqrt(d),
         "wo": rng.standard_normal((e, f, d), np.float32) / np.sqrt(f)}
    if act == "swiglu":
        p["wg"] = rng.standard_normal((e, d, f), np.float32) / np.sqrt(d)
    return x, p


def _apply_both(x, p, cfg, jcfg, dtype):
    """(port, reference) apply_moe outputs and balance losses."""
    import jax.numpy as jnp
    from repro.models import moe as JMOE
    tdt = getattr(torch, dtype)
    y, aux = MOE.apply_moe({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x).to(tdt), cfg)
    jy, jaux = JMOE.apply_moe({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x).astype(jnp.dtype(dtype)), jcfg)
    return (y, aux), (np.asarray(jy, np.float32), float(jaux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_exact_ties_pick_the_lower_index_first(impl, dtype):
    """Experts 1-3 tie exactly on every token: each token takes (1, 2),
    or (0, 1) where expert 0 leads or ties, never expert 3, as the
    reference does; every expert's weights differ, so another pick would
    move the output by O(1)."""
    jcfg, cfg = _cfgs(ARCHS[0], dtype, impl)
    x, p = _layer_inputs(5, tie=True)
    with _port_routing() as own:
        (y, aux), (jy, jaux) = _apply_both(x, p, cfg, jcfg, dtype)
    gates = x @ p["router"]
    want = np.where((gates[..., 0] >= gates[..., 1])[..., None],
                    np.array([0, 1]), np.array([1, 2]))
    np.testing.assert_array_equal(own[0][1], want)
    assert (gates[..., 0] == gates[..., 1]).any()       # a four-way tie too
    assert _gap(y, jy) <= LIMIT[dtype]
    assert abs(float(aux) - jaux) <= LIMIT[dtype] * abs(jaux)
    probs = torch.tensor([[[0.3, 0.3, 0.4, 0.3]]])
    assert MOE.route(probs, 3).tolist() == [[[2, 0, 1]]]   # lax.top_k's


@pytest.mark.parametrize("impl", IMPLS)
def test_choices_past_capacity_are_dropped(impl):
    """Every token's first choice is expert 0 and its second expert 1:
    capacity ceil(16 * 2 * 1.25 / 4) = 10, so tokens 10-15 lose both
    choices (output exactly 0) and the rest keep both, as in the
    reference; the dropped choices still count in the balance loss."""
    jcfg, cfg = _cfgs(ARCHS[0], "float32", impl)
    x, p = _layer_inputs(6)
    x = np.abs(x) + 0.1
    p["router"] = np.zeros_like(p["router"])
    p["router"][:, 0], p["router"][:, 1] = 1.0, 0.5
    assert MOE.capacity(cfg, 16) == 10
    with _port_routing() as own:
        (y, aux), (jy, jaux) = _apply_both(x, p, cfg, jcfg, "float32")
    assert (own[0][1] == np.array([0, 1])).all()
    assert float(y[:, 10:].abs().max()) == 0.0
    assert float(y[:, :10].abs().min(dim=-1).values.max()) > 0
    assert _gap(y, jy) <= LIMIT["float32"]
    assert abs(float(aux) - jaux) <= 1e-6 * jaux
    np.testing.assert_allclose(float(aux), 2.0, rtol=1e-3)  # all on 0 and 1


@pytest.mark.parametrize("impl", IMPLS)
def test_gelu_experts_match_reference(impl):
    jcfg, cfg = _cfgs(ARCHS[0], "float32", impl)
    jcfg, cfg = (dataclasses.replace(c, act="gelu") for c in (jcfg, cfg))
    x, p = _layer_inputs(7, act="gelu")
    (y, aux), (jy, jaux) = _apply_both(x, p, cfg, jcfg, "float32")
    assert _gap(y, jy) <= LIMIT["float32"]
    assert abs(float(aux) - jaux) <= 1e-6 * jaux


@pytest.mark.parametrize("act,shared", [("swiglu", 0), ("swiglu", 2),
                                        ("gelu", 0)])
def test_layout_matches_reference_init(act, shared):
    """``layout_moe`` against ``init_moe``'s shapes, and each leaf's
    init scale (the leading dim is the fan-in: E for stacked experts)."""
    import jax
    from repro.models import moe as JMOE
    jcfg, cfg = (dataclasses.replace(
        c, act=act, moe=dataclasses.replace(c.moe, n_shared_experts=shared))
        for c in _cfgs(ARCHS[0]))
    want = jax.eval_shape(lambda k: JMOE.init_moe(k, jcfg),
                          jax.random.PRNGKey(0))

    def shapes(layout):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v[0])
                for k, v in layout.items()}
    assert shapes(MOE.layout_moe(cfg)) == jax.tree.map(
        lambda a: tuple(a.shape), want)


@pytest.mark.parametrize("tokens", [1, 7, 16, 100, 2048])
@pytest.mark.parametrize("arch", ARCHS + ("phi3.5-moe-42b-a6.6b-full",))
def test_capacity_matches_reference(arch, tokens):
    from repro.configs import get_config as jget
    from repro.models import moe as JMOE
    name = arch.removesuffix("-full")
    if arch.endswith("-full"):
        jcfg, cfg = jget(name), get_config(name)
    else:
        jcfg, cfg = _cfgs(name)
    assert MOE.capacity(cfg, tokens) == JMOE.capacity(jcfg, tokens)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_last_logits_equal_forward_without_drops(ref_trees, arch,
                                                         impl):
    """The port's ``tests/test_models.py:83-98``: capacity factor 8 (no
    drops), prefill of 31 tokens gives forward's logits at position 30."""
    _, cfg = _cfgs(arch, "float32", impl, capacity_factor=8.0)
    params = lm_params_from_reference(ref_trees(arch), cfg, device="cpu")
    model = build_model(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(4, (2, 32), cfg.vocab_size))
    with torch.inference_mode():
        logits, _ = model.forward(params, {"tokens": toks})
        _, last = model.prefill(params, {"tokens": toks[:, :31]}, max_len=32)
    np.testing.assert_allclose(last.numpy(), logits[:, 30].numpy(),
                               atol=1e-3)


def test_param_layout_matches_reference_tree(ref_trees):
    """Same keys and shapes as the reference's init, reduced and (shapes
    only) at full width, for both MoE configs."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    def shapes(layout):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v[0])
                for k, v in layout.items()}
    for arch in ARCHS:
        _, cfg = _cfgs(arch)
        assert shapes(param_layout(cfg)) == jax.tree.map(
            lambda a: tuple(a.shape), ref_trees(arch))
        full = jax.eval_shape(jbuild(jget(arch)).init, jax.random.PRNGKey(0))
        assert shapes(param_layout(get_config(arch))) == jax.tree.map(
            lambda a: tuple(a.shape), full)


def test_convert_checks_the_moe_tree(ref_trees):
    _, cfg = _cfgs(ARCHS[0])
    tree = ref_trees(ARCHS[0])
    moe = dict(tree["layers"]["moe"])
    del moe["wg"]
    layers = dict(tree["layers"], moe=moe)
    with pytest.raises(ValueError, match="layers/moe has keys"):
        lm_params_from_reference(dict(tree, layers=layers), cfg,
                                 device="cpu")
    moe = dict(tree["layers"]["moe"], router=np.zeros((2, 128, 5)))
    layers = dict(tree["layers"], moe=moe)
    with pytest.raises(ValueError, match="layers/moe/router has shape"):
        lm_params_from_reference(dict(tree, layers=layers), cfg,
                                 device="cpu")
    params = lm_params_from_reference(tree, cfg, device="cpu")
    assert params["layers"]["moe"]["wi"].shape == (2, 4, 128, 128)


def test_init_draws_the_moe_tree():
    _, cfg = _cfgs(ARCHS[0])
    model = build_model(cfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(0))
    b = model.init(torch.Generator().manual_seed(0))
    assert torch.equal(a["layers"]["moe"]["wi"], b["layers"]["moe"]["wi"])
    assert "mlp" not in a["layers"]
    std = a["layers"]["moe"]["wi"].std().item()       # fan-in E = 4
    assert abs(std - 0.5) < 0.05


SERVE_CHILD = r"""
import dataclasses
import jax
import numpy as np
from repro.configs import get_config, reduced
from repro.serve import Request, ServeEngine

OUT["runs"] = []
for arch, impl in PAYLOAD["runs"]:
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              moe_impl=impl)
    params = ServeEngine(cfg, None).model.init(jax.random.PRNGKey(0))
    eng = ServeEngine(cfg, params, batch_slots=PAYLOAD["slots"],
                      max_len=PAYLOAD["max_len"])
    warm = eng.warm(PAYLOAD["warm"])
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(PAYLOAD["prompts"],
                                           PAYLOAD["new"]))]
    out = eng.run(reqs)
    OUT["runs"].append({"tokens": {str(k): v for k, v in out.items()},
                        "stats": eng.stats, "warm": warm})
"""
SERVE_RUNS = [(a, i) for a in ARCHS for i in IMPLS]


@pytest.fixture(scope="module")
def ref_serve():
    prompts = _tokens(3, (len(NEW_TOKENS), 10), 512).tolist()
    got = run_reference(SERVE_CHILD, {
        "runs": SERVE_RUNS, "slots": 4, "max_len": MAX_LEN, "warm": [10],
        "prompts": prompts, "new": NEW_TOKENS})
    return prompts, dict(zip(SERVE_RUNS, got["runs"]))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("run", SERVE_RUNS, ids=lambda r: "-".join(r))
def test_serve_engine_matches_reference(ref_trees, ref_serve, run,
                                        use_kernel):
    prompts, want = ref_serve
    arch, impl = run
    _, cfg = _cfgs(arch, "float32", impl)
    params = lm_params_from_reference(ref_trees(arch), cfg, device="cpu")
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=MAX_LEN,
                      use_kernel=use_kernel, device="cpu")
    warm = eng.warm([10])
    out = eng.run([Request(rid=i, prompt=np.asarray(p, np.int32),
                           max_new_tokens=n)
                   for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS))])
    assert {str(k): v for k, v in out.items()} == want[run]["tokens"]
    assert eng.stats == want[run]["stats"]
    assert warm == want[run]["warm"]


@pytest.mark.cuda
@pytest.mark.parametrize("impl", IMPLS)
def test_cuda_model_matches_the_cpu(impl):
    """On the card, with the flash kernel in each layer's attention: the
    same float32 logits, loss and routing decisions as the CPU's plain
    path, from the same seeded weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    cfg = dataclasses.replace(reduced(get_config(ARCHS[0])), dtype="float32",
                              moe_impl=impl)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(2, (2, 32), cfg.vocab_size))
    got = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        model = build_model(cfg, use_kernel=True, device=dev)
        before = flash_attention_fwd.launches
        with _port_routing() as own, torch.inference_mode():
            logits, _ = model.forward(p, {"tokens": toks.to(dev)})
            loss, _ = model.loss(p, {"tokens": toks.to(dev)})
        got[dev] = (logits.cpu(), loss.cpu(), [i for _, i in own],
                    flash_attention_fwd.launches - before)
    assert got["cpu"][3] == 0 and got["cuda"][3] == 2 * cfg.num_layers
    assert _gap(got["cuda"][0], got["cpu"][0].numpy()) <= LIMIT["float32"]
    assert abs(float(got["cuda"][1] - got["cpu"][1])) <= 1e-4 * abs(
        float(got["cpu"][1]))
    for a, b in zip(got["cuda"][2], got["cpu"][2]):
        np.testing.assert_array_equal(a, b)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}
