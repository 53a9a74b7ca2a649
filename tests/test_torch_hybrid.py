"""The port's hybrid family (zamba2: Mamba-2 layers with one shared
attention block after every ``hybrid_period`` of them) and the dense
family at head_dim 80 (stablelm-3b) against the JAX reference, on the CPU.

Weights are the reference's own ``Model.init`` tree, converted with
``lm_params_from_reference``, for three reduced configs:
``reduced(zamba2-2.7b)`` (4 ssm layers in 2 groups of 2, d 128, 8 ssm
heads of 32, N 16, chunk 32, the shared block's 4 heads of 32, vocab
512), the same with ``head_dim=80`` (the head dim of both models at full
size), and ``reduced(stablelm-3b)`` with ``head_dim=80`` (2 layers,
LayerNorm, 4 heads of 80).  Limits, as the largest absolute gap over the
reference's largest magnitude: 1e-4 in float32 (the two packages differ
only in summation order), 5e-2 in bfloat16 (activations and the scan's
(Q, Q) tiles rounded to 8 mantissa bits at other places).  Greedy tokens
and engine stats must be equal.  ``forward`` and ``loss`` run at S = 64
with ``use_kernel`` False and True: on the CPU the port's kernel path is
the plain version of each kernel, the reference's its Pallas kernels in
interpret mode.  ``repro.serve`` imports ``repro.core``, which needs the
``enable_x64`` alias, so the reference engine runs in a child
interpreter (``torch_reference.run_reference``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import build_model, param_layout
from repro_torch.serve import Request, ServeEngine
from torch_reference import run_reference

LIMIT = {"float32": 1e-4, "bfloat16": 5e-2}
SEQ, PROMPT, MAX_LEN, DECODE_STEPS = 64, 24, 40, 8
NEW_TOKENS = [5, 8, 3, 6, 4, 7]           # 6 requests: waves of 4 and 2
# case -> (architecture, overrides of its reduced config)
CASES = {"zamba2": ("zamba2-2.7b", {}),
         "zamba2-hd80": ("zamba2-2.7b", {"head_dim": 80}),
         "stablelm-hd80": ("stablelm-3b", {"head_dim": 80})}


def _cfg_pair(case, dtype):
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    arch, over = CASES[case]
    return (dataclasses.replace(jreduced(jget(arch), **over), dtype=dtype),
            dataclasses.replace(reduced(get_config(arch), **over),
                                dtype=dtype))


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameter tree (numpy) of a case's reduced config,
    drawn once per case."""
    import jax
    from repro.models import build_model as jbuild
    trees = {}

    def get(case):
        if case not in trees:
            jcfg, _ = _cfg_pair(case, "float32")
            trees[case] = jax.tree.map(
                np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
        return trees[case]
    return get


def _gap(got, want) -> float:
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reduced_configs_are_the_documented_ones(case):
    _, cfg = _cfg_pair(case, "float32")
    assert (cfg.d_model, cfg.n_heads, cfg.vocab_size) == (128, 4, 512)
    assert cfg.resolved_head_dim == (32 if case == "zamba2" else 80)
    if case == "stablelm-hd80":
        assert (cfg.family, cfg.num_layers, cfg.norm, cfg.n_kv_heads) == (
            "dense", 2, "ln", 4)
        return
    s = cfg.ssm
    assert (cfg.family, cfg.num_layers, cfg.hybrid_period) == ("hybrid", 4, 2)
    assert (s.d_inner(128), s.n_heads(128), s.head_dim, s.d_state,
            s.chunk_size, s.n_groups) == (256, 8, 32, 16, 32, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_loss_match_reference(ref_params, case, use_kernel,
                                          dtype):
    """Logits, mask and labels of ``forward``, and ``loss`` with its
    metrics, with the reference fed the same weights and tokens."""
    import jax.numpy as jnp
    from repro.models import build_model as jbuild
    jcfg, cfg = _cfg_pair(case, dtype)
    jmodel = jbuild(jcfg, use_kernel=use_kernel)
    model = build_model(cfg, use_kernel=use_kernel, device="cpu")
    params = lm_params_from_reference(ref_params(case), cfg, device="cpu")
    toks = _tokens(2, (2, SEQ), cfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks)}
    jlogits, (_, jmask, jlabels) = jmodel.forward(ref_params(case), batch)
    jloss, jmetrics = jmodel.loss(ref_params(case), batch)
    with torch.inference_mode():
        logits, (aux, mask, labels) = model.forward(
            params, {"tokens": torch.from_numpy(toks)})
    loss, metrics = model.loss(params, {"tokens": torch.from_numpy(toks)})
    assert logits.dtype == model.dtype and logits.shape == jlogits.shape
    assert _gap(logits, jlogits) <= LIMIT[dtype]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert float(aux) == 0.0
    for got, want in ((loss, jloss), (metrics["ce"], jmetrics["ce"])):
        assert abs(float(got) - float(want)) <= LIMIT[dtype] * abs(
            float(want))
    assert float(metrics["tokens"]) == float(jmetrics["tokens"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_reference(ref_params, case, dtype):
    """Prefill logits and every cache leaf at S = 24 (the hybrid family's
    ssm caches of every layer and the shared block's K/V of every group),
    then 8 decode steps (logits and caches)."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jbuild
    jcfg, cfg = _cfg_pair(case, dtype)
    jmodel = jbuild(jcfg)
    model = build_model(cfg, device="cpu")
    params = lm_params_from_reference(ref_params(case), cfg, device="cpu")
    toks = _tokens(1, (2, PROMPT), cfg.vocab_size)
    jcache, jlogits = jax.jit(lambda p, b: jmodel.prefill(
        p, b, max_len=MAX_LEN))(ref_params(case),
                                {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        cache, logits = model.prefill(params, {"tokens": torch.from_numpy(
            toks)}, max_len=MAX_LEN)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            elif k != "len":
                yield f"{prefix}{k}", v

    def compare(cache, jcache, logits, jlogits, where):
        assert cache["len"] == int(jcache["len"]), where
        got, want = dict(leaves(cache)), dict(leaves(jcache))
        assert set(got) == set(want), where
        for name in want:
            assert got[name].shape == want[name].shape, (where, name)
            assert _gap(got[name], want[name]) <= LIMIT[dtype], (where, name)
        assert logits.dtype == model.dtype and logits.shape == jlogits.shape
        assert _gap(logits, jlogits) <= LIMIT[dtype], where

    compare(cache, jcache, logits, jlogits, "prefill")
    if cfg.family == "hybrid":
        assert set(cache) == {"len", "ssm", "k", "v"}
        assert cache["k"].shape[0] == cfg.num_layers // cfg.hybrid_period
    decode = jax.jit(jmodel.decode)
    for step in range(DECODE_STEPS):
        nt = _tokens(100 + step, (2, 1), cfg.vocab_size)
        jcache, jlogits = decode(ref_params(case), jcache, jnp.asarray(nt))
        with torch.inference_mode():
            cache, logits = model.decode(params, cache, torch.from_numpy(nt))
        compare(cache, jcache, logits, jlogits, f"decode step {step}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_last_logits_equal_forward_last_position(ref_params, case):
    """Prefill (plain attention and the chunked scan, as the reference's)
    against ``forward`` with the kernel path at the last position, float32
    within 1e-4."""
    _, cfg = _cfg_pair(case, "float32")
    params = lm_params_from_reference(ref_params(case), cfg, device="cpu")
    toks = torch.from_numpy(_tokens(3, (2, SEQ), cfg.vocab_size))
    with torch.inference_mode():
        logits = build_model(cfg, use_kernel=True, device="cpu").forward(
            params, {"tokens": toks})[0]
        _, last = build_model(cfg, device="cpu").prefill(
            params, {"tokens": toks}, max_len=SEQ)
    assert _gap(last, logits[:, -1].numpy()) <= 1e-4


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "stablelm-3b"])
def test_param_layout_matches_reference_tree(ref_params, arch):
    """Same keys and shapes as the reference's init, for the reduced
    config and (shapes only, no weights drawn) at full width: the hybrid
    tree has the stacked ssm layers and one ``shared`` block."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    case = "zamba2" if arch == "zamba2-2.7b" else "stablelm-hd80"
    _, cfg = _cfg_pair(case, "float32")

    def shapes(layout):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v[0])
                for k, v in layout.items()}
    assert shapes(param_layout(cfg)) == jax.tree.map(
        lambda a: tuple(a.shape), ref_params(case))
    full = jax.eval_shape(jbuild(jget(arch)).init, jax.random.PRNGKey(0))
    want = jax.tree.map(lambda a: tuple(a.shape), full)
    assert shapes(param_layout(get_config(arch))) == want
    if arch == "zamba2-2.7b":
        assert set(want) == {"embed", "final_norm", "layers", "shared"}
        assert want["shared"]["attn"]["wq"] == (2560, 32, 1, 80)


def test_init_draws_the_shared_block_once():
    """Seeded init: the same seed gives the same tree; the shared block is
    one unstacked layer, drawn with its own fan-in."""
    _, cfg = _cfg_pair("zamba2-hd80", "float32")
    model = build_model(cfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(0))
    b = model.init(torch.Generator().manual_seed(0))
    flat = lambda t: [x for v in t.values() for x in (  # noqa: E731
        flat(v) if isinstance(v, dict) else [v])]
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    wq = a["shared"]["attn"]["wq"]
    assert wq.shape == (128, 4, 1, 80)
    assert abs(wq.std().item() - 1 / np.sqrt(128)) < 0.01
    assert a["layers"]["ssm"]["in_x"].shape == (4, 128, 256)


def test_kernels_run_in_forward_and_not_in_prefill(ref_params, monkeypatch):
    """``forward`` with the kernel path calls the scan once an ssm layer
    and the attention once a group; prefill and decode call neither, as
    the reference's hybrid prefill (which passes no ``use_kernel``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    _, cfg = _cfg_pair("zamba2-hd80", "float32")
    params = lm_params_from_reference(ref_params("zamba2-hd80"), cfg,
                                      device="cpu")
    calls = {"ssd": 0, "flash": 0}

    def counting(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(ssd_ops, "ssd", counting("ssd", ssd_ops.ssd))
    monkeypatch.setattr(fa_ops, "flash_attention",
                        counting("flash", fa_ops.flash_attention))
    model = build_model(cfg, use_kernel=True, device="cpu")
    toks = torch.from_numpy(_tokens(4, (1, SEQ), cfg.vocab_size))
    with torch.inference_mode():
        model.forward(params, {"tokens": toks})
        assert calls == {"ssd": 4, "flash": 2}
        cache, _ = model.prefill(params, {"tokens": toks[:, :-1]},
                                 max_len=SEQ)
        model.decode(params, cache, toks[:, -1:])
    assert calls == {"ssd": 4, "flash": 2}


def test_groups_must_tile_the_stack():
    """The reference reshapes the layers into whole groups, so a layer
    count that is not a multiple of ``hybrid_period`` is refused."""
    _, cfg = _cfg_pair("zamba2", "float32")
    with pytest.raises(ValueError, match="hybrid_period"):
        build_model(dataclasses.replace(cfg, num_layers=5), device="cpu")


def test_convert_rejects_a_tree_without_the_shared_block(ref_params):
    _, cfg = _cfg_pair("zamba2", "float32")
    tree = dict(ref_params("zamba2"))
    del tree["shared"]
    with pytest.raises(ValueError, match="has keys"):
        lm_params_from_reference(tree, cfg, device="cpu")
    tree = dict(ref_params("zamba2"), shared=dict(
        ref_params("zamba2")["shared"], ln1={"scale": np.ones(7)}))
    with pytest.raises(ValueError, match="shared/ln1/scale has shape"):
        lm_params_from_reference(tree, cfg, device="cpu")


SERVE_CHILD = r"""
import dataclasses
import numpy as np
from repro.configs import get_config, reduced
from repro.serve import Request, ServeEngine

for case, (arch, over) in PAYLOAD["cases"].items():
    cfg = dataclasses.replace(reduced(get_config(arch), **over),
                              dtype="float32")
    params = ServeEngine(cfg, None).model.init(jax.random.PRNGKey(0))
    eng = ServeEngine(cfg, params, batch_slots=PAYLOAD["slots"],
                      max_len=PAYLOAD["max_len"])
    warm = eng.warm(PAYLOAD["warm"])
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(PAYLOAD["prompts"],
                                           PAYLOAD["new"]))]
    out = eng.run(reqs)
    OUT[case] = {"tokens": {str(k): v for k, v in out.items()},
                 "stats": eng.stats, "warm": warm}
"""


@pytest.fixture(scope="module")
def ref_serve():
    """Prompts, and each case's reference engine tokens, stats and warm
    report (one child for the three cases)."""
    prompts = _tokens(3, (len(NEW_TOKENS), 10), 512).tolist()
    payload = {"cases": CASES, "slots": 4, "max_len": MAX_LEN, "warm": [10],
               "prompts": prompts, "new": NEW_TOKENS}
    return prompts, run_reference(SERVE_CHILD, payload, timeout=900)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_engine_matches_reference(ref_params, ref_serve, case,
                                        use_kernel):
    """The engine with and without the kernel serves the reference
    engine's tokens and stats.  The hybrid family launches nothing either
    way (its prefill runs plain attention and the chunked scan, as the
    reference's); the dense one calls the attention kernel's entry point
    once a layer a prefill with ``use_kernel``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    prompts, want = ref_serve
    _, cfg = _cfg_pair(case, "float32")
    params = lm_params_from_reference(ref_params(case), cfg, device="cpu")
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=MAX_LEN,
                      use_kernel=use_kernel, device="cpu")
    calls = []
    real = fa_ops.flash_attention

    def counting(*args, **kwargs):
        calls.append(None)
        return real(*args, **kwargs)
    fa_ops.flash_attention = counting
    try:
        warm = eng.warm([10])
        out = eng.run([Request(rid=i, prompt=np.asarray(p, np.int32),
                               max_new_tokens=n)
                       for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS))])
    finally:
        fa_ops.flash_attention = real
    assert [len(out[i]) for i in range(len(NEW_TOKENS))] == NEW_TOKENS
    assert {str(k): v for k, v in out.items()} == want[case]["tokens"]
    assert eng.stats == want[case]["stats"]
    assert warm == want[case]["warm"]
    per_prefill = cfg.num_layers if (use_kernel
                                     and cfg.family == "dense") else 0
    assert len(calls) == per_prefill * eng.stats["prefills"]
