"""The port's dense LM and serving engine (repro_torch.models,
repro_torch.serve) against the JAX reference, on the CPU.

Weights are the reference's own ``Model.init`` tree for
``reduced(qwen2-0.5b)`` (2 layers, d 128, 4 heads in 2 KV groups, vocab
512), converted with ``lm_params_from_reference``.  Limits, as the largest
absolute gap over the reference's largest magnitude: 1e-4 in float32
(the two packages differ only in summation order), 5e-2 in bfloat16
(activations rounded to 8 mantissa bits at other places).  Greedy tokens
and engine stats must be equal.  ``repro.serve`` imports ``repro.core``,
which needs the ``enable_x64`` alias, so the reference engine runs in a
child interpreter.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import build_model, param_layout
from repro_torch.serve import Request, ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-0.5b"
LIMIT = {"float32": 1e-4, "bfloat16": 5e-2}
PROMPT, MAX_LEN, DECODE_STEPS = 24, 40, 8
NEW_TOKENS = [5, 8, 3, 6, 4, 7]           # 6 requests: waves of 4 and 2


def _cfg_pair(dtype):
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    return (dataclasses.replace(jreduced(jget(ARCH)), dtype=dtype),
            dataclasses.replace(reduced(get_config(ARCH)), dtype=dtype))


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameter tree (numpy) for the reduced config."""
    import jax
    from repro.models import build_model as jbuild
    jcfg, _ = _cfg_pair("float32")
    params = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _gap(got, want) -> float:
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_configs_equal_reference(name):
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
        jget(name))
    assert dataclasses.asdict(reduced(get_config(name))) == \
        dataclasses.asdict(jreduced(jget(name)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_match_reference(ref_params, use_kernel, dtype):
    """Prefill logits and the K/V cache, then 8 decode steps (logits and
    cache), with the reference fed the same weights and tokens."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jbuild
    jcfg, cfg = _cfg_pair(dtype)
    jmodel = jbuild(jcfg, use_kernel=use_kernel)
    model = build_model(cfg, use_kernel=use_kernel, device="cpu")
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    toks = _tokens(1, (2, PROMPT), cfg.vocab_size)
    jcache, jlogits = jax.jit(lambda p, b: jmodel.prefill(
        p, b, max_len=MAX_LEN))(ref_params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        cache, logits = model.prefill(params, {"tokens": torch.from_numpy(
            toks)}, max_len=MAX_LEN)
    assert cache["len"] == int(jcache["len"]) == PROMPT
    assert logits.shape == jlogits.shape and logits.dtype == model.dtype
    for got, want in ((logits, jlogits), (cache["k"], jcache["k"]),
                      (cache["v"], jcache["v"])):
        assert _gap(got, want) <= LIMIT[dtype]
    decode = jax.jit(jmodel.decode)
    for step in range(DECODE_STEPS):
        nt = _tokens(100 + step, (2, 1), cfg.vocab_size)
        jcache, jlogits = decode(ref_params, jcache, jnp.asarray(nt))
        with torch.inference_mode():
            cache, logits = model.decode(params, cache, torch.from_numpy(nt))
        assert cache["len"] == int(jcache["len"])
        for got, want in ((logits, jlogits), (cache["k"], jcache["k"]),
                          (cache["v"], jcache["v"])):
            assert _gap(got, want) <= LIMIT[dtype], step


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_reference(ref_params, use_kernel):
    import jax.numpy as jnp
    from repro.models import build_model as jbuild
    jcfg, cfg = _cfg_pair("float32")
    toks = _tokens(2, (2, 32), cfg.vocab_size)
    jlogits, (_, jmask, jlabels) = jbuild(jcfg, use_kernel=use_kernel).forward(
        ref_params, {"tokens": jnp.asarray(toks)})
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    with torch.inference_mode():
        logits, (aux, mask, labels) = build_model(
            cfg, use_kernel=use_kernel, device="cpu").forward(
                params, {"tokens": torch.from_numpy(toks)})
    assert _gap(logits, jlogits) <= LIMIT["float32"]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert float(aux) == 0.0


CHILD = r"""
import dataclasses, json, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
import numpy as np
from repro.configs import get_config, reduced
from repro.serve import Request, ServeEngine

pay = json.loads(sys.stdin.read())
cfg = dataclasses.replace(reduced(get_config(pay["arch"])), dtype="float32")
params = ServeEngine(cfg, None).model.init(jax.random.PRNGKey(0))
eng = ServeEngine(cfg, params, batch_slots=pay["slots"],
                  max_len=pay["max_len"])
warm = eng.warm(pay["warm"])
reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=n)
        for i, (p, n) in enumerate(zip(pay["prompts"], pay["new"]))]
out = eng.run(reqs)
print(json.dumps({"tokens": {str(k): v for k, v in out.items()},
                  "stats": eng.stats, "warm": warm}))
"""


@pytest.fixture(scope="module")
def ref_serve():
    """Prompts, and the reference engine's tokens, stats and warm report."""
    _, cfg = _cfg_pair("float32")
    prompts = _tokens(3, (len(NEW_TOKENS), 10), cfg.vocab_size).tolist()
    payload = {"arch": ARCH, "slots": 4, "max_len": MAX_LEN, "warm": [10],
               "prompts": prompts, "new": NEW_TOKENS}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", CHILD],
                          input=json.dumps(payload), capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return prompts, json.loads(proc.stdout.strip().splitlines()[-1])


def _serve(ref_params, prompts, **kw):
    _, cfg = _cfg_pair("float32")
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=MAX_LEN,
                      device="cpu", **kw)
    warm = eng.warm([10])
    out = eng.run([Request(rid=i, prompt=np.asarray(p, np.int32),
                           max_new_tokens=n)
                   for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS))])
    assert [len(out[i]) for i in range(len(NEW_TOKENS))] == NEW_TOKENS
    return eng, {str(k): v for k, v in out.items()}, warm


def test_serve_engine_matches_reference(ref_params, ref_serve):
    prompts, want = ref_serve
    eng, out, warm = _serve(ref_params, prompts)
    assert eng.model.use_kernel          # the port's engine default
    assert out == want["tokens"]
    assert eng.stats == want["stats"]
    assert warm == want["warm"]


def test_plain_serve_engine_matches_reference(ref_params, ref_serve):
    """``use_kernel=False`` builds the reference engine's model: plain
    attention in prefill, the same tokens and stats."""
    prompts, want = ref_serve
    eng, out, warm = _serve(ref_params, prompts, use_kernel=False)
    assert not eng.model.use_kernel
    assert (out, eng.stats, warm) == (want["tokens"], want["stats"],
                                      want["warm"])


def test_encdec_builds_and_unknown_family_raises():
    """whisper-medium's encdec family builds and converts a tree of its
    layout; a family the reference does not have raises ``ValueError`` in
    both."""
    cfg = reduced(get_config("whisper-medium"))
    assert build_model(cfg, device="cpu").cfg.family == "encdec"

    def zeros(layout):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros(v[0])
                for k, v in layout.items()}
    tree = lm_params_from_reference(zeros(param_layout(cfg)), cfg,
                                    device="cpu")
    assert set(tree) == {"embed", "final_norm", "layers", "enc_layers",
                         "enc_norm"}
    bogus = dataclasses.replace(cfg, family="audio")
    with pytest.raises(ValueError, match="audio"):
        build_model(bogus, device="cpu")
    with pytest.raises(ValueError, match="audio"):
        lm_params_from_reference({}, bogus, device="cpu")


def test_param_layout_matches_reference_tree(ref_params):
    """Same keys and shapes as the reference's init, for the reduced
    config and (shapes only, no weights drawn) at full width."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    _, cfg = _cfg_pair("float32")

    def shapes(layout):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v[0])
                for k, v in layout.items()}
    assert shapes(param_layout(cfg)) == jax.tree.map(
        lambda a: tuple(a.shape), ref_params)
    full = jax.eval_shape(jbuild(jget(ARCH)).init, jax.random.PRNGKey(0))
    assert shapes(param_layout(get_config(ARCH))) == jax.tree.map(
        lambda a: tuple(a.shape), full)


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, 40),
                                           (True, 50)])
@pytest.mark.parametrize("block_size", [16, 1024])
def test_mha_paths_match_reference(causal, kv_len, block_size):
    """Both paths of the plain attention: blockwise (Sk = 64 is a multiple
    of 16) and direct, against the reference's ``mha``."""
    import jax.numpy as jnp
    from repro.models.layers import mha as jmha
    from repro_torch.models.layers import mha
    rng = np.random.default_rng(block_size + (kv_len or 0))
    q = rng.standard_normal((2, 64, 2, 3, 32), np.float32)
    k = rng.standard_normal((2, 64, 2, 32), np.float32)
    v = rng.standard_normal((2, 64, 2, 32), np.float32)
    want = jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                kv_len=kv_len, block_size=block_size)
    got = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
              causal=causal, kv_len=kv_len, block_size=block_size)
    assert _gap(got, want) <= LIMIT["float32"]


@pytest.mark.parametrize("part", ["norm", "attention", "mlp", "embed"])
def test_layer_inits_match_reference_shapes(part):
    import jax
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    jcfg, cfg = _cfg_pair("float32")
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    if part == "norm":
        want = jax.eval_shape(lambda k: JL.init_norm(k, 128, "ln"), key)
        got = L.init_norm(128, "ln", generator=gen, device="cpu")
    else:
        want = jax.eval_shape(
            lambda k: getattr(JL, f"init_{part}")(k, jcfg), key)
        got = getattr(L, f"init_{part}")(cfg, generator=gen, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), want) == {
        k: tuple(v.shape) for k, v in got.items()}


def test_init_is_seeded_and_matches_layout():
    _, cfg = _cfg_pair("float32")
    model = build_model(cfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(0))
    b = model.init(torch.Generator().manual_seed(0))
    c = model.init(torch.Generator().manual_seed(1))
    flat = lambda t: [x for v in t.values() for x in (  # noqa: E731
        flat(v) if isinstance(v, dict) else [v])]
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not torch.equal(a["embed"]["tok"], c["embed"]["tok"])
    assert a["layers"]["attn"]["wq"].shape == (2, 128, 2, 2, 32)
    assert a["layers"]["attn"]["bq"].abs().max() == 0
    assert all(x.dtype == torch.float32 for x in flat(a))
    # per-layer fan-in: the stacked layer axis does not enter the scale
    std = a["layers"]["mlp"]["wo"].std().item()
    assert abs(std - 1 / np.sqrt(cfg.d_ff)) < 0.1 / np.sqrt(cfg.d_ff)


def test_convert_rejects_a_tree_that_does_not_fit(ref_params):
    _, cfg = _cfg_pair("float32")
    missing = dict(ref_params, embed={})
    with pytest.raises(ValueError, match="embed has keys"):
        lm_params_from_reference(missing, cfg, device="cpu")
    layers = dict(ref_params["layers"], ln1={"scale": np.ones((3, 128))})
    with pytest.raises(ValueError, match="layers/ln1/scale has shape"):
        lm_params_from_reference(dict(ref_params, layers=layers), cfg,
                                 device="cpu")


def test_prefill_takes_every_prompt_length_and_refuses_overflow(ref_params):
    """A prefill longer than ``max_len`` raises (the reference's raises
    too); decode steps past a full cache write its last row, as the
    reference's ``dynamic_update_slice`` clamps, with RoPE and the length
    unclamped: 6 steps from position 13 of 16, logits and cache against
    the reference's."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jbuild
    jcfg, cfg = _cfg_pair("float32")
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    model = build_model(cfg, use_kernel=True, device="cpu")
    with torch.inference_mode():
        for s in (1, 7, 13):
            cache, logits = model.prefill(
                params, {"tokens": torch.from_numpy(
                    _tokens(s, (1, s), cfg.vocab_size))}, max_len=16)
            assert cache["len"] == s and bool(torch.isfinite(logits).all())
        with pytest.raises(ValueError, match="max_len"):
            model.prefill(params, {"tokens": torch.zeros(1, 17,
                                                         dtype=torch.long)},
                          max_len=16)
    jmodel = jbuild(jcfg)
    jcache, _ = jmodel.prefill(ref_params, {"tokens": jnp.asarray(
        _tokens(13, (1, 13), cfg.vocab_size))}, max_len=16)
    decode = jax.jit(jmodel.decode)
    for step in range(6):
        nt = _tokens(200 + step, (1, 1), cfg.vocab_size)
        jcache, jlogits = decode(ref_params, jcache, jnp.asarray(nt))
        with torch.inference_mode():
            cache, logits = model.decode(params, cache, torch.from_numpy(nt))
        assert cache["len"] == int(jcache["len"]) == 14 + step
        for got, want in ((logits, jlogits), (cache["k"], jcache["k"]),
                          (cache["v"], jcache["v"])):
            assert _gap(got, want) <= LIMIT["float32"], step
