"""The port's ssm family (repro_torch.models.mamba2 and the "ssm" branch of
repro_torch.models.lm) and its serving against the JAX reference, on the
CPU.

Weights are the reference's own ``Model.init`` tree for
``reduced(mamba2-780m)`` (2 layers, d 128, d_inner 256, 8 heads of 32,
N 16, chunk 32, vocab 512), converted with ``lm_params_from_reference``.
Limits, as the largest absolute gap over the reference's largest
magnitude: 1e-4 in float32 (the two packages differ only in summation
order), 5e-2 in bfloat16 (activations and the scan's (Q, Q) tiles rounded
to 8 mantissa bits at other places).  Greedy tokens and engine stats must
be equal.  ``forward`` and ``loss`` run at S = 64 (two chunks, a length
the reference's kernel path accepts) with ``use_kernel`` False and True;
on the CPU the port's kernel path is the plain ``ssd_scan_ref``, the
reference's the Pallas kernel in interpret mode.  ``repro.serve``
imports ``repro.core``, which needs the ``enable_x64`` alias, so the
reference engine runs in a child interpreter.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import build_model, param_layout
from repro_torch.models.layers import a_log_init
from repro_torch.serve import Request, ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "mamba2-780m"
LIMIT = {"float32": 1e-4, "bfloat16": 5e-2}
SEQ, PROMPT, MAX_LEN, DECODE_STEPS = 64, 24, 40, 8
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


def test_reduced_config_is_the_documented_one():
    _, cfg = _cfg_pair("float32")
    s = cfg.ssm
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.vocab_size) == (
        "ssm", 2, 128, 512)
    assert (s.d_inner(128), s.n_heads(128), s.head_dim, s.d_state,
            s.chunk_size, s.n_groups) == (256, 8, 32, 16, 32, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_and_loss_match_reference(ref_params, use_kernel, dtype):
    """Logits, mask and labels of ``forward``, and ``loss`` with its
    metrics, with the reference fed the same weights and tokens."""
    import jax.numpy as jnp
    from repro.models import build_model as jbuild
    jcfg, cfg = _cfg_pair(dtype)
    jmodel = jbuild(jcfg, use_kernel=use_kernel)
    model = build_model(cfg, use_kernel=use_kernel, device="cpu")
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    toks = _tokens(2, (2, SEQ), cfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks)}
    jlogits, (_, jmask, jlabels) = jmodel.forward(ref_params, batch)
    jloss, jmetrics = jmodel.loss(ref_params, batch)
    with torch.inference_mode():
        logits, (aux, mask, labels) = model.forward(
            params, {"tokens": torch.from_numpy(toks)})
    loss, metrics = model.loss(params, {"tokens": torch.from_numpy(toks)})
    assert logits.dtype == model.dtype and logits.shape == jlogits.shape
    assert _gap(logits, jlogits) <= LIMIT[dtype]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert float(aux) == 0.0
    assert not loss.requires_grad and loss.dtype == torch.float32
    for got, want in ((loss, jloss), (metrics["ce"], jmetrics["ce"])):
        assert abs(float(got) - float(want)) <= LIMIT[dtype] * abs(
            float(want))
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == 2 * (
        SEQ - 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(ref_params, dtype):
    """Prefill logits and the conv/state caches at S = 24, then 8 decode
    steps (logits and caches)."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jbuild
    jcfg, cfg = _cfg_pair(dtype)
    jmodel = jbuild(jcfg)
    model = build_model(cfg, device="cpu")
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    toks = _tokens(1, (2, PROMPT), cfg.vocab_size)
    jcache, jlogits = jax.jit(lambda p, b: jmodel.prefill(
        p, b, max_len=MAX_LEN))(ref_params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        cache, logits = model.prefill(params, {"tokens": torch.from_numpy(
            toks)}, max_len=MAX_LEN)

    def compare(cache, jcache, logits, jlogits, where):
        assert cache["len"] == int(jcache["len"]), where
        assert set(cache) == set(jcache) == {"len", "ssm"}
        for name in ("conv", "state"):
            got, want = cache["ssm"][name], jcache["ssm"][name]
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert _gap(got, want) <= LIMIT[dtype], (where, name)
        assert logits.dtype == model.dtype and logits.shape == jlogits.shape
        assert _gap(logits, jlogits) <= LIMIT[dtype], where

    compare(cache, jcache, logits, jlogits, "prefill")
    decode = jax.jit(jmodel.decode)
    for step in range(DECODE_STEPS):
        nt = _tokens(100 + step, (2, 1), cfg.vocab_size)
        jcache, jlogits = decode(ref_params, jcache, jnp.asarray(nt))
        with torch.inference_mode():
            cache, logits = model.decode(params, cache, torch.from_numpy(nt))
        compare(cache, jcache, logits, jlogits, f"decode step {step}")


def test_prefill_of_a_prompt_shorter_than_the_conv_window(ref_params):
    """The decode cache's conv window is zero before the prompt (the
    causal conv's padding), so a one- or two-token prompt decodes exactly
    like the same tokens fed one at a time from an empty cache."""
    _, cfg = _cfg_pair("float32")
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    model = build_model(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(5, (1, 4), cfg.vocab_size)).long()
    with torch.inference_mode():
        cache, _ = model.prefill(params, {"tokens": toks[:, :2]}, max_len=8)
        assert cache["ssm"]["conv"].shape[2] == cfg.ssm.d_conv - 1
        step = model.init_cache(1, 8)
        for t in range(2):
            step, _ = model.decode(params, step, toks[:, t:t + 1])
        for name in ("conv", "state"):
            assert _gap(cache["ssm"][name], step["ssm"][name].numpy()) <= 1e-5
        _, a = model.decode(params, cache, toks[:, 2:3])
        _, b = model.decode(params, step, toks[:, 2:3])
        assert _gap(a, b.numpy()) <= 1e-5


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


@pytest.mark.parametrize("use_kernel", [True, False])
def test_serve_engine_matches_reference(ref_params, ref_serve, use_kernel):
    """The engine with and without the kernel: for this family
    ``use_kernel`` reaches neither prefill nor decode, so both serve the
    reference engine's tokens and stats, and launch nothing."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    prompts, want = ref_serve
    _, cfg = _cfg_pair("float32")
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=MAX_LEN,
                      use_kernel=use_kernel, device="cpu")
    assert eng.model.use_kernel == use_kernel
    before = ssd_scan.launches
    warm = eng.warm([10])
    out = eng.run([Request(rid=i, prompt=np.asarray(p, np.int32),
                           max_new_tokens=n)
                   for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS))])
    assert [len(out[i]) for i in range(len(NEW_TOKENS))] == NEW_TOKENS
    assert {str(k): v for k, v in out.items()} == want["tokens"]
    assert eng.stats == want["stats"]
    assert warm == want["warm"]
    assert ssd_scan.launches == before


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


@pytest.mark.parametrize("arch_size", ["reduced", "full"])
def test_deterministic_leaves_match_reference(arch_size):
    """``D``, ``dt_bias``, ``norm_scale`` and ``conv_bias`` equal the
    reference's ``init_ssm`` bit for bit, on every stacked layer;
    ``A_log`` within two float32 ulps: XLA rewrites ``linspace`` as
    (1 - i r) + i (16 r) with r = fl(1/(H-1)) and has its own log, which
    puts 9 of 48 heads one or two ulps off the float64 value the port
    rounds once.  Random leaves differ (other generators).  One layer at
    full width."""
    import jax
    from repro.configs import get_config as jget
    from repro.models.mamba2 import init_ssm
    from repro_torch.models import layers as L
    from repro_torch.models.mamba2 import layout_ssm
    jcfg, cfg = _cfg_pair("float32")
    if arch_size == "full":
        jcfg, cfg = jget(ARCH), get_config(ARCH)
    want = jax.tree.map(np.asarray, init_ssm(jax.random.PRNGKey(0), jcfg))
    got = L.init_from_layout(layout_ssm(cfg), torch.Generator().manual_seed(
        0), torch.device("cpu"), lead=(2,))
    assert {k: tuple(v.shape[1:]) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    for name in ("D", "dt_bias", "norm_scale", "conv_bias"):
        for layer in got[name]:
            np.testing.assert_array_equal(layer.numpy(), want[name])
    np.testing.assert_array_max_ulp(got["A_log"][1].numpy(), want["A_log"],
                                    maxulp=2)
    nh = cfg.ssm.n_heads(cfg.d_model)
    np.testing.assert_array_equal(
        a_log_init(nh).numpy(),
        np.log(np.linspace(1.0, 16.0, nh)).astype(np.float32))


def test_init_is_seeded_and_matches_layout():
    _, cfg = _cfg_pair("float32")
    model = build_model(cfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(0))
    b = model.init(torch.Generator().manual_seed(0))
    c = model.init(torch.Generator().manual_seed(1))
    flat = lambda t: [x for v in t.values() for x in (  # noqa: E731
        flat(v) if isinstance(v, dict) else [v])]
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not torch.equal(a["layers"]["ssm"]["in_x"],
                           c["layers"]["ssm"]["in_x"])
    ssm = a["layers"]["ssm"]
    assert ssm["in_x"].shape == (2, 128, 256)
    assert ssm["conv_x"].shape == (2, 4, 256)
    assert all(x.dtype == torch.float32 for x in flat(a))
    # per-layer fan-in for dense leaves, 0.1 for the conv taps
    assert abs(ssm["in_x"].std().item() - 1 / np.sqrt(128)) < 0.01
    assert abs(ssm["conv_x"].std().item() - 0.1) < 0.01


def test_convert_rejects_a_tree_that_does_not_fit(ref_params):
    _, cfg = _cfg_pair("float32")
    ssm = dict(ref_params["layers"]["ssm"])
    del ssm["D"]
    with pytest.raises(ValueError, match="layers/ssm has keys"):
        lm_params_from_reference(dict(ref_params, layers=dict(
            ref_params["layers"], ssm=ssm)), cfg, device="cpu")
    ssm = dict(ref_params["layers"]["ssm"], A_log=np.zeros((2, 7)))
    with pytest.raises(ValueError, match="layers/ssm/A_log has shape"):
        lm_params_from_reference(dict(ref_params, layers=dict(
            ref_params["layers"], ssm=ssm)), cfg, device="cpu")


def test_kernel_path_refuses_grad(ref_params, monkeypatch):
    """``forward`` with ``use_kernel`` and parameters that require grad,
    under grad mode: the wrapper raises (the kernel has no backward, and
    the reference's ``jax.grad`` through it fails too).  CPU tensors pose
    as CUDA ones only inside the kernel call."""
    from repro_torch.kernels.ssd_scan import kernel, ops
    _, cfg = _cfg_pair("float32")
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    params["layers"]["ssm"]["in_x"].requires_grad_(True)
    real = ops.ssd

    def as_cuda(xh, dt, A, Bh, Ch, chunk=256):
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "device",
                      property(lambda t: torch.device("cuda", 0)))
            return kernel.ssd_scan(xh, dt, A, Bh, Ch, chunk)
    monkeypatch.setattr(ops, "ssd", as_cuda)
    model = build_model(cfg, use_kernel=True, device="cpu")
    toks = torch.from_numpy(_tokens(4, (1, SEQ), cfg.vocab_size))
    with pytest.raises(RuntimeError, match="no backward"):
        model.forward(params, {"tokens": toks})
    monkeypatch.setattr(ops, "ssd", real)
    loss, _ = model.loss(params, {"tokens": toks})      # values only
    assert bool(torch.isfinite(loss))
