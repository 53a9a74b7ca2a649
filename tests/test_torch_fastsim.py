"""Parity of the port's fastsim (repro_torch.core.fastsim) with the JAX
reference, on the CPU at small sizes.

The reference runs in a child interpreter: installed jax no longer has
``jax.experimental.enable_x64``, which the reference imports, so the
child aliases it to ``jax.enable_x64`` before importing ``repro``.  The
alias never touches this process.  Inputs are made here with numpy from
a fixed seed and handed to both sides as JSON (floats round-trip
exactly).  Tolerances: 1e-12 relative on simulated times (float64 closed
forms), 1e-9 on gradients.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import fastsim_params_from_numpy
from repro_torch.core import fastsim
from repro_torch.core.apps.hpl import HPLConfig
from repro_torch.core.fastsim import (FastSimParams, simulate_hpl_fast,
                                      simulate_time_traced, sweep_hpl,
                                      trace_count)
from repro_torch.obs.metrics import MetricsRegistry, global_metrics
from repro_torch.platforms import get_platform, list_platforms
from repro_torch.workloads import get_workload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = [f.name for f in dataclasses.fields(FastSimParams)]
RTOL = 1e-12

CHILD = r"""
import dataclasses, json, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
from jax.experimental import enable_x64
from repro.core.apps.hpl import HPLConfig
from repro.core.fastsim import (FastSimParams, simulate_hpl_fast,
                                simulate_time_traced, sweep_hpl)
from repro.platforms import get_platform
from repro.workloads import get_workload

pay = json.loads(sys.stdin.read())
cfg = lambda g: HPLConfig(N=g[0], nb=g[1], P=g[2], Q=g[3])
prm = lambda d: FastSimParams(**d)
out = {}
out["own"] = get_workload("hpl").predict(get_platform("bdw-local"))["time_s"]
out["registry"] = {
    name: simulate_hpl_fast(cfg(g), get_platform(name).fastsim())["time_s"]
    for name, g in pay["registry"].items()}
out["singles"] = [simulate_hpl_fast(cfg(g), prm(d))["time_s"]
                  for g, d in pay["singles"]]
out["grid"] = [r["time_s"] for r in sweep_hpl(
    cfg(pay["grid_cfg"]), [prm(d) for d in pay["grid"]])]
out["mixed"] = [r["time_s"] for r in sweep_hpl(
    [cfg(g) for g in pay["mixed_cfgs"]], [prm(d) for d in pay["mixed"]])]
out["forced"] = [r["time_s"] for r in sweep_hpl(
    [cfg(g) for g in pay["forced_cfgs"]], [prm(d) for d in pay["forced"]],
    bucket=tuple(pay["bucket"]))]
with enable_x64(True):
    p0 = prm(pay["grad_prm"])
    val, grad = jax.jit(jax.value_and_grad(
        lambda p: simulate_time_traced(cfg(pay["grad_cfg"]), p)))(p0)
out["grad_value"] = float(val)
out["grad"] = {f.name: float(getattr(grad, f.name))
               for f in dataclasses.fields(grad)}
print(json.dumps(out))
"""


def _params(rng, base: FastSimParams) -> dict:
    """``base`` with every field jittered from ``rng`` (lookahead in
    [0, 1]) — the same values go to both packages."""
    d = {n: float(getattr(base, n)) * float(rng.uniform(0.5, 1.5))
         for n in FIELDS}
    d["lookahead"] = float(rng.uniform(0.0, 1.0))
    return d


def _geom(cfg):
    return [cfg.N, cfg.nb, cfg.P, cfg.Q]


def _cases():
    rng = np.random.default_rng(20201105)
    bdw = get_platform("bdw-local")
    base = bdw.fastsim()
    registry = {}
    for name in list_platforms():
        plat = get_platform(name)
        nb = plat.scale.hpl_nb
        registry[name] = _geom(plat.hpl_config(N=8 * nb))
    singles = [
        ([1000, 96, 3, 5], _params(rng, base)),     # N % nb != 0
        ([1024, 64, 1, 6], _params(rng, base)),     # P = 1
        ([1024, 64, 5, 1], _params(rng, base)),     # Q = 1
        ([700, 64, 1, 1], _params(rng, base)),      # 1 x 1, ragged
        ([2560, 128, 6, 3], _params(rng, base)),    # padded P and Q
    ]
    grid_cfg = _geom(bdw.hpl_config())
    grid = [dict(dataclasses.asdict(base), link_bw=base.link_bw * lb,
                 gemm_eff=ge)
            for lb in rng.uniform(0.25, 4.0, 4)
            for ge in rng.uniform(0.5, 0.99, 4)]
    # same geometry twice ('params' mode), two geometries sharing a bucket
    # ('batch' mode), and singletons in buckets of their own ('single')
    mixed_cfgs = [[4096, 128, 4, 4], [1536, 128, 2, 3], [4096, 128, 4, 4],
                  [1000, 100, 3, 4], [1100, 100, 3, 4], [640, 64, 1, 2]]
    mixed = [_params(rng, base) for _ in mixed_cfgs]
    forced_cfgs = [[4096, 128, 4, 4], [1000, 96, 3, 5], [900, 128, 2, 2],
                   [900, 128, 1, 1]]
    forced = [_params(rng, base) for _ in forced_cfgs]
    return {"registry": registry, "singles": singles, "grid_cfg": grid_cfg,
            "grid": grid, "mixed_cfgs": mixed_cfgs, "mixed": mixed,
            "forced_cfgs": forced_cfgs, "forced": forced,
            "bucket": [40, 4, 6],
            "grad_cfg": grid_cfg, "grad_prm": dataclasses.asdict(base)}


def _run_reference(payload: dict) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", CHILD],
                          input=json.dumps(payload), capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def case():
    payload = _cases()
    return payload, _run_reference(payload)


def _cfg(g):
    return HPLConfig(N=g[0], nb=g[1], P=g[2], Q=g[3])


def _times(results):
    return np.asarray([r["time_s"] for r in results])


def test_own_run_bdw_local(case):
    _, ref = case
    t = get_workload("hpl").predict(get_platform("bdw-local"),
                                    device="cpu")["time_s"]
    np.testing.assert_allclose(t, ref["own"], rtol=RTOL, atol=0)
    np.testing.assert_allclose(t, 0.058538299545155895, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", list_platforms())
def test_registry_platform_cut_to_8_panels(case, name):
    payload, ref = case
    t = simulate_hpl_fast(_cfg(payload["registry"][name]),
                          get_platform(name).fastsim(),
                          device="cpu")["time_s"]
    np.testing.assert_allclose(t, ref["registry"][name], rtol=RTOL, atol=0)


@pytest.mark.parametrize("i", range(5),
                         ids=["ragged_N", "P1", "Q1", "P1_Q1", "padded"])
def test_single_geometries(case, i):
    payload, ref = case
    g, d = payload["singles"][i]
    t = simulate_hpl_fast(_cfg(g), FastSimParams(**d), device="cpu")
    np.testing.assert_allclose(t["time_s"], ref["singles"][i], rtol=RTOL,
                               atol=0)


def test_whatif_grid_16_lanes(case):
    payload, ref = case
    out = sweep_hpl(_cfg(payload["grid_cfg"]),
                    [FastSimParams(**d) for d in payload["grid"]],
                    device="cpu")
    assert len(out) == 16
    np.testing.assert_allclose(_times(out), ref["grid"], rtol=RTOL, atol=0)


def test_mixed_bucket_sweep(case):
    payload, ref = case
    out = sweep_hpl([_cfg(g) for g in payload["mixed_cfgs"]],
                    [FastSimParams(**d) for d in payload["mixed"]],
                    device="cpu")
    np.testing.assert_allclose(_times(out), ref["mixed"], rtol=RTOL, atol=0)


def test_forced_bucket(case):
    payload, ref = case
    out = sweep_hpl([_cfg(g) for g in payload["forced_cfgs"]],
                    [FastSimParams(**d) for d in payload["forced"]],
                    bucket=tuple(payload["bucket"]), device="cpu")
    np.testing.assert_allclose(_times(out), ref["forced"], rtol=RTOL, atol=0)
    # and each lane with P > 1 and Q > 1 equals its own single run.  A
    # P = 1 (or Q = 1) lane in a bucket with P_max > 1 (Q_max > 1) takes
    # the reference's static split for the bucket: it is priced row swaps
    # (reads stored column 1), so it differs from its own single run in
    # both packages alike.
    for g, d, t in zip(payload["forced_cfgs"], payload["forced"], out):
        if g[2] > 1 and g[3] > 1:
            single = simulate_hpl_fast(_cfg(g), FastSimParams(**d),
                                       device="cpu")["time_s"]
            np.testing.assert_allclose(t["time_s"], single, rtol=RTOL, atol=0)


def test_forced_bucket_too_small_raises():
    with pytest.raises(ValueError, match="exceeds forced bucket"):
        sweep_hpl(HPLConfig(N=4096, nb=128, P=4, Q=4),
                  get_platform("bdw-local").fastsim(), bucket=(8, 4, 4),
                  device="cpu")


def test_gradient_matches_reference(case):
    payload, ref = case
    prm = fastsim_params_from_numpy(payload["grad_prm"], device="cpu",
                                    requires_grad=True)
    t = simulate_time_traced(_cfg(payload["grad_cfg"]), prm, device="cpu")
    t.backward()
    np.testing.assert_allclose(t.item(), ref["grad_value"], rtol=RTOL,
                               atol=0)
    # a leaf the recurrence never reads (hop_latency) has no .grad in
    # torch and a zero gradient in JAX
    port = [0.0 if getattr(prm, n).grad is None
            else getattr(prm, n).grad.item() for n in FIELDS]
    np.testing.assert_allclose(port, [ref["grad"][n] for n in FIELDS],
                               rtol=1e-9, atol=0)
    assert any(g != 0.0 for g in port)


def test_bucket_cache_misses_stay_flat_on_changed_values():
    cfg = HPLConfig(N=1536, nb=128, P=2, Q=3)
    base = get_platform("bdw-local").fastsim()
    sweep = [dataclasses.replace(base, link_bw=base.link_bw * f)
             for f in (0.5, 1.0, 2.0)]
    sweep_hpl(cfg, sweep, device="cpu")
    simulate_hpl_fast(cfg, sweep[0], device="cpu")
    misses = trace_count()
    for scale in (0.7, 1.3):
        changed = [dataclasses.replace(p, gemm_eff=p.gemm_eff * scale,
                                       mem_bw=p.mem_bw * scale)
                   for p in sweep]
        sweep_hpl(cfg, changed, device="cpu")
        simulate_hpl_fast(cfg, changed[0], device="cpu")
    assert trace_count() == misses


def test_metrics_record_the_reference_names():
    reg = MetricsRegistry()
    cfg = HPLConfig(N=640, nb=64, P=2, Q=2)
    base = get_platform("bdw-local").fastsim()
    with global_metrics(reg):
        sweep_hpl(cfg, [base, dataclasses.replace(base, theta=1e-6),
                        dataclasses.replace(base, theta=2e-6)], device="cpu")
    snap = reg.snapshot()
    assert snap["counters"]["fastsim.lanes_live"] == 3.0
    assert snap["counters"]["fastsim.lanes_padded"] == 1.0
    assert any(k.startswith(("fastsim.compile_misses",
                             "fastsim.compile_hits"))
               for k in snap["counters"])
    assert "fastsim.sweep_occupancy" in snap["histograms"]


def test_bucket_sizes_match_reference_rule():
    assert [fastsim._bucket(n) for n in (1, 2, 3, 5, 7, 9, 24175)] == \
        [1, 2, 3, 6, 8, 12, 24576]
    assert fastsim._pad_pow2([4, 5, 6]) == [4, 5, 6, 6]


def test_float64_everywhere():
    """N^2 of Frontera's N in float32 would miss parity by ~1e-7: the
    back-substitution term must stay float64."""
    cfg = HPLConfig(N=9_282_848, nb=9_282_848 // 2, P=1, Q=1)
    prm = get_platform("frontera").fastsim()
    t = simulate_time_traced(cfg, prm, device="cpu")
    assert t.dtype == torch.float64
    n = float(cfg.N)
    back = 2.0 * n * n / (prm.peak_flops * prm.gemm_eff)
    assert t.item() > back
