"""Parity of the port's workload layer with the JAX reference, on the CPU:
the batched transformer step model (``repro_torch.workloads.stepsim``)
and ``TransformerWorkload``, registered beside HPL.

The reference runs once per module in a child interpreter
(``torch_reference.run_reference``).  Tolerances: the step parameters a
workload derives from its spec are host Python (bit-identical); step
times 1e-12 relative (float64 closed forms); gradients 1e-9; the DES
bit-identical.  The reference's own cases (registry, geometry, DES vs
stepsim cross-validation, compile-once sweeps, what-if grids) are held
on the port alone as well.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.predict import whatif_grid
from repro_torch.obs.metrics import MetricsRegistry, global_metrics
from repro_torch.platforms import get_platform
from repro_torch.workloads import (HPLWorkload, StepFastModel, StepParams,
                                   TransformerWorkload, WorkloadSpec,
                                   get_workload, list_workloads,
                                   simulate_step_fast, step_time_traced,
                                   sweep_step, trace_count,
                                   workload_from_spec)
from torch_reference import run_reference

RTOL = 1e-12
GRAD_RTOL = 1e-9
TORUS_PLATFORMS = ("tpu-v5e-pod", "syn-torus-fugaku-4k", "syn-torus-bgq-8k")
PLATFORMS = TORUS_PLATFORMS + ("syn-mp-2pod-v5e",)
SMALL = dict(mesh=(2, 4), num_layers=3)     # 8-rank DES probes
FIELDS = [f.name for f in dataclasses.fields(StepParams)]

CHILD = r"""
import dataclasses
import jax
from jax.experimental import enable_x64
from repro.core.predict import whatif_grid
from repro.platforms import get_platform
from repro.workloads import (StepParams, get_workload, list_workloads,
                             step_time_traced, sweep_step)

OUT["registry"] = list_workloads()
OUT["default"], OUT["params"], OUT["small"], OUT["des"] = {}, {}, {}, {}
for name in PAYLOAD["platforms"]:
    plat = get_platform(name)
    OUT["default"][name] = get_workload("transformer").predict(plat)
    OUT["params"][name] = dataclasses.asdict(
        get_workload("transformer").fastsim_model(plat).params)
    small = get_workload("transformer", **PAYLOAD["small"])
    OUT["small"][name] = small.predict(plat)
    OUT["des"][name] = small.predict_des(plat)
OUT["one_pod"] = get_workload("transformer", pods=1, **PAYLOAD["small"]
                              ).predict(get_platform("syn-mp-2pod-v5e"))
OUT["sweep"] = sweep_step([StepParams(**d) for d in PAYLOAD["sweep"]])
with enable_x64(True):
    p0 = StepParams(**PAYLOAD["grad"])
    val, grad = jax.value_and_grad(step_time_traced)(p0)
OUT["grad_value"] = float(val)
OUT["grad"] = {f: float(getattr(grad, f)) for f in PAYLOAD["fields"]}
rows = whatif_grid(get_workload("transformer"), get_platform("tpu-v5e-pod"),
                   {"link_bw": [1.0, 2.0], "mem_bw": [1.0, 1.5]})
OUT["whatif"] = [[r["time_s"], r["speedup"]] for r in rows]
"""


def _random_step_params(rng, base: StepParams) -> dict:
    """``base`` with every field jittered from ``rng``: group sizes drawn
    from 1-8 (1 collapses a ring), overlap in [0, 1]."""
    d = {n: float(getattr(base, n)) * float(rng.uniform(0.5, 1.5))
         for n in FIELDS}
    for n in ("model_group", "data_group", "pod_group"):
        d[n] = float(rng.integers(1, 9))
    d["n_layers"] = float(rng.integers(1, 33))
    d["overlap"] = float(rng.uniform(0.0, 1.0))
    return d


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(20201117)
    base = get_workload("transformer").fastsim_model(
        get_platform("syn-mp-2pod-v5e")).params
    payload = {"platforms": list(PLATFORMS), "small": SMALL,
               "sweep": [_random_step_params(rng, base) for _ in range(11)],
               "grad": _random_step_params(rng, base), "fields": FIELDS}
    payload["grad"].update(model_group=4.0, data_group=2.0, pod_group=2.0)
    return payload, run_reference(CHILD, payload)


# ------------------------------------------------------ parity: stepsim

@pytest.mark.parametrize("name", PLATFORMS)
def test_derived_step_params_bit_identical(case, name):
    _, ref = case
    params = get_workload("transformer").fastsim_model(
        get_platform(name)).params
    assert dataclasses.asdict(params) == ref["params"][name]


@pytest.mark.parametrize("name", PLATFORMS)
def test_default_prediction_within_1e12(case, name):
    _, ref = case
    out = get_workload("transformer").predict(get_platform(name),
                                              device="cpu")
    want = ref["default"][name]
    assert set(out) == set(want)
    for key in ("time_s", "step_s", "mfu", "tokens_per_s"):
        np.testing.assert_allclose(out[key], want[key], rtol=RTOL, atol=0,
                                   err_msg=key)


def test_random_sweep_within_1e12(case):
    payload, ref = case
    out = sweep_step([StepParams(**d) for d in payload["sweep"]],
                     device="cpu")
    assert len(out) == 11
    for key in ("time_s", "mfu"):
        np.testing.assert_allclose([r[key] for r in out],
                                   [r[key] for r in ref["sweep"]],
                                   rtol=RTOL, atol=0, err_msg=key)


def test_gradient_within_1e9(case):
    payload, ref = case
    leaves = {n: torch.tensor(v, dtype=torch.float64, requires_grad=True)
              for n, v in payload["grad"].items()}
    t = step_time_traced(StepParams(**leaves), device="cpu")
    t.backward()
    np.testing.assert_allclose(float(t.detach()), ref["grad_value"],
                               rtol=RTOL, atol=0)
    for n in FIELDS:
        want = ref["grad"][n]
        got = float(leaves[n].grad)
        assert abs(got - want) <= GRAD_RTOL * max(abs(want), 1e-300) \
            or got == want, (n, got, want)


def test_whatif_grid_rows_within_1e12(case):
    _, ref = case
    rows = whatif_grid(get_workload("transformer"), "tpu-v5e-pod",
                       {"link_bw": [1.0, 2.0], "mem_bw": [1.0, 1.5]},
                       device="cpu")
    np.testing.assert_allclose([[r["time_s"], r["speedup"]] for r in rows],
                               ref["whatif"], rtol=RTOL, atol=0)


# --------------------------------------- parity: DES vs stepsim, per spec

@pytest.mark.parametrize("name", PLATFORMS)
def test_small_des_bit_identical_and_stepsim_within_1e12(case, name):
    _, ref = case
    wl = get_workload("transformer", **SMALL)
    plat = get_platform(name)
    assert wl.predict_des(plat) == ref["des"][name]
    np.testing.assert_allclose(wl.predict(plat, device="cpu")["step_s"],
                               ref["small"][name]["step_s"], rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("name", TORUS_PLATFORMS)
def test_cross_validation_des_vs_stepsim(name):
    """Both transformer backends built from one spec tell the same story:
    within 15% on the torus platforms (the port alone)."""
    plat = get_platform(name)
    wl = get_workload("transformer", **SMALL)
    des = wl.predict_des(plat)
    fast = wl.predict(plat, device="cpu")
    rel = abs(des["step_s"] - fast["step_s"]) / des["step_s"]
    assert rel < 0.15, (name, des["step_s"], fast["step_s"], rel)


def test_cross_validation_multipod_gateway_model(case):
    """Cross-pod rings funnel through the pod gateway: within 30%, and a
    second pod costs time in both backends."""
    _, ref = case
    plat = get_platform("syn-mp-2pod-v5e")
    wl = get_workload("transformer", **SMALL)
    des = wl.predict_des(plat)
    fast = wl.predict(plat, device="cpu")
    rel = abs(des["step_s"] - fast["step_s"]) / des["step_s"]
    assert rel < 0.30, (des["step_s"], fast["step_s"], rel)
    single = get_workload("transformer", pods=1, **SMALL).predict(
        plat, device="cpu")
    np.testing.assert_allclose(single["step_s"], ref["one_pod"]["step_s"],
                               rtol=RTOL, atol=0)
    assert fast["step_s"] > single["step_s"]
    assert des["step_s"] > single["step_s"]


# ------------------------------------------------- registry and specs

def test_registry_lists_both_workloads(case):
    _, ref = case
    assert list_workloads() == ref["registry"]
    assert {"hpl", "transformer"} <= set(list_workloads())
    assert isinstance(get_workload("hpl"), HPLWorkload)
    assert isinstance(get_workload("transformer"), TransformerWorkload)


def test_registry_unknown_name_suggests_close_matches():
    with pytest.raises(KeyError, match="transformer"):
        get_workload("transformre")
    with pytest.raises(KeyError, match="registered"):
        get_workload("stencil")


def test_workload_from_spec_and_kind_check():
    spec = WorkloadSpec.make("transformer", mesh=[4, 8], num_layers=6)
    wl = workload_from_spec(spec)
    assert isinstance(wl, TransformerWorkload)
    assert wl.geometry(get_platform("tpu-v5e-pod")) == ((4, 8), 1)
    assert spec == WorkloadSpec.from_json(spec.to_json())
    with pytest.raises(ValueError, match="kind"):
        TransformerWorkload(spec=WorkloadSpec.make("hpl", N=2048))


def test_transformer_geometry_from_fabric():
    wl = get_workload("transformer")
    assert wl.geometry(get_platform("tpu-v5e-pod")) == ((16, 16), 1)
    assert wl.geometry(get_platform("syn-torus-fugaku-4k")) == ((256, 16), 1)
    assert wl.geometry(get_platform("syn-mp-2pod-v5e")) == ((16, 16), 2)
    with pytest.raises(ValueError, match="fat-tree"):
        wl.geometry(get_platform("frontera"))
    with pytest.raises(ValueError, match="rows, cols"):
        get_workload("transformer", mesh=[2, 4, 4]).geometry(
            get_platform("tpu-v5e-pod"))
    with pytest.raises(ValueError, match="chips"):
        get_workload("transformer", mesh=[64, 64]).validate(
            get_platform("tpu-v5e-pod"))
    assert get_workload("transformer", **SMALL).des_ranks(
        get_platform("tpu-v5e-pod")) == 8


def test_transformer_end_to_end_acceptance():
    model = get_workload("transformer").fastsim_model(
        get_platform("tpu-v5e-pod"))
    assert isinstance(model, StepFastModel)
    out = model.predict(device="cpu")
    assert out["step_s"] > 0 and 0 < out["mfu"] < 1
    assert out["tokens_per_s"] > 0


# ------------------------------------------------------ batched stepsim

def _grid18():
    model = get_workload("transformer").fastsim_model(
        get_platform("tpu-v5e-pod"))
    base = model.params
    return model, [dataclasses.replace(
        base, link_bw=base.link_bw * (1 + 0.1 * i), n_layers=float(2 + i),
        flops_per_layer=base.flops_per_layer * (1 + 0.05 * i))
        for i in range(18)]


def test_step_sweep_builds_once_for_18_scenarios():
    """One program per padded lane count: a repeat sweep builds none, and
    a fresh sweep of the same size none either."""
    model, grid = _grid18()
    model.sweep(grid, device="cpu")          # the (32,)-lane program
    c0 = trace_count()
    res = model.sweep(grid, device="cpu")
    assert trace_count() - c0 == 0
    assert len(res) == 18
    res2 = model.sweep([dataclasses.replace(g, mem_bw=g.mem_bw * 1.25)
                        for g in grid], device="cpu")
    assert trace_count() - c0 == 0
    for r, r2 in zip(res, res2):
        assert r2["time_s"] <= r["time_s"] + 1e-12


def test_step_sweep_matches_singles():
    model = get_workload("transformer").fastsim_model(
        get_platform("syn-torus-fugaku-4k"))
    base = model.params
    grid = [dataclasses.replace(base, link_bw=base.link_bw * s)
            for s in (0.5, 1.0, 2.0, 4.0)]
    batched = sweep_step(grid, device="cpu")
    for p, b in zip(grid, batched):
        single = simulate_step_fast(p, device="cpu")
        np.testing.assert_allclose(b["time_s"], single["time_s"], rtol=RTOL,
                                   atol=0)
    times = [b["time_s"] for b in batched]
    assert times == sorted(times, reverse=True)
    assert sweep_step([], device="cpu") == []


def test_step_params_gradient_flows():
    model = get_workload("transformer").fastsim_model(
        get_platform("tpu-v5e-pod"))
    scale = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    p = dataclasses.replace(model.params,
                            link_bw=model.params.link_bw * scale)
    step_time_traced(p, device="cpu").backward()
    assert scale.grad < 0          # faster links -> shorter step


def test_stepsim_sweep_metrics_observe_only():
    plat = get_platform("tpu-v5e-pod")
    wl = get_workload("transformer", mesh=(2, 4), num_layers=2)
    ref = wl.fastsim_model(plat).predict(device="cpu")
    m = MetricsRegistry()
    with global_metrics(m):
        res = wl.fastsim_model(plat).predict(device="cpu")
    assert res["step_s"] == ref["step_s"]
    c = m.snapshot()["counters"]
    assert (c.get('stepsim.compile_hits{bucket="step"}', 0)
            + c.get('stepsim.compile_misses{bucket="step"}', 0)) >= 1
    assert c["stepsim.lanes_live"] == 1.0


def test_whatif_grid_accepts_transformer_workloads():
    rows = whatif_grid(get_workload("transformer"), "tpu-v5e-pod",
                       {"link_bw": [1.0, 2.0], "mem_bw": [1.0, 1.5]},
                       device="cpu")
    assert len(rows) == 4
    assert rows[0]["speedup"] == pytest.approx(1.0, rel=1e-9)
    assert all(r["speedup"] >= 0.999 for r in rows)
