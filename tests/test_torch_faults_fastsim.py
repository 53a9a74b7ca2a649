"""Parity of the port's fault mapping (``repro_torch.faults.fastsim``) and
its fault scenarios on both workloads with the JAX reference, on the CPU.

``apply_faults`` is host Python copied from the reference: its outputs
must be bit-identical.  Fault sweeps and fault predictions run the
float64 closed forms (1e-12 relative); faulted DES runs are host Python
(bit-identical).  The reference's fault cases (DES vs fastsim
cross-validation, fail-stop, the DES-only kinds, one program per fault
grid) are held on the port alone as well.  The reference runs once per
module in a child interpreter (``torch_reference.run_reference``).
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.core.fastsim import trace_count
from repro_torch.faults import (Fault, FaultSpec, NO_FAULTS, apply_faults,
                                fault_params, sweep_faults)
from repro_torch.faults import fastsim as faults_fastsim
from repro_torch.platforms import get_platform
from repro_torch.trace import to_chrome_json, validate_chrome_events
from repro_torch.workloads import get_workload
from torch_reference import run_reference

RTOL = 1e-12
HPL_SMALL = dict(N=1536, nb=128, P=2, Q=4, lookahead=0)
TF_SMALL = dict(mesh=(2, 4), num_layers=3)
# one straggler chip at 0.5x speed plus a seeded 5% of the fabric's
# links at half bandwidth
ACCEPTANCE = (FaultSpec.straggler(rank=1, slowdown=2.0, seed=7)
              + FaultSpec.degraded_links(0.05, factor=0.5, seed=7))
# one of each closed-form kind, and a combined scenario
SPECS = [
    FaultSpec.straggler(rank=1, slowdown=2.0),
    FaultSpec.straggler(rank=0, slowdown=1.5) + FaultSpec.straggler(
        rank=0, slowdown=2.0) + FaultSpec.straggler(rank=3, slowdown=2.5),
    FaultSpec.degraded_links(0.2, factor=0.4, seed=99),
    FaultSpec(faults=(Fault("link_flap", link_frac=0.1, factor=0.5,
                            period=1e-3, duty=0.5, cycles=3),)),
    FaultSpec(faults=(Fault("latency_jitter", sigma=0.3),)),
    ACCEPTANCE,
]

CHILD = r"""
import dataclasses
from repro.faults import FaultSpec, as_fault_spec
from repro.faults.fastsim import apply_faults, sweep_faults
from repro.platforms import get_platform
from repro.workloads import get_workload

specs = [as_fault_spec(d) for d in PAYLOAD["specs"]]
acc = as_fault_spec(PAYLOAD["acceptance"])
hpl = get_workload("hpl", **PAYLOAD["hpl"])
tf = get_workload("transformer", **PAYLOAD["tf"])
bdw, pod = get_platform("bdw-local"), get_platform("tpu-v5e-pod")
prm, step = bdw.fastsim(), tf.fastsim_model(pod).params
OUT["apply"] = [[dataclasses.asdict(apply_faults(prm, s)),
                 dataclasses.asdict(apply_faults(prm, s, grid=(4, 4))),
                 dataclasses.asdict(apply_faults(step, s))] for s in specs]
OUT["sweep_hpl"] = sweep_faults(hpl, bdw, specs)
OUT["sweep_tf"] = sweep_faults(tf, pod, specs)
OUT["predict_hpl"] = [hpl.predict(bdw, faults=s)["time_s"] for s in specs]
OUT["predict_tf"] = [tf.predict(pod, faults=s)["time_s"] for s in specs]
OUT["des_hpl"] = hpl.predict_des(bdw, faults=acc)
OUT["des_tf"] = tf.predict_des(pod, faults=acc)
"""


@pytest.fixture(scope="module")
def ref():
    return run_reference(CHILD, {
        "specs": [s.to_dict() for s in SPECS],
        "acceptance": ACCEPTANCE.to_dict(), "hpl": HPL_SMALL,
        "tf": TF_SMALL})


def _close(results, want, key):
    np.testing.assert_allclose([r[key] for r in results],
                               [r[key] for r in want], rtol=RTOL, atol=0,
                               err_msg=key)


# -------------------------------------------------------------- parity

@pytest.mark.parametrize("i", range(len(SPECS)))
def test_apply_faults_bit_identical(ref, i):
    prm = get_platform("bdw-local").fastsim()
    step = get_workload("transformer", **TF_SMALL).fastsim_model(
        get_platform("tpu-v5e-pod")).params
    got = [dataclasses.asdict(apply_faults(prm, SPECS[i])),
           dataclasses.asdict(apply_faults(prm, SPECS[i], grid=(4, 4))),
           dataclasses.asdict(apply_faults(step, SPECS[i]))]
    assert got == ref["apply"][i]


def test_sweep_faults_hpl_within_1e12(ref):
    out = sweep_faults(get_workload("hpl", **HPL_SMALL),
                       get_platform("bdw-local"), SPECS, device="cpu")
    assert len(out) == len(SPECS) + 1
    for key in ("time_s", "gflops", "slowdown_vs_healthy"):
        _close(out, ref["sweep_hpl"], key)


def test_sweep_faults_transformer_within_1e12(ref):
    out = sweep_faults(get_workload("transformer", **TF_SMALL),
                       get_platform("tpu-v5e-pod"), SPECS, device="cpu")
    for key in ("time_s", "mfu", "tokens_per_s", "slowdown_vs_healthy"):
        _close(out, ref["sweep_tf"], key)


@pytest.mark.parametrize("kind", ["hpl", "transformer"])
def test_fault_predictions_within_1e12(ref, kind):
    wl, plat, key = (
        (get_workload("hpl", **HPL_SMALL), get_platform("bdw-local"),
         "predict_hpl") if kind == "hpl" else
        (get_workload("transformer", **TF_SMALL),
         get_platform("tpu-v5e-pod"), "predict_tf"))
    got = [wl.predict(plat, faults=s, device="cpu")["time_s"] for s in SPECS]
    np.testing.assert_allclose(got, ref[key], rtol=RTOL, atol=0)


def test_faulted_des_bit_identical(ref):
    assert get_workload("hpl", **HPL_SMALL).predict_des(
        get_platform("bdw-local"), faults=ACCEPTANCE) == ref["des_hpl"]
    assert get_workload("transformer", **TF_SMALL).predict_des(
        get_platform("tpu-v5e-pod"), faults=ACCEPTANCE) == ref["des_tf"]


# -------------------------------------------- the reference's fault cases

def test_lazy_exports_are_the_fastsim_module_functions():
    import repro_torch.faults as faults
    assert faults.sweep_faults is faults_fastsim.sweep_faults
    assert faults.fault_params is faults_fastsim.fault_params
    with pytest.raises(AttributeError):
        faults.no_such_name


def test_faults_none_bit_identical():
    wl = get_workload("hpl", **HPL_SMALL)
    plat = get_platform("bdw-local")
    base = wl.predict_des(plat)
    for faults in (None, NO_FAULTS, FaultSpec()):
        again = wl.predict_des(plat, faults=faults)
        assert (again["time_s"], again["events"]) == (base["time_s"],
                                                      base["events"])
    prm = plat.fastsim()
    assert apply_faults(prm, None) is prm and apply_faults(prm, NO_FAULTS) \
        is prm
    assert wl.predict(plat, faults=NO_FAULTS, device="cpu") == wl.predict(
        plat, device="cpu")


@pytest.mark.parametrize("kind,plat_name,params", [
    ("hpl", "bdw-local", HPL_SMALL),
    ("transformer", "tpu-v5e-pod", TF_SMALL),
])
def test_acceptance_scenario_des_with_trace_markers(kind, plat_name, params):
    wl = get_workload(kind, **params)
    plat = get_platform(plat_name)
    healthy = wl.predict_des(plat)
    app = wl.des_app(plat, trace=True, faults=ACCEPTANCE)
    app.run()
    trace = app.engine.trace
    assert app.engine.now > healthy["time_s"]
    names = {f["name"] for f in trace.summary()["faults"]}
    assert {"straggler", "link_degrade"} <= names
    doc = to_chrome_json(trace)
    validate_chrome_events(doc)
    tids = {e["args"]["name"] for e in doc["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert "faults" in tids


@pytest.mark.parametrize("grid", [(2, 4), (4, 4)])
def test_straggler_cross_validation_des_vs_fastsim(grid):
    """The fastsim straggler mapping tracks the DES within 15% (the gate
    is calibrated across geometries)."""
    plat = get_platform("bdw-local")
    P, Q = grid
    wl = get_workload("hpl", N=1536, nb=128, P=P, Q=Q, lookahead=0)
    spec = FaultSpec.straggler(rank=1, slowdown=2.0)
    des = wl.predict_des(plat, faults=spec)
    fast = wl.predict(plat, faults=spec, device="cpu")
    rel = abs(des["time_s"] - fast["time_s"]) / des["time_s"]
    assert rel < 0.15, (P, Q, des["time_s"], fast["time_s"])


def test_transformer_straggler_fastsim_near_exact():
    wl = get_workload("transformer", **TF_SMALL)
    plat = get_platform("tpu-v5e-pod")
    spec = FaultSpec.straggler(rank=3, slowdown=3.0)
    des = wl.predict_des(plat, faults=spec)
    fast = wl.predict(plat, faults=spec, device="cpu")
    rel = abs(des["time_s"] - fast["time_s"]) / des["time_s"]
    assert rel < 0.05, (des["time_s"], fast["time_s"])


def test_acceptance_scenario_crossvalidates():
    wl = get_workload("hpl", **HPL_SMALL)
    plat = get_platform("bdw-local")
    des = wl.predict_des(plat, faults=ACCEPTANCE)
    fast = wl.predict(plat, faults=ACCEPTANCE, device="cpu")
    rel = abs(des["time_s"] - fast["time_s"]) / des["time_s"]
    assert rel < 0.15, (des["time_s"], fast["time_s"])


def test_fail_stop_reports_partial_runs():
    out = get_workload("hpl", **HPL_SMALL).predict_des(
        get_platform("bdw-local"), faults=FaultSpec.fail_stop(rank=2,
                                                              at=1e-4))
    assert out["failed"] and out["gflops"] == 0.0
    assert 0 <= out["n_finished"] < 8
    out = get_workload("transformer", **TF_SMALL).predict_des(
        get_platform("tpu-v5e-pod"), faults=FaultSpec.fail_stop(rank=0))
    assert out["failed"] and out["n_finished"] < 8


def test_fastsim_rejects_des_only_kinds():
    wl = get_workload("hpl", **HPL_SMALL)
    plat = get_platform("bdw-local")
    params = plat.fastsim()
    with pytest.raises(ValueError, match="fail_stop"):
        apply_faults(params, FaultSpec.fail_stop(rank=0))
    with pytest.raises(ValueError, match="DES-only"):
        apply_faults(params, FaultSpec(faults=(
            Fault("link_degrade", node=3, factor=0.5),)))
    with pytest.raises(ValueError, match="fail_stop"):
        wl.predict(plat, faults=FaultSpec.fail_stop(rank=0), device="cpu")
    with pytest.raises(ValueError, match="fail_stop"):
        sweep_faults(wl, plat, [FaultSpec.fail_stop(rank=0)], device="cpu")


def test_sweep_faults_one_program_fault_grid():
    wl = get_workload("hpl", **HPL_SMALL)
    plat = get_platform("bdw-local")
    specs = [FaultSpec.straggler(rank=1, slowdown=s)
             for s in (1.5, 2.0, 4.0)]
    t0 = trace_count()
    out = sweep_faults(wl, plat, specs, device="cpu")
    assert trace_count() - t0 <= 1
    assert len(out) == 4
    assert out[0]["slowdown_vs_healthy"] == pytest.approx(1.0)
    slows = [r["slowdown_vs_healthy"] for r in out[1:]]
    assert all(s >= 1.0 for s in slows)
    assert slows == sorted(slows)
    plain = sweep_faults(wl, plat, specs, baseline=False, device="cpu")
    assert [r["time_s"] for r in plain] == [r["time_s"] for r in out[1:]]
    assert "slowdown_vs_healthy" not in plain[0]


def test_fault_params_one_variant_per_scenario():
    prm = get_platform("bdw-local").fastsim()
    out = fault_params(prm, [None] + SPECS, grid=(2, 4))
    assert out[0] is prm and len(out) == len(SPECS) + 1
    assert out[1].peak_flops < prm.peak_flops
    assert out[3].bcast_bw_scale < prm.bcast_bw_scale
    assert out[5] == prm          # latency jitter is mean-one
