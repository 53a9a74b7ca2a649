"""Parity of the port's fault-tolerance layer (``repro_torch.ft``) with the
JAX reference, on the CPU, and the reference's own ft tests run against
the port.

``StepTimeMonitor``, the restart plans, the straggler what-if and the DES
fault impacts are host Python copied from the reference: equal.
``simulate_fault_impact``'s fastsim backend runs the float64 closed
forms: within 1e-12 relative.  The same helper code (``HELPERS``) drives
both packages: here with the port's names and ``device="cpu"``, in a
child interpreter (``torch_reference.run_reference``, once per module)
with the reference's, since ``repro.core`` needs jax's x64 alias.  The
straggler what-if reads a synthetic dry-run record in the reference's
schema from ``experiments/dryrun`` under a temporary working directory.
"""
import dataclasses
import inspect
import json
import statistics

import numpy as np
import pytest

from repro_torch.core.apps.transformer import (LayerWork, StepWorkload,
                                               TransformerStepSim)
from repro_torch.faults import Fault, FaultSpec
from repro_torch.ft import (StepTimeMonitor, elastic_restart_plan,
                            restart_plan_for_faults, simulate_fault_impact,
                            simulate_straggler_impact)
from repro_torch.workloads import get_workload
from torch_reference import assert_close, run_reference

RTOL = 1e-12
TF_SMALL = dict(mesh=(2, 4), num_layers=3)
HPL_SMALL = dict(N=1536, nb=128, P=2, Q=4, lookahead=0)
# tests/test_system.py:124-130's record with an all-gather, as qwen2-0.5b
# (24 layers on 256 ranks, ~1.4M events a DES run)
STRAGGLER_RECORD = {
    "arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "16x16",
    "chips": 256, "kind": "train",
    "roofline": {"hlo_flops_total": 2.56e17, "hlo_bytes_total": 2.56e14},
    "collectives": {"all-reduce": {"count": 10, "wire_bytes": 1e9},
                    "all-gather": {"count": 24, "wire_bytes": 5e8}}}


def _monitor_cases():
    """Seeded step-time sequences (lognormal noise around 0.1 s, 8% of
    steps slowed 1.2-4x) under four monitor settings.  The last has no
    warm-up: both packages take the median of no step on the first
    record and raise."""
    cases = {}
    for seed, setting in enumerate([
            {}, {"window": 8, "threshold": 1.3, "warmup": 3},
            {"window": 20, "threshold": 2.0, "warmup": 1},
            {"warmup": 0}]):
        rng = np.random.default_rng(seed)
        times = 0.1 * rng.lognormal(0.0, 0.05, 200)
        slow = rng.random(200) < 0.08
        times[slow] *= rng.uniform(1.2, 4.0, int(slow.sum()))
        cases[f"seed{seed}"] = {"setting": setting,
                                "times": [float(t) for t in times]}
    return cases


def _plan_cases():
    """Seeded fail-stop scenarios on 2-d and 3-d meshes, by rank (some
    past the mesh's end) and by node, with stragglers mixed in; batches
    every survivor count divides (720,720 = lcm(1..16)) or not; some
    scenarios leave no survivor or have no fail-stop."""
    rng = np.random.default_rng(23)
    cases = {}
    for i in range(12):
        rows, cols = int(rng.choice([1, 4, 8, 16])), int(
            rng.choice([1, 4, 16]))
        mesh = [rows, cols] + ([2] if i % 4 == 3 else [])
        rpn = int(rng.choice([1, 2, 4]))
        n = rows * cols
        faults = []
        for _ in range(0 if i % 6 == 5 else int(rng.integers(1, 4))):
            if rng.random() < 0.5:
                faults.append(Fault("fail_stop",
                                    rank=int(rng.integers(0, n + 4))))
            else:
                faults.append(Fault("fail_stop", node=int(
                    rng.integers(0, max(n // rpn, 1)))))
        if i % 3 == 0:
            faults.append(Fault("straggler", rank=0, factor=2.0))
        cases[f"plan{i}"] = {
            "faults": FaultSpec(faults=tuple(faults), seed=i).to_dict(),
            "global_batch": 99 if i % 5 == 2 else 720720,
            "resume_step": int(rng.integers(0, 1000)),
            "old_mesh": mesh, "ranks_per_node": rpn}
    return cases


MONITOR_CASES = _monitor_cases()
PLAN_CASES = _plan_cases()
ELASTIC_CASES = {
    "halved": {"global_batch": 256, "resume_step": 100,
               "old_mesh": [16, 16], "new_mesh": [8, 16]},
    "indivisible": {"global_batch": 100, "resume_step": 1,
                    "old_mesh": [16, 16], "new_mesh": [7, 16]},
    "grown_3d": {"global_batch": 4096, "resume_step": 7,
                 "old_mesh": [8, 16, 2], "new_mesh": [32, 16, 2]},
}
_STRAGGLER_3X = FaultSpec.straggler(rank=0, slowdown=3.0).to_dict()
_ACCEPTANCE = (FaultSpec.straggler(rank=1, slowdown=2.0, seed=7)
               + FaultSpec.degraded_links(0.05, factor=0.5, seed=7))
IMPACT_CASES = {
    # tests/test_faults.py:374-386
    "fastsim_transformer_straggler": {
        "workload": "transformer", "params": {}, "platform": "tpu-v5e-pod",
        "faults": _STRAGGLER_3X, "des": False, "threshold": 1.3},
    "des_transformer_fail_stop": {
        "workload": "transformer", "params": TF_SMALL,
        "platform": "tpu-v5e-pod",
        "faults": FaultSpec.fail_stop(rank=3).to_dict(), "des": True,
        "threshold": 1.3},
    # the acceptance scenario (a straggler plus degraded links) on both
    # workloads and backends, and a lower eviction threshold
    "fastsim_hpl_acceptance": {
        "workload": "hpl", "params": HPL_SMALL, "platform": "bdw-local",
        "faults": _ACCEPTANCE.to_dict(), "des": False, "threshold": 1.3},
    "fastsim_transformer_links": {
        "workload": "transformer", "params": {}, "platform": "tpu-v5e-pod",
        "faults": FaultSpec.degraded_links(0.2, factor=0.4,
                                           seed=99).to_dict(),
        "des": False, "threshold": 1.01},
    "des_hpl_acceptance": {
        "workload": "hpl", "params": HPL_SMALL, "platform": "bdw-local",
        "faults": _ACCEPTANCE.to_dict(), "des": True, "threshold": 1.3},
    "des_transformer_straggler": {
        "workload": "transformer", "params": TF_SMALL,
        "platform": "tpu-v5e-pod", "faults": _STRAGGLER_3X, "des": True,
        "threshold": 1.05},
}

# Runs on either package: the names it uses come from the namespace it
# is executed in, ``DEVICE`` holds the port's ``device`` argument.
HELPERS = r"""
def monitor(case):
    mon = StepTimeMonitor(**case["setting"])
    calls = []
    mon.on_straggler = lambda *a: calls.append(list(a))
    flagged, medians = [], []
    try:
        for t in case["times"]:
            flagged.append(mon.record(t))
            medians.append(mon.median)
    except statistics.StatisticsError as exc:
        return {"error": str(exc), "steps": len(flagged)}
    return {"flagged": flagged, "flags": list(mon.flags), "calls": calls,
            "medians": medians}


def plan(case):
    try:
        p = restart_plan_for_faults(
            FaultSpec.from_dict(case["faults"]),
            global_batch=case["global_batch"],
            resume_step=case["resume_step"],
            old_mesh=tuple(case["old_mesh"]),
            ranks_per_node=case["ranks_per_node"])
    except ValueError as exc:
        return {"error": str(exc)}
    return {"plan": dataclasses.asdict(p)}


def elastic(case):
    try:
        p = elastic_restart_plan(
            global_batch=case["global_batch"],
            resume_step=case["resume_step"],
            old_mesh=tuple(case["old_mesh"]),
            new_mesh=tuple(case["new_mesh"]))
    except ValueError as exc:
        return {"error": str(exc)}
    return {"plan": dataclasses.asdict(p)}


def impact(case):
    wl = get_workload(case["workload"], **{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in case["params"].items()})
    return simulate_fault_impact(
        wl, case["platform"], FaultSpec.from_dict(case["faults"]),
        des=case["des"], evict_threshold=case["threshold"], **DEVICE)


def straggler_des():
    wl = StepWorkload(layers=[LayerWork(1e-3, [("all-reduce", 1e6, "model")])
                              for _ in range(4)],
                      tail_collectives=[("all-reduce", 1e7, "data")])
    return [TransformerStepSim(wl, mesh=(4, 4)).run(),
            TransformerStepSim(wl, mesh=(4, 4), straggler=(5, 4.0)).run()]
"""

CHILD = r"""
import dataclasses, inspect, json, os, statistics
from repro.core.apps.transformer import (LayerWork, StepWorkload,
                                         TransformerStepSim)
from repro.faults import FaultSpec
from repro.ft import (StepTimeMonitor, elastic_restart_plan,
                      restart_plan_for_faults, simulate_fault_impact,
                      simulate_straggler_impact)
from repro.workloads import get_workload

C = PAYLOAD
DEVICE = {}
exec(C["helpers"])
OUT["monitor"] = {k: monitor(c) for k, c in C["monitor"].items()}
OUT["plan"] = {k: plan(c) for k, c in C["plan"].items()}
OUT["elastic"] = {k: elastic(c) for k, c in C["elastic"].items()}
OUT["impact"] = {k: impact(c) for k, c in C["impact"].items()}
OUT["straggler_des"] = straggler_des()
os.chdir(C["cwd"])
OUT["straggler"] = simulate_straggler_impact("qwen2-0.5b", "train_4k",
                                             slowdown=3.0)
OUT["signatures"] = {f.__name__: str(inspect.signature(f)) for f in (
    StepTimeMonitor, StepTimeMonitor.record, simulate_straggler_impact,
    simulate_fault_impact, elastic_restart_plan, restart_plan_for_faults)}
"""


@pytest.fixture(scope="module")
def cwd(tmp_path_factory):
    """A working directory whose ``experiments/dryrun`` holds the
    straggler what-if's record."""
    root = tmp_path_factory.mktemp("ft")
    (root / "experiments" / "dryrun").mkdir(parents=True)
    (root / "experiments" / "dryrun" / "qwen2-0.5b__train_4k__16x16.json") \
        .write_text(json.dumps(STRAGGLER_RECORD))
    return root


@pytest.fixture(scope="module")
def ref(cwd):
    return run_reference(CHILD, {
        "helpers": HELPERS, "monitor": MONITOR_CASES, "plan": PLAN_CASES,
        "elastic": ELASTIC_CASES, "impact": IMPACT_CASES, "cwd": str(cwd)})


@pytest.fixture(scope="module")
def port():
    ns = dict(globals(), DEVICE={"device": "cpu"})
    exec(HELPERS, ns)
    return ns


def _json(x):
    """As the child's answers arrive: tuples as lists."""
    return json.loads(json.dumps(x))


# ------------------------------------------ the reference's tests, ported

def test_straggler_monitor_flags():
    """tests/test_system.py:62-69."""
    mon = StepTimeMonitor(threshold=1.5, warmup=3)
    for _ in range(10):
        assert not mon.record(0.1)
    assert mon.record(0.5)
    assert mon.flags


def test_straggler_des_whatif_blowup():
    """tests/test_system.py:137-146: a 4x-slow chip must blow up the
    synchronous step time (DES)."""
    wl = StepWorkload(layers=[LayerWork(1e-3, [("all-reduce", 1e6, "model")])
                              for _ in range(4)],
                      tail_collectives=[("all-reduce", 1e7, "data")])
    base = TransformerStepSim(wl, mesh=(4, 4)).run()
    slow = TransformerStepSim(wl, mesh=(4, 4), straggler=(5, 4.0)).run()
    assert slow["step_s"] > 2.0 * base["step_s"]


def test_simulate_fault_impact_generic():
    """tests/test_faults.py:374-386, on the CPU."""
    out = simulate_fault_impact("transformer", "tpu-v5e-pod",
                                FaultSpec.straggler(rank=0, slowdown=3.0),
                                device="cpu")
    assert out["backend"] == "fastsim"
    assert out["blowup"] > 1.0
    assert out["verdict"] in ("evict", "tolerate")
    des = simulate_fault_impact(
        get_workload("transformer", **TF_SMALL), "tpu-v5e-pod",
        FaultSpec.fail_stop(rank=3), des=True, device="cpu")
    assert des["failed"] and des["verdict"] == "restart"
    assert des["blowup"] == float("inf")


def test_restart_plan_for_faults():
    """tests/test_faults.py:389-403."""
    spec = FaultSpec.fail_stop(rank=18) + FaultSpec.fail_stop(node=1)
    plan = restart_plan_for_faults(spec, global_batch=1792, resume_step=500,
                                   old_mesh=(16, 16), ranks_per_node=4)
    assert plan.new_mesh == (14, 16)         # rows 0 (node 1) and 1 (rank 18)
    assert plan.per_device_batch_new == 128
    assert "evicted dp rows [0, 1]" in plan.notes
    with pytest.raises(ValueError, match="no.*fail_stop|fail_stop"):
        restart_plan_for_faults(FaultSpec.straggler(rank=0), global_batch=8,
                                resume_step=0, old_mesh=(4, 4))
    with pytest.raises(ValueError, match="surviving"):
        restart_plan_for_faults(FaultSpec.fail_stop(rank=0), global_batch=8,
                                resume_step=0, old_mesh=(1, 4))


def test_elastic_plan_validates():
    """tests/test_checkpoint_data.py:65-71."""
    plan = elastic_restart_plan(global_batch=256, resume_step=100,
                                old_mesh=(16, 16), new_mesh=(8, 16))
    assert plan.per_device_batch_new == 32
    with pytest.raises(ValueError):
        elastic_restart_plan(global_batch=100, resume_step=1,
                             old_mesh=(16, 16), new_mesh=(7, 16))


# ------------------------------------------------- port vs reference

@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_step_time_monitor_equals_the_reference(port, ref, case):
    got = port["monitor"](MONITOR_CASES[case])
    assert got == ref["monitor"][case]
    if MONITOR_CASES[case]["setting"].get("warmup") == 0:
        assert got == {"error": "no median for empty data", "steps": 0}
    else:
        assert got["flags"] and got["calls"]


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_restart_plan_for_faults_equals_the_reference(port, ref, case):
    assert _json(port["plan"](PLAN_CASES[case])) == ref["plan"][case]


def test_plan_cases_reach_every_outcome(ref):
    """The seeded scenarios plan a restart and hit each refusal."""
    answers = list(ref["plan"].values())
    errors = " ".join(a.get("error", "") for a in answers)
    assert any("plan" in a for a in answers)
    for reason in ("nothing to restart around", "no surviving replica",
                   "not divisible"):
        assert reason in errors, reason


@pytest.mark.parametrize("case", sorted(ELASTIC_CASES))
def test_elastic_restart_plan_equals_the_reference(port, ref, case):
    assert _json(port["elastic"](ELASTIC_CASES[case])) \
        == ref["elastic"][case]


@pytest.mark.parametrize("case", sorted(IMPACT_CASES))
def test_simulate_fault_impact_equals_the_reference(port, ref, case):
    """fastsim within 1e-12 relative; the DES equal."""
    got = _json(port["impact"](IMPACT_CASES[case]))
    want = ref["impact"][case]
    if IMPACT_CASES[case]["des"]:
        assert got == want
    else:
        assert_close(got, want, rtol=RTOL)


def test_straggler_des_equals_the_reference(port, ref):
    assert port["straggler_des"]() == ref["straggler_des"]


def test_simulate_straggler_impact_equals_the_reference(cwd, ref,
                                                        monkeypatch):
    """benchmarks/sec5_whatif.py's call on the host DES (two 256-rank
    runs at qwen2-0.5b's depth), the record read from the default
    ``DRYRUN_DIR`` under the working directory."""
    monkeypatch.chdir(cwd)
    got = simulate_straggler_impact("qwen2-0.5b", "train_4k", slowdown=3.0)
    assert got == ref["straggler"]
    assert got["verdict"] == "evict"


def test_signatures_are_the_reference_s_but_device(ref):
    """Only ``simulate_fault_impact`` computes on a device; it adds
    ``device`` after the reference's parameters.  The rest keep the
    reference's signatures."""
    for f in (StepTimeMonitor, StepTimeMonitor.record,
              simulate_straggler_impact, elastic_restart_plan,
              restart_plan_for_faults):
        assert str(inspect.signature(f)) == ref["signatures"][f.__name__]
    params = list(inspect.signature(simulate_fault_impact).parameters.values())
    assert params[-1].name == "device" and params[-1].default == "cuda"
    ref_sig = inspect.signature(simulate_fault_impact).replace(
        parameters=params[:-1])
    assert str(ref_sig) == ref["signatures"]["simulate_fault_impact"]
