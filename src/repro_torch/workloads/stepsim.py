"""stepsim — the transformer train step as a batched float64 torch program.

The fastsim idea applied to the second application: where fastsim
vectorizes HPL's panel recurrence, this module vectorizes the train-step
schedule the DES app (core/apps/transformer.py) walks event by event —
per-layer roofline compute, ring collectives on the model axis, a tail
gradient ring on the data axis, and a cross-pod DCN ring when the job
spans pods.

This is the port of ``repro.workloads.stepsim``.  ``StepParams`` is a
frozen dataclass whose leaves become ``(B,)`` float64 tensors on the
device: ``sweep_step`` pads the scenario batch to a power of two (the
lane axis) and runs it as one batch, so model-size x mesh x platform
what-if grids reuse one program per lane count — the sweep-engine
contract ``sweep_hpl`` gives HPL.  Autograd flows through
``step_time_traced`` for calibration.  Every expression keeps the
reference's operation order, so step times agree with it to rounding.

The closed forms mirror the DES timing model, not an idealized one:
ring rounds serialize at ``per_round/bw + phase_latency`` where
``phase_latency`` is the DES's per-message cost (MPI overhead +
rendezvous handshakes + hop latency), so DES-vs-stepsim
cross-validation holds the same way DES-vs-fastsim does for HPL.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.fastsim import _pad_pow2, _record_shard, _shard_lanes
from repro_torch.obs.metrics import RATIO_BUCKETS, get_global_metrics

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class StepParams:
    """One train-step scenario; every field becomes a float64 leaf.

    Group sizes are floats so the whole scenario — including the mesh —
    can ride the lane axis; bytes fields follow the DES wire convention
    (bytes moved through one device over the whole ring).
    """
    # chip (per rank)
    peak_flops: float
    gemm_eff: float
    mem_bw: float
    mem_eff: float
    # fabric
    link_bw: float               # B/s per ICI link per direction
    phase_latency: float         # per ring-round message cost (s)
    pod_bw: float = 25e9         # effective per-flow cross-pod B/s
    pod_latency: float = 10e-6   # per cross-pod round latency (s)
    # per-chip workload (derived from the model dims by the workload)
    flops_per_layer: float = 0.0
    bytes_per_layer: float = 0.0
    coll_model_bytes: float = 0.0   # ring wire bytes per layer, model axis
    coll_data_bytes: float = 0.0    # tail ring wire bytes, data axis
    n_layers: float = 1.0
    model_group: float = 1.0
    data_group: float = 1.0
    pod_group: float = 1.0
    overlap: float = 0.0         # fraction of comm hidden under compute


_STEP_FIELDS = tuple(f.name for f in dataclasses.fields(StepParams))


def _f64_step_params(p: StepParams) -> StepParams:
    return StepParams(**{n: float(getattr(p, n)) for n in _STEP_FIELDS})


def _ring(wire_bytes, group, bw, latency):
    """Ring-collective time under the DES schedule: the wire bytes
    stream at the link rate while 2(n-1) rounds each pay the per-message
    latency; groups of one collapse to zero."""
    rounds = 2.0 * (group - 1.0)
    t = wire_bytes / bw + rounds * latency
    return torch.where(group > 1.0, t, 0.0)


def _step_core(p: StepParams):
    """Step time; every leaf a float64 tensor, 0-d or (B,)."""
    compute = torch.maximum(
        p.flops_per_layer / (p.peak_flops * p.gemm_eff),
        p.bytes_per_layer / (p.mem_bw * p.mem_eff))
    coll = _ring(p.coll_model_bytes, p.model_group, p.link_bw,
                 p.phase_latency)
    # overlap=0 reproduces the DES's serial schedule; >0 models async
    # collectives hidden under compute (the SimXLA overlap knob)
    layer = torch.maximum(compute, coll) \
        + (1.0 - p.overlap) * torch.minimum(compute, coll)
    tail = _ring(p.coll_data_bytes, p.data_group, p.link_bw,
                 p.phase_latency)
    # cross-pod ring: the DES rings wire/data_group bytes over the pod
    # group through the pod gateways
    # (torch.maximum splits a tie's gradient evenly, as JAX's max does)
    pod_wire = p.coll_data_bytes / torch.maximum(
        p.data_group, p.data_group.new_tensor(1.0))
    pod = _ring(pod_wire, p.pod_group, p.pod_bw, p.pod_latency)
    return p.n_layers * layer + tail + pod


# ----------------------------------------------------------- lane shapes
# The reference jit-compiles the step core once per lane shape; the port
# runs it eagerly and builds no program.  It only records each (padded
# lane count, device) it has dispatched, so compile-once assertions keep
# their meaning: a sweep at a shape seen before adds nothing.  Under
# lane sharding (``fastsim.lane_sharding``) each device runs its
# contiguous block of lanes and records its own block shape.
_SHAPES_SEEN: set = set()


def trace_count() -> int:
    """How many distinct (padded lane count, device) shapes the step core
    has been dispatched at — the port's stand-in for the reference's
    retrace count (no program is built), for compile-once assertions in
    tests and benchmarks (mirrors ``fastsim.trace_count``)."""
    return len(_SHAPES_SEEN)


def _leaves(p: StepParams, device: torch.device) -> StepParams:
    """``p`` with every leaf a float64 tensor on ``device`` (tensors
    that already are keep their autograd history)."""
    return StepParams(**{n: torch.as_tensor(getattr(p, n), dtype=F64,
                                            device=device)
                         for n in _STEP_FIELDS})


def step_time_traced(p: StepParams, *,
                     device: DeviceLike = "cuda") -> torch.Tensor:
    """Differentiable scalar step time: leaves of ``p`` may be float64
    tensors with ``requires_grad``; the result is a 0-d tensor to call
    ``backward()`` on — the autodiff surface for gradient calibration of
    step parameters."""
    return _step_core(_leaves(p, resolve_device(device)))


def _stack_step_params(prm_list: Sequence[StepParams], lanes: Sequence[int],
                       device: torch.device) -> StepParams:
    """(lanes,) float64 leaves on ``device``, in one host-to-device copy."""
    rows = torch.tensor([[float(getattr(prm_list[i], n)) for i in lanes]
                         for n in _STEP_FIELDS], dtype=F64, device=device)
    return StepParams(**dict(zip(_STEP_FIELDS, rows.unbind(0))))


def _result(p: StepParams, t: float) -> Dict:
    flops = p.n_layers * p.flops_per_layer
    return {"time_s": t, "step_s": t,
            "mfu": flops / max(t, 1e-30) / p.peak_flops}


def _run_block(prm_list: Sequence[StepParams], lanes: Sequence[int],
               device: torch.device) -> torch.Tensor:
    """Issue the step core over ``lanes`` on one device; the lane times
    stay there (the caller copies them back)."""
    _SHAPES_SEEN.add((len(lanes), str(device)))
    with torch.no_grad():
        return _step_core(_stack_step_params(prm_list, lanes, device))


def sweep_step(params_list: Sequence[StepParams], *,
               device: DeviceLike = "cuda") -> List[Dict]:
    """Run a step-scenario sweep as one batch on ``device``.

    The batch is padded to a power of two so repeat sweeps of any size
    reuse the program cache; results come back in input order as dicts
    with ``time_s``/``step_s``/``mfu`` (model-level fields like
    tokens/s are layered on by ``TransformerWorkload``).  Under lane
    sharding the padded lanes split over the local devices, one
    contiguous block each, issued in turn from the host (see
    ``fastsim``'s lane-sharding note: no faster than one device).
    """
    dev = resolve_device(device)
    prm_list = [_f64_step_params(p) for p in params_list]
    if not prm_list:
        return []
    lanes = _pad_pow2(list(range(len(prm_list))))
    m = get_global_metrics()
    pre, t0 = trace_count(), time.perf_counter()
    shard = _shard_lanes(len(lanes), dev)
    if shard is None:
        out = _run_block(prm_list, lanes, dev).cpu().numpy()
    else:
        per = len(lanes) // len(shard)
        blocks = [_run_block(prm_list, lanes[i:i + per], d)
                  for i, d in zip(range(0, len(lanes), per), shard)]
        out = np.concatenate([b.cpu().numpy() for b in blocks])
    if m.enabled:
        # same taxonomy as fastsim._record_dispatch, one shared "step"
        # bucket (the step core is shape-monomorphic)
        dt = time.perf_counter() - t0
        misses = trace_count() - pre
        if misses:
            m.counter("stepsim.compile_misses", bucket="step").inc(misses)
            m.histogram("stepsim.compile_wall_s", bucket="step").observe(dt)
        else:
            m.counter("stepsim.compile_hits", bucket="step").inc()
            m.histogram("stepsim.dispatch_wall_s").observe(dt)
        m.counter("stepsim.lanes_live").inc(len(prm_list))
        m.counter("stepsim.lanes_padded").inc(len(lanes) - len(prm_list))
        m.histogram("stepsim.sweep_occupancy", RATIO_BUCKETS).observe(
            len(prm_list) / len(lanes))
        _record_shard(m, shard, prefix="stepsim")
    return [_result(p, float(t))
            for p, t in zip(prm_list, out[:len(prm_list)])]


def simulate_step_fast(p: StepParams, *,
                       device: DeviceLike = "cuda") -> Dict:
    """Single-scenario convenience over ``sweep_step``."""
    return sweep_step([p], device=device)[0]
