"""Batched fault axes — map a ``FaultSpec`` onto the closed-form models.

The DES injects faults event-by-event; the batched fastsim/stepsim paths
can't, but the straggler/bandwidth subset has a clean steady-state
mapping onto the parameter dataclasses (``FastSimParams`` /
``StepParams``), which makes degraded scenarios ordinary *sweep axes*:
a fault grid runs as one batch, exactly like a hardware what-if grid.
This is the port of ``repro.faults.fastsim``: the mapping is host
Python on the params (a copy of the reference's); only ``sweep_faults``
touches the device.

Mapping semantics (whole-run steady state — start/duration windows are
DES-only precision; the closed forms see a fault as active for the
whole run):

  * straggler   — per-rank factors compose multiplicatively and the
    *max* over ranks divides ``peak_flops`` and ``mem_bw``.  For the
    transformer step this is exact: the mesh is symmetric and ring
    collectives sync every row/column, so the step time IS the
    straggler's own chain.  HPL gates more loosely — a slow rank holds
    up the serial panel chain only through its process column's syncs
    (it co-owns 1/Q of panel factorizations) and its row-ring forward,
    with the rest absorbed by pipeline slack — so when the run geometry
    is known (``grid=(P, Q)``) the slowdown is attenuated by the
    exposure fraction ``min(1, 3/(P*Q))`` (≈ three ranks' worth of the
    grid's work: the straggler, its column sync, its row forward),
    calibrated against the DES across grid geometries.
  * link_degrade — a seeded fraction ``p`` of links at ``factor``x
    capacity.  A route of ``ROUTE_LINKS`` links is degraded with
    probability ``q = 1 - (1-p)^ROUTE_LINKS``; the expected per-transfer
    time multiplier is ``(1-q) + q/factor``, so effective bandwidth
    scales by its inverse.  Node-scoped link faults (``node >= 0``)
    have no closed form here — DES-only.
  * link_flap   — link_degrade with the duty-cycle-averaged factor
    ``duty*factor + (1-duty)``.
  * latency_jitter — the per-message draw is mean-one by construction,
    so the expected-time mapping is the identity (the DES shows the
    spread; the closed form predicts the mean).
  * fail_stop   — no steady state exists (the run deadlocks); raises.

``sweep_faults`` is the one-batch entry point: one workload/platform
pair swept across a list of fault scenarios.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch._device import DeviceLike
from repro_torch.faults.spec import FaultSpec, as_fault_spec

# links per typical route (fat-tree inter-edge path; torus routes are
# comparable at small mesh radius) — the q = 1-(1-p)^L exposure model
ROUTE_LINKS = 4


def _aggregate(spec: FaultSpec) -> Tuple[float, float]:
    """(compute slowdown, bandwidth scale) for the whole-run mapping."""
    per_rank = {}
    bw_scale = 1.0
    for i, f in enumerate(spec.faults):
        if f.kind == "straggler":
            per_rank[f.rank] = per_rank.get(f.rank, 1.0) * f.factor
        elif f.kind == "fail_stop":
            raise ValueError(
                "fail_stop has no closed-form mapping (the run deadlocks)"
                " — use the DES path")
        elif f.kind in ("link_degrade", "link_flap"):
            if f.node >= 0:
                raise ValueError(
                    f"node-scoped {f.kind} faults are DES-only (no "
                    "closed-form route exposure for one node's links)")
            factor = f.factor if f.kind == "link_degrade" \
                else f.duty * f.factor + (1.0 - f.duty)
            q = 1.0 - (1.0 - f.link_frac) ** ROUTE_LINKS
            bw_scale *= 1.0 / ((1.0 - q) + q / factor)
        # latency_jitter: mean-one draw -> identity in expectation
    slowdown = max(per_rank.values()) if per_rank else 1.0
    return slowdown, bw_scale


def apply_faults(params, faults, *, grid: Optional[Tuple[int, int]] = None):
    """Return a copy of a ``FastSimParams`` or ``StepParams`` with a
    fault scenario folded into its leaves (None/empty spec
    returns ``params`` unchanged).  ``grid=(P, Q)`` enables the HPL
    partial-gating straggler attenuation (see module docstring)."""
    spec = as_fault_spec(faults)
    if spec is None:
        return params
    slowdown, bw_scale = _aggregate(spec)
    if grid is not None and slowdown > 1.0:
        P, Q = grid
        gate = min(1.0, 3.0 / (P * Q))
        slowdown = 1.0 + (slowdown - 1.0) * gate
    fields = {f.name for f in dataclasses.fields(params)}
    over = {"peak_flops": params.peak_flops / slowdown,
            "mem_bw": params.mem_bw / slowdown}
    if "bcast_bw_scale" in fields:           # FastSimParams (HPL)
        over["bcast_bw_scale"] = params.bcast_bw_scale * bw_scale
        over["swap_bw_scale"] = params.swap_bw_scale * bw_scale
    elif "link_bw" in fields:                # StepParams (transformer)
        over["link_bw"] = params.link_bw * bw_scale
        if "pod_bw" in fields:
            over["pod_bw"] = params.pod_bw * bw_scale
    return dataclasses.replace(params, **over)


def fault_params(params, specs: Sequence, *,
                 grid: Optional[Tuple[int, int]] = None) -> List:
    """One params variant per fault scenario (a sweep-axis builder)."""
    return [apply_faults(params, s, grid=grid) for s in specs]


def sweep_faults(workload, platform, specs: Sequence,
                 baseline: bool = True, *,
                 device: DeviceLike = "cuda") -> List[dict]:
    """Sweep one workload/platform pair across fault scenarios in ONE
    batch on ``device``.  With ``baseline=True`` an unfaulted lane is
    prepended, so ``out[0]`` is the healthy prediction and each result
    carries a ``slowdown_vs_healthy`` field."""
    model = workload.fastsim_model(platform)
    cfg = getattr(model, "cfg", None)          # HPL carries its geometry
    grid = (cfg.P, cfg.Q) if cfg is not None else None
    scenarios: List[Optional[FaultSpec]] = \
        ([None] if baseline else []) + list(specs)
    out = model.sweep(fault_params(model.params, scenarios, grid=grid),
                      device=device)
    if baseline:
        t0 = out[0]["time_s"]
        for r in out:
            r["slowdown_vs_healthy"] = r["time_s"] / t0
    return out
