"""Elastic scaling: restart a run on a different device count.

The pieces that make this a plan rather than a prayer (in the JAX
reference package; the port's ``checkpoint/``, ``data/pipeline.py`` and
``sharding/specs.py`` are still to be ported with training, ROADMAP §1,
so here the plan is arithmetic on meshes and batches only):
  * checkpoints store *full logical arrays* (manifest carries shapes), so
    restore re-shards onto whatever mesh exists (checkpoint.restore with
    new shardings);
  * the data pipeline is a pure function of (step, dp_rank, dp_size)
    (data/pipeline.py), so the token stream continues exactly;
  * sharding rules are derived from (cfg, mesh) (sharding/specs.py), not
    hard-coded — a (8,16) degraded mesh yields a valid rule set.

``restart_plan_for_faults`` closes the loop with the fault layer: a
fail-stop ``FaultSpec`` (the same object the DES ran, or the operator's
description of what actually died) maps dead chips to their
data-parallel rows, and the surviving mesh is re-planned through
``elastic_restart_plan``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class ElasticPlan:
    old_mesh: Tuple[int, ...]
    new_mesh: Tuple[int, ...]
    resume_step: int
    dp_size_old: int
    dp_size_new: int
    per_device_batch_new: int
    notes: str = ""


def elastic_restart_plan(*, global_batch: int, resume_step: int,
                         old_mesh: Tuple[int, ...],
                         new_mesh: Tuple[int, ...]) -> ElasticPlan:
    """Validate that a resize keeps the global batch and data order
    intact, and compute the new per-device partitioning."""
    dp_old, dp_new = old_mesh[0], new_mesh[0]
    if global_batch % dp_new != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by new dp={dp_new};"
            " adjust microbatching before resuming")
    return ElasticPlan(
        old_mesh=old_mesh, new_mesh=new_mesh, resume_step=resume_step,
        dp_size_old=dp_old, dp_size_new=dp_new,
        per_device_batch_new=global_batch // dp_new,
        notes="same global batch; data pipeline replays from resume_step "
              "with dp_size_new shards; params re-sharded at restore")


def restart_plan_for_faults(faults, *, global_batch: int, resume_step: int,
                            old_mesh: Tuple[int, ...],
                            ranks_per_node: int = 1) -> ElasticPlan:
    """Plan the elastic restart implied by a fail-stop fault scenario.

    Dead chips are read from the scenario's ``fail_stop`` faults
    (rank-scoped directly; node-scoped via ``ranks_per_node``), mapped
    to their data-parallel rows on ``old_mesh = (rows, cols)`` with the
    mesh's row-major rank layout (``rank = row*cols + col``), and every
    row containing a casualty is evicted — tensor-parallel groups span a
    row, so one dead chip takes its whole row's replica down.  The
    surviving mesh is validated and partitioned by
    ``elastic_restart_plan``.
    """
    from repro_torch.faults import as_fault_spec
    spec = as_fault_spec(faults)
    rows, cols = int(old_mesh[0]), int(old_mesh[1])
    dead_ranks = set()
    for f in (spec.faults if spec is not None else ()):
        if f.kind != "fail_stop":
            continue
        if f.rank >= 0:
            dead_ranks.add(f.rank)
        elif f.node >= 0:
            dead_ranks.update(range(f.node * ranks_per_node,
                                    (f.node + 1) * ranks_per_node))
    if not dead_ranks:
        raise ValueError("restart_plan_for_faults: scenario has no "
                         "fail_stop faults — nothing to restart around")
    dead_rows = sorted({r // cols for r in dead_ranks if r // cols < rows})
    if len(dead_rows) >= rows:
        raise ValueError(
            f"restart_plan_for_faults: all {rows} data-parallel rows "
            f"contain dead chips ({len(dead_ranks)} casualties) — no "
            "surviving replica to restart on")
    new_mesh = (rows - len(dead_rows), cols) + tuple(old_mesh[2:])
    plan = elastic_restart_plan(global_batch=global_batch,
                                resume_step=resume_step,
                                old_mesh=tuple(old_mesh),
                                new_mesh=new_mesh)
    plan.notes = (f"evicted dp rows {dead_rows} "
                  f"({len(dead_ranks)} dead chips); " + plan.notes)
    return plan
