"""Deterministic expansion: ``CampaignSpec`` -> run matrix.

``expand`` is pure planning — no simulation, no compiles.  It resolves
every platform selector (registry lookups, TOP500 parses), crosses the
grid axes, and emits one frozen ``RunCase`` per unit of work in a fixed
order, so the same spec always yields the same matrix (and, downstream,
byte-equal run manifests modulo timing fields).

Two case kinds come out, matching the two batched execution paths:

  * ``grid``  — one (workload, registry platform, axis overrides,
    fault, seed) cell; the executor serves all of these through one
    ``PredictionService.predict_batch`` (one sweep per model family
    per wave).
  * ``fleet`` — one TOP500 machine of one list edition; the executor
    runs each edition through ``top500.predict_fleet`` (one forced-
    bucket compile per edition, per-fabric calibration included).

Incompatibilities (a workload whose ``validate`` rejects a platform, an
axis key the workload doesn't know) are *skipped with a reason* in
lenient mode — a fleet campaign should not die because one machine
can't host one workload — and raise under ``strict=True``.  Fault
scenarios are re-seeded per seed-axis value (``dataclasses.replace``),
which is how Cornebize & Legrand's "variability matters" point becomes
a reportable axis instead of noise.
"""
from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.faults.spec import FaultSpec
from repro_torch.workloads.base import WorkloadSpec

from .spec import CampaignSpec, PlatformSelector

#: inferred TOP500 platform names carry a list-position prefix
#: ("r017-selene"); drift matching across editions keys on the slug.
_RANK_PREFIX = re.compile(r"^r\d{1,4}-")


def machine_key(platform_name: str) -> str:
    """The edition-stable identity of an inferred TOP500 platform (its
    name minus the ``rNNN-`` list-position prefix)."""
    return _RANK_PREFIX.sub("", platform_name)


@dataclasses.dataclass(frozen=True)
class RunCase:
    """One planned run.  ``key`` is the human-stable cell id (unique
    within the campaign and independent of matrix position); ``index``
    is the deterministic position used for run ids."""
    index: int
    kind: str                          # "grid" | "fleet"
    key: str
    workload: WorkloadSpec
    platform: str                      # registry name / inferred name
    overrides: Tuple[Tuple[str, Any], ...] = ()
    fault: Optional[FaultSpec] = None
    seed: int = 0
    edition: str = ""                  # fleet cases only

    @property
    def run_id(self) -> str:
        return f"{self.index:05d}"

    def to_meta(self) -> Dict[str, Any]:
        """The JSON-safe identity block this case contributes to its
        run-manifest line (fully deterministic)."""
        d: Dict[str, Any] = {
            "run": self.run_id, "cell": self.key, "kind": self.kind,
            "workload": self.workload.to_dict(),
            "platform": self.platform, "seed": self.seed,
            "overrides": {k: v for k, v in self.overrides},
            "fault": None if self.fault is None else self.fault.to_dict(),
        }
        if self.edition:
            d["edition"] = self.edition
            d["machine"] = machine_key(self.platform)
        return d


@dataclasses.dataclass
class RunMatrix:
    """The expanded campaign: grid cases + per-edition fleets, plus the
    resolution products the executor needs (Platform objects) and the
    audit trail of skipped cells."""
    spec: CampaignSpec
    cases: List[RunCase]
    platforms: Dict[str, Any]               # name -> Platform (grid)
    fleets: Dict[str, List[Any]]            # edition -> [Platform, ...]
    skipped: List[Tuple[str, str]]          # (cell key, reason)

    @property
    def grid_cases(self) -> List[RunCase]:
        return [c for c in self.cases if c.kind == "grid"]

    @property
    def fleet_cases(self) -> List[RunCase]:
        return [c for c in self.cases if c.kind == "fleet"]

    def editions(self) -> List[str]:
        seen: List[str] = []
        for c in self.fleet_cases:
            if c.edition not in seen:
                seen.append(c.edition)
        return seen


def _resolve_top500(sel: PlatformSelector) -> List[Any]:
    """A top500 selector -> inferred Platform list (list order)."""
    from repro_torch.top500 import infer_platforms, parse_top500, \
        sample_list_path
    src = sel.top500
    if src.startswith("sample:"):
        src = sample_list_path(src[len("sample:"):])
    rows = parse_top500(src).rows
    if sel.limit:
        rows = rows[:sel.limit]
    if not rows:
        raise ValueError(f"campaign selector top500={sel.top500!r}: "
                         "no parseable rows")
    return infer_platforms(rows)


def _wl_axis_cells(spec: CampaignSpec,
                   w: WorkloadSpec) -> List[Tuple[Tuple[str, Any], ...]]:
    """The axis cross-product as applied to workload ``w``: only the
    axes ``w`` knows participate (others contribute no variation for
    this workload)."""
    keys = set(spec.axis_candidates().get(w.kind, ()))
    mine = [(k, vals) for k, vals in spec.axes if k in keys]
    if not mine:
        return [()]
    return [tuple(zip((k for k, _ in mine), combo))
            for combo in itertools.product(*(vals for _, vals in mine))]


def expand(spec: CampaignSpec, *, strict: bool = False) -> RunMatrix:
    """Expand a validated spec into its deterministic run matrix.

    Grid order: workload-major, then platform, then axis cell, then
    fault scenario, then seed — the spec's own (normalized) orders
    throughout.  Fleet order: selector order, then list order.  The
    budget is a hard cap: a matrix that would exceed
    ``spec.budget.max_runs`` raises before any case is built.
    """
    from repro_torch.platforms import get_platform
    from repro_torch.workloads import workload_from_spec
    spec.validate()

    cases: List[RunCase] = []
    skipped: List[Tuple[str, str]] = []
    platforms: Dict[str, Any] = {}
    fleets: Dict[str, List[Any]] = {}

    reg_sel = [s for s in spec.platforms if s.kind == "registry"]
    top_sel = [s for s in spec.platforms if s.kind == "top500"]
    for sel in reg_sel:
        platforms[sel.registry] = get_platform(sel.registry)
    for sel in top_sel:
        label = sel.edition_label()
        if label in fleets:
            raise ValueError(
                f"campaign {spec.name!r}: duplicate fleet edition label "
                f"{label!r}; set selector edition= to disambiguate")
        fleets[label] = _resolve_top500(sel)

    # ------------------------------------------------------ budget gate
    n_grid = 0
    for w in spec.workloads:
        n_grid += (len(reg_sel) * len(_wl_axis_cells(spec, w))
                   * len(spec.faults) * len(spec.seeds))
    n_fleet = sum(len(ps) for ps in fleets.values())
    if n_grid + n_fleet > spec.budget.max_runs:
        raise ValueError(
            f"campaign {spec.name!r}: matrix would be "
            f"{n_grid + n_fleet} runs ({n_grid} grid + {n_fleet} fleet), "
            f"over budget max_runs={spec.budget.max_runs}; shrink an "
            "axis or raise the budget")

    # ------------------------------------------------------- grid cases
    index = 0
    for wi, w in enumerate(spec.workloads):
        for sel in reg_sel:
            plat = platforms[sel.registry]
            for ci, cell in enumerate(_wl_axis_cells(spec, w)):
                cell_spec = w.replace(**dict(cell)) if cell else w
                try:
                    workload_from_spec(cell_spec).validate(plat)
                except (ValueError, KeyError) as exc:
                    key = f"{w.kind}[{wi}]@{sel.registry}#c{ci}"
                    if strict:
                        raise ValueError(f"campaign {spec.name!r}: cell "
                                         f"{key}: {exc}") from exc
                    skipped.append((key, str(exc)))
                    continue
                for fi, fault in enumerate(spec.faults):
                    for seed in spec.seeds:
                        if fault is not None:
                            fault_s = dataclasses.replace(fault, seed=seed)
                        else:
                            fault_s = None
                        cases.append(RunCase(
                            index=index, kind="grid",
                            key=(f"{w.kind}[{wi}]@{sel.registry}"
                                 f"#c{ci}f{fi}s{seed}"),
                            workload=cell_spec, platform=sel.registry,
                            overrides=cell, fault=fault_s, seed=seed))
                        index += 1

    # ------------------------------------------------------ fleet cases
    hpl = WorkloadSpec(kind="hpl")
    for edition, plats in fleets.items():
        for plat in plats:
            cases.append(RunCase(
                index=index, kind="fleet",
                key=f"fleet:{edition}/{machine_key(plat.name)}",
                workload=hpl, platform=plat.name, edition=edition))
            index += 1

    return RunMatrix(spec=spec, cases=cases, platforms=platforms,
                     fleets=fleets, skipped=skipped)
