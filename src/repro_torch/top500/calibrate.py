"""Calibration of inferred fleets: residual factors and DES bridging.

Two paths, both recorded in ``Platform.provenance`` so every spec says
which one produced its calibration:

  * ``calibrate_fleet`` — the scalar residual path: one multiplicative
    efficiency factor per fabric family, fit on published Rmax
    (provenance: ``("calibration", "family-factor")``);
  * ``calibrate_against_des`` — the simulation path: run
    the DES->fastsim gradient bridge (``fit_fastsim_to_des``) on a
    small sample of inferred specs and share each family's fitted
    contention table family-wide (provenance:
    ``("calibration", "des-bridge:<donor>")``).

Residual calibration: fit the systematic sim-vs-published gap.

Cornebize & Legrand's central finding is that simulation predicts
*relative* behavior faithfully while absolute accuracy hinges on
calibration.  Heuristic-inferred fleets inherit a systematic per-fabric
bias (our fat-tree geometry is conventional, not the machine's wiring;
contention scales are uncalibrated), so we fit one multiplicative
efficiency factor per fabric family — median(published / predicted)
over a deterministic training split — and report error on the held-out
rest.  The median keeps single-machine outliers (odd published runs,
mis-parsed rows) from dragging the family factor.

Split rule (deterministic, stratified): entries are grouped by family
and sorted by published Rmax; even positions train, odd positions test.
A family with a single machine trains only (its factor would otherwise
be fit on nothing); families never seen in training fall back to the
global factor.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch._device import DeviceLike

GLOBAL = "__global__"
CALIBRATION_KEY = "calibration"      # provenance key both paths stamp


def _stamp_calibration(platform, how: str):
    """A copy of ``platform`` whose provenance records the calibration
    path (first writer wins — a spec calibrated by the DES bridge keeps
    that record through a later residual pass)."""
    if CALIBRATION_KEY in platform.provenance_dict:
        return platform
    return dataclasses.replace(
        platform,
        provenance=platform.provenance + ((CALIBRATION_KEY, how),))


@dataclasses.dataclass
class CalibrationResult:
    factors: Dict[str, float]          # family -> efficiency factor
    train_median_abs_err: float
    heldout_median_abs_err: float
    n_train: int
    n_test: int

    def factor_for(self, family: str) -> float:
        return self.factors.get(family, self.factors[GLOBAL])

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        held = d["heldout_median_abs_err"]
        if held != held:                    # NaN -> null (strict JSON)
            d["heldout_median_abs_err"] = None
        return d


def assign_splits(entries) -> None:
    """Stamp each entry's ``split`` in place (see module docstring).
    Entries without a published Rmax can't train or score — they keep
    ``split == ""`` and only receive the fitted factor."""
    by_family: Dict[str, List] = {}
    for e in entries:
        if e.published_tflops > 0:
            by_family.setdefault(e.family, []).append(e)
    for group in by_family.values():
        group.sort(key=lambda e: -e.published_tflops)
        for i, e in enumerate(group):
            e.split = "train" if (i % 2 == 0 or len(group) == 1) \
                else "test"


def calibrate_fleet(entries) -> CalibrationResult:
    """Fit family factors on the train split, apply to every entry, and
    measure held-out error.  Mutates ``entries`` (sets ``split`` and
    ``calibrated_tflops``) and returns the fit."""
    assign_splits(entries)
    train = [e for e in entries if e.split == "train"]
    if not train:
        raise ValueError("calibrate_fleet: no entries with a published "
                         "Rmax to train on")
    ratios: Dict[str, List[float]] = {}
    for e in train:
        if e.predicted_tflops > 0:
            ratios.setdefault(e.family, []).append(
                e.published_tflops / e.predicted_tflops)
    factors = {fam: statistics.median(rs) for fam, rs in ratios.items()}
    factors[GLOBAL] = statistics.median(
        [e.published_tflops / e.predicted_tflops
         for e in train if e.predicted_tflops > 0])
    for e in entries:
        e.calibrated_tflops = e.predicted_tflops * \
            factors.get(e.family, factors[GLOBAL])
        e.platform = _stamp_calibration(e.platform, "family-factor")
    test = [e for e in entries if e.split == "test"]
    return CalibrationResult(
        factors=factors,
        train_median_abs_err=statistics.median(
            [abs(e.rel_err) for e in train]),
        heldout_median_abs_err=statistics.median(
            [abs(e.rel_err) for e in test]) if test else float("nan"),
        n_train=len(train), n_test=len(test))


# ------------------------------------------------------ DES bridging

@dataclasses.dataclass
class DESCalibration:
    """Output of ``calibrate_against_des``: the input specs with fitted
    contention tables baked in (input order) plus the audit trail — the
    *applied* table per family (the per-field median over its donors)
    and every donor's individual ``BridgeFit``."""
    platforms: List            # Platform, with calibration + provenance
    tables: Dict[str, Dict[str, float]]   # family -> applied calibration
    fits: Dict[str, List]      # family -> [(donor name, BridgeFit), ...]
    donors: Dict[str, str]     # family -> comma-joined donor names


def _probe_platform(platform, max_nodes: int):
    """A probe-scale copy of an inferred spec: same node model, link
    bandwidths and latencies (what the bridge fits), but geometry shrunk
    so the DES probes run in seconds even for a 100k-node machine.
    Probe configs use <= 16 ranks, so the shrink does not change which
    links a probe exercises — only how big an object we build."""
    n = min(platform.scale.n_nodes, max_nodes)
    fab = platform.fabric
    kw: Dict = {}
    if fab.kind == "dragonfly":
        per = max(-(-n // 4), 1)
        kw = dict(n_groups=2, routers_per_group=2, nodes_per_router=per)
    elif fab.kind == "torus":
        side = max(2, round(n ** (1.0 / len(fab.dims))))
        dims = [side] * len(fab.dims)
        while _prod(dims) < n:
            dims[0] += 1
        kw = dict(dims=tuple(dims))
    elif fab.kind == "multipod":
        side = max(2, round((n // 2) ** (1.0 / max(len(fab.dims), 1))))
        dims = [side] * len(fab.dims)
        while _prod(dims) * 2 < n:
            dims[0] += 1
        kw = dict(dims=tuple(dims), n_pods=2)
    # fat-tree topologies size themselves from n_nodes; geometry stands
    shrunk = dataclasses.replace(fab, **kw) if kw else fab
    return dataclasses.replace(
        platform, fabric=shrunk,
        scale=dataclasses.replace(platform.scale, n_nodes=n),
        calibration=())


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def calibrate_against_des(platforms: Sequence, *,
                          per_family: int = 1, max_probe_nodes: int = 64,
                          steps: int = 20, lr: float = 0.1,
                          probe_configs: Optional[Sequence] = None,
                          device: DeviceLike = "cuda") -> DESCalibration:
    """Bridge-calibrate an inferred fleet against the DES instead of the
    scalar family factor.

    Per fabric family, the ``per_family`` smallest machines are probed:
    ``fit_fastsim_to_des`` runs small DES probes on a probe-scale copy
    of the spec and gradient-fits the fastsim contention scales
    (``bcast_bw_scale``, ``swap_bw_scale``).  The per-field median of
    the family's fits is applied to every member, and each spec's
    provenance records which path (and which donor machines) produced
    its calibration — ``("calibration", "des-bridge:<donors>")`` —
    versus ``("calibration", "family-factor")`` from
    ``calibrate_fleet``.  Smoke-sized by construction: probes are
    <= 16-rank DES runs and ``steps`` defaults low.  The probes run on
    the host and each bridge fit on ``device``.
    """
    from repro_torch.platforms.bridge import fit_fastsim_to_des
    from .infer import fabric_group

    platforms = list(platforms)
    if not platforms:
        raise ValueError("calibrate_against_des: no platforms")
    by_family: Dict[str, List] = {}
    for p in platforms:
        by_family.setdefault(fabric_group(p), []).append(p)

    fits: Dict[str, List] = {}
    donors: Dict[str, str] = {}
    tables: Dict[str, Dict[str, float]] = {}
    for family, group in sorted(by_family.items()):
        sample = sorted(group, key=lambda p: (p.scale.n_nodes, p.name))
        sample = sample[:max(per_family, 1)]
        fitted: List[Tuple[str, object]] = []
        for donor in sample:
            probe = _probe_platform(donor, max_probe_nodes)
            fitted.append((donor.name, fit_fastsim_to_des(
                probe, probe_configs=probe_configs, steps=steps, lr=lr,
                device=device)))
        donors[family] = ",".join(name for name, _ in fitted)
        fits[family] = fitted
        fields = fitted[0][1].fields
        tables[family] = {
            f: statistics.median([fit.calibration[f] for _, fit in fitted])
            for f in fields}

    out = []
    for p in platforms:
        family = fabric_group(p)
        cal = p.with_calibration(tables[family])
        out.append(_stamp_calibration(
            cal, f"des-bridge:{donors[family]}"))
    return DESCalibration(platforms=out, tables=tables, fits=fits,
                          donors=donors)
