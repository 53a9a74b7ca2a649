"""Fleet predictor: every inferred platform through ONE batched sweep.

The paper predicts machines one at a time (4.8 h of SystemC per
scenario); this module predicts a whole TOP500 list in a single
batched program on the device.  Per machine it auto-tunes an HPL run
under the standard memory-fraction rule, then feeds the entire fleet
through ``fastsim.sweep_hpl(..., bucket=...)`` — one padded scenario
axis, one bucket program, regardless of how many geometries are mixed.
(``compiles`` in the report counts bucket programs built, the port's
stand-in for the reference's compiles.)

Scale proxying (the trick that makes a 150k-node machine simulable in
a shared bucket): HPL under the memory rule is *weak-scaled* — the
per-rank local matrix ``N / sqrt(P*Q) = sqrt(mem_fraction * hbm / 8)``
is independent of machine size — so a machine larger than ``max_ranks``
is simulated as a proxy grid of at most ``max_ranks`` ranks with the
same per-rank load, same node, same fabric params, and its predicted
Rmax is the proxy's *efficiency* times the full machine's peak.
Machines at or below ``max_ranks`` simulate at full size (proxy scale
1).  The proxy decision is recorded per machine in the report.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch._device import DeviceLike
from repro_torch.platforms.spec import Platform

from .infer import fabric_group, infer_platforms, memory_sized_n
from .rows import Top500Row


@dataclasses.dataclass(frozen=True)
class FleetTuning:
    """Auto-tuner knobs: proxy size, memory fill, and panel budget."""
    mem_fraction: float = 0.75   # HPL matrix fill of fleet memory
    max_ranks: int = 1024        # proxy grid cap (P'*Q' <= max_ranks)
    panels_cap: int = 4096       # nb grows until ceil(N/nb) <= panels_cap
    nb_min: int = 128            # smallest (and default) block size
    nb_step: int = 64            # nb granularity when the cap forces it up


@dataclasses.dataclass
class FleetEntry:
    """One machine's tuned scenario + prediction, ready for ranking."""
    platform: Platform
    cfg: object                  # HPLConfig (proxy geometry)
    scale: float                 # full-machine nodes / proxy nodes
    family: str                  # fabric calibration group
    published_tflops: float
    predicted_tflops: float = 0.0     # raw fleet-sim prediction
    calibrated_tflops: float = 0.0    # after family-efficiency factor
    split: str = ""                   # "train" | "test" (calibration)

    @property
    def rel_err(self) -> float:
        """Signed relative error vs the published Rmax; NaN when the
        platform has no published number to compare against."""
        if self.published_tflops <= 0:
            return float("nan")
        pred = self.calibrated_tflops or self.predicted_tflops
        return (pred - self.published_tflops) / self.published_tflops


def tune_scenario(platform: Platform, tuning: FleetTuning):
    """(HPLConfig proxy, scale): the machine's memory-rule HPL run on at
    most ``tuning.max_ranks`` ranks with full-size per-rank load."""
    from repro_torch.core.apps.hpl import HPLConfig

    n_ranks = platform.scale.n_ranks
    rpn = platform.scale.ranks_per_node
    r = min(n_ranks, tuning.max_ranks)
    P = int(math.isqrt(r))
    Q = r // P
    proxy_nodes = max(P * Q // rpn, 1)
    scale = platform.scale.n_nodes / proxy_nodes

    nb = tuning.nb_min
    N = memory_sized_n(proxy_nodes, platform.node.hbm_bytes, nb,
                       tuning.mem_fraction)
    if (N + nb - 1) // nb > tuning.panels_cap:
        nb = -(-N // (tuning.panels_cap * tuning.nb_step)) \
            * tuning.nb_step
        N = memory_sized_n(proxy_nodes, platform.node.hbm_bytes, nb,
                           tuning.mem_fraction)
    return HPLConfig(N=N, nb=nb, P=P, Q=Q,
                     bcast=platform.mpi.bcast), scale


def fleet_bucket(cfgs: Sequence[object]) -> Tuple[int, int, int]:
    """The shared (n_panels_max, P_max, Q_max) every scenario fits in."""
    return (max(c.n_panels for c in cfgs),
            max(c.P for c in cfgs),
            max(c.Q for c in cfgs))


def predict_fleet(source, *,
                  tuning: Optional[FleetTuning] = None,
                  calibrate: bool = True,
                  infer_kw: Optional[dict] = None,
                  metrics=None,
                  device: DeviceLike = "cuda") -> "FleetReport":
    """Rows (or pre-inferred Platforms) -> ranked predicted-vs-published
    Rmax report, via one forced-bucket ``sweep_hpl`` call on ``device``.

    ``source`` is a sequence of ``Top500Row`` or of ``Platform``.  With
    ``calibrate=True`` the per-fabric-family residual pass runs on a
    deterministic train split and held-out error is reported (see
    top500/calibrate.py).

    ``metrics`` (a ``repro_torch.obs.MetricsRegistry``) opts the run into
    fleet telemetry: machine/compile counters, per-provenance-source
    counts, per-phase wall times (tune / sweep / calibrate) and the
    fitted family calibration factors as gauges.  The registry rides on
    the returned report so ``report.run_manifest()`` can emit the
    per-run NDJSON artifact the campaign layer consumes.
    """
    import time as _time

    from repro_torch.core.fastsim import sweep_hpl, trace_count
    from repro_torch.obs.metrics import NULL_METRICS

    m = metrics if metrics is not None else NULL_METRICS
    tuning = tuning or FleetTuning()
    items = list(source)
    if not items:
        raise ValueError("predict_fleet: no machines to predict (did "
                         "the parser skip every row?)")
    if isinstance(items[0], Top500Row):
        platforms = infer_platforms(items, **(infer_kw or {}))
    else:
        platforms = items

    t0 = _time.perf_counter()
    entries: List[FleetEntry] = []
    for plat in platforms:
        cfg, scale = tune_scenario(plat, tuning)
        entries.append(FleetEntry(
            platform=plat, cfg=cfg, scale=scale,
            family=fabric_group(plat),
            published_tflops=plat.scale.reported_tflops))
    if m.enabled:
        m.histogram("fleet.phase_wall_s", phase="tune").observe(
            _time.perf_counter() - t0)
        m.counter("fleet.machines").inc(len(entries))
        for e in entries:
            for src, _ in e.platform.provenance:
                m.counter("fleet.provenance", source=src).inc()

    bucket = fleet_bucket([e.cfg for e in entries])
    compiles0 = trace_count()
    t0 = _time.perf_counter()
    results = sweep_hpl([e.cfg for e in entries],
                        [e.platform.fastsim() for e in entries],
                        bucket=bucket, device=device)
    compiles = trace_count() - compiles0
    if m.enabled:
        m.histogram("fleet.phase_wall_s", phase="sweep").observe(
            _time.perf_counter() - t0)
        m.counter("fleet.compiles").inc(compiles)
    for e, res in zip(entries, results):
        e.predicted_tflops = res["tflops"] * e.scale

    report = FleetReport(entries=entries, bucket=bucket,
                         compiles=compiles, tuning=tuning, metrics=m)
    if calibrate:
        from .calibrate import calibrate_fleet
        t0 = _time.perf_counter()
        report.calibration = calibrate_fleet(entries)
        if m.enabled:
            m.histogram("fleet.phase_wall_s", phase="calibrate").observe(
                _time.perf_counter() - t0)
            for fam, f in sorted(report.calibration.factors.items()):
                m.gauge("fleet.calibration_factor", family=fam).set(f)
    return report


@dataclasses.dataclass
class FleetReport:
    """Ranked fleet prediction + the sweep/calibration audit trail."""
    entries: List[FleetEntry]
    bucket: Tuple[int, int, int]
    compiles: int
    tuning: FleetTuning
    calibration: Optional[object] = None    # CalibrationResult
    skipped_rows: List = dataclasses.field(default_factory=list)
    #                    ^ (line, reason) pairs the parser rejected
    metrics: Optional[object] = None        # registry the run reported to

    def ranked(self) -> List[FleetEntry]:
        """Entries by predicted Rmax, best first (the predicted list)."""
        return sorted(self.entries,
                      key=lambda e: -(e.calibrated_tflops
                                      or e.predicted_tflops))

    def median_abs_err(self, split: Optional[str] = None) -> float:
        import statistics
        errs = [abs(e.rel_err) for e in self.entries
                if (split is None or e.split == split)
                and e.published_tflops > 0]
        return statistics.median(errs) if errs else float("nan")

    def run_manifest(self, path=None, **meta) -> str:
        """One NDJSON run-manifest line for this fleet run (the per-run
        artifact the campaign layer consumes, ``repro_torch.obs``):
        machine/bucket/compile/error summary as ``meta``, the full
        metrics snapshot when the run was instrumented.  With ``path``
        the line is also appended to that NDJSON journal."""
        from repro_torch.obs import append_manifest, manifest_line
        med, held = self.median_abs_err(), self.median_abs_err("test")
        base = {
            "machines": len(self.entries),
            "bucket": list(self.bucket),
            "compiles": self.compiles,
            "n_skipped": len(self.skipped_rows),
            "median_abs_err": None if med != med else med,
            "heldout_median_abs_err": None if held != held else held,
        }
        if self.calibration is not None:
            base["calibration_factors"] = dict(
                sorted(self.calibration.factors.items()))
        base.update(meta)
        m = self.metrics if self.metrics is not None \
            and getattr(self.metrics, "enabled", False) else None
        if path is not None:
            return append_manifest(path, "fleet_run", meta=base, metrics=m)
        return manifest_line("fleet_run", meta=base, metrics=m)

    def to_dict(self) -> Dict:
        med, held = self.median_abs_err(), self.median_abs_err("test")
        d: Dict = {
            "bucket": list(self.bucket),
            "compiles": self.compiles,
            "tuning": dataclasses.asdict(self.tuning),
            "median_abs_err": None if med != med else med,
            "heldout_median_abs_err": None if held != held else held,
            "skipped_rows": [list(kv) for kv in self.skipped_rows],
            "machines": [],
        }
        if self.calibration is not None:
            d["calibration"] = self.calibration.to_dict()
        d["n_skipped"] = len(self.skipped_rows)
        for pos, e in enumerate(self.ranked(), start=1):
            err = e.rel_err
            d["machines"].append({
                "predicted_rank": pos,
                "name": e.platform.name,
                "family": e.family,
                "split": e.split,
                "published_tflops": e.published_tflops,
                "predicted_tflops": e.predicted_tflops,
                "calibrated_tflops": e.calibrated_tflops,
                "rel_err": None if err != err else err,   # NaN -> null
                "proxy_scale": e.scale,
                "proxy_cfg": {"N": e.cfg.N, "nb": e.cfg.nb,
                              "P": e.cfg.P, "Q": e.cfg.Q},
                "provenance": [list(kv) for kv in e.platform.provenance],
            })
        return d
