"""Campaign executor: the whole matrix through the batched engines.

One ``run_campaign`` call serves the entire expanded matrix with the
same economy the layers below already guarantee:

  * every grid case becomes one ``WorkloadRequest`` into a single
    ``PredictionService.predict_batch`` — one ``sweep_models`` dispatch
    per workload family per wave, so (2 workloads x 3 platforms x axes
    x faults x seeds) costs two compiled sweeps, not N;
  * every fleet edition runs through ``top500.predict_fleet`` — one
    forced-bucket ``sweep_hpl`` compile per edition regardless of how
    many machine geometries the list mixes, per-fabric calibration
    included.

Everything reports into ONE ``MetricsRegistry`` installed as the
global metrics sink for the duration, so the fastsim/stepsim compile
counters (``fastsim.compile_misses``/``stepsim.compile_misses``) are
the ground truth for the one-compile-per-family claim — the campaign
summary carries them and tests assert on them.

Journaling: one ``campaign_run`` NDJSON line per run (pure identity +
result payload, no wall clocks — equal campaigns give byte-equal run
lines) plus one trailing ``campaign_summary`` line (spec echo, dispatch
counts, per-edition calibration, wall time, full metrics snapshot —
the only place timing lives).  With ``journal=``, lines are appended
as they are produced, so a killed run leaves a readable prefix (the
lenient ``read_manifest`` skips a torn trailing line).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.obs import MetricsRegistry, global_metrics
from repro_torch.obs.export import manifest_record
from repro_torch.obs.metrics import parse_key

from .matrix import RunMatrix, expand
from .spec import CampaignSpec

#: result keys stripped from grid run records (per-request wall clocks
#: would break byte-equal journals; timing belongs to the summary)
_TIMING_KEYS = ("wall_s", "latency_s")


@dataclasses.dataclass
class CampaignResult:
    """Everything one campaign run produced: the matrix, per-run
    records (journal order), per-edition fleet reports, and the shared
    metrics registry."""
    spec: CampaignSpec
    matrix: RunMatrix
    records: List[Dict[str, Any]]
    fleet_reports: Dict[str, Any]           # edition -> FleetReport
    grid_results: Dict[int, dict]           # case index -> result
    metrics: Any
    wall_s: float

    @property
    def run_records(self) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == "campaign_run"]

    @property
    def summary(self) -> Dict[str, Any]:
        return next(r for r in self.records
                    if r["kind"] == "campaign_summary")

    def lines(self) -> List[str]:
        import json
        return [json.dumps(r, sort_keys=True) for r in self.records]

    def write_journal(self, path) -> None:
        with open(path, "w") as fh:
            for line in self.lines():
                fh.write(line + "\n")


def dispatch_counts(snapshot: Dict[str, Any]) -> Dict[str, int]:
    """Model-dispatch totals off a metrics snapshot: per compiled-sweep
    family, misses (fresh compiles) + hits (bucket reuse) = dispatches.
    This is the observable the one-compile-per-family acceptance
    criterion is asserted against."""
    out = {"fastsim_compiles": 0, "fastsim_dispatches": 0,
           "stepsim_compiles": 0, "stepsim_dispatches": 0,
           "serve_sweeps": 0, "cache_hits": 0, "cache_misses": 0,
           "coalesced": 0}
    for key, val in snapshot.get("counters", {}).items():
        name, _ = parse_key(key)
        if name == "fastsim.compile_misses":
            out["fastsim_compiles"] += int(val)
            out["fastsim_dispatches"] += int(val)
        elif name == "fastsim.compile_hits":
            out["fastsim_dispatches"] += int(val)
        elif name == "stepsim.compile_misses":
            out["stepsim_compiles"] += int(val)
            out["stepsim_dispatches"] += int(val)
        elif name == "stepsim.compile_hits":
            out["stepsim_dispatches"] += int(val)
        elif name == "serve.sweeps":
            out["serve_sweeps"] += int(val)
        elif name == "serve.cache_hits":
            out["cache_hits"] += int(val)
        elif name == "serve.cache_misses":
            out["cache_misses"] += int(val)
        elif name == "serve.coalesced":
            out["coalesced"] += int(val)
    return out


def _grid_result_payload(out: Optional[dict]) -> Optional[dict]:
    """The journaled slice of a grid result: everything the sweep
    computed, minus wall-clock fields, the (trace-sized) breakdown, and
    the ``cached`` provenance stamp (a warm-cache re-run must journal
    byte-equal ``campaign_run`` lines)."""
    if out is None:
        return None
    return {k: v for k, v in out.items()
            if k not in _TIMING_KEYS and k not in ("breakdown", "cached")}


def _fleet_entry_payload(entry) -> dict:
    err = entry.rel_err
    return {
        "family": entry.family,
        "published_tflops": entry.published_tflops,
        "predicted_tflops": entry.predicted_tflops,
        "calibrated_tflops": entry.calibrated_tflops,
        "rel_err": None if err != err else err,
        "split": entry.split,
        "proxy_scale": entry.scale,
        "proxy_cfg": {"N": entry.cfg.N, "nb": entry.cfg.nb,
                      "P": entry.cfg.P, "Q": entry.cfg.Q},
    }


def run_campaign(spec: CampaignSpec, *, journal=None, metrics=None,
                 tuning=None, calibrate: bool = True,
                 max_batch: int = 256, strict: bool = False,
                 service=None, cache=None,
                 device: Optional[DeviceLike] = None) -> CampaignResult:
    """Execute a campaign end to end; see the module docstring for the
    batching/journaling contract.

    ``journal`` — path to append NDJSON lines to as they are produced.
    ``metrics`` — a shared ``MetricsRegistry`` (default: fresh, or the
    service's registry when ``service=`` is given).
    ``tuning``/``calibrate`` — forwarded to ``predict_fleet``.
    ``strict`` — grid resolution errors raise instead of being isolated
    into per-run ``{"status": "error"}`` records.
    ``service`` — a caller-held ``PredictionService`` to route grid
    cases through; re-running an identical campaign against a warm
    cached service is all-hits with byte-equal ``campaign_run`` lines.
    ``cache`` — forwarded to the internally-built service when
    ``service`` is not given (True/int/ResultCache, see
    ``repro_torch.serve``).
    ``device`` — where the sweeps run (the internally-built service's
    and every edition's ``predict_fleet``): by default the caller-held
    ``service``'s device, else ``"cuda"``.  It is resolved before
    anything is expanded: without a card a ``"cuda"`` campaign raises
    here, never as per-run error records.

    The summary's ``dispatches`` are deltas over this campaign (counter
    totals at entry are subtracted), so shared registries and reused
    services report per-campaign compile economy, not lifetime totals.
    """
    from repro_torch.serve import PredictionService, WorkloadRequest

    if device is None:
        device = service.device if service is not None else "cuda"
    dev = resolve_device(device)
    if metrics is None:
        registry = service.metrics if service is not None \
            else MetricsRegistry()
    else:
        registry = metrics
    counts_start = dispatch_counts(
        registry.snapshot() if registry.enabled else {})
    matrix = expand(spec, strict=strict)
    records: List[Dict[str, Any]] = []
    t_start = time.perf_counter()

    def emit(rec: Dict[str, Any]) -> None:
        records.append(rec)
        if journal is not None:
            import json
            with open(journal, "a") as fh:
                fh.write(json.dumps(rec, sort_keys=True) + "\n")

    grid_results: Dict[int, dict] = {}
    fleet_reports: Dict[str, Any] = {}
    with global_metrics(registry):
        # ------------------------------------------------- grid cases
        grid = matrix.grid_cases
        if grid:
            svc = service if service is not None else PredictionService(
                max_batch=max_batch, metrics=registry, cache=cache,
                device=dev)
            reqs = [WorkloadRequest(rid=c.index, workload=c.workload,
                                    platform=matrix.platforms[c.platform],
                                    faults=c.fault)
                    for c in grid]
            grid_results = svc.predict_batch(
                reqs, isolate_errors=not strict)
            for case in grid:
                meta = {"campaign": spec.name, **case.to_meta(),
                        "result": _grid_result_payload(
                            grid_results.get(case.index))}
                emit(manifest_record("campaign_run", meta=meta))

        # ------------------------------------------------ fleet cases
        for edition in matrix.editions():
            from repro_torch.top500 import predict_fleet
            report = predict_fleet(matrix.fleets[edition], tuning=tuning,
                                   calibrate=calibrate, metrics=registry,
                                   device=dev)
            fleet_reports[edition] = report
            by_name = {e.platform.name: e for e in report.entries}
            for case in matrix.fleet_cases:
                if case.edition != edition:
                    continue
                entry = by_name[case.platform]
                meta = {"campaign": spec.name, **case.to_meta(),
                        "result": _fleet_entry_payload(entry)}
                emit(manifest_record("campaign_run", meta=meta))

    wall_s = time.perf_counter() - t_start
    snap = registry.snapshot() if registry.enabled else {}
    editions_meta = {}
    for edition, report in fleet_reports.items():
        med, held = report.median_abs_err(), report.median_abs_err("test")
        editions_meta[edition] = {
            "machines": len(report.entries),
            "compiles": report.compiles,
            "median_abs_err": None if med != med else med,
            "heldout_median_abs_err": None if held != held else held,
            "calibration_factors": (
                dict(sorted(report.calibration.factors.items()))
                if report.calibration is not None else {}),
        }
    summary_meta = {
        "campaign": spec.name,
        "spec": spec.to_dict(),
        "runs": len(matrix.cases),
        "grid_runs": len(matrix.grid_cases),
        "fleet_runs": len(matrix.fleet_cases),
        "skipped": [list(kv) for kv in matrix.skipped],
        "dispatches": {k: v - counts_start.get(k, 0)
                       for k, v in dispatch_counts(snap).items()},
        "editions": editions_meta,
        "wall_s": wall_s,                 # the one timing field
    }
    emit(manifest_record("campaign_summary", meta=summary_meta,
                         metrics=registry if registry.enabled else None))
    return CampaignResult(spec=spec, matrix=matrix, records=records,
                          fleet_reports=fleet_reports,
                          grid_results=grid_results, metrics=registry,
                          wall_s=wall_s)
