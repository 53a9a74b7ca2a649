"""Campaign merge + report tooling (the ``ben*`` half of the layer).

Journals are NDJSON run manifests (``campaign_run`` lines + one
``campaign_summary`` per executed campaign).  This module folds any
number of them — including partial journals from killed runs, read
leniently — into one merged artifact and renders the ranked report:

  * :func:`merge_journals` — concatenate run records and fold every
    summary's metrics snapshot with the monoid merge
    (``obs.merge_snapshots``: counters sum, gauge peaks max,
    histograms add), emitting one trailing ``campaign_merged`` record.
  * :func:`campaign_report` — the analysis dict: ranked grid results,
    per-edition fleet summaries, and the longitudinal drift section —
    per-machine prediction drift and per-fabric calibration-factor
    drift between the earliest and latest edition present (machines
    matched by their edition-stable slug, list-position prefix
    stripped).
  * :func:`render_markdown` / :func:`render_text` / :func:`write_csv`
    — the human and spreadsheet surfaces over that dict.
"""
from __future__ import annotations

import csv
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import merge_snapshots
from repro_torch.obs.export import manifest_record, read_manifest

from .exec import dispatch_counts

#: campaign journal record kinds this module folds
RUN_KIND, SUMMARY_KIND, MERGED_KIND = ("campaign_run",
                                       "campaign_summary",
                                       "campaign_merged")


def load_journal(path, *, strict: bool = False) -> List[Dict[str, Any]]:
    """Read one NDJSON journal; lenient by default (a torn trailing
    line from a killed run is skipped, not fatal)."""
    return read_manifest(path, strict=strict)


def merge_journals(paths: Sequence, *,
                   strict: bool = False) -> List[Dict[str, Any]]:
    """Fold journals into one record list: every ``campaign_run`` line
    (journal order, journals in argument order), every per-campaign
    summary, and one trailing ``campaign_merged`` record whose metrics
    snapshot is the monoid fold of all summaries' snapshots."""
    runs: List[Dict[str, Any]] = []
    summaries: List[Dict[str, Any]] = []
    for path in paths:
        for rec in load_journal(path, strict=strict):
            if rec.get("kind") == RUN_KIND:
                runs.append(rec)
            elif rec.get("kind") in (SUMMARY_KIND, MERGED_KIND):
                summaries.append(rec)
    snaps = [r["metrics"] for r in summaries if "metrics" in r]
    merged_snap = merge_snapshots(*snaps) if snaps else None
    campaigns: List[str] = []
    editions: Dict[str, Any] = {}
    wall_s = 0.0
    for s in summaries:
        meta = s.get("meta", {})
        name = meta.get("campaign", "")
        if name and name not in campaigns:
            campaigns.append(name)
        editions.update(meta.get("editions", {}))
        wall_s += meta.get("wall_s", 0.0)
    meta = {"campaigns": campaigns, "n_runs": len(runs),
            "n_summaries": len(summaries), "editions": editions,
            "wall_s": wall_s}
    if merged_snap is not None:
        meta["dispatches"] = dispatch_counts(merged_snap)
    merged = manifest_record(MERGED_KIND, meta=meta,
                             metrics=merged_snap)
    return runs + summaries + [merged]


def write_journal(records: Sequence[Dict[str, Any]], path) -> None:
    with open(path, "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec, sort_keys=True) + "\n")


# ------------------------------------------------------------- analysis
def _run_rows(records) -> List[Dict[str, Any]]:
    return [r["meta"] for r in records if r.get("kind") == RUN_KIND]


def _tflops(result: Optional[dict]) -> Optional[float]:
    if not result:
        return None
    for key in ("calibrated_tflops", "predicted_tflops", "tflops"):
        v = result.get(key)
        if v:
            return float(v)
    return None


def campaign_report(records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The analysis dict a merged (or single) journal renders to."""
    rows = _run_rows(records)
    grid = [m for m in rows if m.get("kind") == "grid"]
    fleet = [m for m in rows if m.get("kind") == "fleet"]
    summaries = [r["meta"] for r in records
                 if r.get("kind") in (SUMMARY_KIND, MERGED_KIND)]

    ranked_grid = sorted(
        (m for m in grid if _tflops(m.get("result")) is not None),
        key=lambda m: -_tflops(m["result"]))
    errors = [m for m in grid
              if (m.get("result") or {}).get("status") == "error"]

    editions: Dict[str, Dict[str, Any]] = {}
    for s in summaries:
        editions.update(s.get("editions", {}))
    by_edition: Dict[str, List[dict]] = {}
    for m in fleet:
        by_edition.setdefault(m.get("edition", ""), []).append(m)

    report: Dict[str, Any] = {
        "campaigns": sorted({m.get("campaign", "") for m in rows}),
        "n_runs": len(rows), "n_grid": len(grid), "n_fleet": len(fleet),
        "n_errors": len(errors),
        "ranked_grid": ranked_grid,
        "editions": editions,
        "fleet_by_edition": {
            ed: sorted(ms, key=lambda m: -(_tflops(m["result"]) or 0.0))
            for ed, ms in by_edition.items()},
    }
    if len(by_edition) >= 2:
        report["drift"] = edition_drift(by_edition, editions)
    return report


def edition_drift(by_edition: Dict[str, List[dict]],
                  editions_meta: Dict[str, Any]) -> Dict[str, Any]:
    """The longitudinal section: earliest vs latest edition (sorted
    label order), machines matched by edition-stable slug."""
    first, last = min(by_edition), max(by_edition)
    a = {m["machine"]: m for m in by_edition[first]}
    b = {m["machine"]: m for m in by_edition[last]}
    machines: List[Dict[str, Any]] = []
    for key in sorted(set(a) & set(b)):
        ra, rb = a[key]["result"], b[key]["result"]
        pa, pb = _tflops(ra), _tflops(rb)
        pub_a = ra.get("published_tflops") or 0.0
        pub_b = rb.get("published_tflops") or 0.0
        machines.append({
            "machine": key,
            "family": rb.get("family", ra.get("family", "")),
            f"predicted_{first}": pa, f"predicted_{last}": pb,
            f"published_{first}": pub_a, f"published_{last}": pub_b,
            "predicted_drift": ((pb - pa) / pa
                                if pa and pb is not None else None),
            "published_drift": ((pub_b - pub_a) / pub_a
                                if pub_a and pub_b else None),
        })
    machines.sort(key=lambda d: -abs(d["predicted_drift"] or 0.0))

    fa = (editions_meta.get(first) or {}).get("calibration_factors", {})
    fb = (editions_meta.get(last) or {}).get("calibration_factors", {})
    factors = [{
        "family": fam,
        f"factor_{first}": fa.get(fam), f"factor_{last}": fb.get(fam),
        "drift": (fb[fam] - fa[fam]
                  if fam in fa and fam in fb else None),
    } for fam in sorted(set(fa) | set(fb))]
    return {"from": first, "to": last,
            "common_machines": len(machines),
            "appeared": sorted(set(b) - set(a)),
            "dropped": sorted(set(a) - set(b)),
            "machines": machines, "calibration_factors": factors}


# ------------------------------------------------------------ rendering
def _fmt(v, nd=3) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def _pct(v) -> str:
    return "-" if v is None else f"{v * 100:+.1f}%"


def _fault_label(fault: Optional[dict]) -> str:
    if not fault:
        return "-"
    return fault.get("name") or "+".join(
        f.get("kind", "?") for f in fault.get("faults", ())) or "-"


def _table(headers: List[str], rows: List[List[str]],
           md: bool) -> List[str]:
    if md:
        out = ["| " + " | ".join(headers) + " |",
               "|" + "|".join("---" for _ in headers) + "|"]
        out += ["| " + " | ".join(r) + " |" for r in rows]
        return out
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    line = "  ".join(h.ljust(w) for h, w in zip(headers, widths))
    out = [line, "  ".join("-" * w for w in widths)]
    out += ["  ".join(c.ljust(w) for c, w in zip(r, widths))
            for r in rows]
    return out


def render_report(report: Dict[str, Any], *, markdown: bool = True,
                  top: int = 20) -> str:
    """The ranked campaign report (Markdown by default, aligned text
    with ``markdown=False``)."""
    md = markdown
    h = (lambda s: f"## {s}") if md else (lambda s: s.upper())
    lines: List[str] = []
    names = ", ".join(n for n in report["campaigns"] if n) or "campaign"
    lines.append(f"# Campaign report: {names}" if md
                 else f"CAMPAIGN REPORT: {names}")
    lines.append("")
    lines.append(f"{report['n_runs']} runs "
                 f"({report['n_grid']} grid, {report['n_fleet']} fleet), "
                 f"{report['n_errors']} errors.")

    if report["ranked_grid"]:
        lines += ["", h(f"Grid runs (top {top} by TFlop/s)"), ""]
        rows = [[m["run"], m["workload"]["kind"], m["platform"],
                 str(m["seed"]), _fault_label(m.get("fault")),
                 _fmt(_tflops(m["result"]), 1)]
                for m in report["ranked_grid"][:top]]
        lines += _table(["run", "workload", "platform", "seed", "fault",
                         "tflops"], rows, md)

    for ed, ms in sorted(report["fleet_by_edition"].items()):
        meta = report["editions"].get(ed, {})
        lines += ["", h(f"Fleet edition {ed}"), ""]
        err = meta.get("median_abs_err")
        held = meta.get("heldout_median_abs_err")
        lines.append(f"{len(ms)} machines, {meta.get('compiles', '?')} "
                     f"compile(s); median |err| {_fmt(err)} "
                     f"(held-out {_fmt(held)}).")
        lines.append("")
        rows = [[str(i + 1), m["machine"], m["result"].get("family", ""),
                 _fmt(m["result"].get("published_tflops"), 1),
                 _fmt(_tflops(m["result"]), 1),
                 _pct(m["result"].get("rel_err"))]
                for i, m in enumerate(ms[:top])]
        lines += _table(["#", "machine", "family", "published",
                         "predicted", "rel_err"], rows, md)

    drift = report.get("drift")
    if drift:
        lines += ["", h(f"Edition drift: {drift['from']} -> "
                        f"{drift['to']}"), ""]
        lines.append(f"{drift['common_machines']} machines in both "
                     f"editions; {len(drift['appeared'])} appeared, "
                     f"{len(drift['dropped'])} dropped.")
        lines.append("")
        rows = [[d["machine"], d["family"],
                 _fmt(d[f"predicted_{drift['from']}"], 1),
                 _fmt(d[f"predicted_{drift['to']}"], 1),
                 _pct(d["predicted_drift"]), _pct(d["published_drift"])]
                for d in drift["machines"][:top]]
        lines += _table(["machine", "family",
                         f"pred {drift['from']}", f"pred {drift['to']}",
                         "pred drift", "pub drift"], rows, md)
        lines += ["", h("Calibration-factor drift"), ""]
        rows = [[f["family"], _fmt(f[f"factor_{drift['from']}"]),
                 _fmt(f[f"factor_{drift['to']}"]), _fmt(f["drift"])]
                for f in drift["calibration_factors"]]
        lines += _table(["fabric family", f"factor {drift['from']}",
                         f"factor {drift['to']}", "drift"], rows, md)
    return "\n".join(lines) + "\n"


def render_markdown(report: Dict[str, Any], **kw) -> str:
    return render_report(report, markdown=True, **kw)


def render_text(report: Dict[str, Any], **kw) -> str:
    return render_report(report, markdown=False, **kw)


#: CSV columns, one row per campaign_run record
CSV_FIELDS = ("campaign", "run", "cell", "kind", "workload", "platform",
              "edition", "machine", "seed", "fault", "status", "tflops",
              "published_tflops", "rel_err", "family")


def write_csv(records: Sequence[Dict[str, Any]], path) -> int:
    """One CSV row per run record; returns the row count."""
    rows = _run_rows(records)
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=CSV_FIELDS)
        w.writeheader()
        for m in rows:
            res = m.get("result") or {}
            w.writerow({
                "campaign": m.get("campaign", ""),
                "run": m.get("run", ""), "cell": m.get("cell", ""),
                "kind": m.get("kind", ""),
                "workload": m["workload"]["kind"],
                "platform": m.get("platform", ""),
                "edition": m.get("edition", ""),
                "machine": m.get("machine", ""),
                "seed": m.get("seed", ""),
                "fault": (_fault_label(m["fault"])
                          if m.get("fault") else ""),
                "status": res.get("status", "ok"),
                "tflops": _tflops(res),
                "published_tflops": res.get("published_tflops", ""),
                "rel_err": res.get("rel_err", ""),
                "family": res.get("family", ""),
            })
    return len(rows)
