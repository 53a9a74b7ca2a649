"""Exporters: Prometheus text exposition + NDJSON run manifests.

Two machine-readable surfaces over a ``MetricsRegistry`` snapshot:

  * :func:`to_prometheus` — the Prometheus text exposition format
    (``# TYPE`` comments, ``_total`` counter suffix, cumulative
    ``_bucket{le=...}`` histogram series ending in ``le="+Inf"``,
    gauge peaks as a ``_peak`` companion series).  Metric names are
    sanitized to the exposition grammar (dots become underscores);
    :func:`validate_prometheus_text` checks any exposition string
    against that grammar and the cumulative-bucket invariants, and is
    what the tests hold the exporter to.
  * :func:`manifest_record` / :func:`append_manifest` — one JSON object
    per run ("NDJSON run manifest"): a ``kind`` tag, caller metadata,
    and the full metrics snapshot, dumped with sorted keys so equal
    runs produce byte-equal lines.  This is the per-run artifact format
    the campaign layer consumes; ``top500.FleetReport.run_manifest``
    emits it.

This is the port's own copy of ``repro.obs.export`` (pure Python, same
text and line formats).

No wall-clock or hostname fields are injected here — determinism is the
caller's to break (pass timestamps in ``meta`` if you want them).
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

__all__ = ["to_prometheus", "validate_prometheus_text",
           "manifest_record", "manifest_line", "append_manifest",
           "read_manifest", "read_manifest_report",
           "ManifestReadReport"]

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")

# exposition grammar (the subset we emit): metric names, optional
# label set, and a float/int value.  Validation regexes below.
_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^{}]*)\})?'
    r' (?P<value>[+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|Inf|NaN))$')
_LABEL_PAIR_RE = re.compile(
    r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\\n]|\\.)*)"')


def _prom_name(name: str) -> str:
    out = _NAME_SANITIZE.sub("_", name)
    if not _METRIC_NAME_RE.match(out):
        out = "_" + out
    return out


def _fmt_labels(labels, extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [(_LABEL_SANITIZE.sub("_", k),
              v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n"))
             for k, v in tuple(labels) + tuple(extra)]
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def _fmt_val(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def to_prometheus(registry_or_snapshot) -> str:
    """Render a registry (or snapshot dict) in the Prometheus text
    exposition format.  Deterministic: series are emitted in sorted
    snapshot order."""
    from .metrics import parse_key
    snap = (registry_or_snapshot.snapshot()
            if hasattr(registry_or_snapshot, "snapshot")
            else registry_or_snapshot)
    lines: List[str] = []

    for key, value in snap.get("counters", {}).items():
        name, labels = parse_key(key)
        pname = _prom_name(name) + "_total"
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname}{_fmt_labels(labels)} {_fmt_val(value)}")

    for key, gv in snap.get("gauges", {}).items():
        name, labels = parse_key(key)
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname}{_fmt_labels(labels)} {_fmt_val(gv['value'])}")
        if gv.get("max") is not None:
            lines.append(f"# TYPE {pname}_peak gauge")
            lines.append(
                f"{pname}_peak{_fmt_labels(labels)} {_fmt_val(gv['max'])}")

    for key, hv in snap.get("histograms", {}).items():
        name, labels = parse_key(key)
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} histogram")
        cum = 0
        for bound, c in zip(hv["bounds"], hv["counts"]):
            cum += c
            lines.append(
                f"{pname}_bucket"
                f"{_fmt_labels(labels, (('le', _fmt_val(bound)),))} {cum}")
        cum += hv["counts"][len(hv["bounds"])]
        lines.append(
            f"{pname}_bucket{_fmt_labels(labels, (('le', '+Inf'),))} {cum}")
        lines.append(f"{pname}_sum{_fmt_labels(labels)} "
                     f"{_fmt_val(hv['sum'])}")
        lines.append(f"{pname}_count{_fmt_labels(labels)} {hv['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def validate_prometheus_text(text: str) -> List[Tuple[str, Dict[str, str],
                                                      float]]:
    """Check ``text`` against the exposition grammar; returns the parsed
    ``(name, labels, value)`` samples, raising ``ValueError`` on the
    first violation.  Beyond line syntax it checks the histogram
    invariants: ``_bucket`` series are cumulative (non-decreasing in
    ``le`` order), end at ``le="+Inf"``, and agree with ``_count``."""
    samples: List[Tuple[str, Dict[str, str], float]] = []
    buckets: Dict[str, List[Tuple[str, float]]] = {}
    counts: Dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("TYPE", "HELP"):
                raise ValueError(f"line {lineno}: bad comment {line!r}")
            if not _METRIC_NAME_RE.match(parts[2]):
                raise ValueError(
                    f"line {lineno}: bad metric name {parts[2]!r}")
            if parts[1] == "TYPE" and parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: bad type {parts[3]!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: bad sample line {line!r}")
        labels: Dict[str, str] = {}
        raw = m.group("labels")
        if raw:
            consumed = 0
            for lm in _LABEL_PAIR_RE.finditer(raw):
                if not _LABEL_NAME_RE.match(lm.group("k")):
                    raise ValueError(
                        f"line {lineno}: bad label name {lm.group('k')!r}")
                labels[lm.group("k")] = lm.group("v")
                consumed += len(lm.group(0))
            leftover = _LABEL_PAIR_RE.sub("", raw).strip(", ")
            if leftover:
                raise ValueError(
                    f"line {lineno}: unparsable label text {leftover!r}")
        name = m.group("name")
        value = float(m.group("value").replace("Inf", "inf"))
        samples.append((name, labels, value))
        if name.endswith("_bucket") and "le" in labels:
            series = name + _fmt_labels(
                tuple(sorted((k, v) for k, v in labels.items()
                             if k != "le")))
            buckets.setdefault(series, []).append((labels["le"], value))
        elif name.endswith("_count"):
            counts[name[:-len("_count")] + _fmt_labels(
                tuple(sorted(labels.items())))] = value
    for series, pairs in buckets.items():
        vals = [v for _, v in pairs]
        if vals != sorted(vals):
            raise ValueError(f"{series}: bucket counts not cumulative")
        if pairs[-1][0] != "+Inf":
            raise ValueError(f"{series}: last bucket must be le=\"+Inf\"")
        base = series[:series.index("_bucket")] + series[
            series.index("_bucket") + len("_bucket"):]
        if base in counts and counts[base] != pairs[-1][1]:
            raise ValueError(
                f"{series}: +Inf bucket {pairs[-1][1]} != _count "
                f"{counts[base]}")
    return samples


# ------------------------------------------------------- NDJSON manifest
MANIFEST_VERSION = 1


def manifest_record(kind: str, *, meta: Optional[Mapping[str, Any]] = None,
                    metrics=None) -> Dict[str, Any]:
    """One run manifest as a JSON-safe dict: ``kind`` tags the producer
    ("serve_wave", "fleet_run", "bench", ...), ``meta`` is caller
    payload (config, counts, walls), ``metrics`` a registry or snapshot
    whose full snapshot rides along."""
    rec: Dict[str, Any] = {"manifest": MANIFEST_VERSION, "kind": str(kind)}
    if meta:
        rec["meta"] = dict(meta)
    if metrics is not None:
        rec["metrics"] = (metrics.snapshot()
                          if hasattr(metrics, "snapshot") else dict(metrics))
    return rec


def manifest_line(kind: str, *, meta: Optional[Mapping[str, Any]] = None,
                  metrics=None) -> str:
    """The NDJSON line for one run (sorted keys: equal runs give
    byte-equal lines)."""
    return json.dumps(manifest_record(kind, meta=meta, metrics=metrics),
                      sort_keys=True)


def append_manifest(path, kind: str, *,
                    meta: Optional[Mapping[str, Any]] = None,
                    metrics=None) -> str:
    """Append one manifest line to ``path`` (the NDJSON journal form:
    one JSON object per line, concatenation-safe across runs)."""
    line = manifest_line(kind, meta=meta, metrics=metrics)
    with open(path, "a") as fh:
        fh.write(line + "\n")
    return line


class ManifestReadReport:
    """What a lenient manifest read accepted and what it skipped:
    ``records`` in file order, ``skipped`` as (1-based line, reason)
    pairs — blank lines are ignored silently (NDJSON allows them),
    corrupt lines (a journal torn by a killed run) are counted."""

    def __init__(self, records: List[Dict[str, Any]],
                 skipped: List[Tuple[int, str]]):
        self.records = records
        self.skipped = skipped

    def __iter__(self):
        return iter(self.records)

    def __len__(self):
        return len(self.records)


def read_manifest_report(path, *, strict: bool = False
                         ) -> ManifestReadReport:
    """Parse an NDJSON manifest file, tolerating the damage a killed
    run leaves behind.  Lenient mode (default) skips corrupt lines
    with a per-line reason in ``report.skipped``; ``strict=True``
    raises ``ValueError`` on the first one.  Blank lines are never an
    error."""
    records: List[Dict[str, Any]] = []
    skipped: List[Tuple[int, str]] = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as exc:
                if strict:
                    raise ValueError(
                        f"read_manifest: {path}: line {lineno}: "
                        f"{exc}") from exc
                skipped.append((lineno, str(exc)))
                continue
            if not isinstance(rec, dict):
                reason = (f"expected a JSON object, got "
                          f"{type(rec).__name__}")
                if strict:
                    raise ValueError(f"read_manifest: {path}: line "
                                     f"{lineno}: {reason}")
                skipped.append((lineno, reason))
                continue
            records.append(rec)
    return ManifestReadReport(records, skipped)


def read_manifest(path, *, strict: bool = False) -> List[Dict[str, Any]]:
    """Parse an NDJSON manifest file back into records.  Lenient by
    default — blank and corrupt lines are skipped (use
    :func:`read_manifest_report` to see what was dropped);
    ``strict=True`` raises on the first corrupt line."""
    return read_manifest_report(path, strict=strict).records
