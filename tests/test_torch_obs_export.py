"""Parity of the port's exporters (``repro_torch.obs.export``: Prometheus
text and NDJSON run manifests) with the reference's ``repro.obs``.

The exporters are pure Python copied from the reference, so the same
registry history must give byte-equal Prometheus text and manifest
lines.  ``repro.obs`` imports no part of the reference that needs
``jax.experimental.enable_x64``, so it is imported here directly.  The
reference's export and manifest cases are held on the port as well.
"""
import json

import pytest

import repro.obs as ref_obs
from repro_torch.obs import (NULL_METRICS, ManifestReadReport,
                             MetricsRegistry, append_manifest,
                             manifest_line, manifest_record, read_manifest,
                             read_manifest_report, to_prometheus,
                             validate_prometheus_text)
from repro_torch.obs.metrics import parse_key


def _history(m):
    """One registry history, replayed on either package's registry."""
    m.counter("c", kind="x").inc(3)
    m.counter("fastsim.compile_hits", bucket="16x4x4").inc()
    m.gauge("g").set(7)
    m.gauge("g").set(2)
    h = m.histogram("h", buckets=(1.0, 10.0))
    h.observe(0.5)
    h.observe(5.0)
    m.histogram("serve.latency_s", kind="hpl").observe(0.003)
    return m


def _torn_journal(path, line):
    path.write_text(line("run", meta={"i": 0}) + "\n"
                    "\n"
                    + line("run", meta={"i": 1}) + "\n"
                    '["not", "an", "object"]\n'
                    '{"kind": "run", "meta": {"i": 2')
    return path


# -------------------------------------------------------------- parity

def test_prometheus_text_byte_equal_to_reference():
    ours = _history(MetricsRegistry())
    ref = _history(ref_obs.MetricsRegistry())
    assert ours.to_prometheus() == ref.to_prometheus()
    assert to_prometheus(ours) == ref_obs.to_prometheus(ref)
    assert NULL_METRICS.to_prometheus() == ""


def test_manifest_lines_byte_equal_to_reference(tmp_path):
    ours = _history(MetricsRegistry())
    ref = _history(ref_obs.MetricsRegistry())
    meta = {"n": 3, "bucket": [16, 4, 4], "name": "fleet"}
    assert manifest_line("bench", meta=meta, metrics=ours) \
        == ref_obs.manifest_line("bench", meta=meta, metrics=ref)
    assert manifest_record("bench", meta=meta) \
        == ref_obs.manifest_record("bench", meta=meta)
    a, b = tmp_path / "ours.ndjson", tmp_path / "ref.ndjson"
    append_manifest(a, "bench", meta=meta, metrics=ours)
    ref_obs.append_manifest(b, "bench", meta=meta, metrics=ref)
    assert a.read_bytes() == b.read_bytes()


def test_read_manifest_report_equal_to_reference(tmp_path):
    path = _torn_journal(tmp_path / "torn.ndjson", manifest_line)
    ours, ref = read_manifest_report(path), ref_obs.read_manifest_report(
        path)
    assert (ours.records, ours.skipped) == (ref.records, ref.skipped)


# -------------------------------------------- the reference's own cases

def test_prometheus_export_passes_own_validator():
    text = _history(MetricsRegistry()).to_prometheus()
    by_name = {}
    for name, labels, value in validate_prometheus_text(text):
        by_name.setdefault(name, []).append((labels, value))
    assert by_name["c_total"] == [({"kind": "x"}, 3.0)]
    assert ("g", [({}, 2.0)]) in by_name.items()
    assert by_name["g_peak"] == [({}, 7.0)]
    les = [lab["le"] for lab, _ in by_name["h_bucket"]]
    assert les[-1] == "+Inf"
    assert by_name["h_count"] == [({}, 2.0)]


def test_prometheus_validator_rejects_bad_text():
    with pytest.raises(ValueError, match="bad sample line"):
        validate_prometheus_text("9bad_name 1")
    with pytest.raises(ValueError, match="not cumulative"):
        validate_prometheus_text(
            'h_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\n')
    with pytest.raises(ValueError, match='le="\\+Inf"'):
        validate_prometheus_text('h_bucket{le="1"} 1\n')
    with pytest.raises(ValueError, match="!= _count"):
        validate_prometheus_text('h_bucket{le="+Inf"} 3\nh_count 4\n')


def test_manifest_round_trip(tmp_path):
    m = _history(MetricsRegistry())
    rec = manifest_record("bench", meta={"n": 3}, metrics=m)
    assert rec["manifest"] == 1 and rec["kind"] == "bench"
    assert rec["meta"] == {"n": 3} and rec["metrics"] == m.snapshot()
    p = tmp_path / "runs.ndjson"
    l1 = append_manifest(p, "bench", meta={"n": 3}, metrics=m)
    l2 = append_manifest(p, "bench", meta={"n": 3},
                         metrics=_history(MetricsRegistry()))
    assert l1 == l2
    recs = read_manifest(p)
    assert len(recs) == 2 and recs[0] == rec


def test_read_manifest_lenient_skips_with_count(tmp_path):
    report = read_manifest_report(_torn_journal(tmp_path / "torn.ndjson",
                                                manifest_line))
    assert isinstance(report, ManifestReadReport)
    assert [r["meta"]["i"] for r in report.records] == [0, 1]
    assert len(report) == 2 and list(report) == report.records
    assert [lineno for lineno, _ in report.skipped] == [4, 5]
    assert "expected a JSON object" in report.skipped[0][1]
    assert len(read_manifest(tmp_path / "torn.ndjson")) == 2


def test_read_manifest_strict_raises_with_location(tmp_path):
    path = _torn_journal(tmp_path / "torn.ndjson", manifest_line)
    with pytest.raises(ValueError, match=r"line 4: expected a JSON "
                                         r"object, got list"):
        read_manifest(path, strict=True)
    clean = tmp_path / "clean.ndjson"
    clean.write_text(manifest_line("run", meta={"i": 0}) + "\n"
                     + manifest_line("run", meta={"i": 1}) + "\n")
    assert len(read_manifest(clean, strict=True)) == 2


def test_read_manifest_empty_and_blank_files(tmp_path):
    empty = tmp_path / "empty.ndjson"
    empty.write_text("")
    blank = tmp_path / "blank.ndjson"
    blank.write_text("\n\n\n")
    for p in (empty, blank):
        assert read_manifest(p, strict=True) == []


def test_fleet_metrics_and_run_manifest(tmp_path):
    from repro_torch.platforms import get_platform
    from repro_torch.top500 import FleetTuning, predict_fleet
    plats = [get_platform("bdw-local"), get_platform("frontera")]
    tuning = FleetTuning(max_ranks=64)
    ref = predict_fleet(plats, tuning=tuning, device="cpu")
    m = MetricsRegistry()
    report = predict_fleet(plats, tuning=tuning, metrics=m, device="cpu")
    for e1, e2 in zip(ref.entries, report.entries):
        assert e1.predicted_tflops == e2.predicted_tflops   # observe-only
    snap = m.snapshot()
    assert snap["counters"]["fleet.machines"] == 2.0
    phases = {parse_key(k)[1][0][1]
              for k in snap["histograms"] if k.startswith("fleet.phase")}
    assert phases == {"tune", "sweep", "calibrate"}
    assert any(k.startswith("fleet.calibration_factor")
               for k in snap["gauges"])
    p = tmp_path / "fleet.ndjson"
    report.run_manifest(p, campaign="unit")
    rec = read_manifest(p)[0]
    assert rec["kind"] == "fleet_run"
    assert rec["meta"]["machines"] == 2 and rec["meta"]["campaign"] == "unit"
    assert rec["metrics"]["counters"]["fleet.machines"] == 2.0
    rec2 = json.loads(ref.run_manifest())
    assert rec2["meta"]["machines"] == 2 and "metrics" not in rec2
