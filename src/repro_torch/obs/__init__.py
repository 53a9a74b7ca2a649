"""repro_torch.obs — metrics & telemetry for the simulation stack.

Zero-overhead-when-off metrics in the trace subsystem's null-object
style: ``MetricsRegistry`` (counters / gauges / fixed-bucket histograms,
mergeable and JSON round-trip), ``Timer`` spans, a Prometheus text
exporter, and NDJSON run manifests.

Simulation layers stay metrics-free unless opted in: hang a registry on
``engine.metrics`` (DES) or install one with ``set_global_metrics``
(fastsim / stepsim program-cache and sweep-lane metrics).  Instrumented
runs are bit-identical to uninstrumented ones — the registry only
observes.
"""
from .export import (ManifestReadReport, append_manifest, manifest_line,
                     manifest_record, read_manifest,
                     read_manifest_report, to_prometheus,
                     validate_prometheus_text)
from .metrics import (COUNT_BUCKETS, DEFAULT_LATENCY_BUCKETS, NULL_METRICS,
                      RATIO_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, Timer, get_global_metrics,
                      global_metrics, merge_snapshots, set_global_metrics)

__all__ = [
    "MetricsRegistry", "NULL_METRICS", "Counter", "Gauge", "Histogram",
    "Timer", "DEFAULT_LATENCY_BUCKETS", "COUNT_BUCKETS", "RATIO_BUCKETS",
    "merge_snapshots", "get_global_metrics", "set_global_metrics",
    "global_metrics", "to_prometheus", "validate_prometheus_text",
    "manifest_record", "manifest_line", "append_manifest", "read_manifest",
    "read_manifest_report", "ManifestReadReport",
]
