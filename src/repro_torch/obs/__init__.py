"""repro_torch.obs — the metrics registry the simulation layers report
into (counters / gauges / fixed-bucket histograms, mergeable and JSON
round-trip).  ``core.fastsim`` records its bucket-cache and sweep-lane
metrics here once a registry is installed with ``set_global_metrics``.
"""
from .metrics import (COUNT_BUCKETS, DEFAULT_LATENCY_BUCKETS, NULL_METRICS,
                      RATIO_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, Timer, get_global_metrics,
                      global_metrics, merge_snapshots, set_global_metrics)

__all__ = [
    "MetricsRegistry", "NULL_METRICS", "Counter", "Gauge", "Histogram",
    "Timer", "DEFAULT_LATENCY_BUCKETS", "COUNT_BUCKETS", "RATIO_BUCKETS",
    "merge_snapshots", "get_global_metrics", "set_global_metrics",
    "global_metrics",
]
