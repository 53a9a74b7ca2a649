"""MetricsRegistry — counters, gauges, and fixed-bucket histograms for
the serving + simulation stack (DESIGN.md §18).

The contract mirrors the trace subsystem's null-object pattern (§13):
when metrics are off a component carries the module-level
``NULL_METRICS`` singleton whose instruments are no-ops and whose
``enabled`` flag is False, so every instrumentation site reduces to one
attribute test and hot paths pay nothing.  Crucially an enabled
registry only *observes* — it never schedules engine events, never
perturbs sweep inputs — so instrumented runs produce bit-identical
simulation results (asserted in tests/test_obs.py for HPL and
transformer on both the DES and the batched fast paths).

Three instrument kinds, chosen for mergeability (fleet runs, CI shards
and serving replicas aggregate by snapshot merge, which must be
associative and commutative — property-tested):

  * **Counter** — monotone float add.  Merge: sum.
  * **Gauge** — last-set value plus tracked min/max.  Merge: max of
    values (gauges here are depth/high-water style readings, where max
    is the meaningful aggregate), max of maxes, min of mins.
  * **Histogram** — fixed upper-bound buckets (so two snapshots merge
    by elementwise count addition; merging histograms with different
    bounds raises) plus sum/count/min/max.  Point numbers mislead
    without distributions (Cornebize & Legrand, PAPERS.md): latency and
    throughput are recorded as histograms, never single floats.

Instruments are keyed by ``(name, labels)``; snapshots flatten the key
to ``name{k="v",...}`` with sorted labels so equal registries serialize
to equal JSON (deterministic snapshots).  ``Timer`` is the span-style
context manager over a histogram.

A process-global registry hook (``set_global_metrics``) lets the
module-shaped layers — ``core.fastsim``, ``workloads.stepsim`` — report
compile-cache and sweep-lane metrics without threading a registry
through every call; it defaults to ``NULL_METRICS`` so nothing is
recorded unless a caller opts in.

This is the port's own copy of ``repro.obs.metrics``: instrument names
and snapshot format are the same, and ``to_prometheus`` goes through the
port's ``obs/export.py``.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import re
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Timer", "MetricsRegistry",
    "NULL_METRICS", "DEFAULT_LATENCY_BUCKETS", "merge_snapshots",
    "get_global_metrics", "set_global_metrics", "global_metrics",
]

#: default latency buckets (seconds): sub-ms fastsim dispatches through
#: multi-minute DES breakdowns land in distinct buckets
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0)

#: small-integer buckets for size-ish distributions (wave sizes, lanes)
COUNT_BUCKETS: Tuple[float, ...] = (
    1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0)

#: unit-interval buckets (occupancy / efficiency fractions)
RATIO_BUCKETS: Tuple[float, ...] = (
    0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0)

Labels = Tuple[Tuple[str, str], ...]

_KEY_RE = re.compile(
    r'^(?P<name>[^{}]+)(?:\{(?P<labels>[^{}]*)\})?$')
_LABEL_RE = re.compile(r'(?P<k>[A-Za-z_][A-Za-z0-9_.]*)="(?P<v>[^"]*)"')


def _labels_of(labels: Mapping[str, Any]) -> Labels:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def flatten_key(name: str, labels: Labels = ()) -> str:
    """``name`` or ``name{k="v",...}`` with sorted labels — the
    snapshot/JSON key form (parse back with :func:`parse_key`)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


def parse_key(key: str) -> Tuple[str, Labels]:
    m = _KEY_RE.match(key)
    if not m:
        raise ValueError(f"bad metric key {key!r}")
    raw = m.group("labels")
    if not raw:
        return m.group("name"), ()
    labels = tuple((lm.group("k"), lm.group("v"))
                   for lm in _LABEL_RE.finditer(raw))
    return m.group("name"), labels


# ---------------------------------------------------------- instruments
class Counter:
    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = value

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Gauge:
    __slots__ = ("value", "max", "min")

    def __init__(self):
        self.value: float = 0.0
        self.max: Optional[float] = None
        self.min: Optional[float] = None

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        if self.max is None or v > self.max:
            self.max = v
        if self.min is None or v < self.min:
            self.min = v


class Histogram:
    """Fixed-bucket histogram: ``bounds`` are ascending upper bounds;
    ``counts`` has ``len(bounds) + 1`` entries, the last being the
    overflow (+Inf) bucket."""

    __slots__ = ("bounds", "counts", "sum", "count", "min", "max")

    def __init__(self, bounds: Iterable[float] = DEFAULT_LATENCY_BUCKETS):
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        if not self.bounds or list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(
                f"histogram bounds must be ascending and distinct, "
                f"got {self.bounds}")
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1
        if self.max is None or v > self.max:
            self.max = v
        if self.min is None or v < self.min:
            self.min = v

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile in [0, 1] (0.0 when empty)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        lo = 0.0
        for i, c in enumerate(self.counts):
            hi = self.bounds[i] if i < len(self.bounds) else (
                self.max if self.max is not None else lo)
            if cum + c >= target and c > 0:
                frac = (target - cum) / c
                return lo + frac * (max(hi, lo) - lo)
            cum += c
            lo = hi
        return self.max if self.max is not None else 0.0

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class Timer:
    """Span-style context manager: observes elapsed wall seconds into a
    histogram on exit; ``.elapsed`` holds the last measurement."""

    __slots__ = ("_hist", "_t0", "elapsed")

    def __init__(self, hist: Histogram):
        self._hist = hist
        self._t0 = 0.0
        self.elapsed: Optional[float] = None

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
        self._hist.observe(self.elapsed)


# ---------------------------------------------------------- null object
class _NullCounter:
    __slots__ = ()
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    value = 0.0
    max = None
    min = None

    def set(self, v: float) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    bounds: Tuple[float, ...] = ()
    sum = 0.0
    count = 0
    min = None
    max = None
    mean = 0.0

    def observe(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0


class _NullTimer:
    __slots__ = ()
    elapsed = None

    def __enter__(self) -> "_NullTimer":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()
_NULL_TIMER = _NullTimer()


class _NullMetrics:
    """Metrics-off singleton: instruments are shared no-ops, snapshots
    are empty, and ``enabled`` is False so hot paths skip recording
    behind one attribute test."""
    enabled = False
    __slots__ = ()

    def counter(self, name: str, **labels) -> _NullCounter:
        return _NULL_COUNTER

    def gauge(self, name: str, **labels) -> _NullGauge:
        return _NULL_GAUGE

    def histogram(self, name: str, buckets=None, **labels) -> _NullHistogram:
        return _NULL_HISTOGRAM

    def timer(self, name: str, buckets=None, **labels) -> _NullTimer:
        return _NULL_TIMER

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, **kw)

    def to_prometheus(self) -> str:
        return ""


NULL_METRICS = _NullMetrics()


# ------------------------------------------------------------- registry
class MetricsRegistry:
    """The enabled registry: instruments are created on first use and
    keyed ``(name, sorted labels)``; repeat lookups return the same
    object, so call sites may cache them."""

    enabled = True

    def __init__(self):
        self._counters: Dict[Tuple[str, Labels], Counter] = {}
        self._gauges: Dict[Tuple[str, Labels], Gauge] = {}
        self._histograms: Dict[Tuple[str, Labels], Histogram] = {}

    # -------------------------------------------------- instrument API
    def counter(self, name: str, **labels) -> Counter:
        key = (name, _labels_of(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _labels_of(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, buckets: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        key = (name, _labels_of(labels))
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram(
                DEFAULT_LATENCY_BUCKETS if buckets is None else buckets)
        return h

    def timer(self, name: str, buckets: Optional[Iterable[float]] = None,
              **labels) -> Timer:
        return Timer(self.histogram(name, buckets, **labels))

    # ------------------------------------------------------- snapshots
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Deterministic (key-sorted) JSON-safe snapshot of every
        instrument; equal histories give equal snapshots."""
        counters = {flatten_key(*k): c.value
                    for k, c in self._counters.items()}
        gauges = {flatten_key(*k): {"value": g.value, "max": g.max,
                                    "min": g.min}
                  for k, g in self._gauges.items()}
        hists = {flatten_key(*k): {
            "bounds": list(h.bounds), "counts": list(h.counts),
            "sum": h.sum, "count": h.count, "min": h.min, "max": h.max}
            for k, h in self._histograms.items()}
        return {"counters": dict(sorted(counters.items())),
                "gauges": dict(sorted(gauges.items())),
                "histograms": dict(sorted(hists.items()))}

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, **kw)

    @classmethod
    def from_snapshot(cls, snap: Mapping[str, Any]) -> "MetricsRegistry":
        reg = cls()
        reg.merge(snap)
        return reg

    @classmethod
    def from_json(cls, s: str) -> "MetricsRegistry":
        return cls.from_snapshot(json.loads(s))

    def merge(self, other) -> "MetricsRegistry":
        """Fold another registry (or snapshot dict) into this one —
        counters add, gauges max, histogram buckets add elementwise
        (same-name histograms must share bounds).  Returns self."""
        snap = other.snapshot() if hasattr(other, "snapshot") else other
        for key, v in snap.get("counters", {}).items():
            name, labels = parse_key(key)
            self._counters.setdefault((name, labels), Counter()).value += v
        for key, gv in snap.get("gauges", {}).items():
            name, labels = parse_key(key)
            g = self._gauges.setdefault((name, labels), Gauge())
            g.value = max(g.value, gv["value"]) if g.max is not None \
                else gv["value"]
            for attr, pick in (("max", max), ("min", min)):
                mine, theirs = getattr(g, attr), gv.get(attr)
                if theirs is not None:
                    setattr(g, attr,
                            theirs if mine is None else pick(mine, theirs))
        for key, hv in snap.get("histograms", {}).items():
            name, labels = parse_key(key)
            hkey = (name, labels)
            h = self._histograms.get(hkey)
            if h is None:
                h = self._histograms[hkey] = Histogram(hv["bounds"])
            if list(h.bounds) != list(hv["bounds"]):
                raise ValueError(
                    f"cannot merge histogram {key!r}: bounds differ "
                    f"({list(h.bounds)} vs {list(hv['bounds'])})")
            for i, c in enumerate(hv["counts"]):
                h.counts[i] += c
            h.sum += hv["sum"]
            h.count += hv["count"]
            for attr, pick in (("max", max), ("min", min)):
                mine, theirs = getattr(h, attr), hv.get(attr)
                if theirs is not None:
                    setattr(h, attr,
                            theirs if mine is None else pick(mine, theirs))
        return self

    # --------------------------------------------------------- export
    def to_prometheus(self) -> str:
        from .export import to_prometheus
        return to_prometheus(self)

    def __repr__(self) -> str:
        return (f"MetricsRegistry({len(self._counters)} counters, "
                f"{len(self._gauges)} gauges, "
                f"{len(self._histograms)} histograms)")


def merge_snapshots(*snaps: Mapping[str, Any]) -> Dict[str, Any]:
    """Pure merge of snapshot dicts (associative and commutative —
    property-tested in tests/test_obs_properties.py)."""
    reg = MetricsRegistry()
    for s in snaps:
        reg.merge(s)
    return reg.snapshot()


# ------------------------------------------------------ global registry
# Module-shaped layers (fastsim, stepsim) report through this hook; it
# defaults to NULL_METRICS so uninstrumented runs record nothing and the
# guard is one `enabled` test.
_GLOBAL = NULL_METRICS


def get_global_metrics():
    return _GLOBAL


def set_global_metrics(registry) -> Any:
    """Install ``registry`` (a MetricsRegistry or NULL_METRICS) as the
    process-global sink; returns the previous one for restoration."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = registry if registry is not None else NULL_METRICS
    return prev


@contextlib.contextmanager
def global_metrics(registry):
    """Scoped ``set_global_metrics`` (restores the previous sink)."""
    prev = set_global_metrics(registry)
    try:
        yield registry
    finally:
        set_global_metrics(prev)
