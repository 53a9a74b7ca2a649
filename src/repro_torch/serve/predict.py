"""Batch prediction services: simulation-as-a-service endpoints.

``PredictionService`` is the workload-generic front end: requests name a
``(workload, platform)`` pair (registry names, specs, or instances) and
``flush`` drains the queue in micro-batches, one batched sweep per
workload family per wave (``FastModel.sweep_models``) — HPL requests
share ``sweep_hpl`` programs, transformer requests share ``sweep_step``
programs, and a mixed burst costs one dispatch per family.

``HPLPredictionService`` is the original HPL-specialized endpoint, kept
as the back-compat surface for cfg/params-level requests (an
``HPLConfig`` plus a ``FastSimParams`` what-if).  A burst of thousands
of requests costs a handful of bucket programs (shape-bucket LRU cache)
and one batched dispatch per (bucket, wave) — the serving answer to the
paper's 4.8-hour-per-scenario SystemC baseline.

Requests can name a registered platform instead of carrying explicit
params: ``PredictRequest(rid=1, platform="frontera")`` serves that
machine's published HPL run from its spec (DES-calibrated fastsim
params included), so the endpoint can predict any registry machine by
name.

Both services accept ``breakdown=True``: a traced DES of the same
scenario runs and ``result["breakdown"]`` carries per-phase times,
compute/comm/idle fractions and the critical path (see
``repro_torch.trace``).
The DES costs real wall time per rank, so breakdown requests are capped
at ``max_des_ranks`` (reject, don't stall, the batch endpoint) — 1024
since the engine hot-loop rewrite.  ``WorkloadRequest.regions`` runs the
breakdown DES as a representative-region simulation
(``repro_torch.scale``):
only one region of the iteration space is simulated exactly, so the
guard rises to ``max_region_ranks`` and the result is stamped
``region_approx=True``.

Production hardening (all opt-in, so the strict all-or-nothing contract
above is the default):

  * ``WorkloadRequest.timeout_s`` sets a per-request wall-clock budget.
    The deadline is stamped at submit time and propagated into the
    breakdown DES (``Engine.set_wall_deadline``); a request whose DES
    would blow the budget — or whose scenario exceeds the rank guard —
    degrades gracefully to its fastsim-only answer, stamped with
    ``fallback_reason`` and ``degraded=True`` instead of timing out (or
    rejecting) the wave.
  * transient backend errors (``RuntimeError``/``OSError`` from a sweep
    dispatch) are retried with exponential backoff (``retries``,
    ``backoff_s``); scenario errors (``ValueError``/``KeyError``) never
    are.
  * ``predict_batch(reqs, isolate_errors=True)`` captures per-request
    resolution errors into ``{"status": "error", ...}`` response
    entries instead of rejecting the wave; failed requests are never
    enqueued, so an empty or all-failed wave leaves the queue clean.
  * ``WorkloadRequest.faults`` runs the scenario on a degraded platform
    (``repro_torch.faults``): folded into the fast model's params and, for
    breakdown requests, injected into the DES.

Production throughput (all opt-in):

  * ``PredictionService(cache=True)`` attaches a content-addressed
    result cache (``repro_torch.serve.cache``): repeat scenarios are served
    from the cache (stamped ``cached=True``) and duplicate in-flight
    keys within a wave coalesce onto one dispatched leader.  Budgeted
    (``timeout_s``) requests and error/degraded results are never
    cached.
  * ``PredictionService(shard=True)`` splits each family sweep's padded
    lane axis across local devices; with one device (or an indivisible
    batch) it falls back to the exact unsharded code path.  The split
    is issued serially from the host and the sweep loop is bound by
    host dispatch, so it adds host wall and never saves it: it is kept
    for parity with the reference, not as a throughput option.
  * ``svc.warm(workloads, platforms, count=...)`` (or ``python -m
    repro_torch.serve warm``) builds the sweep buckets a traffic mix
    will need, so the first real wave pays zero compiles — verified by
    the compile hit/miss counters.

Devices: both services (and ``warm``, ``predict_top500``) take
``device=`` (default ``"cuda"``), resolved once at construction: without
a card a CUDA service raises there, before any request is queued, so a
missing device is never retried as a transient backend error nor
isolated into per-request error records.  Every sweep, fleet and
region tail the service runs goes to that device; the breakdown DES
runs on the host.

Observability (``repro_torch.obs``): both services carry a
``MetricsRegistry`` (``svc.metrics``; pass ``metrics=NULL_METRICS`` to
switch it off, or share one registry across services/replicas — they
merge).  Counters back every hardening path (retries, deadline
fallbacks, degraded answers, isolated errors, rank-guard trips,
dispatch failures), per-request latency and wave size are recorded as
histograms (distributions, not point numbers), and the queue depth is a
gauge with a tracked peak.  ``svc.metrics.to_prometheus()`` is the
scrape surface; ``svc.manifest()`` emits one NDJSON run-manifest line.
Breakdown DES runs report engine telemetry into the same registry.

Dispatch is all-or-nothing per wave: every family's sweep runs before
any result is attached, and a dispatch that fails (after retries)
stamps every request in the wave with a ``{"status": "error", ...}``
result, re-raises, and leaves the queue holding only the requests
behind the wave — the service stays reusable and the queue clean (the
resolve-all-before-enqueue guarantee, extended to dispatch time).
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.apps.hpl import HPLConfig
from repro_torch.core.engine import SimWallDeadline
from repro_torch.core.fastsim import (FastSimParams, lane_sharding,
                                      sweep_hpl, trace_count)
from repro_torch.obs import COUNT_BUCKETS, MetricsRegistry, manifest_line
from repro_torch.serve.cache import (as_result_cache, copy_payload,
                                     request_key)


@dataclasses.dataclass
class PredictRequest:
    rid: int
    cfg: Optional[HPLConfig] = None
    params: Optional[FastSimParams] = None
    platform: Optional[str] = None       # registry name; fills cfg/params
    breakdown: bool = False              # attach a DES phase breakdown
    result: Optional[dict] = None
    _t_submit: Optional[float] = dataclasses.field(default=None, repr=False)


@dataclasses.dataclass
class WorkloadRequest:
    """One (workload, platform) prediction request.  ``workload`` is a
    registry kind name, a ``WorkloadSpec``, or a ``Workload`` instance;
    ``platform`` a registry name or ``Platform`` spec; ``params`` are
    workload-spec overrides applied at resolution time."""
    rid: int
    workload: Any = "hpl"
    platform: Any = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    breakdown: bool = False              # attach a DES phase breakdown
    faults: Any = None                   # FaultSpec / dict / JSON scenario
    regions: Any = None                  # int / RegionSpec: breakdown DES
    #        runs as a representative region (repro_torch.scale), guarded by
    #        max_region_ranks instead of max_des_ranks and stamped
    #        region_approx=True
    timeout_s: Optional[float] = None    # wall budget; enables fallback
    result: Optional[dict] = None
    _bound: Any = dataclasses.field(default=None, repr=False)
    #        ^ (workload, platform, fastmodel), set by _resolve
    _ckey: Optional[str] = dataclasses.field(default=None, repr=False)
    #        ^ content-addressed cache key, set at flush time (None when
    #        the cache is off or the request is uncacheable)
    _deadline: Optional[float] = dataclasses.field(default=None, repr=False)
    _fallback: Optional[str] = dataclasses.field(default=None, repr=False)
    _t_submit: Optional[float] = dataclasses.field(default=None, repr=False)


#: live services, for registry-driven resolution-memo invalidation
_LIVE_SERVICES: "weakref.WeakSet" = weakref.WeakSet()
_RESOLUTION_HOOK_INSTALLED = False


def _install_resolution_hook() -> None:
    """Idempotently subscribe to platform re-registration so every live
    service forgets memoized resolutions of the re-registered name."""
    global _RESOLUTION_HOOK_INSTALLED
    if _RESOLUTION_HOOK_INSTALLED:
        return
    from repro_torch.platforms.registry import add_invalidation_hook

    def _on_rebound(name: str) -> None:
        for svc in list(_LIVE_SERVICES):
            svc._drop_resolution_memo(name)

    add_invalidation_hook(_on_rebound)
    _RESOLUTION_HOOK_INSTALLED = True


class PredictionService:
    """Workload-generic micro-batching front end: routes ``(workload,
    platform)`` requests through the workload registry and drains the
    queue one batched sweep per workload family per wave."""

    #: exception types a sweep dispatch may raise transiently (backend
    #: hiccups); scenario errors (ValueError/KeyError) are never retried
    TRANSIENT = (RuntimeError, OSError)

    def __init__(self, max_batch: int = 256, max_des_ranks: int = 1024,
                 max_region_ranks: int = 16384,
                 retries: int = 2, backoff_s: float = 0.05,
                 metrics: Any = None, cache: Any = None,
                 shard: bool = False, device: DeviceLike = "cuda"):
        #: resolved here, so a missing card raises before any request
        #: exists (never inside the retried dispatch)
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_des_ranks = max_des_ranks
        self.max_region_ranks = max_region_ranks
        self.retries = retries
        self.backoff_s = backoff_s
        self._queue: List[WorkloadRequest] = []
        self.stats = {"requests": 0, "batches": 0, "scenarios": 0,
                      "sweeps": 0, "des_breakdowns": 0, "retries": 0,
                      "fallbacks": 0, "errors": 0, "cache_hits": 0,
                      "cache_misses": 0, "coalesced": 0}
        #: on by default (a fresh registry); pass NULL_METRICS to opt
        #: out or a shared registry to aggregate across services
        self.metrics = MetricsRegistry() if metrics is None else metrics
        #: off by default — the strict recompute-everything contract is
        #: the default.  True / an int / a ResultCache turn
        #: on content-addressed result caching + request coalescing
        #: (share one ResultCache across services to share results).
        self.cache = as_result_cache(cache)
        #: off by default — True shards each family sweep's padded lane
        #: axis across local devices (single-device fallback is bitwise-
        #: identical to the unsharded path; the blocks are issued one
        #: after another from the host, so no faster than one device)
        self.shard = bool(shard)
        #: (workload, params, platform, faults) -> (wl, plat, model);
        #: name-level resolutions are pure, so repeat traffic skips the
        #: spec/model rebuild (the dominant per-request Python cost).
        #: Entries derived from a registry name are dropped when that
        #: name is re-registered (see _install_resolution_hook).
        self._resolve_memo: Dict[tuple, tuple] = {}
        _LIVE_SERVICES.add(self)
        _install_resolution_hook()

    def _drop_resolution_memo(self, name: str) -> None:
        """Registry rebinding event: forget memoized resolutions of
        platform ``name`` so the next request re-reads the registry."""
        self._resolve_memo = {k: v for k, v in self._resolve_memo.items()
                              if k[2] != name}

    @staticmethod
    def _memo_key(req: WorkloadRequest) -> Optional[tuple]:
        """Hashable identity of a name-level resolution, or None when
        the request carries instances/unhashables (resolved fresh)."""
        if not (isinstance(req.workload, str)
                and isinstance(req.platform, str)):
            return None
        try:
            key = (req.workload, tuple(sorted(req.params.items())),
                   req.platform, req.faults)
            hash(key)            # tuples build fine around list params;
            return key           # only hashing surfaces the TypeError
        except TypeError:        # unhashable param value / fault dict
            return None

    def _bind(self, req: WorkloadRequest) -> tuple:
        """Build (workload, platform, fastmodel) for one request."""
        from repro_torch.workloads import (Workload, WorkloadSpec,
                                           get_workload, workload_from_spec)
        wl = req.workload
        if isinstance(wl, str):
            wl = get_workload(wl, **req.params)
        elif isinstance(wl, WorkloadSpec):
            wl = workload_from_spec(
                wl.replace(**req.params) if req.params else wl)
        elif isinstance(wl, Workload):
            if req.params:
                wl = workload_from_spec(wl.spec.replace(**req.params))
        else:
            raise ValueError(f"request {req.rid}: workload must be a kind "
                             f"name, WorkloadSpec, or Workload, got "
                             f"{type(wl).__name__}")
        if req.platform is None:
            raise ValueError(f"request {req.rid}: needs a platform")
        plat = req.platform
        if isinstance(plat, str):
            from repro_torch.platforms import get_platform
            plat = get_platform(plat)
        wl.validate(plat)
        return (wl, plat, wl.fastsim_model(plat, faults=req.faults))

    def _resolve(self, req: WorkloadRequest) -> None:
        """Bind names to specs and build the fast model; idempotent, and
        every error surfaces here (before anything is enqueued)."""
        if req._bound is not None:
            return
        memo_key = self._memo_key(req)
        bound = (self._resolve_memo.get(memo_key)
                 if memo_key is not None else None)
        if bound is None:
            bound = self._bind(req)
            if memo_key is not None:
                if len(self._resolve_memo) >= 4096:
                    self._resolve_memo.clear()
                self._resolve_memo[memo_key] = bound
        wl, plat, _ = bound
        if req.breakdown:
            # region requests simulate only a representative slice of the
            # iteration space, so they get the (much higher) region guard
            guard, name = ((self.max_region_ranks, "max_region_ranks")
                           if req.regions is not None
                           else (self.max_des_ranks, "max_des_ranks"))
            if wl.des_ranks(plat) > guard:
                if req.timeout_s is not None:
                    # budgeted request: degrade to fastsim, don't reject
                    req._fallback = (f"{name}: breakdown DES at "
                                     f"{wl.des_ranks(plat)} ranks exceeds "
                                     f"{guard}")
                else:
                    raise ValueError(
                        f"request {req.rid}: breakdown DES at "
                        f"{wl.des_ranks(plat)} ranks exceeds {name}="
                        f"{guard}; pass a scaled-down scenario"
                        + ("" if req.regions is not None else
                           " or a regions= request"))
        req._bound = bound

    def submit(self, req: WorkloadRequest) -> None:
        self._resolve(req)
        if req.timeout_s is not None and req._deadline is None:
            req._deadline = time.monotonic() + req.timeout_s
        self.stats["requests"] += 1
        self._queue.append(req)
        if self.metrics.enabled:
            req._t_submit = time.perf_counter()
            self.metrics.counter("serve.requests").inc()
            self.metrics.gauge("serve.queue_depth").set(len(self._queue))

    def _cache_key(self, req: WorkloadRequest) -> Optional[str]:
        """Content-addressed key of a resolved request, or None when it
        is uncacheable.  Budgeted requests (``timeout_s``) can degrade
        nondeterministically under wall pressure, so they are never
        cached (which also keeps every rank-guard/deadline fallback out
        of the cache — degraded answers are always recomputed)."""
        if req.timeout_s is not None:
            return None
        wl, plat, _ = req._bound
        return request_key(wl.spec, plat, faults=req.faults,
                           regions=req.regions, breakdown=req.breakdown)

    def _dispatch(self, model_cls, reqs: List[WorkloadRequest]) -> List[dict]:
        """One batched sweep per family, with bounded retry + exponential
        backoff for transient backend errors.  With ``shard=True`` the
        sweep's padded lane axis is split across local devices (serially
        from the host; see ``fastsim``'s lane-sharding note)."""
        models = [r._bound[2] for r in reqs]
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                if self.shard:
                    with lane_sharding(True):
                        return model_cls.sweep_models(models,
                                                      device=self.device)
                return model_cls.sweep_models(models, device=self.device)
            except self.TRANSIENT:
                if attempt == self.retries:
                    raise
                self.stats["retries"] += 1
                self.metrics.counter("serve.retries").inc()
                time.sleep(delay)
                delay *= 2.0

    def _attach_breakdown(self, req: WorkloadRequest, out: dict) -> None:
        """Run the traced DES under the request's remaining wall budget;
        on budget exhaustion the fastsim answer stands, stamped with the
        fallback reason."""
        wl, plat, _ = req._bound
        budget = None
        if req._deadline is not None:
            budget = req._deadline - time.monotonic()
            if budget <= 0.0:
                self._degrade(out, "deadline_exceeded: wall budget spent "
                                   "before the breakdown DES started",
                              kind="deadline")
                return
        try:
            app = wl.des_app(plat, trace=True, faults=req.faults,
                             regions=req.regions, device=self.device)
            if budget is not None:
                app.engine.set_wall_deadline(budget)
            if self.metrics.enabled:
                # DES telemetry (events/s, heap depth, recycle rate)
                # lands in the service registry; engine.metrics only
                # observes, so the simulated clock is unchanged
                app.engine.metrics = self.metrics
                with self.metrics.timer("serve.des_wall_s"):
                    app.run()
            else:
                app.run()
            summary = app.engine.trace.summary()
            if req.regions is not None:
                # the trace covers only the simulated region
                summary["region_approx"] = True
                out["region_approx"] = True
            out["breakdown"] = summary
            self.stats["des_breakdowns"] += 1
            self.metrics.counter("serve.des_breakdowns").inc()
        except SimWallDeadline as exc:
            self._degrade(out, f"wall_deadline: {exc}", kind="deadline")

    def _degrade(self, out: dict, reason: str, *,
                 kind: str = "deadline") -> None:
        """Stamp a degraded (fastsim-only) answer.  ``kind`` routes the
        counter: "deadline" for wall-budget fallbacks, "rank_guard" for
        breakdown requests over the DES rank cap."""
        out["fallback_reason"] = reason
        out["degraded"] = True
        self.stats["fallbacks"] += 1
        if self.metrics.enabled:
            self.metrics.counter("serve.fallbacks").inc()
            self.metrics.counter(
                "serve.deadline_fallbacks" if kind == "deadline"
                else "serve.rank_guard_trips").inc()

    def _finish(self, req: WorkloadRequest, out: dict,
                results: Dict[int, dict]) -> None:
        """Attach one answered result to its request + the result map
        and record the request's latency."""
        req.result = out
        results[req.rid] = out
        m = self.metrics
        if m.enabled and req._t_submit is not None:
            m.histogram("serve.request_latency_s").observe(
                time.perf_counter() - req._t_submit)

    def flush(self) -> Dict[int, dict]:
        """Drain the queue in waves of up to ``max_batch`` scenarios;
        each wave groups requests by workload family and runs ONE
        ``sweep_models`` dispatch per family.  Returns {rid: result}.

        With a cache attached, each wave is first partitioned: requests
        whose content-addressed key is already cached are served
        immediately (stamped ``cached=True``); duplicate in-flight keys
        coalesce onto one *leader* per key (the only one dispatched) and
        the followers receive deep copies of the leader's result.
        Uncacheable requests (``timeout_s`` budgets, which can degrade
        nondeterministically) always take the dispatch path, and error
        results are never inserted into the cache.

        Dispatch is all-or-nothing per wave: every family's sweep runs
        before any result is attached.  If one family's dispatch fails
        (after retries), every not-yet-served request in the wave is
        stamped with a ``{"status": "error", ...}`` result, the
        exception re-raises, and the queue keeps only the requests
        behind the wave — the service stays reusable with a clean queue
        (cache hits served before the failure keep their good results)."""
        results: Dict[int, dict] = {}
        m = self.metrics
        cache = self.cache
        while self._queue:
            wave = self._queue[:self.max_batch]
            del self._queue[:self.max_batch]
            if m.enabled:
                m.histogram("serve.wave_size", COUNT_BUCKETS).observe(
                    len(wave))
                m.gauge("serve.queue_depth").set(len(self._queue))
            to_dispatch: List[WorkloadRequest] = []
            followers: Dict[str, List[WorkloadRequest]] = {}
            served_ids: set = set()
            if cache is None:
                to_dispatch = list(wave)
            else:
                leaders: Dict[str, WorkloadRequest] = {}
                for req in wave:
                    req._ckey = key = self._cache_key(req)
                    if key is None:               # uncacheable: dispatch
                        to_dispatch.append(req)
                        continue
                    hit = cache.get(key)
                    if hit is not None:
                        hit["cached"] = True      # provenance stamp; the
                        #   payload under it is bit-identical to a miss
                        self._finish(req, hit, results)
                        served_ids.add(id(req))
                        self.stats["cache_hits"] += 1
                        m.counter("serve.cache_hits").inc()
                        continue
                    self.stats["cache_misses"] += 1
                    m.counter("serve.cache_misses").inc()
                    if key in leaders:            # coalesce onto leader
                        followers.setdefault(key, []).append(req)
                    else:
                        leaders[key] = req
                        to_dispatch.append(req)
            by_family: Dict[type, List[WorkloadRequest]] = {}
            for req in to_dispatch:
                by_family.setdefault(type(req._bound[2]), []).append(req)
            dispatched: List[tuple] = []
            try:
                for model_cls, reqs in by_family.items():
                    dispatched.append((reqs, self._dispatch(model_cls, reqs)))
                    self.stats["sweeps"] += 1
                    m.counter("serve.sweeps").inc()
            except Exception as exc:
                # the wave is already off the queue; stamp every request
                # not already served from cache so callers holding the
                # objects see the failure, then surface it.  Nothing from
                # a failed wave is ever inserted into the cache.
                err = {"status": "error", "error": str(exc),
                       "error_type": type(exc).__name__}
                for req in wave:
                    if id(req) not in served_ids:
                        req.result = dict(err)
                self.stats["errors"] += 1
                m.counter("serve.dispatch_failures").inc()
                raise
            for reqs, res in dispatched:
                for req, out in zip(reqs, res):
                    out = dict(out)
                    if req._fallback is not None:    # rank-guard degrade
                        self._degrade(out, req._fallback, kind="rank_guard")
                    elif req.breakdown:
                        self._attach_breakdown(req, out)
                    if (cache is not None and req._ckey is not None
                            and not out.get("degraded")):
                        # inserts happen only here, after a successful
                        # non-degraded dispatch: errors raised above and
                        # degraded answers never enter the cache
                        cache.put(req._ckey, out,
                                  platform=req._bound[1].name)
                    self._finish(req, out, results)
                    for dup in (followers.get(req._ckey, ())
                                if req._ckey is not None else ()):
                        self._finish(dup, copy_payload(out), results)
                        self.stats["coalesced"] += 1
                        m.counter("serve.coalesced").inc()
            self.stats["batches"] += 1
            self.stats["scenarios"] += len(wave)
            if m.enabled:
                m.counter("serve.batches").inc()
                m.counter("serve.scenarios").inc(len(wave))
                if cache is not None:
                    m.gauge("serve.cache_entries").set(len(cache))
                    m.gauge("serve.cache_occupancy").set(
                        len(cache) / cache.max_entries)
        return results

    def predict_batch(self, requests: Sequence[WorkloadRequest], *,
                      isolate_errors: bool = False) -> Dict[int, dict]:
        """Submit + flush in one call.

        Default is all-or-nothing on resolution: a bad request (unknown
        workload or platform name) rejects the whole call and leaves the
        queue untouched.  With ``isolate_errors=True`` a bad request
        instead yields a ``{"status": "error", "error": ...,
        "error_type": ...}`` entry for its rid while the rest of the
        wave is served normally; failed requests are never enqueued, so
        an empty (or all-failed) wave leaves the queue clean."""
        requests = list(requests)
        if not isolate_errors:
            for req in requests:
                self._resolve(req)
            if not requests:
                return {}
            for req in requests:
                self.submit(req)        # _resolve is idempotent
            return self.flush()
        results: Dict[int, dict] = {}
        good: List[WorkloadRequest] = []
        for req in requests:
            try:
                self._resolve(req)
                good.append(req)
            except Exception as exc:
                err = {"status": "error", "error": str(exc),
                       "error_type": type(exc).__name__}
                req.result = err
                results[req.rid] = err
                self.stats["errors"] += 1
                self.metrics.counter("serve.errors_isolated").inc()
        for req in good:
            self.submit(req)
        if good:
            for rid, out in self.flush().items():
                out.setdefault("status", "ok")
                results[rid] = out
        return results

    def predict(self, workload, platform, *, faults=None,
                timeout_s=None, **params) -> dict:
        """Single-request convenience entry point."""
        return self.predict_batch(
            [WorkloadRequest(rid=0, workload=workload, platform=platform,
                             params=params, faults=faults,
                             timeout_s=timeout_s)])[0]

    # --------------------------------------------------------- warm pool
    def warm(self, workloads: Any = ("hpl",), platforms: Any = (), *,
             count: int = 1, prime_cache: bool = False,
             requests: Optional[Sequence[WorkloadRequest]] = None
             ) -> Dict[str, Any]:
        """Build the sweep buckets a (workload, platform) grid will need,
        so the first real wave pays zero compiles.

        ``workloads``/``platforms`` are names, specs, or instances (one
        or a sequence); ``count`` replicates each cell so the warm
        dispatch is padded to the same power-of-two lane count a real
        wave of that size will use (the compile counters are keyed on the
        padded batch shape — warm with the wave size you expect to
        serve).
        Alternatively ``requests=`` warms from a representative traffic
        sample: the sweep engine sees exactly the scenario/geometry mix
        (and therefore the compile buckets) those requests will need —
        breakdown/timeout stamps are dropped, only the sweep shapes
        matter.  With ``prime_cache=True`` (and a cache attached) the
        warm results are inserted too, so the first wave is all-hits,
        not just all-compile-hits.

        Compiles are measured via the trace counters and recorded as
        ``serve.warm_compiles`` / ``serve.warm_dispatches``; the report
        dict carries ``compiles``/``dispatches``/``scenarios``.  A
        second identical ``warm()`` reporting ``compiles == 0`` is the
        warm-pool verification contract."""
        from repro_torch.core import fastsim
        from repro_torch.workloads import stepsim

        def _aslist(x):
            return list(x) if isinstance(x, (list, tuple)) else [x]

        reqs: List[WorkloadRequest] = []
        if requests is not None:
            reqs = [WorkloadRequest(rid=-1 - i, workload=r.workload,
                                    platform=r.platform,
                                    params=dict(r.params), faults=r.faults,
                                    regions=r.regions)
                    for i, r in enumerate(requests)]
        else:
            for wl in _aslist(workloads):
                for plat in _aslist(platforms):
                    for i in range(max(1, int(count))):
                        reqs.append(WorkloadRequest(rid=-1 - len(reqs),
                                                    workload=wl,
                                                    platform=plat))
        for req in reqs:
            self._resolve(req)
        by_family: Dict[type, List[WorkloadRequest]] = {}
        for req in reqs:
            by_family.setdefault(type(req._bound[2]), []).append(req)
        m = self.metrics
        pre = fastsim.trace_count() + stepsim.trace_count()
        for model_cls, group in by_family.items():
            res = self._dispatch(model_cls, group)
            if m.enabled:
                m.counter("serve.warm_dispatches").inc()
            if prime_cache and self.cache is not None:
                for req, out in zip(group, res):
                    key = self._cache_key(req)
                    if key is not None:
                        self.cache.put(key, dict(out),
                                       platform=req._bound[1].name)
        compiles = fastsim.trace_count() + stepsim.trace_count() - pre
        if m.enabled and compiles:
            m.counter("serve.warm_compiles").inc(compiles)
        return {"compiles": compiles, "dispatches": len(by_family),
                "scenarios": len(reqs)}

    # ------------------------------------------------------ observability
    def prometheus(self) -> str:
        """The service's metrics in Prometheus text exposition format."""
        return self.metrics.to_prometheus()

    def manifest(self, **meta) -> str:
        """One NDJSON run-manifest line: service config + lifetime stats
        as ``meta`` and the full metrics snapshot (see
        ``repro_torch.obs``)."""
        base = {"service": type(self).__name__,
                "max_batch": self.max_batch, "stats": dict(self.stats)}
        base.update(meta)
        return manifest_line("serve_run", meta=base, metrics=self.metrics)


class HPLPredictionService:
    """Micro-batching front end over the batched sweep engine — the
    HPL-specialized back-compat surface (cfg/params-level requests);
    new call sites should prefer the workload-generic
    ``PredictionService``."""

    def __init__(self, max_batch: int = 256, max_des_ranks: int = 1024,
                 metrics: Any = None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_des_ranks = max_des_ranks
        self._queue: List[PredictRequest] = []
        self.stats = {"requests": 0, "batches": 0, "scenarios": 0,
                      "traces": 0, "des_breakdowns": 0}
        #: same metric names as PredictionService (serve.requests,
        #: serve.batches, serve.scenarios, serve.sweeps, ...), so the
        #: two endpoints are drop-in equivalents on a dashboard
        self.metrics = MetricsRegistry() if metrics is None else metrics

    def _resolve(self, req: PredictRequest) -> None:
        if req.params is None or req.cfg is None:
            if req.platform is None:
                raise ValueError(
                    f"request {req.rid}: needs (cfg, params) or a "
                    "platform name")
            from repro_torch.platforms import get_platform
            plat = get_platform(req.platform)
            if req.params is None:
                req.params = plat.fastsim()
            if req.cfg is None:
                req.cfg = plat.hpl_config()
        if req.breakdown:
            if req.platform is None:
                raise ValueError(
                    f"request {req.rid}: breakdown=True needs a platform "
                    "name (the DES is built from the spec)")
            if req.cfg.n_ranks > self.max_des_ranks:
                raise ValueError(
                    f"request {req.rid}: breakdown DES at "
                    f"{req.cfg.n_ranks} ranks exceeds max_des_ranks="
                    f"{self.max_des_ranks}; pass a scaled-down cfg")

    def submit(self, req: PredictRequest) -> None:
        self._resolve(req)
        self.stats["requests"] += 1
        self._queue.append(req)
        if self.metrics.enabled:
            req._t_submit = time.perf_counter()
            self.metrics.counter("serve.requests").inc()
            self.metrics.gauge("serve.queue_depth").set(len(self._queue))

    def _des_breakdown(self, req: PredictRequest) -> dict:
        """Traced DES of the request scenario -> phase/category report."""
        from repro_torch.core.apps.hpl import HPLSim
        from repro_torch.platforms import get_platform
        sim = HPLSim(req.cfg, get_platform(req.platform), trace=True)
        if self.metrics.enabled:
            sim.engine.metrics = self.metrics
            with self.metrics.timer("serve.des_wall_s"):
                res = sim.run()
        else:
            res = sim.run()
        out = res.trace.summary()
        out["des_time_s"] = res.time_s
        out["des_gflops"] = res.gflops
        self.stats["des_breakdowns"] += 1
        self.metrics.counter("serve.des_breakdowns").inc()
        return out

    def flush(self) -> Dict[int, dict]:
        """Drain the queue in waves of up to ``max_batch`` scenarios.

        Each wave is one ``sweep_hpl`` call: scenarios sharing a shape
        bucket run as a single batched program.  Returns
        {rid: result-dict} for everything served.
        """
        results: Dict[int, dict] = {}
        m = self.metrics
        t0 = trace_count()
        while self._queue:
            wave = self._queue[:self.max_batch]
            del self._queue[:self.max_batch]
            if m.enabled:
                m.histogram("serve.wave_size", COUNT_BUCKETS).observe(
                    len(wave))
                m.gauge("serve.queue_depth").set(len(self._queue))
            res = sweep_hpl([r.cfg for r in wave],
                            [r.params for r in wave], device=self.device)
            m.counter("serve.sweeps").inc()   # one sweep_hpl per wave
            for req, out in zip(wave, res):
                if req.breakdown:
                    out = dict(out)
                    out["breakdown"] = self._des_breakdown(req)
                req.result = out
                results[req.rid] = out
                if m.enabled and req._t_submit is not None:
                    m.histogram("serve.request_latency_s").observe(
                        time.perf_counter() - req._t_submit)
            self.stats["batches"] += 1
            self.stats["scenarios"] += len(wave)
            if m.enabled:
                m.counter("serve.batches").inc()
                m.counter("serve.scenarios").inc(len(wave))
        self.stats["traces"] += trace_count() - t0
        return results

    def predict_batch(self, scenarios: Sequence[PredictRequest]
                      ) -> Dict[int, dict]:
        """Submit + flush in one call — the RPC-handler entry point.

        All-or-nothing on resolution: every request is resolved before
        any is enqueued, so one bad request (unknown platform name
        mid-batch, missing cfg) rejects the whole call and leaves the
        queue exactly as it was.  An empty batch returns {} without
        dispatching anything.
        """
        scenarios = list(scenarios)
        for req in scenarios:
            self._resolve(req)
        if not scenarios:
            return {}
        for req in scenarios:
            self.submit(req)        # _resolve is idempotent
        return self.flush()

    def predict_platforms(self, names: Sequence[str],
                          cfg: Optional[HPLConfig] = None,
                          ) -> Mapping[str, dict]:
        """Predict a batch of registry machines by name (their published
        HPL runs, or a shared ``cfg`` override) in one sweep."""
        reqs = [PredictRequest(rid=i, cfg=cfg, platform=name)
                for i, name in enumerate(names)]
        out = self.predict_batch(reqs)
        return {name: out[i] for i, name in enumerate(names)}

    def predict_top500(self, csv_path, **kw) -> dict:
        """Serve a whole TOP500 list export: ranked predicted-vs-
        published Rmax report as a JSON-safe dict (delegates to
        ``repro_torch.top500.predict_top500``; same keywords)."""
        report = predict_top500(csv_path, metrics=self.metrics,
                                device=self.device, **kw)
        self.stats["requests"] += len(report.entries)
        self.stats["scenarios"] += len(report.entries)
        self.stats["batches"] += 1
        if self.metrics.enabled:
            self.metrics.counter("serve.requests").inc(len(report.entries))
            self.metrics.counter("serve.scenarios").inc(len(report.entries))
            self.metrics.counter("serve.batches").inc()
        return report.to_dict()

    # ------------------------------------------------------ observability
    def prometheus(self) -> str:
        """The service's metrics in Prometheus text exposition format."""
        return self.metrics.to_prometheus()

    def manifest(self, **meta) -> str:
        """One NDJSON run-manifest line (same shape as
        ``PredictionService.manifest``)."""
        base = {"service": type(self).__name__,
                "max_batch": self.max_batch, "stats": dict(self.stats)}
        base.update(meta)
        return manifest_line("serve_run", meta=base, metrics=self.metrics)


def warm(workloads: Any = ("hpl",), platforms: Any = (), *,
         count: int = 1, prime_cache: bool = False,
         service: Optional[PredictionService] = None,
         device: DeviceLike = "cuda", **service_kw) -> Dict[str, Any]:
    """Module-level warm-pool entry point (``python -m repro_torch.serve
    warm`` wraps this): build the sweep buckets for a (workload,
    platform) grid on ``service`` — or a fresh
    ``PredictionService(device=device, **service_kw)`` — and return the
    warm report (see ``PredictionService.warm``)."""
    svc = service if service is not None else PredictionService(
        device=device, **service_kw)
    report = svc.warm(workloads, platforms, count=count,
                      prime_cache=prime_cache)
    report["service"] = type(svc).__name__
    return report


def predict_top500(csv_path, *, namespace: Optional[str] = None,
                   overwrite: bool = False, metrics: Any = None,
                   device: DeviceLike = "cuda", **kw):
    """Parse a TOP500 list export, infer a Platform per row, and predict
    the whole fleet in one batched sweep — returns the ``FleetReport``
    (rows the lenient parser rejected surface in ``report.skipped_rows``;
    a list with *no* parseable rows raises with the reasons).

    ``namespace="top500"`` additionally registers every inferred spec as
    ``top500/<name>`` so individual machines can then be served by name
    through ``PredictRequest(platform=...)``; re-ingesting the same list
    needs ``overwrite=True`` (forwarded to ``bulk_register``).  Remaining
    keywords reach ``repro_torch.top500.predict_fleet`` (``tuning=``,
    ``calibrate=``, ``infer_kw=``); the sweep runs on ``device``,
    resolved before the list is read.
    """
    from repro_torch.top500 import (infer_platforms, parse_top500,
                                    predict_fleet)
    dev = resolve_device(device)
    parsed = parse_top500(csv_path)
    if metrics is not None and metrics.enabled:
        metrics.counter("fleet.rows_parsed").inc(len(parsed.rows))
        metrics.counter("fleet.rows_skipped").inc(len(parsed.skipped))
    if not parsed.rows:
        raise ValueError(
            f"predict_top500: no parseable rows in {csv_path!r}; "
            f"skipped: {parsed.skipped[:5]}"
            f"{'...' if len(parsed.skipped) > 5 else ''}")
    platforms = infer_platforms(parsed.rows,
                                **(kw.pop("infer_kw", None) or {}))
    if namespace is not None:
        from repro_torch.platforms import bulk_register
        platforms = bulk_register(platforms, namespace=namespace,
                                  overwrite=overwrite)
    report = predict_fleet(platforms, metrics=metrics, device=dev, **kw)
    report.skipped_rows = list(parsed.skipped)
    return report
