"""Stream-level (fluid) network model with max-min fair bandwidth sharing.

The paper's network layer: "a stream-level network model is implemented as
an alternative [to packet-level] that offers latency and bandwidth
restrictions ... we divide large messages into smaller chunks and calculate
the transmission time according to the currently allocated bandwidth".

We implement the continuous limit of that chunking: each message is a
*flow* over its route's links; whenever the flow set changes, bandwidth is
re-allocated max-min fairly (progressive filling) and every flow's
completion time is re-predicted.  Contention (the paper's §V finding that a
200 Gb/s upgrade buys almost nothing on a congested fat-tree) emerges from
the shared-link allocation.

The max-min allocation also exists as a vectorized CUDA kernel
(``repro_torch.kernels.maxmin_fair``) used by the fast exascale path.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.engine import Engine, Event


class Link:
    __slots__ = ("capacity", "latency", "flows", "name", "_mark")

    def __init__(self, capacity: float, latency: float = 0.0, name: str = ""):
        self.capacity = capacity      # bytes / s
        self.latency = latency        # s per traversal
        # flow -> None: an *ordered* set.  Iteration order must be
        # insertion order, not id() order — component traversal feeds the
        # engine heap, and id()-ordered sets made same-timestamp event
        # ordering (and traces) vary run-to-run.
        self.flows: Dict["Flow", None] = {}
        self.name = name
        self._mark = 0      # visited stamp for Network._component


class Flow:
    __slots__ = ("size", "remaining", "links", "rate", "done", "_last_t",
                 "_version", "_mark", "_occ")

    def __init__(self, size: float, links: Sequence[Link], done: Event):
        self.size = float(size)
        self.remaining = float(size)
        self.links = list(links)
        self.rate = 0.0
        self.done = done
        self._last_t = 0.0
        self._version = 0
        self._mark = 0      # visited stamp for Network._component
        self._occ = 0       # occurrence count within one _reallocate


class Network:
    """Holds links + active flows; topology supplies routes."""

    def __init__(self, engine: Engine, topology, *,
                 min_flow_time: float = 0.0):
        self.engine = engine
        self.topo = topology
        self.flows: Dict[Flow, None] = {}   # ordered set (see Link.flows)
        self.min_flow_time = min_flow_time
        # route cache: topology routes are pure functions of (src, dst)
        # (even dragonfly Valiant is deterministic) and link latencies
        # never change mid-run, so (links, latency) can be memoized
        self._routes: Dict = {}
        # completed Flow shells for reuse (engine.pooling only); a
        # recycled flow keeps its monotonic _version so stale completion
        # predictions from its previous life can never fire (see
        # _maybe_complete's version check)
        self._flow_pool: List[Flow] = []
        # pre-bound callbacks: scheduled once per flow event, so the
        # binding cost is paid here instead of per call_at
        self._complete_cb = self._maybe_complete
        self._start_cb = self._start_flow
        self._stamp = 0     # _component's visited stamp

    # -- fluid max-min fairness ------------------------------------------
    #
    # Max-min allocation decomposes exactly over connected components of
    # the flow/link sharing graph, so a flow arrival/departure only
    # re-allocates its component — O(component) per event instead of
    # O(all flows).  This is what lets the Python DES reach 10^4 ranks
    # (paper Fig 7); the exascale path uses the vectorized kernel instead.
    def _component(self, seeds: Sequence[Flow]) -> List[Flow]:
        # visited tracking by stamping Flow/Link objects (monotonic
        # per-Network counter) instead of building id() sets per call.
        # NOTE: seed occurrences are deliberately preserved (a neighbor
        # sharing k links is seeded k times and _reallocate's shares
        # divide by occurrence count); only traversal-discovered flows
        # dedup, exactly like the id()-set version.
        stamp = self._stamp = self._stamp + 1
        out: List[Flow] = []
        stack = [f for f in seeds if f in self.flows]
        for f in stack:
            f._mark = stamp
        while stack:
            f = stack.pop()
            out.append(f)
            for l in f.links:
                if l._mark == stamp:
                    continue
                l._mark = stamp
                for g in l.flows:
                    if g._mark != stamp:
                        g._mark = stamp
                        stack.append(g)
        return out

    def _reallocate(self, seeds: Optional[Sequence[Flow]] = None):
        now = self.engine.now
        if seeds is not None and len(seeds) == 1:
            # fast path: a lone flow whose links carry nothing else gets
            # min-capacity — exactly what progressive filling computes
            # for a singleton component, without the id()-dict machinery
            f = seeds[0]
            if f in self.flows:
                alone = True
                for l in f.links:
                    if len(l.flows) > 1:
                        alone = False
                        break
                if alone:
                    if f.rate > 0:
                        f.remaining -= f.rate * (now - f._last_t)
                        if f.remaining < 0:
                            f.remaining = 0.0
                    f._last_t = now
                    rate = math.inf
                    for l in f.links:
                        if l.capacity < rate:
                            rate = l.capacity
                    f.rate = rate
                    f._version += 1
                    t_done = now + (f.remaining / rate
                                    if rate < math.inf else 0.0)
                    self.engine.call_at(t_done, self._complete_cb,
                                        (f, f._version))
                    return
        comp = self._component(seeds) if seeds is not None \
            else list(self.flows)
        # NOTE: ``comp`` may contain the same flow more than once
        # (neighbors sharing >= 2 links are seeded per shared link and
        # ``_component`` keeps the occurrences); shares deliberately
        # divide by *occurrence* counts — the reference semantics are
        # the quadratic per-round recount of unassigned occurrences.
        # Counting each flow's multiplicity up front (stamp pass) lets
        # the fill keep those counts incrementally — decrement by
        # ``_occ`` when a flow assigns — which is bit-identical to the
        # recount but O(rounds * links) instead of
        # O(rounds * links * flows).
        stamp = self._stamp = self._stamp + 1
        uniq: List[Flow] = []
        for f in comp:
            if f._mark == stamp:
                f._occ += 1
                continue
            f._mark = stamp
            f._occ = 1
            uniq.append(f)
            # progress accounting since last change (idempotent per
            # occurrence in the reference, so once per flow is exact)
            if f.rate > 0:
                f.remaining -= f.rate * (now - f._last_t)
                if f.remaining < 0:
                    f.remaining = 0.0
            f._last_t = now
        # progressive filling within the component.  One entry per link:
        # [remaining_capacity, flows, unassigned_occurrences].
        links: Dict[int, list] = {}
        for f in uniq:
            f.rate = -1.0  # unassigned
            occ = f._occ
            for l in f.links:
                e = links.get(id(l))
                if e is None:
                    links[id(l)] = e = [l.capacity, [], 0]
                e[1].append(f)
                e[2] += occ
        entries = list(links.values())
        n_active = len(comp)
        while n_active > 0:
            best, best_share = None, math.inf
            for e in entries:
                n = e[2]
                if n == 0:
                    continue
                share = e[0] / n
                if share < best_share:
                    best_share, best = share, e
            if best is None:
                for f in uniq:  # flows with no links (self-send)
                    if f.rate < 0:
                        f.rate = math.inf
                        n_active -= f._occ
                break
            for f in best[1]:
                if f.rate < 0:
                    f.rate = best_share
                    n_active -= f._occ
                    for l in f.links:
                        e2 = links[id(l)]
                        e2[0] -= best_share
                        e2[2] -= f._occ
        # re-predict completions
        for f in comp:
            f._version += 1
            if f.rate <= 0:
                continue
            t_done = now + (f.remaining / f.rate if f.rate < math.inf else 0.0)
            self.engine.call_at(t_done, self._complete_cb,
                                (f, f._version))

    def _maybe_complete(self, arg):
        f, version = arg
        if f._version != version or f not in self.flows:
            return
        now = self.engine.now
        f.remaining -= f.rate * (now - f._last_t)
        f._last_t = now
        if f.remaining > 1e-9 * max(f.size, 1.0):
            return  # superseded; a newer prediction exists
        self.flows.pop(f, None)
        # single pass: drop f from each link, then collect that link's
        # survivors — same neighbor list (and order) as collecting
        # before the pops, without the per-flow identity checks
        neighbors: List[Flow] = []
        for l in f.links:
            lf = l.flows
            lf.pop(f, None)
            if lf:
                neighbors.extend(lf)
        if neighbors:
            self._reallocate(neighbors)
        done = f.done
        if self.engine.pooling:
            # shell back to the pool; _version is NOT reset (monotonic
            # across lives), so leftover (f, old_version) predictions in
            # the heap stay stale forever
            f.done = None
            f.links = []
            self._flow_pool.append(f)
            # the flow-done event is internal to the network->SimMPI
            # edge: set() hands the wakeups to the engine FIFO, after
            # which nothing references it — recycle immediately
            done.set()
            self.engine._recycle_event(done)
        else:
            done.set()

    # -- public API -------------------------------------------------------
    def set_capacity(self, link: Link, capacity: float):
        """Change a link's capacity mid-run (the fault layer's
        time-varying bandwidth hook).  Flows crossing the link get their
        shares and completion predictions recomputed; with no flows the
        update is free.  Capacity must stay > 0 — fail-stop is modeled
        by killing processes, not by zero-bandwidth links."""
        if capacity <= 0:
            raise ValueError(f"link capacity must be > 0, got {capacity}")
        link.capacity = capacity
        if link.flows:
            self._reallocate(list(link.flows))

    def send(self, src: int, dst: int, size: float) -> Event:
        """Start a flow; returns Event set at completion (after path latency
        + bandwidth-shared transfer)."""
        done = self.engine.event()
        route = self._routes.get((src, dst))
        if route is None:
            links = self.topo.route(src, dst)
            route = (links, sum(l.latency for l in links)
                     + self.topo.base_latency)
            self._routes[(src, dst)] = route
        links, latency = route
        if not links or size <= 0:
            self.engine.call_at(self.engine.now + latency, done.set, None)
            return done
        pool = self._flow_pool
        if pool:
            f = pool.pop()
            f.size = float(size)
            f.remaining = f.size
            f.links = list(links)
            f.rate = 0.0
            f.done = done
            f._last_t = 0.0
        else:
            f = Flow(size, links, done)
        self.engine.call_at(self.engine.now + latency, self._start_cb, f)
        return done

    def _start_flow(self, f: Flow):
        f._last_t = self.engine.now
        self.flows[f] = None
        for l in f.links:
            l.flows[f] = None
        self._reallocate([f])
