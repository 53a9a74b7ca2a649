"""Discrete-event simulation engine (the paper's SystemC/CoFluent analog).

Sequential engine; every simulated MPI rank / virtual thread is a Python
generator ("CoFluent virtual thread").  Processes yield:

    float/int        — wait that many simulated seconds
    Event            — park until the event fires
    Process          — park until the child process terminates (join)
    ("spawn", gen)   — start a child process, continue immediately

The paper's "privatization of global variables" workaround (§III-C) is
unnecessary here: each generator closes over its own state — documented in
DESIGN.md §9.

Hot-loop layout (DESIGN.md §17).  The queue is split by delay class:

  * **same-timestamp FIFO** (``_nq_seq``/``_nq_fn``/``_nq_arg``) —
    events scheduled at the current instant (``dt == 0``: event
    wakeups, spawns, relays — the dominant class in collective-heavy
    runs) append to three parallel flat arrays consumed through a head
    cursor; they never touch the heap.  Parallel arrays instead of
    ``(seq, fn, arg)`` tuples is a *gc* decision, not a style one: an
    int/ref append creates no collector-tracked object, so the FIFO —
    unlike a tuple queue, whose retained entries push the gen-0
    counter over threshold every ~700 events — triggers no collections
    at all, matching the pre-rewrite loop's gc-neutral behavior
    (a tuple-queue variant measured 2x slower on zero-delay-heavy
    runs, with 100% of the difference inside ``gc.collect``).  The
    drained prefix is compacted every 8192 entries to bound memory.
    Wakeups batch per timestamp and are FIFO-stable by construction
    (satellite: the ``Event.set`` re-entrancy hazard).
  * **timed heap** (``_heap``) — future events live in a binary heap
    of ``(t, seq, fn, arg)`` tuples.  (A slot-reuse variant with
    mutable entries and a free list was measured ~40% *slower* than
    tuples — CPython's tuple free list beats manual recycling — so
    reuse is confined to the FIFO, events, and flows, where it wins.)
    ``seq`` is the monotonic insertion number: it tie-breaks equal
    timestamps (comparison never reaches the callables) and is what
    makes the FIFO/heap merge exact.

The merge rule is the old loop's total order, verbatim: dispatch in
``(time, seq)`` order, where FIFO entries carry ``t == now``.  The
rewritten loop is therefore *bit-identical* — same event order, same
finish times, same traces — to the frozen pre-rewrite loop kept in
``_legacy_engine.py``, and tests/test_engine_order.py holds it to that
on randomized programs.
"""
from __future__ import annotations

import heapq
import math
import time
from typing import Any, Callable, Generator, List, Optional

from repro_torch.obs.metrics import NULL_METRICS
from repro_torch.trace.recorder import NULL_RECORDER, TraceRecorder


# engine-telemetry histogram buckets (events/s spans interpreted-loop
# rates; recycle rate is a fraction of events)
_EVENTS_PER_S_BUCKETS = (1e3, 2.5e3, 5e3, 1e4, 2.5e4, 5e4, 1e5, 2e5,
                         3e5, 5e5, 1e6, 2e6, 5e6)
_RECYCLE_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0)


class ProcessError(RuntimeError):
    """An exception escaped a DES process generator.  Carries the
    process identity and engine state at failure time so fault-run
    failures are debuggable (the original exception is ``__cause__``)."""

    def __init__(self, message: str, *, process: str = "", sim_time: float
                 = 0.0, pending_events: int = 0):
        super().__init__(message)
        self.process = process
        self.sim_time = sim_time
        self.pending_events = pending_events


class SimWallDeadline(RuntimeError):
    """The engine's *wall-clock* budget expired mid-run (the serving
    layer's per-request timeout; simulated time is unbounded)."""


class Event:
    # No cached bound method here: Events (and Processes) are *callable*
    # and the FIFO/heap store the object itself as the dispatch target.
    # An earlier variant cached ``self.step = self._step``, which is a
    # reference cycle (event -> bound method -> event) — every
    # non-recycled event became cyclic garbage only gc could free, and
    # zero-delay-heavy runs spent ~40% of wall time in collections.
    __slots__ = ("engine", "_set", "waiters", "payload")

    def __init__(self, engine: "Engine"):
        self.engine = engine
        self._set = False
        self.waiters: List["Process"] = []
        self.payload: Any = None

    def set(self, payload: Any = None):
        if self._set:
            return
        self._set = True
        self.payload = payload
        waiters = self.waiters
        if waiters:
            # zero-delay wakeups go straight onto the same-timestamp
            # FIFO in registration order (seq-numbered so the heap
            # merge stays exact)
            eng = self.engine
            seqs = eng._nq_seq
            fns = eng._nq_fn
            args = eng._nq_arg
            seq = eng._seq
            for proc in waiters:
                seq += 1
                seqs.append(seq)
                fns.append(proc)
                args.append(payload)
            eng._seq = seq
            waiters.clear()

    @property
    def is_set(self) -> bool:
        return self._set

    # an Event can sit directly in another event's waiters list and
    # relay the fire (SimMPI chains flow-completion -> transfer events
    # this way without a per-message adapter object); __call__ makes it
    # a dispatch target for the FIFO/heap without a bound-method alloc
    def _step(self, payload: Any = None):
        self.set(payload)

    __call__ = _step


class Process:
    __slots__ = ("engine", "gen", "done", "_joiners", "name", "killed")

    def __init__(self, engine: "Engine", gen: Generator, name: str = ""):
        self.engine = engine
        self.gen = gen
        self.done = Event(engine)
        self.name = name
        self.killed = False          # fail-stop: stop dead, never join

    def kill(self):
        """Fail-stop this virtual thread: it takes no further steps and
        its ``done`` event never fires, so joiners and rendezvous peers
        block forever — exactly a real fail-stop process."""
        self.killed = True
        self.gen.close()

    def _step(self, send_value: Any = None):
        if self.killed:
            return
        eng = self.engine
        send = self.gen.send
        try:
            while True:
                cmd = send(send_value)
                send_value = None
                # fast path: a bare float wait is the dominant yield
                # (the trace-overhead mapping showed it) — dispatch on exact
                # type before the isinstance ladder
                tc = type(cmd)
                if tc is float:
                    if cmd < 0.0:
                        raise ValueError(f"negative wait {cmd} in {self.name}")
                    # inlined _schedule: one fewer call per wait, the
                    # single hottest line in the simulator
                    seq = eng._seq + 1
                    eng._seq = seq
                    if cmd == 0.0:
                        eng._nq_seq.append(seq)
                        eng._nq_fn.append(self)
                        eng._nq_arg.append(None)
                    else:
                        heapq.heappush(eng._heap,
                                       (eng.now + cmd, seq, self, None))
                    return
                if tc is Event:
                    if cmd._set:
                        send_value = cmd.payload
                        continue
                    cmd.waiters.append(self)
                    return
                # slow ladder, semantics identical to the legacy loop:
                # ints / numpy scalars / bools, Event subclasses, joins,
                # spawn tuples
                if isinstance(cmd, (int, float)):
                    if cmd < 0:
                        raise ValueError(f"negative wait {cmd} in {self.name}")
                    eng._schedule(float(cmd), self, None)
                    return
                if isinstance(cmd, Event):
                    if cmd.is_set:
                        send_value = cmd.payload
                        continue
                    cmd.waiters.append(self)
                    return
                if isinstance(cmd, Process):
                    if cmd.done.is_set:
                        continue
                    cmd.done.waiters.append(self)
                    return
                if isinstance(cmd, tuple) and cmd and cmd[0] == "spawn":
                    eng.spawn(cmd[1])
                    continue
                raise TypeError(f"bad yield {cmd!r} from {self.name}")
        except StopIteration:
            self.done.set()
        except ProcessError:
            raise
        except Exception as exc:
            raise ProcessError(
                f"DES process {self.name or '<unnamed>'} failed at "
                f"t={eng.now:.9g}s ({eng.pending()} pending events): "
                f"{type(exc).__name__}: {exc}",
                process=self.name, sim_time=eng.now,
                pending_events=eng.pending()) from exc

    __call__ = _step


class Engine:
    """Event loop.  Two queues (see module docstring): a FIFO for
    same-timestamp events and an array-backed slot-reuse heap for timed
    ones, merged in exact ``(time, seq)`` order so event ordering (and
    therefore traces and results) is reproducible run-to-run and
    bit-identical to the pre-rewrite loop.  Anything feeding the queues
    must iterate its own state deterministically too (see the ordered
    flow dicts in hardware/network.py).

    ``pooling`` marks this engine as supporting object recycling:
    SimMPI recycles its receive-wait events through ``_recycle_event``
    and Network recycles ``Flow`` objects when it is set (the legacy
    engine sets it False so benchmarks can reproduce pre-rewrite
    allocation behavior).

    ``trace=True`` attaches a ``repro_torch.trace.TraceRecorder``; off, the
    no-op NULL_RECORDER singleton sits there so instrumentation sites
    cost one attribute test and the loop itself is untouched.  The
    recorder never schedules events, so traced and untraced runs of the
    same scenario produce bit-identical simulated times.

    ``faults`` is the engine's fault clock — a
    ``repro_torch.faults.inject.FaultRuntime`` attached by the application
    when a scenario carries a ``FaultSpec``, or the no-op NULL_FAULTS
    singleton.  A runtime drives degradation through ordinary
    ``call_at`` events (its schedule is finite by construction), so an
    unfaulted run schedules nothing extra and stays bit-identical to
    pre-fault builds.

    ``wall_deadline`` (a ``time.monotonic`` timestamp) bounds *wall
    clock*, not simulated time: the serving layer sets it so a DES that
    would blow a request deadline raises ``SimWallDeadline`` instead of
    stalling the wave.  Unset, the hot loop is untouched.
    """

    pooling = True

    def __init__(self, trace: bool = False):
        self.now = 0.0
        self._heap: list = []        # (t, seq, fn, arg) tuples, heap order
        # same-instant FIFO as parallel arrays (gc-neutral; see module
        # docstring), consumed through the shared head cursor
        self._nq_seq: list = []
        self._nq_fn: list = []
        self._nq_arg: list = []
        self._nowq_head = 0
        self._seq = 0
        self._event_pool: list = []
        self.event_count = 0
        self.trace = TraceRecorder(self) if trace else NULL_RECORDER
        from repro_torch.faults.inject import NULL_FAULTS
        self.faults = NULL_FAULTS
        self.wall_deadline: Optional[float] = None
        # metrics sink (repro_torch.obs): NULL_METRICS unless a caller hangs a
        # registry here; run() then takes the metered mirror loop, so
        # the hot loop below never tests the flag per event.  Recycles
        # are counted unconditionally — one int add inside a function
        # call that already happened, invisible next to the event cost.
        self.metrics = NULL_METRICS
        self.recycles = 0
        self._recycles_seen = 0

    def event(self) -> Event:
        pool = self._event_pool
        if pool:
            return pool.pop()
        return Event(self)

    def _recycle_event(self, ev: Event) -> None:
        """Return an event to the pool.  Caller must guarantee no live
        references remain (SimMPI's receive-wait events qualify: they
        never escape the recv generator that made them)."""
        ev._set = False
        ev.payload = None
        # waiters is already empty after set(); a killed waiter path
        # never recycles, so no defensive clear needed — but it's cheap
        ev.waiters.clear()
        self._event_pool.append(ev)
        self.recycles += 1

    def pending(self) -> int:
        """Events scheduled but not yet dispatched (both queues)."""
        return len(self._heap) + len(self._nq_seq) - self._nowq_head

    def queue_depth(self) -> int:
        """Alias for ``pending()`` — the bench's peak-depth probe."""
        return self.pending()

    def _schedule(self, dt: float, fn: Callable, arg: Any):
        seq = self._seq + 1
        self._seq = seq
        if dt == 0.0:
            self._nq_seq.append(seq)
            self._nq_fn.append(fn)
            self._nq_arg.append(arg)
        else:
            heapq.heappush(self._heap, (self.now + dt, seq, fn, arg))

    def call_at(self, t: float, fn: Callable, arg: Any = None):
        seq = self._seq + 1
        self._seq = seq
        if t <= self.now:            # legacy max(t, now) clamp -> FIFO
            self._nq_seq.append(seq)
            self._nq_fn.append(fn)
            self._nq_arg.append(arg)
        else:
            heapq.heappush(self._heap, (t, seq, fn, arg))

    def spawn(self, gen: Generator, name: str = "") -> Process:
        proc = Process(self, gen, name)
        self._schedule(0.0, proc, None)
        return proc

    def set_wall_deadline(self, timeout_s: Optional[float]):
        """Bound the *wall clock* a run may burn: ``run()`` raises
        ``SimWallDeadline`` once ``timeout_s`` real seconds elapse.
        None clears the bound."""
        self.wall_deadline = (None if timeout_s is None
                              else time.monotonic() + timeout_s)

    def run(self, until: float = math.inf) -> float:
        if self.wall_deadline is not None:
            return self._run_deadline(until)
        if self.metrics.enabled:
            return self._run_metered(until)
        heap = self._heap
        seqs = self._nq_seq
        fns = self._nq_fn
        args = self._nq_arg
        pop = heapq.heappop
        head = self._nowq_head
        count = self.event_count
        now = self.now
        try:
            while True:
                if head < len(seqs):
                    # same-timestamp batch: drain FIFO entries at t ==
                    # now, yielding to the heap only when its top is an
                    # older (smaller-seq) event at the same instant
                    if now > until:
                        break
                    if heap:
                        s = heap[0]
                        if s[0] == now and s[1] < seqs[head]:
                            pop(heap)
                            count += 1
                            s[2](s[3])
                            continue
                    fn = fns[head]
                    arg = args[head]
                    head += 1
                    if head >= 8192:
                        # compact the drained prefix so long
                        # same-timestamp cascades don't grow the arrays
                        # (and pin payload refs) without bound
                        del seqs[:head]
                        del fns[:head]
                        del args[:head]
                        head = 0
                    count += 1
                    fn(arg)
                    continue
                if head:
                    seqs.clear()
                    fns.clear()
                    args.clear()
                    head = 0
                if not heap:
                    break
                s = heap[0]
                t = s[0]
                if t > until:
                    break
                pop(heap)
                self.now = now = t
                count += 1
                s[2](s[3])
        finally:
            self.event_count = count
            self._nowq_head = head
        return self.now

    def _run_metered(self, until: float) -> float:
        # metrics-on mirror of run(): same dispatch order (the registry
        # never schedules events, so simulated results stay
        # bit-identical — asserted in tests/test_obs.py), plus a
        # queue-depth high-water probe per dispatched event and a
        # metrics flush on exit.  Kept separate so the metrics-off hot
        # loop above never pays for either.
        heap = self._heap
        seqs = self._nq_seq
        fns = self._nq_fn
        args = self._nq_arg
        pop = heapq.heappop
        head = self._nowq_head
        count = self.event_count
        now = self.now
        ev0 = count
        hw = 0
        t0 = time.perf_counter()
        try:
            while True:
                depth = len(heap) + len(seqs) - head
                if depth > hw:
                    hw = depth
                if head < len(seqs):
                    if now > until:
                        break
                    if heap:
                        s = heap[0]
                        if s[0] == now and s[1] < seqs[head]:
                            pop(heap)
                            count += 1
                            s[2](s[3])
                            continue
                    fn = fns[head]
                    arg = args[head]
                    head += 1
                    if head >= 8192:
                        del seqs[:head]   # see run(): bound retention
                        del fns[:head]
                        del args[:head]
                        head = 0
                    count += 1
                    fn(arg)
                    continue
                if head:
                    seqs.clear()
                    fns.clear()
                    args.clear()
                    head = 0
                if not heap:
                    break
                s = heap[0]
                t = s[0]
                if t > until:
                    break
                pop(heap)
                self.now = now = t
                count += 1
                s[2](s[3])
        finally:
            self.event_count = count
            self._nowq_head = head
            self._flush_metrics(ev0, t0, high_water=hw)
        return self.now

    def _flush_metrics(self, ev0: int, t0: float,
                       high_water: Optional[int] = None) -> None:
        """Record one run()'s engine telemetry into ``self.metrics``
        (events, events/s distribution, queue-depth high-water via the
        ``queue_depth()`` probe, pool recycle rate)."""
        m = self.metrics
        ev = self.event_count - ev0
        dt = time.perf_counter() - t0
        m.counter("engine.runs").inc()
        m.counter("engine.events").inc(ev)
        rec = self.recycles - self._recycles_seen
        self._recycles_seen = self.recycles
        m.counter("engine.event_recycles").inc(rec)
        m.gauge("engine.event_pool").set(len(self._event_pool))
        if high_water is not None:
            m.gauge("engine.queue_depth_peak").set(high_water)
        if ev and dt > 0.0:
            m.histogram("engine.events_per_s",
                        buckets=_EVENTS_PER_S_BUCKETS).observe(ev / dt)
            m.histogram("engine.run_wall_s").observe(dt)
            m.histogram("engine.recycle_rate",
                        buckets=_RECYCLE_BUCKETS).observe(rec / ev)

    def _run_deadline(self, until: float) -> float:
        # separate loop so the unbudgeted hot path above stays
        # untouched; the clock syscall is amortized over 1024-event
        # slices.  Dispatch logic mirrors run() exactly (equivalence is
        # asserted under deadline in tests/test_engine_order.py).  With
        # a metrics registry attached, flush engine telemetry on the
        # way out (including the SimWallDeadline path).
        if self.metrics.enabled:
            ev0, t0 = self.event_count, time.perf_counter()
            try:
                return self._run_deadline_loop(until)
            finally:
                self._flush_metrics(ev0, t0)
        return self._run_deadline_loop(until)

    def _run_deadline_loop(self, until: float) -> float:
        heap = self._heap
        seqs = self._nq_seq
        fns = self._nq_fn
        args = self._nq_arg
        pop = heapq.heappop
        deadline = self.wall_deadline
        while True:
            if time.monotonic() > deadline:
                raise SimWallDeadline(
                    f"wall-clock budget expired at sim t={self.now:.9g}s "
                    f"({self.event_count} events, {self.pending()} pending)")
            head = self._nowq_head
            count = self.event_count
            budget = 1024
            try:
                while budget:
                    budget -= 1
                    if head < len(seqs):
                        if self.now > until:
                            return self.now
                        if heap:
                            s = heap[0]
                            if s[0] == self.now and s[1] < seqs[head]:
                                pop(heap)
                                count += 1
                                s[2](s[3])
                                continue
                        fn = fns[head]
                        arg = args[head]
                        head += 1
                        if head >= 8192:
                            del seqs[:head]   # see run(): bound retention
                            del fns[:head]
                            del args[:head]
                            head = 0
                        count += 1
                        fn(arg)
                        continue
                    if head:
                        seqs.clear()
                        fns.clear()
                        args.clear()
                        head = 0
                    if not heap:
                        return self.now
                    s = heap[0]
                    t = s[0]
                    if t > until:
                        return self.now
                    pop(heap)
                    self.now = t
                    count += 1
                    s[2](s[3])
            finally:
                self.event_count = count
                self._nowq_head = head

    def run_all(self) -> float:
        return self.run(math.inf)
