"""FaultRuntime — DES-side injection of a ``FaultSpec``.

The runtime hangs off ``Engine`` (``engine.faults``), mirroring the
trace recorder's NULL-object pattern: unfaulted engines carry the
module-level ``NULL_FAULTS`` singleton whose hooks are identity
functions behind ``enabled=False``, so every injection site reduces to
one attribute test and an unfaulted run schedules zero extra events —
bit-identical to pre-fault builds.

Injection points (see DESIGN.md §16):

  * compute  — ``SimBLAS``/layer compute yields are multiplied by
    ``compute_scale(rank)`` (straggler faults; multiplicative, so
    overlapping stragglers compose).
  * network  — selected links get ``Network.set_capacity`` calls at
    activation/deactivation times (degrade and flap; capacity scaling
    is multiplicative too, so restore divides).
  * MPI      — ``SimMPI.isend`` software overhead is multiplied by
    ``latency_factor(src)``, a deterministic per-message draw from
    ``1 ± sigma`` (no RNG in sim time: a counter hash seeded by the
    spec's seed).
  * liveness — fail-stop kills the registered ``Process`` of each
    target rank; peers block at their next rendezvous with it, exactly
    like a real fail-stop process (the run ends when the heap drains,
    and apps report a failed/partial result).

Every activation/deactivation is an ordinary ``engine.call_at`` event
scheduled up-front from the spec (link flaps carry a finite cycle
count), so the event heap always drains and a seeded spec replays
bit-identically run-to-run.  With tracing on, activations emit instant
markers and each active window becomes a ``cat="fault"`` span on the
dedicated ``FAULT_TRACK`` timeline (rank -1, rendered as a "faults"
thread in the Chrome export, excluded from breakdowns/critical path).
"""
from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.faults.spec import Fault, FaultSpec

FAULT_TRACK = -1          # trace rank id of the fault timeline


class _NullFaults:
    """Faults-off singleton: identity hooks behind ``enabled``."""
    enabled = False
    __slots__ = ()

    def compute_scale(self, rank: int) -> float:
        return 1.0

    def latency_factor(self, rank: int) -> float:
        return 1.0

    def alive(self, rank: int) -> bool:
        return True

    def register_rank(self, rank: int, proc) -> None:
        pass

    def finalize(self) -> None:
        pass


NULL_FAULTS = _NullFaults()


class FaultRuntime:
    """Installs a ``FaultSpec`` into a live engine/network pair.

    Construct *after* the engine and network exist and *before*
    spawning rank processes; the constructor attaches itself as
    ``engine.faults`` and schedules the whole (finite) fault timetable.
    Apps then ``register_rank(r, proc)`` each spawned process (so
    fail-stop can kill it) and call ``finalize()`` after ``run_all``
    (closes still-open fault spans in the trace).
    """
    enabled = True

    def __init__(self, spec: FaultSpec, engine, network=None,
                 n_ranks: int = 0,
                 rank_to_node: Optional[Callable[[int], int]] = None):
        if network is None and any(
                f.kind in ("link_degrade", "link_flap")
                for f in spec.faults):
            raise ValueError("link faults need a network")
        self.spec = spec
        self.engine = engine
        self.net = network
        self.n_ranks = n_ranks
        self.rank_to_node = rank_to_node or (lambda r: r)
        self._compute: Dict[int, float] = {}      # rank -> multiplier
        self._jitter: List[float] = []            # active sigmas
        self._msg_counter = 0
        self._dead: set = set()
        self._procs: Dict[int, Any] = {}
        # (fault idx, cycle) -> activation time, for trace spans
        self._open: Dict[Tuple[int, int], float] = {}
        self._links: Dict[int, List] = {}         # fault idx -> [Link]
        engine.faults = self
        self._install()

    # ------------------------------------------------------------ install
    def _install(self):
        eng = self.engine
        for i, f in enumerate(self.spec.faults):
            if f.kind in ("link_degrade", "link_flap"):
                self._links[i] = self._resolve_links(f, i)
            if f.kind == "link_flap":
                for c in range(f.cycles):
                    t_on = f.start + c * f.period
                    eng.call_at(t_on, self._activate, (i, c))
                    eng.call_at(t_on + f.duty * f.period,
                                self._deactivate, (i, c))
            else:
                eng.call_at(f.start, self._activate, (i, 0))
                end = f.end
                if end != float("inf"):
                    eng.call_at(end, self._deactivate, (i, 0))

    def _resolve_links(self, f: Fault, i: int) -> List:
        topo = self.net.topo
        if f.node >= 0:
            return list(topo.node_links(f.node))
        links = topo.iter_links()
        k = min(max(1, round(f.link_frac * len(links))), len(links))
        # seeded per-fault sample over the deterministic structural
        # order — same spec, same links, run-to-run
        rnd = random.Random((self.spec.seed << 16)
                            ^ ((i * 2654435761) & 0xffffffff))
        return rnd.sample(links, k)

    def _fault_ranks(self, f: Fault) -> List[int]:
        if f.rank >= 0:
            return [f.rank]
        return [r for r in range(self.n_ranks)
                if self.rank_to_node(r) == f.node]

    # -------------------------------------------------- timetable events
    def _activate(self, arg: Tuple[int, int]):
        i, cycle = arg
        f = self.spec.faults[i]
        if f.kind == "straggler":
            self._compute[f.rank] = \
                self._compute.get(f.rank, 1.0) * f.factor
        elif f.kind == "fail_stop":
            for r in self._fault_ranks(f):
                self._dead.add(r)
                proc = self._procs.get(r)
                if proc is not None:
                    proc.kill()
        elif f.kind in ("link_degrade", "link_flap"):
            for l in self._links[i]:
                self.net.set_capacity(l, l.capacity * f.factor)
        elif f.kind == "latency_jitter":
            self._jitter.append(f.sigma)
        tr = self.engine.trace
        if tr.enabled:
            tr.instant(FAULT_TRACK, f"fault_on:{f.kind}",
                       args=self._span_args(f, i))
        self._open[(i, cycle)] = self.engine.now

    def _deactivate(self, arg: Tuple[int, int]):
        i, cycle = arg
        f = self.spec.faults[i]
        if f.kind == "straggler":
            self._compute[f.rank] = \
                self._compute.get(f.rank, 1.0) / f.factor
        elif f.kind in ("link_degrade", "link_flap"):
            for l in self._links[i]:
                self.net.set_capacity(l, l.capacity / f.factor)
        elif f.kind == "latency_jitter":
            self._jitter.remove(f.sigma)
        self._close_span(i, cycle)

    def _span_args(self, f: Fault, i: int) -> Dict[str, Any]:
        args: Dict[str, Any] = {"kind": f.kind, "fault": i}
        if f.rank >= 0:
            args["rank"] = f.rank
        if f.node >= 0:
            args["node"] = f.node
        if f.kind != "fail_stop":
            args["factor"] = f.factor if f.kind != "latency_jitter" \
                else f.sigma
        if i in self._links:
            args["links"] = len(self._links[i])
        return args

    def _close_span(self, i: int, cycle: int):
        t0 = self._open.pop((i, cycle), None)
        tr = self.engine.trace
        if t0 is not None and tr.enabled:
            f = self.spec.faults[i]
            tr.complete(FAULT_TRACK, "fault", f.kind, t0,
                        args=self._span_args(f, i))

    # ------------------------------------------------------- query hooks
    def compute_scale(self, rank: int) -> float:
        return self._compute.get(rank, 1.0)

    def latency_factor(self, rank: int) -> float:
        if not self._jitter:
            return 1.0
        scale = 1.0
        for sigma in self._jitter:
            self._msg_counter += 1
            h = (self._msg_counter * 2654435761 + rank * 97
                 + self.spec.seed * 40503) & 0xffffffff
            scale *= 1.0 + sigma * (h / 0xffffffff * 2.0 - 1.0)
        return scale

    def alive(self, rank: int) -> bool:
        return rank not in self._dead

    @property
    def dead_ranks(self) -> List[int]:
        return sorted(self._dead)

    # ----------------------------------------------------- app lifecycle
    def register_rank(self, rank: int, proc) -> None:
        self._procs[rank] = proc
        if rank in self._dead:       # fail-stopped before registration
            proc.kill()

    def finalize(self) -> None:
        """Close still-open fault spans (open-ended faults) at run end."""
        for (i, cycle) in sorted(self._open):
            self._close_span(i, cycle)


def install_faults(faults, engine, network=None, n_ranks: int = 0,
                   rank_to_node=None):
    """Normalize a ``faults=`` argument and attach a runtime to the
    engine; returns ``engine.faults`` (NULL_FAULTS when empty/None)."""
    from repro_torch.faults.spec import as_fault_spec
    spec = as_fault_spec(faults)
    if spec is not None:
        FaultRuntime(spec, engine, network=network, n_ranks=n_ranks,
                     rank_to_node=rank_to_node)
    return engine.faults
