"""HPL application model (paper §III-C) on the discrete-event simulator.

Right-looking LU with block size ``nb`` on a P x Q block-cyclic process
grid.  Per panel k:

  1. panel factorization (owning process column): per column j of the
     panel — idamax + pivot allreduce over the P column ranks + dscal +
     dger over the local rows; pivot exchange is aggregated into one
     column-group sync + analytic per-column latency (the paper models
     collectives with algorithm models, not per-packet events).
  2. panel broadcast along each process row (HPL '1ring' store-and-forward
     by default, 'long' = scatter+allgather variant available).
  3. trailing row swaps among the P column ranks (HPL_dlaswp*: modeled as
     log2(P) exchange rounds of the U strip — bandwidth-bound Level-1 ops
     per the paper).
  4. trailing update: dtrsm + dgemm on the local tile.

Matrix data is never allocated (paper: "the content of A is irrelevant
for the simulation") — only numroc-style shape arithmetic flows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core.engine import Engine
from repro_torch.core.hardware.network import Network
from repro_torch.core.hardware.node import NodeModel
from repro_torch.core.simblas import SimBLAS
from repro_torch.core.simmpi import SimMPI


def numroc(n: int, nb: int, iproc: int, nprocs: int) -> int:
    """ScaLAPACK NUMROC: local rows/cols of an n-length dim distributed in
    nb blocks over nprocs, for process iproc (src proc 0)."""
    nblocks = n // nb
    base = (nblocks // nprocs) * nb
    extra = nblocks % nprocs
    if iproc < extra:
        base += nb
    elif iproc == extra:
        base += n % nb
    return base


@dataclasses.dataclass
class HPLConfig:
    N: int
    nb: int
    P: int
    Q: int
    bcast: str = "1ring"          # 1ring | long
    lookahead: int = 0            # modeled depth (0: panel on critical path)

    def __post_init__(self):
        if self.N < 1 or self.nb < 1:
            raise ValueError(f"HPLConfig: N={self.N}, nb={self.nb} must be "
                             ">= 1")
        if self.P < 1 or self.Q < 1:
            raise ValueError(f"HPLConfig: P={self.P}, Q={self.Q} must be "
                             ">= 1")
        if self.bcast not in ("1ring", "long"):
            raise ValueError(f"HPLConfig: bcast={self.bcast!r} not in "
                             "('1ring', 'long')")
        if self.lookahead not in (0, 1):
            raise ValueError(f"HPLConfig: lookahead={self.lookahead} must "
                             "be 0 or 1")
        # N % nb != 0 is legal: the trailing partial panel is modeled
        # (ceil(N/nb) panels, last one N % nb wide) — see n_panels.

    @property
    def n_ranks(self) -> int:
        return self.P * self.Q

    @property
    def n_panels(self) -> int:
        """ceil(N / nb): a trailing N % nb panel is simulated, not
        silently dropped."""
        return (self.N + self.nb - 1) // self.nb

    def flops(self) -> float:
        return (2.0 / 3.0) * self.N ** 3 + 1.5 * self.N ** 2


@dataclasses.dataclass
class HPLResult:
    time_s: float
    gflops: float
    events: int
    comm_time_est: float = 0.0
    trace: Optional[object] = None   # TraceRecorder when run with trace=True
    failed: bool = False             # a fault stopped ranks from finishing
    n_finished: int = -1             # ranks that completed (-1: all)
    # representative-region runs (repro_torch.scale): only ``region_panels``
    # panels were simulated exactly; the rest are extrapolated
    region_approx: bool = False
    region_panels: int = 0


class HPLRank:
    """One MPI rank = one virtual thread."""

    def __init__(self, sim: "HPLSim", rank: int):
        self.sim = sim
        self.rank = rank
        self.p = rank % sim.cfg.P          # row coordinate (column-major grid)
        self.q = rank // sim.cfg.P

    def run(self):
        sim = self.sim
        cfg = sim.cfg
        mpi = sim.mpi
        eng = sim.engine
        tr = eng.trace
        fa = eng.faults
        tren = tr.enabled          # static for the whole run
        faen = fa.enabled
        blas = sim.blas[self.rank]
        P, Q, nb, N = cfg.P, cfg.Q, cfg.nb, cfg.N
        col_group = [self.q * P + pp for pp in range(P)]
        row_group = [qq * P + self.p for qq in range(Q)]
        n_panels = cfg.n_panels            # ceil: trailing partial panel
        if sim.max_panels is not None:     # region truncation (scale/)
            n_panels = min(n_panels, sim.max_panels)
        marks = sim.panel_marks

        for k in range(n_panels):
            rem = N - k * nb
            w = min(nb, rem)                # panel width (< nb on the last)
            qk = k % Q                      # owning process column
            pk = k % P                      # row owning the diagonal block
            mloc = numroc(rem, nb, (self.p - pk) % P, P)
            nloc = numroc(max(rem - w, 0), nb, (self.q - (k + 1) % Q) % Q, Q)
            panel_bytes = 8.0 * (mloc + w) * w

            if self.q == qk:
                # --- 1. panel factorization --------------------------------
                ph0 = eng.now
                t = blas.panel_fact(mloc, w)
                if faen:
                    t *= fa.compute_scale(self.rank)
                if tren:
                    tr.compute(self.rank, "panel_blas", t,
                               args={"panel": k, "w": w})
                yield t
                # pivot search allreduces: one aggregated column sync +
                # w analytic small allreduces (latency-bound)
                yield from mpi.barrier(self.rank, col_group, ("pf", k, self.q))
                ar_lat = 2 * math.ceil(math.log2(max(P, 2))) \
                    * (sim.net.topo.base_latency + mpi.overhead)
                if tren:
                    tr.complete(self.rank, "comm", "pivot_allreduce",
                                eng.now, t1=eng.now + w * ar_lat,
                                args={"panel": k})
                yield w * ar_lat
                if tren:
                    tr.complete(self.rank, "phase", "panel_fact", ph0,
                                args={"panel": k})
                # --- 2. broadcast along my row -----------------------------
                if Q > 1:
                    ph0 = eng.now
                    yield from self._bcast_panel(row_group, qk, panel_bytes, k)
                    if tren:
                        tr.complete(self.rank, "phase", "panel_bcast", ph0,
                                    args={"panel": k})
            else:
                if Q > 1:
                    ph0 = eng.now
                    yield from self._bcast_panel(row_group, qk, panel_bytes, k)
                    if tren:
                        tr.complete(self.rank, "phase", "panel_bcast", ph0,
                                    args={"panel": k})

            # --- 3. trailing row swaps (U strip) among column ranks --------
            u_bytes = 8.0 * w * max(nloc, 0)
            if P > 1 and u_bytes > 0:
                ph0 = eng.now
                rounds = math.ceil(math.log2(P))
                peer_up = col_group[(self.p + 1) % P]
                peer_dn = col_group[(self.p - 1) % P]
                for r in range(rounds):
                    ev = mpi.isend(self.rank, peer_up,
                                   u_bytes / max(rounds, 1),
                                   tag=("swap", k, r))
                    yield from mpi.recv(peer_dn, self.rank,
                                        tag=("swap", k, r))
                    yield ev
                t = blas.dlaswp(w, max(nloc, 1))
                if faen:
                    t *= fa.compute_scale(self.rank)
                if tren:
                    tr.compute(self.rank, "dlaswp", t, args={"panel": k})
                yield t
                if tren:
                    tr.complete(self.rank, "phase", "row_swap", ph0,
                                args={"panel": k})

            # --- 4. trailing update ---------------------------------------
            if nloc > 0:
                ph0 = eng.now
                t = blas.dtrsm(w, nloc)
                if faen:
                    t *= fa.compute_scale(self.rank)
                if tren:
                    tr.compute(self.rank, "dtrsm", t, args={"panel": k})
                yield t
                if mloc > 0:
                    t = blas.dgemm(mloc, nloc, w)
                    if faen:
                        t *= fa.compute_scale(self.rank)
                    if tren:
                        tr.compute(self.rank, "dgemm", t,
                                   args={"panel": k, "m": mloc, "n": nloc})
                    yield t
                if tren:
                    tr.complete(self.rank, "phase", "trailing_update", ph0,
                                args={"panel": k})

            if marks is not None:
                # per-panel boundary time on this rank; the region layer
                # fits its closed forms to the max over ranks (no events
                # scheduled — ordering is untouched)
                prev = marks.get(k, 0.0)
                if eng.now > prev:
                    marks[k] = eng.now

        sim.finish_times[self.rank] = sim.engine.now

    def _bcast_panel(self, row_group, root_q, nbytes, k):
        sim = self.sim
        cfg = sim.cfg
        mpi = sim.mpi
        Q = cfg.Q
        root_rank = row_group[root_q]
        if cfg.bcast == "long":
            yield from mpi.bcast(self.rank, root_rank, row_group, nbytes,
                                 op_id=("bc", k, self.p))
            return
        # HPL 1ring: store-and-forward pipeline around the row ring
        my_i = (self.q - root_q) % Q
        if my_i > 0:
            prev_rank = row_group[(self.q - 1) % Q]
            yield from mpi.recv(prev_rank, self.rank, tag=("bc1r", k))
        if my_i < Q - 1:
            nxt = row_group[(self.q + 1) % Q]
            ev = mpi.isend(self.rank, nxt, nbytes, tag=("bc1r", k))
            if cfg.lookahead == 0:
                yield ev


class HPLSim:
    """Full-DES HPL run.

    ``HPLSim(cfg, platform)`` builds the hardware pair from a
    ``repro_torch.platforms.Platform`` spec (node model, topology, ranks per
    node, and MPI-stack knobs all come from the spec); the explicit
    ``HPLSim(cfg, node, topology)`` form stays for ad-hoc hardware, and
    ``HPLSim(cfg, platform.des(trace=True))`` accepts a prebuilt stack.

    ``trace=True`` attaches a ``repro_torch.trace.TraceRecorder``: per-rank
    phase/compute/comm timelines, Chrome-trace export
    (``result.trace.to_chrome_json(path)``) and critical-path analysis
    (``result.trace.summary()``) at zero cost — and zero perturbation —
    when off.
    """

    def __init__(self, cfg: HPLConfig, node, topology=None,
                 ranks_per_node: Optional[int] = None,
                 mpi_overhead: Optional[float] = None,
                 trace: Optional[bool] = None,
                 faults=None,
                 max_panels: Optional[int] = None,
                 panel_marks: Optional[Dict[int, float]] = None):
        if topology is None and hasattr(node, "des"):   # a Platform spec
            platform = node
            stack = platform.des()
            node, topology = stack.node, stack.topology
            if ranks_per_node is None:
                ranks_per_node = stack.ranks_per_node
            if mpi_overhead is None:
                mpi_overhead = stack.mpi_overhead
            if trace is None:
                trace = stack.trace
            capacity = platform.scale.n_ranks
            if cfg.n_ranks > capacity:
                raise ValueError(
                    f"config needs {cfg.n_ranks} ranks but platform "
                    f"{platform.name!r} has {capacity}")
        elif topology is None and hasattr(node, "topology"):  # a DESStack
            stack = node
            node, topology = stack.node, stack.topology
            if ranks_per_node is None:
                ranks_per_node = stack.ranks_per_node
            if mpi_overhead is None:
                mpi_overhead = stack.mpi_overhead
            if trace is None:
                trace = stack.trace
        elif topology is None:
            raise TypeError("HPLSim needs a Platform, a DESStack, or "
                            "(node, topology)")
        ranks_per_node = 1 if ranks_per_node is None else ranks_per_node
        mpi_overhead = 5e-7 if mpi_overhead is None else mpi_overhead
        self.cfg = cfg
        self.node = node
        self.engine = Engine(trace=bool(trace))
        self.net = Network(self.engine, topology)
        self.mpi = SimMPI(self.engine, self.net, cfg.n_ranks,
                          rank_to_node=lambda r: r // ranks_per_node,
                          overhead=mpi_overhead)
        # per-rank BLAS: a rank uses its share of the node
        share = dataclasses.replace(
            node, peak_flops=node.peak_flops / ranks_per_node,
            mem_bw=node.mem_bw / ranks_per_node,
            cores=max(node.cores // ranks_per_node, 1))
        # every rank gets the same node share, and SimBLAS is a pure
        # function of shapes — one instance serves all ranks and its
        # panel_fact memo is shared across the whole grid (per-rank
        # instances under the legacy bench engine, as pre-rewrite)
        if self.engine.pooling:
            shared_blas = SimBLAS(share)
            self.blas = [shared_blas] * cfg.n_ranks
        else:
            self.blas = [SimBLAS(share) for _ in range(cfg.n_ranks)]
        self.finish_times: Dict[int, float] = {}
        # region-simulation hooks (repro_torch/scale/): truncate the run
        # after max_panels panels and/or record per-panel boundary times
        self.max_panels = max_panels
        self.panel_marks = panel_marks
        if faults is not None:
            from repro_torch.faults.inject import install_faults
            install_faults(faults, self.engine, network=self.net,
                           n_ranks=cfg.n_ranks,
                           rank_to_node=self.mpi.rank_to_node)

    @property
    def trace(self):
        """The engine's TraceRecorder (NULL_RECORDER when tracing off)."""
        return self.engine.trace

    def run(self) -> HPLResult:
        fa = self.engine.faults
        for r in range(self.cfg.n_ranks):
            proc = self.engine.spawn(HPLRank(self, r).run(),
                                     name=f"rank{r}")
            if fa.enabled:
                fa.register_rank(r, proc)
        self.engine.run_all()
        fa.finalize()
        trace = self.engine.trace if self.engine.trace.enabled else None
        n_done = len(self.finish_times)
        if n_done < self.cfg.n_ranks:
            # a fail-stop stranded the survivors at a rendezvous: the
            # heap drained without every rank finishing
            return HPLResult(time_s=self.engine.now, gflops=0.0,
                             events=self.engine.event_count, trace=trace,
                             failed=True, n_finished=n_done)
        t = max(self.finish_times.values())
        return HPLResult(time_s=t, gflops=self.cfg.flops() / t / 1e9,
                         events=self.engine.event_count, trace=trace)
