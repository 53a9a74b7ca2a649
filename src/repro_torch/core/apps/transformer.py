"""Transformer train/serve step as a DES application on the TPU torus.

This is the hardware-adaptation analogue of apps/hpl.py: instead of HPL's
panel/bcast/update flow over MPI on a fat-tree, the application is a
scan-over-layers train (or decode) step whose per-layer compute and
collective schedule comes from the compiled dry-run record.

What the DES adds over the analytic SimXLA model (both are paper-style
"library models"):
  * contention on shared links — cross-pod DCN traffic, multi-axis
    collectives sharing ring links;
  * straggler injection (slow chip / slow link) for the fault-tolerance
    what-if studies (ft/straggler.py consumes these results);
  * jitter — per-rank compute-time perturbation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.engine import Engine
from repro_torch.core.hardware.network import Network
from repro_torch.core.hardware.node import NodeModel, TPU_V5E
from repro_torch.core.hardware.topology import Torus, MultiPod
from repro_torch.core.simmpi import SimMPI
from repro_torch.core.simxla import ICIParams, default_ici, ici_from_platform


@dataclasses.dataclass
class LayerWork:
    compute_s: float
    # (op, wire_bytes, axis): axis 'model' | 'data' | 'pod'
    collectives: List[Tuple[str, float, str]]


@dataclasses.dataclass
class StepWorkload:
    """Per-device, per-layer workload; see from_dryrun_record."""
    layers: List[LayerWork]
    tail_collectives: List[Tuple[str, float, str]]   # e.g. grad all-reduce
    tail_compute_s: float = 0.0

    @staticmethod
    def from_dryrun_record(record: Dict, num_layers: int,
                           chip: NodeModel = TPU_V5E) -> "StepWorkload":
        r = record["roofline"]
        chips = record["chips"]
        flops = r["hlo_flops_total"] / chips
        nbytes = r["hlo_bytes_total"] / chips
        compute = max(flops / (chip.peak_flops * chip.gemm_efficiency),
                      nbytes / 3.0 / (chip.mem_bw * chip.mem_efficiency))
        per_layer = compute / max(num_layers, 1)
        colls = record.get("collectives", {})
        layer_colls: List[Tuple[str, float, str]] = []
        tail: List[Tuple[str, float, str]] = []
        for op, agg in colls.items():
            wire = agg["wire_bytes"]
            if op == "all-reduce" and record.get("kind") == "train":
                # gradient reduction: half at tail over 'data' (+pod), rest
                # per-layer over 'model'
                tail.append((op, wire * 0.5, "data"))
                layer_colls.append((op, wire * 0.5 / num_layers, "model"))
            else:
                layer_colls.append((op, wire / num_layers, "model"))
        return StepWorkload(
            layers=[LayerWork(per_layer, list(layer_colls))
                    for _ in range(num_layers)],
            tail_collectives=tail)


class TransformerStepSim:
    def __init__(self, workload: StepWorkload, *,
                 mesh: Tuple[int, int] = (16, 16), pods: int = 1,
                 chip: Optional[NodeModel] = None,
                 ici: Optional[ICIParams] = None,
                 mpi_overhead: float = 5e-7,
                 straggler: Optional[Tuple[int, float]] = None,
                 jitter: float = 0.0, seed: int = 0,
                 trace: bool = False, faults=None,
                 layer_marks: Optional[Dict[int, float]] = None):
        self.workload = workload
        self.mesh = mesh
        self.pods = pods
        self.chip = chip if chip is not None else TPU_V5E
        ici = ici or default_ici()
        self.n_per_pod = mesh[0] * mesh[1]
        self.n = self.n_per_pod * pods
        self.engine = Engine(trace=trace)
        if pods == 1:
            topo = Torus(mesh, link_bw=ici.link_bw,
                         hop_latency=ici.hop_latency,
                         base_latency=ici.base_latency)
        else:
            topo = MultiPod([Torus(mesh, link_bw=ici.link_bw,
                                   hop_latency=ici.hop_latency,
                                   base_latency=ici.base_latency)
                             for _ in range(pods)],
                            self.n_per_pod, dcn_bw_per_node=ici.dcn_bw,
                            dcn_latency=ici.dcn_latency)
        self.net = Network(self.engine, topo)
        self.mpi = SimMPI(self.engine, self.net, self.n,
                          overhead=mpi_overhead)
        self.straggler = straggler
        self.jitter = jitter
        self.seed = seed
        self.finish: Dict[int, float] = {}
        # region-simulation hook (slice 6 of the port): record per-layer
        # boundary times (max over ranks; no events scheduled)
        self.layer_marks = layer_marks
        if faults is not None:
            from repro_torch.faults.inject import install_faults
            install_faults(faults, self.engine, network=self.net,
                           n_ranks=self.n)

    @classmethod
    def from_platform(cls, workload: StepWorkload, platform, *,
                      mesh: Optional[Tuple[int, int]] = None,
                      pods: Optional[int] = None,
                      **kw) -> "TransformerStepSim":
        """Build the DES from a ``repro_torch.platforms.Platform`` spec: chip,
        ICI, and MPI-stack knobs all come from the spec; the (rows, cols)
        mesh defaults to the platform's torus dims (a k-D torus collapses
        to ``(prod(dims[:-1]), dims[-1])``) and ``pods`` to the fabric's
        pod count."""
        fab = platform.fabric
        if fab.kind not in ("torus", "multipod"):
            raise ValueError(
                f"platform {platform.name!r} has a {fab.kind!r} fabric; "
                "the transformer step DES needs torus or multipod")
        if mesh is None:
            mesh = (math.prod(fab.dims[:-1]), fab.dims[-1])
        if pods is None:
            pods = fab.n_pods if fab.kind == "multipod" else 1
        kw.setdefault("chip", platform.node_model())
        kw.setdefault("ici", ici_from_platform(platform))
        kw.setdefault("mpi_overhead", platform.mpi.overhead)
        return cls(workload, mesh=tuple(mesh), pods=pods, **kw)

    # mesh coordinate helpers (rank = pod*n_per_pod + row*cols + col)
    def _groups(self, rank: int) -> Dict[str, List[int]]:
        rows, cols = self.mesh
        pod = rank // self.n_per_pod
        local = rank % self.n_per_pod
        r, c = divmod(local, cols)
        base = pod * self.n_per_pod
        return {
            "model": [base + r * cols + cc for cc in range(cols)],
            "data": [base + rr * cols + c for rr in range(rows)],
            "pod": [p * self.n_per_pod + local for p in range(self.pods)],
        }

    def _compute_scale(self, rank: int) -> float:
        s = 1.0
        if self.straggler and rank == self.straggler[0]:
            s *= self.straggler[1]
        if self.jitter:
            # deterministic per-rank jitter (no RNG in sim time)
            h = (rank * 2654435761 + self.seed) & 0xffffffff
            s *= 1.0 + self.jitter * ((h / 0xffffffff) - 0.5) * 2.0
        return s

    def _rank_proc(self, rank: int):
        tr = self.engine.trace
        fa = self.engine.faults
        tren = tr.enabled
        faen = fa.enabled
        groups = self._groups(rank)
        # per-axis ring geometry computed once per rank, not per
        # collective call: (group, me, nxt, prv, prv_ring_index)
        rings = {}
        for axis, grp in groups.items():
            n = len(grp)
            me = grp.index(rank)
            rings[axis] = (grp, me, grp[(me + 1) % n], grp[(me - 1) % n],
                           (me - 1) % n)
        base_scale = self._compute_scale(rank)
        marks = self.layer_marks
        for li, layer in enumerate(self.workload.layers):
            ph0 = self.engine.now
            # fault scale is re-read per layer: stragglers can activate
            # and clear mid-step
            scale = base_scale * fa.compute_scale(rank) \
                if faen else base_scale
            if tren:
                tr.compute(rank, "layer_compute", layer.compute_s * scale,
                           args={"layer": li})
            yield layer.compute_s * scale
            for ci, (op, wire, axis) in enumerate(layer.collectives):
                if len(groups[axis]) <= 1:
                    continue
                yield from self._collective(rank, op, wire, rings[axis],
                                            op_id=("l", li, ci, axis))
            if tren:
                tr.complete(rank, "phase", f"layer{li}", ph0,
                            args={"layer": li})
            if marks is not None:
                # per-layer boundary on this rank; the region layer
                # replicates the steady-state delta of the max-over-ranks
                # boundary times (ordering untouched: no events scheduled)
                prev = marks.get(li, 0.0)
                if self.engine.now > prev:
                    marks[li] = self.engine.now
        ph0 = self.engine.now
        if self.workload.tail_compute_s:
            scale = base_scale * fa.compute_scale(rank) \
                if faen else base_scale
            if tren:
                tr.compute(rank, "tail_compute",
                           self.workload.tail_compute_s * scale)
            yield self.workload.tail_compute_s * scale
        for ci, (op, wire, axis) in enumerate(self.workload.tail_collectives):
            grp = groups[axis]
            if len(grp) > 1:
                yield from self._collective(rank, op, wire, rings[axis],
                                            op_id=("t", ci, axis))
            if axis == "data" and self.pods > 1:
                yield from self._collective(rank, op, wire / len(grp),
                                            rings["pod"], op_id=("tp", ci))
        if tren and self.engine.now > ph0:
            tr.complete(rank, "phase", "tail", ph0)
        self.finish[rank] = self.engine.now

    def _collective(self, rank, op, wire_bytes, ring, op_id):
        """Ring collectives as real flows; wire_bytes already follows the
        hlo_parse ring convention (bytes through one device).  ``ring``
        is the precomputed (group, me, nxt, prv, prv_index) tuple from
        _rank_proc — ring geometry is a pure function of (rank, axis)."""
        mpi = self.mpi
        tr = self.engine.trace
        group, me, nxt, prv, prv_i = ring
        tok = tr.coll_begin(rank, op, op_id, group, wire_bytes) \
            if tr.enabled else None
        n = len(group)
        if op == "all-reduce":
            rounds = 2 * (n - 1)
        elif op == "collective-permute":
            rounds = 1
        else:       # all-gather / reduce-scatter / all-to-all / default
            rounds = n - 1
        per_round = wire_bytes / max(rounds, 1)
        isend = mpi.isend
        eng = mpi.engine
        if tok is None and eng.pooling:
            # hot path: the blocking-recv body inlined (identical yield
            # sequence to mpi.recv, minus one generator frame per round;
            # traced and legacy runs keep the generator so span capture
            # and the pre-PR cost model stay exact)
            posted = mpi._posted
            recv_wait = mpi._recv_wait
            recycle = eng._recycle_event
            for k in range(rounds):
                ev = isend(rank, nxt, per_round, tag=(op_id, k, me))
                key = (prv, rank, (op_id, k, prv_i))
                box = posted.get(key)
                if box:
                    transfer, eager = box.pop(0)
                else:
                    w = eng.event()
                    wl = recv_wait.get(key)
                    if wl is None:
                        recv_wait[key] = [w]
                    else:
                        wl.append(w)
                    transfer, eager = yield w
                    recycle(w)
                yield transfer
                if eager:
                    recycle(transfer)
                yield ev
        else:
            recv = mpi.recv
            for k in range(rounds):
                ev = isend(rank, nxt, per_round, tag=(op_id, k, me))
                yield from recv(prv, rank, tag=(op_id, k, prv_i))
                yield ev
        if tok is not None:
            tr.coll_end(rank, tok)

    @property
    def trace(self):
        """The engine's TraceRecorder (NULL_RECORDER when tracing off)."""
        return self.engine.trace

    def run(self) -> Dict:
        fa = self.engine.faults
        for r in range(self.n):
            proc = self.engine.spawn(self._rank_proc(r), name=f"chip{r}")
            if fa.enabled:
                fa.register_rank(r, proc)
        self.engine.run_all()
        fa.finalize()
        if len(self.finish) < self.n:
            # fail-stop stranded the survivors; report a failed step
            return {"step_s": self.engine.now, "failed": True,
                    "n_finished": len(self.finish),
                    "events": self.engine.event_count,
                    "min_finish": min(self.finish.values())
                    if self.finish else 0.0}
        t = max(self.finish.values())
        return {"step_s": t, "events": self.engine.event_count,
                "min_finish": min(self.finish.values())}
