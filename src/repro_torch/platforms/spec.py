"""Declarative machine specifications — the single source of platform truth.

The paper predicts full-system performance from "an abstract yet
high-fidelity model" of the platform; Cornebize & Legrand (2102.07674)
show that *calibration quality* dominates prediction accuracy, and
Mohammed et al. (1910.06844) argue for one machine description driving
multiple simulation backends.  This module is that description: a
``Platform`` bundles four sections —

  * ``NodeSpec``   — the processing element (peak flops, memory system,
    BLAS dispatch overheads, optional accelerator section),
  * ``FabricSpec`` — the interconnect (fat-tree / dragonfly / torus /
    multipod geometry, link bandwidths, hop latencies),
  * ``MPIStackSpec`` — the software stack (per-call overhead, effective
    small-message latency, default HPL broadcast algorithm),
  * ``ScaleSpec``  — deployment scale (node count, ranks per node, the
    machine's published HPL run geometry and TOP500 numbers),

plus an optional ``calibration`` table of DES-fitted fastsim overrides
(fitted by ``repro``'s platforms/bridge.py, which is not ported yet).
Specs are frozen, hashable, and round-trip
through ``to_dict``/``from_dict`` (JSON-safe), so a registry machine can
be shipped, diffed, and versioned as data.

Backends are built lazily: ``platform.des()`` returns the discrete-event
stack (NodeModel, Topology, ranks-per-node, SimMPI knobs) and
``platform.fastsim()`` the vectorized simulator's ``FastSimParams`` —
both via platforms/build.py, so this module stays import-light.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Optional, Tuple

FABRIC_KINDS = ("fat-tree", "dragonfly", "torus", "multipod")


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One node: the paper's §III-A1 processing-element model as data."""
    name: str
    peak_flops: float            # node peak, FLOP/s (sustained AVX/MXU clock)
    mem_bw: float                # B/s
    cores: int = 1
    gemm_efficiency: float = 0.92
    mem_efficiency: float = 0.80
    blas_latency: float = 2e-7   # theta: per-BLAS-call overhead (s)
    hbm_bytes: float = 0.0       # per-node memory capacity (sizes HPL N)
    # accelerator section (paper's CPU-GPGPU heterogeneous extension)
    accel_peak_flops: float = 0.0
    accel_mem_bw: float = 0.0
    accel_efficiency: float = 0.75

    @classmethod
    def xeon(cls, name: str, sockets: int, cores_per_socket: int,
             sustained_clock_ghz: float, flops_per_cycle: int = 32,
             ddr_gbs: float = 100.0, **kw) -> "NodeSpec":
        """Xeon-style derivation: peak = cores x flops/cycle x clock."""
        cores = sockets * cores_per_socket
        return cls(name=name,
                   peak_flops=cores * flops_per_cycle
                   * sustained_clock_ghz * 1e9,
                   mem_bw=ddr_gbs * 1e9, cores=cores, **kw)


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """The interconnect: one of FABRIC_KINDS plus its geometry knobs.

    ``link_bw`` is the per-node injection bandwidth in B/s; geometry
    fields are kind-specific and ignored by the other kinds.
    """
    kind: str
    link_bw: float
    hop_latency: float = 90e-9
    base_latency: float = 1e-6
    # fat-tree (two-level, D-mod-K)
    nodes_per_edge: int = 0
    n_core: int = 0
    uplink_bw: Optional[float] = None
    # dragonfly (g groups x a routers x p nodes)
    n_groups: int = 0
    routers_per_group: int = 0
    nodes_per_router: int = 0
    global_bw: Optional[float] = None
    nonminimal: bool = False
    # torus (TPU ICI)
    dims: Tuple[int, ...] = ()
    # multipod (pods of `dims`-torus joined by a DCN)
    n_pods: int = 0
    dcn_bw_per_node: float = 25e9
    dcn_latency: float = 10e-6

    def __post_init__(self):
        if self.kind not in FABRIC_KINDS:
            raise ValueError(f"fabric kind {self.kind!r} not in "
                             f"{FABRIC_KINDS}")


@dataclasses.dataclass(frozen=True)
class MPIStackSpec:
    """MPI software stack: what SimMPI / fastsim need beyond the wire."""
    overhead: float = 5e-7           # per-call software overhead (s)
    net_latency: Optional[float] = None  # end-to-end small-msg latency;
    #                                  None -> derived from the fabric
    bcast: str = "1ring"             # default HPL panel-broadcast variant


@dataclasses.dataclass(frozen=True)
class ScaleSpec:
    """Deployment scale and the machine's published HPL geometry."""
    n_nodes: int
    ranks_per_node: int = 1
    grid: Tuple[int, int] = (0, 0)   # published / default (P, Q)
    hpl_n: int = 0                   # published / memory-sized Nmax
    hpl_nb: int = 384
    reported_tflops: float = 0.0     # TOP500 Rmax (0 = not a real entry)
    paper_pred_tflops: float = 0.0   # the paper's own prediction, if any

    @property
    def n_ranks(self) -> int:
        return self.n_nodes * self.ranks_per_node


@dataclasses.dataclass(frozen=True)
class Platform:
    """A complete machine description; the only place machine constants
    are allowed to live (everything else goes through the registry)."""
    name: str
    node: NodeSpec
    fabric: FabricSpec
    mpi: MPIStackSpec = MPIStackSpec()
    scale: ScaleSpec = ScaleSpec(n_nodes=1)
    # DES-fitted FastSimParams overrides, e.g. (("bcast_bw_scale", 0.9),)
    calibration: Tuple[Tuple[str, float], ...] = ()
    # per-scale contention overrides fitted from region-DES probes
    # (repro.scale): ((ranks, (("bcast_bw_scale", 0.8), ...)), ...);
    # ``fastsim(at_ranks=...)`` applies the nearest (log-space) entry on
    # top of ``calibration``
    contention: Tuple[Tuple[int, Tuple[Tuple[str, float], ...]], ...] = ()
    # inference audit trail for generated specs (top500 ingestion): each
    # entry is a (key, value) string pair, e.g. ("cpu_family", "xeon-avx512")
    # or ("peak_source", "rpeak-rescaled"); empty for hand-written specs
    provenance: Tuple[Tuple[str, str], ...] = ()
    notes: str = ""

    # ------------------------------------------------------ backends
    def des(self, trace: bool = False):
        """Build the discrete-event stack: a DESStack of
        (node, topology, ranks_per_node, mpi_overhead).  ``trace=True``
        marks the stack so HPLSim attaches a TraceRecorder."""
        from .build import build_des
        return build_des(self, trace=trace)

    def fastsim(self, *, calibrated: bool = True,
                at_ranks: Optional[int] = None):
        """Build FastSimParams (with ``calibration`` overrides applied
        unless ``calibrated=False``).  ``at_ranks`` additionally applies
        the nearest per-scale ``contention`` entry (log-space distance),
        so predictions at 10^4 ranks use scales fitted at 10^4 ranks."""
        from .build import build_fastsim
        params = build_fastsim(self, calibrated=calibrated)
        if at_ranks is not None and calibrated:
            over = self.contention_for(at_ranks)
            if over:
                params = dataclasses.replace(params, **over)
        return params

    def contention_for(self, at_ranks: int) -> Dict[str, float]:
        """The contention entry nearest ``at_ranks`` in log-space
        ({} when the table is empty)."""
        if not self.contention or at_ranks < 1:
            return {}
        ranks, over = min(
            self.contention,
            key=lambda e: abs(math.log(max(e[0], 1)) - math.log(at_ranks)))
        return dict(over)

    def node_model(self):
        from .build import build_node
        return build_node(self.node)

    def ici(self, **overrides):
        """ICI parameters derived from the fabric/MPI sections — the
        analytic-network backend adapter (not ported yet: raises
        ``NotImplementedError``)."""
        from .build import build_ici
        return build_ici(self, **overrides)

    def topology(self):
        from .build import build_topology
        return build_topology(self.fabric, self.scale.n_nodes)

    def hpl_config(self, N: Optional[int] = None, nb: Optional[int] = None,
                   P: Optional[int] = None, Q: Optional[int] = None, **kw):
        """The machine's published HPL run (overridable per field)."""
        from repro_torch.core.apps.hpl import HPLConfig
        gp, gq = self.scale.grid
        P = P if P is not None else gp
        Q = Q if Q is not None else gq
        if P <= 0 or Q <= 0:
            raise ValueError(f"platform {self.name!r} has no default grid; "
                             "pass P and Q explicitly")
        N = N if N is not None else self.scale.hpl_n
        if N <= 0:
            raise ValueError(f"platform {self.name!r} has no default N; "
                             "pass N explicitly")
        kw.setdefault("bcast", self.mpi.bcast)
        return HPLConfig(N=N, nb=nb if nb is not None else self.scale.hpl_nb,
                         P=P, Q=Q, **kw)

    @property
    def calibration_dict(self) -> Dict[str, float]:
        return dict(self.calibration)

    @property
    def provenance_dict(self) -> Dict[str, str]:
        return dict(self.provenance)

    def with_calibration(self, overrides: Dict[str, float]) -> "Platform":
        """A copy with ``overrides`` merged into the calibration table."""
        merged = dict(self.calibration)
        merged.update(overrides)
        return dataclasses.replace(
            self, calibration=tuple(sorted(merged.items())))

    @property
    def contention_dict(self) -> Dict[int, Dict[str, float]]:
        return {r: dict(over) for r, over in self.contention}

    def with_contention(self, at_ranks: int, overrides: Dict[str, float],
                        note: str = "") -> "Platform":
        """A copy with ``overrides`` merged into the per-scale contention
        entry for ``at_ranks``; a non-empty ``note`` records the fit's
        provenance (region geometry, probe count) under
        ``contention@<ranks>``."""
        at_ranks = int(at_ranks)
        table = self.contention_dict
        entry = table.setdefault(at_ranks, {})
        entry.update(overrides)
        cont = tuple(sorted(
            (r, tuple(sorted(over.items()))) for r, over in table.items()))
        prov = self.provenance
        if note:
            key = f"contention@{at_ranks}"
            prov = tuple(kv for kv in prov if kv[0] != key) + ((key, note),)
        return dataclasses.replace(self, contention=cont, provenance=prov)

    # -------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["fabric"]["dims"] = list(self.fabric.dims)
        d["scale"]["grid"] = list(self.scale.grid)
        d["calibration"] = [list(kv) for kv in self.calibration]
        d["contention"] = [[r, [list(kv) for kv in over]]
                           for r, over in self.contention]
        d["provenance"] = [list(kv) for kv in self.provenance]
        return d

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Platform":
        fab = dict(d["fabric"])
        fab["dims"] = tuple(fab.get("dims") or ())
        sc = dict(d["scale"])
        sc["grid"] = tuple(sc.get("grid") or (0, 0))
        return cls(name=d["name"],
                   node=NodeSpec(**d["node"]),
                   fabric=FabricSpec(**fab),
                   mpi=MPIStackSpec(**d.get("mpi", {})),
                   scale=ScaleSpec(**sc),
                   calibration=tuple((k, float(v))
                                     for k, v in d.get("calibration", [])),
                   contention=tuple(
                       (int(r), tuple((k, float(v)) for k, v in over))
                       for r, over in d.get("contention", [])),
                   provenance=tuple((k, str(v))
                                    for k, v in d.get("provenance", [])),
                   notes=d.get("notes", ""))

    @classmethod
    def from_json(cls, s: str) -> "Platform":
        return cls.from_dict(json.loads(s))
