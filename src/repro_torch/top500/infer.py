"""Spec inference: TOP500 row strings -> Platform specs, with provenance.

The paper hand-derives each machine's node model (sustained AVX clock,
flops/cycle, memory bandwidth) from its processor SKU and its fabric
from the interconnect product name.  This module systematizes exactly
that derivation so it runs over a whole list:

  * ``CPU_FAMILIES`` — ordered regex rules over the processor string.
    Each rule carries the ISA's DP flops/cycle, the sustained-clock
    fraction under full-width vector load (the paper's 1.8-vs-2.7 GHz
    Frontera observation, generalized), sockets per node, and per-core
    memory bandwidth/capacity.  Core count and nominal clock are parsed
    from the string itself ("28C 2.7GHz").
  * ``FABRIC_FAMILIES`` — regex rules over the interconnect string that
    pick the fabric *kind* (EDR/HDR/OPA -> fat-tree, Aries/Slingshot ->
    dragonfly, Tofu/BlueGene -> torus) and its bandwidth class; geometry
    (switch radix, group size, torus dims) is then sized to the node
    count.

Every heuristic decision is recorded in the generated ``Platform``'s
``provenance`` table — which rule fired, where the peak came from,
whether Rpeak reconciliation rescaled it — and every rule is
overridable per call (``cpu_families=``/``fabric_families=`` replace
the tables; ``overrides=`` pins spec fields directly).

Rpeak reconciliation: the list's Rpeak is authoritative (it *is*
cores x nominal clock x flops/cycle).  If the rule-derived nominal
system peak disagrees with Rpeak by more than ``rpeak_tolerance``
(wrong flops/cycle guess, unlisted accelerator), the node's nominal
peak is rescaled to Rpeak / n_nodes, and for accelerated rows the
excess over the CPU part is attributed to the accelerator section.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.platforms.spec import (FabricSpec, MPIStackSpec,
                                        NodeSpec, Platform, ScaleSpec)

from .rows import Top500Row


# ------------------------------------------------------------ CPU rules

@dataclasses.dataclass(frozen=True)
class CPUFamilyRule:
    """One processor family: matched against the row's processor string
    (first match wins; order the table accordingly)."""
    name: str
    pattern: str                 # case-insensitive regex
    flops_per_cycle: int         # DP FMA width per core
    sustained_frac: float        # sustained / nominal clock under vectors
    sockets_per_node: int
    mem_bw_core_gbs: float       # per-core sustained stream bandwidth
    mem_core_gb: float           # per-core memory capacity
    default_cores: int = 0       # per-socket fallback if "NNC" is absent
    default_ghz: float = 0.0     # fallback if "X.XGHz" is absent

    def matches(self, processor: str) -> bool:
        return re.search(self.pattern, processor, re.IGNORECASE) is not None


CPU_FAMILIES: Tuple[CPUFamilyRule, ...] = (
    CPUFamilyRule("a64fx", r"\bA64FX\b", 32, 0.95, 1, 21.3, 0.67, 48, 2.2),
    CPUFamilyRule("xeon-phi", r"Xeon Phi|\b72[0-9]{2}[PF]?\b.*Knights",
                  32, 0.55, 1, 6.0, 1.6, 68, 1.4),
    CPUFamilyRule("xeon-avx512",
                  r"Xeon (Platinum|Gold|Silver|Bronze|W-\d)|Xeon.*84\d\dC?",
                  32, 0.70, 2, 4.5, 3.5, 24, 2.4),
    CPUFamilyRule("xeon-avx2", r"E5-\d{4}\s?v[34]\b|E7-\d{4}\s?v[34]\b",
                  16, 0.85, 2, 4.5, 4.5, 14, 2.4),
    CPUFamilyRule("xeon-avx", r"E5-\d{4}(\s?v2)?\b|X56\d\d|E7-\d{4}",
                  8, 0.90, 2, 4.0, 4.0, 12, 2.6),
    CPUFamilyRule("epyc", r"\bEPYC\b", 16, 0.85, 2, 3.4, 4.0, 64, 2.25),
    CPUFamilyRule("power9", r"POWER9", 8, 0.95, 2, 7.0, 8.0, 22, 3.0),
    CPUFamilyRule("bgq", r"Power BQC|BQC 16C", 8, 0.95, 1, 2.7, 1.0,
                  16, 1.6),
    CPUFamilyRule("sparc64", r"SPARC64", 8, 0.95, 1, 8.0, 2.0, 8, 2.0),
    CPUFamilyRule("sw26010", r"SW26010|Sunway", 8, 0.95, 1, 0.52, 0.125,
                  260, 1.45),
    # catch-all keeps the pipeline total (provenance marks the guess)
    CPUFamilyRule("generic-x86", r".", 16, 0.80, 2, 4.0, 3.0, 16, 2.5),
)

# accelerator product -> DP peak per device (FLOP/s); used only to tag
# the accelerator section after Rpeak reconciliation.
ACCEL_PEAKS: Tuple[Tuple[str, float], ...] = (
    (r"A100", 9.7e12),
    (r"V100", 7.8e12),
    (r"P100", 4.7e12),
    (r"K\d0x?\b", 1.4e12),
    (r"MI\d+", 6.6e12),
    (r"Matrix-2000", 2.4e12),
)

_CORES_RE = re.compile(r"(\d+)\s*C\b", re.IGNORECASE)
_GHZ_RE = re.compile(r"([\d.]+)\s*GHz", re.IGNORECASE)


# --------------------------------------------------------- fabric rules

@dataclasses.dataclass(frozen=True)
class FabricFamilyRule:
    """One interconnect family: kind + bandwidth class; geometry is sized
    per machine by ``_size_fabric``.  ``family`` is the residual-
    calibration grouping key (see top500/calibrate.py)."""
    name: str
    pattern: str
    kind: str                    # fat-tree | dragonfly | torus
    family: str                  # calibration group
    link_bw: float               # per-node injection B/s
    hop_latency: float = 90e-9
    nonminimal: bool = False

    def matches(self, interconnect: str) -> bool:
        return re.search(self.pattern, interconnect,
                         re.IGNORECASE) is not None


FABRIC_FAMILIES: Tuple[FabricFamilyRule, ...] = (
    FabricFamilyRule("ib-hdr", r"\bHDR\b", "fat-tree", "infiniband",
                     200e9 / 8),
    FabricFamilyRule("ib-edr", r"\bEDR\b", "fat-tree", "infiniband",
                     100e9 / 8),
    FabricFamilyRule("ib-fdr", r"\bFDR\b", "fat-tree", "infiniband",
                     56e9 / 8),
    FabricFamilyRule("ib-qdr", r"\bQDR\b", "fat-tree", "infiniband",
                     40e9 / 8),
    FabricFamilyRule("omnipath", r"Omni[- ]?Path|\bOPA\b", "fat-tree",
                     "omnipath", 100e9 / 8),
    FabricFamilyRule("aries", r"\bAries\b", "dragonfly", "aries", 14.6e9,
                     100e-9),
    FabricFamilyRule("slingshot", r"Slingshot", "dragonfly", "slingshot",
                     25e9, 100e-9, nonminimal=True),
    FabricFamilyRule("tofu", r"\bTofu\b", "torus", "tofu", 6.8e9, 200e-9),
    FabricFamilyRule("bluegene", r"BlueGene|Blue Gene|5D Torus", "torus",
                     "bluegene", 2e9, 80e-9),
    FabricFamilyRule("th-express", r"TH Express", "fat-tree", "custom",
                     14e9),
    FabricFamilyRule("sunway-net", r"Sunway", "fat-tree", "custom", 14e9),
    FabricFamilyRule("bxi", r"\bBXI\b", "fat-tree", "custom", 100e9 / 8),
    FabricFamilyRule("eth-100g", r"100G\b.*Ethernet|Ethernet.*100G",
                     "fat-tree", "ethernet", 100e9 / 8),
    FabricFamilyRule("eth-25g", r"25G\b.*Ethernet|Ethernet.*25G",
                     "fat-tree", "ethernet", 25e9 / 8),
    FabricFamilyRule("eth-10g", r"10G\b.*Ethernet|Ethernet.*10G",
                     "fat-tree", "ethernet", 10e9 / 8),
    # generic InfiniBand (no speed grade listed) -> EDR-class
    FabricFamilyRule("ib-generic", r"Infini[Bb]and|Mellanox", "fat-tree",
                     "infiniband", 100e9 / 8),
    FabricFamilyRule("eth-generic", r"Ethernet", "fat-tree", "ethernet",
                     25e9 / 8),
    # catch-all: treat unknown/custom networks as a 100 Gb fat-tree
    FabricFamilyRule("unknown", r".", "fat-tree", "custom", 100e9 / 8),
)


def _size_fabric(rule: FabricFamilyRule, n_nodes: int) -> FabricSpec:
    """Fill in geometry for the machine's node count.  Shapes are
    conventional for the family, not per-machine wiring diagrams — the
    provenance table records which rule sized them."""
    if rule.kind == "fat-tree":
        nodes_per_edge = 32 if n_nodes >= 32 else max(n_nodes, 1)
        n_edge = (n_nodes + nodes_per_edge - 1) // nodes_per_edge
        n_core = max(2, min(16, (n_edge + 1) // 2))
        return FabricSpec(kind="fat-tree", link_bw=rule.link_bw,
                          hop_latency=rule.hop_latency,
                          nodes_per_edge=nodes_per_edge, n_core=n_core,
                          uplink_bw=2.0 * rule.link_bw)
    if rule.kind == "dragonfly":
        routers_per_group, nodes_per_router = 16, 16
        group = routers_per_group * nodes_per_router
        n_groups = max(2, (n_nodes + group - 1) // group)
        return FabricSpec(kind="dragonfly", link_bw=rule.link_bw,
                          hop_latency=rule.hop_latency,
                          n_groups=n_groups,
                          routers_per_group=routers_per_group,
                          nodes_per_router=nodes_per_router,
                          global_bw=rule.link_bw * 1.3,
                          nonminimal=rule.nonminimal)
    if rule.kind == "torus":
        return FabricSpec(kind="torus", link_bw=rule.link_bw,
                          hop_latency=rule.hop_latency,
                          dims=_torus_dims(n_nodes))
    raise ValueError(f"fabric rule {rule.name!r}: unknown kind "
                     f"{rule.kind!r}")


def _torus_dims(n_nodes: int, ndims: int = 3) -> Tuple[int, ...]:
    """Near-cubic power-of-two dims with product >= n_nodes."""
    total_log = max(int(math.ceil(math.log2(max(n_nodes, 1)))), ndims)
    base, extra = divmod(total_log, ndims)
    return tuple(2 ** (base + (1 if i < extra else 0))
                 for i in range(ndims))


# ------------------------------------------------------------ inference

def _slug(text: str, fallback: str) -> str:
    s = re.sub(r"[^\w.-]+", "-", text.strip(), flags=re.UNICODE).strip("-")
    return (s or fallback).lower()


def _near_square_grid(n_ranks: int) -> Tuple[int, int]:
    """(P, Q) with P*Q == n_ranks, P <= Q, as square as divisors allow."""
    best = (1, n_ranks)
    for p in range(int(math.isqrt(n_ranks)), 0, -1):
        if n_ranks % p == 0:
            best = (p, n_ranks // p)
            break
    return best


def memory_sized_n(n_nodes: int, hbm_bytes: float, nb: int,
                   mem_fraction: float = 0.75) -> int:
    """Largest nb-multiple N with 8*N^2 <= mem_fraction of fleet memory —
    the standard HPL problem-sizing rule."""
    n = math.sqrt(mem_fraction * n_nodes * hbm_bytes / 8.0)
    return max(int(n) // nb * nb, nb)


def infer_platform(row: Top500Row, *,
                   cpu_families: Sequence[CPUFamilyRule] = CPU_FAMILIES,
                   fabric_families: Sequence[FabricFamilyRule]
                   = FABRIC_FAMILIES,
                   overrides: Optional[Dict[str, object]] = None,
                   rpeak_tolerance: float = 0.30,
                   mem_fraction: float = 0.75,
                   default_nb: int = 256) -> Platform:
    """One list row -> one ``Platform`` with a full provenance record.

    ``overrides`` pins inferred scalar knobs by name before the spec is
    assembled: ``cores_per_node``, ``n_nodes``, ``node_peak_flops``,
    ``mem_bw``, ``hbm_bytes``, ``nb``.  Every override fires a
    provenance entry so a tuned spec still explains itself.
    """
    ov = dict(overrides or {})
    prov: List[Tuple[str, str]] = [
        ("source", f"top500 rank {row.rank} schema v{row.schema_version}"),
    ]

    cpu = next((r for r in cpu_families if r.matches(row.processor)),
               None)
    if cpu is None:
        raise ValueError(f"infer_platform: no CPU family rule matches "
                         f"processor {row.processor!r} (row rank "
                         f"{row.rank}); add a catch-all rule")
    prov.append(("cpu_family", cpu.name))

    m = _CORES_RE.search(row.processor)
    cores_per_socket = int(m.group(1)) if m else cpu.default_cores
    if not m:
        prov.append(("cores_per_socket", f"fallback {cores_per_socket}"))
    m = _GHZ_RE.search(row.processor)
    ghz = float(m.group(1)) if m else cpu.default_ghz
    if not m:
        prov.append(("clock_ghz", f"fallback {ghz}"))

    cores_per_node = int(ov.get("cores_per_node",
                                cpu.sockets_per_node * cores_per_socket))
    if "cores_per_node" in ov:
        prov.append(("cores_per_node", f"override {cores_per_node}"))
    n_nodes = int(ov.get("n_nodes",
                         max(row.cpu_cores // max(cores_per_node, 1), 1)))
    prov.append(("n_nodes",
                 f"override {n_nodes}" if "n_nodes" in ov else
                 f"{row.cpu_cores} cpu cores / {cores_per_node} per node"))

    # nominal node peak from the rule; reconcile against the listed Rpeak
    nominal_core = cpu.flops_per_cycle * ghz * 1e9
    nominal_node = nominal_core * cores_per_node
    rpeak_node = row.rpeak_tflops * 1e12 / n_nodes
    accelerated = row.accel_cores > 0 or bool(row.accelerator)
    if "node_peak_flops" in ov:
        nominal_node = float(ov["node_peak_flops"])
        prov.append(("peak_source", "override"))
    elif accelerated or abs(nominal_node - rpeak_node) \
            > rpeak_tolerance * rpeak_node:
        prov.append(("peak_source",
                     f"rpeak-rescaled (heuristic {nominal_node:.3e} vs "
                     f"rpeak/node {rpeak_node:.3e})"))
        nominal_node = rpeak_node
    else:
        prov.append(("peak_source", "processor-heuristic"))
    accel_node = max(nominal_node - nominal_core * cores_per_node, 0.0) \
        if accelerated else 0.0
    if accelerated:
        prov.append(("accelerator", row.accelerator or "unlisted"))
        for pat, dev_peak in ACCEL_PEAKS:
            if re.search(pat, row.accelerator or row.processor,
                         re.IGNORECASE):
                prov.append(("accel_device_peak", f"{dev_peak:.2e}"))
                break

    # the paper's sustained-clock derate applies to the whole node peak;
    # accelerator-resident HPL doesn't see the host's vector downclock,
    # so accelerated nodes get a milder, GPU-boost-style derate
    sustained = 0.90 if accelerated else cpu.sustained_frac
    peak_flops = nominal_node * sustained
    prov.append(("sustained_frac", f"{sustained}"))

    mem_bw = float(ov.get("mem_bw",
                          cpu.mem_bw_core_gbs * 1e9 * cores_per_node))
    hbm = float(ov.get("hbm_bytes",
                       cpu.mem_core_gb * 1e9 * cores_per_node))
    if accelerated:                  # HBM-resident HPL on the accelerator
        # HBM machines run ~0.1 B/flop (V100: 900 GB/s against 7.8 TF)
        mem_bw = max(mem_bw, 0.1 * accel_node)
        prov.append(("mem_model", "accel-hbm-floor"))

    node = NodeSpec(name=f"{cpu.name}-{cores_per_node}c",
                    peak_flops=peak_flops, mem_bw=mem_bw,
                    cores=cores_per_node,
                    gemm_efficiency=0.92, mem_efficiency=0.80,
                    blas_latency=2e-6 if accelerated else 2e-7,
                    hbm_bytes=hbm,
                    accel_peak_flops=accel_node * sustained,
                    accel_mem_bw=mem_bw if accelerated else 0.0)

    fab_rule = next((r for r in fabric_families
                     if r.matches(row.interconnect)), None)
    if fab_rule is None:
        raise ValueError(f"infer_platform: no fabric family rule "
                         f"matches interconnect {row.interconnect!r} "
                         f"(row rank {row.rank}); add a catch-all rule")
    prov.append(("fabric_family", fab_rule.name))
    prov.append(("fabric_group", fab_rule.family))
    fabric = _size_fabric(fab_rule, n_nodes)
    prov.append(("fabric_geometry",
                 f"{fabric.kind} sized for {n_nodes} nodes"))

    nb = int(ov.get("nb", default_nb))
    grid = _near_square_grid(n_nodes)
    hpl_n = row.nmax or memory_sized_n(n_nodes, hbm, nb, mem_fraction)
    prov.append(("hpl_n", "published nmax" if row.nmax else
                 f"memory rule ({mem_fraction:.2f} fill)"))

    name = f"r{row.rank:03d}-{_slug(row.system or row.site, 'unnamed')}"
    return Platform(
        name=name, node=node, fabric=fabric,
        mpi=MPIStackSpec(net_latency=2e-6),
        scale=ScaleSpec(n_nodes=n_nodes, ranks_per_node=1, grid=grid,
                        hpl_n=hpl_n, hpl_nb=nb,
                        reported_tflops=row.rmax_tflops),
        provenance=tuple(prov),
        notes=f"Inferred from TOP500 row: {row.site} / {row.system} "
              f"({row.processor}; {row.interconnect})")


def infer_platforms(rows: Iterable[Top500Row], **kw) -> List[Platform]:
    return [infer_platform(row, **kw) for row in rows]


def fabric_group(platform: Platform) -> str:
    """The calibration grouping key recorded at inference time."""
    return platform.provenance_dict.get("fabric_group", "unknown")
