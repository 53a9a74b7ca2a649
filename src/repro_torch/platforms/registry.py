"""Named platform registry — every machine the framework can predict.

Real systems from the paper (Table I/II, Fig 7) and the TPU adaptation
target, plus synthetic TOP500-class entries spanning all three fabric
families (fat-tree / dragonfly / torus) so scenario sweeps have scale
diversity to chew on.  All machine constants — peaks, bandwidths, grid
shapes, published Rmax numbers — live HERE and nowhere else; call sites
go through ``get_platform(name)``.

Synthetic entries are loosely modeled on public TOP500-class systems
(Cascade Lake + EDR, Sapphire Rapids + HDR, Aries and Slingshot
dragonflies, A64FX and BG/Q tori, an A100 fat-tree, a 2-pod TPU DCN rig)
but are NOT measurements of those machines — they are plausible spec
points for what-if studies.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Callable, Dict, Iterable, List, Sequence

from .spec import FabricSpec, MPIStackSpec, NodeSpec, Platform, ScaleSpec

_REGISTRY: Dict[str, Platform] = {}

#: callbacks fired with a platform *name* whenever that name's binding
#: changes (overwrite re-registration or unregistration) — the serving
#: layer's result caches subscribe here to drop entries derived from
#: the name (layering stays serve -> platforms)
_INVALIDATION_HOOKS: List[Callable[[str], None]] = []


def add_invalidation_hook(fn: Callable[[str], None]) -> None:
    """Subscribe to name-rebinding events; ``fn(name)`` is called after
    an existing registration is overwritten or removed (idempotent —
    the same callable is only installed once)."""
    if fn not in _INVALIDATION_HOOKS:
        _INVALIDATION_HOOKS.append(fn)


def _notify_rebound(name: str) -> None:
    for fn in list(_INVALIDATION_HOOKS):
        fn(name)


def register(platform: Platform, *, overwrite: bool = False) -> Platform:
    if not overwrite and platform.name in _REGISTRY:
        raise ValueError(f"platform {platform.name!r} already registered")
    rebound = platform.name in _REGISTRY
    _REGISTRY[platform.name] = platform
    if rebound:
        _notify_rebound(platform.name)
    return platform


def bulk_register(platforms: Iterable[Platform], *, namespace: str,
                  overwrite: bool = False) -> List[Platform]:
    """Register a generated list under ``namespace/`` so ingested specs
    (e.g. a whole TOP500 list) can never collide with built-in names.

    Each platform is re-named ``f"{namespace}/{platform.name}"``.  The
    batch is validated up front — a duplicate inside the batch or a
    collision with an already-registered name raises before anything is
    registered (all-or-nothing), unless ``overwrite=True``.  Returns the
    renamed platforms in input order.
    """
    if not namespace or "/" in namespace:
        raise ValueError(f"bulk_register: namespace {namespace!r} must be "
                         "a non-empty string without '/'")
    renamed = [dataclasses.replace(p, name=f"{namespace}/{p.name}")
               for p in platforms]
    seen: Dict[str, int] = {}
    for p in renamed:
        if p.name in seen:
            raise ValueError(f"bulk_register: duplicate name {p.name!r} "
                             "inside the batch")
        seen[p.name] = 1
        if not overwrite and p.name in _REGISTRY:
            raise ValueError(f"bulk_register: {p.name!r} already "
                             "registered (pass overwrite=True to replace)")
    for p in renamed:
        rebound = p.name in _REGISTRY
        _REGISTRY[p.name] = p
        if rebound:
            _notify_rebound(p.name)
    return renamed


def unregister(names: Sequence[str]) -> None:
    """Remove registered names (missing ones are ignored) — the cleanup
    companion to ``bulk_register`` for tests and re-ingestion."""
    for name in names:
        if _REGISTRY.pop(name, None) is not None:
            _notify_rebound(name)


def get_platform(name: str) -> Platform:
    try:
        return _REGISTRY[name]
    except KeyError:
        close = difflib.get_close_matches(name, _REGISTRY, n=3, cutoff=0.5)
        hint = (f"did you mean: {', '.join(close)}?" if close
                else "no close match")
        raise KeyError(f"unknown platform {name!r}; {hint} "
                       f"({len(_REGISTRY)} platforms registered; "
                       "see list_platforms())") from None


def list_platforms() -> List[str]:
    return sorted(_REGISTRY)


# --------------------------------------------------------------- nodes

# Paper Table I: 2x Xeon E5-2699 v4 Broadwell 22c @2.2 GHz nominal;
# AVX2 (16 DP flops/cyc) sustains ~1.8 GHz; DDR4-2400 x 4ch x 2.
_BDW_NODE = NodeSpec.xeon("bdw-2699v4", 2, 22, 1.8, flops_per_cycle=16,
                          ddr_gbs=153.6, hbm_bytes=256e9)

# Frontera: 2x Xeon Platinum 8280 28c; AVX-512 sustains ~1.8 GHz (paper:
# the nominal 2.7 GHz cannot be held under AVX-512); DDR4-2933 x 6ch x 2.
_CLX_NODE = NodeSpec.xeon("clx-8280", 2, 28, 1.8, flops_per_cycle=32,
                          ddr_gbs=2 * 6 * 23.46, hbm_bytes=192e9)

# PupMaya: 2x Xeon Gold 6148 20c; AVX-512 sustains ~1.6 GHz; DDR4-2666.
_SKX_NODE = NodeSpec.xeon("skx-6148", 2, 20, 1.6, flops_per_cycle=32,
                          ddr_gbs=2 * 6 * 21.3, hbm_bytes=192e9)

# TPU v5e: 197 TF bf16, 819 GB/s HBM, 16 GB per chip; 2 us dispatch.
_V5E_NODE = NodeSpec(name="tpu-v5e", peak_flops=197e12, mem_bw=819e9,
                     cores=1, gemm_efficiency=0.90, mem_efficiency=0.85,
                     blas_latency=2e-6, hbm_bytes=16e9)


# ------------------------------------------------- paper / real systems

register(Platform(
    name="bdw-local",
    node=_BDW_NODE,
    fabric=FabricSpec(kind="fat-tree", link_bw=100e9 / 8, nodes_per_edge=4,
                      n_core=2),
    mpi=MPIStackSpec(net_latency=2e-6),
    scale=ScaleSpec(n_nodes=16, grid=(4, 4), hpl_n=4096, hpl_nb=128),
    notes="Paper Table I local validation machine, as a 16-node cell."))

register(Platform(
    name="frontera",
    node=_CLX_NODE,
    # 8,008 nodes on HDR100 (pairs into HDR200 leaf ports): ~182 leaf
    # switches x 44 nodes, 6 core switches, 18 HDR200 uplinks / 6 cores.
    fabric=FabricSpec(kind="fat-tree", link_bw=100e9 / 8, hop_latency=90e-9,
                      nodes_per_edge=44, n_core=6,
                      uplink_bw=200e9 / 8 * 3),
    mpi=MPIStackSpec(net_latency=2e-6),
    scale=ScaleSpec(n_nodes=8008, grid=(88, 91), hpl_n=9_282_848,
                    hpl_nb=384, reported_tflops=23516,
                    paper_pred_tflops=22566),
    notes="TOP500 #5 (paper Table II); paper SystemC sim wall 4.8 h."))

register(Platform(
    name="pupmaya",
    node=_SKX_NODE,
    fabric=FabricSpec(kind="fat-tree", link_bw=100e9 / 8, hop_latency=90e-9,
                      nodes_per_edge=32, n_core=8),
    mpi=MPIStackSpec(net_latency=2e-6),
    scale=ScaleSpec(n_nodes=4248, grid=(59, 72), hpl_n=4_748_928,
                    hpl_nb=384, reported_tflops=7484,
                    paper_pred_tflops=7558),
    notes="TOP500 #25 (paper Table II); paper SystemC sim wall 1.7 h."))

register(Platform(
    name="paper-fat-tree-10008",
    node=_CLX_NODE,
    # The paper's Fig 7 scalability rig: 10,008 nodes, 556 36-port edge
    # switches (18 down / 18 up), 18 core switches.
    fabric=FabricSpec(kind="fat-tree", link_bw=100e9 / 8,
                      nodes_per_edge=18, n_core=18),
    mpi=MPIStackSpec(net_latency=2e-6),
    scale=ScaleSpec(n_nodes=10008, grid=(72, 139), hpl_n=20_000_000),
    notes="Paper Fig 7 10,008-node scalability rig (21.8 h SystemC)."))

register(Platform(
    name="tpu-v5e-pod",
    node=_V5E_NODE,
    # one v5e pod: (16, 16) 2-D ICI torus, ~45 GB/s per link direction
    fabric=FabricSpec(kind="torus", link_bw=45e9, hop_latency=500e-9,
                      dims=(16, 16)),
    mpi=MPIStackSpec(net_latency=1e-6),
    scale=ScaleSpec(n_nodes=256, grid=(16, 16), hpl_n=619_520, hpl_nb=512),
    # DES-fitted (bridge.fit_fastsim_to_des, 3 small probes, 120 steps)
    calibration=(("bcast_bw_scale", 0.6641436081771985),
                 ("net_latency", 1.6478532495591818e-06),
                 ("swap_bw_scale", 1.3025717500119678)),
    notes="Hardware-adaptation target: HPL recast onto a v5e ICI torus."))


# ---------------------------------------------- synthetic TOP500 class

register(Platform(
    name="syn-ft-edr-1k",
    node=NodeSpec.xeon("syn-skl-6142", 2, 24, 2.0, flops_per_cycle=32,
                       ddr_gbs=230.4, hbm_bytes=192e9),
    fabric=FabricSpec(kind="fat-tree", link_bw=100e9 / 8,
                      nodes_per_edge=32, n_core=8),
    scale=ScaleSpec(n_nodes=1024, grid=(32, 32), hpl_n=4_294_912,
                    hpl_nb=256),
    notes="Mid-size Skylake + EDR fat-tree (departmental TOP500 entry)."))

register(Platform(
    name="syn-ft-hdr-32k",
    node=NodeSpec.xeon("syn-spr-8480", 2, 48, 2.4, flops_per_cycle=32,
                       ddr_gbs=614.4, hbm_bytes=512e9),
    fabric=FabricSpec(kind="fat-tree", link_bw=200e9 / 8,
                      nodes_per_edge=64, n_core=16,
                      uplink_bw=400e9 / 8),
    scale=ScaleSpec(n_nodes=32768, grid=(128, 256), hpl_n=39_650_304,
                    hpl_nb=512),
    notes="Leadership-class Sapphire Rapids + HDR200 fat-tree."))

register(Platform(
    name="syn-df-aries-8k",
    node=NodeSpec.xeon("syn-bdw-6148", 2, 18, 2.1, flops_per_cycle=32,
                       ddr_gbs=204.8, hbm_bytes=128e9),
    fabric=FabricSpec(kind="dragonfly", link_bw=14.6e9, hop_latency=100e-9,
                      n_groups=16, routers_per_group=16,
                      nodes_per_router=32, global_bw=18.75e9),
    scale=ScaleSpec(n_nodes=8192, grid=(64, 128), hpl_n=9_914_496,
                    hpl_nb=384),
    notes="Aries-era dragonfly (Cray XC-class), minimal routing."))

register(Platform(
    name="syn-df-ss-16k",
    node=NodeSpec.xeon("syn-amd-7763", 2, 64, 2.0, flops_per_cycle=16,
                       ddr_gbs=409.6, hbm_bytes=256e9),
    fabric=FabricSpec(kind="dragonfly", link_bw=25e9, hop_latency=100e-9,
                      n_groups=32, routers_per_group=16,
                      nodes_per_router=32, nonminimal=True),
    scale=ScaleSpec(n_nodes=16384, grid=(128, 128), hpl_n=19_826_176,
                    hpl_nb=512),
    notes="Slingshot-era dragonfly, Valiant non-minimal routing."))

register(Platform(
    name="syn-torus-fugaku-4k",
    node=NodeSpec(name="syn-a64fx", peak_flops=48 * 32 * 2.2e9,
                  mem_bw=1024e9, cores=48, gemm_efficiency=0.90,
                  mem_efficiency=0.80, blas_latency=2e-7,
                  hbm_bytes=32e9),
    fabric=FabricSpec(kind="torus", link_bw=6.8e9, hop_latency=200e-9,
                      dims=(16, 16, 16)),
    scale=ScaleSpec(n_nodes=4096, grid=(64, 64), hpl_n=3_506_496,
                    hpl_nb=192),
    # DES-fitted (bridge.fit_fastsim_to_des, 3 small probes, 120 steps)
    calibration=(("bcast_bw_scale", 0.5907666924636771),
                 ("net_latency", 2.29015778924287e-06),
                 ("swap_bw_scale", 10.155731492432405)),
    notes="A64FX + TofuD-style 3-D torus cell (Fugaku-like)."))

register(Platform(
    name="syn-torus-bgq-8k",
    node=NodeSpec(name="syn-bgq", peak_flops=16 * 8 * 1.6e9,
                  mem_bw=42.6e9, cores=16, gemm_efficiency=0.85,
                  mem_efficiency=0.80, blas_latency=2e-7, hbm_bytes=16e9),
    fabric=FabricSpec(kind="torus", link_bw=2e9, hop_latency=80e-9,
                      dims=(32, 16, 16)),
    scale=ScaleSpec(n_nodes=8192, grid=(64, 128), hpl_n=3_506_432,
                    hpl_nb=128),
    # DES-fitted (bridge.fit_fastsim_to_des, 3 small probes, 120 steps)
    calibration=(("bcast_bw_scale", 0.8759841926584423),
                 ("net_latency", 4.562412942707659e-06),
                 ("swap_bw_scale", 3.1254017822068474)),
    notes="BlueGene/Q-style low-power torus machine."))

register(Platform(
    name="syn-gpu-ft-2k",
    # HPL runs on the GPUs: node peak is 4x A100 DP (9.7 TF each); the
    # accelerator section documents the split.  One rank per GPU.
    node=NodeSpec(name="syn-4xa100", peak_flops=4 * 9.7e12,
                  mem_bw=4 * 1555e9, cores=4, gemm_efficiency=0.90,
                  mem_efficiency=0.80, blas_latency=2e-6,
                  hbm_bytes=4 * 80e9, accel_peak_flops=4 * 9.7e12,
                  accel_mem_bw=4 * 1555e9),
    fabric=FabricSpec(kind="fat-tree", link_bw=200e9 / 8,
                      nodes_per_edge=32, n_core=16),
    scale=ScaleSpec(n_nodes=2048, ranks_per_node=4, grid=(64, 128),
                    hpl_n=7_839_744, hpl_nb=384),
    notes="GPU-accelerated fat-tree (A100-class), 4 ranks/node."))

register(Platform(
    name="syn-mp-2pod-v5e",
    node=_V5E_NODE,
    fabric=FabricSpec(kind="multipod", link_bw=45e9, hop_latency=500e-9,
                      dims=(16, 16), n_pods=2, dcn_bw_per_node=25e9,
                      dcn_latency=10e-6),
    mpi=MPIStackSpec(net_latency=1e-6),
    scale=ScaleSpec(n_nodes=512, grid=(16, 32), hpl_n=876_032,
                    hpl_nb=512),
    # DES-fitted (bridge.fit_fastsim_to_des, 3 small probes, 120 steps)
    calibration=(("bcast_bw_scale", 0.6624194630769419),
                 ("net_latency", 1.647546832564056e-06),
                 ("swap_bw_scale", 1.301011940122499)),
    notes="Two v5e pods joined by a DCN (cross-pod HPL what-if rig)."))
