"""SimXLA — the SimBLAS/SimMPI idea adapted to the TPU/XLA world.

Where the paper models BLAS calls + MPI collectives on a fat-tree, the
TPU workload is XLA HLO ops + XLA collectives on an ICI torus.  The
library-layer models here consume the per-device (flops, bytes,
collective) trace extracted from the *compiled dry-run artifact*
(roofline/hlo_parse.py) — the exact analogue of substituting BLAS calls
with analytical models: data content never matters, only shapes.

Two fidelity levels (mirroring the paper's hybrid):
  * analytic (this module): closed-form ring/torus collective times +
    roofline op times + an overlap model;
  * DES (core/apps/transformer.py): per-rank virtual threads issuing
    flows on the Torus topology — contention is emergent.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from .hardware.node import NodeModel, TPU_V5E


@dataclasses.dataclass(frozen=True)
class ICIParams:
    link_bw: float = 45e9          # B/s per link per direction
    links_per_axis: int = 2        # bidirectional ring on each torus axis
    latency: float = 1e-6          # per collective-phase software latency
    dcn_bw: float = 25e9           # per-chip cross-pod bandwidth
    dcn_latency: float = 10e-6
    hop_latency: float = 500e-9    # per-ICI-hop wire latency
    base_latency: float = 1e-6     # per-message software/NIC latency


def ici_from_platform(platform, **overrides) -> ICIParams:
    """Derive the ICI parameters from a ``repro_torch.platforms.Platform`` spec
    (fabric + MPI-stack sections); keyword overrides win.  This is the
    single spec->ICI mapping — the legacy module constant ``ICI`` resolves
    through it from the ``tpu-v5e-pod`` registry entry."""
    fab, mpi = platform.fabric, platform.mpi
    latency = mpi.net_latency
    if latency is None:
        from repro_torch.platforms.build import derived_net_latency
        latency = derived_net_latency(platform)
    kw = dict(link_bw=fab.link_bw, latency=latency,
              dcn_bw=fab.dcn_bw_per_node, dcn_latency=fab.dcn_latency,
              hop_latency=fab.hop_latency, base_latency=fab.base_latency)
    kw.update(overrides)
    return ICIParams(**kw)


def default_ici() -> ICIParams:
    """The TPU-v5e ICI constants, resolved from the platform registry
    (single source of machine truth) and cached."""
    global _DEFAULT_ICI
    if _DEFAULT_ICI is None:
        from repro_torch.platforms.registry import get_platform
        _DEFAULT_ICI = ici_from_platform(get_platform("tpu-v5e-pod"))
    return _DEFAULT_ICI


_DEFAULT_ICI: Optional[ICIParams] = None


def assert_registry_consistent(platform=None) -> None:
    """Fail loudly if the legacy module constants (``ICI``, the node
    ``TPU_V5E``) have drifted from the registry spec they are supposed to
    mirror.  Benchmarks and examples that historically read hardcoded
    chip constants call this after routing through the registry, so a
    future re-hardcoding cannot silently diverge."""
    from repro_torch.core.hardware.node import TPU_V5E
    if platform is None:
        from repro_torch.platforms.registry import get_platform
        platform = get_platform("tpu-v5e-pod")
    spec_node = platform.node_model()
    if spec_node != TPU_V5E:
        raise RuntimeError(
            f"legacy TPU_V5E constant diverged from {platform.name!r} "
            f"spec: {TPU_V5E} != {spec_node}")
    spec_ici = ici_from_platform(platform)
    if spec_ici != default_ici():
        raise RuntimeError(
            f"legacy ICI constants diverged from {platform.name!r} "
            f"spec: {default_ici()} != {spec_ici}")


def __getattr__(name):
    # ICI stays importable as a constant; resolved (and cached) from the
    # registry on first access so the numbers live in one place.
    if name == "ICI":
        value = default_ici()
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def ring_allreduce_time(nbytes: float, n: int,
                        ici: Optional[ICIParams] = None) -> float:
    """Bidirectional-ring all-reduce on one torus axis: reduce-scatter +
    all-gather, each moving (n-1)/n of the buffer over 2 links."""
    ici = ici or default_ici()
    if n <= 1 or nbytes <= 0:
        return 0.0
    wire = 2.0 * (n - 1) / n * nbytes
    return wire / (ici.link_bw * ici.links_per_axis) \
        + 2.0 * (n - 1) * ici.latency


def ring_allgather_time(result_bytes: float, n: int,
                        ici: Optional[ICIParams] = None) -> float:
    ici = ici or default_ici()
    if n <= 1 or result_bytes <= 0:
        return 0.0
    wire = (n - 1) / n * result_bytes
    return wire / (ici.link_bw * ici.links_per_axis) + (n - 1) * ici.latency


def reduce_scatter_time(shard_bytes: float, n: int,
                        ici: Optional[ICIParams] = None) -> float:
    ici = ici or default_ici()
    if n <= 1 or shard_bytes <= 0:
        return 0.0
    wire = (n - 1) * shard_bytes
    return wire / (ici.link_bw * ici.links_per_axis) + (n - 1) * ici.latency


def all_to_all_time(nbytes: float, n: int,
                    ici: Optional[ICIParams] = None) -> float:
    """All-to-all on a ring: each chip sends (n-1)/n of its buffer; average
    hop distance n/4 on a bidirectional ring inflates wire occupancy."""
    ici = ici or default_ici()
    if n <= 1 or nbytes <= 0:
        return 0.0
    wire = (n - 1) / n * nbytes * (n / 4.0) / max(n - 1, 1) * 2.0
    return wire / (ici.link_bw * ici.links_per_axis) + (n - 1) * ici.latency


def collective_permute_time(nbytes: float,
                            ici: Optional[ICIParams] = None) -> float:
    ici = ici or default_ici()
    return nbytes / (ici.link_bw * ici.links_per_axis) + ici.latency


def collective_time(op: str, wire_bytes: float, group_size: int,
                    ici: Optional[ICIParams] = None) -> float:
    """Time for one collective given the *ring wire bytes* already computed
    by the HLO analyzer (hlo_parse ring-algorithm convention)."""
    ici = ici or default_ici()
    if wire_bytes <= 0:
        return 0.0
    n = max(group_size, 2)
    phases = {"all-reduce": 2 * (n - 1), "all-gather": n - 1,
              "reduce-scatter": n - 1, "all-to-all": n - 1,
              "collective-permute": 1}.get(op, n - 1)
    return wire_bytes / (ici.link_bw * ici.links_per_axis) \
        + phases * ici.latency


@dataclasses.dataclass
class StepPrediction:
    compute_s: float
    memory_s: float
    collective_s: float
    step_s: float
    bound_s: float
    breakdown: Dict[str, float]


class SimXLA:
    """Analytic step-time predictor for a compiled (arch x shape x mesh)
    cell, driven by the dry-run record.  Chip and ICI numbers default
    to the ``tpu-v5e-pod`` registry spec; ``SimXLA.for_platform`` derives
    them from any other ``Platform``."""

    def __init__(self, chip: Optional[NodeModel] = None,
                 ici: Optional[ICIParams] = None,
                 overlap: float = 0.7, fusion_efficiency: float = 3.0):
        self.chip = chip if chip is not None else TPU_V5E
        self.ici = ici or default_ici()
        # fraction of collective time hidden under compute (XLA latency
        # hiding / async collectives)
        self.overlap = overlap
        # our HLO byte model counts op-boundary traffic on the *CPU*-
        # partitioned module; TPU fusion materializes ~1/fusion_efficiency
        # of those boundaries (calibratable; see EXPERIMENTS.md §Sim-accuracy)
        self.fusion_efficiency = fusion_efficiency

    @classmethod
    def for_platform(cls, platform, **kw) -> "SimXLA":
        """A predictor whose chip and ICI sections come from a
        ``Platform`` spec instead of the legacy constants."""
        kw.setdefault("chip", platform.node_model())
        kw.setdefault("ici", ici_from_platform(platform))
        return cls(**kw)

    def predict(self, record: Dict) -> StepPrediction:
        """record: one experiments/dryrun/*.json cell."""
        r = record["roofline"]
        flops = r["hlo_flops_total"] / record["chips"]
        nbytes = r["hlo_bytes_total"] / record["chips"]
        compute = flops / (self.chip.peak_flops * self.chip.gemm_efficiency)
        memory = (nbytes / self.fusion_efficiency
                  / (self.chip.mem_bw * self.chip.mem_efficiency))
        coll = 0.0
        per_op = {}
        for op, agg in record.get("collectives", {}).items():
            t = collective_time(op, agg["wire_bytes"],
                                group_size=16, ici=self.ici)
            per_op[op] = t
            coll += t
        onchip = max(compute, memory)
        step = max(onchip, coll) + (1.0 - self.overlap) * min(onchip, coll)
        return StepPrediction(
            compute_s=compute, memory_s=memory, collective_s=coll,
            step_s=step, bound_s=max(compute, memory, coll),
            breakdown=dict(per_op, compute=compute, memory=memory))
