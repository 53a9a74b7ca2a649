"""Node (processing element) analytical models.

Paper §III-A1: compute-bound ops cost ``ops / (peak x efficiency)``;
bandwidth-bound ops cost ``bytes / (bw x efficiency)``.  Peak numbers and
efficiencies are *inputs* taken from public specs.  The same form covers
CPU, GPU and TPU chips.

Machine constants live in ``repro_torch.platforms.registry``; the named
factories below (``local_node``, ``frontera_node``, ...) are thin
shims over the registry.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NodeModel:
    name: str
    peak_flops: float            # node peak, FLOP/s (at sustained AVX/MXU clock)
    mem_bw: float                # B/s
    cores: int = 1
    gemm_efficiency: float = 0.92
    mem_efficiency: float = 0.80
    blas_latency: float = 2e-7   # theta: per-call overhead (s)
    # accelerator section (paper's CPU-GPGPU heterogeneous extension)
    accel_peak_flops: float = 0.0
    accel_mem_bw: float = 0.0
    accel_efficiency: float = 0.75

    @property
    def core_peak(self) -> float:
        return self.peak_flops / max(self.cores, 1)

    def gemm_time(self, ops: float, single_core: bool = False) -> float:
        peak = self.core_peak if single_core else self.peak_flops
        return ops / (peak * self.gemm_efficiency) + self.blas_latency

    def mem_time(self, nbytes: float) -> float:
        return nbytes / (self.mem_bw * self.mem_efficiency) + self.blas_latency


# --- registry-backed shims ---------------------------------------------------

def node_from_spec(spec) -> NodeModel:
    """NodeSpec -> NodeModel (platforms.build.build_node delegates here)."""
    return NodeModel(name=spec.name, peak_flops=spec.peak_flops,
                     mem_bw=spec.mem_bw, cores=spec.cores,
                     gemm_efficiency=spec.gemm_efficiency,
                     mem_efficiency=spec.mem_efficiency,
                     blas_latency=spec.blas_latency,
                     accel_peak_flops=spec.accel_peak_flops,
                     accel_mem_bw=spec.accel_mem_bw,
                     accel_efficiency=spec.accel_efficiency)


def _registry_node(platform_name: str) -> NodeModel:
    # resolved lazily: the registry imports nothing of core, so this
    # works whichever package is imported first
    from repro_torch.platforms.registry import get_platform
    return node_from_spec(get_platform(platform_name).node)


def local_node() -> NodeModel:
    """Paper Table I local Broadwell machine (registry: bdw-local)."""
    return _registry_node("bdw-local")


def frontera_node() -> NodeModel:
    """Frontera's CLX-8280 node (registry: frontera)."""
    return _registry_node("frontera")


def pupmaya_node() -> NodeModel:
    """PupMaya's SKX-6148 node (registry: pupmaya)."""
    return _registry_node("pupmaya")


def __getattr__(name):
    # TPU_V5E stays importable as a constant; resolved (and cached) from
    # the registry on first access so the numbers live in one place.
    if name == "TPU_V5E":
        value = _registry_node("tpu-v5e-pod")
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
