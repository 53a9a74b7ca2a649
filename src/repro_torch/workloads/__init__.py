"""Workload layer: the App abstraction over any Platform (HPL so far).

    from repro_torch.workloads import get_workload
    from repro_torch.platforms import get_platform

    get_workload("hpl").predict(get_platform("frontera"))   # on the GPU
"""
from .base import (FastModel, Workload, WorkloadSpec, get_workload,
                   list_workloads, register_workload, workload_from_spec)
from .hpl import HPLFastModel, HPLWorkload

__all__ = [
    "FastModel", "Workload", "WorkloadSpec", "get_workload",
    "list_workloads", "register_workload", "workload_from_spec",
    "HPLFastModel", "HPLWorkload",
]
