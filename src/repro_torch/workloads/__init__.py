"""Workload layer: one App abstraction drives HPL *and* transformer
training over any Platform.

    from repro_torch.workloads import get_workload
    from repro_torch.platforms import get_platform

    plat = get_platform("tpu-v5e-pod")
    get_workload("hpl").predict(plat)              # HPL Rmax run, on the GPU
    get_workload("transformer").predict(plat)      # LM train-step time

Every workload offers the same two backends built from the same spec —
``des_app(platform)`` (discrete-event on the host, contention emergent)
and ``fastsim_model(platform)`` (batched sweeps on the device) — and a
JSON-round-trip ``WorkloadSpec`` so scenarios are data, exactly like
``Platform`` specs.
"""
from .base import (FastModel, Workload, WorkloadSpec, get_workload,
                   list_workloads, register_workload, workload_from_spec)
from .hpl import HPLFastModel, HPLWorkload
from .stepsim import (StepParams, simulate_step_fast, step_time_traced,
                      sweep_step, trace_count)
from .transformer import StepFastModel, TransformerWorkload

__all__ = [
    "FastModel", "Workload", "WorkloadSpec", "get_workload",
    "list_workloads", "register_workload", "workload_from_spec",
    "HPLFastModel", "HPLWorkload",
    "StepParams", "simulate_step_fast", "step_time_traced", "sweep_step",
    "trace_count",
    "StepFastModel", "TransformerWorkload",
]
