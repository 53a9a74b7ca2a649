"""Declarative fault injection for degraded-platform what-ifs.

``FaultSpec`` (pure data, JSON round-trip) describes a scenario;
``FaultRuntime`` injects it into a live DES; ``repro_torch.faults.fastsim``
maps the straggler/bandwidth subset onto the batched closed-form models
as extra sweep axes.

The fastsim mapping is imported lazily (module attribute access) so
DES-only fault runs never pull in the device-side simulators.
"""
from repro_torch.faults.inject import (FAULT_TRACK, FaultRuntime, NULL_FAULTS,
                                       install_faults)
from repro_torch.faults.spec import (FASTSIM_KINDS, FAULT_KINDS, Fault,
                                     FaultSpec, NO_FAULTS, as_fault_spec)

__all__ = [
    "FAULT_KINDS", "FASTSIM_KINDS", "Fault", "FaultSpec", "NO_FAULTS",
    "as_fault_spec", "FaultRuntime", "NULL_FAULTS", "FAULT_TRACK",
    "install_faults", "apply_faults", "fault_params", "sweep_faults",
]

_LAZY = ("apply_faults", "fault_params", "sweep_faults")


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.faults import fastsim
        return getattr(fastsim, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
