"""Declarative fault injection for degraded-platform what-ifs.

``FaultSpec`` (pure data, JSON round-trip) describes a scenario;
``FaultRuntime`` injects it into a live DES.  The mapping onto the
batched closed-form models (``faults/fastsim.py``: ``apply_faults``,
``fault_params``, ``sweep_faults``) waits for slice 5 of the port
(ROADMAP §1).
"""
from repro_torch.faults.inject import (FAULT_TRACK, FaultRuntime, NULL_FAULTS,
                                       install_faults)
from repro_torch.faults.spec import (FASTSIM_KINDS, FAULT_KINDS, Fault,
                                     FaultSpec, NO_FAULTS, as_fault_spec)

__all__ = [
    "FAULT_KINDS", "FASTSIM_KINDS", "Fault", "FaultSpec", "NO_FAULTS",
    "as_fault_spec", "FaultRuntime", "NULL_FAULTS", "FAULT_TRACK",
    "install_faults",
]
