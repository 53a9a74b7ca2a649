"""Straggler detection + mitigation hooks.

Detection: per-step wall times vs a rolling median; a step (or, on a real
multi-host deployment, a host's all-reduce arrival time) slower than
``threshold x median`` flags a straggler.  Mitigation hooks are pluggable:
checkpoint-and-evict, re-shard data away from the slow host, or lower the
synchronization frequency (gradient accumulation).

The simulator closes the loop: ``simulate_straggler_impact`` replays the
step on the DES with a slow chip injected — now expressed as a
``repro_torch.faults.FaultSpec`` scenario, so detection feeds the same
declarative fault layer every backend understands — and reports the
predicted step-time blowup; the operator can decide whether eviction is
worth a restart *before* touching the cluster (paper §V what-if
methodology applied to fault tolerance).  ``simulate_fault_impact`` is
the workload-generic edition: any registered workload, any platform,
any fault scenario, on either backend.  It alone takes ``device``
(the fastsim backend runs there); the rest of this module is host
Python, the DES included.
"""
from __future__ import annotations

import collections
import statistics
from typing import Callable, Dict, List, Optional

from repro_torch._device import DeviceLike, resolve_device


class StepTimeMonitor:
    def __init__(self, window: int = 50, threshold: float = 1.5,
                 warmup: int = 5):
        self.window = window
        self.threshold = threshold
        self.warmup = warmup
        self.times = collections.deque(maxlen=window)
        self.flags: List[int] = []
        self._step = 0
        self.on_straggler: Optional[Callable[[int, float, float], None]] = None

    def record(self, step_time: float) -> bool:
        """Returns True if this step is flagged as straggling."""
        self._step += 1
        flagged = False
        if len(self.times) >= self.warmup:
            med = statistics.median(self.times)
            if step_time > self.threshold * med:
                flagged = True
                self.flags.append(self._step)
                if self.on_straggler:
                    self.on_straggler(self._step, step_time, med)
        self.times.append(step_time)
        return flagged

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0


def simulate_straggler_impact(arch: str, shape: str, mesh: str = "16x16",
                              slowdown: float = 3.0, chip: int = 0) -> Dict:
    """Predicted step-time impact of one slow chip (DES what-if); a thin
    consumer of the declarative fault layer."""
    from repro_torch.core.predict import predict_cell_des
    from repro_torch.faults import FaultSpec
    base = predict_cell_des(arch, shape, mesh)
    slow = predict_cell_des(
        arch, shape, mesh,
        faults=FaultSpec.straggler(rank=chip, slowdown=slowdown))
    return {"baseline_s": base["step_s"], "straggler_s": slow["step_s"],
            "blowup": slow["step_s"] / max(base["step_s"], 1e-12),
            "verdict": ("evict" if slow["step_s"] > 1.3 * base["step_s"]
                        else "tolerate")}


def simulate_fault_impact(workload, platform, faults, *,
                          des: bool = False,
                          evict_threshold: float = 1.3,
                          device: DeviceLike = "cuda") -> Dict:
    """Predicted impact of ANY fault scenario on any registered workload.

    ``workload`` is a kind name or ``Workload`` instance, ``platform`` a
    registry name or spec, ``faults`` anything ``as_fault_spec`` accepts.
    ``des=False`` (default) compares fastsim predictions on ``device`` —
    fine for straggler/bandwidth scenarios; ``des=True`` runs both
    scenarios on the DES on the host, which additionally covers
    fail-stop (the faulted run reports ``failed=True`` and the verdict is
    ``restart``).  ``device`` is resolved first in both modes, so a
    missing card raises before any work.
    """
    from repro_torch.workloads import Workload, get_workload
    dev = resolve_device(device)
    wl = workload if isinstance(workload, Workload) else get_workload(workload)
    if isinstance(platform, str):
        from repro_torch.platforms import get_platform
        platform = get_platform(platform)
    if des:
        base = wl.predict_des(platform)
        faulted = wl.predict_des(platform, faults=faults)
    else:
        base = wl.predict(platform, device=dev)
        faulted = wl.predict(platform, faults=faults, device=dev)
    out = {"baseline_s": base["time_s"], "faulted_s": faulted["time_s"],
           "backend": "des" if des else "fastsim"}
    if faulted.get("failed"):
        out["failed"] = True
        out["n_finished"] = faulted.get("n_finished")
        out["blowup"] = float("inf")
        out["verdict"] = "restart"
    else:
        out["blowup"] = faulted["time_s"] / max(base["time_s"], 1e-12)
        out["verdict"] = ("evict" if out["blowup"] > evict_threshold
                          else "tolerate")
    return out
