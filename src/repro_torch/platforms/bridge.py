"""DES -> fastsim calibration bridge.

The two backends describe the same machine at different fidelities: the
DES resolves per-message contention on the real topology, while fastsim
folds contention into per-phase bandwidth scales (``bcast_bw_scale``,
``swap_bw_scale``).  This module closes the loop the way Cornebize &
Legrand close it against real machines — treat the higher-fidelity
simulator as the measurement, and gradient-fit the fast model to it:

    fit = fit_fastsim_to_des(get_platform("frontera"))
    fit.platform                 # spec with DES-consistent calibration

``fit_fastsim_params`` differentiates the entire HPL panel recurrence
with respect to the fitted fields (torch autograd), so a handful of small
DES probe runs is enough to pin the contention scales; the fitted values
are baked into the spec's ``calibration`` table so every registry
machine can ship DES-consistent fastsim params.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch._device import DeviceLike, resolve_device

from .spec import Platform

# Small probe grids: big enough that broadcast/swap terms are visible,
# small enough that the DES runs in seconds.  (N, nb, P, Q).
DEFAULT_PROBES: Tuple[Tuple[int, int, int, int], ...] = (
    (1536, 128, 2, 2),
    (2048, 128, 2, 4),
    (2048, 128, 4, 4),
)

DEFAULT_FIT_FIELDS: Tuple[str, ...] = ("bcast_bw_scale", "swap_bw_scale")


@dataclasses.dataclass
class BridgeFit:
    platform: Platform               # spec with fitted calibration baked in
    fit: object                      # the underlying calibrate.FastSimFit
    probes: List[Tuple[object, float]]   # (HPLConfig, DES seconds)
    fields: Tuple[str, ...]

    @property
    def calibration(self) -> dict:
        return {f: float(getattr(self.fit.params, f)) for f in self.fields}


def _no_regions(regions, where: str) -> None:
    if regions is not None:
        raise NotImplementedError(
            f"{where}: representative-region runs (regions=) are not "
            "ported yet (ROADMAP §1, slice 6: scale and TOP500)")


def des_probe_runs(platform: Platform,
                   probe_configs: Optional[Sequence] = None, *,
                   regions=None) -> List[Tuple[object, float]]:
    """Run the DES on small probe configs; returns (cfg, seconds) pairs.

    Probes use ``lookahead=0`` (the DES models the non-overlapped
    schedule) and are clipped to the platform's rank capacity.  The DES
    is pure Python on the host.  ``regions`` (representative-region
    probes) waits for slice 6 of the port and raises.
    """
    from repro_torch.core.apps.hpl import HPLConfig, HPLSim

    _no_regions(regions, "des_probe_runs")
    if probe_configs is None:
        cap = platform.scale.n_ranks
        probe_configs = [HPLConfig(N=n, nb=nb, P=p, Q=q, lookahead=0,
                                   bcast=platform.mpi.bcast)
                         for n, nb, p, q in DEFAULT_PROBES if p * q <= cap]
    if not probe_configs:
        raise ValueError(f"platform {platform.name!r}: no probe config "
                         "fits its rank capacity")
    runs = []
    for cfg in probe_configs:
        res = HPLSim(cfg, platform).run()
        runs.append((cfg, res.time_s))
    return runs


def fit_fastsim_to_des(platform: Platform,
                       probe_configs: Optional[Sequence] = None,
                       fields: Sequence[str] = DEFAULT_FIT_FIELDS,
                       steps: int = 60, lr: float = 0.1,
                       regions=None, *,
                       device: DeviceLike = "cuda") -> BridgeFit:
    """Gradient-fit fastsim's contention scales to DES probe runs.

    Returns a BridgeFit whose ``platform`` carries the fitted values in
    its calibration table — ``platform.fastsim()`` is then
    DES-consistent at probe scale while the compute side of the spec
    stays untouched (only ``fields`` move).  The DES probes run on the
    host; the fit (``fit_fastsim_params``) runs on ``device``, which is
    resolved first, so a missing card raises before any probe runs.
    ``regions`` waits for slice 6 of the port and raises.
    """
    from repro_torch.core.calibrate import fit_fastsim_params

    dev = resolve_device(device)
    _no_regions(regions, "fit_fastsim_to_des")
    runs = des_probe_runs(platform, probe_configs)
    init = dataclasses.replace(platform.fastsim(calibrated=False),
                               lookahead=0.0)
    fit = fit_fastsim_params(runs, init, fields=tuple(fields),
                             steps=steps, lr=lr, device=dev)
    calibration = {f: float(getattr(fit.params, f)) for f in fields}
    return BridgeFit(platform=platform.with_calibration(calibration),
                     fit=fit, probes=runs, fields=tuple(fields))
