"""Per-scale contention calibration: region-DES probes at 10^4+ ranks.

The calibration bridge (platforms/bridge.py) fits fastsim's contention
scales against exact DES probes, but exact probes cap near 10^3 ranks —
so fleet predictions at real machine scale would reuse scales fitted at
toy scale and *assume* they transfer.  Representative-region runs
(``repro_torch.scale.region``) make the probe itself cheap at any rank
count, so the scales can be fitted *at* the scale they will be used at,
and the drift between scales measured rather than assumed:

    fit = fit_contention_at_scale(plat, at_ranks=10_000)
    fit.platform.fastsim(at_ranks=10_000)   # scale-specific params

The region probes run on the host; their tails and the gradient fit run
on ``device``.

Fitted overrides land in the spec's per-scale ``contention`` table
(``Platform.with_contention``) with a provenance entry recording the
region geometry that produced them; ``Platform.fastsim(at_ranks=...)``
then applies the nearest (log-space) entry on top of the base
calibration.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch._device import DeviceLike
from repro_torch.core.apps.hpl import HPLConfig

from .region import RegionSpec, as_region


def square_grid(n_ranks: int) -> Tuple[int, int]:
    """The most nearly square (P, Q) factorization with P <= Q."""
    if n_ranks < 1:
        raise ValueError(f"n_ranks={n_ranks} must be >= 1")
    for p in range(int(math.isqrt(n_ranks)), 0, -1):
        if n_ranks % p == 0:
            return p, n_ranks // p
    raise AssertionError("unreachable: 1 divides everything")


def scaled_probe_configs(platform, at_ranks: int, *,
                         region: Optional[RegionSpec] = None,
                         nb: int = 128) -> List[HPLConfig]:
    """HPL probe configs at ``at_ranks`` sized for region runs: a nearly
    square grid, and N chosen so the panel count is a small multiple of
    the region length — enough unsimulated tail that the fitted scales
    see real extrapolation, small enough that the region DES stays
    seconds."""
    if at_ranks > platform.scale.n_ranks:
        raise ValueError(
            f"at_ranks={at_ranks} exceeds platform "
            f"{platform.name!r} capacity ({platform.scale.n_ranks})")
    region = as_region(region)
    P, Q = square_grid(at_ranks)
    return [HPLConfig(N=nb * panels, nb=nb, P=P, Q=Q, lookahead=0,
                      bcast=platform.mpi.bcast)
            for panels in (3 * region.panels, 4 * region.panels)]


@dataclasses.dataclass
class ScaleFit:
    """One per-scale calibration: ``platform`` carries the new
    ``contention`` entry (plus provenance); ``overrides`` is the fitted
    field table for ``at_ranks``."""
    platform: object                    # Platform with the entry baked in
    at_ranks: int
    overrides: Dict[str, float]
    probes: List[Tuple[HPLConfig, float]]
    region: RegionSpec
    fields: Tuple[str, ...]


def fit_contention_at_scale(platform, at_ranks: int, *,
                            region: Optional[RegionSpec] = None,
                            probe_configs: Optional[Sequence] = None,
                            fields: Optional[Sequence[str]] = None,
                            steps: int = 60, lr: float = 0.1,
                            device: DeviceLike = "cuda") -> ScaleFit:
    """Fit fastsim contention scales against region-DES probes run at
    ``at_ranks`` and bake them into the spec's per-scale table (region
    tails and the fit on ``device``)."""
    from repro_torch.platforms.bridge import (DEFAULT_FIT_FIELDS,
                                              fit_fastsim_to_des)

    region = as_region(region)
    fields = tuple(fields) if fields is not None else DEFAULT_FIT_FIELDS
    if probe_configs is None:
        probe_configs = scaled_probe_configs(platform, at_ranks,
                                             region=region)
    fit = fit_fastsim_to_des(platform, probe_configs, fields=fields,
                             steps=steps, lr=lr, regions=region,
                             device=device)
    overrides = fit.calibration
    note = (f"region-fit panels={region.panels} warmup={region.warmup} "
            f"probes={len(fit.probes)} fields={','.join(fields)}")
    plat = platform.with_contention(at_ranks, overrides, note=note)
    return ScaleFit(platform=plat, at_ranks=at_ranks, overrides=overrides,
                    probes=fit.probes, region=region, fields=fields)


def contention_drift(platform, scales: Sequence[int], *,
                     device: DeviceLike = "cuda", **kw
                     ) -> Tuple[object, Dict[int, Dict[str, float]]]:
    """Fit the contention scales at each rank count in ``scales`` and
    return (platform with the full table, {ranks: overrides}) — the
    fitted-scale-vs-rank-count drift the bridge used to assume away."""
    table: Dict[int, Dict[str, float]] = {}
    plat = platform
    for s in scales:
        sf = fit_contention_at_scale(plat, s, device=device, **kw)
        plat = sf.platform
        table[int(s)] = sf.overrides
    return plat, table
