"""Representative-region simulation: exact DES on one region, analytic
replication of the rest.

Ferrerón et al. ("Crossing the Architectural Barrier", PAPERS.md) show
that simulating one representative region of an iterative parallel code
exactly and replicating the remaining iterations analytically preserves
accuracy at a fraction of the cost.  Cornebize & Legrand ("Variability
Matters") motivate why the closed forms that replace the replicated
iterations must be *calibrated from the simulated region* rather than
assumed.  This module applies both ideas to the two DES applications:

  * **HPL** (``RegionHPLSim``): the first ``RegionSpec.panels`` panels of
    the right-looking LU run on the real DES (every flow, every
    contention event).  The unsimulated tail exploits LU's self-similar
    structure: the remaining panels of an ``N`` x ``N`` problem ARE a
    complete ``N - R*nb`` problem on the same grid, so the closed-form
    panel recurrence (``core.fastsim``) prices the tail with the full
    pipeline/shape arithmetic intact, and the region calibrates one
    scalar —

        s  =  (mark[R-1] - mark[W-1]) / (That(W) - That(R))

    the DES-over-closed-form time ratio on the post-warmup window
    (``That(k)`` = fastsim time of the trailing subproblem starting at
    panel ``k``).  ``time = mark[R-1] + s * That(R)``.  A scalar is the
    right amount of freedom: per-panel regressions on the region are
    ill-posed (block-cyclic features are constant within a window
    shorter than ``P`` panels), while ``s`` only asks the region "how
    much slower is the contended DES than the analytic model", which is
    exactly what a dozen panels can answer.  Without a ``Platform``
    (raw node/topology construction) there is no fastsim surface and a
    sign-constrained least-squares fit of per-panel durations against
    exact-shape features (``d_k ~= a*comp_k + b*bytes_k + c*w_k + e``)
    takes over — good on modest grids, documented weaker on large ones.

  * **transformer** (``RegionStepSim``): layers are homogeneous, so the
    first ``panels`` layers (plus the real tail collectives) run exactly
    and the steady-state per-layer delta — read from the layer-boundary
    marks — replicates the rest.

Both are exposed through the ``Workload`` protocol as
``des_app(platform, regions=...)`` / ``predict_des(..., regions=...)``;
results are stamped ``region_approx`` so downstream consumers (the
serving layer's breakdown endpoint, the calibration bridge) can tell an
extrapolated answer from an exact one.

This is the port of ``repro.scale.region``.  The region prefix is the
port's DES, host Python and bit-identical to the reference's; the HPL
tail is priced by the port's ``simulate_hpl_fast`` on ``device``; the
feature-fit fallback stays a numpy least-squares fit over a handful of
rows on the host, exactly as the reference does it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Union

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.apps.hpl import HPLConfig, HPLResult, HPLSim, numroc
from repro_torch.core.apps.transformer import (StepWorkload,
                                               TransformerStepSim)
from repro_torch.core.simblas import SimBLAS


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """How much of the iteration space to simulate exactly.

    ``panels`` is the region length in iterations (HPL panels /
    transformer layers); ``warmup`` leading iterations are excluded from
    the fit window (pipeline fill distorts them).
    """
    panels: int = 12
    warmup: int = 2

    def __post_init__(self):
        if self.warmup < 1:
            raise ValueError(f"RegionSpec: warmup={self.warmup} must be "
                             ">= 1")
        if self.panels < self.warmup + 4:
            raise ValueError(
                f"RegionSpec: panels={self.panels} must be >= warmup + 4 "
                f"(need a usable fit window, warmup={self.warmup})")


Regions = Union[None, int, RegionSpec]


def as_region(regions: Regions) -> RegionSpec:
    """Normalize the ``regions=`` argument: an int is a region length."""
    if regions is None:
        return RegionSpec()
    if isinstance(regions, RegionSpec):
        return regions
    if isinstance(regions, bool):
        raise TypeError("regions must be an int or RegionSpec")
    if isinstance(regions, int):
        return RegionSpec(panels=regions)
    raise TypeError(f"regions must be None, int, or RegionSpec, got "
                    f"{type(regions).__name__}")


# --------------------------------------------------------------- HPL
def _panel_features(cfg: HPLConfig, blas: SimBLAS) -> List[List[float]]:
    """Per-panel closed-form features [comp_s, wire_bytes, w, 1] from
    exact numroc shape arithmetic — no DES, no data.

    ``comp_s`` is the critical-rank BLAS time of panel k (factorization
    + dtrsm + dgemm + dlaswp on the max local shapes); ``wire_bytes``
    the panel-broadcast pipeline plus U-strip swap volume; ``w`` carries
    the per-column latency terms (pivot allreduces).  The linear fit
    against the simulated region absorbs overlap/contention scaling.
    """
    N, nb, P, Q = cfg.N, cfg.nb, cfg.P, cfg.Q
    rows: List[List[float]] = []
    for k in range(cfg.n_panels):
        rem = N - k * nb
        w = min(nb, rem)
        pk = k % P
        mloc = max(numroc(rem, nb, (p - pk) % P, P) for p in range(P))
        nloc = max(numroc(max(rem - w, 0), nb, (q - (k + 1) % Q) % Q, Q)
                   for q in range(Q))
        comp = blas.panel_fact(mloc, w)
        nbytes = 0.0
        if Q > 1:
            nbytes += 8.0 * (mloc + w) * w          # panel broadcast
        if P > 1 and nloc > 0:
            nbytes += 8.0 * w * nloc                # U-strip swap rounds
            comp += blas.dlaswp(w, max(nloc, 1))
        if nloc > 0:
            comp += blas.dtrsm(w, nloc)
            if mloc > 0:
                comp += blas.dgemm(mloc, nloc, w)
        rows.append([comp, nbytes, float(w), 1.0])
    return rows


def _nnls(A, b):
    """Exact non-negative least squares by exhaustive support search
    (A has <= 4 columns, so <= 16 candidate supports).  Deterministic,
    no dependency beyond numpy."""
    import itertools

    import numpy as np

    m, n = A.shape
    best_r, best_th = np.inf, np.zeros(n)
    for r in range(n + 1):
        for sup in itertools.combinations(range(n), r):
            th = np.zeros(n)
            if sup:
                cols = list(sup)
                sol, *_ = np.linalg.lstsq(A[:, cols], b, rcond=None)
                if (sol < 0.0).any():
                    continue
                th[cols] = sol
            resid = float(((A @ th - b) ** 2).sum())
            if resid < best_r - 1e-18:
                best_r, best_th = resid, th
    return best_th


def _fit_tail(features: List[List[float]], durations: List[float],
              fit_lo: int, tail_lo: int) -> float:
    """Fit d_k ~= X_k . theta on panels [fit_lo, tail_lo) and return the
    predicted total duration of panels [tail_lo, end).

    Columns are max-normalized before the solve (comp is ~1e-2 s while
    bytes is ~1e6) and coefficients are sign-constrained: every feature
    is a cost, so negative weights are physically meaningless — and on
    long-tail extrapolation an unconstrained min-norm solution happily
    trades a negative bytes slope against a large constant inside the
    window, then explodes outside it."""
    import numpy as np

    X = np.asarray(features, dtype=float)
    d = np.asarray(durations, dtype=float)
    scale = np.abs(X[fit_lo:tail_lo]).max(axis=0)
    scale[scale == 0.0] = 1.0
    theta = _nnls(X[fit_lo:tail_lo] / scale, d[fit_lo:tail_lo])
    pred = (X[tail_lo:] / scale) @ theta
    return float(np.clip(pred, 0.0, None).sum())


def _closed_form_tail(cfg: HPLConfig, platform, marks: Dict[int, float],
                      region: RegionSpec, device) -> float:
    """Price panels [R, end) with the fastsim recurrence, calibrated by
    the region: the tail of HPL at panel ``k`` is itself a complete
    ``(N - k*nb)`` problem on the same grid, so ``That(k)`` (closed-form
    time of that subproblem, at the DES's lookahead) prices any suffix.
    One scalar ``s`` — DES seconds per closed-form second on the
    post-warmup window [W, R) — absorbs contention and rendezvous
    overheads the analytic model folds away.  The recurrence runs on
    ``device``."""
    from repro_torch.core.fastsim import simulate_hpl_fast

    prm = dataclasses.replace(platform.fastsim(),
                              lookahead=float(cfg.lookahead))

    def t_hat(k: int) -> float:
        n = cfg.N - k * cfg.nb
        if n <= 0:
            return 0.0
        return simulate_hpl_fast(dataclasses.replace(cfg, N=n), prm,
                                 device=device)["time_s"]

    R, W = region.panels, region.warmup
    denom = t_hat(W) - t_hat(R)
    s = (marks[R - 1] - marks[W - 1]) / denom if denom > 0.0 else 1.0
    if not (s > 0.0):                   # degenerate window; trust the form
        s = 1.0
    return s * t_hat(R)


class RegionHPLSim:
    """HPL with only a representative prefix of panels simulated.

    Drop-in for ``HPLSim`` (same constructor forms — Platform, DESStack,
    or (node, topology) — plus ``region=``): ``run()`` returns an
    ``HPLResult`` whose ``time_s`` extrapolates the unsimulated panels
    from the region-calibrated closed form, stamped
    ``region_approx=True``.  Built from a ``Platform`` the tail is
    priced by the fastsim recurrence on ``device`` (the accurate path —
    see module docstring; the device is resolved here, so a missing card
    raises before the DES runs); otherwise the feature fit takes over on
    the host.  When the config has no more panels than the region, the
    exact DES runs and the result is returned unchanged.
    """

    def __init__(self, cfg: HPLConfig, node, topology=None, *,
                 region: Regions = None, device: DeviceLike = "cuda",
                 **hpl_kw):
        self.cfg = cfg
        self.region = as_region(region)
        self._platform = (node if topology is None
                          and hasattr(node, "fastsim") else None)
        self._truncated = cfg.n_panels > self.region.panels
        self._device = (resolve_device(device) if self._truncated
                        and self._platform is not None else None)
        self._marks: Dict[int, float] = {}
        if self._truncated:
            hpl_kw.setdefault("max_panels", self.region.panels)
            hpl_kw.setdefault("panel_marks", self._marks)
        self.sim = HPLSim(cfg, node, topology, **hpl_kw)

    @property
    def engine(self):
        return self.sim.engine

    @property
    def trace(self):
        return self.sim.trace

    def run(self) -> HPLResult:
        res = self.sim.run()
        if not self._truncated or res.failed:
            # exact run, or a fail-stop stranded the region — nothing
            # sound to extrapolate from
            return res
        R = self.region.panels
        marks = self._marks
        if self._platform is not None:
            tail = _closed_form_tail(self.cfg, self._platform, marks,
                                     self.region, self._device)
        else:
            durations = [marks.get(0, 0.0)]
            for k in range(1, R):
                durations.append(marks.get(k, 0.0) - marks.get(k - 1, 0.0))
            feats = _panel_features(self.cfg,
                                    SimBLAS(self.sim.blas[0].node))
            tail = _fit_tail(feats, durations + [0.0] * (len(feats) - R),
                             fit_lo=self.region.warmup, tail_lo=R)
        t = marks[R - 1] + tail
        return HPLResult(
            time_s=t, gflops=self.cfg.flops() / t / 1e9,
            events=res.events, trace=res.trace,
            region_approx=True, region_panels=R)


# ------------------------------------------------------- transformer
class RegionStepSim:
    """Transformer step with only ``region.panels`` layers simulated.

    ``build(truncated_workload, layer_marks)`` constructs the inner
    ``TransformerStepSim`` (the workload layer binds platform/mesh/trace
    there).  Layers are homogeneous by construction, so the steady-state
    per-layer delta — the last two layer-boundary marks — replicates the
    unsimulated layers; the tail collectives (whose wire bytes scale
    with the FULL layer count) run exactly inside the region.
    """

    def __init__(self, workload: StepWorkload, region: Regions,
                 build: Callable[[StepWorkload, Optional[Dict[int, float]]],
                                 TransformerStepSim]):
        self.region = as_region(region)
        self.n_layers = len(workload.layers)
        self._truncated = self.n_layers > self.region.panels
        self._marks: Optional[Dict[int, float]] = None
        if self._truncated:
            self._marks = {}
            workload = StepWorkload(
                layers=workload.layers[:self.region.panels],
                tail_collectives=workload.tail_collectives,
                tail_compute_s=workload.tail_compute_s)
        self.sim = build(workload, self._marks)

    @property
    def engine(self):
        return self.sim.engine

    @property
    def trace(self):
        return self.sim.trace

    def run(self) -> Dict:
        res = self.sim.run()
        if not self._truncated or res.get("failed"):
            return res
        R = self.region.panels
        marks = self._marks
        delta = marks[R - 1] - marks[R - 2]
        out = dict(res)
        t = res["step_s"] + (self.n_layers - R) * max(delta, 0.0)
        out["step_s"] = t
        out["region_step_s"] = res["step_s"]
        out["region_approx"] = True
        out["layers_simulated"] = R
        out["layers_total"] = self.n_layers
        return out
