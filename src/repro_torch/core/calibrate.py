"""Microbenchmark calibration (paper §III-B1, Fig 2) — plus end-to-end
gradient calibration of the fastsim parameters.

Measures *real* BLAS performance on this host via numpy and fits the
SimBLAS analytical model ``E = mu * ops + theta`` by least squares,
reporting R^2 (the paper reports R^2 = 0.9998 for MKL DGEMM on a
Broadwell core; we run the same protocol on this container's CPU).
Memory-bound Level-1 ops calibrate the effective bandwidth the same way.

``fit_fastsim_params`` goes beyond the paper's per-kernel fits: the
fast simulator takes its parameters as float64 tensors
(``fastsim.simulate_time_traced``), so torch autograd differentiates the
*entire* HPL panel recurrence with respect to them, and measured
full-application runtimes can be fit directly — the
simulation-based-optimization loop of Cornebize & Legrand, with
gradients instead of black-box search.  The measurements above are
numpy on the host (they calibrate the host's BLAS, as in the
reference); only the fit runs on the device.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass
class FitResult:
    mu: float                 # s per flop
    theta: float              # s per call
    r2: float
    points: List[Tuple[float, float]]   # (ops, seconds)

    @property
    def eff_flops(self) -> float:
        return 1.0 / self.mu


def _time_call(fn, min_time: float = 0.05, max_reps: int = 200) -> float:
    fn()  # warmup
    reps, total = 0, 0.0
    t0 = time.perf_counter()
    while total < min_time and reps < max_reps:
        fn()
        reps += 1
        total = time.perf_counter() - t0
    return total / reps


def fit_linear(points: Sequence[Tuple[float, float]]) -> FitResult:
    ops = np.array([p[0] for p in points])
    ts = np.array([p[1] for p in points])
    A = np.stack([ops, np.ones_like(ops)], axis=1)
    (mu, theta), *_ = np.linalg.lstsq(A, ts, rcond=None)
    pred = A @ np.array([mu, theta])
    ss_res = float(np.sum((ts - pred) ** 2))
    ss_tot = float(np.sum((ts - ts.mean()) ** 2))
    r2 = 1.0 - ss_res / max(ss_tot, 1e-30)
    return FitResult(mu=float(mu), theta=float(max(theta, 0.0)), r2=r2,
                     points=list(points))


def measure_dgemm(sizes: Optional[Sequence[int]] = None,
                  min_time: float = 0.05) -> FitResult:
    """Paper Fig 2 protocol: square-ish DGEMMs, m,n,k in [128, 2048]."""
    sizes = sizes or [128, 192, 256, 384, 512, 768, 1024, 1536]
    rng = np.random.default_rng(0)
    points = []
    for m in sizes:
        for k in (m // 2, m):
            a = rng.standard_normal((m, k))
            b = rng.standard_normal((k, m))
            t = _time_call(lambda: a @ b, min_time=min_time)
            ops = 2.0 * m * m * k + 2.0 * m * m
            points.append((ops, t))
    return fit_linear(points)


def measure_stream(n: int = 1 << 24, min_time: float = 0.1) -> float:
    """Effective memory bandwidth (B/s) via a daxpy-like triad."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n)
    y = rng.standard_normal(n)

    def triad():
        y.__iadd__(0.5 * x)        # read x, read/write y
    t = _time_call(triad, min_time=min_time)
    return 8.0 * 3.0 * n / t


def measure_memop(op: str = "swap", n: int = 1 << 22,
                  min_time: float = 0.05) -> Tuple[float, float]:
    """Returns (bytes_touched, seconds) for a Level-1 style op."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n)
    y = rng.standard_normal(n)
    if op == "swap":
        def fn():
            x[:], y[:] = y, np.array(x)
        nbytes = 8.0 * 4.0 * n
    elif op == "scal":
        def fn():
            x.__imul__(1.0000001)
        nbytes = 8.0 * 2.0 * n
    elif op == "copy":
        def fn():
            y[:] = x
        nbytes = 8.0 * 2.0 * n
    else:
        raise ValueError(op)
    t = _time_call(fn, min_time=min_time)
    return nbytes, t


def measure_dger(m: int = 1024, n: int = 128,
                 min_time: float = 0.05) -> float:
    """Effective bandwidth (B/s) of a dger-style rank-1 panel update at
    HPL-panel-like sizes.  Panels are often cache-resident, so this runs
    far above DRAM triad bandwidth — the paper calibrates *per kernel*
    efficiency for exactly this reason (§III-B1)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((m, n))
    x = rng.standard_normal(m)
    y = rng.standard_normal(n)

    def fn():
        A.__isub__(np.outer(x, y))
    t = _time_call(fn, min_time=min_time)
    return 8.0 * (2.0 * m * n + m + n) / t


def measure_small_overhead(min_time: float = 0.05) -> float:
    """Per-call dispatch overhead of a tiny Level-1 op (numpy slicing +
    dispatch; a C BLAS would be ~10x lower — this calibrates OUR
    measurement substrate, exactly the paper's point that mu/theta are
    implementation-dependent)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((256, 64))

    def fn():
        A[1:, 0] /= 1.0000001
        A[1:, 1:4] -= np.outer(A[1:, 0], A[0, 1:4])
    t = _time_call(fn, min_time=min_time)
    return t / 2.0          # two calls per fn


@dataclasses.dataclass
class CalibrationProfile:
    dgemm: FitResult
    mem_bw: float            # effective B/s (DRAM triad)
    panel_bw: float = 0.0    # effective B/s of panel-sized Level-1/2 ops
    theta_mem: float = 2e-6  # per-call overhead of Level-1/2 ops

    def as_dict(self) -> Dict:
        return {"mu": self.dgemm.mu, "theta": self.dgemm.theta,
                "r2": self.dgemm.r2, "eff_flops": self.dgemm.eff_flops,
                "mem_bw": self.mem_bw, "panel_bw": self.panel_bw,
                "theta_mem": self.theta_mem}


def calibrate(quick: bool = False) -> CalibrationProfile:
    sizes = [128, 256, 512, 1024] if quick else None
    return CalibrationProfile(
        dgemm=measure_dgemm(sizes=sizes,
                            min_time=0.02 if quick else 0.05),
        mem_bw=measure_stream(n=1 << 22 if quick else 1 << 24),
        panel_bw=measure_dger(),
        theta_mem=measure_small_overhead())


# ------------------------------------------------- gradient calibration

FASTSIM_FIT_FIELDS = ("gemm_eff", "mem_bw", "link_bw", "theta",
                      "net_latency")


@dataclasses.dataclass
class FastSimFit:
    params: "FastSimParams"          # calibrated parameters
    loss0: float                     # initial mean squared log-time error
    loss: float                      # final
    steps: int
    history: List[float]             # loss per step

    @property
    def improvement(self) -> float:
        return self.loss0 / max(self.loss, 1e-30)


def fit_fastsim_params(runs: Sequence[Tuple["HPLConfig", float]],
                       init: "FastSimParams",
                       fields: Sequence[str] = FASTSIM_FIT_FIELDS,
                       steps: int = 300, lr: float = 0.1, *,
                       device: DeviceLike = "cuda") -> FastSimFit:
    """Fit ``fields`` of a FastSimParams to measured HPL runtimes.

    ``runs`` is a list of ``(HPLConfig, measured_seconds)``.  The loss is
    the mean squared log-time error; parameters are optimized in log
    space (positivity) with Adam.  Each step evaluates every run's panel
    recurrence on ``device`` in float64 and differentiates it with
    autograd (``backward()`` on a float64 leaf); the Adam step is the
    reference's float32 AdamW.
    """
    import torch

    from repro_torch.train.optimizer import adamw_init, adamw_update
    from .fastsim import FastSimParams, simulate_time_traced

    dev = resolve_device(device)
    runs = list(runs)
    fields = tuple(fields)
    base = {n: float(v) for n, v in dataclasses.asdict(init).items()}
    logt_meas = [math.log(t) for _, t in runs]

    def loss_fn(theta):
        over = dict(base)
        for name, v in zip(fields, theta.unbind(0)):
            over[name] = torch.exp(v)
        prm = FastSimParams(**over)
        errs = [torch.log(simulate_time_traced(cfg, prm, device=dev)) - lm
                for (cfg, _), lm in zip(runs, logt_meas)]
        return sum(e * e for e in errs) / len(runs)

    def value_and_grad(theta):
        leaf = theta.detach().requires_grad_(True)
        val = loss_fn(leaf)
        val.backward()
        return val.detach(), leaf.grad

    theta = torch.tensor([math.log(base[f]) for f in fields],
                         dtype=torch.float64, device=dev)
    state = adamw_init([theta])
    history: List[float] = []
    for _ in range(steps):
        val, g = value_and_grad(theta)
        history.append(float(val))
        (theta,), state, _ = adamw_update([theta], [g], state, lr=lr,
                                          b2=0.999, weight_decay=0.0,
                                          max_grad_norm=1e9)
    with torch.no_grad():
        final = float(loss_fn(theta))
    theta = theta.cpu().numpy()

    fitted = dict(base)
    for name, t in zip(fields, theta):
        fitted[name] = float(math.exp(t))
    return FastSimFit(params=FastSimParams(**fitted),
                      loss0=history[0] if history else final,
                      loss=final, steps=steps, history=history)
