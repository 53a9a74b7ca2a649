"""SimBLAS — analytical performance models of BLAS kernels (paper §III-B1).

Level-3 kernels are compute-bound: ``E = mu * ops + theta`` with
``mu = 1 / (peak * efficiency)``; Level-1/2 kernels are bandwidth-bound:
``E = bytes / (bw * eff) + theta``.  BLAS is data-independent, so only
shapes matter — no data is ever touched (this is what makes the matrix-A
elision sound).

``mu`` / ``theta`` come either from the node spec or from a measured
calibration (core/calibrate.py, reproducing the paper's Fig 2 microtest
with R^2 reported).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .hardware.node import NodeModel

# Memoize whole panel-factorization accumulations (see ``panel_fact``).
# Values are bit-identical either way — the cached number is the same
# float the loop would produce — so this is purely a speed knob; the
# reference package's legacy engine (not ported) clears it to reproduce
# the pre-rewrite per-call cost for benchmarking.
PANEL_CACHE = True


@dataclasses.dataclass
class BlasCounters:
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0
    time: float = 0.0


class SimBLAS:
    def __init__(self, node: NodeModel, *, single_core: bool = False,
                 mu: Optional[float] = None, theta: Optional[float] = None,
                 theta_mem: Optional[float] = None):
        self.node = node
        self.single_core = single_core
        peak = node.core_peak if single_core else node.peak_flops
        self.mu = mu if mu is not None else 1.0 / (peak * node.gemm_efficiency)
        self.theta = theta if theta is not None else node.blas_latency
        # Level-1/2 calls have far smaller dispatch overhead than a GEMM
        # (no blocking/packing setup); calibrated separately.
        self.theta_mem = theta_mem if theta_mem is not None \
            else min(self.theta, 2e-6)
        self.counters = BlasCounters()
        self._panel_cache: dict = {}

    # -- helpers ----------------------------------------------------------
    def _compute(self, ops: float) -> float:
        t = self.mu * ops + self.theta
        c = self.counters
        c.calls += 1
        c.flops += ops
        c.time += t
        return t

    def _memory(self, nbytes: float) -> float:
        t = (nbytes / (self.node.mem_bw * self.node.mem_efficiency)
             + self.theta_mem)
        c = self.counters
        c.calls += 1
        c.bytes += nbytes
        c.time += t
        return t

    # -- Level 3 (compute-bound) ------------------------------------------
    def dgemm(self, m: int, n: int, k: int) -> float:
        return self._compute(2.0 * m * n * k + 2.0 * m * n)

    def dtrsm(self, m: int, n: int, side: str = "L") -> float:
        ops = float(m) * m * n if side == "L" else float(n) * n * m
        return self._compute(ops)

    # -- Level 2 (bandwidth-bound) ----------------------------------------
    def dgemv(self, m: int, n: int) -> float:
        return self._memory(8.0 * (m * n + m + n))

    def dger(self, m: int, n: int) -> float:
        # read A, x, y; write A
        return self._memory(8.0 * (2.0 * m * n + m + n))

    # -- Level 1 (bandwidth-bound) ----------------------------------------
    def dswap(self, n: int) -> float:
        return self._memory(8.0 * 4.0 * n)     # paper Fig 3: 4 accesses/elem

    def dscal(self, n: int) -> float:
        return self._memory(8.0 * 2.0 * n)

    def daxpy(self, n: int) -> float:
        return self._memory(8.0 * 3.0 * n)

    def dcopy(self, n: int) -> float:
        return self._memory(8.0 * 2.0 * n)

    def idamax(self, n: int) -> float:
        return self._memory(8.0 * n)

    # -- fused HPL panel factorization (paper §III-C inner loop) ------------
    def panel_fact(self, mloc: int, w: int) -> float:
        """Total BLAS time of one HPL panel factorization: per column j,
        idamax + dscal over the remaining rows and a rank-1 dger update.

        The accumulation order is exactly the unfused per-column loop, so
        the value is bit-identical to calling the three kernels w times —
        which is what lets the result be memoized per (mloc, w) shape
        (shapes repeat across process rows and panels).  When cached, the
        call counters reflect only the first computation of each shape.
        """
        if PANEL_CACHE:
            t = self._panel_cache.get((mloc, w))
            if t is not None:
                return t
        t = 0.0
        for j in range(w):
            mj = mloc - j
            if mj < 1:
                mj = 1
            t += self.idamax(mj)
            t += self.dscal(mj)
            t += self.dger(mj, w - j - 1)
        if PANEL_CACHE:
            self._panel_cache[(mloc, w)] = t
        return t

    # -- HPL auxiliary kernels (paper §III-C: HPL_dlaswp*) ------------------
    def dlaswp(self, rows: int, cols: int) -> float:
        return self._memory(8.0 * 4.0 * rows * cols)

    def dlacpy(self, rows: int, cols: int) -> float:
        return self._memory(8.0 * 2.0 * rows * cols)
