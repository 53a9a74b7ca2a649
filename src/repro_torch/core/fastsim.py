"""fastsim — the HPL simulator as a float64 torch program.

The per-panel timing recurrence is a max-plus system over the P x Q grid:

  fact_k(p)        panel factorization on owning column (SimBLAS closed forms)
  arrival_k(p,q)   1-ring store&forward broadcast = prefix-max along the row
                   ring: a_i = hop*i + cummax_j<=i (d_j - hop*j)
  T_{k+1}(p,q)     = max(T_k, arrival, colmax(arrival)) + swap + update

This is the port of ``repro.core.fastsim``.  The recurrence runs as plain
torch ops in float64/int64 on ``device`` (eagerly: the panel loop is a
Python loop of ``n_panels_max`` iterations, each of which launches about
180 small kernels on a GPU).  Every per-element expression keeps the
reference's operation order, so results agree with it to rounding.

Shapes follow the reference's sweep engine: grids are padded to a shape
bucket ``(n_panels_max, P_max, Q_max)``, and the recurrence carries a
*trailing* scenario (lane) axis.  Geometry ``(N, nb, P, Q)`` is a ``(G,)``
int64 tensor per field and params are ``(B,)`` float64 tensors, with
``G == 1`` (one geometry shared by every lane: single runs and hardware
what-if grids) or ``G == B`` (one geometry per lane: mixed-config sweeps,
where the reference uses ``jax.vmap``).  Gradients flow through the whole
recurrence under autograd (``simulate_time_traced``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as tnf

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.obs.metrics import RATIO_BUCKETS, get_global_metrics

from .apps.hpl import HPLConfig
from .hardware.node import NodeModel

F64 = torch.float64
I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class FastSimParams:
    # node
    peak_flops: float            # per rank
    gemm_eff: float
    mem_bw: float                # per rank, effective
    theta: float                 # per-BLAS-call overhead
    # network
    link_bw: float               # per-NIC bytes/s
    net_latency: float           # per-message software+wire latency
    hop_latency: float = 90e-9
    bcast_bw_scale: float = 1.0  # contention scale on panel broadcast
    swap_bw_scale: float = 1.0   # contention scale on row swaps
    lookahead: float = 1.0       # HPL lookahead depth (1 = overlap panel)

    @staticmethod
    def from_node(node: NodeModel, *, link_bw: float,
                  ranks_per_node: int = 1, net_latency: float = 2e-6,
                  **kw) -> "FastSimParams":
        return FastSimParams(
            peak_flops=node.peak_flops / ranks_per_node,
            gemm_eff=node.gemm_efficiency,
            mem_bw=node.mem_bw * node.mem_efficiency / ranks_per_node,
            theta=node.blas_latency,
            link_bw=link_bw, net_latency=net_latency, **kw)


_PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(FastSimParams))


# ------------------------------------------------------------- bucketing
def _bucket(n: int) -> int:
    """Smallest b >= n of the form 2^k or 3*2^(k-1) (<= 1.5x padding)."""
    n = max(int(n), 1)
    p = 1 << (n - 1).bit_length()
    if p >= 4 and 3 * p // 4 >= n:
        return 3 * p // 4
    return p


def bucket_key(cfg: HPLConfig) -> Tuple[int, int, int]:
    """(n_panels_max, P_max, Q_max) shape-bucket key for a config."""
    return (_bucket(cfg.n_panels), _bucket(cfg.P), _bucket(cfg.Q))


class _Tables(NamedTuple):
    """Per-bucket constants on the device."""
    ar2: torch.Tensor    # (P_max+1,) 2*ceil(log2(max(p, 2)))
    swr: torch.Tensor    # (P_max+1,) swap rounds max(ceil(log2 p), 1), 0 at p=1
    ip: torch.Tensor     # arange(P_max) int64
    iq: torch.Tensor     # arange(Q_max) int64
    iqf: torch.Tensor    # arange(Q_max) float64


def _tables(P_max: int, Q_max: int, device: torch.device) -> _Tables:
    # exact ceil-log2 via lookup tables built on the host (float log2 can
    # be off by one ulp at powers of two, which would flip a whole
    # latency round)
    ar2 = torch.tensor([2.0 * math.ceil(math.log2(max(p, 2)))
                        for p in range(P_max + 1)], dtype=F64, device=device)
    swr = torch.tensor([float(max(math.ceil(math.log2(p)), 1)) if p > 1
                        else 0.0 for p in range(P_max + 1)],
                       dtype=F64, device=device)
    iq = torch.arange(Q_max, dtype=I64, device=device)
    return _Tables(ar2, swr, torch.arange(P_max, dtype=I64, device=device),
                   iq, iq.to(F64))


# ------------------------------------------------------------------ core
def _sim_core(N, nb, P, Q, prm: FastSimParams,
              n_panels_max: int, P_max: int, Q_max: int, tb: _Tables):
    """HPL panel recurrence over a shape bucket.

    ``N, nb, P, Q`` are ``(G,)`` int64 tensors and ``prm`` leaves ``(B,)``
    float64 tensors, ``G`` in ``{1, B}``; returns the ``(B,)`` simulated
    times.  Grid state is ``(P_max, Q_max, B)``; rows p >= P, columns
    q >= Q and panels k >= ceil(N/nb) are padding, masked so they never
    touch live lanes (the ring re-base maps padding columns to
    themselves, the column-sync max and the final max are mask-reduced,
    and the carry freezes once k reaches the live panel count).  Every
    geometry-derived quantity carries the geometry axis last, so it
    broadcasts against the lane axis.
    """
    peak = prm.peak_flops * prm.gemm_eff                 # (B,)
    mem_bw = prm.mem_bw
    theta = prm.theta
    alpha = prm.net_latency
    bcast_bw = prm.link_bw * prm.bcast_bw_scale
    swap_bw = prm.link_bw * prm.swap_bw_scale
    lookahead = prm.lookahead
    B = peak.shape[0]

    ar_lat = tb.ar2[P] * alpha                           # (B,)
    sw_rounds = tb.swr[P]                                # (G,)

    row_on = tb.ip[:, None] < P                          # (P_max, G)
    col_on = tb.iq[:, None] < Q                          # (Q_max, G)
    active = row_on[:, None, :] & col_on[None, :, :]     # (P_max, Q_max, G)
    # ceil: a trailing N % nb panel is simulated at its true width
    n_panels = torch.div(N + nb - 1, nb, rounding_mode="floor")

    def width(rem):
        """Panel width: nb except on the trailing partial panel (and 0 on
        padding iterations past the live panel count)."""
        return torch.clamp(torch.minimum(nb, rem), min=0)

    def numroc_vec(rem, shift, nprocs, idx):
        """Vectorized NUMROC for procs ``idx`` with owner shift -> (size, G).
        ``rem`` goes negative past the live panel count, so ``//`` and
        ``%`` must floor (Python semantics), as in the reference."""
        ip = torch.remainder(idx[:, None] - shift, nprocs)
        nblocks = torch.div(rem, nb, rounding_mode="floor")
        base = torch.div(nblocks, nprocs, rounding_mode="floor") * nb
        extra = torch.remainder(nblocks, nprocs)
        return (base + torch.where(
            ip < extra, nb,
            torch.where(ip == extra, torch.remainder(rem, nb), 0))
        ).to(F64)

    def fact_time(k):
        """Panel-k factorization cost per row rank (SimBLAS closed forms):
        dger/dscal/idamax are Level-1/2 memory-bound.  Returns (P_max, B)."""
        rem = N - k * nb
        wf = width(rem).to(F64)
        mloc = numroc_vec(rem, torch.remainder(k, P), P, tb.ip)
        pf_bytes = 8.0 * (torch.clamp(mloc * wf * wf - wf * wf * wf / 3.0,
                                      min=0.0)
                          + 3.0 * mloc * wf)
        return pf_bytes / mem_bw + wf * (3 * theta) + wf * ar_lat

    # The T carry lives in *ring-order* space: stored column i holds the
    # absolute column (qk + i) % Q, so the broadcast root is always index
    # 0 and the prefix-max chain never gathers.  Each panel advances the
    # ring by one column, so re-basing the carry for the next panel is a
    # static roll plus two selects; padding columns map to themselves.
    #
    # ord-space NUMROC is panel-invariant: stored column i belongs to
    # proc (i - 1) % Q of the *next* panel's distribution, every panel.
    # bucket(1) == 1, so Q_max > 1 implies Q >= 2: the ord index of
    # column (k+1) % Q — i.e. 1 % Q — is static.
    idx1 = 1 if Q_max > 1 else 0

    def cummax_cols(x):
        """Inclusive prefix-max along axis 1 (Kogge-Stone shift-max: on a
        tie ``torch.maximum`` splits the gradient evenly, as JAX does,
        where ``torch.cummax`` would not)."""
        s = 1
        while s < Q_max:
            shifted = tnf.pad(x[:, :-s, :], (0, 0, s, 0), value=-math.inf)
            x = torch.maximum(x, shifted)
            s *= 2
        return x

    def ring_rebase(T):
        """Stored col i <- stored col (i+1)%Q on live cols, identity on
        padding: one static roll plus two selects."""
        if Q_max == 1:
            return T
        roll = torch.cat([T[:, 1:, :], T[:, :1, :]], dim=1)
        qcol = tb.iq[None, :, None]
        return torch.where(qcol < Q - 1, roll,
                           torch.where(qcol == Q - 1, T[:, :1, :], T))

    def step(k, T, fact_done):
        rem = N - k * nb
        w = width(rem)
        wf = w.to(F64)                                             # (G,)
        mloc = numroc_vec(rem, torch.remainder(k, P), P, tb.ip)    # (P_max, G)
        nloc = numroc_vec(torch.clamp(rem - w, min=0), 1, Q,
                          tb.iq)                                   # (Q_max, G) ord

        # 2. 1-ring broadcast along each row: prefix-max recurrence.
        # fact_done was computed in the previous iteration (lookahead).
        panel_bytes = 8.0 * (mloc + wf) * wf                       # (P_max, G)
        hop = alpha + panel_bytes / bcast_bw                       # (P_max, B)
        hi = hop[:, None, :] * tb.iqf[None, :, None]               # (P, Q, B)
        root = fact_done[:, None, :]
        # chain readiness; out of place (not an indexed write) so autograd
        # sees every step
        d = torch.cat([root, (T - hi)[:, 1:, :]], dim=1)
        a = hi + cummax_cols(d)
        arrival = torch.cat([root, a[:, 1:, :]], dim=1)            # root holds panel

        # 3. row swaps: column ranks exchange the U strip (sync on colmax)
        # 4. update: dtrsm + dgemm on the local tile
        u_bytes = 8.0 * wf * nloc                                  # (Q_max, G)
        trsm = wf * wf * nloc / peak + theta                       # (Q_max, B)
        m2n = 2.0 * mloc[:, None, :] * nloc[None, :, :]            # (P, Q, G)
        gemm = (m2n * wf + m2n) / peak + theta                     # (P, Q, B)
        if P_max > 1:                    # P > 1 exactly (bucket(1) == 1)
            swap = torch.where(
                u_bytes > 0,
                sw_rounds * (alpha + (u_bytes / torch.clamp(sw_rounds,
                                                            min=1.0))
                             / swap_bw)
                + 4.0 * 8.0 * wf * nloc / mem_bw,
                0.0)                                               # (Q_max, B)
            # column sync: every rank of a column proceeds from the
            # column max, so after_swap is row-independent.  amax splits
            # a tie's gradient evenly, as JAX's max does.
            colmax = torch.where(row_on[:, None, :],
                                 torch.maximum(arrival, T),
                                 -math.inf).amax(dim=0)            # (Q_max, B)
            after_swap = colmax + swap                             # (Q_max, B)
            T_new = (after_swap + trsm)[None, :, :] + gemm
            as_next = after_swap[idx1]                             # (B,)
        else:
            after_swap = torch.maximum(arrival, T)                 # (1, Q, B)
            T_new = after_swap + trsm[None, :, :] + gemm
            as_next = after_swap[:, idx1, :]                       # (1, B)

        # 1'. (lookahead) factor panel k+1 on its owning column, anchored
        # right after that column updates just the next panel's columns.
        mloc_n = numroc_vec(torch.clamp(rem - nb, min=0),
                            torch.remainder(k + 1, P), P, tb.ip)
        w_next = width(rem - nb).to(F64)
        gemm_nb = 2.0 * mloc_n * w_next * wf / peak + theta        # (P_max, B)
        ft = fact_time(k + 1)
        fact_next_overlap = as_next + gemm_nb + ft
        fact_next_serial = T_new[:, idx1, :] + ft
        fact_next = (lookahead * torch.minimum(fact_next_overlap,
                                               fact_next_serial)
                     + (1.0 - lookahead) * fact_next_serial)
        return T_new, fact_next

    T = torch.zeros((P_max, Q_max, B), dtype=F64, device=peak.device)
    F = fact_time(0)                     # panel 0: nothing to overlap with
    for k in range(n_panels_max):
        T2, F2 = step(k, T, F)
        live = k < n_panels                                        # (G,)
        # freeze once past the live panel count, then re-base the ring
        # (frozen values keep rotating with qk to stay column-stable; the
        # final masked max is invariant under the live-column cycle)
        T = ring_rebase(torch.where(live, T2, T))
        F = torch.where(live, F2, F)
    total = torch.where(active, T, -math.inf).amax(dim=(0, 1))     # (B,)
    # back substitution: ~2 N^2 flops + N broadcasts (minor).  Geometry
    # goes to float64 first: int64 times a Python float would give
    # float32 in torch.
    Nf, nbf, Pf, Qf = (x.to(F64) for x in (N, nb, P, Q))
    return total + 2.0 * Nf * Nf / (peak * Pf * Qf) + Nf / nbf * alpha


# ------------------------------------------------------- lane sharding
# Device-sharded batch dispatch: the sweep engine's trailing scenario
# axis is embarrassingly parallel (every lane is an independent
# recurrence), so when more than one local device is available the
# padded lane axis can be split across them, one contiguous block of
# lanes per device, with the results concatenated in lane order.  Off by
# default; the single-device (or indivisible-batch) fallback takes the
# exact unsharded path with the same tensors, so results are bitwise-
# identical to an unsharded dispatch by construction.
#
# Unlike the reference's one SPMD program, the split here is serial on
# the host: one thread issues every block's panel loop in turn (all of
# them before the first result is copied back, so the cards run
# alongside each other), and the loop is bound by host dispatch, not by
# the card.  k cards therefore cost about k times the host wall of one
# and cannot speed up a sweep; the switch exists for parity with the
# reference's API, not as a throughput option.
_LANE_SHARDING = False


def set_lane_sharding(enabled: bool) -> bool:
    """Enable/disable device-sharded sweep dispatch; returns the
    previous setting (for restoration)."""
    global _LANE_SHARDING
    prev = _LANE_SHARDING
    _LANE_SHARDING = bool(enabled)
    return prev


@contextlib.contextmanager
def lane_sharding(enabled: bool = True):
    """Scoped ``set_lane_sharding`` — the serving layer wraps a wave's
    family dispatches in this context when ``shard=True``."""
    prev = set_lane_sharding(enabled)
    try:
        yield
    finally:
        set_lane_sharding(prev)


def _local_devices(device: torch.device) -> List[torch.device]:
    """The devices a sharded dispatch from ``device`` may split over:
    every CUDA device for a CUDA device, the one CPU otherwise."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def shard_device_count(device: DeviceLike = "cuda") -> int:
    """How many local devices a sharded dispatch would split over:
    ``torch.cuda.device_count()`` for a CUDA device, 1 for the CPU."""
    return len(_local_devices(torch.device(device)))


def _shard_lanes(n_lanes: int, device: torch.device,
                 devices: Optional[Sequence[torch.device]] = None
                 ) -> Optional[List[torch.device]]:
    """The devices ``n_lanes`` padded lanes split over, one contiguous
    block each, or None for the unsharded path: sharding off, one
    device, or a lane count the device count does not divide.
    ``devices`` overrides the local device list (a CPU test passes
    ``[cpu] * 4``)."""
    if not _LANE_SHARDING:
        return None
    devs = list(devices) if devices is not None else _local_devices(device)
    if len(devs) <= 1 or n_lanes % len(devs):
        return None
    return devs


def _record_shard(m, devices: Optional[Sequence[torch.device]],
                  prefix: str = "fastsim") -> None:
    if m.enabled and devices is not None:
        m.counter(f"{prefix}.sharded_dispatches").inc()
        m.gauge(f"{prefix}.shard_devices").set(len(devices))


# ----------------------------------------------------------- bucket cache
# The reference jit-compiles one program per bucket and retraces it for
# each new padded lane count.  The port keeps one program per (bucket,
# mode, device) and counts each (bucket, mode, padded lane count, device)
# shape it dispatches, so the compile counter moves where the
# reference's does.
_SHAPES_SEEN: set = set()


def trace_count() -> int:
    """How many distinct (bucket, mode, padded lane count, device) shapes
    the bucket programs have been dispatched at — the port's stand-in for
    the reference's (re)trace count, for cache-hit assertions in tests and
    benchmarks."""
    return len(_SHAPES_SEEN)


@functools.lru_cache(maxsize=128)
def _compiled(n_panels_max: int, P_max: int, Q_max: int, mode: str,
              device: str):
    """The program for one shape bucket on one device.  mode: 'single'
    (one scenario) | 'params' (shared geometry, (B,) params — the
    trailing-batch fast path for what-if grids) | 'batch' (per-lane
    geometry and params for mixed-config sweeps)."""
    tb = _tables(P_max, Q_max, torch.device(device))

    def fn(N, nb, P, Q, prm):
        return _sim_core(N, nb, P, Q, prm, n_panels_max, P_max, Q_max, tb)
    return fn


def _record_dispatch(m, key: Tuple[int, int, int], pre_traces: int,
                     dt: float, live: int, lanes: int) -> None:
    """One bucket-program dispatch into the global metrics registry:
    cache hit/miss (and build wall) per shape bucket, plus sweep-lane
    occupancy — padding lanes are pure waste, so the ratio is the sweep
    engine's utilization number."""
    bucket = "x".join(str(b) for b in key)
    misses = trace_count() - pre_traces
    if misses:
        m.counter("fastsim.compile_misses", bucket=bucket).inc(misses)
        m.histogram("fastsim.compile_wall_s", bucket=bucket).observe(dt)
    else:
        m.counter("fastsim.compile_hits", bucket=bucket).inc()
        m.histogram("fastsim.dispatch_wall_s").observe(dt)
    m.counter("fastsim.lanes_live").inc(live)
    m.counter("fastsim.lanes_padded").inc(lanes - live)
    m.histogram("fastsim.sweep_occupancy", RATIO_BUCKETS).observe(
        live / lanes)


def _geometry(cfgs: Sequence[HPLConfig], device: torch.device):
    """(N, nb, P, Q) as four (len(cfgs),) int64 tensors on ``device``."""
    return torch.tensor([[c.N for c in cfgs], [c.nb for c in cfgs],
                         [c.P for c in cfgs], [c.Q for c in cfgs]],
                        dtype=I64, device=device).unbind(0)


def _stack_params(prms: Sequence[FastSimParams],
                  device: torch.device) -> FastSimParams:
    """(B,) float64 leaves on ``device``, built in one host-to-device copy."""
    rows = torch.tensor([[float(getattr(p, n)) for p in prms]
                         for n in _PARAM_FIELDS], dtype=F64, device=device)
    return FastSimParams(**dict(zip(_PARAM_FIELDS, rows.unbind(0))))


def _pad_pow2(idxs: List[int]) -> List[int]:
    pad = 1 << (len(idxs) - 1).bit_length()
    return idxs + [idxs[-1]] * (pad - len(idxs))


def _run_block(key: Tuple[int, int, int], mode: str,
               cfgs: Sequence[HPLConfig], prms: Sequence[FastSimParams],
               device: torch.device) -> torch.Tensor:
    """Issue one bucket program over ``len(prms)`` lanes on one device;
    the lane times stay there (the caller copies them back)."""
    _SHAPES_SEEN.add((key, mode, len(prms), str(device)))
    fn = _compiled(*key, mode, str(device))
    with torch.no_grad():
        return fn(*_geometry(cfgs, device), _stack_params(prms, device))


def _dispatch(key: Tuple[int, int, int], mode: str,
              cfgs: Sequence[HPLConfig], prms: Sequence[FastSimParams],
              live: int, device: torch.device) -> np.ndarray:
    """Run one bucket program over ``len(prms)`` lanes (``cfgs`` is one
    shared geometry or one per lane); returns the lane times.  Under lane
    sharding each device runs its contiguous block of lanes; every block
    is issued before the first is copied back."""
    m = get_global_metrics()
    pre, t0 = trace_count(), time.perf_counter()
    shard = _shard_lanes(len(prms), device)
    if shard is None:
        out = _run_block(key, mode, cfgs, prms, device).cpu().numpy()
    else:
        per = len(prms) // len(shard)
        blocks = [_run_block(key, mode,
                             cfgs if len(cfgs) == 1 else cfgs[i:i + per],
                             prms[i:i + per], dev)
                  for i, dev in zip(range(0, len(prms), per), shard)]
        out = np.concatenate([b.cpu().numpy() for b in blocks])
    if m.enabled:
        _record_dispatch(m, key, pre, time.perf_counter() - t0, live,
                         len(prms))
        _record_shard(m, shard)
    return out


def _run_single(cfg: HPLConfig, prm: FastSimParams,
                device: torch.device) -> float:
    return float(_dispatch(bucket_key(cfg), "single", [cfg], [prm], 1,
                           device)[0])


def simulate_time_traced(cfg: HPLConfig, prm: FastSimParams, *,
                         device: DeviceLike = "cuda") -> torch.Tensor:
    """Differentiable scalar HPL time: ``prm`` leaves may be float64
    tensors with ``requires_grad``; the result is a 0-d tensor to call
    ``backward()`` on.  This is the autodiff surface for gradient
    calibration."""
    dev = resolve_device(device)
    key = bucket_key(cfg)
    prm1 = FastSimParams(**{
        n: torch.as_tensor(getattr(prm, n), dtype=F64, device=dev).reshape(1)
        for n in _PARAM_FIELDS})
    return _sim_core(*_geometry([cfg], dev), prm1, *key,
                     _tables(key[1], key[2], dev))[0]


def _result(cfg: HPLConfig, t: float) -> dict:
    return {"time_s": t, "gflops": cfg.flops() / t / 1e9,
            "tflops": cfg.flops() / t / 1e12}


def simulate_hpl_fast(cfg: HPLConfig, prm: FastSimParams, *,
                      device: DeviceLike = "cuda") -> dict:
    return _result(cfg, _run_single(cfg, prm, resolve_device(device)))


# ---------------------------------------------------------- sweep engine
Configs = Union[HPLConfig, Sequence[HPLConfig]]
Params = Union[FastSimParams, Sequence[FastSimParams]]


def sweep_hpl(configs: Configs, params: Params, *,
              bucket: Optional[Tuple[int, int, int]] = None,
              device: DeviceLike = "cuda") -> List[dict]:
    """Run a scenario sweep in as few bucket programs as possible.

    ``configs`` and ``params`` are zipped; a single ``HPLConfig`` or
    ``FastSimParams`` on either side broadcasts against the other.
    Scenarios sharing an exact ``(N, nb, P, Q)`` run as one params-only
    batch (geometry shared — the fast path for hardware what-if grids);
    the remaining scenarios are grouped by shape bucket (``bucket_key``)
    and each bucket runs as one batch with per-lane geometry.  Batches
    are padded to a power of two.  Results come back as one
    ``simulate_hpl_fast``-style dict per scenario, in input order.

    ``bucket=(n_panels_max, P_max, Q_max)`` forces every scenario into
    ONE padded shape bucket: the whole sweep runs as a single batch
    regardless of geometry mix (the TOP500 fleet path).  Each component
    is rounded up to a bucket size; a config that doesn't fit raises.
    """
    dev = resolve_device(device)
    cfg_list = [configs] if isinstance(configs, HPLConfig) else list(configs)
    prm_list = [params] if isinstance(params, FastSimParams) else list(params)
    if len(cfg_list) == 1 and len(prm_list) > 1:
        cfg_list = cfg_list * len(prm_list)
    if len(prm_list) == 1 and len(cfg_list) > 1:
        prm_list = prm_list * len(cfg_list)
    if len(cfg_list) != len(prm_list):
        raise ValueError(
            f"sweep_hpl: {len(cfg_list)} configs vs {len(prm_list)} params "
            "(must match, or one side must be a single scenario)")
    if bucket is not None:
        return _sweep_forced_bucket(cfg_list, prm_list, bucket, dev)

    by_cfg: Dict[Tuple[int, int, int, int], List[int]] = {}
    for idx, cfg in enumerate(cfg_list):
        by_cfg.setdefault((cfg.N, cfg.nb, cfg.P, cfg.Q), []).append(idx)

    times = np.empty(len(cfg_list), np.float64)
    mixed: Dict[Tuple[int, int, int], List[int]] = {}
    for idxs in by_cfg.values():
        key = bucket_key(cfg_list[idxs[0]])
        if len(idxs) == 1:
            mixed.setdefault(key, []).append(idxs[0])
            continue
        lanes = _pad_pow2(idxs)
        out = _dispatch(key, "params", [cfg_list[idxs[0]]],
                        [prm_list[i] for i in lanes], len(idxs), dev)
        times[idxs] = out[:len(idxs)]
    for key, idxs in mixed.items():
        if len(idxs) == 1:
            times[idxs[0]] = _run_single(cfg_list[idxs[0]],
                                         prm_list[idxs[0]], dev)
            continue
        lanes = _pad_pow2(idxs)
        out = _dispatch(key, "batch", [cfg_list[i] for i in lanes],
                        [prm_list[i] for i in lanes], len(idxs), dev)
        times[idxs] = out[:len(idxs)]
    return [_result(cfg, float(t)) for cfg, t in zip(cfg_list, times)]


def _sweep_forced_bucket(cfg_list: Sequence[HPLConfig],
                         prm_list: Sequence[FastSimParams],
                         bucket: Tuple[int, int, int],
                         device: torch.device) -> List[dict]:
    """One 'batch'-mode dispatch for the whole sweep under a shared
    (rounded-up) bucket — one bucket program per distinct forced bucket,
    however many geometries are mixed in."""
    key = tuple(_bucket(b) for b in bucket)
    n_panels_max, P_max, Q_max = key
    for cfg in cfg_list:
        if (cfg.n_panels > n_panels_max or cfg.P > P_max
                or cfg.Q > Q_max):
            raise ValueError(
                f"sweep_hpl: config (N={cfg.N}, nb={cfg.nb}, P={cfg.P}, "
                f"Q={cfg.Q}) exceeds forced bucket "
                f"({n_panels_max}, {P_max}, {Q_max})")
    lanes = _pad_pow2(list(range(len(cfg_list))))
    out = _dispatch(key, "batch", [cfg_list[i] for i in lanes],
                    [prm_list[i] for i in lanes], len(cfg_list), device)
    return [_result(cfg, float(t))
            for cfg, t in zip(cfg_list, out[:len(cfg_list)])]
