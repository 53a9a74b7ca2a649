#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from src/repro_torch/csrc/ (one nvcc per
source, all at once), prints what the compiler reports for each (``-Xptxas
-v``: registers, shared memory, spills) and, where the toolkit has
``cuobjdump``, how many HGMMA (wgmma) instructions the bf16 flash kernels
hold and how many HMMA the bf16 instances of the SSD kernel's chunk_scan
hold (each must be above 0), holds each kernel against its plain torch
version, then drives each main path through the entry points a user
calls, with the launch counts set to 0 just before it and read just
after:

  * HPL prediction: the max-min fair allocation of Frontera's panel
    broadcast (``waterfill``, which runs ``masked_min_rows`` once per
    iteration); ``get_workload("hpl").predict(get_platform(p))`` for
    bdw-local, tpu-v5e-pod, syn-mp-2pod-v5e and Frontera (N=9,282,848,
    88x91 grid, 24,175 panels) against the reference package's simulated
    times; a 64-lane Frontera what-if grid and a mixed-geometry
    forced-bucket sweep through ``sweep_hpl``, against the single runs.
  * LM serving: ``ServeEngine`` on qwen2-0.5b at full width (24 layers,
    d_model 896, 14 query heads in 2 KV groups, vocab 151,936) with seeded
    random weights, 8 requests of 128 prompt tokens and 32 new tokens in
    4 slots; prefill runs ``flash_attention_fwd`` once per layer.  The
    same requests then go through the engine built without the kernel
    (the reference engine's build), in bfloat16 and in float32, and the
    greedy tokens must agree.  Then a 4 x 2048 prefill and 16 decode steps
    with and without the kernel, compared in float32 and bfloat16, and two
    planted faults that the comparison must catch.  The bf16 kernel is
    timed beside scaled_dot_product_attention at the prefill shape and at
    the served shape.
  * Mamba-2 scoring and serving: the SSD chunk-scan kernel against its
    plain version at the kernel tests' shapes, mamba2-780m's 4 x 2048
    forward shape, a ragged S and an S below the chunk, in float32 and
    bfloat16, and element by element against its own function evaluated
    in float64 within a derived rounding bound, with two planted faults
    that must break both, timed at the model's shape on per-head B and C
    and on one group's B and C shared by all heads, as the model passes
    them (with each of its three passes' device time from torch.profiler);
    ``Model.loss`` of mamba2-780m at full width (48 layers, d_model
    1536, 48 heads of 64, N 128, vocab 50,280, seeded weights) on
    4 x 2048 tokens with the kernel (48 launches a forward) against the
    plain chunked scan: in float32 at the logits, the loss and every
    layer's scan, in bfloat16 at every layer's scan (and each bf16 path's
    logits against the float32 ones), with the same two faults planted in
    the model; then ``ServeEngine`` on the same model (4 requests of 128
    prompt and 16 new tokens, 4 slots), which runs prefill and decode
    without the kernel, as the reference's engine does, and a float32
    check that prefill's last logits equal the kernel forward's.

Any failure exits non-zero.  The line before the last is a JSON object of
the kernels' measurements; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's src/ beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Simulated seconds of get_workload("hpl").predict(get_platform(p)) from the
# reference package (JAX, float64 on the CPU).
REFERENCE_TIME_S = {
    "bdw-local": 0.058538299545155895,
    "tpu-v5e-pod": 88.82483519304056,
    "syn-mp-2pod-v5e": 168.19366046372835,
    "frontera": 23516.763203358445,
}
# 1e-12 relative for the short runs; Frontera's 24k panels add rounding
# differences (about n_panels * eps at worst), so 1e-10 there.
TOL = {"bdw-local": 1e-12, "tpu-v5e-pod": 1e-12, "syn-mp-2pod-v5e": 1e-12,
       "frontera": 1e-10}
# Published HBM rate of one H100 SXM (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
# Published dense peaks of one H100 SXM (NVIDIA data sheet), FLOP/s: bf16 on
# the tensor cores, float32 on the CUDA cores.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# (F, L, density): tests/test_kernels.py's shapes, then a ragged one
TEST_SHAPES = [(64, 128, 0.1), (256, 256, 0.03), (8, 128, 0.5),
               (1000, 300, 0.05)]
LM_ARCH = "qwen2-0.5b"
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_SLOTS = 8, 128, 32, 4
# (B, S, G, R, hd): tests/test_kernels.py's flash shapes, a ragged one, the
# shape ServeEngine gives the kernel (one 128-token prompt at a time), and
# qwen2-0.5b's 4 x 2048 prefill
FLASH_SERVED = (1, SERVE_PROMPT, 2, 7, 64)
FLASH_SHAPES = [(1, 128, 1, 1, 64), (2, 256, 2, 4, 64), (1, 256, 1, 7, 32),
                (1, 512, 4, 2, 128), (1, 200, 2, 7, 64), FLASH_SERVED]
FLASH_PREFILL = (4, 2048, 2, 7, 64)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# unit roundoff of bfloat16 (8 significand bits)
BF16_U = 2.0 ** -8
PREFILL_B, PREFILL_S, PREFILL_DECODE = 4, 2048, 16
# Kernel against plain path, largest gap over the plain path's largest
# magnitude, across prefill logits, the K/V cache and 16 decode steps.
# float32: the kernel agrees with its plain version to ~1e-6, so 1e-4
# leaves room for 24 layers of growth; bfloat16 rounds activations to 8
# mantissa bits at other places in the two paths.
PREFILL_LIMIT = {"float32": 1e-4, "bfloat16": 5e-2}
SSM_ARCH = "mamba2-780m"
# (B, S, H, P, N, chunk): tests/test_kernels.py's SSD shapes; mamba2-780m's
# 4 x 2048 forward; a ragged S and an S below the chunk at the model's widths
SSD_SHAPES = [(1, 64, 1, 8, 4, 16), (2, 128, 3, 16, 8, 32),
              (1, 256, 2, 64, 16, 64), (1, 128, 2, 32, 128, 128)]
SSD_MODEL = (4, 2048, 48, 64, 128, 256)
SSD_RAGGED = [(1, 300, 48, 64, 128, 256), (2, 100, 48, 64, 128, 256)]
# rtol, atol of the reference's kernel test (tests/test_kernels.py)
SSD_TOL = {torch.float32: (2e-4, 2e-3), torch.bfloat16: (5e-2, 5e-1)}
# unit roundoff of float32 (24 significand bits)
F32_U = 2.0 ** -24
SSM_B, SSM_S = 4, 2048
SSM_SERVE_REQUESTS, SSM_SERVE_PROMPT, SSM_SERVE_NEW, SSM_SERVE_SLOTS = (
    4, 128, 16, 4)
# Kernel against plain path for mamba2-780m, each gap over the plain
# output's largest magnitude.  float32: the logits, the loss and every
# layer's scan output, which differ only in summation order (1e-4 leaves
# room for 48 layers).  bfloat16: every layer's scan output, where the
# plain path rounds the scan's (Q, Q) tiles to bf16 while the kernel stays
# float32, as in the reference; the limit is the reference kernel test's
# bf16 rtol.  The bf16 logits carry the whole model's bf16 rounding (each
# bf16 path read 6.5e-2 and 6.8e-2 from the float32 logits), so they are
# held against the float32 kernel path's logits and loss, within 1e-1,
# and their kernel-vs-plain gap is printed, not gated.
SSM_LIMIT = 1e-4
SSM_SCAN_LIMIT_BF16 = 5e-2
SSM_BF16_FROM_F32 = 1e-1


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of one ``fn()`` between CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def frontera_incidence(dev):
    """Flow x link incidence of Frontera's 1-ring panel broadcast in every
    process row at once: rank (p, q) sits on node p + q*P (column-major)
    and sends to (p, (q+1) % Q), routed over the port's fat tree."""
    from repro_torch.kernels.maxmin_fair import flow_incidence
    from repro_torch.platforms import get_platform
    plat = get_platform("frontera")
    P, Q = plat.scale.grid
    pairs = [(p + q * P, p + ((q + 1) % Q) * P)
             for q in range(Q) for p in range(P)]
    adj, caps = flow_incidence(plat.topology(), pairs)
    return (torch.from_numpy(adj).to(dev), torch.from_numpy(caps).to(dev))


def first_share(adj, caps):
    """The per-link fair share of waterfill's first iteration: the values
    the main path hands the row-min kernel."""
    from repro_torch.kernels.maxmin_fair import INF
    nl = adj.to(torch.float32).sum(dim=0)
    return torch.where(nl > 0, caps / torch.clamp(nl, min=1.0), INF)


def check_minrows(name, adj, vals):
    """Kernel against plain version: exactly equal (a min does no
    arithmetic); returns the timing record."""
    from repro_torch.kernels.maxmin_fair import (masked_min_rows,
                                                 masked_min_rows_ref)
    out_k = masked_min_rows(adj, vals)
    out_p = masked_min_rows_ref(adj, vals)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max()) if out_k.numel() else 0.0
    check(torch.equal(out_k, out_p),
          f"masked_min_rows {name}: kernel != plain (max abs err {err})")
    F, L = adj.shape
    ms = cuda_ms(lambda: masked_min_rows(adj, vals))
    plain_ms = cuda_ms(lambda: masked_min_rows_ref(adj, vals))
    bound_ms = (F * L + 4 * L + 4 * F) / HBM_BYTES_PER_S * 1e3
    print(f"masked_min_rows {name} F={F} L={L}: equal=True "
          f"max_abs_err={err} ms={ms:.6f} plain_ms={plain_ms:.6f} "
          f"bound_ms={bound_ms:.6f} (bytes) "
          f"launches={masked_min_rows.launches}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "max_abs_err": err}


def kernel_phase(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    for F, L, density in TEST_SHAPES:
        adj = (torch.rand(F, L, generator=g, device=dev)
               < density).to(torch.int8)
        if (F, L) == (1000, 300):
            # ragged rows (300 % 16 != 0) with non-positive entries, which
            # cross no link
            adj = adj - (torch.rand(F, L, generator=g, device=dev)
                         < 0.05).to(torch.int8)
        vals = torch.rand(L, generator=g, device=dev) * 100
        check_minrows(f"{F}x{L}", adj, vals)
    adj, caps = frontera_incidence(dev)
    check(tuple(adj.shape) == (8008, 18200),
          f"Frontera incidence shape {tuple(adj.shape)} != (8008, 18200)")
    return adj, caps, check_minrows("frontera", adj,
                                    first_share(adj, caps))


def predict_phase(dev, name):
    from repro_torch.core.fastsim import bucket_key
    from repro_torch.platforms import get_platform
    from repro_torch.workloads import get_workload
    plat = get_platform(name)
    wl = get_workload("hpl")
    t0 = time.perf_counter()
    t = wl.predict(plat, device=dev)["time_s"]
    wall = time.perf_counter() - t0
    cfg = wl.config(plat)
    steps = bucket_key(cfg)[0]
    err = rel_err(t, REFERENCE_TIME_S[name])
    print(f"predict {name}: time_s={t!r} reference="
          f"{REFERENCE_TIME_S[name]!r} rel_err={err:.3e} (tol {TOL[name]}) "
          f"wall_s={wall:.3f} panels={cfg.n_panels} loop_steps={steps} "
          f"panels_per_s={cfg.n_panels / wall:.1f}", flush=True)
    check(err <= TOL[name], f"predict {name}: rel err {err} > {TOL[name]}")
    return t


def grid_phase(dev, frontera_t):
    """8 link_bw x 8 gemm_eff what-if lanes over Frontera's run."""
    import dataclasses

    from repro_torch.platforms import get_platform
    from repro_torch.workloads import get_workload
    plat = get_platform("frontera")
    wl = get_workload("hpl")
    model = wl.fastsim_model(plat)
    base = model.params
    link = [base.link_bw * f for f in (0.5, 0.75, 1.0, 1.25, 1.5, 2.0, 3.0,
                                       4.0)]
    eff = [0.80, 0.83, 0.86, 0.89, base.gemm_eff, 0.94, 0.96, 0.98]
    prms = [dataclasses.replace(base, link_bw=lb, gemm_eff=ge)
            for lb in link for ge in eff]
    t0 = time.perf_counter()
    out = [r["time_s"] for r in model.sweep(prms, device=dev)]
    wall = time.perf_counter() - t0
    ref_lane = out[2 * 8 + 4]            # link_bw x 1.0, gemm_eff as is
    err = rel_err(ref_lane, frontera_t)
    n_panels = wl.config(plat).n_panels
    print(f"grid frontera 64 lanes: wall_s={wall:.3f} "
          f"lane_panels_per_s={64 * n_panels / wall:.1f} "
          f"min_time_s={min(out)!r} max_time_s={max(out)!r} "
          f"unmodified_lane={ref_lane!r} rel_err_vs_single={err:.3e}",
          flush=True)
    check(all(t > 0 and t < float("inf") for t in out),
          "grid: non-finite lane time")
    check(err <= 1e-12, f"grid: unmodified lane rel err {err} > 1e-12")


def forced_bucket_phase(dev, singles):
    """The three small platforms in one mixed-geometry forced bucket."""
    from repro_torch.platforms import get_platform
    from repro_torch.workloads import HPLFastModel, get_workload
    names = ["bdw-local", "tpu-v5e-pod", "syn-mp-2pod-v5e"]
    wl = get_workload("hpl")
    models = [wl.fastsim_model(get_platform(n)) for n in names]
    t0 = time.perf_counter()
    out = HPLFastModel.sweep_models(models, device=dev)
    wall = time.perf_counter() - t0
    panels = sum(m.cfg.n_panels for m in models)
    for n, r in zip(names, out):
        err = rel_err(r["time_s"], singles[n])
        print(f"forced bucket {n}: time_s={r['time_s']!r} "
              f"rel_err_vs_single={err:.3e}", flush=True)
        check(err <= 1e-12, f"forced bucket {n}: rel err {err} > 1e-12")
    print(f"forced bucket: wall_s={wall:.3f} "
          f"panels_per_s={panels / wall:.1f}", flush=True)


def flash_bound_ms(shape, causal, dtype):
    """The least time for the attention products at ``shape``: the FLOPs
    this call needs (the causal key count of each row, 2 x 2 per element
    of q.k and p.v) at the peak rate for ``dtype``, or q, k, v and the
    output moved once at the HBM rate, whichever is larger."""
    b, s, g, r, hd = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * g * r * hd * pairs
    nbytes = (2 * b * s * g * r * hd + 2 * b * s * g * hd) * (
        torch.finfo(dtype).bits // 8)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_inputs(shape, dtype, dev, seed):
    b, s, g, r, hd = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(b, s, g, r, hd, generator=gen, device=dev).to(dtype),
            torch.randn(b, s, g, hd, generator=gen, device=dev).to(dtype),
            torch.randn(b, s, g, hd, generator=gen, device=dev).to(dtype))


def visible_mask(sq, sk, causal, dev):
    """(sq, sk) bool: the keys each query position sees."""
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool, device=dev)
    return (torch.arange(sk, device=dev)[None, :]
            <= torch.arange(sq, device=dev)[:, None])


def bf16_exact(q, k, v, mask):
    """What the bf16 kernel computes, in float64 on its own inputs (q scaled
    and rounded to bfloat16 as the kernel does it), over the keys ``mask``
    allows.  Returns (out, P @ |V|)."""
    qs = (q.float() * (1.0 / math.sqrt(q.shape[4]))).to(q.dtype).double()
    s = torch.einsum("bqgrk,bsgk->bgrqs", qs, k.double())
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    return (torch.einsum("bgrqs,bsgk->bqgrk", p, v.double()),
            torch.einsum("bgrqs,bsgk->bqgrk", p, v.double().abs()))


def bf16_excess(out, exact, mag):
    """The largest |out - exact| over its bound, element by element.  The
    bf16 kernel rounds each probability to bfloat16 before P @ V (at most
    u * (P @ |V|) in all) and its output once (at most one ulp of the
    value it rounds); 1.05 leaves room for float32 sums.  At most 1:
    within the bound."""
    slack = BF16_U * mag
    _, e = torch.frexp(exact.abs() + slack)
    ulp = torch.ldexp(torch.ones_like(exact), e - 8)
    return float(((out.double() - exact).abs() / (1.05 * slack + ulp)).max())


def check_flash(shape, causal, dtype, dev, seed):
    """Kernel against plain version on the same inputs, and in bf16 also
    element by element against ``bf16_exact`` within ``bf16_excess``'s
    bound; returns the inputs, the max abs error and, in bf16, the exact
    output and P @ |V|."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    q, k, v = flash_inputs(shape, dtype, dev, seed)
    out_k = flash_attention_fwd(q, k, v, causal=causal)
    out_p = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    check(out_k.shape == q.shape and out_k.dtype == dtype,
          f"flash_attention {shape}: output {tuple(out_k.shape)} "
          f"{out_k.dtype}")
    check(bool(torch.isfinite(out_k.float()).all()),
          f"flash_attention {shape}: non-finite output")
    err = float((out_k.float() - out_p.float()).abs().max())
    tol = FLASH_TOL[dtype]
    print(f"flash_attention {shape} causal={causal} {dtype}: "
          f"max_abs_err={err} (tol {tol})", flush=True)
    check(torch.allclose(out_k.float(), out_p.float(), atol=tol, rtol=tol),
          f"flash_attention {shape} causal={causal} {dtype}: kernel != "
          f"plain (max abs err {err})")
    exact = None
    if dtype == torch.bfloat16:
        exact = bf16_exact(q, k, v, visible_mask(shape[1], shape[1], causal,
                                                 dev))
        excess = bf16_excess(out_k, *exact)
        print(f"flash_attention {shape} causal={causal} {dtype}: element "
              f"bound max |err| / bound = {excess:.4f} (limit 1)", flush=True)
        check(excess <= 1.0, f"flash_attention {shape} causal={causal} "
                             f"{dtype}: an element is {excess} x its bound")
    return (q, k, v), err, exact


def planted_tile_faults(q, k, v, exact):
    """A bf16 check at the causal prefill shape must reject a kernel that
    loses one 64-key tile for the last 64 query positions: its diagonal
    tile, or the first tile.  Such outputs move by far less than the 2e-2
    absolute limit; the element bound must catch them."""
    s = q.shape[1]
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    causal, late = kpos <= qpos, qpos >= s - 64
    faults = {
        "last_rows_skip_diagonal_tile": causal & ~(late & (kpos >= s - 64)),
        "last_rows_skip_first_tile": causal & ~(late & (kpos < 64))}
    for name, mask in faults.items():
        out = bf16_exact(q, k, v, mask)[0].to(q.dtype)
        excess = bf16_excess(out, *exact)
        err = float((out.double() - exact[0]).abs().max())
        print(f"flash_attention planted fault {name}: max_abs_err={err:.4e} "
              f"(absolute limit {FLASH_TOL[q.dtype]}) element bound max "
              f"|err| / bound = {excess:.4f}", flush=True)
        check(excess > 1.0, f"flash_attention: planted fault {name} reads "
                            f"{excess} x the bound, within it")


def sdpa_inputs(q, k, v):
    """q, k, v in scaled_dot_product_attention's (B, heads, S, hd) layout,
    the G x R query heads in group order."""
    b, s, g, r, hd = q.shape
    return (q.reshape(b, s, g * r, hd).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2))


def time_flash(shape, dev):
    """The bf16 kernel at ``shape`` causal, timed beside
    scaled_dot_product_attention (the library yardstick) in turns: kernel,
    library, library, kernel."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    q, k, v = flash_inputs(shape, torch.bfloat16, dev, 98)
    qs, ks, vs = sdpa_inputs(q, k, v)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel():
        return flash_attention_fwd(q, k, v, causal=True)

    def library():
        return sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
    ms = [cuda_ms(kernel)]
    library_ms = [cuda_ms(library), cuda_ms(library)]
    ms.append(cuda_ms(kernel))
    bound_ms, bound_by = flash_bound_ms(shape, True, torch.bfloat16)
    print(f"flash_attention {shape} causal torch.bfloat16 (the shape "
          f"ServeEngine's prefill gives it): ms={ms[0]:.6f},{ms[1]:.6f} "
          f"library_ms(sdpa)={library_ms[0]:.6f},{library_ms[1]:.6f} "
          f"bound_ms={bound_ms:.6f} ({bound_by})", flush=True)


def flash_phase(dev):
    """(a) the flash kernel against its plain version at the test shapes,
    then timed at qwen2-0.5b's prefill shape beside the plain version and
    scaled_dot_product_attention (the library yardstick, never on the
    port's path)."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_fwd)
    seed = 0
    for shape in FLASH_SHAPES:
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                seed += 1
                check_flash(shape, causal, dtype, dev, seed)
    time_flash(FLASH_SERVED, dev)
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        (q, k, v), err, exact = check_flash(FLASH_PREFILL, True, dtype, dev,
                                            99)
        if dtype == torch.bfloat16:
            planted_tile_faults(q, k, v, exact)
        del exact
        qs, ks, vs = sdpa_inputs(q, k, v)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=True))
        library_ms = cuda_ms(lambda: sdpa(qs, ks, vs, is_causal=True,
                                          enable_gqa=True))
        bound_ms, bound_by = flash_bound_ms(FLASH_PREFILL, True, dtype)
        print(f"flash_attention {FLASH_PREFILL} causal {dtype}: "
              f"ms={ms:.6f} plain_ms={plain_ms:.6f} "
              f"library_ms(sdpa)={library_ms:.6f} bound_ms={bound_ms:.6f} "
              f"({bound_by}) max_abs_err={err}", flush=True)
        if dtype == torch.bfloat16:
            rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms}
    return rec


def lm_params(cfg, dev):
    from repro_torch.models import build_model
    return build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))


def serve_requests(cfg):
    """The seeded requests of the serve phase (fresh objects each call)."""
    import numpy as np

    from repro_torch.serve import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32),
        max_new_tokens=SERVE_NEW) for i in range(SERVE_REQUESTS)]


def compare_served(dev, cfg, params, out):
    """The tokens ``out`` served with the kernel against the same requests
    served by the engine built without it.  Each request's tokens must be
    equal, or part where the plain path's two candidates are a near-tie:
    their logits within ``PREFILL_LIMIT`` (the kernel-vs-plain gap allowed
    for the dtype) of the logits' largest magnitude."""
    from repro_torch.serve import ServeEngine
    plain = ServeEngine(cfg, params, batch_slots=SERVE_SLOTS,
                        max_len=SERVE_PROMPT + SERVE_NEW, use_kernel=False,
                        device=dev)
    reqs = serve_requests(cfg)
    ref = plain.run(reqs)
    check(sorted(out) == sorted(ref) and all(
        len(out[r]) == len(ref[r]) for r in ref),
        f"serve {cfg.dtype}: token counts differ")
    limit = PREFILL_LIMIT[cfg.dtype]
    same = 0
    for r in reqs:
        t = next((t for t, (a, b) in enumerate(zip(out[r.rid], ref[r.rid]))
                  if a != b), None)
        if t is None:
            same += 1
            continue
        prefix = [int(x) for x in r.prompt] + ref[r.rid][:t]
        with torch.inference_mode():
            logits = plain.model.prefill(params, {"tokens": torch.tensor(
                [prefix], device=dev)}, max_len=len(prefix))[1][0]
        logits = logits[:cfg.vocab_size].float()
        a, b = ref[r.rid][t], out[r.rid][t]
        tie = float((logits[a] - logits[b]).abs() / logits.abs().max())
        print(f"serve {cfg.name} {cfg.dtype}: request {r.rid} first differs "
              f"at token {t} (plain {a}, kernel {b}); their logits differ "
              f"by {tie:.3e} of scale (near-tie limit {limit})", flush=True)
        check(tie <= limit, f"serve {cfg.dtype}: kernel and plain engines "
                            f"differ at request {r.rid} token {t}, not a "
                            f"near-tie ({tie} > {limit})")
    print(f"serve {cfg.name} {cfg.dtype}: kernel and plain engines served "
          f"the same tokens for {same} of {len(reqs)} requests", flush=True)


def serve_phase(dev, cfg, params):
    """(b) the main path: ServeEngine on full-width qwen2-0.5b.  Launch
    counts are 0 just before the run and read just after.  Then the same
    requests through the engine without the kernel, in the config's bf16
    and in float32."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, batch_slots=SERVE_SLOTS,
                      max_len=SERVE_PROMPT + SERVE_NEW, device=dev)
    eng.warm(SERVE_PROMPT)          # the first call's one-time set-up
    reqs = serve_requests(cfg)
    before = dict(eng.stats)
    flash_attention_fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    stats = {k: eng.stats[k] - before[k] for k in eng.stats}
    tokens = sum(len(t) for t in out.values())
    print(f"serve {cfg.name}: {SERVE_REQUESTS} requests x prompt "
          f"{SERVE_PROMPT} + {SERVE_NEW} new, {SERVE_SLOTS} slots: {tokens} "
          f"tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s, stats "
          f"{stats}, flash_attention_fwd launches={launches}", flush=True)
    waves = -(-SERVE_REQUESTS // SERVE_SLOTS)
    check(stats == {"prefills": SERVE_REQUESTS,
                    "decode_steps": waves * (SERVE_NEW - 1),
                    "tokens_out": SERVE_REQUESTS * SERVE_NEW},
          f"serve: stats {stats}")
    check(all(len(t) == SERVE_NEW and all(0 <= x < cfg.vocab_size
                                          for x in t) for t in out.values()),
          "serve: a request's tokens are missing or outside the vocab")
    check(launches == cfg.num_layers * stats["prefills"],
          f"serve: flash_attention_fwd launched {launches} times, not "
          f"{cfg.num_layers} x {stats['prefills']} prefills")
    compare_served(dev, cfg, params, out)
    c32 = dataclasses.replace(cfg, dtype="float32")
    out32 = ServeEngine(c32, params, batch_slots=SERVE_SLOTS,
                        max_len=SERVE_PROMPT + SERVE_NEW,
                        device=dev).run(serve_requests(c32))
    compare_served(dev, c32, params, out32)
    return launches


@contextlib.contextmanager
def planted(fault):
    """A fault in the kernel path: layer 12's attention output zeroed, or
    the causal mask off in every layer."""
    from repro_torch.kernels.flash_attention import ops
    real = ops.flash_attention
    calls = []

    def faulty(q, k, v, causal=True):
        calls.append(None)
        if fault == "no_causal_mask":
            return real(q, k, v, causal=False)
        out = real(q, k, v, causal=causal)
        return torch.zeros_like(out) if len(calls) == 13 else out
    ops.flash_attention = faulty
    try:
        yield
    finally:
        ops.flash_attention = real


def run_prefill(cfg, params, dev, use_kernel, tokens, steps):
    """4 x 2048 prefill then ``steps`` decode steps on fixed tokens;
    returns the prefill wall seconds and every tensor to compare (logits
    over the real vocabulary: the padded entries are -1e30 in both paths
    and would set the scale of the comparison)."""
    from repro_torch.models import build_model
    model = build_model(cfg, use_kernel=use_kernel, device=dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = model.prefill(params, {"tokens": tokens[:, :-steps]},
                                      max_len=tokens.shape[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        v = cfg.vocab_size
        outs = [logits[:, :v], cache["k"].clone(), cache["v"].clone()]
        for i in range(steps):
            n = tokens.shape[1] - steps + i
            cache, logits = model.decode(params, cache, tokens[:, n:n + 1])
            outs.append(logits[:, :v])
        outs += [cache["k"], cache["v"]]
    check(all(bool(torch.isfinite(t.float()).all()) for t in outs),
          f"prefill {cfg.dtype} use_kernel={use_kernel}: non-finite output")
    return wall, outs


def gap(outs, ref):
    """Largest gap over the reference's largest magnitude, across all."""
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max()) for a, b in zip(outs, ref))


def prefill_phase(dev, cfg, params):
    """(c) full-width prefill with the kernel against the plain path, in
    float32 and bfloat16, and two planted faults that must read above the
    limit that passes the kernel."""
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size,
                           (PREFILL_B, PREFILL_S + PREFILL_DECODE),
                           generator=gen, device=dev)
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        limit = PREFILL_LIMIT[dtype]
        run_prefill(c, params, dev, True, tokens, PREFILL_DECODE)   # warm
        plain_wall, ref = run_prefill(c, params, dev, False, tokens,
                                      PREFILL_DECODE)
        kern_wall, outs = run_prefill(c, params, dev, True, tokens,
                                      PREFILL_DECODE)
        plain_wall2, _ = run_prefill(c, params, dev, False, tokens,
                                     PREFILL_DECODE)
        kern_wall2, _ = run_prefill(c, params, dev, True, tokens,
                                    PREFILL_DECODE)
        g = gap(outs, ref)
        faults = {}
        for fault in ("layer_12_attention_zeroed", "no_causal_mask"):
            with planted(fault):
                faults[fault] = gap(run_prefill(c, params, dev, True, tokens,
                                                PREFILL_DECODE)[1], ref)
        print(f"prefill {cfg.name} {PREFILL_B}x{PREFILL_S} {dtype}: "
              f"wall_s kernel={kern_wall:.4f},{kern_wall2:.4f} "
              f"plain={plain_wall:.4f},{plain_wall2:.4f}; kernel vs plain "
              f"gap={g:.3e} (limit {limit}) over logits, K/V cache and "
              f"{PREFILL_DECODE} decode steps; planted faults read "
              + ", ".join(f"{k}={v:.3e}" for k, v in faults.items()),
              flush=True)
        check(g <= limit, f"prefill {dtype}: kernel vs plain gap {g} > "
                          f"{limit}")
        for k, v in faults.items():
            check(v > limit, f"prefill {dtype}: planted fault {k} reads "
                             f"{v}, within the limit {limit}")


def ssd_inputs(shape, dtype, dev, seed, shared=False):
    """x, B, C normal in ``dtype``; dt = softplus(normal) and A = -exp(normal)
    in float32: the reference kernel test's distributions.  With ``shared``,
    B and C are one group's (B, S, 1, N) broadcast to every head as a view
    with head stride 0, as the model's ``_heads_bc`` gives them for
    mamba2-780m (one group)."""
    b, s, h, p, n, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*size):
        return torch.randn(*size, generator=gen, device=dev)
    x = normal(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(normal(b, s, h))
    A = -torch.exp(normal(h))
    if shared:
        return x, dt, A, *(normal(b, s, 1, n).to(dtype).expand(b, s, h, n)
                           for _ in range(2))
    return x, dt, A, normal(b, s, h, n).to(dtype), normal(b, s, h, n).to(dtype)


def ssd_exact(xh, dt, A, Bh, Ch, chunk):
    """The kernel's function in float64 on its own inputs (dt * A rounded to
    float32 as the kernel forms it), and a bound on how far the kernel's
    float32 arithmetic may land from it before the output is rounded.

    The bound follows the kernel's operations, with u = 2^-24: each dot
    product of length K is off by at most K u of its sum of absolute terms
    (C B^T and C h^T over N, the output sum over the chunk's Q positions,
    the state sum over Q); each exp by 2 ulp (4 u) plus its argument's
    error; each product or sum by u.  The exponents come from the chunk's
    cumulative sum of dt * A, which the kernel forms by a two-level scan
    (at most 13 roundings on any path, all terms of one sign):
    |d cum| <= 16 u |cum|.  Errors
    carried in the state are tracked from chunk to chunk.  Returns
    (y, bound), both (B, S, H, P) float64."""
    b, s, h, p = xh.shape
    n = Bh.shape[-1]
    q = min(chunk, s)
    u = F32_U

    def heads_first(t):
        return t.double().movedim(2, 1)
    x, Bd, Cd = heads_first(xh), heads_first(Bh), heads_first(Ch)
    adt, dtd = heads_first(dt * A), heads_first(dt)
    state = torch.zeros(b, h, p, n, dtype=torch.float64, device=xh.device)
    s_abs, s_err = torch.zeros_like(state), torch.zeros_like(state)
    ys, errs = [], []
    for c0 in range(0, s, q):
        sl = slice(c0, min(c0 + q, s))
        m = sl.stop - c0
        xq, Bq, Cq, dq = x[:, :, sl], Bd[:, :, sl], Cd[:, :, sl], dtd[:, :, sl]
        cum = torch.cumsum(adt[:, :, sl], dim=-1)                 # (B,H,m)
        ac = cum.abs()
        ecum = 16 * u * ac + u * ac         # scan error + the subtraction's
        last, elast = cum[..., -1:], ecum[..., -1:]
        causal = torch.ones(m, m, dtype=torch.bool,
                            device=xh.device).tril()
        L = torch.where(causal, torch.exp(cum[..., :, None]
                                          - cum[..., None, :]), 0.0)
        W = L * dq[..., None, :]
        K = (Cq.abs() @ Bq.abs().transpose(-1, -2)) * W           # |M| terms
        xa = xq.abs()
        Ce = Cq * torch.exp(cum)[..., None]
        inter_mag = Ce.abs() @ s_abs.transpose(-1, -2)
        y = ((Cq @ Bq.transpose(-1, -2)) * W) @ xq + Ce @ state.transpose(
            -1, -2)
        Kx = K @ xa
        err = (Kx * ((n + 8) * u + ecum[..., None])
               + (K * ecum[..., None, :]) @ xa
               + inter_mag * ((n + 8) * u + ecum[..., None])
               + Ce.abs() @ s_err.transpose(-1, -2)
               + (q + 1) * u * (Kx + inter_mag))
        ys.append(y)
        errs.append(err)
        dec = torch.exp(last - cum) * dq                          # (B,H,m)
        Sq = xq.transpose(-1, -2) @ (Bq * dec[..., None])
        Sa = xa.transpose(-1, -2) @ (Bq.abs() * dec[..., None])
        Se = xa.transpose(-1, -2) @ (Bq.abs() * (dec * ecum)[..., None])
        el, eel = torch.exp(last)[..., None], elast[..., None]
        new_abs = el * s_abs + Sa
        s_err = (el * s_err + el * s_abs * (6 * u + eel)
                 + Sa * ((q + 8) * u + eel) + Se + u * new_abs)
        state = el * state + Sq
        s_abs = new_abs
    return (torch.cat(ys, dim=2).movedim(1, 2),
            torch.cat(errs, dim=2).movedim(1, 2))


def ssd_excess(out, exact, bound):
    """The largest |out - exact| over its bound plus one ulp of the output
    dtype at the exact value (the kernel rounds y once).  At most 1: within
    the bound."""
    bits = {torch.float32: 24, torch.bfloat16: 8}[out.dtype]
    _, e = torch.frexp(exact.abs() + bound)
    ulp = torch.ldexp(torch.ones_like(exact), e - bits)
    return float(((out.double() - exact).abs() / (bound + ulp)).max())


def ssd_plain_excess(out, plain):
    """The largest |out - plain| over the test's limit atol + rtol |plain|.
    At most 1: within the limit."""
    rtol, atol = SSD_TOL[plain.dtype]
    return float(((out.float() - plain.float()).abs()
                  / (atol + rtol * plain.float().abs())).max())


def ssd_bound_ms(shape, dtype, groups):
    """The least time for the scan at ``shape`` with B and C given for
    ``groups`` groups (``groups`` = H: one per head; 1: one shared by every
    head): the larger of its operations' time and its bytes' time.

    Operations, with causal skipping (C B^T and M x over the Q(Q+1)/2 pairs
    i >= j of each chunk, C h^T and x^T B over all positions).  C B^T
    depends on the group only, so it is counted once per group; its
    operands are the inputs, so in bfloat16 it is priced at the bf16
    tensor-core peak (bf16 products are exact in float32 and accumulate in
    float32) and in float32 at the CUDA-core peak (TF32 would round them).
    The other three products take a float32 operand (M, the state, B's
    decay-weighted rows) and are priced at the float32 peak.  The
    exponentials are not counted.  Bytes: x, B and C (one per group), dt,
    A read once and y written once.  Returns (ms, bound_by, C B^T FLOPs,
    the other products' FLOPs, bytes)."""
    b, s, h, p, n, chunk = shape
    q = min(chunk, s)
    cb = rest = 0
    for c0 in range(0, s, q):
        m = min(q, s - c0)
        cb += m * (m + 1) * n
        rest += m * (m + 1) * p + 4 * m * n * p
    cb *= b * groups
    rest *= b * h
    size = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * s * h * p + 2 * b * s * groups * n) * size + 4 * (
        b * s * h + h)
    t_ops = cb / PEAK_FLOPS[dtype] + rest / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", cb, rest, nbytes)


def check_ssd(shape, dtype, dev, seed, shared=False):
    """Kernel against plain version within the test limits, and element by
    element against ``ssd_exact`` within its bound; returns the inputs, the
    max abs error, the plain output and the exact output with its bound."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    inputs = ssd_inputs(shape, dtype, dev, seed, shared)
    label = f"{shape} {dtype}" + (" B/C shared" if shared else "")
    chunk = shape[-1]
    out = ssd_scan(*inputs, chunk)
    plain = ssd_scan_ref(*inputs, chunk)
    torch.cuda.synchronize()
    check(out.shape == inputs[0].shape and out.dtype == dtype,
          f"ssd_scan {shape}: output {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(out.float()).all()),
          f"ssd_scan {shape} {dtype}: non-finite output")
    err = float((out.float() - plain.float()).abs().max())
    within = ssd_plain_excess(out, plain)
    exact = ssd_exact(*inputs, chunk)
    excess = ssd_excess(out, *exact)
    print(f"ssd_scan {label}: max_abs_err={err:.4e} vs plain "
          f"(|err| / test limit {within:.4f}, limit 1); element bound max "
          f"|err| / bound = {excess:.4f} (limit 1)", flush=True)
    check(within <= 1.0, f"ssd_scan {label}: kernel != plain "
                         f"({within} x the test limit)")
    check(excess <= 1.0, f"ssd_scan {label}: an element is {excess} x its "
                         "bound")
    return inputs, err, plain, exact


SSD_FAULTS = ("state_dropped_mid_sequence", "head_0_decay_doubled")


def faulty_scan(scan, fault):
    """``scan`` with a fault planted around the call: the state dropped at
    the middle of S (the scan run on the two halves), or head 0's decay
    rate A doubled."""
    def run(xh, dt, A, Bh, Ch, chunk=256):
        if fault == "state_dropped_mid_sequence":
            half = xh.shape[1] // 2
            return torch.cat([scan(xh[:, sl], dt[:, sl], A, Bh[:, sl],
                                   Ch[:, sl], chunk)
                              for sl in (slice(0, half), slice(half, None))],
                             dim=1)
        A2 = A.clone()
        A2[0] *= 2
        return scan(xh, dt, A2, Bh, Ch, chunk)
    return run


def ssd_pass_times(inputs, chunk):
    """Each of the kernel's three passes' mean device time over 5 calls, by
    kernel name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssd_scan import ssd_scan
    ssd_scan(*inputs, chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ssd_scan(*inputs, chunk)
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            name = next((n for n in ("chunk_state", "state_passing",
                                     "chunk_scan") if n in e.name), e.name)
            times.setdefault(name, []).append(e.time_range.elapsed_us())
    check(len(times) == 3, f"ssd_scan passes: the profiler saw {sorted(times)}")
    return {k: statistics.mean(v) * 1e-3 for k, v in times.items()}


def ssd_phase(dev):
    """(d) the SSD kernel against its plain version and its float64 function
    at every checked shape, two planted faults at the model's shape, and
    times at the model's shape on per-head B and C and on one group's B and
    C shared by all heads (head stride 0), as ``Model.loss`` passes them;
    the shared bf16 run (the config's dtype and the main path's layout)
    goes in the record."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    seed = 200
    for shape in SSD_SHAPES + SSD_RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            seed += 1
            check_ssd(shape, dtype, dev, seed)
    rec = {}
    chunk = SSD_MODEL[-1]
    for dtype in (torch.float32, torch.bfloat16):
        inputs, err, plain, exact = check_ssd(SSD_MODEL, dtype, dev, 299)
        for name in SSD_FAULTS:
            out = faulty_scan(ssd_scan, name)(*inputs, chunk)
            excess = ssd_excess(out, *exact)
            within = ssd_plain_excess(out, plain)
            print(f"ssd_scan planted fault {name} {dtype}: element bound "
                  f"max |err| / bound = {excess:.4e}; |err| / test limit "
                  f"{within:.4e}", flush=True)
            check(excess > 1.0 and within > 1.0,
                  f"ssd_scan: planted fault {name} ({dtype}) reads {excess} "
                  f"x the bound and {within} x the test limit, not above "
                  "both")
        del exact, plain, out
        for shared in (False, True):
            if shared:
                del inputs
                inputs, err, plain, exact = check_ssd(SSD_MODEL, dtype, dev,
                                                      298, shared=True)
                del exact, plain
            groups = 1 if shared else SSD_MODEL[2]
            ms = cuda_ms(lambda: ssd_scan(*inputs, chunk))
            plain_ms = cuda_ms(lambda: ssd_scan_ref(*inputs, chunk))
            bound_ms, bound_by, cb, rest, nbytes = ssd_bound_ms(
                SSD_MODEL, dtype, groups)
            print(f"ssd_scan {SSD_MODEL} {dtype} B/C "
                  f"{'shared by all heads' if shared else 'per head'}: "
                  f"ms={ms:.6f} plain_ms={plain_ms:.6f} "
                  f"bound_ms={bound_ms:.6f} ({bound_by}: C B^T {cb:.4e} "
                  f"FLOPs at the {str(dtype)[6:]} peak + {rest:.4e} at the "
                  f"float32 peak, with causal skipping; {nbytes:.4e} bytes) "
                  f"bound/ms={bound_ms / ms:.4f} max_abs_err={err}",
                  flush=True)
            if dtype == torch.bfloat16 and shared:
                rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": None}
                passes = ssd_pass_times(inputs, chunk)
                print(f"ssd_scan {SSD_MODEL} {dtype} B/C shared by all "
                      "heads, each pass's mean device ms (torch.profiler, 5 "
                      "calls): " + ", ".join(f"{k}={v:.6f}"
                                             for k, v in passes.items()),
                      flush=True)
    return rec


@contextlib.contextmanager
def planted_ssd(fault):
    """``faulty_scan``'s fault in the model's kernel path, in every
    layer."""
    from repro_torch.kernels.ssd_scan import ops
    real = ops.ssd
    ops.ssd = faulty_scan(real, fault)
    try:
        yield
    finally:
        ops.ssd = real


@contextlib.contextmanager
def scan_gaps(gaps):
    """Every ``ops.ssd`` call in the block (one a layer) also runs the
    plain path's chunked scan on the same inputs; appends each layer's
    largest gap over the plain output's largest magnitude, and prints the
    scan's share of the mixer (its RMS over that of x, the D skip term's
    input: D is 1 at init)."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models.mamba2 import ssd_chunked
    inner = ops.ssd
    shares = []

    def recording(xh, dt, A, Bh, Ch, chunk=256):
        y = inner(xh, dt, A, Bh, Ch, chunk)
        ref = ssd_chunked(xh, dt, A, Bh, Ch, chunk)[0].float()
        gaps.append(float((y.float() - ref).abs().max() / ref.abs().max()))
        shares.append(float(ref.square().mean().sqrt()
                            / xh.float().square().mean().sqrt()))
        return y
    ops.ssd = recording
    try:
        yield
    finally:
        ops.ssd = inner
    if shares:
        print(f"ssm scan share of the mixer (RMS of the scan over RMS of x) "
              f"across {len(shares)} layers: min {min(shares):.3e} max "
              f"{max(shares):.3e}", flush=True)


def logits_gap(logits, ref_logits, vocab):
    """The logits' largest gap over their largest magnitude, over the real
    vocabulary (the padded entries are -1e30 in both)."""
    a, b = logits[..., :vocab].float(), ref_logits[..., :vocab].float()
    return float((a - b).abs().max() / b.abs().max())


def ssm_gap(logits, loss, ref_logits, ref_loss, vocab):
    """The larger of the logits' gap and the loss's relative gap."""
    return max(logits_gap(logits, ref_logits, vocab),
               abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def ssm_loss_phase(dev, cfg, params):
    """(e) the main path of the kernel: ``Model.loss`` of mamba2-780m on
    4 x 2048 tokens with the kernel, its launch count read around the
    bfloat16 run (the config's dtype), against the plain chunked scan in
    float32 and bfloat16; two planted faults; in float32, prefill's last
    logits against the kernel forward's last position.  The comparison
    covers each layer's scan output besides the logits and the loss: with
    the reference's init the scan is under 1% of each mixer's output (dt is
    about 0.016 and D is 1), so its faults move the logits far less than
    the scan itself.  Limits: ``SSM_LIMIT`` (float32) and
    ``SSM_SCAN_LIMIT_BF16``, ``SSM_BF16_FROM_F32`` (bfloat16)."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import build_model
    gen = torch.Generator(device=dev).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (SSM_B, SSM_S),
                                     generator=gen, device=dev)}
    vocab = cfg.vocab_size
    launches = None
    f32 = None
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        kern = build_model(c, use_kernel=True, device=dev)
        plain = build_model(c, use_kernel=False, device=dev)
        kern.loss(params, batch)                        # warm
        ssd_scan.launches = 0
        (loss_k, met_k), wall_k = timed(lambda: kern.loss(params, batch))
        n = ssd_scan.launches
        print(f"ssm loss {cfg.name} {SSM_B}x{SSM_S} {dtype}: ssd_scan "
              f"launches={n} loss={float(loss_k)!r} "
              f"tokens={float(met_k['tokens'])}", flush=True)
        check(n == cfg.num_layers, f"ssm loss {dtype}: ssd_scan launched "
                                   f"{n} times, not {cfg.num_layers}")
        if dtype == cfg.dtype:
            launches = n
        (loss_p, _), wall_p = timed(lambda: plain.loss(params, batch))
        _, wall_k2 = timed(lambda: kern.loss(params, batch))
        _, wall_p2 = timed(lambda: plain.loss(params, batch))
        with torch.inference_mode():
            logits_p = plain.forward(params, batch)[0]
            layers = []
            with scan_gaps(layers):
                logits_k = kern.forward(params, batch)[0]
            check(bool(torch.isfinite(logits_k.float()).all())
                  and bool(torch.isfinite(loss_k)),
                  f"ssm loss {dtype}: non-finite output")
            # (logits and loss gap, largest layer scan gap)
            gaps = {"kernel": (ssm_gap(logits_k, loss_k, logits_p, loss_p,
                                       vocab), max(layers))}
            for fault in SSD_FAULTS:
                with planted_ssd(fault):
                    loss_f, _ = kern.loss(params, batch)
                    layers = []
                    with scan_gaps(layers):
                        lf = kern.forward(params, batch)[0]
                gaps[fault] = (ssm_gap(lf, loss_f, logits_p, loss_p, vocab), max(layers))
                del lf
            for k, (out, scan) in gaps.items():
                print(f"ssm loss {dtype}: {k} vs plain: logits and loss "
                      f"{out:.3e}; largest layer scan gap {scan:.3e}",
                      flush=True)
            if dtype == "bfloat16":
                # each bf16 path against the float32 kernel path
                to32 = [ssm_gap(t, l, *f32, vocab)
                        for t, l in ((logits_k, loss_k), (logits_p, loss_p))]
                print(f"ssm loss bfloat16 against the float32 kernel path's "
                      f"logits and loss: kernel {to32[0]:.3e}, plain "
                      f"{to32[1]:.3e} (limit {SSM_BF16_FROM_F32})",
                      flush=True)
                del f32
            else:
                f32 = (logits_k[..., :vocab].clone(), loss_k)
                last_k = logits_k[:, -1, :vocab]
                del logits_k, logits_p
                _, last_p = kern.prefill(params, batch, max_len=SSM_S)
                cross = float((last_p[:, :vocab].float() - last_k.float())
                              .abs().max() / last_k.float().abs().max())
                print(f"ssm prefill vs forward(use_kernel=True) last "
                      f"position, float32: gap={cross:.3e} (limit 1e-4)",
                      flush=True)
                check(cross <= 1e-4, f"ssm: prefill's last logits differ "
                                     f"from the kernel forward's by {cross}")
        print(f"ssm loss {cfg.name} {SSM_B}x{SSM_S} {dtype}: wall_s "
              f"kernel={wall_k:.4f},{wall_k2:.4f} plain={wall_p:.4f},"
              f"{wall_p2:.4f}", flush=True)
        out, scan = gaps.pop("kernel")
        if dtype == "float32":
            check(max(out, scan) <= SSM_LIMIT,
                  f"ssm loss float32: kernel vs plain gap {max(out, scan)} "
                  f"> {SSM_LIMIT}")
            for k, v in gaps.items():
                check(min(v) > SSM_LIMIT,
                      f"ssm loss float32: planted fault {k} reads {v}, not "
                      f"above the limit {SSM_LIMIT} at the logits and loss "
                      "and at the scans")
        else:
            check(scan <= SSM_SCAN_LIMIT_BF16,
                  f"ssm loss bfloat16: a layer's scan gap {scan} > "
                  f"{SSM_SCAN_LIMIT_BF16}")
            check(max(to32) <= SSM_BF16_FROM_F32,
                  f"ssm loss bfloat16: logits and loss {to32} from the "
                  f"float32 path, > {SSM_BF16_FROM_F32}")
            for k, v in gaps.items():
                check(v[1] > SSM_SCAN_LIMIT_BF16,
                      f"ssm loss bfloat16: planted fault {k} reads {v[1]} "
                      f"at the scans, within {SSM_SCAN_LIMIT_BF16}")
    return launches


def ssm_serve_phase(dev, cfg, params):
    """(f) ServeEngine on full-width mamba2-780m in bf16: prefill and
    decode run no SSD kernel (as in the reference), so launches stay 0."""
    import numpy as np

    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, batch_slots=SSM_SERVE_SLOTS,
                      max_len=SSM_SERVE_PROMPT + SSM_SERVE_NEW, device=dev)
    eng.warm(SSM_SERVE_PROMPT)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, SSM_SERVE_PROMPT).astype(np.int32),
        max_new_tokens=SSM_SERVE_NEW) for i in range(SSM_SERVE_REQUESTS)]
    before = dict(eng.stats)
    ssd_scan.launches = 0
    out, wall = timed(lambda: eng.run(reqs))
    launches = ssd_scan.launches
    stats = {k: eng.stats[k] - before[k] for k in eng.stats}
    tokens = sum(len(t) for t in out.values())
    print(f"serve {cfg.name}: {SSM_SERVE_REQUESTS} requests x prompt "
          f"{SSM_SERVE_PROMPT} + {SSM_SERVE_NEW} new, {SSM_SERVE_SLOTS} "
          f"slots: {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} "
          f"tokens/s, stats {stats}, ssd_scan launches={launches}",
          flush=True)
    waves = -(-SSM_SERVE_REQUESTS // SSM_SERVE_SLOTS)
    check(stats == {"prefills": SSM_SERVE_REQUESTS,
                    "decode_steps": waves * (SSM_SERVE_NEW - 1),
                    "tokens_out": SSM_SERVE_REQUESTS * SSM_SERVE_NEW},
          f"serve {cfg.name}: stats {stats}")
    check(all(len(t) == SSM_SERVE_NEW and all(0 <= x < cfg.vocab_size
                                              for x in t)
              for t in out.values()),
          f"serve {cfg.name}: a request's tokens are missing or outside the "
          "vocab")
    check(launches == 0, f"serve {cfg.name}: ssd_scan launched {launches} "
                         "times; prefill and decode do not run it")


def sass_counts(build):
    """What the tensor cores run: ``cuobjdump -sass`` counts of HGMMA (wgmma)
    in the bf16 flash kernels and of HMMA (mma.sync) and HGMMA in the bf16
    instances of the SSD kernel's chunk_scan; each must be above 0.  Where
    the toolkit has no cuobjdump, it says so and checks the PTX of the
    flash source for wgmma instead."""
    import re
    import shutil
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = next((t for t in (os.path.join(home, "bin", "cuobjdump"),
                             shutil.which("cuobjdump") or "")
                 if t and os.path.isfile(t)), None)
    if tool is None:
        ptx = subprocess.run(
            [build._nvcc(), "-gencode", "arch=compute_90a,code=compute_90a",
             "-std=c++17", "-ptx", "-o", "-",
             str(build.CSRC / "flash_attention.cu")],
            capture_output=True, text=True, check=True).stdout
        n = ptx.count("wgmma.mma_async")
        print(f"cuobjdump not found in the toolkit: no SASS counts; the PTX "
              f"of flash_attention.cu holds {n} wgmma.mma_async", flush=True)
        check(n > 0, "flash_attention.cu: no wgmma in its PTX")
        return
    for lib, want in (("flash_attention", "flash_fwd_bf16"),
                      ("ssd_scan", "chunk_scanI13__nv_bfloat16")):
        sass = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1) if want in m.group(1) else None
                if fn:
                    counts[fn] = {"HMMA": 0, "HGMMA": 0}
            elif fn:
                for op in ("HGMMA", "HMMA"):
                    if re.search(rf"\b{op}\.", line):
                        counts[fn][op] += 1
        for fn, c in counts.items():
            print(f"sass {lib} {fn}: HGMMA={c['HGMMA']} HMMA={c['HMMA']}",
                  flush=True)
        op = "HGMMA" if lib == "flash_attention" else "HMMA"
        check(counts and all(c[op] > 0 for c in counts.values()),
              f"{lib}: a bf16 kernel without {op} in its SASS: {counts}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # both float32 matmul and cuDNN in full float32: waterfill's link
    # counts need it (TF32 keeps 10 mantissa bits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device("cuda", 0)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    sources = ["maxmin_fair", "flash_attention", "ssd_scan"]
    _build.build_libraries(sources)
    for name in sources:
        _build.load_library(name)
    print(f"kernel build: {', '.join(n + '.cu' for n in sources)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in sources:
        print(_build.build_log(name).strip(), flush=True)
    sass_counts(_build)

    from repro_torch.core.apps.hpl import HPLConfig
    from repro_torch.core.fastsim import FastSimParams, simulate_hpl_fast
    from repro_torch.core.hardware.node import local_node
    from repro_torch.kernels.maxmin_fair import (masked_min_rows, waterfill,
                                                 waterfill_ref)

    adj, caps, frontera_rec = kernel_phase(dev)

    # ---- the main path: launch counts start at 0 here
    masked_min_rows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rates_k = waterfill(adj, caps)
    torch.cuda.synchronize()
    wf_wall = time.perf_counter() - t0
    wf_iters = masked_min_rows.launches
    print(f"waterfill frontera 8008x18200: iterations={wf_iters} "
          f"wall_s={wf_wall:.4f}", flush=True)

    t0 = time.perf_counter()
    anchor = simulate_hpl_fast(HPLConfig(N=4096, nb=128, P=4, Q=4),
                               FastSimParams.from_node(
                                   local_node(), link_bw=100e9 / 8),
                               device=dev)["time_s"]
    err = rel_err(anchor, REFERENCE_TIME_S["bdw-local"])
    print(f"simulate_hpl_fast bdw-local anchor: time_s={anchor!r} "
          f"rel_err={err:.3e} wall_s={time.perf_counter() - t0:.3f}",
          flush=True)
    check(err <= 1e-12, f"anchor rel err {err} > 1e-12")
    singles = {"bdw-local": anchor}
    for name in ("tpu-v5e-pod", "syn-mp-2pod-v5e", "frontera"):
        singles[name] = predict_phase(dev, name)
    grid_phase(dev, singles["frontera"])
    forced_bucket_phase(dev, singles)
    torch.cuda.synchronize()
    launches = masked_min_rows.launches
    print(f"main path launches: masked_min_rows={launches}", flush=True)
    check(launches > 0, "masked_min_rows was not launched on the main path")

    # ---- waterfill: kernel against plain, and link conservation
    rates_p = waterfill_ref(adj, caps)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(rates_k).all()), "waterfill: non-finite rate")
    check(torch.allclose(rates_k, rates_p, rtol=1e-4, atol=0.0),
          "waterfill: kernel and plain differ beyond rtol 1e-4")
    flows, links = adj.nonzero(as_tuple=True)
    usage = torch.zeros(adj.shape[1], dtype=torch.float64, device=dev)
    usage.index_add_(0, links, torch.clamp(rates_k.double(), max=1e30)[flows])
    check(bool((usage <= caps.double() * (1 + 1e-3)).all()),
          "waterfill: link usage exceeds capacity")
    wf_err = float((rates_k - rates_p).abs().max())
    print(f"waterfill: kernel vs plain max_abs_err={wf_err} (rtol 1e-4 ok), "
          f"conservation ok, min_rate={float(rates_k.min())!r} "
          f"max_rate={float(rates_k.max())!r}", flush=True)

    # ---- LM serving: qwen2-0.5b at full width, flash attention in prefill
    from repro_torch.configs import get_config
    flash_rec = flash_phase(dev)
    cfg = get_config(LM_ARCH)
    params = lm_params(cfg, dev)
    flash_launches = serve_phase(dev, cfg, params)
    prefill_phase(dev, cfg, params)
    del params

    # ---- Mamba-2: the SSD kernel, mamba2-780m scoring and serving
    ssd_rec = ssd_phase(dev)
    scfg = get_config(SSM_ARCH)
    sparams = lm_params(scfg, dev)
    ssd_launches = ssm_loss_phase(dev, scfg, sparams)
    ssm_serve_phase(dev, scfg, sparams)

    kernels = [{
        "name": "masked_min_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/maxmin_fair.cu",
        "replaces": "src/repro/kernels/maxmin_fair/kernel.py:41",
        "launches": launches, "max_abs_err": frontera_rec["max_abs_err"],
        "ms": frontera_rec["ms"], "plain_ms": frontera_rec["plain_ms"],
        "bound_ms": frontera_rec["bound_ms"], "bound_by": "bytes",
        "library_ms": None}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
        "launches": flash_launches, **flash_rec}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:67",
        "launches": ssd_launches, **ssd_rec}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
