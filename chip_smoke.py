#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from src/repro_torch/csrc/ (one nvcc per
source, all at once) and holds each against its plain torch version, then
drives each main path through the entry points a user calls, with the
launch counts set to 0 just before it and read just after:

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
    planted faults that the comparison must catch.

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
FLASH_SHAPES = [(1, 128, 1, 1, 64), (2, 256, 2, 4, 64), (1, 256, 1, 7, 32),
                (1, 512, 4, 2, 128), (1, 200, 2, 7, 64),
                (1, SERVE_PROMPT, 2, 7, 64)]
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
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        (q, k, v), err, exact = check_flash(FLASH_PREFILL, True, dtype, dev,
                                            99)
        if dtype == torch.bfloat16:
            planted_tile_faults(q, k, v, exact)
        del exact
        b, s, g, r, hd = FLASH_PREFILL
        qs = q.reshape(b, s, g * r, hd).transpose(1, 2)
        ks, vs = k.transpose(1, 2), v.transpose(1, 2)
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
    returns the prefill wall seconds and every tensor to compare."""
    from repro_torch.models import build_model
    model = build_model(cfg, use_kernel=use_kernel, device=dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = model.prefill(params, {"tokens": tokens[:, :-steps]},
                                      max_len=tokens.shape[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs = [logits, cache["k"].clone(), cache["v"].clone()]
        for i in range(steps):
            n = tokens.shape[1] - steps + i
            cache, logits = model.decode(params, cache, tokens[:, n:n + 1])
            outs.append(logits)
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
    sources = ["maxmin_fair", "flash_attention"]
    _build.build_libraries(sources)
    for name in sources:
        _build.load_library(name)
    print(f"kernel build: {', '.join(n + '.cu' for n in sources)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in sources:
        print(_build.build_log(name).strip(), flush=True)

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
        "launches": flash_launches, **flash_rec}]
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
