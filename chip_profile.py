#!/usr/bin/env python3
"""Where the port's main paths spend their time, on one NVIDIA GPU.

    python3 chip_profile.py [--only hpl|lm|ssm]

HPL: Frontera's geometry (88 x 91 grid, nb=384, bucket P_max = Q_max =
96) cut to 512 panels, at 1 lane and at 64 what-if lanes, through
``sweep_hpl``.  LM: full-width qwen2-0.5b with seeded weights, as
``ServeEngine`` runs it: a 1 x 128 prefill, a decode step of a 4-slot
wave with a 160-position cache, and a 4 x 2048 prefill, each with the
flash-attention kernel.  SSM: full-width mamba2-780m in bf16 with seeded
weights: a 4 x 2048 ``Model.forward`` with the SSD chunk-scan kernel (the
scoring path of ``Model.loss``), and a decode step of a 4-slot wave after
a 128-token prefill (as ``ServeEngine`` runs it).  For each it prints the
wall time per step (host clock, ending in a device sync) and, from
``torch.profiler`` over one more run, the CUDA kernels launched per step,
the device busy share (summed kernel time over the profiled wall time)
and, for the LM and SSM cases, the kernels that take the most device
time.  The last line is one JSON object of
those numbers with the card's name and power limit.  Needs a CUDA
device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_PANELS = 512


def profiled(run, steps):
    """Wall time of ``run`` (after a warm-up), then one profiled run:
    kernels per step, device busy share and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    run()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    if not kernels:
        print("profiler recorded no device kernels: device time not "
              "measured", flush=True)
    return {"wall_s": wall, "ms_per_step": wall / steps * 1e3,
            "profiled_wall_s": prof_wall,
            "kernels_per_step": len(kernels) / steps,
            "device_busy_s": busy_s,
            "device_busy_share": busy_s / prof_wall,
            "device_us_per_kernel": (busy_s / len(kernels) * 1e6
                                     if kernels else None),
            "top_kernels": [(name[:60], us * 1e-6 / busy_s)
                            for name, us in top] if kernels else []}


def profile_lm(dev, out):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg, use_kernel=True, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    short = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen,
                          device=dev)
    long = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen,
                         device=dev)
    n_decode = 16

    def prefill(tokens, max_len):
        def run():
            model.prefill(params, {"tokens": tokens}, max_len=max_len)
            torch.cuda.synchronize()
        return run

    with torch.inference_mode():
        cache, _ = model.prefill(params, {"tokens": short}, max_len=160)
        step_tokens = short[:, :1]

        def decode():
            cache["len"] = 128
            for _ in range(n_decode):
                model.decode(params, cache, step_tokens)
            torch.cuda.synchronize()

        cases = {"prefill_1x128": (prefill(short[:1], 160), 1),
                 f"decode_4slots_x{n_decode}": (decode, n_decode),
                 "prefill_4x2048": (prefill(long, 2048), 1)}
        for name, (run, steps) in cases.items():
            rec = profiled(run, steps)
            out[f"lm_{name}"] = rec
            print(f"qwen2-0.5b {name}: " + " ".join(
                f"{k}={v}" for k, v in rec.items()), flush=True)


def profile_ssm(dev, out):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("mamba2-780m")
    model = build_model(cfg, use_kernel=True, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    long = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen,
                         device=dev)
    n_decode = 16

    def forward():
        model.forward(params, {"tokens": long})
        torch.cuda.synchronize()

    with torch.inference_mode():
        cache, _ = model.prefill(params, {"tokens": long[:, :128]},
                                 max_len=160)
        step_tokens = long[:, :1]

        def decode():
            for _ in range(n_decode):
                model.decode(params, cache, step_tokens)
            torch.cuda.synchronize()

        cases = {"forward_4x2048": (forward, 1),
                 f"decode_4slots_x{n_decode}": (decode, n_decode)}
        for name, (run, steps) in cases.items():
            rec = profiled(run, steps)
            out[f"ssm_{name}"] = rec
            print(f"mamba2-780m {name}: " + " ".join(
                f"{k}={v}" for k, v in rec.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=("hpl", "lm", "ssm"))
    only = parser.parse_args().only
    sys.path.insert(0, os.path.join(ROOT, "src"))

    from repro_torch.core.fastsim import bucket_key, sweep_hpl
    from repro_torch.platforms import get_platform

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    out = {"card": card}
    if only in (None, "lm"):
        profile_lm(dev, out)
    if only in (None, "ssm"):
        profile_ssm(dev, out)
    if only in ("lm", "ssm"):
        print(json.dumps(out), flush=True)
        return 0
    plat = get_platform("frontera")
    cfg = plat.hpl_config(N=N_PANELS * plat.scale.hpl_nb)
    steps = bucket_key(cfg)[0]
    base = plat.fastsim()
    out["config"] = {"N": cfg.N, "nb": cfg.nb, "P": cfg.P, "Q": cfg.Q,
                     "loop_steps": steps}
    for lanes in (1, 64):
        prms = [dataclasses.replace(base, link_bw=base.link_bw * (1 + i / 64))
                for i in range(lanes)]

        def run():
            sweep_hpl(cfg, prms if lanes > 1 else prms[0], device=dev)
            torch.cuda.synchronize()

        rec = profiled(run, steps)      # the first run builds the tables
        del rec["top_kernels"]
        out[f"lanes_{lanes}"] = rec
        print(f"lanes={lanes}: " + " ".join(
            f"{k}={v}" for k, v in rec.items()), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
