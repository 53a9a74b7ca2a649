#!/usr/bin/env python3
"""Where the port's fastsim panel loop spends its time, on one NVIDIA GPU.

    python3 chip_profile.py

Runs Frontera's geometry (88 x 91 grid, nb=384, bucket P_max = Q_max = 96)
cut to 512 panels, at 1 lane and at 64 what-if lanes, through
``sweep_hpl``.  For each it prints the wall time per loop step (host
clock, ending in a device sync) and, from ``torch.profiler`` over one
more run, the CUDA kernels launched per step and the device busy share
(summed kernel time over the profiled wall time).  The last line is one
JSON object of those numbers with the card's name and power limit.
Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_PANELS = 512


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.fastsim import bucket_key, sweep_hpl
    from repro_torch.platforms import get_platform

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    plat = get_platform("frontera")
    cfg = plat.hpl_config(N=N_PANELS * plat.scale.hpl_nb)
    steps = bucket_key(cfg)[0]
    base = plat.fastsim()
    out = {"card": card, "config": {"N": cfg.N, "nb": cfg.nb, "P": cfg.P,
                                    "Q": cfg.Q, "loop_steps": steps}}
    for lanes in (1, 64):
        prms = [dataclasses.replace(base, link_bw=base.link_bw * (1 + i / 64))
                for i in range(lanes)]

        def run():
            sweep_hpl(cfg, prms if lanes > 1 else prms[0], device=dev)
            torch.cuda.synchronize()

        run()                                   # builds the bucket tables
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            prof_wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if e.device_type.name == "CUDA"]
        busy_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
        rec = {"lanes": lanes, "wall_s": wall,
               "ms_per_step": wall / steps * 1e3,
               "profiled_wall_s": prof_wall,
               "kernels_per_step": len(kernels) / steps,
               "device_busy_s": busy_s,
               "device_busy_share": busy_s / prof_wall,
               "device_us_per_kernel": (busy_s / len(kernels) * 1e6
                                        if kernels else None)}
        out[f"lanes_{lanes}"] = rec
        print(f"lanes={lanes}: " + " ".join(
            f"{k}={v}" for k, v in rec.items() if k != "lanes"), flush=True)
        if not kernels:
            print("profiler recorded no device kernels: device time not "
                  "measured", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
