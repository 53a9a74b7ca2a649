"""Training launcher.

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 3 \\
        --global-batch 4 --seq-len 256
    python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \\
        --steps 50 --device cpu

Port of ``repro.launch.train``: the same flags and defaults, the loop's
step lines and the same closing line.  ``--device`` (default ``cuda``)
names the device; without a card the launcher raises ``RuntimeError``
unless given ``--device cpu``.  ``--smoke`` trains the reduced config;
without it the config trains at full width (on the card).  The weights
are the port's own seed-0 draw (``train``'s CPU generator), not the
reference's ``PRNGKey(0)``, unless ``--ckpt-dir`` holds a checkpoint to
resume from.  ``--dryrun`` describes the production cell instead: it
starts ``python -m repro_torch.launch.dryrun --arch --shape
[--multi-pod]`` in a child and exits with its code, as the reference's
launcher starts its dry-run.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.train.loop import train


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--dryrun", action="store_true",
                    help="describe the production cell instead "
                         "(repro_torch.launch.dryrun, in a child)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default cuda; cpu runs "
                         "without a card)")
    args = ap.parse_args(argv)

    if args.dryrun:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               args.arch, "--shape", args.shape]
        if args.multi_pod:
            cmd.append("--multi-pod")
        raise SystemExit(subprocess.call(cmd))

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    res = train(cfg, steps=args.steps, global_batch=args.global_batch,
                seq_len=args.seq_len, lr=args.lr,
                microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                device=dev)
    print(f"[train] done: loss {res['first_loss']:.4f} -> "
          f"{res['final_loss']:.4f} (median step "
          f"{res['median_step_s']*1e3:.0f} ms)")
    return res


if __name__ == "__main__":
    main()
