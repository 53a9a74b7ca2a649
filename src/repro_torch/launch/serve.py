"""Serving launcher: seeded requests through ``ServeEngine``, one line of
results (reduced configs under ``--smoke`` run on the CPU too; the full
width runs on the card).

    python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 8
    python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \\
        --requests 8 --device cpu

Port of ``repro.launch.serve``: the same flags, defaults, requests
(``np.random.default_rng(0)`` prompts) and cache length
(``prompt_len + max_new + 1``), and the same printed line.  ``--device``
(default ``cuda``) names the device; without a card the launcher raises
``RuntimeError`` unless given ``--device cpu``.  The weights are the
port's own seed-0 draw (``Model.init`` on a CPU generator seeded 0,
moved to the device), so ``--device cpu`` and ``--device cuda`` serve
the same weights; they are not the reference's
``model.init(jax.random.PRNGKey(0))``, so the tokens are not the
reference launcher's.  ``serve`` takes any weights: given the
reference's tree through ``convert.lm_params_from_reference`` it serves
the reference's tokens.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine


def seed_params(cfg, device: DeviceLike = "cuda"):
    """The launcher's weights: ``cfg``'s seed-0 init drawn on the CPU and
    moved to ``device``, so every device serves the same ones."""
    return build_model(cfg, device=device).init(
        torch.Generator().manual_seed(0))


def serve(cfg, params, *, requests: int = 8, prompt_len: int = 32,
          max_new: int = 16, batch_slots: int = 4,
          device: DeviceLike = "cuda"):
    """Serve ``requests`` seeded prompts of ``prompt_len`` tokens,
    ``max_new`` new tokens each, in waves of ``batch_slots``, and print
    the reference launcher's line.  Returns (tokens by request id, the
    engine's ``stats``, wall seconds)."""
    eng = ServeEngine(cfg, params, batch_slots=batch_slots,
                      max_len=prompt_len + max_new + 1, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        prompt_len).astype(np.int32),
                    max_new_tokens=max_new)
            for i in range(requests)]
    t0 = time.perf_counter()
    # the engine reads every token back to the host (``int``, ``tolist``),
    # which waits for the device: dt ends after its last step
    results = eng.run(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in results.values())
    print(f"[serve] {len(results)} requests, {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s) — stats {eng.stats}", flush=True)
    return results, dict(eng.stats), dt


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda; cpu runs "
                         "without a card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    return serve(cfg, seed_params(cfg, dev), requests=args.requests,
                 prompt_len=args.prompt_len, max_new=args.max_new,
                 batch_slots=args.batch_slots, device=dev)


if __name__ == "__main__":
    main()
