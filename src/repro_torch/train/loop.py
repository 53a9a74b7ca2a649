"""The training loop, the port of ``repro.train.loop``: data, step,
checkpoints and the straggler monitor.

``train`` takes the reference's keywords and returns its dict; it adds
``device=`` (default ``"cuda"``, which raises without a card).  It is
restart-safe as the reference's is: it resumes from the latest
checkpoint under ``ckpt_dir`` and replays the data stream from that step,
so a resumed run computes what a straight run does, bit for bit on one
device.  The parameters are drawn on a CPU generator seeded ``seed`` and
moved to ``device``, so every device starts from the same weights (the
port's own draw, not the reference's ``PRNGKey(seed)``).

The reference jits its step with the state donated; the port's step is
eager and pure, and dropping the old state after each step is what
donation did.  The reference's edge cases are kept: a resume at or past
``steps`` runs no step, returns NaN losses and still saves the restored
state as step ``steps``; with ``steps % ckpt_every == 0`` the last step
is saved twice.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.ft import StepTimeMonitor

from .state import make_train_state
from .step import make_train_step


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          lr: float = 3e-4, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, microbatches: int = 1,
          log_every: int = 10, seed: int = 0,
          log_fn: Callable[[str], None] = print,
          device: DeviceLike = "cuda") -> Dict:
    """Single-process training on ``device``. Returns final metrics."""
    dev = resolve_device(device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=seed)
    ds = SyntheticLM(dcfg)
    step_fn, _ = make_train_step(cfg, lr=lr, microbatches=microbatches,
                                 device=dev)

    state = make_train_state(cfg, torch.Generator().manual_seed(seed),
                             device=dev)
    start = 0
    ckpt = None
    if ckpt_dir:
        ckpt = AsyncCheckpointer(ckpt_dir)
        last = latest_step(ckpt_dir)
        if last is not None:
            state = restore_checkpoint(ckpt_dir, last, state, device=dev)
            start = last
            log_fn(f"[train] resumed from step {last}")

    monitor = StepTimeMonitor()
    losses = []
    extras = {}
    if cfg.family == "encdec":
        extras["encoder_embeds"] = torch.zeros(
            (global_batch, cfg.encoder_seq, cfg.d_model), dtype=torch.float32,
            device=dev)
    if cfg.family == "vlm":
        extras["image_embeds"] = torch.zeros(
            (global_batch, cfg.n_image_tokens, cfg.d_model),
            dtype=torch.float32, device=dev)

    for step in range(start, steps):
        batch = {"tokens": torch.as_tensor(ds.shard_at(step, 0, 1),
                                           device=dev), **extras}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        # the read waits for the device: dt ends after the step's last kernel
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        flagged = monitor.record(dt)
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            log_fn(f"[train] step {step:5d} loss {loss:.4f} "
                   f"({dt*1e3:.0f} ms{' STRAGGLER' if flagged else ''})")
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, state)
    if ckpt:
        ckpt.save(steps, state)
        ckpt.wait()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "losses": losses, "state": state,
            "median_step_s": monitor.median}
