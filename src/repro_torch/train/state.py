"""The train state, the port of ``repro.train.step``'s ``TrainState`` and
``make_train_state``: what a checkpoint saves and restores and what
``train.step`` updates."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import build_model

from .optimizer import opt_init


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor


def make_train_state(cfg, generator: torch.Generator, *,
                     device: DeviceLike = "cuda") -> TrainState:
    """Parameters drawn from ``generator`` (``Model.init``) on ``device``,
    the optimizer state ``cfg.optimizer`` starts from, and step 0 (a 0-d
    int32 tensor)."""
    dev = resolve_device(device)
    params = build_model(cfg, device=dev).init(generator)
    return TrainState(params=params, opt=opt_init(cfg.optimizer)(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))
