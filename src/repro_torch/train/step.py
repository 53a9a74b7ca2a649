"""The training step, the port of ``repro.train.step``.

``make_train_step(cfg, ...)`` returns ``(train_step, model)``, and
``train_step(state, batch)`` returns ``(new_state, metrics)``, with the
reference's semantics: the gradient of ``Model.loss`` (the plain paths:
no kernel has a backward), optionally accumulated over ``microbatches``
slices of the batch's leading axis (float32 gradients summed, then
divided by their number; the loss their mean, the other metrics the last
slice's), optionally passed through int8 compression leaf by leaf, then
the update ``cfg.optimizer`` names.  ``metrics`` is the loss's metrics
with ``loss`` and ``grad_norm`` (the global norm before the clip), and
the new state carries ``step + 1``.

The step is pure: gradients come from ``torch.autograd.grad`` on detached
copies of the parameters, so nothing accumulates into any ``.grad`` and
the input state is left as it was.  The reference's jit and ``lax.scan``
over microbatches have no counterpart here: the port runs eagerly on one
device.  ``state_specs`` gives the train state's logical sharding specs
(for ``repro_torch.sharding`` and the dry-run's per-device bytes); the
step itself reads none.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch._device import DeviceLike
from repro_torch._tree import leaves, map_with_keys, unflatten
from repro_torch.models import build_model

from .optimizer import opt_state_specs, opt_update
from .state import TrainState, make_train_state

__all__ = ["TrainState", "make_train_state", "make_train_step",
           "train_step", "loss_and_grads", "compress_grads", "state_specs"]

F32 = torch.float32


def state_specs(cfg, model) -> TrainState:
    """The logical specs of ``make_train_state``'s tree: the model's
    parameter specs, the optimizer state's, and a replicated step."""
    pspec = model.param_specs()
    return TrainState(params=pspec,
                      opt=opt_state_specs(cfg.optimizer, pspec),
                      step=None)


def _quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values and their float32 scale ``max(max|g|, 1e-8) / 127``;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-8) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_grads(grads):
    """Every leaf of ``grads`` quantized to int8 with its own scale and
    dequantized again (what crosses the reference's cross-pod reduction)."""
    return map_with_keys(lambda _, g: _dequantize_int8(*_quantize_int8(g)),
                         grads)


def _microbatch_mean(total: List[torch.Tensor], n: int
                     ) -> List[torch.Tensor]:
    """The accumulated gradients divided by the number of microbatches."""
    return [g / n for g in total]


def _split(batch, microbatches: int) -> List[Any]:
    """``batch`` cut along its leading axis into ``microbatches`` equal
    slices, in order (the reference's reshape to (microbatches, b / m))."""
    sizes = {x.shape[0] for x in leaves(batch)}
    if len(sizes) != 1 or next(iter(sizes)) % microbatches:
        raise ValueError(f"train_step: a batch of leading sizes "
                         f"{sorted(sizes)} does not split into "
                         f"{microbatches} microbatches")
    n = next(iter(sizes)) // microbatches
    return [map_with_keys(lambda _, x, i=i: x[i * n:(i + 1) * n], batch)
            for i in range(microbatches)]


def loss_and_grads(model, params, batch, *, microbatches: int = 1
                   ) -> Tuple[torch.Tensor, Dict, Any]:
    """``(loss, metrics, grads)`` of ``model.loss`` at ``params`` on
    ``batch``; ``grads`` has the tree of ``params`` (a leaf the loss does
    not reach gets zeros, as in jax).  Neither ``params`` nor any
    ``.grad`` is touched."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    tree = unflatten(params, flat)
    parts = [batch] if microbatches <= 1 else _split(batch, microbatches)
    total, lsum, metrics = None, None, {}
    with torch.enable_grad():
        for part in parts:
            loss, metrics = model.loss(tree, part)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(flat, grads)]
            loss = loss.detach()
            if total is None:
                total, lsum = grads, loss
            else:
                total = [a + g for a, g in zip(total, grads)]
                lsum = lsum + loss
    metrics = {k: v.detach() for k, v in metrics.items()}
    if microbatches > 1:
        total = _microbatch_mean(total, microbatches)
        lsum = lsum / microbatches
    return lsum, metrics, unflatten(params, total)


def make_train_step(cfg, *, lr: float = 3e-4, microbatches: int = 1,
                    grad_compression: bool = False, use_kernel: bool = False,
                    device: DeviceLike = "cuda"
                    ) -> Tuple[Callable, Any]:
    """Returns ``(train_step, model)``: ``train_step(state, batch) ->
    (state, metrics)`` on ``device`` (default ``"cuda"``, which raises
    without a card).  ``use_kernel=True`` raises ``RuntimeError`` on every
    device: neither kernel has a backward (nor has the reference's)."""
    if use_kernel:
        raise RuntimeError(
            "make_train_step: use_kernel=True, but the flash-attention and "
            "SSD-scan kernels have no backward (nor have the reference's "
            "Pallas kernels); train with use_kernel=False")
    model = build_model(cfg, use_kernel=False, device=device)
    update = opt_update(cfg.optimizer)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, metrics, grads = loss_and_grads(model, state.params, batch,
                                              microbatches=microbatches)
        if grad_compression:
            grads = compress_grads(grads)
        with torch.no_grad():
            new_params, new_opt, gnorm = update(state.params, grads,
                                                state.opt, lr=lr)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step, model


def train_step(cfg, state: TrainState, batch, **kw):
    """One step of ``make_train_step(cfg, **kw)``."""
    step_fn, _ = make_train_step(cfg, **kw)
    return step_fn(state, batch)
