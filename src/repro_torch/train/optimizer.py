"""The port of ``repro.train.optimizer``: AdamW's init and update, and
Adafactor's init.  The inits take any tree of tensors (nested dicts,
lists, tuples), as the reference's take pytrees, and return the
reference's state layout: ``{"m": tree, "v": tree, "count": 0-d int32}``
for AdamW and ``{"f": tree of {"vr", "vc"} or {"v"}, "count": 0-d
int32}`` for Adafactor, the count on the device of the first parameter.
``adamw_update`` steps lists of tensors (what gradient calibration
passes); the tree-aware updates and Adafactor's update come with the
training step.

Every step runs in float32, as the reference's does: the moments are
float32, the gradient is cast to float32 before it enters them, the bias
corrections ``1 - b**count`` are float32, and a parameter is updated in
float32 and cast back to its own dtype.  A float64 parameter is therefore
rounded to float32 at every step, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch._tree import map_with_keys

F32 = torch.float32


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every tensor (0-d float32)."""
    total = sum(torch.sum(torch.square(x.to(F32))) for x in tensors)
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return [g * scale for g in grads], gn


def _init(params, init_one: Callable[[torch.Tensor], Any]):
    """``init_one`` on every parameter, and the step count: a 0-d int32
    zero, as the reference's ``jnp.zeros((), jnp.int32)``, on the first
    parameter's device."""
    devices: List[torch.device] = []

    def one(_, p):
        devices.append(p.device)
        return init_one(p)
    tree = map_with_keys(one, params)
    return tree, torch.zeros((), dtype=torch.int32,
                             device=devices[0] if devices else "cpu")


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def adamw_init(params) -> Dict:
    m, count = _init(params, _zeros_f32)
    return {"m": m, "v": map_with_keys(lambda _, p: _zeros_f32(p), params),
            "count": count}


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params) -> Dict:
    """Adafactor's factored second moment: a leaf of two or more axes
    keeps a row vector (its shape without the last axis) and a column
    vector (without the second to last); any other leaf a full ``v``."""
    def init_one(p):
        shape, dev = tuple(p.shape), p.device
        if _factored(shape):
            return {"vr": torch.zeros(shape[:-1], dtype=F32, device=dev),
                    "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32,
                                      device=dev)}
        return {"v": torch.zeros(shape, dtype=F32, device=dev)}
    f, count = _init(params, init_one)
    return {"f": f, "count": count}


def opt_init(name: str) -> Callable:
    return {"adamw": adamw_init, "adafactor": adafactor_init}[name]


def _bias_correction(b: float, count: int, device: torch.device
                     ) -> torch.Tensor:
    """``1 - b**count`` in float32, computed on the host CPU (as the
    reference computes it) and moved to ``device``: the device's float32
    ``pow`` need not round as the host's does."""
    b32 = torch.tensor(b, dtype=F32)
    c32 = torch.tensor(count, dtype=F32)
    return (1.0 - torch.pow(b32, c32)).to(device)


def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], state: Dict, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0
                 ) -> Tuple[List[torch.Tensor], Dict, torch.Tensor]:
    """One AdamW step; returns ``(new_params, new_state, grad_norm)``.
    Pure: neither ``params`` nor ``state`` is modified."""
    grads, gn = clip_by_global_norm(grads, max_grad_norm)
    count = state["count"] + 1
    n = int(count)               # the one read of the count per update
    corrections: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
    new_p, new_m, new_v = [], [], []
    # Python scalars meet float32 tensors in float32, as JAX's weakly
    # typed scalars do
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        g = g.to(F32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        if p.device not in corrections:
            corrections[p.device] = (_bias_correction(b1, n, p.device),
                                     _bias_correction(b2, n, p.device))
        c1, c2 = corrections[p.device]
        mhat = m / c1
        vhat = v / c2
        step = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(F32)
        new_p.append((p.to(F32) - lr * step).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return new_p, {"m": new_m, "v": new_v, "count": count}, gn
