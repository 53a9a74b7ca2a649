"""AdamW over lists of tensors, the port of ``repro.train.optimizer``'s
AdamW (Adafactor waits for the training slice, ROADMAP §1 slice 8c).

Every step runs in float32, as the reference's does: the moments are
float32, the gradient is cast to float32 before it enters them, the bias
corrections ``1 - b**count`` are float32, and a parameter is updated in
float32 and cast back to its own dtype.  A float64 parameter is therefore
rounded to float32 at every step, as in the reference.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

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


def adamw_init(params: Sequence[torch.Tensor]) -> Dict:
    return {"m": [torch.zeros(p.shape, dtype=F32, device=p.device)
                  for p in params],
            "v": [torch.zeros(p.shape, dtype=F32, device=p.device)
                  for p in params],
            "count": 0}


def _bias_correction(b: float, count: int, device: torch.device
                     ) -> torch.Tensor:
    """``1 - b**count`` in float32, computed on the host CPU (as the
    reference computes it) and moved to ``device``: the device's float32
    ``pow`` need not round as the host's does."""
    b32 = torch.tensor(b, dtype=F32)
    c32 = torch.tensor(float(count), dtype=F32)
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
    new_p, new_m, new_v = [], [], []
    # Python scalars meet float32 tensors in float32, as JAX's weakly
    # typed scalars do
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        g = g.to(F32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / _bias_correction(b1, count, p.device)
        vhat = v / _bias_correction(b2, count, p.device)
        step = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(F32)
        new_p.append((p.to(F32) - lr * step).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return new_p, {"m": new_m, "v": new_v, "count": count}, gn
