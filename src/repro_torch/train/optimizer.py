"""The port of ``repro.train.optimizer``: AdamW and Adafactor, their
inits and updates, and ``opt_init`` / ``opt_update`` by name.  Every
function takes trees of tensors (nested dicts, lists, tuples and
``NamedTuple``s), as the reference's take pytrees, flattened in the
reference's one order (``repro_torch._tree``); gradient calibration steps
a list ``[theta]`` with AdamW.  The states have the reference's layout:
``{"m": tree, "v": tree, "count": 0-d int32}`` for AdamW and ``{"f": tree
of {"vr", "vc"} or {"v"}, "count": 0-d int32}`` for Adafactor, the count
on the device of the first parameter.  ``opt_state_specs`` gives the
states' logical sharding specs from the parameters' (plain tuples, for
``repro_torch.sharding``); no update reads them, since the port runs on
one device.

Every step runs in float32, as the reference's does: the moments are
float32, the gradient is cast to float32 before it enters them, AdamW's
bias corrections ``1 - b**count`` are float32, and a parameter is updated
in float32 and cast back to its own dtype.  A float64 parameter is
therefore rounded to float32 at every step, as in the reference.  The
updates are pure: they return new tensors and modify none they are given.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch._tree import leaves, map_with_keys, unflatten
from repro_torch.sharding.specs import map_specs

F32 = torch.float32


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf (0-d float32),
    summed in flatten order."""
    total = sum(torch.sum(torch.square(x.to(F32))) for x in leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """``grads`` scaled down to a global norm of at most ``max_norm``, and
    the global norm before the scaling."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return map_with_keys(lambda _, g: g * scale, grads), gn


def _leaves_like(params, tree, what: str) -> list:
    """``tree``'s leaves, one for each leaf of ``params`` (gradients and
    AdamW's moments have the parameters' tree)."""
    out, n = leaves(tree), len(leaves(params))
    if len(out) != n:
        raise ValueError(f"{what}: {len(out)} leaves for {n} parameters")
    return out


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


def adamw_update(params, grads, state: Dict, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0
                 ) -> Tuple[Any, Dict, torch.Tensor]:
    """One AdamW step on trees; returns ``(new_params, new_state,
    grad_norm)``, ``grad_norm`` taken before the clip."""
    grads, gn = clip_by_global_norm(_leaves_like(params, grads, "grads"),
                                    max_grad_norm)
    count = state["count"] + 1
    n = int(count)               # the one read of the count per update
    corrections: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
    new_p, new_m, new_v = [], [], []
    # Python scalars meet float32 tensors in float32, as JAX's weakly
    # typed scalars do
    for p, g, m, v in zip(leaves(params), grads,
                          _leaves_like(params, state["m"], "m"),
                          _leaves_like(params, state["v"], "v")):
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
    return (unflatten(params, new_p),
            {"m": unflatten(params, new_m), "v": unflatten(params, new_v),
             "count": count}, gn)


def _factors(params, f) -> list:
    """Adafactor's moments parameter by parameter: ``f``'s leaves taken in
    flatten order, two for a factored parameter (a dict's keys flatten
    sorted: "vc", then "vr") and one ("v") for any other."""
    it = iter(leaves(f))
    out = [{"vc": next(it), "vr": next(it)} if _factored(p.shape)
           else {"v": next(it)} for p in leaves(params)]
    if next(it, None) is not None:
        raise ValueError("adafactor_update: more moments than parameters")
    return out


def _adafactor_one(p: torch.Tensor, g: torch.Tensor, f: Dict, *, lr: float,
                   decay: float, eps: float, weight_decay: float,
                   clip_threshold: float) -> Tuple[torch.Tensor, Dict]:
    """One leaf's Adafactor step: (new parameter, new moments)."""
    g = g.to(F32)
    g2 = torch.square(g) + eps
    if _factored(p.shape):
        vr = decay * f["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
        vc = decay * f["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
        rfac = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                min=eps)
        update = g / (torch.sqrt(rfac)[..., None]
                      * torch.sqrt(vc)[..., None, :] + 1e-12)
        newf = {"vr": vr, "vc": vc}
    else:
        v = decay * f["v"] + (1 - decay) * g2
        update = g / (torch.sqrt(v) + 1e-12)
        newf = {"v": v}
    rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-12)
    update = update / torch.clamp(rms / clip_threshold, min=1.0)
    p32 = p.to(F32)
    return (p32 - lr * update - lr * weight_decay * p32).to(p.dtype), newf


def adafactor_update(params, grads, state: Dict, *, lr: float,
                     decay: float = 0.99, eps: float = 1e-30,
                     weight_decay: float = 0.0, max_grad_norm: float = 1.0,
                     clip_threshold: float = 1.0
                     ) -> Tuple[Any, Dict, torch.Tensor]:
    """One Adafactor step on trees; returns ``(new_params, new_state,
    grad_norm)``.  A leaf of two or more axes keeps the row and column
    means of ``g**2 + eps`` (decayed), and divides by the square root of
    their outer product normalised by the row mean; any other leaf keeps
    the full ``v``.  Each leaf's update is scaled down to an RMS of at
    most ``clip_threshold``."""
    grads, gn = clip_by_global_norm(_leaves_like(params, grads, "grads"),
                                    max_grad_norm)
    out = [_adafactor_one(p, g, f, lr=lr, decay=decay, eps=eps,
                          weight_decay=weight_decay,
                          clip_threshold=clip_threshold)
           for p, g, f in zip(leaves(params), grads,
                              _factors(params, state["f"]))]
    return (unflatten(params, [o[0] for o in out]),
            {"f": unflatten(params, [o[1] for o in out]),
             "count": state["count"] + 1}, gn)


def opt_update(name: str) -> Callable:
    return {"adamw": adamw_update, "adafactor": adafactor_update}[name]


def opt_state_specs(name: str, param_specs):
    """Logical specs for the optimizer state, mirroring param specs:
    AdamW's moments take the parameters' specs; Adafactor's row means
    drop the last dim and its column means the one before it, and a leaf
    of fewer than two dims keeps its spec for ``v``; ``count`` is
    replicated."""
    if name == "adamw":
        return {"m": param_specs, "v": param_specs, "count": None}

    def one(spec):
        if len(spec) >= 2:
            return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
        return {"v": spec}
    return {"f": map_specs(one, param_specs), "count": None}
