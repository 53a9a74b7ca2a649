"""Mixture-of-Experts layer: GShard-style einsum dispatch and the sorted
grouped path.

Port of ``repro.models.moe``: the same parameter tree (``router`` (D, E),
``wi``/``wg``/``wo`` stacked per expert, optional ``shared`` experts), the
same capacity, dispatch order, drops and balance loss.  The expert
products are plain matrix products (the reference runs them outside any
Pallas kernel too).  The sharding specs (``spec_moe``, the shared
experts' included) are the reference's, on plain tuples, for
``Model.param_specs``.  Left out: the scatter path's ``constrain`` calls
(the identity on one device, and the port runs on one).

Both paths take their routing decision from ``route`` (each token's
experts, in choice order), looked up at call time, so a caller can record
or replay the decisions by replacing ``moe.route``.  The gate weights are
always the path's own probabilities at the chosen experts.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import Layout, cast

Params = Dict[str, Any]


def layout_moe(cfg) -> Layout:
    """The reference's ``init_moe`` tree: every leaf ``"dense"``, whose
    fan-in is the leading dim (E for the stacked expert weights, as the
    reference's ``_dense_init`` gives for a 3-d shape)."""
    e = cfg.moe
    d, f, n = cfg.d_model, e.d_ff_expert, e.num_experts
    p = {"router": ((d, n), "dense"), "wi": ((n, d, f), "dense")}
    if cfg.act == "swiglu":
        p["wg"] = ((n, d, f), "dense")
    p["wo"] = ((n, f, d), "dense")
    if e.n_shared_experts:
        fs = e.n_shared_experts * f
        p["shared"] = {"wi": ((d, fs), "dense"), "wg": ((d, fs), "dense"),
                       "wo": ((fs, d), "dense")}
    return p


def spec_moe(cfg):
    e = cfg.moe
    p = {"router": (None, None)}
    if cfg.act == "swiglu":
        p["wi"] = ("ep", "fsdp", None)
        p["wg"] = ("ep", "fsdp", None)
        p["wo"] = ("ep", None, "fsdp")
    else:
        p["wi"] = ("ep", "fsdp", None)
        p["wo"] = ("ep", None, "fsdp")
    if e.n_shared_experts:
        p["shared"] = {"wi": ("fsdp", "tp"), "wg": ("fsdp", "tp"),
                       "wo": ("tp", "fsdp")}
    return p


def capacity(cfg, tokens_per_group: int) -> int:
    e = cfg.moe
    c = int(math.ceil(tokens_per_group * e.top_k * e.capacity_factor
                      / e.num_experts))
    return max(c, 1)


def route(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """The routing decision: probs (G, S, E) float32 -> each token's
    ``top_k`` experts (G, S, top_k) int64, largest probability first and
    the lower index first among equal ones (the order of the reference's
    ``jax.lax.top_k`` and of its iterated ``jnp.argmax``; ``torch.topk``
    promises no order among ties).  The reference's einsum path zeroes a
    chosen expert and takes the argmax again, which differs only if a
    token had fewer than ``top_k`` nonzero probabilities (a softmax that
    underflowed)."""
    return torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[..., :top_k]


def _topk_dispatch(gates: torch.Tensor, top_k: int, cap: int):
    """gates: (G, S, E) float32.  Returns dispatch (G, S, E, C) bool,
    combine (G, S, E, C) float32 and the balance loss.  Slots fill in
    choice order: every token's first choice before any second choice,
    tokens in sequence order within a choice; a choice past the expert's
    capacity is dropped (weight 0) but still counts in the loss."""
    g, s, e = gates.shape
    probs = torch.softmax(gates, dim=-1)
    idx = route(probs, top_k)
    slots = torch.arange(cap, device=gates.device)
    dispatch = torch.zeros((g, s, e, cap), dtype=torch.bool,
                           device=gates.device)
    combine = torch.zeros((g, s, e, cap), dtype=torch.float32,
                          device=gates.device)
    sel_so_far = torch.zeros((g, s, e), dtype=torch.int64,
                             device=gates.device)
    for j in range(top_k):
        onehot = F.one_hot(idx[..., j], e)                       # (G,S,E)
        count_prev = sel_so_far.sum(dim=1, keepdim=True)         # (G,1,E)
        pos = torch.cumsum(onehot, dim=1) - 1 + count_prev
        pos = (pos * onehot).sum(dim=-1)                          # (G,S)
        keep = pos < cap
        w = torch.gather(probs, -1, idx[..., j:j + 1])[..., 0] * keep
        # a zero row where pos >= cap (F.one_hot would raise there)
        poh = (pos[..., None] == slots).float()                   # (G,S,C)
        d_k = onehot[..., None].float() * poh[:, :, None, :]      # (G,S,E,C)
        dispatch |= d_k > 0
        combine += d_k * w[..., None, None]
        sel_so_far += onehot
    me = probs.mean(dim=1)                                        # (G,E)
    ce = (sel_so_far.float() / max(1, top_k)).mean(dim=1)
    aux = (me * ce).sum(dim=-1).mean() * e
    return dispatch, combine, aux


def _experts(p: Params, xe: torch.Tensor, cfg) -> torch.Tensor:
    """Each expert's MLP on its slots: xe (G, E, C, D) -> (G, E, C, D)."""
    dtype = xe.dtype
    h = torch.einsum("gecd,edf->gecf", xe, cast(p["wi"], dtype))
    if cfg.act == "swiglu":
        gg = torch.einsum("gecd,edf->gecf", xe, cast(p["wg"], dtype))
        h = F.silu(gg) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return torch.einsum("gecf,efd->gecd", h, cast(p["wo"], dtype))


def _shared(sp: Params, x: torch.Tensor) -> torch.Tensor:
    """The shared experts: a SwiGLU MLP every token passes through."""
    dtype = x.dtype
    hs = x @ cast(sp["wi"], dtype)
    gs = x @ cast(sp["wg"], dtype)
    return (F.silu(gs) * hs) @ cast(sp["wo"], dtype)


def _gates(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (x @ cast(p["router"], x.dtype)).float()


def apply_moe(p: Params, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> ((B, S, D), balance loss).  Groups = batch rows;
    ``cfg.moe_impl`` "scatter" takes the sorted grouped path."""
    if getattr(cfg, "moe_impl", "einsum") == "scatter":
        return apply_moe_scatter(p, x, cfg)
    e = cfg.moe
    dtype = x.dtype
    cap = capacity(cfg, x.shape[1])
    dispatch, combine, aux = _topk_dispatch(_gates(p, x), e.top_k, cap)
    xe = torch.einsum("gsec,gsd->gecd", dispatch.to(dtype), x)
    ye = _experts(p, xe, cfg)
    y = torch.einsum("gsec,gecd->gsd", combine.to(dtype), ye)
    if e.n_shared_experts:
        y = y + _shared(p["shared"], x)
    return y, aux


def apply_moe_scatter(p: Params, x: torch.Tensor, cfg
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted grouped dispatch: each row's (token, choice) slots sorted by
    expert (stably, so by token then choice within an expert), gathered
    into per-expert buffers of ``capacity`` rows, and scattered back.
    Slots past an expert's capacity all write one overflow row, which is
    discarded (several writes land there, so which one wins does not
    matter).  Drops may differ from the einsum path's at the margin: the
    two fill an expert's slots in different orders."""
    e = cfg.moe
    b, s, d = x.shape
    dtype = x.dtype
    k, n = e.top_k, e.num_experts
    cap = capacity(cfg, s)
    probs = torch.softmax(_gates(p, x), dim=-1)              # (B,S,E)
    idx = route(probs, k)                                    # (B,S,k)
    w = torch.gather(probs, -1, idx)
    sk = s * k
    eid = idx.reshape(b, sk)                                 # expert per slot
    wgt = w.reshape(b, sk)
    tok = (torch.arange(sk, device=x.device) // k).expand(b, sk)

    order = torch.argsort(eid, dim=1, stable=True)           # (B, S*k)
    eid_s = torch.gather(eid, 1, order)
    tok_s = torch.gather(tok, 1, order)
    counts = F.one_hot(eid, n).sum(dim=1)                    # (B,E)
    starts = torch.cumsum(counts, dim=1) - counts            # exclusive
    pos = (torch.arange(sk, device=x.device)[None]
           - torch.gather(starts, 1, eid_s))
    keep = pos < cap
    dst = torch.where(keep, eid_s * cap + pos,
                      torch.full_like(pos, n * cap))         # overflow slot

    rows = torch.arange(b, device=x.device)[:, None]
    buf = x.new_zeros((b, n * cap + 1, d))
    buf[rows, dst] = x[rows, tok_s]
    xe = buf[:, :n * cap].reshape(b, n, cap, d)              # (B,E,C,D)
    ye = _experts(p, xe, cfg)
    ye_flat = torch.cat([ye.reshape(b, n * cap, d),
                         ye.new_zeros((b, 1, d))], dim=1)    # overflow = 0
    w_s = torch.gather(wgt, 1, order) * keep
    out_s = ye_flat[rows, dst] * w_s[..., None].to(dtype)
    # un-sort and reduce the k slots per token
    y_slots = x.new_zeros((b, sk, d))
    y_slots[rows, order] = out_s
    y = y_slots.reshape(b, s, k, d).sum(dim=2)

    me = probs.mean(dim=1)
    ce = F.one_hot(idx, n).float().sum(dim=2).mean(dim=1) / k
    aux = (me * ce).sum(dim=-1).mean() * n
    if e.n_shared_experts:
        y = y + _shared(p["shared"], x)
    return y, aux
