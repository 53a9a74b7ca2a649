"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) layer.

Port of ``repro.models.mamba2``: the same functions, parameter names,
shapes and dtypes.  The full-sequence forward runs the chunked SSD
algorithm (``ssd_chunked``, a Python loop over chunks: the reference's
``lax.scan``) or, with ``use_kernel``, the SSD chunk-scan kernel through
``kernels.ssd_scan.ops.ssd``; prefill always runs ``ssd_chunked``, which
also gives the final state; decode is the O(1) state recurrence.  As in
the reference, the kernel is reached only by the full-sequence forward
without state (``Model.forward`` and ``Model.loss``).

Dtypes follow the reference exactly: the projections, the (Q, Q, H)
decay tiles, ``C B^T`` and ``y_intra`` in the compute dtype, ``y_inter``
and the state-update operands cast from float32 to it, the state itself
float32.  ``_causal_conv`` stays the reference's shifted sum (no cuDNN,
so no TF32 question).  ``ssd_chunked`` remats its chunk body when it
records a graph, as the reference does.  The sharding specs
(``spec_ssm``, ``spec_ssm_cache``) are the reference's, on plain tuples,
for ``Model.param_specs`` and ``Model.cache_specs``; nothing here applies
them, since the port runs on one device.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

from .layers import Layout, cast

Params = Dict[str, Any]


def dims(cfg) -> Tuple[int, int, int, int, int, int, int]:
    s = cfg.ssm
    d = cfg.d_model
    return (s.d_inner(d), s.n_heads(d), s.d_state, s.n_groups, s.head_dim,
            s.d_conv, s.chunk_size)


def layout_ssm(cfg) -> Layout:
    """The reference's ``init_ssm`` tree as (shape, init kind): ``dense``
    leaves are normal / sqrt(fan-in), ``conv`` normal * 0.1; ``A_log``
    (log of 1..16 spread over the heads), ``dt_bias`` (softplus^-1 of
    0.01), ``D``, ``norm_scale`` and ``conv_bias`` are deterministic."""
    din, nh, ns, ng, _, dc, _ = dims(cfg)
    d = cfg.d_model
    return {
        "in_z": ((d, din), "dense"),
        "in_x": ((d, din), "dense"),
        "in_B": ((d, ng * ns), "dense"),
        "in_C": ((d, ng * ns), "dense"),
        "in_dt": ((d, nh), "dense"),
        "conv_x": ((dc, din), "conv"),
        "conv_B": ((dc, ng * ns), "conv"),
        "conv_C": ((dc, ng * ns), "conv"),
        "conv_bias": ((din + 2 * ng * ns,), "zeros"),
        "A_log": ((nh,), "a_log"),
        "D": ((nh,), "ones"),
        "dt_bias": ((nh,), "dt_bias"),
        "norm_scale": ((din,), "ones"),
        "out": ((din, d), "dense"),
    }


def spec_ssm(cfg):
    return {
        "in_z": ("fsdp", "tp"), "in_x": ("fsdp", "tp"),
        "in_B": ("fsdp", None), "in_C": ("fsdp", None),
        "in_dt": ("fsdp", None),
        "conv_x": (None, "tp"), "conv_B": (None, None), "conv_C": (None, None),
        "conv_bias": (None,),
        "A_log": (None,), "D": (None,), "dt_bias": (None,),
        "norm_scale": ("tp",),
        "out": ("tp", "fsdp"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (K, C); depthwise causal conv + bias, as a sum of
    K shifted copies in x's dtype."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = sum(xp[:, i:i + s, :] * cast(w[i], x.dtype) for i in range(k))
    return y + cast(b, x.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    y = y * F.silu(z)
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _heads_bc(t: torch.Tensor, nh: int, ng: int) -> torch.Tensor:
    """(B, S, G, N) -> groups broadcast to heads -> (B, S, H, N).  With one
    group this is a view whose head stride is 0 (no copy)."""
    if ng == nh:
        return t
    b, s, g, n = t.shape
    return t[:, :, :, None, :].expand(b, s, g, nh // ng, n).reshape(
        b, s, nh, n)


def _ssm_fwd(p: Params, x: torch.Tensor, cfg, use_kernel: bool = False,
             want_state: bool = False):
    din, nh, ns, ng, hp, dc, chunk = dims(cfg)
    b, s, _ = x.shape
    dtype = x.dtype
    z = x @ cast(p["in_z"], dtype)
    xi = x @ cast(p["in_x"], dtype)
    Bi = x @ cast(p["in_B"], dtype)
    Ci = x @ cast(p["in_C"], dtype)
    dt = x @ cast(p["in_dt"], dtype)

    conv_tail = None
    if want_state:  # the pre-conv tail feeds decode's conv window
        conv_tail = torch.cat([xi, Bi, Ci], dim=-1)[:, -(dc - 1):, :]
        if conv_tail.shape[1] < dc - 1:
            # a prompt shorter than the window: the causal conv's zero
            # padding stands before it (the reference fails here)
            conv_tail = F.pad(conv_tail, (0, 0, dc - 1 - conv_tail.shape[1],
                                          0))

    cb = p["conv_bias"]
    xi = F.silu(_causal_conv(xi, p["conv_x"], cb[:din]))
    Bi = F.silu(_causal_conv(Bi, p["conv_B"], cb[din:din + ng * ns]))
    Ci = F.silu(_causal_conv(Ci, p["conv_C"], cb[din + ng * ns:]))

    A = -torch.exp(p["A_log"])                             # (H,) < 0
    dtf = F.softplus(dt.float() + p["dt_bias"])
    xh = xi.reshape(b, s, nh, hp)
    Bh = _heads_bc(Bi.reshape(b, s, ng, ns), nh, ng)
    Ch = _heads_bc(Ci.reshape(b, s, ng, ns), nh, ng)

    if use_kernel and not want_state:
        y = ssd_ops.ssd(xh, dtf, A, Bh, Ch, chunk)
        state = None
    else:
        y, state = ssd_chunked(xh, dtf, A, Bh, Ch, chunk)
    y = y + xh * cast(p["D"], dtype)[None, None, :, None]
    y = _gated_norm(y.reshape(b, s, din), z, p["norm_scale"])
    out = y @ cast(p["out"], dtype)
    if want_state:
        return out, {"conv": conv_tail.float(), "state": state}
    return out


def apply_ssm(p: Params, x: torch.Tensor, cfg,
              use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence Mamba-2 mixer.  x: (B, S, D) -> (B, S, D)."""
    return _ssm_fwd(p, x, cfg, use_kernel=use_kernel, want_state=False)


def apply_ssm_prefill(p: Params, x: torch.Tensor, cfg):
    """Like ``apply_ssm`` but also returns the decode cache
    {'conv': (B, K-1, C) float32, 'state': (B, H, P, N) float32}."""
    return _ssm_fwd(p, x, cfg, want_state=True)


# ---------------------------------------------------------------------------
# decode


def init_ssm_cache(cfg, batch: int, device) -> Params:
    """One layer's decode cache, float32: the pre-conv window
    (B, K-1, C) and the state (B, H, P, N)."""
    din, nh, ns, ng, hp, dc, _ = dims(cfg)
    return {
        "conv": torch.zeros(batch, dc - 1, din + 2 * ng * ns,
                            dtype=torch.float32, device=device),
        "state": torch.zeros(batch, nh, hp, ns, dtype=torch.float32,
                             device=device),
    }


def spec_ssm_cache(cfg):
    return {"conv": ("dp", None, None), "state": ("dp", "tp", None, None)}


def apply_ssm_decode(p: Params, x: torch.Tensor, cfg, cache: Params):
    """x: (B, 1, D); cache: {'conv': (B, K-1, C), 'state': (B, H, P, N)}.
    Writes the new conv window and state into ``cache`` in place (the
    reference returns updated copies); returns (out, cache)."""
    din, nh, ns, ng, hp, dc, _ = dims(cfg)
    b = x.shape[0]
    dtype = x.dtype
    z = x @ cast(p["in_z"], dtype)
    xi = x @ cast(p["in_x"], dtype)
    Bi = x @ cast(p["in_B"], dtype)
    Ci = x @ cast(p["in_C"], dtype)
    dt = x @ cast(p["in_dt"], dtype)

    new_col = torch.cat([xi, Bi, Ci], dim=-1)              # (B,1,C)
    window = torch.cat([cache["conv"].to(dtype), new_col], dim=1)
    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=1)
    conv = torch.einsum("bkc,kc->bc", window, cast(conv_w, dtype)) \
        + cast(p["conv_bias"], dtype)
    conv = F.silu(conv)
    xi = conv[:, :din]
    Bi = conv[:, din:din + ng * ns]
    Ci = conv[:, din + ng * ns:]
    cache["conv"].copy_(window[:, 1:, :])

    A = -torch.exp(p["A_log"])
    dtf = F.softplus(dt[:, 0, :].float() + p["dt_bias"])
    xh = xi.reshape(b, nh, hp).float()
    Bh = _heads_bc(Bi.reshape(b, 1, ng, ns), nh, ng)[:, 0].float()
    Ch = _heads_bc(Ci.reshape(b, 1, ng, ns), nh, ng)[:, 0].float()

    decay = torch.exp(dtf * A[None, :])                     # (B,H)
    h_new = (cache["state"] * decay[:, :, None, None]
             + torch.einsum("bhn,bhp->bhpn", Bh * dtf[..., None], xh))
    cache["state"].copy_(h_new)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h_new)
    y = y + xh * p["D"][None, :, None]
    y = _gated_norm(y.reshape(b, 1, din).to(dtype), z, p["norm_scale"])
    out = y @ cast(p["out"], dtype)
    return out, cache
