"""Dense transformer building blocks (functional, dict-of-tensor params).

Port of ``repro.models.layers`` (the dense blocks, the enc-dec
cross-attention and the sinusoidal position table): the same functions,
names, parameter shapes and layouts (the grouped attention layout, ``wq``
as (D, G, R, hd)), so that a parameter tree of the reference converts by
a copy.  Parameters are nested dicts of tensors; activations run in the
config's dtype with float32 norms and softmax, as in the reference.

Each ``init_*`` draws from an explicit ``torch.Generator`` (numbers differ
from ``jax.random``'s; the tests hand both packages the same weights).
The logical sharding specs (``spec_norm``, ``spec_attention``,
``spec_mlp``, ``spec_embed``) are the reference's, on plain tuples:
``Model.param_specs`` assembles them and ``repro_torch.sharding`` resolves
them onto a mesh for the dry-run's per-device bytes.  No layer applies
them: the reference's ``constrain`` is the identity on one device, and
the port runs on one.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops

Params = Dict[str, Any]
# a parameter's shape and how it is drawn: "dense" (normal / sqrt(fan-in),
# the fan-in being the leading dim, as the reference's ``_dense_init``
# gives for every shape used here), "embed" (normal * 0.02), "conv"
# (normal * 0.1), "ones", "zeros", or a deterministic vector over the
# last dim: "a_log" and "dt_bias" (Mamba-2, see ``mamba2``)
Layout = Dict[str, Any]

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# helpers


def a_log_init(nh: int) -> torch.Tensor:
    """Mamba-2's ``A_log``: log(linspace(1, 16, nh)) as float32, computed
    in float64 and rounded once.  XLA's own rewriting of ``jnp.linspace``
    and its float32 log give values up to two ulps away on the CPU (at 9 of
    48 heads)."""
    return torch.log(torch.linspace(1.0, 16.0, nh,
                                    dtype=torch.float64)).float()


def dt_bias_init(nh: int) -> torch.Tensor:
    """Mamba-2's ``dt_bias``: softplus^-1(0.01) = log(expm1(0.01)) in
    float32, as the reference computes it."""
    return torch.log(torch.expm1(torch.full((nh,), 1e-2,
                                            dtype=torch.float32)))


# deterministic leaves by init kind: a function of the last dim's size
_VECTOR_INITS: Dict[str, Callable[[int], torch.Tensor]] = {
    "a_log": a_log_init, "dt_bias": dt_bias_init}


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)


def init_from_layout(layout: Layout, generator: torch.Generator,
                     device: torch.device, dtype: torch.dtype = torch.float32,
                     lead: Tuple[int, ...] = ()) -> Params:
    """Draw every leaf of ``layout`` with ``generator`` (on the generator's
    device, then moved to ``device``); ``lead`` prepends stacked axes
    (a layer axis) without changing a leaf's fan-in."""
    out: Params = {}
    for name, leaf in layout.items():
        if isinstance(leaf, dict):
            out[name] = init_from_layout(leaf, generator, device, dtype, lead)
            continue
        shape, kind = leaf
        full = tuple(lead) + tuple(shape)
        if kind == "ones":
            t = torch.ones(full, dtype=dtype, device=device)
        elif kind == "zeros":
            t = torch.zeros(full, dtype=dtype, device=device)
        elif kind in _VECTOR_INITS:
            t = _VECTOR_INITS[kind](shape[-1]).to(
                device=device, dtype=dtype).expand(full).clone()
        else:
            scale = {"embed": 0.02, "conv": 0.1}.get(
                kind, 1.0 / math.sqrt(max(shape[0], 1)))
            t = (torch.randn(full, generator=generator, dtype=torch.float32,
                             device=generator.device) * scale).to(
                device=device, dtype=dtype)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# norms


def layout_norm(d: int, norm: str = "rms") -> Layout:
    p = {"scale": ((d,), "ones")}
    if norm == "ln":
        p["bias"] = ((d,), "zeros")
    return p


def spec_norm(norm="rms"):
    p = {"scale": (None,)}
    if norm == "ln":
        p["bias"] = (None,)
    return p


def init_norm(d: int, norm: str = "rms", *, generator: torch.Generator,
              device: torch.device) -> Params:
    return init_from_layout(layout_norm(d, norm), generator, device)


def apply_norm(p: Params, x: torch.Tensor, norm: str = "rms",
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if norm == "rms":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embedding


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, ..., hd), positions: (B, S) integer. Works for any rank."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs                 # (B, S, half)
    shape = tuple(ang.shape[:2]) + (1,) * (x.dim() - 3) + (half,)
    cos = torch.cos(ang).reshape(shape)
    sin = torch.sin(ang).reshape(shape)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int, device=None,
                         start: int = 0) -> torch.Tensor:
    """(seq_len, d_model) float32: sin at even columns, cos at odd ones, of
    pos / 10000^(2i / d_model), for pos from ``start``; every element is
    computed alone, so rows ``start:start + seq_len`` of a longer table are
    these bits.  The power is taken in float64 and rounded once, which
    gives the reference's float32 denominators (torch's float32 ``pow`` is
    an ulp off at a few columns, which the angle of a late row multiplies
    past the float32 parity limit)."""
    pos = torch.arange(start, start + seq_len, dtype=torch.float32,
                       device=device)[:, None]
    expo = torch.arange(0, d_model, 2, dtype=torch.float32,
                        device=device) / d_model
    ang = pos / torch.pow(10000.0, expo.double()).float()[None, :]
    pe = torch.zeros((seq_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


# ---------------------------------------------------------------------------
# attention


def layout_attention(cfg) -> Layout:
    """Grouped layout: wq (D, G, R, hd) where G = kv groups, R = H/G."""
    d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    r = h // kv
    p = {"wq": ((d, kv, r, hd), "dense"), "wk": ((d, kv, hd), "dense"),
         "wv": ((d, kv, hd), "dense"), "wo": ((kv, r, hd, d), "dense")}
    if cfg.qkv_bias:
        p["bq"] = ((kv, r, hd), "zeros")
        p["bk"] = ((kv, hd), "zeros")
        p["bv"] = ((kv, hd), "zeros")
    return p


def spec_attention(cfg):
    p = {
        "wq": ("fsdp", "tp_kv", "tp_rep", None),
        "wk": ("fsdp", "tp_kv", None),
        "wv": ("fsdp", "tp_kv", None),
        "wo": ("tp_kv", "tp_rep", None, "fsdp"),
    }
    if cfg.qkv_bias:
        p["bq"] = ("tp_kv", "tp_rep", None)
        p["bk"] = ("tp_kv", None)
        p["bv"] = ("tp_kv", None)
    return p


def init_attention(cfg, *, generator: torch.Generator,
                   device: torch.device) -> Params:
    return init_from_layout(layout_attention(cfg), generator, device)


def _qkv(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Returns q: (B,S,G,R,hd); k, v: (B,S,G,hd)."""
    dtype = x.dtype
    b, s, d = x.shape
    wq = cast(p["wq"], dtype)
    q = (x @ wq.reshape(d, -1)).view(b, s, *wq.shape[1:])
    k = (x @ cast(p["wk"], dtype).reshape(d, -1)).view(b, s,
                                                       *p["wk"].shape[1:])
    v = (x @ cast(p["wv"], dtype).reshape(d, -1)).view(b, s,
                                                       *p["wv"].shape[1:])
    if cfg.qkv_bias:
        q = q + cast(p["bq"], dtype)
        k = k + cast(p["bk"], dtype)
        v = v + cast(p["bv"], dtype)
    if not cfg.attention_free and cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_mask(sq: int, sk: int, causal: bool, q_offset: int,
               kv_len: Optional[int], device) -> torch.Tensor:
    """(sq, sk) bool: which keys each query position may see."""
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len)
    return mask


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal=True,
        q_offset: int = 0, kv_len: Optional[int] = None,
        block_size: Optional[int] = 1024) -> torch.Tensor:
    """Plain attention in torch ops, grouped layout throughout (no KV-head
    expansion).  q: (B, Sq, G, R, hd); k, v: (B, Sk, G, hd).  kv_len:
    positions >= kv_len are masked (decode cache).  Scores in the input
    dtype, softmax in float32.  The direct path materializes the scores;
    when Sk is a multiple of ``block_size`` above it, the blockwise path
    walks KV blocks with an online softmax (``block_size=None``: always
    the direct path).  Returns (B, Sq, G, R, hd)."""
    b, sq, g, r, hd = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qg = (q * scale).to(q.dtype)

    if block_size is None or sk <= block_size or sk % block_size != 0:
        # direct path (small S / decode / non-divisible lengths)
        scores = torch.einsum("bqgrk,bsgk->bgrqs", qg, k).float()
        if causal or kv_len is not None:
            mask = _attn_mask(sq, sk, causal, q_offset, kv_len, q.device)
            scores = scores + torch.where(mask, 0.0, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bgrqs,bsgk->bqgrk", probs, v)

    m = torch.full((b, g, r, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, g, r, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, g, r, sq, hd), dtype=torch.float32,
                      device=q.device)
    qpos = q_offset + torch.arange(sq, device=q.device)
    for k0 in range(0, sk, block_size):
        kblk, vblk = k[:, k0:k0 + block_size], v[:, k0:k0 + block_size]
        s = torch.einsum("bqgrk,bsgk->bgrqs", qg, kblk).float()
        kpos = k0 + torch.arange(block_size, device=q.device)
        bias = torch.zeros((sq, block_size), dtype=torch.float32,
                           device=q.device)
        if causal:
            bias = torch.where(kpos[None, :] <= qpos[:, None], bias, NEG_INF)
        if kv_len is not None:
            bias = torch.where(kpos[None, :] < kv_len, bias, NEG_INF)
        s = s + bias
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqs,bsgk->bgrqk", p.to(q.dtype), vblk).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]         # (b,g,r,sq,hd)
    return out.movedim(3, 1).to(q.dtype)                     # (b,sq,g,r,hd)


def _out_proj(p: Params, out: torch.Tensor, dtype) -> torch.Tensor:
    """(B, S, G, R, hd) x wo (G, R, hd, D) -> (B, S, D)."""
    b, s = out.shape[:2]
    wo = cast(p["wo"], dtype)
    return out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def apply_attention(p: Params, x: torch.Tensor, cfg, positions, causal=True,
                    use_kernel: bool = False):
    """Full-sequence (prefill / forward) self-attention.  With
    ``use_kernel`` the attention runs through ``ops.flash_attention`` (the
    CUDA kernel on the card), else through ``mha``.  Returns
    (out, (k, v))."""
    q, k, v = _qkv(p, x, cfg, positions)
    if use_kernel:
        out = fa_ops.flash_attention(q, k, v, causal=causal)
    else:
        out = mha(q, k, v, causal=causal,
                  block_size=getattr(cfg, "attn_block", 1024))
    return _out_proj(p, out, x.dtype), (k, v)


def apply_attention_decode(p: Params, x: torch.Tensor, cfg,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           cache_len: int):
    """One-token decode: x (B, 1, D); caches (B, Smax, G, hd).  Writes the
    new key and value in place (the reference returns updated copies) at
    row ``cache_len``, clamped to the last row ``Smax - 1`` as the
    reference's ``lax.dynamic_update_slice_in_dim`` clamps its start, and
    attends over the first ``cache_len + 1`` rows (every row, once past
    the end).  RoPE takes the unclamped ``cache_len``, as in the
    reference."""
    positions = torch.full((x.shape[0], 1), cache_len, dtype=torch.long,
                           device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    row = min(cache_len, k_cache.shape[1] - 1)
    k_cache[:, row] = k[:, 0].to(k_cache.dtype)
    v_cache[:, row] = v[:, 0].to(v_cache.dtype)
    out = mha(q, k_cache.to(q.dtype), v_cache.to(q.dtype), causal=False,
              kv_len=cache_len + 1, block_size=None)
    return _out_proj(p, out, x.dtype), (k_cache, v_cache)


# cross-attention (enc-dec) -------------------------------------------------


def layout_cross_attention(cfg) -> Layout:
    """The self-attention tree; cross-attention uses only ``wq``, ``wk``,
    ``wv`` and ``wo`` of it (no bias, no rope), as the reference's."""
    return layout_attention(cfg)


def init_cross_attention(cfg, *, generator: torch.Generator,
                         device: torch.device) -> Params:
    return init_attention(cfg, generator=generator, device=device)


def apply_cross_attention(p: Params, x: torch.Tensor, cfg,
                          enc_k: torch.Tensor,
                          enc_v: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) attends over every encoder position: enc_k, enc_v
    (B, S_enc, G, hd) from ``cross_kv``.  Plain ``mha`` at its default
    block size, never the kernel (the reference's call)."""
    b, s, d = x.shape
    wq = cast(p["wq"], x.dtype)
    q = (x @ wq.reshape(d, -1)).view(b, s, *wq.shape[1:])
    return _out_proj(p, mha(q, enc_k, enc_v, causal=False), x.dtype)


def cross_kv(p: Params, enc_out: torch.Tensor, cfg):
    """The encoder output's keys and values, (B, S_enc, G, hd) each."""
    b, s, d = enc_out.shape
    dtype = enc_out.dtype
    k = enc_out @ cast(p["wk"], dtype).reshape(d, -1)
    v = enc_out @ cast(p["wv"], dtype).reshape(d, -1)
    return (k.view(b, s, *p["wk"].shape[1:]),
            v.view(b, s, *p["wv"].shape[1:]))


# ---------------------------------------------------------------------------
# MLP


def layout_mlp(cfg, d_ff: Optional[int] = None) -> Layout:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"wi": ((d, f), "dense"), "wg": ((d, f), "dense"),
                "wo": ((f, d), "dense")}
    return {"wi": ((d, f), "dense"), "wo": ((f, d), "dense")}


def spec_mlp(cfg):
    if cfg.act == "swiglu":
        return {"wi": ("fsdp", "tp"), "wg": ("fsdp", "tp"), "wo": ("tp", "fsdp")}
    return {"wi": ("fsdp", "tp"), "wo": ("tp", "fsdp")}


def init_mlp(cfg, d_ff: Optional[int] = None, *,
             generator: torch.Generator, device: torch.device) -> Params:
    return init_from_layout(layout_mlp(cfg, d_ff), generator, device)


def apply_mlp(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    dtype = x.dtype
    h = x @ cast(p["wi"], dtype)
    if cfg.act == "swiglu":
        h = F.silu(x @ cast(p["wg"], dtype)) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return h @ cast(p["wo"], dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding


def layout_embed(cfg) -> Layout:
    p = {"tok": ((cfg.vocab_padded, cfg.d_model), "embed")}
    if not cfg.tie_embeddings:
        p["unembed"] = ((cfg.d_model, cfg.vocab_padded), "dense")
    return p


def spec_embed(cfg):
    p = {"tok": ("vocab", "fsdp")}
    if not cfg.tie_embeddings:
        p["unembed"] = ("fsdp", "vocab")
    return p


def init_embed(cfg, *, generator: torch.Generator,
               device: torch.device) -> Params:
    return init_from_layout(layout_embed(cfg), generator, device)


def apply_embed(p: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    # gather, then cast: the same values as casting the whole table first
    return cast(p["tok"][tokens], getattr(torch, cfg.dtype))


def apply_unembed(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Logits over the padded vocab; the pad region is masked to -1e30."""
    w = p["unembed"] if not cfg.tie_embeddings else p["tok"].T
    logits = x @ cast(w, x.dtype)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits
