"""Plain torch version of causal / full grouped-query attention: the CPU
path of the flash-attention kernel's wrapper, and what the CUDA kernel is
held against on the card.  Port of ``attention_ref``
(src/repro/kernels/flash_attention/ref.py)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, G, R, hd); k, v: (B, Sk, G, hd) -> (B, Sq, G, R, hd).

    Materializes the full score matrix (O(S^2) memory); float32 softmax,
    masked scores are -1e30.  Query position i sees keys 0..i when
    ``causal``.
    """
    sq, hd = q.shape[1], q.shape[4]
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqgrk,bsgk->bgrqs", q.float() * scale, k.float())
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(kpos <= qpos, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqs,bsgk->bqgrk", probs, v.float())
    return out.to(q.dtype)
