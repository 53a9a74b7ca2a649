"""Public flash-attention entry point: the CUDA kernel on the card, the
plain version on the CPU."""
from __future__ import annotations

import torch

from .kernel import check_inputs, flash_attention_fwd
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, G, R, hd); k, v: (B, Sk, G, hd) -> (B, Sq, G, R, hd).

    CPU tensors go through the plain version (``ref.attention_ref``);
    CUDA tensors launch the kernel (``kernel.flash_attention_fwd``) or
    raise.  Nothing falls back from one to the other.
    """
    if q.device.type == "cpu":
        check_inputs(q, k, v)
        return attention_ref(q, k, v, causal=causal)
    return flash_attention_fwd(q, k, v, causal=causal)
