"""Plain torch versions of the max-min fair bandwidth allocation.

The paper's stream-level network model allocates link bandwidth max-min
fairly across flows (progressive filling).  These are the dense plain
versions: the CPU path of the kernel wrapper, and what the CUDA kernel
is held against on the card.
"""
from __future__ import annotations

import torch

INF = 3.4e38


def masked_min_rows_ref(adj: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """adj: (F, L) bool/int; vals: (L,) f32 -> per-flow min over its links.
    Flows with no links get +INF."""
    masked = torch.where(adj > 0, vals[None, :], INF)
    return masked.amin(dim=1)


def waterfill_ref(adj: torch.Tensor, caps: torch.Tensor,
                  max_iters: int = 64) -> torch.Tensor:
    """Progressive-filling max-min allocation, all plain torch.

    adj: (F, L) 0/1; caps: (L,).  Returns rates (F,) f32.  Each
    iteration: fair share per link = remaining / active flows; every
    unfrozen flow whose minimum share equals the global bottleneck share
    freezes at that rate.
    """
    from .ops import waterfill
    return waterfill(adj, caps, max_iters, use_kernel=False)
