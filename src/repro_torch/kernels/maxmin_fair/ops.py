"""Max-min fair rates by progressive filling, with the masked row-min on
the CUDA kernel, and the flow x link incidence it runs on."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .kernel import INF, masked_min_rows
from .ref import masked_min_rows_ref


def waterfill(adj: torch.Tensor, caps: torch.Tensor, max_iters: int = 64,
              use_kernel: bool = True) -> torch.Tensor:
    """Max-min fair rates (F,) float32 for an (F, L) 0/1 incidence and
    (L,) link capacities, on their device.  The per-iteration masked
    row-min runs through the kernel (``use_kernel=False``: its plain
    version).  At most ``max_iters`` iterations; a flow crossing no link
    gets INF.

    The two incidence-vector products are plain float32 matmuls, as in
    the reference.  They must not run in TF32, whose 10-bit mantissa
    makes link counts above 1,024 inexact, so this raises when
    ``torch.backends.cuda.matmul.allow_tf32`` is on.
    """
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("waterfill: torch.backends.cuda.matmul.allow_tf32 "
                           "is on; the link counts need full float32")
    F, _ = adj.shape
    adj8 = adj.to(torch.int8).contiguous()
    adjf_t = adj8.to(torch.float32).T
    minrows = masked_min_rows if use_kernel else masked_min_rows_ref
    rates = torch.zeros(F, dtype=torch.float32, device=adj.device)
    frozen = torch.zeros(F, dtype=torch.float32, device=adj.device)
    rem = caps.to(torch.float32)
    it = 0
    while it < max_iters and frozen.sum().item() < F:
        active = 1.0 - frozen
        nl = adjf_t @ active
        share = torch.where(nl > 0, rem / torch.clamp(nl, min=1.0), INF)
        fmin = torch.where(active > 0, minrows(adj8, share.contiguous()), INF)
        smin = fmin.min()
        freeze_now = ((fmin - smin).abs() <= 1e-6 * smin) & (active > 0)
        rates = torch.where(freeze_now, smin, rates)
        used = adjf_t @ torch.where(freeze_now, smin, 0.0)
        frozen = frozen + freeze_now.to(torch.float32)
        rem = torch.clamp(rem - used, min=0.0)
        it += 1
    return torch.where(adj8.sum(dim=1) == 0, INF, rates)


def flow_incidence(topology, pairs: Sequence[Tuple[int, int]]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The (F, L) int8 flow x link incidence of node pairs ``(src, dst)``
    routed over ``topology`` (links in ``topology.iter_links()`` order)
    and the (L,) float32 link capacities."""
    links = topology.iter_links()
    index = {id(link): j for j, link in enumerate(links)}
    adj = np.zeros((len(pairs), len(links)), np.int8)
    for i, (src, dst) in enumerate(pairs):
        for link in topology.route(src, dst):
            adj[i, index[id(link)]] = 1
    caps = np.asarray([link.capacity for link in links], np.float32)
    return adj, caps
