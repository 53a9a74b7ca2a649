"""Public SSD chunk-scan entry point: the CUDA kernel on the card, the
plain version on the CPU."""
from __future__ import annotations

import torch

from .kernel import check_inputs, ssd_scan
from .ref import ssd_scan_ref


def ssd(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bh: torch.Tensor, Ch: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """xh: (B, S, H, P); dt: (B, S, H) float32; A: (H,) float32;
    Bh, Ch: (B, S, H, N) -> y: (B, S, H, P) in xh's dtype.

    CPU tensors go through the plain version (``ref.ssd_scan_ref``); CUDA
    tensors launch the kernel (``kernel.ssd_scan``) or raise.  Nothing
    falls back from one to the other.
    """
    if xh.device.type == "cpu":
        check_inputs(xh, dt, A, Bh, Ch)
        return ssd_scan_ref(xh, dt, A, Bh, Ch, chunk)
    return ssd_scan(xh, dt, A, Bh, Ch, chunk)
