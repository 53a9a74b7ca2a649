"""Mamba-2 SSD chunk scan forward — the CUDA kernel's wrapper.

Port of the TPU kernel ``ssd_scan`` (``_ssd_kernel``,
src/repro/kernels/ssd_scan/kernel.py).  The kernel is
``csrc/ssd_scan.cu``: the chunk-parallel split, three launches a call
(each chunk's cumsum and own state; the states passed from chunk to
chunk; each chunk's output), ``C B^T`` on the tensor cores for bf16
inputs and every other product on the CUDA cores in float32 (see the note
in the source).  The wrapper allocates the two float32 scratches the
passes share: the cumsum (B, H, NC, Q) and the chunk states
(B, H, NC, P, N), ~50 MB at mamba2-780m's 4 x 2048 shape.  Unlike the TPU
kernel it masks a ragged S itself (the same result as padding with
dt = 0), so every length runs.  Like it, it is forward only: there is no
backward, and inputs that would need one are refused.

``ssd_scan`` takes CUDA tensors only and launches the kernel or raises;
``ops.ssd`` is the entry point that also takes CPU tensors (through the
plain version).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import load_library

__all__ = ["MAX_CHUNK", "MAX_N", "MAX_P", "check_inputs", "ssd_scan"]

MAX_P, MAX_N, MAX_CHUNK = 128, 128, 256
DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = load_library("ssd_scan").ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_inputs(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bh: torch.Tensor, Ch: torch.Tensor) -> None:
    """Raise unless xh is (B, S, H, P), dt (B, S, H) float32, A (H,)
    float32 and Bh, Ch (B, S, H, N) of xh's dtype (float32 or bfloat16),
    all on one device."""
    if xh.dim() != 4 or dt.shape != xh.shape[:3] or A.shape != xh.shape[2:3]:
        raise ValueError(f"ssd_scan: xh {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)} must be "
                         "(B, S, H, P), (B, S, H) and (H,)")
    if (Bh.dim() != 4 or Bh.shape != Ch.shape
            or Bh.shape[:3] != xh.shape[:3]):
        raise ValueError(f"ssd_scan: Bh {tuple(Bh.shape)} and Ch "
                         f"{tuple(Ch.shape)} must both be (B, S, H, N) with "
                         f"xh's (B, S, H) = {tuple(xh.shape[:3])}")
    if xh.dtype not in DTYPES or Bh.dtype != xh.dtype or Ch.dtype != xh.dtype:
        raise TypeError(f"ssd_scan: xh, Bh, Ch must share float32 or "
                        f"bfloat16, got {xh.dtype}, {Bh.dtype}, {Ch.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and A must be float32, got "
                        f"{dt.dtype} and {A.dtype}")
    if any(t.device != xh.device for t in (dt, A, Bh, Ch)):
        raise ValueError("ssd_scan: inputs on different devices")


def _rows(t: torch.Tensor):
    """``t`` with a contiguous last dim, and its (batch, seq, head) element
    strides: a head stride of 0 (one group broadcast to every head) is
    read as it is, not copied."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    return t, t.stride()[:3]


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bh: torch.Tensor, Ch: torch.Tensor,
             chunk: int = 256) -> torch.Tensor:
    """xh: (B, S, H, P); dt: (B, S, H) float32; A: (H,) float32;
    Bh, Ch: (B, S, H, N), CUDA tensors, P <= 128, N <= 128 ->
    y: (B, S, H, P) in xh's dtype, in chunks of ``min(chunk, S)``
    (``min(chunk, S) <= 256``).  ``ssd_scan.launches`` counts the calls
    (each launches the three passes)."""
    check_inputs(xh, dt, A, Bh, Ch)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan: needs CUDA tensors, got {xh.device}; "
                         "ops.ssd takes CPU ones")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xh, dt, A, Bh, Ch)):
        raise RuntimeError("ssd_scan: the kernel has no backward (as the TPU "
                           "kernel has none); call it without inputs that "
                           "require grad, or under torch.no_grad()")
    b, s, h, p = xh.shape
    n = Bh.shape[-1]
    chunk = min(int(chunk), s)
    if p > MAX_P or n > MAX_N or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: takes P <= {MAX_P}, N <= {MAX_N} and "
                         f"0 < min(chunk, S) <= {MAX_CHUNK}, got P={p}, "
                         f"N={n}, chunk={chunk}")
    xh, dt, A = xh.contiguous(), dt.contiguous(), A.contiguous()
    Bh, bs = _rows(Bh)
    Ch, cs = _rows(Ch)
    y = torch.empty_like(xh)
    if y.numel() == 0:
        return y
    nc = -(-s // chunk)
    cum = torch.empty(b, h, nc, chunk, dtype=torch.float32, device=xh.device)
    states = torch.empty(b, h, nc, p, n, dtype=torch.float32,
                         device=xh.device)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    err = _c_fn()(xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bh.data_ptr(),
                  Ch.data_ptr(), y.data_ptr(), cum.data_ptr(),
                  states.data_ptr(), int(xh.dtype == torch.bfloat16),
                  b, s, h, p, n, chunk, *bs, *cs, xh.device.index, stream)
    if err:
        raise RuntimeError(f"ssd_scan: CUDA launch failed with error {err} at "
                           f"xh {tuple(xh.shape)}, N={n}, chunk={chunk}, "
                           f"{xh.dtype}")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
