"""Flash attention forward — the CUDA kernel's wrapper.

Port of the TPU kernel ``flash_attention_fwd`` (``_flash_kernel``,
src/repro/kernels/flash_attention/kernel.py).  The kernel is
``csrc/flash_attention.cu`` (see the note in the source).  In bf16, one
block per (batch, KV group, 192 flattened q*R rows; 128 at hd 80 and
128): a producer warp streams key and value tiles by TMA into a ring of
shared-memory stages, each tile serving all R heads of the group, and
consumer warpgroups run both products with ``wgmma`` (hd 80 padded to 96
columns in shared memory, TMA's zero fill supplying the padding); the
tensor maps are encoded on the host each call (``cuTensorMapEncodeTiled``,
reached through ``cudaGetDriverEntryPoint``).  In float32, CUDA-core FMAs
(the tensor cores would round to TF32).  Unlike the TPU kernel it
masks ragged Sq and Sk itself, so every prompt length runs.

``flash_attention_fwd`` takes CUDA tensors only and launches the kernel
or raises; ``ops.flash_attention`` is the entry point that also takes CPU
tensors (through the plain version).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels._build import load_library

__all__ = ["HEAD_DIMS", "check_inputs", "flash_attention_fwd"]

HEAD_DIMS = (32, 64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = load_library("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q is (B, Sq, G, R, hd) and k, v are (B, Sk, G, hd) of
    q's dtype (float32 or bfloat16) on q's device."""
    if q.dim() != 5 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be "
                         "(B, Sq, G, R, hd) and two (B, Sk, G, hd)")
    b, _, g, _, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, g, hd):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on B, G or hd")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernel's vector loads need."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, G, R, hd); k, v: (B, Sk, G, hd), CUDA tensors of one
    dtype (float32 or bfloat16), hd in {32, 64, 80, 128} -> (B, Sq, G, R, hd)
    in q's dtype.  ``flash_attention_fwd.launches`` counts the kernel's
    launches.  Refuses inputs that require grad while grad is enabled:
    the kernel has no backward."""
    check_inputs(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: needs CUDA tensors, got "
                         f"{q.device}; ops.flash_attention takes CPU ones")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the output is written through raw pointers: it would come back
        # with no grad_fn and cut attention out of the gradient silently
        raise RuntimeError("flash_attention_fwd: the kernel has no backward "
                           "(as the TPU kernel has none); call it without "
                           "inputs that require grad, or under "
                           "torch.no_grad()")
    b, sq, g, r, hd = q.shape
    sk = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if sk == 0:
        raise ValueError("flash_attention_fwd: no keys (Sk == 0)")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _c_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  int(q.dtype == torch.bfloat16), b, sq, sk, g, r, hd,
                  int(causal), 1.0 / math.sqrt(hd), q.device.index, stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd: CUDA launch failed with "
                           f"error {err} at q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype}")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
