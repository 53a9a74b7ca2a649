"""Masked row-min over a flow x link incidence — the CUDA kernel's wrapper.

Port of the TPU kernel ``masked_min_rows`` (``_minrows_kernel``,
src/repro/kernels/maxmin_fair/kernel.py).  The kernel is
``csrc/maxmin_fair.cu``: one warp per flow row, 16-byte streaming loads
of the int8 incidence, a warp-shuffle min; it is memory-bound on the
F x L incidence bytes (see the note in the source).  Unlike the TPU
kernel it masks ragged F and L itself, so it runs at every shape.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it computes the plain version (``ref.masked_min_rows_ref``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import load_library

from .ref import INF, masked_min_rows_ref

__all__ = ["INF", "masked_min_rows"]


@functools.lru_cache(maxsize=None)
def _c_fn():
    fn = load_library("maxmin_fair").masked_min_rows_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def masked_min_rows(adj: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """adj: (F, L) int8; vals: (L,) float32, on one device -> (F,) float32
    row-min of ``vals`` over the links each row crosses (INF for none).
    ``masked_min_rows.launches`` counts the kernel's launches."""
    if adj.dim() != 2 or vals.dim() != 1 or vals.shape[0] != adj.shape[1]:
        raise ValueError(f"masked_min_rows: adj {tuple(adj.shape)} and vals "
                         f"{tuple(vals.shape)} must be (F, L) and (L,)")
    if adj.dtype != torch.int8 or vals.dtype != torch.float32:
        raise TypeError(f"masked_min_rows: adj must be int8 and vals "
                        f"float32, got {adj.dtype} and {vals.dtype}")
    if adj.device != vals.device:
        raise ValueError(f"masked_min_rows: adj on {adj.device}, vals on "
                         f"{vals.device}")
    if adj.device.type == "cpu":
        return masked_min_rows_ref(adj, vals)
    if adj.device.type != "cuda":
        raise ValueError(f"masked_min_rows: unsupported device {adj.device}")
    if not (adj.is_contiguous() and vals.is_contiguous()):
        raise ValueError("masked_min_rows: adj and vals must be contiguous")
    F, L = adj.shape
    out = torch.empty(F, dtype=torch.float32, device=adj.device)
    if F == 0:
        return out
    stream = torch.cuda.current_stream(adj.device).cuda_stream
    err = _c_fn()(adj.data_ptr(), vals.data_ptr(), out.data_ptr(), F, L,
                  adj.device.index, stream)
    if err:
        raise RuntimeError(f"masked_min_rows: CUDA launch failed with error "
                           f"{err} at F={F}, L={L}")
    masked_min_rows.launches += 1
    return out


masked_min_rows.launches = 0
