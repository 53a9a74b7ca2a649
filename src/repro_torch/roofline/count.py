"""FLOPs and bytes of a torch function, counted op by op on meta tensors.

The port's counterpart of the reference dry-run's ``compiled.as_text()``
plus ``analyze`` (``repro/launch/dryrun.py:164-165``): the port has no
XLA program, so ``count(fn, *args, chips=...)`` runs ``fn`` (the port's
own train step, prefill or decode) under a ``TorchDispatchMode`` and adds
up what every aten op it reaches would cost.  On meta tensors nothing is
allocated and no device is touched; an op that needs data (``.item()``,
``nonzero``) raises, and so does an op this module has no rule for, so
a cell is counted whole or not at all.

What each op adds, by class:

* **products** (``mm``, ``addmm``, ``bmm``, ``baddbmm``, the convolutions
  and the fused attentions): ``torch.utils.flop_counter``'s formula,
  2 x M x N x K for a matrix product.  These are the FLOPs the roofline's
  compute term is about, and the only ones XLA's ``analyze`` counts
  (dots and convolutions).
* **elementwise and reductions** (ops tagged ``pointwise`` or
  ``reduction``, and the softmax / norm kernels listed in ``_ELEMENTWISE``):
  one FLOP per output element, so that the casts, exps and masks of an
  eager step are not free; against the products they are a few percent.
* **data movement** (copies, casts, concatenation, gathers, scatters,
  sorts, cumulative sums; ``_MOVES``), and factories: bytes only.
* **views and metadata** (every op whose schema returns an alias of an
  input, ``detach``, ``_unsafe_view``, a host read of a 0-d tensor):
  nothing; they move no memory.

The lists hold the ops the port's train step, prefill and decode reach
for every arch and shape, under the torch of this repository's CPU
tests and the card's (whose ``checkpoint`` makes an empty tensor inside
the step), and their near kin; a factory (an op that reads no tensor)
is a move without a list.  Any other op raises, so a new op in a model
is classed before a record counts it.

Bytes are every input read once plus every output written once: for
each tensor, the elements it addresses (a broadcast dim, stride 0, counts
once) times ``priced_size`` of its dtype.  So a slice reads the slice,
and a broadcast ``mask`` reads its own length, as XLA's fused broadcasts
do.  Eager torch materialises what XLA fuses (a cast, a mask, an
``exp``), so the count runs higher than the reference's for the same
program; the kernel adjustment below removes the largest such chain, the
attention scores.  ``priced_size`` is the element size, except that a
floating element counts ``FLOAT_BYTES`` = 4 at least: the reference's
records come from XLA:CPU, which normalises bfloat16 to float32 before
it partitions or counts anything (every dot and every collective in its
programs is float32), and the port's record is read in place of the
reference's by the same predictions.  A TPU program would move a
bfloat16 tensor in half the bytes.

Per-device figures are the global ones over ``chips``: the global step is
counted once and every chip is taken to do an equal share of it (the
reference's multi-pod and single-pod FLOP totals are equal, so no compute
is replicated there).

The kernel adjustment follows the reference's (``dryrun.py:181-204``):
each op's output dims go to the cell's matcher; an op whose first
output matches has its bytes removed (a flash or SSD kernel keeps that
tile on chip), and a matched product's FLOPs are reported as
``tile_dot_flops`` for the caller to halve (causal blocks skipped) or,
for SSD chunks, to keep.  The dims are global: the port's score tiles
(``mha``'s (B, G, R, S, block) blocks, and the bmm's (B G, R S, block)
behind each einsum) match at every sequence length, where the
reference's per-device dims do not match once the sequence is sharded
below half a block.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_ATEN = torch.ops.aten
# the reference's records are XLA:CPU's, which computes and moves every
# bfloat16 tensor as float32 (its float normalisation runs before the
# partitioner), so a record prices a floating element at 4 bytes at least
FLOAT_BYTES = 4

# not tagged pointwise or reduction, but one pass over their output
_ELEMENTWISE = {
    _ATEN._softmax, _ATEN._log_softmax, _ATEN._softmax_backward_data,
    _ATEN._log_softmax_backward_data, _ATEN.native_layer_norm,
    _ATEN.native_layer_norm_backward, _ATEN.rsqrt, _ATEN.logsumexp,
    _ATEN.var_mean, _ATEN.var, _ATEN.gelu_backward, _ATEN.silu_backward,
    _ATEN.threshold_backward, _ATEN.masked_fill, _ATEN.masked_fill_,
    _ATEN.one_hot, _ATEN.softplus_backward, _ATEN.floor_divide,
}
# move memory and compute nothing (an op that reads no tensor, a
# factory, writes its output and is classed so without a list)
_MOVES = {
    _ATEN._to_copy, _ATEN.clone, _ATEN.copy_, _ATEN.copy, _ATEN.cat,
    _ATEN.stack, _ATEN.index, _ATEN.index_put, _ATEN.index_put_,
    _ATEN._index_put_impl_, _ATEN.index_select, _ATEN.gather,
    _ATEN.scatter, _ATEN.scatter_, _ATEN.scatter_add, _ATEN.scatter_add_,
    _ATEN.index_add, _ATEN.index_add_, _ATEN.select_scatter,
    _ATEN.slice_scatter, _ATEN.embedding, _ATEN.embedding_dense_backward,
    _ATEN.constant_pad_nd, _ATEN.roll, _ATEN.flip, _ATEN.repeat,
    _ATEN.zeros_like, _ATEN.ones_like, _ATEN.full_like, _ATEN.empty_like,
    _ATEN.new_zeros, _ATEN.new_ones, _ATEN.new_full, _ATEN.new_empty,
    _ATEN.new_empty_strided, _ATEN.lift_fresh_copy, _ATEN.fill,
    _ATEN.fill_, _ATEN.zero_, _ATEN.sort, _ATEN.topk, _ATEN.cumsum,
    _ATEN.argsort, _ATEN._unsafe_index, _ATEN.tril, _ATEN.triu,
    _ATEN.diagonal_scatter, _ATEN.as_strided_scatter, _ATEN.select_backward,
    _ATEN.slice_backward,
}
# metadata only (the views are found from their schemas)
_FREE = {_ATEN.detach, _ATEN.lift_fresh, _ATEN.sym_size, _ATEN.sym_stride,
         _ATEN.sym_numel, _ATEN.sym_storage_offset, _ATEN.is_same_size,
         _ATEN._local_scalar_dense, _ATEN._unsafe_view}


def _distinct_elements(t: torch.Tensor) -> int:
    """Elements ``t`` addresses: a dim of stride 0 (a broadcast) counts
    once."""
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)


def priced_size(dtype: torch.dtype) -> int:
    """Bytes a record counts for one element of ``dtype``: a floating
    element at least ``FLOAT_BYTES``."""
    size = dtype.itemsize
    return max(size, FLOAT_BYTES) if dtype.is_floating_point else size


def _tensor_bytes(t: torch.Tensor) -> int:
    return _distinct_elements(t) * priced_size(t.dtype)


def _is_view(func) -> bool:
    if func.is_view:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class OpCounter(TorchDispatchMode):
    """Adds up FLOPs and bytes of every aten op run under it (see the
    module docstring for the rules); ops whose first output's dims
    ``matcher`` accepts are also summed apart."""

    def __init__(self, matcher: Optional[Callable] = None):
        super().__init__()
        self.matcher = matcher
        self.flops = 0.0
        self.bytes = 0.0
        self.matched_bytes = 0.0
        self.matched_dot_flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in _FREE or _is_view(func):
            return out
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            dot = True
        elif (packet in _ELEMENTWISE or torch.Tag.pointwise in func.tags
              or torch.Tag.reduction in func.tags):
            flops = float(sum(t.numel() for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor)))
            dot = False
        elif packet in _MOVES or not any(
                isinstance(t, torch.Tensor)
                for t in tree_leaves((args, kwargs))):
            flops, dot = 0.0, False
        else:
            raise NotImplementedError(
                f"roofline.count: no rule for {func} (add it to the "
                "products, elementwise ops, moves or views)")
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        nbytes = float(sum(_tensor_bytes(t) for t in ins)
                       + sum(_tensor_bytes(t) for t in outs))
        self.flops += flops
        self.bytes += nbytes
        if self.matcher is not None and outs \
                and self.matcher(list(outs[0].shape)):
            self.matched_bytes += nbytes
            if dot:
                self.matched_dot_flops += flops
        return out


def count(fn: Callable, *args, chips: int = 1,
          matcher: Optional[Callable] = None, **kwargs) -> Dict:
    """Run ``fn(*args, **kwargs)`` (on meta tensors) under an
    ``OpCounter`` and return per-device ``flops`` and ``bytes`` (the
    global counts over ``chips``), the matched ``tile_bytes`` and
    ``tile_dot_flops`` per device, and the wall time ``count_s``."""
    counter = OpCounter(matcher)
    t0 = time.perf_counter()
    with counter:
        fn(*args, **kwargs)
    return {"flops": counter.flops / chips, "bytes": counter.bytes / chips,
            "tile_bytes": counter.matched_bytes / chips,
            "tile_dot_flops": counter.matched_dot_flops / chips,
            "count_s": time.perf_counter() - t0}


def kernel_matcher(cfg, shape) -> Optional[Callable]:
    """The reference dry-run's matcher for this cell, or None: the score
    matcher unless the arch is attention-free, the chunk matcher for pure
    SSMs (on hybrids it can overlap the score matcher)."""
    from .hlo_parse import chunk_matcher, score_matcher
    if not cfg.attention_free:
        return score_matcher(min(shape.seq_len, 32768), cfg.attn_block)
    if cfg.ssm is not None:
        return chunk_matcher(cfg.ssm.chunk_size)
    return None
