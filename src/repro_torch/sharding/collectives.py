"""The collectives of one step on a production mesh, from the sharding
rules: the dry-run's counterpart of the collectives the reference reads
off its partitioned HLO (``repro/launch/dryrun.py:166-167``).

The port runs every model on one device, so no partitioner decides where
data moves; this module writes the decision out, term by term, from what
decides it in the reference: the rules (``make_rules``), the mesh, the
legalized spec of every parameter leaf (``tree_shardings``) and the
reference's activation constraints, which keep the residual stream at
``("dp", "sp", None)`` between layers (``repro/models/lm.py:182-439``)
and the MoE buffers at ``("dp", "ep", ...)`` (``repro/models/moe.py:
162-194``).  ``step_collectives`` returns ``{op: {"count",
"wire_bytes"}}`` per device, the reference record's schema; each op's
wire bytes are ``analysis.ring_wire_bytes`` of its result bytes and
group size, the formula ``parse_hlo_collectives`` applies to the HLO.

Tokens.  A device holds ``B / |dp|`` sequences of ``S / |sp|`` positions
(decode: one position), ``|x|`` being the devices over the axes ``x``
resolves to, kept only where they divide the dim, as ``legalize`` does.
Activations cross at ``FLOAT_BYTES`` an element and a parameter at
``roofline.count.priced_size`` of its dtype: 4 bytes for a floating
element, as the reference's XLA:CPU records count every bfloat16 tensor
(see ``roofline.count``).

The terms, in the order ``step_collectives`` adds them:

1. **Parameters stored sharded (fsdp).**  In a train step or prefill a
   leaf's axes on its ``fsdp`` dims are all-gathered before use (the
   compute keeps only the tensor-parallel dims sharded); so are the
   embedding table's ``vocab`` axes where the logits do not keep vocab
   sharded (the sequence took the axis, ``("dp", "sp", "vocab")``).  Once
   per forward, and once more per backward when ``cfg.remat`` recomputes
   the layer.  Decode gathers no weight: it moves activations (term 2).
2. **Products over sharded dims.**  A product whose contraction dims
   stay sharded leaves a partial sum: its output is all-reduced over
   those axes (the tensor-parallel block outputs, ``wo``; in decode also
   every ``fsdp``-sharded input dim).  In the backward pass the same
   holds for the input gradient of a product whose output dims stay
   sharded (``wq``, ``wi``).  A decode product whose output keeps the
   model dim sharded (``fsdp`` on an output dim) is all-gathered to
   rejoin the residual stream.  The vocab-sharded embedding lookup
   all-reduces its rows, and a vocab-sharded unembedding all-reduces the
   softmax's two per-token statistics.
3. **Attention over a sharded sequence (sp).**  Each layer all-gathers K
   and V along the sequence (forward, and again when remat recomputes).
   The train step's backward follows the reference's partitioning of the
   blockwise attention (``repro/models/layers.py:152-207``, seen in its
   HLO): on the blockwise path (S a multiple of ``attn_block`` above it)
   a KV block spans ``attn_block / (S / |sp|)`` devices, and each block's
   backward is split along its keys over them.  Per layer and block it
   all-gathers the block's queries and their float32 softmax statistic,
   moves the float32 score tile (the device's queries against the
   block's keys) from a query split to a key split by all-to-all, and
   all-reduces the block's K and V gradients.  Where a block lies on one
   device, or on the direct path, the K and V gradients are
   reduce-scattered instead.  In decode with the cache's sequence
   sharded (``kv_seq``), the softmax statistics and the partial output
   are all-reduced per layer.
4. **Experts (ep).**  Where the tokens are not split over the expert
   axes, dispatch is local and the combine is a product over sharded
   expert slots (all-reduce, as term 2, and again for the dispatch's
   input gradient); where they are, the slots travel by all-to-all, once
   to dispatch and once to combine, per pass.
5. **Mamba-2 channels.**  The tensor-parallel ``d_inner`` channels meet
   the replicated B and C channels in one concatenation in prefill (the
   conv cache's tail) and decode (the conv window, and its weights): the
   sharded part is all-gathered.  The gated norm over sharded channels
   all-reduces one float32 per token.
6. **Gradients.**  Each leaf's float32 gradient is summed over the axes
   its tokens are split over: reduce-scattered over those the leaf is
   stored sharded on, all-reduced over the rest.  The ``pod`` axis of the
   2x16x16 mesh is a data axis: it enters here and in the batch split.

Biases and depthwise convolution taps (``_ELEMENTWISE``) act per
channel and contract nothing; any other parameter leaf of rank 2 or more
without a role in ``_PRODUCTS`` raises, so a new layer is classed before
a record counts it.

Left out: scalars (the loss, the gradient norm), and the other
resharding an XLA partitioner may choose on its own between constraints
(the reference's records show collective-permutes of that kind; PERF.md
§6 lists them by cell).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

from repro_torch.roofline.analysis import ring_wire_bytes
from repro_torch.roofline.count import FLOAT_BYTES, priced_size

from .specs import Rules, _axes, _spec_leaf, legalize, resolve

# in and out dims of each product's weight, by its last two path keys,
# without the layer axis; a dim in neither is a batch dim (the experts)
_PRODUCTS = {
    "wq": ((0,), (1, 2, 3)), "wk": ((0,), (1, 2)), "wv": ((0,), (1, 2)),
    "attn/wo": ((0, 1, 2), (3,)), "cross/wo": ((0, 1, 2), (3,)),
    "mlp/wi": ((0,), (1,)), "mlp/wg": ((0,), (1,)), "mlp/wo": ((0,), (1,)),
    "shared/wi": ((0,), (1,)), "shared/wg": ((0,), (1,)),
    "shared/wo": ((0,), (1,)),
    "router": ((0,), (1,)),
    "moe/wi": ((1,), (2,)), "moe/wg": ((1,), (2,)), "moe/wo": ((1,), (2,)),
    "in_z": ((0,), (1,)), "in_x": ((0,), (1,)), "in_B": ((0,), (1,)),
    "in_C": ((0,), (1,)), "in_dt": ((0,), (1,)), "ssm/out": ((0,), (1,)),
    "unembed": ((0,), (1,)),
}
# per-channel leaves of rank 2 or more, which no product contracts
_ELEMENTWISE = ("bq", "bk", "bv", "conv_x", "conv_B", "conv_C")
_STACKS = ("layers", "enc_layers")


class _Tally:
    def __init__(self):
        self.ops: Dict[str, Dict[str, float]] = {}

    def add(self, op: str, result_bytes: float, axes, mesh,
            count: float = 1.0) -> None:
        self.add_group(op, result_bytes, _size(axes, mesh), count)

    def add_group(self, op: str, result_bytes: float, gs: int,
                  count: float = 1.0) -> None:
        if gs <= 1 and op != "collective-permute":
            return
        agg = self.ops.setdefault(op, {"count": 0.0, "wire_bytes": 0.0})
        agg["count"] += count
        agg["wire_bytes"] += count * ring_wire_bytes(op, result_bytes, gs)


def _size(axes, mesh) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _legal_axes(logical: Tuple, dim: int, rules: Rules, mesh) -> Tuple:
    """The axes ``logical`` (one dim's names) resolves to, cut to those
    that divide ``dim``."""
    return _axes(legalize(resolve(logical, rules), (dim,), mesh)[0])


def _leaves(logical, legal, tree, path=()) -> Iterator:
    """(path, logical spec, legalized spec, tensor) for every leaf."""
    if _spec_leaf(logical):
        yield path, logical or (), legal, tree
        return
    for k in sorted(logical):
        yield from _leaves(logical[k], legal[k], tree[k], path + (k,))


def _role(path) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    return _PRODUCTS.get("/".join(path[-2:]), _PRODUCTS.get(path[-1]))


class _Step:
    """One step's shapes: tokens per device and the layer counts."""

    def __init__(self, cfg, shape, rules: Rules, mesh):
        self.cfg, self.kind, self.mesh = cfg, shape.kind, mesh
        b, s = shape.global_batch, shape.seq_len
        self.seq_len = s
        self.dp = _legal_axes(("dp",), b, rules, mesh)
        self.sp = () if shape.kind == "decode" else \
            _legal_axes(("sp",), s, rules, mesh)
        self.b_loc = b // _size(self.dp, mesh)
        self.s_full = 1 if shape.kind == "decode" else s
        self.s_loc = self.s_full // _size(self.sp, mesh)
        self.tokens = self.b_loc * self.s_loc
        enc = cfg.encoder_seq or 0
        self.enc_tokens = self.b_loc * (enc // _size(
            _legal_axes(("sp",), enc, rules, mesh), mesh) if enc else 0)
        self.train = shape.kind == "train"
        self.remat = 1 if self.train and cfg.remat != "none" else 0
        self.passes = 1 + self.remat      # forward passes of every layer

    def uses(self, path) -> int:
        """How many times one step applies the leaf (per layer slice)."""
        cfg = self.cfg
        if path[0] == "shared":
            return cfg.num_layers // cfg.hybrid_period
        return 1

    def leaf_tokens(self, path) -> int:
        if path[0] == "enc_layers" or (len(path) > 2 and path[1] == "cross"
                                       and path[-1] in ("wk", "wv")):
            return self.enc_tokens
        return self.tokens


def _param_terms(t: _Tally, st: _Step, rules: Rules, logical_tree,
                 legal_tree, params) -> None:
    """Terms 1, 2 and 6 over every parameter leaf."""
    mesh, cfg = st.mesh, st.cfg
    vocab_kept = bool(resolve(("dp", "sp", "vocab"), rules)[2])
    for path, logical, legal, leaf in _leaves(logical_tree, legal_tree,
                                              params):
        stacked = path[0] in _STACKS
        n_stack = leaf.shape[0] if stacked else 1
        dims = tuple(leaf.shape[1:] if stacked else leaf.shape)
        logical = tuple(logical[1:] if stacked else logical)
        spec = tuple(legal[1:] if stacked else legal) + (None,) * len(dims)
        axes = [_axes(spec[i]) for i in range(len(dims))]
        stored = tuple(a for ax in axes for a in ax)
        one_bytes = math.prod(dims) * priced_size(leaf.dtype)
        shard_bytes = one_bytes / _size(stored, mesh)
        uses = st.uses(path) * n_stack
        gather = () if st.kind == "decode" else tuple(
            a for i, ax in enumerate(axes) for a in ax
            if logical[i] == "fsdp"
            or (logical[i] == "vocab" and not vocab_kept))
        kept = [tuple(a for a in ax if a not in gather) for ax in axes]
        if gather:                                          # term 1
            t.add("all-gather", one_bytes / _size(
                tuple(a for ax in kept for a in ax), mesh), gather, mesh,
                n_stack * (st.passes if st.train else 1)
                * st.uses(path))
        if st.train:                                        # term 6
            grad = shard_bytes * 4 / priced_size(leaf.dtype)
            split = st.dp + st.sp
            t.add("reduce-scatter", grad,
                  tuple(a for a in split if a in stored), mesh, n_stack)
            t.add("all-reduce", grad,
                  tuple(a for a in split if a not in stored), mesh, n_stack)
        tokens = st.leaf_tokens(path)
        if path[-1] == "tok":                   # the embedding lookup
            if kept[0]:
                t.add("all-reduce", tokens * dims[1] * FLOAT_BYTES, kept[0],
                      mesh, st.passes)
            if cfg.tie_embeddings:
                _product(t, st, tokens, dims[::-1],
                         ((0,), (1,)), [kept[1], kept[0]], 1)
            continue
        role = _role(path)
        if role is not None:                                # term 2
            _product(t, st, tokens, dims, role, kept, uses)
        elif len(dims) >= 2 and path[-1] not in _ELEMENTWISE:
            raise NotImplementedError(
                f"sharding.collectives: parameter {'/'.join(path)} "
                f"{tuple(dims)} has no product role (_PRODUCTS) and is not "
                f"per-channel (_ELEMENTWISE)")


def _product(t: _Tally, st: _Step, tokens: int, dims, role, kept,
             uses: int) -> None:
    """Term 2 for one weight applied ``uses`` times to ``tokens``."""
    mesh = st.mesh
    ins, outs = role
    in_axes = tuple(a for i in ins for a in kept[i])
    out_axes = tuple(a for i in outs for a in kept[i])
    batch_shards = math.prod(_size(kept[i], mesh) for i in range(len(dims))
                             if i not in ins and i not in outs)
    out_elems = math.prod(dims[i] for i in outs) / _size(out_axes, mesh)
    in_elems = math.prod(dims[i] for i in ins) / _size(in_axes, mesh)
    if batch_shards > 1:        # expert weights: handled by term 4
        return
    if in_axes:
        t.add("all-reduce", tokens * out_elems * FLOAT_BYTES, in_axes, mesh,
              uses * st.passes)
    if out_axes and st.train:
        t.add("all-reduce", tokens * in_elems * FLOAT_BYTES, out_axes, mesh,
              uses)
    if out_axes and st.kind == "decode" and dims[outs[-1]] == \
            st.cfg.d_model:
        t.add("all-gather", tokens * math.prod(dims[i] for i in outs)
              * FLOAT_BYTES, out_axes, mesh, uses)
    if out_axes and dims[outs[-1]] == st.cfg.vocab_padded:
        t.add("all-reduce", tokens * 2 * 4, out_axes, mesh, st.passes)


def _attention_terms(t: _Tally, st: _Step, rules: Rules) -> None:
    """Term 3."""
    cfg, mesh = st.cfg, st.mesh
    if cfg.attention_free:
        return
    n_attn = {"hybrid": cfg.num_layers // max(cfg.hybrid_period, 1),
              "encdec": cfg.num_layers + cfg.num_encoder_layers}.get(
                  cfg.family, cfg.num_layers)
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    kv_axes = _legal_axes(("tp_kv",), g, rules, mesh)
    g_loc = g // _size(kv_axes, mesh)
    h_loc = cfg.n_heads // _size(kv_axes + _legal_axes(
        ("tp_rep",), cfg.n_heads // g, rules, mesh), mesh)
    if st.sp:
        kv = st.b_loc * st.s_full * g_loc * hd * FLOAT_BYTES
        t.add("all-gather", kv, st.sp, mesh, 2 * n_attn * st.passes)
        blk = cfg.attn_block
        span = blk // st.s_loc if st.s_full > blk and \
            st.s_full % blk == 0 else 1
        if st.train and span > 1:
            n = n_attn * (st.s_full // blk)
            t.add_group("all-gather", st.b_loc * h_loc * blk * hd
                        * FLOAT_BYTES, span, n)               # queries
            t.add_group("all-gather", st.b_loc * h_loc * blk * 4, span, n)
            t.add_group("all-to-all", st.b_loc * h_loc * st.s_loc * blk
                        * 4, span, n)                         # scores
            t.add_group("all-reduce", 2 * st.b_loc * g_loc * blk * hd
                        * FLOAT_BYTES, span, n)               # dK, dV
        elif st.train:
            t.add("reduce-scatter", kv / _size(st.sp, mesh), st.sp, mesh,
                  2 * n_attn)
    if st.kind == "decode":
        kv_seq = _legal_axes(("kv_seq",), st.seq_len, rules, mesh)
        t.add("all-reduce", st.b_loc * h_loc * 2 * 4, kv_seq, mesh, n_attn)
        t.add("all-reduce", st.b_loc * h_loc * hd * FLOAT_BYTES, kv_seq,
              mesh, n_attn)


def _expert_terms(t: _Tally, st: _Step, rules: Rules) -> None:
    """Term 4."""
    cfg, mesh = st.cfg, st.mesh
    if cfg.moe is None or cfg.family != "moe":
        return
    e = cfg.moe
    ep = _legal_axes(("ep",), e.num_experts, rules, mesh)
    x = st.tokens * cfg.d_model * FLOAT_BYTES
    if not set(ep) & set(st.dp + st.sp):
        t.add("all-reduce", x, ep, mesh, cfg.num_layers * st.passes)
        if st.train:
            t.add("all-reduce", x, ep, mesh, cfg.num_layers)
        return
    slots = x * e.top_k * e.capacity_factor
    passes = st.passes + (1 if st.train else 0)
    t.add("all-to-all", slots, ep, mesh, 2 * cfg.num_layers * passes)


def _ssm_terms(t: _Tally, st: _Step, rules: Rules) -> None:
    """Term 5."""
    cfg, mesh = st.cfg, st.mesh
    if cfg.ssm is None:
        return
    din = cfg.ssm.d_inner(cfg.d_model)
    tp = _legal_axes(("tp",), din, rules, mesh)
    if not tp:
        return
    n = cfg.num_layers
    t.add("all-reduce", st.tokens * 4, tp, mesh,
          n * (st.passes + (1 if st.train else 0)))
    if st.kind == "prefill":
        t.add("all-gather", st.b_loc * (cfg.ssm.d_conv - 1) * din * FLOAT_BYTES,
              tp, mesh, n)
    if st.kind == "decode":
        t.add("all-gather", st.b_loc * din * FLOAT_BYTES, tp, mesh, n)
        t.add("all-gather", cfg.ssm.d_conv * din * FLOAT_BYTES, tp, mesh, n)


def step_collectives(cfg, shape, rules: Rules, mesh, param_specs,
                     param_shardings, params) -> Dict[str, Dict[str, float]]:
    """``{op: {"count", "wire_bytes"}}`` per device for one step of
    ``cfg`` at ``shape`` (train step, prefill or decode) on ``mesh``
    under ``rules``.  ``param_specs`` is the logical spec tree of
    ``params`` (``Model.param_specs``), ``param_shardings`` its legalized
    specs (``tree_shardings(param_specs, mesh, rules, params)``) and
    ``params`` the parameters as the step reads them (meta tensors)."""
    st = _Step(cfg, shape, rules, mesh)
    t = _Tally()
    _param_terms(t, st, rules, param_specs, param_shardings, params)
    _attention_terms(t, st, rules)
    _expert_terms(t, st, rules)
    _ssm_terms(t, st, rules)
    return t.ops
