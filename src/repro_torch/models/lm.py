"""Model assembly for every family of the reference.

Port of ``repro.models.lm.Model`` for ``family`` "dense" (qwen2-style),
"moe" (the dense layer with a Mixture-of-Experts MLP), "vlm" (the dense
stack with image embeddings prepended), "ssm" (Mamba-2), "hybrid"
(zamba2: groups of ``hybrid_period`` Mamba-2 layers, each group followed
by one shared attention + MLP block, the same parameters in every group)
and "encdec" (whisper: a stack of non-causal encoder layers over
``batch["encoder_embeds"]``, then decoder layers of causal
self-attention, cross-attention over the encoder output and an MLP, with
sinusoidal positions added to both inputs; every attention of the family
is plain, as in the reference, whatever ``use_kernel`` says).
Same methods as the reference, on nested dicts of tensors::

  init(generator) -> params                 param_specs() -> logical specs
  forward(params, batch) -> (logits, aux)   loss(params, batch) -> (loss, metrics)
  init_cache(batch, max_len, enc_len=0) -> cache
  cache_specs() -> logical specs
  prefill(params, batch, max_len) -> (cache, logits)
  decode(params, cache, tokens) -> (cache, logits)

Layer parameters are stacked on a leading layer axis, as in the
reference, so converting a reference tree is a copy; the layer stack is a
Python loop over that axis (the reference's ``lax.scan``).  The
logical spec trees (``param_specs``, ``cache_specs``) are the
reference's, tuples of logical axis names that ``repro_torch.sharding``
resolves onto a mesh; the reference's ``constrain`` (a sharding
constraint) is the identity on one device and is left out.  Remat follows ``cfg.remat`` as in the reference
(``remat``): each layer (the hybrid family: each group of ssm layers with
its shared block; the encdec encoder's layers too) runs checkpointed when
``forward`` or ``loss`` records a graph, and plain otherwise.
``cache["len"]`` is a Python int, and ``decode`` writes the KV cache, or
the ssm cache's conv window and state, in place (the reference donates
the cache to a jitted step).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import leaves
from repro_torch.sharding.specs import map_specs

from . import layers as L
from . import mamba2 as M
from . import moe as MOE

Params = Dict[str, Any]

_PORTED = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
# rows of the table the reference's ``decode`` takes the encdec family's
# position row from
DECODE_POSITIONS = 8192


_ATEN = torch.ops.aten
# the products a selective remat policy saves: "dots" every matrix
# product (the reference's ``checkpoint_dots``), "dots_nb" those without
# batch dims (``checkpoint_dots_with_no_batch_dims``: the projections, not
# the attention scores or the per-expert products)
SAVED_PRODUCTS = {
    "dots": (_ATEN.mm.default, _ATEN.addmm.default, _ATEN.bmm.default,
             _ATEN.baddbmm.default),
    "dots_nb": (_ATEN.mm.default, _ATEN.addmm.default)}


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under a remat policy, the reference's ``_maybe_remat``:
    "none" leaves it as it is; "dots" and "dots_nb" checkpoint it saving
    only the products ``SAVED_PRODUCTS`` lists (the rest is recomputed in
    the backward pass); any other value ("full") checkpoints it whole.
    Remat changes what the backward pass keeps, never a value."""
    if policy == "none":
        return fn
    kw: Dict[str, Any] = {"use_reentrant": False}
    if policy in SAVED_PRODUCTS:
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts,
            list(SAVED_PRODUCTS[policy]))
    return functools.partial(ckpt.checkpoint, fn, **kw)


def _check_family(cfg) -> None:
    if cfg.family not in _PORTED:
        raise ValueError(cfg.family)
    if cfg.family == "hybrid" and (
            cfg.hybrid_period <= 0 or cfg.num_layers % cfg.hybrid_period):
        # the reference reshapes the layer stack into whole groups
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not form "
                         f"groups of hybrid_period {cfg.hybrid_period}")


def _stacked(layout, n: int):
    """Prepend a layer axis of ``n`` to every leaf shape of a layout."""
    return {k: _stacked(v, n) if isinstance(v, dict)
            else ((n,) + tuple(v[0]), v[1]) for k, v in layout.items()}


def layer_layout(cfg) -> L.Layout:
    """One stacked layer's parameters: the reference's ``_init_layer``
    (dense, moe, vlm: "moe" in place of "mlp" for the moe family),
    ``_init_ssm_layer`` (ssm, hybrid) or ``_init_decdec_layer`` (encdec:
    the decoder layer) tree."""
    if cfg.family in ("ssm", "hybrid"):
        return {"ln": L.layout_norm(cfg.d_model, cfg.norm),
                "ssm": M.layout_ssm(cfg)}
    if cfg.family == "encdec":
        return {"ln1": L.layout_norm(cfg.d_model, cfg.norm),
                "attn": L.layout_attention(cfg),
                "lnx": L.layout_norm(cfg.d_model, cfg.norm),
                "cross": L.layout_cross_attention(cfg),
                "ln2": L.layout_norm(cfg.d_model, cfg.norm),
                "mlp": L.layout_mlp(cfg)}
    return dense_layout(cfg)


def dense_layout(cfg) -> L.Layout:
    """An attention + MLP (or MoE) layer: the reference's ``_init_layer``
    tree, which is also the hybrid family's one ``shared`` block and the
    encdec family's encoder layer."""
    p = {"ln1": L.layout_norm(cfg.d_model, cfg.norm),
         "attn": L.layout_attention(cfg),
         "ln2": L.layout_norm(cfg.d_model, cfg.norm)}
    if cfg.moe is not None and cfg.family == "moe":
        p["moe"] = MOE.layout_moe(cfg)
    else:
        p["mlp"] = L.layout_mlp(cfg)
    return p


def _stacks(cfg) -> Dict[str, Tuple[L.Layout, int]]:
    """The stacked subtrees: name -> (one layer's layout, layer count)."""
    stacks = {"layers": (layer_layout(cfg), cfg.num_layers)}
    if cfg.family == "encdec":
        stacks["enc_layers"] = (dense_layout(cfg), cfg.num_encoder_layers)
    return stacks


def param_layout(cfg) -> L.Layout:
    """Every parameter's (shape, init kind), layers stacked on axis 0: the
    reference's ``Model.init`` tree, shape for shape."""
    _check_family(cfg)
    p = {"embed": L.layout_embed(cfg),
         "final_norm": L.layout_norm(cfg.d_model, cfg.norm)}
    p.update({k: _stacked(lay, n) for k, (lay, n) in _stacks(cfg).items()})
    if cfg.family == "hybrid":
        p["shared"] = dense_layout(cfg)
    if cfg.family == "encdec":
        p["enc_norm"] = L.layout_norm(cfg.d_model, cfg.norm)
    return p


def _stacked_specs(spec):
    """Prepend a None (layer) dim to every leaf of a logical spec tree."""
    return map_specs(lambda s: (None,) + s, spec)


def decode_position_row(pos: int, d_model: int, device) -> torch.Tensor:
    """(1, d_model) float32: the encdec decode step's position row, row
    ``pos`` of the reference's ``DECODE_POSITIONS``-row sinusoidal table.
    The reference slices it with ``lax.dynamic_slice_in_dim``, which clamps
    the start into the table, so every position past the last row reads
    the last row; this does the same."""
    row = min(max(int(pos), 0), DECODE_POSITIONS - 1)
    return L.sinusoidal_positions(1, d_model, device, start=row)


def _layer(stacked: Params, i: int) -> Params:
    """Layer ``i``'s parameters (views) from the stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


class Model(nn.Module):
    """A decoder-only LM on ``device`` (default ``"cuda"``, which raises
    without a card).  ``use_kernel`` sends the dense stack's (dense, moe,
    vlm) full-sequence attention (``forward``, ``loss``, ``prefill``) through
    the flash-attention kernel, and the ssm family's full-sequence scan
    (``forward``, ``loss``; not ``prefill``, which needs the final state,
    as in the reference) through the SSD chunk-scan kernel.  The hybrid
    family's ``forward`` and ``loss`` run both (each ssm layer's scan, and
    the shared block's attention once a group); its ``prefill`` runs
    neither, as the reference's (which calls the shared block's attention
    without ``use_kernel``).  Nor does any method of the encdec family:
    the reference runs its encoder, decoder and cross-attention plain."""

    def __init__(self, cfg, use_kernel: bool = False,
                 device: DeviceLike = "cuda"):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.param_dtype = getattr(torch, cfg.param_dtype)

    # ------------------------------------------------------------- params
    def init(self, generator: torch.Generator) -> Params:
        """Random parameters drawn from ``generator`` (a CPU or CUDA
        generator; the tensors land on the model's device)."""
        stacks = _stacks(self.cfg)
        p = {}
        for k, lay in param_layout(self.cfg).items():
            lead = ()
            if k in stacks:
                lay, n = stacks[k]
                lead = (n,)
            p[k] = L.init_from_layout(lay, generator, self.device,
                                      self.param_dtype, lead=lead)
        return p

    def param_specs(self) -> Params:
        """The logical spec of every parameter, the ``init`` tree's keys:
        the reference's ``Model.param_specs``."""
        cfg = self.cfg
        sp: Params = {"embed": L.spec_embed(cfg),
                      "final_norm": L.spec_norm(cfg.norm)}
        if cfg.family in ("dense", "moe", "vlm"):
            sp["layers"] = _stacked_specs(self._spec_layer(cfg))
        elif cfg.family == "ssm":
            sp["layers"] = _stacked_specs(self._spec_ssm_layer(cfg))
        elif cfg.family == "hybrid":
            sp["layers"] = _stacked_specs(self._spec_ssm_layer(cfg))
            sp["shared"] = self._spec_layer(cfg)
        elif cfg.family == "encdec":
            sp["enc_layers"] = _stacked_specs(self._spec_layer(cfg))
            sp["enc_norm"] = L.spec_norm(cfg.norm)
            sp["layers"] = _stacked_specs(self._spec_decdec_layer(cfg))
        return sp

    @staticmethod
    def _spec_layer(cfg) -> Params:
        p = {"ln1": L.spec_norm(cfg.norm), "attn": L.spec_attention(cfg),
             "ln2": L.spec_norm(cfg.norm)}
        if cfg.moe is not None and cfg.family == "moe":
            p["moe"] = MOE.spec_moe(cfg)
        else:
            p["mlp"] = L.spec_mlp(cfg)
        return p

    @staticmethod
    def _spec_ssm_layer(cfg) -> Params:
        return {"ln": L.spec_norm(cfg.norm), "ssm": M.spec_ssm(cfg)}

    @staticmethod
    def _spec_decdec_layer(cfg) -> Params:
        return {"ln1": L.spec_norm(cfg.norm), "attn": L.spec_attention(cfg),
                "lnx": L.spec_norm(cfg.norm),
                "cross": L.spec_attention(cfg),
                "ln2": L.spec_norm(cfg.norm), "mlp": L.spec_mlp(cfg)}

    def _plan(self, params: Params) -> List[Tuple[str, int, Params, bool]]:
        """The stack in run order: (kind "ssm", "dense" or "cross" (an
        encdec decoder layer), cache index, layer parameters, shared).  The
        hybrid family runs its one ``shared`` block after every
        ``hybrid_period`` ssm layers, with cache index g in group g (the
        reference's reshape of the stack into groups); the same parameters
        serve every group.  The encdec encoder is not in the plan: it runs
        first, in ``_encoder``."""
        cfg = self.cfg
        kind = {"ssm": "ssm", "hybrid": "ssm",
                "encdec": "cross"}.get(cfg.family, "dense")
        plan = []
        for i in range(cfg.num_layers):
            plan.append((kind, i, _layer(params["layers"], i), False))
            if cfg.family == "hybrid" and (i + 1) % cfg.hybrid_period == 0:
                plan.append(("dense", i // cfg.hybrid_period,
                             params["shared"], True))
        return plan

    # ------------------------------------------------------------ forward
    def _embed_inputs(self, params: Params, batch):
        """Returns (x, positions, loss_mask, labels).  For the vlm family
        ``batch["image_embeds"]`` (B, N_img, D) is prepended to the token
        embeddings; its positions carry label 0 and no loss, and the mask
        is (1, S), as the reference's.  The encdec family adds the
        sinusoidal position table to the token embeddings."""
        cfg = self.cfg
        dev = self.device
        tokens = torch.as_tensor(batch["tokens"], dtype=torch.long,
                                 device=dev)
        b = tokens.shape[0]
        x = L.apply_embed(params["embed"], tokens, cfg)
        if cfg.family == "vlm":
            img = torch.as_tensor(batch["image_embeds"], device=dev).to(
                self.dtype)                                   # (B, Nimg, D)
            x = torch.cat([img, x], dim=1)
            n_img, s = img.shape[1], x.shape[1]
            labels = torch.cat([tokens.new_zeros((b, n_img)), tokens], dim=1)
            pos = torch.arange(s, device=dev)
            mask = ((pos >= n_img) & (pos < s - 1)).float()[None, :]
            labels = torch.roll(labels, -1, dims=1)
        else:
            s = tokens.shape[1]
            labels = torch.roll(tokens, -1, dims=1)
            mask = (torch.arange(s, device=dev) < s - 1).float()
            mask = mask[None, :].expand(b, s)
        if cfg.family == "encdec":
            x = x + L.sinusoidal_positions(s, cfg.d_model, dev).to(
                self.dtype)[None]
        positions = torch.arange(s, device=dev)[None].expand(b, s)
        return x, positions, mask, labels

    def _ffn(self, p_l: Params, h: torch.Tensor):
        """The layer's MLP or MoE: (out, balance loss; 0 for an MLP)."""
        if "moe" in p_l:
            return MOE.apply_moe(p_l["moe"], h, self.cfg)
        return (L.apply_mlp(p_l["mlp"], h, self.cfg),
                torch.zeros((), dtype=torch.float32, device=self.device))

    def _dense_layer_fwd(self, p_l: Params, x: torch.Tensor, positions,
                         use_kernel: Optional[bool] = None,
                         causal: bool = True):
        """Returns (x, (k, v), balance loss).  The attention runs through
        the kernel if ``use_kernel`` (default: the model's)."""
        cfg = self.cfg
        if use_kernel is None:
            use_kernel = self.use_kernel
        h = L.apply_norm(p_l["ln1"], x, cfg.norm)
        a, kv = L.apply_attention(p_l["attn"], h, cfg, positions,
                                  causal=causal, use_kernel=use_kernel)
        x = x + a
        h = L.apply_norm(p_l["ln2"], x, cfg.norm)
        m, aux = self._ffn(p_l, h)
        return x + m, kv, aux

    def _cross_layer_fwd(self, p_l: Params, x: torch.Tensor, positions,
                         enc_out: torch.Tensor):
        """An encdec decoder layer over the whole sequence: causal
        self-attention, cross-attention over ``enc_out``, MLP, all plain.
        Returns (x, (k, v), (ck, cv))."""
        cfg = self.cfg
        h = L.apply_norm(p_l["ln1"], x, cfg.norm)
        a, kv = L.apply_attention(p_l["attn"], h, cfg, positions,
                                  use_kernel=False)
        x = x + a
        h = L.apply_norm(p_l["lnx"], x, cfg.norm)
        ck, cv = L.cross_kv(p_l["cross"], enc_out, cfg)
        x = x + L.apply_cross_attention(p_l["cross"], h, cfg, ck, cv)
        h = L.apply_norm(p_l["ln2"], x, cfg.norm)
        return x + L.apply_mlp(p_l["mlp"], h, cfg), kv, (ck, cv)

    def _units(self, params: Params) -> List[list]:
        """The plan cut into the units remat wraps, the reference's scan
        bodies: one layer each, or for the hybrid family one group (its
        ssm layers and the shared block after them)."""
        plan = self._plan(params)
        if self.cfg.family != "hybrid":
            return [[step] for step in plan]
        n = self.cfg.hybrid_period + 1
        return [plan[i:i + n] for i in range(0, len(plan), n)]

    def _layer_fn(self, params: Params) -> Callable:
        """How a unit runs: under ``cfg.remat`` when a graph is recorded
        on the parameters, else as it is."""
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in leaves(params)):
            return lambda fn: remat(fn, self.cfg.remat)
        return lambda fn: fn

    def _encoder(self, params: Params, enc_embeds,
                 wrap: Callable = lambda fn: fn) -> torch.Tensor:
        """The encdec encoder: ``enc_embeds`` (B, S_enc, D) in the compute
        dtype plus the sinusoidal table, non-causal plain self-attention
        (rope still applies, as in the reference) and the MLP in every
        layer (each through ``wrap``), then ``enc_norm``."""
        cfg = self.cfg
        x = torch.as_tensor(enc_embeds, device=self.device).to(self.dtype)
        b, s = x.shape[:2]
        x = x + L.sinusoidal_positions(s, cfg.d_model, self.device).to(
            self.dtype)[None]
        positions = torch.arange(s, device=self.device)[None].expand(b, s)

        def layer(x, p_l):
            return self._dense_layer_fwd(p_l, x, positions, use_kernel=False,
                                         causal=False)[0]
        for i in range(cfg.num_encoder_layers):
            x = wrap(layer)(x, _layer(params["enc_layers"], i))
        return L.apply_norm(params["enc_norm"], x, cfg.norm)

    def _ssm_layer_fwd(self, p_l: Params, x: torch.Tensor):
        h = L.apply_norm(p_l["ln"], x, self.cfg.norm)
        return x + M.apply_ssm(p_l["ssm"], h, self.cfg,
                               use_kernel=self.use_kernel)

    def forward(self, params: Params, batch):
        """Teacher-forcing forward.  Returns (logits, (aux, mask, labels));
        aux is the MoE balance loss summed over layers (0 without MoE)."""
        cfg = self.cfg
        x, positions, mask, labels = self._embed_inputs(params, batch)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        wrap = self._layer_fn(params)
        enc_out = None
        if cfg.family == "encdec":
            enc_out = self._encoder(params, batch["encoder_embeds"], wrap)

        def unit(x, aux, steps):
            for kind, _, p_l, _ in steps:
                if kind == "ssm":
                    x = self._ssm_layer_fwd(p_l, x)
                elif kind == "cross":
                    x = self._cross_layer_fwd(p_l, x, positions, enc_out)[0]
                else:
                    x, _, a = self._dense_layer_fwd(p_l, x, positions)
                    aux = aux + a
            return x, aux
        for steps in self._units(params):
            x, aux = wrap(unit)(x, aux, steps)
        x = L.apply_norm(params["final_norm"], x, cfg.norm)
        logits = L.apply_unembed(params["embed"], x, cfg)
        return logits, (aux, mask, labels)

    def loss(self, params: Params, batch):
        """Mean next-token cross-entropy over the positions that have a
        label (every one but the last), in float32; returns (loss,
        {"ce", "aux", "tokens"}).  It records a graph only where
        parameters require grad (``train.step`` differentiates it); with
        ``init``'s parameters it scores a batch and builds none.  The
        kernels have no backward: with ``use_kernel`` and parameters that
        require grad, the kernel wrappers raise."""
        logits, (aux, mask, labels) = self.forward(params, batch)
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, labels[..., None])[..., 0]
        nll = (lse - ll) * mask
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = nll.sum() / denom
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux, "tokens": denom}

    # -------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_len: int,
                   enc_len: int = 0) -> Params:
        """The dense stack's (dense, moe, vlm) K/V cache (L, B, max_len, G,
        hd) in the compute dtype, or the ssm family's {"conv": (L, B, K-1, C),
        "state": (L, B, H, P, N)} in float32 (``max_len`` unused).  The
        hybrid family has both: the ssm cache of every layer, and K/V of
        the shared block, one (B, max_len, G, hd) per group.  The encdec
        family has the decoder's K/V and the cross-attention's "ck"/"cv",
        (L, B, enc_len or ``encoder_seq``, G, hd) in the compute dtype."""
        cfg = self.cfg
        cache: Params = {"len": 0}
        if cfg.family in ("ssm", "hybrid"):
            one = M.init_ssm_cache(cfg, batch_size, self.device)
            cache["ssm"] = {
                k: torch.zeros((cfg.num_layers,) + tuple(v.shape),
                               dtype=v.dtype, device=self.device)
                for k, v in one.items()}
        if cfg.family == "ssm":
            return cache
        n_kv = (cfg.num_layers // cfg.hybrid_period
                if cfg.family == "hybrid" else cfg.num_layers)
        shape = (n_kv, batch_size, max_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=self.dtype, device=self.device)
        cache["v"] = torch.zeros(shape, dtype=self.dtype, device=self.device)
        if cfg.family == "encdec":
            shape = (cfg.num_layers, batch_size, enc_len or cfg.encoder_seq,
                     cfg.n_kv_heads, cfg.resolved_head_dim)
            cache["ck"] = torch.zeros(shape, dtype=self.dtype,
                                      device=self.device)
            cache["cv"] = torch.zeros(shape, dtype=self.dtype,
                                      device=self.device)
        return cache

    def cache_specs(self) -> Params:
        """The logical spec of every cache leaf: the reference's
        ``Model.cache_specs``.  ``"len"`` is ``None`` (replicated), which
        pairs with ``api.abstract_cache``'s 0-d int32 ``len``, not with
        ``init_cache``'s Python int."""
        cfg = self.cfg
        kv = (None, "dp", "kv_seq", "tp_kv", None)
        c: Params = {"len": None}
        if cfg.family in ("dense", "moe", "vlm", "encdec"):
            c["k"] = kv
            c["v"] = kv
        if cfg.family == "encdec":
            c["ck"] = kv
            c["cv"] = kv
        if cfg.family in ("ssm", "hybrid"):
            c["ssm"] = _stacked_specs(M.spec_ssm_cache(cfg))
        if cfg.family == "hybrid":
            c["k"] = kv
            c["v"] = kv
        return c

    # ------------------------------------------------------------ prefill
    def prefill(self, params: Params, batch, max_len: int):
        """Process the full prompt; returns (cache, last-token logits)."""
        cfg = self.cfg
        x, positions, _, _ = self._embed_inputs(params, batch)
        b, s = x.shape[:2]
        if s > max_len and cfg.family != "ssm":
            raise ValueError(f"prefill: prompt of {s} tokens > max_len "
                             f"{max_len}")
        enc_out = None
        if cfg.family == "encdec":
            enc_out = self._encoder(params, batch["encoder_embeds"])
        cache = self.init_cache(
            b, max_len, enc_len=0 if enc_out is None else enc_out.shape[1])

        for kind, i, p_l, shared in self._plan(params):
            if kind == "ssm":
                h = L.apply_norm(p_l["ln"], x, cfg.norm)
                y, st = M.apply_ssm_prefill(p_l["ssm"], h, cfg)
                for k, v in st.items():
                    cache["ssm"][k][i] = v
                x = x + y
            elif kind == "cross":
                x, (k, v), (ck, cv) = self._cross_layer_fwd(
                    p_l, x, positions, enc_out)
                cache["k"][i, :, :s] = k
                cache["v"][i, :, :s] = v
                cache["ck"][i] = ck
                cache["cv"][i] = cv
            else:
                # the hybrid's shared block runs plain attention here, as
                # the reference's hybrid prefill does
                x, (k, v), _ = self._dense_layer_fwd(
                    p_l, x, positions, use_kernel=False if shared else None)
                cache["k"][i, :, :s] = k
                cache["v"][i, :, :s] = v
        cache["len"] = s
        x = L.apply_norm(params["final_norm"], x, cfg.norm)
        logits = L.apply_unembed(params["embed"], x[:, -1:, :], cfg)
        return cache, logits[:, 0, :]

    # ------------------------------------------------------------- decode
    def decode(self, params: Params, cache: Params, tokens):
        """One decode step. tokens: (B, 1) -> (cache, logits (B, V)); the
        cache is updated in place and returned.  Past a full K/V cache the
        step writes its last row (``apply_attention_decode``) and
        ``cache["len"]`` keeps counting, as in the reference."""
        cfg = self.cfg
        pos = cache["len"]
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        x = L.apply_embed(params["embed"], tokens, cfg)
        if cfg.family == "encdec":
            x = x + decode_position_row(pos, cfg.d_model, self.device).to(
                self.dtype)[None]

        for kind, i, p_l, _ in self._plan(params):
            if kind == "ssm":
                h = L.apply_norm(p_l["ln"], x, cfg.norm)
                y, _ = M.apply_ssm_decode(p_l["ssm"], h, cfg, {
                    k: v[i] for k, v in cache["ssm"].items()})
                x = x + y
                continue
            h = L.apply_norm(p_l["ln1"], x, cfg.norm)
            a, _ = L.apply_attention_decode(p_l["attn"], h, cfg,
                                            cache["k"][i], cache["v"][i], pos)
            x = x + a
            if kind == "cross":
                h = L.apply_norm(p_l["lnx"], x, cfg.norm)
                x = x + L.apply_cross_attention(
                    p_l["cross"], h, cfg, cache["ck"][i].to(x.dtype),
                    cache["cv"][i].to(x.dtype))
            h = L.apply_norm(p_l["ln2"], x, cfg.norm)
            x = x + self._ffn(p_l, h)[0]
        cache["len"] = pos + 1
        x = L.apply_norm(params["final_norm"], x, cfg.norm)
        logits = L.apply_unembed(params["embed"], x, cfg)
        return cache, logits[:, 0, :]


def build_model(cfg, use_kernel: bool = False,
                device: DeviceLike = "cuda") -> Model:
    return Model(cfg, use_kernel=use_kernel, device=device)
