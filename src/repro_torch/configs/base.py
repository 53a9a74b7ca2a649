"""Model and shape configurations: the port's own copy of
``repro.configs.base`` (pure Python, no jax), so that a config built here
equals the reference's field for field.

Every assigned architecture is expressed as a ``ModelConfig``; every assigned
input shape as a ``ShapeConfig``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk_size: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rms"               # rms | ln
    act: str = "swiglu"             # swiglu | gelu
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2-style): shared attention+mlp block applied every N ssm layers
    hybrid_period: int = 0
    # encoder-decoder (whisper-style)
    num_encoder_layers: int = 0
    encoder_seq: int = 0            # frames after the (stubbed) conv frontend
    # vlm (llava-style): precomputed image-patch embeddings prepended to text
    n_image_tokens: int = 0
    # whether full O(S^2) attention is the only sequence mixer (drives long_500k skip)
    attention_free: bool = False
    # optimizer override for memory-constrained giants (see DESIGN.md §6)
    optimizer: str = "adamw"        # adamw | adafactor
    remat: str = "full"             # full | none | dots
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # ---- performance knobs (EXPERIMENTS.md §Perf hillclimb) ----
    moe_impl: str = "einsum"        # einsum | scatter (sorted grouped-GEMM)
    attn_block: int = 1024          # blockwise-attention KV block
    force_scheme: Optional[str] = None   # override tp/sp scheme selection

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding tables are padded to a multiple of 256 so the vocab dim
        shards evenly on any production mesh axis combination; logits in the
        pad region are masked to -inf before the softmax."""
        return ((self.vocab_size + 255) // 256) * 256

    def n_params(self) -> int:
        """Total parameter count (analytical; used for 6ND model flops)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d
        out = 0 if self.tie_embeddings else self.vocab_size * d
        per_attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.qkv_bias:
            per_attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        if self.act == "swiglu":
            per_mlp = 3 * d * self.d_ff
        else:
            per_mlp = 2 * d * self.d_ff
        per_moe = 0
        if self.moe is not None:
            e = self.moe
            per_exp = 3 * d * e.d_ff_expert if self.act == "swiglu" else 2 * d * e.d_ff_expert
            per_moe = e.num_experts * per_exp + d * e.num_experts
            per_mlp = 0
        per_ssm = 0
        if self.ssm is not None:
            s = self.ssm
            din, nh, ns = s.d_inner(d), s.n_heads(d), s.d_state
            # in_proj: z, x, B, C, dt ; out_proj ; conv ; A, D, dt_bias ; gated norm
            per_ssm = d * (2 * din + 2 * s.n_groups * ns + nh) + din * d
            per_ssm += s.d_conv * (din + 2 * s.n_groups * ns) + 3 * nh + din
        norms = 2 * d  # final norm + small terms folded in
        if self.family in ("ssm",):
            per_layer = per_ssm + d
            return emb + out + self.num_layers * per_layer + norms
        if self.family == "hybrid":
            per_layer = per_ssm + d
            shared = per_attn + per_mlp + 2 * d
            n_apps = self.num_layers // max(self.hybrid_period, 1)
            return emb + out + self.num_layers * per_layer + shared + norms
        per_layer = per_attn + (per_moe or per_mlp) + 2 * d
        n_dec = self.num_layers
        total = emb + out + n_dec * per_layer + norms
        if self.num_encoder_layers:
            enc_layer = per_attn + per_mlp + 2 * d
            cross = per_attn + d
            total += self.num_encoder_layers * enc_layer + n_dec * cross
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        per_exp = 3 * self.d_model * e.d_ff_expert if self.act == "swiglu" \
            else 2 * self.d_model * e.d_ff_expert
        inactive = (e.num_experts - e.top_k - e.n_shared_experts) * per_exp
        return self.n_params() - self.num_layers * inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                       # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        return cfg.family in ("ssm", "hybrid")
    return True


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small: dict = dict(
        num_layers=min(cfg.num_layers, 2 if cfg.family != "hybrid" else 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(num_experts=4, top_k=min(cfg.moe.top_k, 2),
                                 d_ff_expert=128,
                                 capacity_factor=cfg.moe.capacity_factor,
                                 n_shared_experts=cfg.moe.n_shared_experts)
    if cfg.ssm is not None:
        small["ssm"] = SSMConfig(d_state=16, head_dim=32, expand=2, d_conv=4,
                                 chunk_size=32, n_groups=1)
    if cfg.hybrid_period:
        small["hybrid_period"] = 2
    if cfg.num_encoder_layers:
        small["num_encoder_layers"] = 2
        small["encoder_seq"] = 16
    if cfg.n_image_tokens:
        small["n_image_tokens"] = 8
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
