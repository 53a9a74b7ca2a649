"""The 10 assigned architectures: the port's own copy of
``repro.configs.archs``.

Sources are noted per-arch ([arXiv/hf; tier] as assigned).  Each entry is
importable as ``repro_torch.configs.get_config(<id>)``.
"""
from __future__ import annotations

from .base import ModelConfig, MoEConfig, SSMConfig

# [ssm] SSD (state-space duality) [arXiv:2405.21060; unverified]
MAMBA2_780M = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50280, norm="rms", act="swiglu", attention_free=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4,
                  chunk_size=256, n_groups=1),
)

# [dense] GQA, QKV bias [arXiv:2407.10671; hf]
QWEN2_0_5B = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151936, head_dim=64, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
    remat="dots_nb", attn_block=2048,
)

# [dense] pruned nemotron [arXiv:2407.14679; hf]
MINITRON_8B = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=16384,
    vocab_size=256000, head_dim=128,
    remat="dots_nb", attn_block=2048,
)

# [dense] llama-arch, code, MQA kv=1 [arXiv:2405.04324; hf]
GRANITE_34B = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab_size=49152, head_dim=128,
    remat="dots_nb", attn_block=2048,
)

# [dense] MHA [hf:stabilityai/stablelm-2-1_6b; unverified]
STABLELM_3B = ModelConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab_size=50304, head_dim=80, norm="ln",
    remat="dots_nb", attn_block=2048,
)

# [hybrid] Mamba2 + shared attn blocks [arXiv:2411.15242; hf]
ZAMBA2_2_7B = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, head_dim=80, hybrid_period=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4,
                  chunk_size=256, n_groups=1),
)

# [moe] 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B(scaled); hf]
QWEN3_MOE_235B = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab_size=151936, head_dim=128, rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536,
                  capacity_factor=1.25),
    optimizer="adafactor",  # DESIGN.md §6: AdamW fp32 state ≈ 3.3 TB > 1-pod HBM budget
    remat="dots_nb", attn_block=2048,
)

# [moe] 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]
PHI35_MOE_42B = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab_size=32064, head_dim=128, norm="ln",
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400,
                  capacity_factor=1.25),
    remat="dots_nb", attn_block=2048,
)

# [audio] enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified]
WHISPER_MEDIUM = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=51865, head_dim=64, norm="ln", act="gelu",
    num_encoder_layers=24, encoder_seq=1500,
    remat="dots_nb", attn_block=2048,
)

# [vlm] mistral-7b backbone, anyres tiling (stubbed frontend)
# [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
LLAVA_NEXT_MISTRAL_7B = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128, rope_theta=1e6,
    n_image_tokens=2880,  # anyres: 5 tiles x 576 patch tokens
    remat="dots_nb", attn_block=2048,
)

ARCHS = {
    c.name: c for c in [
        MAMBA2_780M, QWEN2_0_5B, MINITRON_8B, GRANITE_34B, STABLELM_3B,
        ZAMBA2_2_7B, QWEN3_MOE_235B, PHI35_MOE_42B, WHISPER_MEDIUM,
        LLAVA_NEXT_MISTRAL_7B,
    ]
}
