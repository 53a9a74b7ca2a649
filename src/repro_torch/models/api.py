"""Abstract model inputs and state: port of ``repro.models.api``.

The reference's descriptors are ``jax.ShapeDtypeStruct``s from
``jax.eval_shape``; here they are torch tensors on the ``meta`` device,
which carry a shape and a dtype and no storage.  Nothing is drawn or
allocated, so the trees of the largest configs (qwen3-moe-235b-a22b's
940 GB of float32 parameters) build in milliseconds on any host: the
paper's "matrix A is never allocated", applied to the model's weights,
optimizer state, caches and inputs.

``make_batch`` is the one concrete function: a seeded batch of the
shapes ``input_specs`` describes.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.train.optimizer import opt_init
from repro_torch.train.state import TrainState

from .lm import build_model, param_layout

_META = torch.device("meta")


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=_META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input of this cell: int32 tokens,
    and the vlm family's image embeddings or the encdec family's encoder
    frames in float32."""
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), i32)}
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        n_img = cfg.n_image_tokens
        out["tokens"] = _meta((b, s - n_img), i32)
        out["image_embeds"] = _meta((b, n_img, cfg.d_model), f32)
    elif cfg.family == "encdec":
        out["tokens"] = _meta((b, s), i32)
        out["encoder_embeds"] = _meta((b, cfg.encoder_seq, cfg.d_model), f32)
    else:
        out["tokens"] = _meta((b, s), i32)
    return out


def input_logical_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The logical axes of each input, as the reference names them."""
    if shape.kind == "decode":
        return {"tokens": ("dp", None)}
    out = {"tokens": ("dp", "sp")}
    if cfg.family == "vlm":
        out["image_embeds"] = ("dp", "sp", None)
    elif cfg.family == "encdec":
        out["encoder_embeds"] = ("dp", "sp", None)
    return out


def abstract_params(cfg: ModelConfig):
    """``Model.init``'s tree as meta tensors of ``cfg.param_dtype``, layer
    axes stacked: read from ``param_layout``, so nothing is drawn."""
    dtype = getattr(torch, cfg.param_dtype)

    def walk(layout):
        return {k: walk(v) if isinstance(v, dict) else _meta(v[0], dtype)
                for k, v in layout.items()}
    return walk(param_layout(cfg))


def abstract_state(cfg: ModelConfig) -> TrainState:
    """``make_train_state``'s state on meta tensors: the parameters, the
    optimizer state ``cfg.optimizer`` starts from, and a 0-d int32 step."""
    params = abstract_params(cfg)
    return TrainState(params=params, opt=opt_init(cfg.optimizer)(params),
                      step=_meta((), torch.int32))


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig):
    """``init_cache`` for this cell on meta tensors.  Its ``"len"`` is a
    0-d int32, as the reference's is; ``Model.init_cache`` keeps a Python
    int there, which ``decode`` counts with."""
    cache = build_model(cfg, device=_META).init_cache(
        shape.global_batch, shape.seq_len, enc_len=cfg.encoder_seq or 0)
    cache["len"] = _meta((), torch.int32)
    return cache


def make_batch(cfg: ModelConfig, shape: ShapeConfig,
               generator: Optional[torch.Generator] = None,
               scale: float = 0.02, *, device: DeviceLike = "cuda"):
    """A concrete synthetic batch matching ``input_specs``: tokens uniform
    in ``[0, vocab_size)`` (int32), float inputs ``randn * scale``
    (float32), drawn in that order from ``generator`` (default: a CPU
    generator seeded 0) on the generator's device, then moved to
    ``device``.  So one generator state gives one batch on every device.
    The values are not the reference's: it draws from jax's threefry
    stream, which torch's generators do not reproduce."""
    dev = resolve_device(device)
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if spec.dtype.is_floating_point:
            t = torch.randn(spec.shape, generator=gen, dtype=spec.dtype,
                            device=gen.device) * scale
        else:
            t = torch.randint(0, cfg.vocab_size, spec.shape, generator=gen,
                              dtype=spec.dtype, device=gen.device)
        out[name] = t.to(dev)
    return out
