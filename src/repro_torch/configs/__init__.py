"""Model configurations (a copy of ``repro.configs``)."""
from .base import (ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES,
                   shape_applicable, reduced)
from .archs import ARCHS


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
           "ARCHS", "get_config", "get_shape", "list_archs",
           "shape_applicable", "reduced"]
