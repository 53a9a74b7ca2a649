"""Language models (the dense, moe, vlm and ssm
families so far): port of
``repro.models``."""
from .lm import Model, build_model, param_layout

__all__ = ["Model", "build_model", "param_layout"]
