"""Language models (the dense, moe, vlm, ssm and hybrid families so far):
port of ``repro.models``."""
from .lm import Model, build_model, param_layout

__all__ = ["Model", "build_model", "param_layout"]
