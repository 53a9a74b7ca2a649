"""LM serving (port of ``repro.serve.engine``; the prediction service is
ported with slice 7)."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
