"""Application models: HPL's run geometry (the DES apps wait for the DES
slice)."""
from .hpl import HPLConfig, numroc

__all__ = ["HPLConfig", "numroc"]
