"""Grouped-query flash attention: the CUDA kernel, its plain version, and
the entry point that picks one by device."""
from .kernel import HEAD_DIMS, flash_attention_fwd
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["HEAD_DIMS", "attention_ref", "flash_attention",
           "flash_attention_fwd"]
