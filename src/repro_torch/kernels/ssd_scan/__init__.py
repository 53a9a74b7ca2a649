"""Mamba-2 SSD chunk scan: the CUDA kernel, its plain versions, and the
entry point that picks one by device."""
from .kernel import MAX_CHUNK, MAX_N, MAX_P, ssd_scan
from .ops import ssd
from .ref import ssd_ref_sequential, ssd_scan_ref, ssd_split_ref

__all__ = ["MAX_CHUNK", "MAX_N", "MAX_P", "ssd", "ssd_ref_sequential",
           "ssd_scan", "ssd_scan_ref", "ssd_split_ref"]
