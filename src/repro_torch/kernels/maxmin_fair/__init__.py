"""Max-min fair bandwidth allocation: the masked row-min CUDA kernel,
its plain version, and the progressive-filling loop that runs it."""
from .kernel import INF, masked_min_rows
from .ops import flow_incidence, waterfill
from .ref import masked_min_rows_ref, waterfill_ref

__all__ = ["INF", "masked_min_rows", "masked_min_rows_ref", "waterfill",
           "waterfill_ref", "flow_incidence"]
