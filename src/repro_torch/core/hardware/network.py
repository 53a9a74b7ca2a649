"""Network links (paper §III-A2).

Only ``Link``, which the topologies are built from, is ported so far.
The stream-level ``Network``/``Flow`` model with max-min fair sharing
waits for the DES slice; its vectorized allocation is
``repro_torch.kernels.maxmin_fair.ops.waterfill``.
"""
from __future__ import annotations

from typing import Dict


class Link:
    __slots__ = ("capacity", "latency", "flows", "name", "_mark")

    def __init__(self, capacity: float, latency: float = 0.0, name: str = ""):
        self.capacity = capacity      # bytes / s
        self.latency = latency        # s per traversal
        # flow -> None: an *ordered* set (insertion order), kept for the
        # DES network model
        self.flows: Dict[object, None] = {}
        self.name = name
        self._mark = 0      # visited stamp for the DES component walk
