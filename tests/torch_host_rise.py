"""A stand-in on the CPU for ``chip_smoke.device_rise``, the card's peak
allocation inside a block: the CPU keeps no allocation peak, so this
counts the bytes of every tensor off the meta device that an op makes
inside the block."""
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _Made(TorchDispatchMode):
    """Sums the bytes of every tensor off the meta device an op makes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.bytes += sum(t.numel() * t.element_size()
                          for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor) and not t.is_meta)
        return out


@contextlib.contextmanager
def host_rise(dev):
    """``device_rise``'s stand-in: {"bytes": the bytes of every real tensor
    made inside the block}, filled when the block ends."""
    out = {}
    with _Made() as made:
        yield out
    out["bytes"] = made.bytes
