"""Carry specs and parameters from the reference package into the port.

Every function takes plain data (JSON text, floats and numpy arrays), so
the reference can produce it in another process; nothing here imports
the reference.
"""
from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.fastsim import _PARAM_FIELDS, FastSimParams
from repro_torch.models.lm import param_layout
from repro_torch.platforms.spec import Platform


def platform_from_reference(json_str: str) -> Platform:
    """The port's ``Platform`` from the reference's ``Platform.to_json()``."""
    return Platform.from_json(json_str)


def fastsim_params_from_numpy(
        d: Mapping[str, Union[float, np.ndarray]], *,
        device: DeviceLike = "cuda",
        requires_grad: bool = False) -> FastSimParams:
    """The port's ``FastSimParams`` with float64 tensor leaves on
    ``device`` from a dict of field name -> float or numpy float64 array
    (the reference's ``_stack_params`` form); 0-d leaves for floats.
    ``requires_grad`` makes every leaf a leaf of autograd."""
    missing = [n for n in _PARAM_FIELDS if n not in d]
    if missing:
        raise KeyError(f"fastsim_params_from_numpy: missing fields {missing}")
    dev = resolve_device(device)
    return FastSimParams(**{
        n: torch.tensor(np.asarray(d[n], np.float64), dtype=torch.float64,
                        device=dev, requires_grad=requires_grad)
        for n in _PARAM_FIELDS})


def lm_params_from_reference(tree: Mapping[str, Any], cfg, *,
                             device: DeviceLike = "cuda"
                             ) -> Mapping[str, Any]:
    """The port's LM parameters from the reference's ``Model.init`` tree
    given as nested dicts of numpy arrays (same keys, layer parameters
    stacked on axis 0).  Leaves are copied into ``cfg.param_dtype``
    tensors on ``device``.  A tree whose keys or shapes differ from the
    config's layout raises ``ValueError``."""
    layout = param_layout(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)

    def convert(node, lay, path):
        where = "/".join(path) or "<root>"
        if isinstance(lay, dict):
            if not isinstance(node, Mapping) or set(node) != set(lay):
                got = sorted(node) if isinstance(node, Mapping) else node
                raise ValueError(f"lm_params_from_reference: {where} has "
                                 f"keys {got}, expected {sorted(lay)}")
            return {k: convert(node[k], lay[k], path + (k,)) for k in lay}
        arr = np.asarray(node)
        if arr.shape != tuple(lay[0]):
            raise ValueError(f"lm_params_from_reference: {where} has shape "
                             f"{arr.shape}, expected {tuple(lay[0])}")
        return torch.tensor(arr, dtype=dtype, device=dev)

    return convert(tree, layout, ())
