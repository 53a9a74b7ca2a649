"""Carry specs and parameters from the reference package into the port.

Both functions take plain data (JSON text, floats and numpy arrays), so
the reference can produce them in another process; nothing here imports
the reference.
"""
from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.fastsim import _PARAM_FIELDS, FastSimParams
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
