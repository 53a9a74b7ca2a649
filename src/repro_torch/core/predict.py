"""Public prediction API: the paper's §V what-if surface at sweep scale.

``whatif_grid`` evaluates a cartesian grid of hardware deltas as one
batched fastsim sweep, for an ``HPLConfig`` (legacy form) or for any
registered workload's fast model (``whatif_grid(workload, platform,
axes)``).  The dry-run-record predictions (``predict_cell``,
``predict_cell_des``, ``whatif``, ``load_record``) read XLA compile
records and wait for slice 8c of the port (ROADMAP §1).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Sequence

from repro_torch._device import DeviceLike, resolve_device


def _resolve_platform(platform):
    if isinstance(platform, str):
        from repro_torch.platforms import get_platform
        return get_platform(platform)
    return platform


def whatif_grid(scenario, base_params=None, axes: Mapping[str, Sequence[float]]
                = None, *, mode: str = "scale",
                device: DeviceLike = "cuda") -> list:
    """Paper §V at sweep scale: evaluate a cartesian grid of hardware
    what-ifs as one batched fastsim sweep on ``device``.

    Two forms:

    * legacy HPL: ``whatif_grid(cfg, base_params, axes)`` with an
      ``HPLConfig`` and a ``FastSimParams`` baseline;
    * workload-generic: ``whatif_grid(workload, platform, axes)`` with
      any ``repro_torch.workloads.Workload`` (the baseline params come
      from ``workload.fastsim_model(platform)``), or directly
      ``whatif_grid(model, None, axes)`` with a prebuilt ``FastModel``.

    ``axes`` maps params field names to multipliers (``mode="scale"``,
    default) or absolute values (``mode="abs"``), e.g.
    ``{"link_bw": [1, 2, 4], "mem_bw": [1.0, 1.25]}`` — 6 scenarios plus
    the baseline, all in one batch (bucketed sweep engine).

    Returns one dict per grid point, in ``itertools.product`` order, with
    the axis values, the model's result fields (``time_s`` always), and
    ``speedup`` over the unmodified baseline.
    """
    if mode not in ("scale", "abs"):
        raise ValueError(f"whatif_grid: mode must be scale|abs, got {mode}")
    dev = resolve_device(device)
    if hasattr(scenario, "fastsim_model"):          # a Workload
        if base_params is None:
            raise ValueError("whatif_grid(workload, platform, axes): the "
                             "second argument must be the platform")
        model = scenario.fastsim_model(_resolve_platform(base_params))
    elif hasattr(scenario, "sweep"):                # a prebuilt FastModel
        model = scenario
        if base_params is not None:
            model = dataclasses.replace(model, params=base_params)
    else:                                           # legacy HPLConfig form
        from repro_torch.workloads.hpl import HPLFastModel
        model = HPLFastModel(cfg=scenario, params=base_params)

    base = model.params
    names = list(axes)
    combos = list(itertools.product(*[axes[n] for n in names]))
    grid = []
    for combo in combos:
        over = {n: (getattr(base, n) * v if mode == "scale" else v)
                for n, v in zip(names, combo)}
        grid.append(dataclasses.replace(base, **over))
    res = model.sweep([base] + grid, device=dev)   # lane 0 = baseline
    base_t = res[0]["time_s"]
    out = []
    for combo, r in zip(combos, res[1:]):
        row = dict(zip(names, combo))
        row.update(r)
        row["speedup"] = base_t / r["time_s"]
        out.append(row)
    return out
