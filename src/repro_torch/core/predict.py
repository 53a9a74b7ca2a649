"""Public prediction API: the paper's use-case surface.

``predict_cell(arch, shape, mesh)`` reads a dry-run record (the compiled
cell's FLOPs, bytes and collectives) and returns SimXLA's analytic
step-time prediction; ``predict_cell_des`` runs the full DES with
contention / stragglers.  Chip and ICI parameters default to the
``tpu-v5e-pod`` registry spec and can be re-derived from any other
platform via ``platform=``.  ``whatif`` re-predicts under hardware deltas
(faster links, more HBM bandwidth, more peak FLOP/s) — §V of the paper,
TPU edition.  These four are host Python and take no ``device``.
``whatif_grid`` is the sweep-scale edition: a cartesian grid of hardware
deltas evaluated as one batched fastsim sweep on ``device``, for an
``HPLConfig`` (legacy form) or for any registered workload's fast model
(``whatif_grid(workload, platform, axes)``).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import get_config
from .hardware.node import NodeModel
from .simxla import ICIParams, SimXLA, StepPrediction, ici_from_platform
from .apps.transformer import StepWorkload, TransformerStepSim

DRYRUN_DIR = Path("experiments/dryrun")


def _resolve_platform(platform):
    if isinstance(platform, str):
        from repro_torch.platforms import get_platform
        return get_platform(platform)
    return platform


def load_record(arch: str, shape: str, mesh: str = "16x16",
                dryrun_dir: Path = DRYRUN_DIR) -> Dict:
    p = Path(dryrun_dir) / f"{arch}__{shape}__{mesh}.json"
    if not p.exists():
        raise FileNotFoundError(
            f"dry-run record {p} missing — write it with "
            f"`python -m repro_torch.launch.dryrun --arch {arch} --shape "
            f"{shape}`")
    return json.loads(p.read_text())


def predict_cell(arch: str, shape: str, mesh: str = "16x16",
                 chip: Optional[NodeModel] = None,
                 ici: Optional[ICIParams] = None,
                 overlap: float = 0.7,
                 dryrun_dir: Path = DRYRUN_DIR,
                 platform="tpu-v5e-pod") -> StepPrediction:
    """Analytic step-time prediction for one compiled cell.  Hardware
    numbers come from ``platform`` (registry name or Platform spec);
    explicit ``chip``/``ici`` win over the spec-derived values."""
    rec = load_record(arch, shape, mesh, dryrun_dir)
    plat = _resolve_platform(platform)
    if chip is None:
        chip = plat.node_model()
    if ici is None:
        ici = ici_from_platform(plat)
    return SimXLA(chip=chip, ici=ici, overlap=overlap).predict(rec)


def predict_cell_des(arch: str, shape: str, mesh: str = "16x16",
                     straggler=None, jitter: float = 0.0,
                     dryrun_dir: Path = DRYRUN_DIR,
                     platform="tpu-v5e-pod", faults=None) -> Dict:
    rec = load_record(arch, shape, mesh, dryrun_dir)
    cfg = get_config(arch)
    plat = _resolve_platform(platform)
    wl = StepWorkload.from_dryrun_record(rec, cfg.num_layers,
                                         chip=plat.node_model())
    pods = 2 if mesh == "2x16x16" else 1
    sim = TransformerStepSim(wl, mesh=(16, 16), pods=pods,
                             chip=plat.node_model(),
                             ici=ici_from_platform(plat),
                             mpi_overhead=plat.mpi.overhead,
                             straggler=straggler, jitter=jitter,
                             faults=faults)
    return sim.run()


def whatif(arch: str, shape: str, mesh: str = "16x16", *,
           link_bw_scale: float = 1.0, hbm_bw_scale: float = 1.0,
           peak_scale: float = 1.0,
           dryrun_dir: Path = DRYRUN_DIR,
           platform="tpu-v5e-pod") -> Dict:
    """Paper §V for the TPU case study: predict the win from a hardware
    change without re-running anything on hardware."""
    plat = _resolve_platform(platform)
    base_chip = plat.node_model()
    base_ici = ici_from_platform(plat)
    base = predict_cell(arch, shape, mesh, chip=base_chip, ici=base_ici,
                        dryrun_dir=dryrun_dir)
    chip = dataclasses.replace(base_chip,
                               peak_flops=base_chip.peak_flops * peak_scale,
                               mem_bw=base_chip.mem_bw * hbm_bw_scale)
    ici = dataclasses.replace(base_ici,
                              link_bw=base_ici.link_bw * link_bw_scale)
    new = predict_cell(arch, shape, mesh, chip=chip, ici=ici,
                       dryrun_dir=dryrun_dir)
    return {"baseline_s": base.step_s, "whatif_s": new.step_s,
            "speedup": base.step_s / max(new.step_s, 1e-12),
            "baseline": base, "whatif": new}


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
