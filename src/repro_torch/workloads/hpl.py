"""HPL as a registered workload — the paper's application.

The spec's params are the ``HPLConfig`` knobs; any of ``N``/``nb``/
``P``/``Q`` left unset (or 0) falls back to the platform's published run
geometry (``platform.hpl_config()``), so ``get_workload("hpl")`` with no
arguments predicts every registry machine's own Rmax run.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch._device import DeviceLike
from repro_torch.core.apps.hpl import HPLConfig, HPLSim

from .base import FastModel, Workload, register_workload

_CFG_KEYS = ("N", "nb", "P", "Q")


@dataclasses.dataclass
class HPLFastModel(FastModel):
    """The batched HPL recurrence bound to one run geometry: ``params``
    variants sweep as one batch (``fastsim.sweep_hpl``)."""
    cfg: HPLConfig
    params: object                     # FastSimParams

    @classmethod
    def sweep_models(cls, models: Sequence["HPLFastModel"], *,
                     device: DeviceLike = "cuda") -> List[dict]:
        """One batch per wave: scenarios sharing a shape bucket take
        ``sweep_hpl``'s grouped fast path; a wave that mixes buckets is
        forced into one shared bucket instead — the TOP500 fleet trick,
        so the family costs one dispatch either way."""
        from repro_torch.core.fastsim import bucket_key, sweep_hpl
        cfgs = [m.cfg for m in models]
        prms = [m.params for m in models]
        if len({bucket_key(c) for c in cfgs}) > 1:
            bucket = (max(c.n_panels for c in cfgs),
                      max(c.P for c in cfgs),
                      max(c.Q for c in cfgs))
            return sweep_hpl(cfgs, prms, bucket=bucket, device=device)
        return sweep_hpl(cfgs, prms, device=device)


@register_workload
class HPLWorkload(Workload):
    kind = "hpl"

    def config(self, platform) -> HPLConfig:
        """The scenario's ``HPLConfig`` on ``platform`` (spec overrides
        win over the platform's published run geometry)."""
        p = self.spec.params_dict
        kw = {k: int(p[k]) for k in _CFG_KEYS if p.get(k)}
        if p.get("bcast"):
            kw["bcast"] = p["bcast"]
        if "lookahead" in p:
            kw["lookahead"] = int(p["lookahead"])
        return platform.hpl_config(**kw)

    def validate(self, platform) -> None:
        cfg = self.config(platform)     # raises on missing defaults
        if cfg.n_ranks > platform.scale.n_ranks:
            raise ValueError(
                f"hpl workload needs {cfg.n_ranks} ranks but platform "
                f"{platform.name!r} has {platform.scale.n_ranks}")

    def des_app(self, platform, *, trace: bool = False,
                faults=None, regions=None, device: DeviceLike = "cuda"):
        """The DES on the host; with ``regions`` a representative-region
        run whose unsimulated tail is priced by fastsim on ``device``."""
        if regions is None:
            return HPLSim(self.config(platform), platform, trace=trace,
                          faults=faults)
        from repro_torch.scale import RegionHPLSim
        return RegionHPLSim(self.config(platform), platform,
                            region=regions, trace=trace, faults=faults,
                            device=device)

    def des_ranks(self, platform) -> int:
        return self.config(platform).n_ranks

    def fastsim_model(self, platform, *, faults=None) -> HPLFastModel:
        cfg = self.config(platform)
        params = platform.fastsim()
        if faults is not None:
            from repro_torch.faults.fastsim import apply_faults
            params = apply_faults(params, faults, grid=(cfg.P, cfg.Q))
        return HPLFastModel(cfg=cfg, params=params)

    def predict_des(self, platform, *, trace: bool = False,
                    faults=None, regions=None,
                    device: DeviceLike = "cuda") -> dict:
        """The full DES (pure Python on the host); ``device`` prices a
        region run's tail and is unused without ``regions``."""
        res = self.des_app(platform, trace=trace, faults=faults,
                           regions=regions, device=device).run()
        out = {"time_s": res.time_s, "gflops": res.gflops,
               "tflops": res.gflops / 1e3, "events": res.events}
        if res.failed:
            out["failed"] = True
            out["n_finished"] = res.n_finished
        if res.region_approx:
            out["region_approx"] = True
            out["panels_simulated"] = res.region_panels
        if trace and res.trace is not None:
            out["breakdown"] = res.trace.summary()
            if res.region_approx:
                out["breakdown"]["region_approx"] = True
        return out
