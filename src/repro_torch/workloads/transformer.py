"""Transformer training as a registered workload over any Platform.

Until this layer existed the transformer DES app carried its own chip
and ICI constants (``TPU_V5E``, ``ICI``); now both backends are derived
from one ``Platform`` spec, exactly like HPL:

  * ``des_app(platform)``  — the per-rank DES
    (``core.apps.transformer.TransformerStepSim``) built via
    ``from_platform``: chip, ICI, MPI overhead, and the default mesh all
    come from the spec;
  * ``fastsim_model(platform)`` — batched ``stepsim.StepParams`` whose
    closed forms mirror the DES schedule, so model-size x mesh x
    platform what-if grids run as one batch on the device (sweep-engine
    contract).

Both backends consume the SAME derived quantities — per-layer compute
seconds and ring wire bytes — computed once in ``_derive`` from the
model dims (Megatron-style tensor parallelism on the mesh's column axis,
data parallelism on rows, gradient ring across pods).  The backends
differ only in how they model the network, which is what DES-vs-stepsim
cross-validation (tests/test_workloads.py) pins down.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch._device import DeviceLike
from repro_torch.core.apps.transformer import (LayerWork, StepWorkload,
                                               TransformerStepSim)

from .base import FastModel, Workload, WorkloadSpec, register_workload
from .stepsim import StepParams

# rendezvous per-message cost in the DES: MPI overhead + RDV handshake
# (2 half-RTTs) + wire base latency + one neighbor hop
_RDV_HALF_RTTS = 3.0

DEFAULTS = dict(
    num_layers=4, d_model=512, d_ff=2048, vocab=32768,
    seq_len=512, batch_per_replica=8,
    dtype_bytes=2, grad_bytes=4,       # bf16 activations, fp32 grads
    overlap=0.0,                       # 0 = the DES's serial schedule
)


def _ring_wire(nbytes: float, n: int) -> float:
    """Ring all-reduce wire bytes through one device (DES convention)."""
    return 2.0 * (n - 1) / n * nbytes if n > 1 else 0.0


@dataclasses.dataclass
class StepFastModel(FastModel):
    """Batched analytic step model; ``params`` variants (hardware or
    model-shape deltas alike) sweep as one batch."""
    params: StepParams
    tokens_per_step: float = 0.0       # global tokens per optimizer step

    @classmethod
    def sweep_models(cls, models: Sequence["StepFastModel"], *,
                     device: DeviceLike = "cuda") -> List[dict]:
        from .stepsim import sweep_step
        res = sweep_step([m.params for m in models], device=device)
        for m, r in zip(models, res):
            if m.tokens_per_step:
                r["tokens_per_s"] = m.tokens_per_step / r["time_s"]
        return res


@register_workload
class TransformerWorkload(Workload):
    kind = "transformer"

    @classmethod
    def default_spec(cls) -> WorkloadSpec:
        return WorkloadSpec.make(cls.kind, **DEFAULTS)

    # ------------------------------------------------------- geometry
    def geometry(self, platform) -> Tuple[Tuple[int, int], int]:
        """(rows, cols) mesh and pod count on ``platform``; the spec's
        ``mesh``/``pods`` params override the fabric-derived defaults
        (a k-D torus collapses to ``(prod(dims[:-1]), dims[-1])``)."""
        fab = platform.fabric
        if fab.kind not in ("torus", "multipod"):
            raise ValueError(
                f"transformer workload needs a torus or multipod fabric; "
                f"platform {platform.name!r} is {fab.kind!r}")
        p = self.spec.params_dict
        mesh = p.get("mesh")
        if mesh is None:
            mesh = (math.prod(fab.dims[:-1]), fab.dims[-1])
        if len(mesh) != 2:
            raise ValueError(f"mesh must be (rows, cols), got {mesh!r}")
        mesh = (int(mesh[0]), int(mesh[1]))
        pods = p.get("pods")
        if pods is None:
            pods = fab.n_pods if fab.kind == "multipod" else 1
        pods = int(pods)
        if mesh[0] < 1 or mesh[1] < 1 or pods < 1:
            raise ValueError(f"bad mesh {mesh} x {pods} pods")
        if pods > 1 and fab.kind != "multipod":
            raise ValueError(f"platform {platform.name!r} has one pod; "
                             f"spec asks for {pods}")
        return mesh, pods

    def validate(self, platform) -> None:
        mesh, pods = self.geometry(platform)
        need = mesh[0] * mesh[1] * pods
        have = platform.scale.n_ranks
        if need > have:
            raise ValueError(
                f"transformer workload needs {need} chips "
                f"({mesh[0]}x{mesh[1]} x {pods} pods) but platform "
                f"{platform.name!r} has {have}")
        if self.spec.get("num_layers", 1) < 1:
            raise ValueError("num_layers must be >= 1")

    def des_ranks(self, platform) -> int:
        mesh, pods = self.geometry(platform)
        return mesh[0] * mesh[1] * pods

    # ------------------------------------------------ shared derivation
    def _derive(self, platform) -> Dict:
        """The one place model dims meet the platform spec: everything
        both backends consume (compute seconds, wire bytes, effective
        bandwidths) is computed here so they can never diverge."""
        p = self.spec.params_dict
        (rows, cols), pods = self.geometry(platform)
        m, d = cols, rows                    # model / data group sizes
        node, fab, scale = platform.node, platform.fabric, platform.scale
        rpn = max(scale.ranks_per_node, 1)
        peak = node.peak_flops / rpn
        mem_bw = node.mem_bw / rpn

        L = int(p["num_layers"])
        D, F, V = float(p["d_model"]), float(p["d_ff"]), float(p["vocab"])
        S, B = float(p["seq_len"]), float(p["batch_per_replica"])
        dt, gb = float(p["dtype_bytes"]), float(p["grad_bytes"])
        t = S * B                            # tokens per replica per step

        p_layer = 4.0 * D * D + 2.0 * D * F  # weights per layer (floats)
        # fwd+bwd GEMM flops (6 per weight per token) + attention scores
        flops_chip = (6.0 * t * p_layer + 12.0 * B * S * S * D) / m
        act_bytes = t * D * dt               # one boundary activation
        # 3 weight passes (fwd, bwd, grad write) + activation traffic:
        # ~4 full-D boundary tensors and ~8 tensor-sharded internals
        bytes_chip = 3.0 * p_layer * dt / m + (4.0 + 8.0 / m) * act_bytes
        compute_s = max(flops_chip / (peak * node.gemm_efficiency),
                        bytes_chip / (mem_bw * node.mem_efficiency))

        # Megatron TP: 2 fwd + 2 bwd activation all-reduces per layer on
        # the model axis, folded into one ring per layer (DES and stepsim
        # both see one wire total, so round counts match)
        coll_model = 4.0 * _ring_wire(act_bytes, m)
        grads_chip = (L * p_layer + 2.0 * D * V) * gb / m
        coll_data = _ring_wire(grads_chip, d)

        phase_lat = (platform.mpi.overhead
                     + _RDV_HALF_RTTS * fab.base_latency + fab.hop_latency)
        n_pp = rows * cols
        # cross-pod ring: flows share the DCN (per-node bandwidth) and
        # funnel through the pod gateway, where dimension-order routing
        # concentrates ~half the pod's flows on one ingress ICI link
        pod_bw = min(fab.dcn_bw_per_node,
                     2.0 * fab.link_bw / max(n_pp, 2))
        pod_lat = (platform.mpi.overhead + _RDV_HALF_RTTS * fab.base_latency
                   + (rows + cols) / 2.0 * fab.hop_latency
                   + 2.0 * fab.dcn_latency)

        params = StepParams(
            peak_flops=peak, gemm_eff=node.gemm_efficiency,
            mem_bw=mem_bw, mem_eff=node.mem_efficiency,
            link_bw=fab.link_bw, phase_latency=phase_lat,
            pod_bw=pod_bw, pod_latency=pod_lat,
            flops_per_layer=flops_chip, bytes_per_layer=bytes_chip,
            coll_model_bytes=coll_model, coll_data_bytes=coll_data,
            n_layers=float(L), model_group=float(m), data_group=float(d),
            pod_group=float(pods), overlap=float(p.get("overlap", 0.0)))
        return dict(mesh=(rows, cols), pods=pods, compute_s=compute_s,
                    coll_model=coll_model, coll_data=coll_data,
                    params=params, n_layers=L,
                    tokens_per_step=t * d * pods)

    # ------------------------------------------------------- backends
    def step_workload(self, platform) -> StepWorkload:
        """The DES per-rank schedule derived from the spec pair."""
        d = self._derive(platform)
        layers = [LayerWork(d["compute_s"],
                            [("all-reduce", d["coll_model"], "model")]
                            if d["coll_model"] > 0 else [])
                  for _ in range(d["n_layers"])]
        tail = [("all-reduce", d["coll_data"], "data")] \
            if d["coll_data"] > 0 else []
        return StepWorkload(layers=layers, tail_collectives=tail)

    def des_app(self, platform, *, trace: bool = False, faults=None,
                regions=None, device: DeviceLike = "cuda", **kw):
        """The DES on the host; a transformer region replicates the
        steady-state layer delta on the host, with no closed form to
        run, so ``device`` is accepted and unused."""
        self.validate(platform)
        d = self._derive(platform)

        def build(workload, layer_marks=None):
            return TransformerStepSim.from_platform(
                workload, platform, mesh=d["mesh"], pods=d["pods"],
                trace=trace, faults=faults, layer_marks=layer_marks, **kw)

        if regions is None:
            return build(self.step_workload(platform))
        # representative region: the first `regions` layers run on the
        # exact DES (with the full-L tail collectives — their wire bytes
        # scale with the total layer count); the rest replicate the
        # steady-state per-layer delta
        from repro_torch.scale import RegionStepSim
        return RegionStepSim(self.step_workload(platform), regions, build)

    def fastsim_model(self, platform, *, faults=None) -> StepFastModel:
        self.validate(platform)
        d = self._derive(platform)
        params = d["params"]
        if faults is not None:
            from repro_torch.faults.fastsim import apply_faults
            params = apply_faults(params, faults)
        return StepFastModel(params=params,
                             tokens_per_step=d["tokens_per_step"])

    def predict_des(self, platform, *, trace: bool = False,
                    faults=None, regions=None) -> dict:
        app = self.des_app(platform, trace=trace, faults=faults,
                           regions=regions)
        res = app.run()
        d = self._derive(platform)
        out = {"time_s": res["step_s"], "step_s": res["step_s"],
               "events": res["events"],
               "tokens_per_s": d["tokens_per_step"] / res["step_s"]}
        if res.get("failed"):
            out["failed"] = True
            out["n_finished"] = res["n_finished"]
        if res.get("region_approx"):
            out["region_approx"] = True
            out["layers_simulated"] = res["layers_simulated"]
        if trace and app.trace.enabled:
            out["breakdown"] = app.trace.summary()
            if res.get("region_approx"):
                out["breakdown"]["region_approx"] = True
        return out
