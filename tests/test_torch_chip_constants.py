"""The reference values ``chip_smoke.py`` holds the port to on the card
are the JAX reference's own.

The card's machine has no jax, so ``chip_smoke.py`` carries the
reference's answers as ``REFERENCE_*`` constants.  This test reads them
(and the inputs they were computed from) out of the script with ``ast``,
without importing it, recomputes every one with the reference package in
a child interpreter (``torch_reference.run_reference``), and requires
them equal: DES events and panel marks exactly, times and fitted values
within 1e-13 relative (ten times tighter than the card's gates, so the
check does not hang on the last bit of a host's float64 rounding).
Covered: the transformer step times, the 18-scenario step sweep and the
step-time gradient; the HPL and transformer fault sweeps on tpu-v5e-pod;
the region run of Frontera's 16 x 16 DES; the per-scale contention fit;
the TOP500 fleet at the library's default tuning; and slice 7's serving
wave (times, ``stats`` and ``request_key`` digests through the
reference's ``PredictionService``), its acceptance campaign and its
two-edition TOP500 study (each ``campaign_run`` record apart from its
result floats as a sha256 digest, the floats one by one, the drift
table; the digest is the script's own ``result_floats``).  The MoE and
VLM phases' configurations and flash shapes are held to the reference's
configs in this process (``repro.configs`` imports without jax's x64
alias), and so are the head_dim-80 phases' shapes and launch counts
(stablelm-3b, zamba2-2.7b), with their kernels' bounds counted again here
another way.
"""
import ast
import importlib.util
import os

import pytest

from torch_reference import ROOT, run_reference

RTOL = 1e-13

CHILD = r"""
import dataclasses
import jax
from jax.experimental import enable_x64
from repro.core.apps.hpl import HPLConfig
from repro.faults import as_fault_spec
from repro.faults.fastsim import sweep_faults
from repro.platforms import get_platform
from repro.scale import RegionHPLSim, RegionSpec, fit_contention_at_scale
from repro.top500 import load_sample, predict_fleet
from repro.workloads import get_workload, step_time_traced

C = PAYLOAD
OUT["REFERENCE_STEP_S"] = {
    name: get_workload("transformer").predict(get_platform(name))["step_s"]
    for name in C["STEP_PLATFORMS"]}
pod = get_platform("tpu-v5e-pod")
model = get_workload("transformer").fastsim_model(pod)
base = model.params
grid = [dataclasses.replace(base, link_bw=base.link_bw * (1 + 0.1 * i),
                            n_layers=float(2 + i),
                            flops_per_layer=base.flops_per_layer
                            * (1 + 0.05 * i))
        for i in range(C["STEP_GRID_LANES"])]
OUT["REFERENCE_STEP_GRID_S"] = [r["step_s"] for r in model.sweep(grid)]
with enable_x64(True):
    val, grad = jax.value_and_grad(lambda lb: step_time_traced(
        dataclasses.replace(base, link_bw=lb)))(base.link_bw)
OUT["REFERENCE_STEP_GRAD"] = {"step_s": float(val),
                              "d_link_bw": float(grad)}
specs = [as_fault_spec(d) for d in C["FAULT_SPECS"]]
OUT["REFERENCE_FAULT_SWEEP"] = {
    kind: {key: [r[key] for r in sweep_faults(get_workload(kind), pod,
                                              specs)]
           for key in ("time_s", "slowdown_vs_healthy")}
    for kind in ("hpl", "transformer")}
frontera = get_platform("frontera")
sim = RegionHPLSim(HPLConfig(**C["DES_CFG"]), frontera, region=C["REGION"])
res = sim.run()
OUT["REFERENCE_REGION"] = {"time_s": res.time_s, "events": res.events,
                           "marks": [sim._marks[k] for k in sorted(sim._marks)]}
fit = C["CONTENTION_FIT"]
sf = fit_contention_at_scale(
    frontera, fit["at_ranks"],
    region=RegionSpec(panels=fit["panels"], warmup=fit["warmup"]),
    probe_configs=[HPLConfig(bcast=frontera.mpi.bcast, **fit["probe"])],
    steps=fit["steps"])
OUT["REFERENCE_CONTENTION"] = {
    "overrides": sf.overrides,
    "note": dict(sf.platform.provenance)[f"contention@{fit['at_ranks']}"]}
rep = predict_fleet(load_sample())
OUT["REFERENCE_FLEET"] = {
    "bucket": list(rep.bucket), "compiles": rep.compiles,
    "factors": dict(sorted(rep.calibration.factors.items())),
    "median_abs_err": rep.median_abs_err(),
    "heldout_median_abs_err": rep.calibration.heldout_median_abs_err,
    "machines": [[e.platform.name, e.split, e.predicted_tflops,
                  e.calibrated_tflops] for e in rep.entries]}
"""

SERVE_CHILD = r"""
from repro.campaign import (CampaignSpec, campaign_report,
                            edition_study_spec, run_campaign)
from repro.faults import FaultSpec
from repro.serve import PredictionService, WorkloadRequest
from repro.top500 import FleetTuning

C = PAYLOAD


def mk(d):
    f = d.get("faults")
    return WorkloadRequest(
        rid=d["rid"], workload=d.get("workload", "hpl"),
        platform=d["platform"],
        faults=None if f is None else FaultSpec.from_dict(f),
        breakdown=d.get("breakdown", False))


svc = PredictionService(cache=True)
out = svc.predict_batch([mk(d) for d in C["SERVE_WAVE"]])
stats = dict(svc.stats)
svc.predict_batch([mk(d) for d in C["SERVE_WAVE"]])
cached = dict(svc.stats)
same = PredictionService(cache=True)
same.predict_batch([mk(dict(C["SERVE_WAVE"][0], rid=i)) for i in range(8)])
keys = {}
for rid in C["SERVE_KEY_RIDS"]:
    req = mk(C["SERVE_WAVE"][rid])
    svc._resolve(req)
    keys[str(rid)] = svc._cache_key(req)
OUT["REFERENCE_SERVE"] = {
    "time_s": [out[d["rid"]]["time_s"] for d in C["SERVE_WAVE"]],
    "stats": stats, "cached_stats": cached,
    "coalesced_stats": dict(same.stats), "keys": keys}
res = run_campaign(CampaignSpec.make("accept", **C["CAMPAIGN_ACCEPT"]))
OUT["campaign_runs"] = res.run_records
OUT["campaign_dispatches"] = res.summary["meta"]["dispatches"]
es = C["EDITION_STUDY"]
res = run_campaign(edition_study_spec(es["editions"], limit=es["limit"]),
                   tuning=FleetTuning(max_ranks=es["max_ranks"],
                                      panels_cap=es["panels_cap"]))
OUT["study_runs"] = res.run_records
OUT["study_drift"] = campaign_report(res.records)["drift"]
"""

INPUTS = ("STEP_PLATFORMS", "STEP_GRID_LANES", "FAULT_SPECS", "DES_CFG",
          "REGION", "CONTENTION_FIT")
CONSTANTS = ("REFERENCE_STEP_S", "REFERENCE_STEP_GRID_S",
             "REFERENCE_STEP_GRAD", "REFERENCE_FAULT_SWEEP",
             "REFERENCE_REGION", "REFERENCE_CONTENTION", "REFERENCE_FLEET")
SERVE_INPUTS = ("SERVE_WAVE", "SERVE_KEY_RIDS", "CAMPAIGN_ACCEPT",
                "EDITION_STUDY")
SERVE_CONSTANTS = ("REFERENCE_SERVE", "REFERENCE_CAMPAIGN",
                   "REFERENCE_EDITION_STUDY")


def _literal(node):
    """A literal, or ``dict(k=literal, ...)``."""
    if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "dict":
        return {kw.arg: _literal(kw.value) for kw in node.keywords}
    return ast.literal_eval(node)


def _script_values(names) -> dict:
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in names:
            out[node.targets[0].id] = _literal(node.value)
    return out


def _result_floats(records):
    """``chip_smoke.result_floats``, loaded from the script's file (the
    script only defines names when imported)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script.result_floats(records)


@pytest.fixture(scope="module")
def values():
    script = _script_values(INPUTS + CONSTANTS)
    assert set(script) == set(INPUTS + CONSTANTS), set(script)
    ref = run_reference(CHILD, {k: script[k] for k in INPUTS}, timeout=900)
    return script, ref


@pytest.fixture(scope="module")
def serve_values():
    """Slice 7's constants, and the reference's answers in their form."""
    script = _script_values(SERVE_INPUTS + SERVE_CONSTANTS)
    assert set(script) == set(SERVE_INPUTS + SERVE_CONSTANTS), set(script)
    out = run_reference(SERVE_CHILD, {k: script[k] for k in SERVE_INPUTS},
                        timeout=900)
    gates = ("fastsim_dispatches", "stepsim_dispatches", "serve_sweeps")
    digest, floats = _result_floats(out["campaign_runs"])
    ref = {"REFERENCE_SERVE": out["REFERENCE_SERVE"],
           "REFERENCE_CAMPAIGN": {
               "skeleton_sha256": digest, "floats": floats,
               "dispatches": {k: out["campaign_dispatches"][k]
                              for k in gates}}}
    digest, floats = _result_floats(out["study_runs"])
    drift = out["study_drift"]
    ref["REFERENCE_EDITION_STUDY"] = {
        "skeleton_sha256": digest, "floats": floats,
        "machines": {d["machine"]: [d["predicted_drift"],
                                    d["published_drift"]]
                     for d in drift["machines"]},
        "factors": {f["family"]: [f[f"factor_{drift['from']}"],
                                  f[f"factor_{drift['to']}"]]
                    for f in drift["calibration_factors"]}}
    return script, ref


def _same(got, want, path=""):
    """Equal structure; ints, strings and DES marks exactly, other floats
    within RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and ".marks" not in path:
        assert got == pytest.approx(want, rel=RTOL, abs=0), path
    else:
        assert got == want, path


@pytest.mark.parametrize("name", CONSTANTS)
def test_reference_constant_matches_the_reference(values, name):
    script, ref = values
    _same(script[name], ref[name], name)


@pytest.mark.parametrize("name", SERVE_CONSTANTS)
def test_slice7_constant_matches_the_reference(serve_values, name):
    script, ref = serve_values
    _same(script[name], ref[name], name)


def test_serve_wave_covers_both_families_a_fault_and_a_breakdown(
        serve_values):
    script, _ = serve_values
    wave = script["SERVE_WAVE"]
    assert {d.get("workload", "hpl") for d in wave} == {"hpl",
                                                       "transformer"}
    assert any(d.get("faults") for d in wave)
    assert any(d.get("breakdown") for d in wave)
    assert script["REFERENCE_SERVE"]["stats"]["sweeps"] == 2
    assert script["REFERENCE_SERVE"]["coalesced_stats"]["coalesced"] == 7


def test_fleet_constant_covers_the_whole_sample(values):
    script, _ = values
    fleet = script["REFERENCE_FLEET"]
    assert len(fleet["machines"]) == 51 and fleet["compiles"] == 1
    assert fleet["heldout_median_abs_err"] <= 0.15
    assert {split for _, split, _, _ in fleet["machines"]} \
        == {"train", "test"}


def test_fault_specs_cover_every_closed_form_kind(values):
    script, _ = values
    kinds = [{f["kind"] for f in s["faults"]} for s in script["FAULT_SPECS"]]
    assert {"straggler", "link_degrade", "link_flap",
            "latency_jitter"} <= set().union(*kinds)
    assert any(len(k) > 1 for k in kinds)            # a combined spec


def _script():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


@pytest.mark.parametrize("which", ["moe", "vlm"])
def test_moe_and_vlm_flash_shapes_are_the_reference_configs(which):
    """Each phase's flash shape (B, S, G, R, hd) is its model's prefill
    under the reference's config: phi3.5-moe's B x S tokens, llava's
    image tokens plus the prompt; hd is one the kernel builds."""
    from repro.configs import get_config as jget
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    script = _script()
    arch = {"moe": script.MOE_ARCH, "vlm": script.VLM_ARCH}[which]
    cfg = jget(arch)
    assert cfg.family == which
    heads = (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
             cfg.resolved_head_dim)
    if which == "moe":
        want = (script.MOE_B, script.MOE_S) + heads
        assert script.FLASH_MOE == want
    else:
        want = (1, cfg.n_image_tokens + script.VLM_PROMPT) + heads
        assert script.FLASH_VLM == want
        assert want[1] % 128 != 0         # ragged at the hd-128 tile
    assert cfg.resolved_head_dim in HEAD_DIMS
    assert want in script.FLASH_SHAPES


def test_moe_depth_cut_is_what_one_card_holds():
    """phi3.5-moe whole does not fit one 80 GB card even in bf16; the cut
    to ``MOE_LAYERS`` layers does in float32 weights (the seeded
    parameters' dtype), with room for the comparison beside them."""
    import dataclasses
    from repro.configs import get_config as jget
    script = _script()
    cfg = jget(script.MOE_ARCH)
    assert 0 < script.MOE_LAYERS < cfg.num_layers
    assert cfg.n_params() * 2 > 80e9
    cut = dataclasses.replace(cfg, num_layers=script.MOE_LAYERS)
    assert cut.n_params() * 4 < 0.6 * 80e9
    for spec in (script.MOE_SERVE, script.VLM_SERVE):
        n, prompt, new, slots = spec
        assert n % slots == 0 and prompt == 128 and new == 16


def test_head_dim_80_shapes_are_the_reference_configs():
    """The head_dim-80 phases' shapes follow the reference's configs:
    zamba2's loss (its shared block's 32 heads, one a KV group) and its
    scan (80 heads of 64, N 64, chunk 256), stablelm-3b's served prompt,
    and a ragged shape (Sq, Sk unequal, neither a multiple of the 128-key
    tile)."""
    from repro.configs import get_config as jget
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    script = _script()
    z, st = jget(script.HYBRID_ARCH), jget(script.STABLELM_ARCH)
    assert (z.family, st.family) == ("hybrid", "dense")
    assert script.FLASH_HYBRID == (
        script.HYBRID_B, script.HYBRID_S, z.n_kv_heads,
        z.n_heads // z.n_kv_heads, z.resolved_head_dim) == (4, 2048, 32, 1,
                                                            80)
    assert script.FLASH_STABLELM == (
        1, script.SERVE_PROMPT, st.n_kv_heads, st.n_heads // st.n_kv_heads,
        st.resolved_head_dim) == (1, 128, 32, 1, 80)
    assert script.SSD_HYBRID == (
        script.HYBRID_B, script.HYBRID_S, z.ssm.n_heads(z.d_model),
        z.ssm.head_dim, z.ssm.d_state, z.ssm.chunk_size) == (4, 2048, 80, 64,
                                                             64, 256)
    (b, sq, g, r, hd), sk = script.FLASH_RAGGED_80
    assert hd == 80 and sq != sk and sq % 128 and sk % 128
    assert 80 in HEAD_DIMS


def test_new_launch_counts_follow_the_configs():
    """zamba2's loss: the scan once an ssm layer, flash once a group of
    ``hybrid_period``; stablelm-3b's serve run: flash once a layer a
    prefill, one prefill a request."""
    from repro.configs import get_config as jget
    script = _script()
    z, st = jget(script.HYBRID_ARCH), jget(script.STABLELM_ARCH)
    assert script.HYBRID_LOSS_LAUNCHES == {
        "ssd_scan": z.num_layers,
        "flash_attention_fwd": z.num_layers // z.hybrid_period} == {
        "ssd_scan": 54, "flash_attention_fwd": 9}
    assert z.num_layers % z.hybrid_period == 0
    n = script.SERVE_SPEC[0]
    assert script.STABLELM_SERVE_LAUNCHES == st.num_layers * n == 256


@pytest.mark.parametrize("which", ["zamba2 flash", "stablelm flash",
                                   "zamba2 scan"])
def test_head_dim_80_and_n_64_bounds(which):
    """``flash_bound_ms`` and ``ssd_bound_ms`` at the new shapes against
    the same bounds counted here another way: causal attention as
    (S(S+1)/2 pairs) x (2 FLOPs a multiply-add) x (q.k and p.v) x hd per
    head; the scan per chunk of Q positions as C B^T over Q(Q+1)/2 pairs
    once per group, M x over those pairs and C h^T and x^T B over every
    position per head; bytes each input read once and the output written
    once.  The H100 SXM's data-sheet rates: 989e12 bf16 and 67e12 float32
    FLOP/s, 3.35e12 B/s."""
    import torch
    script = _script()
    bf16 = torch.bfloat16
    if which.endswith("flash"):
        shape = (script.FLASH_HYBRID if which.startswith("zamba2")
                 else script.FLASH_STABLELM)
        b, s, g, r, hd = shape
        flops = b * g * r * (s * (s + 1) // 2) * 2 * 2 * hd
        nbytes = 2 * (b * s * g * r * hd * 2 + b * s * g * hd * 2)
        want = max(flops / 989e12, nbytes / 3.35e12) * 1e3
        got, by = script.flash_bound_ms(shape, True, bf16)
        assert got == pytest.approx(want, rel=1e-12)
        if which.startswith("zamba2"):
            assert (by, flops) == ("operations", 85_941_288_960)
            assert got == pytest.approx(0.0869, abs=5e-5)
        else:
            assert by == "bytes"
        return
    b, s, h, p, n, chunk = script.SSD_HYBRID
    pairs = sum(m * (m + 1) // 2 for m in [chunk] * (s // chunk))
    cb = b * 1 * pairs * 2 * n
    rest = b * h * (pairs * 2 * p + s * 2 * (2 * n * p))
    nbytes = (2 * b * s * h * p + 2 * b * s * n) * 2 + 4 * (b * s * h + h)
    want = max(cb / 989e12 + rest / 67e12, nbytes / 3.35e12) * 1e3
    got, by, got_cb, got_rest, got_bytes = script.ssd_bound_ms(
        script.SSD_HYBRID, bf16, 1)
    assert (got_cb, got_rest, got_bytes) == (cb, rest, nbytes)
    assert got == pytest.approx(want, rel=1e-12)
    assert by == "operations" and rest == 21_516_779_520
    assert got == pytest.approx(0.321, abs=5e-4)
