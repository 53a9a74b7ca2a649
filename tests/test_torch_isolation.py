"""The port stands alone: it imports neither jax nor the reference
package, its entry points never fall back to the CPU on their own, and
chip_smoke.py refuses to run without a card or without the repository."""
import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import fit_fastsim_params, whatif_grid
from repro_torch.core.apps.hpl import HPLConfig
from repro_torch.core.fastsim import (simulate_hpl_fast, simulate_time_traced,
                                      sweep_hpl)
from repro_torch.convert import (fastsim_params_from_numpy,
                                 lm_params_from_reference)
from repro_torch.models import build_model
from repro_torch.models.api import make_batch
from repro_torch.serve import (HPLPredictionService, PredictionService,
                               ServeEngine, predict_top500, warm)
from repro_torch.campaign import CampaignSpec, run_campaign
from repro_torch.faults import FaultSpec, sweep_faults
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.train import make_train_state, train
from repro_torch.ft import simulate_fault_impact
from repro_torch.platforms import (des_probe_runs, fit_fastsim_to_des,
                                   get_platform)
from repro_torch.scale import (RegionHPLSim, contention_drift,
                               fit_contention_at_scale)
from repro_torch.top500 import (calibrate_against_des, predict_fleet,
                                sample_list_path)
from repro_torch.workloads import (get_workload, simulate_step_fast,
                                   step_time_traced, sweep_step)
from torch_reference import load_chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any import of jax now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
assert {"repro_torch.launch", "repro_torch.launch.serve",
        "repro_torch.data", "repro_torch.data.pipeline",
        "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
        "repro_torch.train.state", "repro_torch.train.loop",
        "repro_torch.launch.train", "repro_torch.roofline",
        "repro_torch.roofline.analysis", "repro_torch.roofline.hlo_parse",
        "repro_torch.models.api", "repro_torch.launch.mesh",
        "repro_torch.sharding", "repro_torch.sharding.specs",
        "repro_torch.roofline.count", "repro_torch.sharding.collectives",
        "repro_torch.launch.dryrun"} <= set(names)
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not loaded, loaded
from repro_torch.kernels.maxmin_fair import masked_min_rows, waterfill
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_fwd)
import torch
adj = torch.ones((8, 16), dtype=torch.int8)
waterfill(adj, torch.ones(16))
assert masked_min_rows.launches == 0, masked_min_rows.launches
flash_attention(torch.ones(1, 4, 1, 2, 32), torch.ones(1, 4, 1, 32),
                torch.ones(1, 4, 1, 32))
assert flash_attention_fwd.launches == 0, flash_attention_fwd.launches
from repro_torch.kernels.ssd_scan import ssd, ssd_scan
ssd(torch.ones(1, 8, 2, 4), torch.ones(1, 8, 2), -torch.ones(2),
    torch.ones(1, 8, 2, 4), torch.ones(1, 8, 2, 4), 4)
assert ssd_scan.launches == 0, ssd_scan.launches
import json, os, tempfile
from repro_torch.core import load_record, predict_cell, predict_cell_des, \
    whatif
from repro_torch.core.predict import DRYRUN_DIR
from repro_torch.faults import FaultSpec
from repro_torch.ft import (ElasticPlan, StepTimeMonitor, elastic_restart_plan,
                            restart_plan_for_faults, simulate_fault_impact,
                            simulate_straggler_impact)
rec = {"arch": "x", "shape": "train_4k", "mesh": "16x16", "chips": 256,
       "kind": "train", "roofline": {"hlo_flops_total": 2.56e17,
                                     "hlo_bytes_total": 2.56e14},
       "collectives": {"all-reduce": {"count": 10, "wire_bytes": 1e9}}}
d = tempfile.mkdtemp()
with open(os.path.join(d, "x__train_4k__16x16.json"), "w") as f:
    json.dump(rec, f)
assert load_record("x", "train_4k", dryrun_dir=d) == rec
assert predict_cell("x", "train_4k", dryrun_dir=d).step_s > 0
assert whatif("x", "train_4k", dryrun_dir=d, link_bw_scale=2.0)["speedup"] > 1
assert StepTimeMonitor(warmup=1).record(0.1) is False
assert isinstance(restart_plan_for_faults(
    FaultSpec.fail_stop(rank=0), global_batch=12, resume_step=0,
    old_mesh=(4, 4)), ElasticPlan)
assert simulate_fault_impact("hpl", "bdw-local", FaultSpec.straggler(rank=0),
                             device="cpu")["blowup"] > 1
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.train import make_train_state
tokens = SyntheticLM(DataConfig(512, 16, 4)).global_batch_at(0)
assert tokens.shape == (4, 16)
state = make_train_state(reduced(get_config("qwen2-0.5b")),
                         torch.Generator().manual_seed(0), device="cpu")
save_checkpoint(d, 1, state)
ck = AsyncCheckpointer(d)
ck.save(2, state)
ck.wait()
assert latest_step(d) == 2
back = restore_checkpoint(d, 2, state, device="cpu")
assert torch.equal(back.params["embed"]["tok"], state.params["embed"]["tok"])
from repro_torch.train import train
res = train(reduced(get_config("qwen2-0.5b")), steps=2, global_batch=2,
            seq_len=8, ckpt_dir=tempfile.mkdtemp(), log_fn=lambda s: None,
            device="cpu")
assert len(res["losses"]) == 2 and int(res["state"].step) == 2
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api, build_model
from repro_torch.sharding import make_rules, sharded_bytes, tree_shardings
from repro_torch.train import state_specs
cfg = get_config("qwen2-0.5b")
state = api.abstract_state(cfg)
assert sharded_bytes(state, tree_shardings(
    state_specs(cfg, build_model(cfg, device="meta")),
    make_production_mesh(), make_rules(cfg, global_batch=256), state),
    make_production_mesh()) == 275615240
import torch.distributed as dist
from repro_torch.launch.dryrun import run_cell
rec = run_cell("mamba2-780m", "decode_32k", False, tempfile.mkdtemp())
assert rec["ok"] and not dist.is_initialized()
loaded = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not loaded, loaded
print(len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def test_every_module_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          text=True, env=_env(), cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_import_of_jax_or_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    for mod in _imports(tree):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
            (path, mod)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_chip_smoke_child_scripts_import_no_jax_or_reference():
    """The child scripts ``chip_smoke.py`` holds as strings import neither
    jax nor the reference, and no string there names a module of either.
    The one child that imports a module by a name it is given
    (``HOST_CALL``) refuses a name outside the port."""
    children, by_name = 0, []
    for node in ast.walk(ast.parse((ROOT / "chip_smoke.py").read_text())):
        if not (isinstance(node, ast.Constant) and isinstance(node.value,
                                                              str)):
            continue
        assert node.value.split(".")[0] not in ("jax", "jaxlib", "repro"), \
            node.value
        if "import " in node.value:
            try:
                tree = ast.parse(node.value)
            except SyntaxError:
                continue
            children += 1
            by_name += ["import_module" in node.value]
            for mod in _imports(tree):
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    mod
    assert children >= 3 and sum(by_name) == 1
    script = load_chip_smoke()
    proc = subprocess.run(
        [sys.executable, "-c", script.HOST_CALL,
         json.dumps(["repro.configs", "list_archs", [], {}])],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=60)
    assert proc.returncode != 0
    assert "not a module of the port: repro.configs" in proc.stderr


@pytest.mark.parametrize("path", [
    "src/repro_torch/launch/dryrun.py", "src/repro_torch/roofline/count.py",
    "src/repro_torch/sharding/collectives.py"])
def test_dry_run_modules_import_no_process_group(path):
    """The dry-run describes a mesh without one: its three modules import
    neither jax, the reference nor ``torch.distributed``."""
    tree = ast.parse((ROOT / path).read_text())
    mods = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
            for a in node.names]
    mods += [node.module for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) and node.level == 0]
    assert mods and not [m for m in mods if m.split(".")[0] in (
        "jax", "jaxlib", "repro") or m.startswith("torch.distributed")]


def _entry_points():
    plat = get_platform("bdw-local")
    cfg = plat.hpl_config()
    prm = plat.fastsim()
    model = get_workload("hpl").fastsim_model(plat)
    lm = reduced(get_config("qwen2-0.5b"))
    ssm = reduced(get_config("mamba2-780m"))
    moe = reduced(get_config("phi3.5-moe-42b-a6.6b"))
    vlm = reduced(get_config("llava-next-mistral-7b"))
    hybrid = reduced(get_config("zamba2-2.7b"))
    encdec = reduced(get_config("whisper-medium"))
    step = get_workload("transformer").fastsim_model(
        get_platform("tpu-v5e-pod")).params
    region_cfg = HPLConfig(N=2048, nb=128, P=2, Q=2, lookahead=0)
    return {
        "simulate_hpl_fast": lambda: simulate_hpl_fast(cfg, prm),
        "sweep_hpl": lambda: sweep_hpl(cfg, [prm, prm]),
        "simulate_time_traced": lambda: simulate_time_traced(cfg, prm),
        "Workload.predict": lambda: get_workload("hpl").predict(plat),
        "FastModel.predict": lambda: model.predict(),
        "FastModel.sweep": lambda: model.sweep([prm]),
        "fastsim_params_from_numpy": lambda: fastsim_params_from_numpy(
            {n: 1.0 for n in prm.__dataclass_fields__}),
        "build_model": lambda: build_model(lm),
        "ServeEngine": lambda: ServeEngine(lm, {}),
        "lm_params_from_reference": lambda: lm_params_from_reference(
            _lm_tree(lm), lm),
        "build_model_ssm": lambda: build_model(ssm),
        "ServeEngine_ssm": lambda: ServeEngine(ssm, {}),
        "lm_params_from_reference_ssm": lambda: lm_params_from_reference(
            _lm_tree(ssm), ssm),
        "build_model_moe": lambda: build_model(moe),
        "ServeEngine_moe": lambda: ServeEngine(moe, {}),
        "lm_params_from_reference_moe": lambda: lm_params_from_reference(
            _lm_tree(moe), moe),
        "build_model_vlm": lambda: build_model(vlm),
        "ServeEngine_vlm": lambda: ServeEngine(vlm, {}),
        "lm_params_from_reference_vlm": lambda: lm_params_from_reference(
            _lm_tree(vlm), vlm),
        "build_model_hybrid": lambda: build_model(hybrid),
        "ServeEngine_hybrid": lambda: ServeEngine(hybrid, {}),
        "lm_params_from_reference_hybrid": lambda: lm_params_from_reference(
            _lm_tree(hybrid), hybrid),
        "build_model_encdec": lambda: build_model(encdec),
        "ServeEngine_encdec": lambda: ServeEngine(encdec, {}),
        "lm_params_from_reference_encdec": lambda: lm_params_from_reference(
            _lm_tree(encdec), encdec),
        "fit_fastsim_params": lambda: fit_fastsim_params(
            [(cfg, 0.05)], prm, fields=("gemm_eff",), steps=1),
        "whatif_grid": lambda: whatif_grid(get_workload("hpl"), plat,
                                           {"link_bw": [1.0, 2.0]}),
        "fit_fastsim_to_des": lambda: fit_fastsim_to_des(plat, steps=1),
        "sweep_step": lambda: sweep_step([step]),
        "simulate_step_fast": lambda: simulate_step_fast(step),
        "step_time_traced": lambda: step_time_traced(step),
        "predict_transformer": lambda: get_workload("transformer").predict(
            get_platform("tpu-v5e-pod")),
        "sweep_faults": lambda: sweep_faults(get_workload("hpl"), plat,
                                             [FaultSpec.straggler(rank=0)]),
        "simulate_fault_impact": lambda: simulate_fault_impact(
            "hpl", plat, FaultSpec.straggler(rank=0)),
        "simulate_fault_impact_des": lambda: simulate_fault_impact(
            "hpl", plat, FaultSpec.fail_stop(rank=0), des=True),
        "RegionHPLSim": lambda: RegionHPLSim(region_cfg, plat, region=6),
        "predict_des_regions": lambda: get_workload(
            "hpl", N=2048, nb=128, P=2, Q=2).predict_des(plat, regions=6),
        "des_probe_runs_regions": lambda: des_probe_runs(
            plat, [region_cfg], regions=6),
        "fit_contention_at_scale": lambda: fit_contention_at_scale(
            plat, 4, region=6, steps=1),
        "contention_drift": lambda: contention_drift(plat, [4], region=6,
                                                     steps=1),
        "predict_fleet": lambda: predict_fleet([plat]),
        "calibrate_against_des": lambda: calibrate_against_des([plat],
                                                               steps=1),
        "PredictionService": lambda: PredictionService(),
        "HPLPredictionService": lambda: HPLPredictionService(),
        "serve.warm": lambda: warm(["hpl"], ["bdw-local"]),
        "serve.predict_top500": lambda: predict_top500(sample_list_path()),
        "run_campaign": lambda: run_campaign(CampaignSpec.make(
            "one", workloads=["hpl"], platforms=["bdw-local"])),
        "launch.serve.main": lambda: launch_serve.main(
            ["--arch", "qwen2-0.5b", "--smoke"]),
        "make_train_state": lambda: make_train_state(
            lm, torch.Generator().manual_seed(0)),
        "restore_checkpoint": lambda: restore_checkpoint(
            "no-such-dir", 0, {}),
        "train": lambda: train(lm, steps=1, global_batch=2, seq_len=8),
        "launch.train.main": lambda: launch_train.main(
            ["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"]),
        "make_batch": lambda: make_batch(lm, SMOKE_SHAPE),
    }


def _lm_tree(cfg):
    """A parameter tree of the right shapes (zeros), as plain numpy."""
    from repro_torch.models import param_layout

    def zeros(layout):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros(v[0])
                for k, v in layout.items()}
    return zeros(param_layout(cfg))


SMOKE_SHAPE = ShapeConfig("smoke", "prefill", 64, 2)
LM_ARCHS = {"": "qwen2-0.5b", "_ssm": "mamba2-780m",
            "_moe": "phi3.5-moe-42b-a6.6b", "_vlm": "llava-next-mistral-7b",
            "_hybrid": "zamba2-2.7b", "_encdec": "whisper-medium"}


@pytest.mark.parametrize("name", [
    "build_model", "ServeEngine", "lm_params_from_reference",
    "build_model_ssm", "ServeEngine_ssm", "lm_params_from_reference_ssm",
    "build_model_moe", "ServeEngine_moe", "lm_params_from_reference_moe",
    "build_model_vlm", "ServeEngine_vlm", "lm_params_from_reference_vlm",
    "build_model_hybrid", "ServeEngine_hybrid",
    "lm_params_from_reference_hybrid", "build_model_encdec",
    "ServeEngine_encdec", "lm_params_from_reference_encdec", "make_batch",
    "make_batch_vlm", "make_batch_encdec"])
def test_lm_entry_points_run_on_the_cpu_when_asked(name):
    suffix = next(s for s in ("_ssm", "_moe", "_vlm", "_hybrid", "_encdec",
                              "")
                  if name.endswith(s))
    base = name.removesuffix(suffix)
    lm = reduced(get_config(LM_ARCHS[suffix]))
    call = {"build_model": lambda: build_model(lm, device="cpu"),
            "ServeEngine": lambda: ServeEngine(lm, {}, device="cpu"),
            "lm_params_from_reference": lambda: lm_params_from_reference(
                _lm_tree(lm), lm, device="cpu"),
            "make_batch": lambda: make_batch(lm, SMOKE_SHAPE,
                                             device="cpu")}[base]
    assert call() is not None


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_host_side_of_training_keeps_the_references_signatures():
    """The entry points that touch no device keep the reference's
    signatures (``restore_checkpoint`` takes ``device=`` in place of the
    reference's ``shardings=``; ``make_train_state`` a torch generator in
    place of the jax key, and ``device=``); ``train`` takes the
    reference's and ``device=`` after them."""
    import inspect
    import repro.checkpoint as ref_ckpt
    import repro.data as ref_data
    import repro.train.loop as ref_loop
    import repro_torch.checkpoint as port_ckpt
    import repro_torch.data as port_data

    port_train = inspect.signature(train)
    device = port_train.parameters["device"]
    assert (device.kind, device.default) == (inspect.Parameter.KEYWORD_ONLY,
                                             "cuda")
    assert list(port_train.parameters)[-1] == "device"
    assert str(port_train.replace(parameters=[
        p for name, p in port_train.parameters.items()
        if name != "device"])) == str(inspect.signature(ref_loop.train))

    def surface(ckpt, data):
        return [(fn.__qualname__, str(inspect.signature(fn))) for fn in (
            ckpt.save_checkpoint, ckpt.latest_step, ckpt.AsyncCheckpointer,
            ckpt.AsyncCheckpointer.save, ckpt.AsyncCheckpointer.wait,
            data.DataConfig, data.SyntheticLM,
            data.SyntheticLM.global_batch_at, data.SyntheticLM.shard_at,
            data.make_batch_iterator)]
    assert surface(port_ckpt, port_data) == surface(ref_ckpt, ref_data)


def test_unported_paths_name_their_slice():
    """Every model family is ported (the encdec family, whisper-medium,
    the last, builds at full size on the CPU);
    the paths ported since the first slices run: the DES (slice 4),
    representative regions (``regions=``, slice 6) and fault scenarios on
    the fast model (slice 5)."""
    plat = get_platform("bdw-local")
    wl = get_workload("hpl")
    app = wl.des_app(plat)
    assert app.cfg == wl.config(plat) and app.run().events == 10597
    out = wl.predict_des(plat)
    assert (out["time_s"], out["events"]) == (0.05864729600365412, 10597)
    from repro_torch.scale import RegionHPLSim, RegionSpec
    region = RegionSpec(panels=6, warmup=2)
    assert isinstance(wl.des_app(plat, regions=region, device="cpu"),
                      RegionHPLSim)
    out = wl.predict_des(plat, regions=region, device="cpu")
    assert out["region_approx"] and out["panels_simulated"] == 6
    assert out["events"] < 10597
    model = wl.fastsim_model(plat, faults={"faults": []})
    assert model.params == plat.fastsim()
    whisper = build_model(get_config("whisper-medium"), device="cpu")
    assert (whisper.cfg.family, whisper.device.type) == ("encdec", "cpu")
    assert wl.des_ranks(plat) == HPLConfig(4096, 128, 4, 4).n_ranks


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """A build that fails raises with the compiler's output and leaves no
    library behind: nothing falls back to the plain version."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'nvcc: cannot compile here' >&2\n"
                    "exit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(RuntimeError, match="(?s)CUDA build failed.*"
                                           "cannot compile here"):
        _build.build_libraries(["maxmin_fair"])
    assert not list((tmp_path / "build").iterdir())


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA here: the script exits non-zero and prints no result, both
    in the repository and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True,
                              cwd=script.parent, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
