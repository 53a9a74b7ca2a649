"""The port stands alone: it imports neither jax nor the reference
package, its entry points never fall back to the CPU on their own, and
chip_smoke.py refuses to run without a card or without the repository."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import fit_fastsim_params, whatif_grid
from repro_torch.core.apps.hpl import HPLConfig
from repro_torch.core.fastsim import (simulate_hpl_fast, simulate_time_traced,
                                      sweep_hpl)
from repro_torch.convert import (fastsim_params_from_numpy,
                                 lm_params_from_reference)
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine
from repro_torch.platforms import fit_fastsim_to_des, get_platform
from repro_torch.workloads import get_workload

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any import of jax now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
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
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def _entry_points():
    plat = get_platform("bdw-local")
    cfg = plat.hpl_config()
    prm = plat.fastsim()
    model = get_workload("hpl").fastsim_model(plat)
    lm = reduced(get_config("qwen2-0.5b"))
    ssm = reduced(get_config("mamba2-780m"))
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
        "fit_fastsim_params": lambda: fit_fastsim_params(
            [(cfg, 0.05)], prm, fields=("gemm_eff",), steps=1),
        "whatif_grid": lambda: whatif_grid(get_workload("hpl"), plat,
                                           {"link_bw": [1.0, 2.0]}),
        "fit_fastsim_to_des": lambda: fit_fastsim_to_des(plat, steps=1),
    }


def _lm_tree(cfg):
    """A parameter tree of the right shapes (zeros), as plain numpy."""
    from repro_torch.models import param_layout

    def zeros(layout):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros(v[0])
                for k, v in layout.items()}
    return zeros(param_layout(cfg))


@pytest.mark.parametrize("name", [
    "build_model", "ServeEngine", "lm_params_from_reference",
    "build_model_ssm", "ServeEngine_ssm", "lm_params_from_reference_ssm"])
def test_lm_entry_points_run_on_the_cpu_when_asked(name):
    base = name.removesuffix("_ssm")
    lm = reduced(get_config("mamba2-780m" if name.endswith("_ssm")
                            else "qwen2-0.5b"))
    call = {"build_model": lambda: build_model(lm, device="cpu"),
            "ServeEngine": lambda: ServeEngine(lm, {}, device="cpu"),
            "lm_params_from_reference": lambda: lm_params_from_reference(
                _lm_tree(lm), lm, device="cpu")}[base]
    assert call() is not None


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_unported_paths_name_their_slice():
    """The DES paths run now (slice 4); representative regions
    (``regions=``) still name slice 6 and fault scenarios on the fast
    model slice 5."""
    plat = get_platform("bdw-local")
    wl = get_workload("hpl")
    app = wl.des_app(plat)
    assert app.cfg == wl.config(plat) and app.run().events == 10597
    out = wl.predict_des(plat)
    assert (out["time_s"], out["events"]) == (0.05864729600365412, 10597)
    with pytest.raises(NotImplementedError, match="slice 6"):
        wl.des_app(plat, regions=2)
    with pytest.raises(NotImplementedError, match="slice 6"):
        wl.predict_des(plat, regions=2)
    with pytest.raises(NotImplementedError, match="slice 5"):
        wl.fastsim_model(plat, faults={"faults": []})
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
