"""Parity of the port's calibration (``core.calibrate``), its AdamW
(``train.optimizer``) and the what-if grid (``core.predict.whatif_grid``)
with the JAX package's, on the CPU.

The reference runs in a child interpreter that aliases
``jax.experimental.enable_x64`` to ``jax.enable_x64`` (never in this
process); inputs are made here with numpy from fixed seeds and cross as
JSON, which round-trips floats exactly.  Tolerances:

* ``fit_linear`` (numpy on the host, copied): bit-identical;
* ``adamw_update``: bit-identical parameters, moments and norms over 5
  steps (both sides do the step in float32 and cast back);
* ``fit_fastsim_params``: loss history and fitted parameters within 1e-6
  relative of the reference's at 30 steps; the gradient under them
  agrees with JAX's to ~1e-9, so a float32 Adam step rounds the same
  way almost always, and one flip moves a parameter by at most one
  float32 ulp of its logarithm;
* ``whatif_grid`` rows: 1e-12 relative (float64 closed forms, the
  fastsim bound), and against the port's own single runs.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import whatif_grid
from repro_torch.core.apps.hpl import HPLConfig
from repro_torch.core.calibrate import (FASTSIM_FIT_FIELDS, fit_fastsim_params,
                                        fit_linear, measure_dgemm,
                                        measure_dger, measure_memop,
                                        measure_small_overhead,
                                        measure_stream)
from repro_torch.core.fastsim import FastSimParams, simulate_hpl_fast
from repro_torch.core.hardware.node import local_node
from repro_torch.platforms import get_platform
from repro_torch.train.optimizer import adamw_init, adamw_update
from repro_torch.workloads import get_workload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = FastSimParams.from_node(local_node(), link_bw=100e9 / 8)
# tests/test_sweep.py:150: the recovery setup
RECOVERY_GEOMS = [(2048, 128, 2, 4), (4096, 128, 4, 4), (3072, 128, 4, 2),
                  (4096, 192, 2, 8)]
RECOVERY_FIELDS = ("gemm_eff", "link_bw")
FIT_RTOL = 1e-6
GRID_RTOL = 1e-12
GRID_AXES = {"link_bw": [1.0, 2.0], "mem_bw": [1.0, 1.5]}
ABS_AXES = {"gemm_eff": [0.8, 0.9], "net_latency": [1e-6, 4e-6]}
# (lr, b1, b2, eps, weight_decay, max_grad_norm): the calibration's
# arguments, then the defaults (weight decay and a clip that bites)
ADAM_ARGS = {"calibration": dict(lr=0.1, b2=0.999, weight_decay=0.0,
                                 max_grad_norm=1e9),
             "defaults": dict(lr=1e-2)}

CHILD = r"""
import dataclasses, json, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
import jax.numpy as jnp
import numpy as np
from jax.experimental import enable_x64
from repro.core.apps.hpl import HPLConfig
from repro.core.calibrate import fit_fastsim_params, fit_linear
from repro.core.fastsim import FastSimParams, simulate_hpl_fast
from repro.core.hardware.node import local_node
from repro.core.predict import whatif_grid
from repro.train.optimizer import adamw_init, adamw_update
from repro.workloads import get_workload

pay = json.loads(sys.stdin.read())
out = {}
fr = fit_linear([tuple(p) for p in pay["points"]])
out["fit_linear"] = [fr.mu, fr.theta, fr.r2]

out["adam"] = {}
with enable_x64(True):
    for name, case in pay["adam"].items():
        theta = jnp.asarray(case["theta"], jnp.float64)
        state = adamw_init(theta)
        steps = []
        for g in case["grads"]:
            theta, state, gn = adamw_update(
                theta, jnp.asarray(g, jnp.float64), state, **case["args"])
            steps.append([np.asarray(theta).tolist(),
                          np.asarray(state["m"]).tolist(),
                          np.asarray(state["v"]).tolist(), float(gn),
                          int(state["count"])])
        out["adam"][name] = steps

BASE = FastSimParams.from_node(local_node(), link_bw=100e9 / 8)
cfgs = [HPLConfig(N=n, nb=nb, P=p, Q=q) for n, nb, p, q in pay["geoms"]]
runs = [(c, simulate_hpl_fast(c, BASE)["time_s"]) for c in cfgs]
init = dataclasses.replace(BASE, gemm_eff=BASE.gemm_eff * 1.6,
                           link_bw=BASE.link_bw * 0.5)
fit = fit_fastsim_params(runs, init, fields=tuple(pay["fields"]),
                         steps=pay["steps"], lr=0.1)
out["runs"] = [t for _, t in runs]
out["fit"] = {"params": dataclasses.asdict(fit.params), "loss0": fit.loss0,
              "loss": fit.loss, "history": fit.history}

cfg = HPLConfig(N=4096, nb=128, P=4, Q=4)
out["grid_legacy"] = whatif_grid(cfg, BASE, pay["axes"])
out["grid_workload"] = whatif_grid(get_workload("hpl"), "bdw-local",
                                   pay["axes"])
out["grid_abs"] = whatif_grid(get_workload("hpl"), "bdw-local",
                              pay["abs_axes"], mode="abs")
print(json.dumps(out))
"""


def _payload():
    rng = np.random.default_rng(20201105)
    ops = rng.uniform(1e6, 1e10, 16)
    points = [[float(o), float(2.5e-11 * o + 3e-6 + rng.normal(0, 1e-5))]
              for o in ops]
    adam = {}
    for name, args in ADAM_ARGS.items():
        n = 2 if name == "calibration" else 7
        adam[name] = {
            "theta": rng.normal(0.0, 10.0, n).tolist(),
            "grads": [rng.normal(0.0, 3.0, n).tolist() for _ in range(5)],
            "args": args}
    return {"points": points, "adam": adam,
            "geoms": RECOVERY_GEOMS, "fields": RECOVERY_FIELDS, "steps": 30,
            "axes": GRID_AXES, "abs_axes": ABS_AXES}


@pytest.fixture(scope="module")
def case():
    payload = _payload()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", CHILD],
                          input=json.dumps(payload), capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return payload, json.loads(proc.stdout.strip().splitlines()[-1])


def test_fit_linear_bit_identical(case):
    payload, ref = case
    fr = fit_linear([tuple(p) for p in payload["points"]])
    assert [fr.mu, fr.theta, fr.r2] == ref["fit_linear"]
    assert fr.eff_flops == 1.0 / fr.mu


@pytest.mark.parametrize("name", sorted(ADAM_ARGS))
def test_adamw_bit_identical_over_5_steps(case, name):
    payload, ref = case
    c = payload["adam"][name]
    theta = torch.tensor(c["theta"], dtype=torch.float64)
    state = adamw_init([theta])
    for step, g in zip(ref["adam"][name], c["grads"]):
        (theta,), state, gn = adamw_update(
            [theta], [torch.tensor(g, dtype=torch.float64)], state,
            **c["args"])
        assert theta.dtype == torch.float64
        assert state["m"][0].dtype == torch.float32
        got = [theta.tolist(), state["m"][0].tolist(), state["v"][0].tolist(),
               float(gn), state["count"]]
        assert got == step


def _recovery_runs(times):
    return [(HPLConfig(N=n, nb=nb, P=p, Q=q), t)
            for (n, nb, p, q), t in zip(RECOVERY_GEOMS, times)]


def _recovery_init():
    return dataclasses.replace(BASE, gemm_eff=BASE.gemm_eff * 1.6,
                               link_bw=BASE.link_bw * 0.5)


def test_fit_fastsim_params_30_steps_matches_reference(case):
    _, ref = case
    fit = fit_fastsim_params(_recovery_runs(ref["runs"]), _recovery_init(),
                             fields=RECOVERY_FIELDS, steps=30, lr=0.1,
                             device="cpu")
    assert len(fit.history) == 30 and fit.steps == 30
    np.testing.assert_allclose(fit.history, ref["fit"]["history"],
                               rtol=FIT_RTOL, atol=0)
    np.testing.assert_allclose([fit.loss0, fit.loss],
                               [ref["fit"]["loss0"], ref["fit"]["loss"]],
                               rtol=FIT_RTOL, atol=0)
    got = dataclasses.asdict(fit.params)
    for name, want in ref["fit"]["params"].items():
        np.testing.assert_allclose(got[name], want, rtol=FIT_RTOL, atol=0,
                                   err_msg=name)
    # only the fitted fields move
    for name in set(got) - set(RECOVERY_FIELDS):
        assert got[name] == float(getattr(BASE, name))


def test_fit_fastsim_params_recovers_true_params():
    """tests/test_sweep.py:150 on the port, with its own simulated
    runtimes: 250 Adam steps recover gemm_eff within 5% and link_bw
    within 10%."""
    runs = [(cfg, simulate_hpl_fast(cfg, BASE, device="cpu")["time_s"])
            for cfg, _ in _recovery_runs([0.0] * 4)]
    fit = fit_fastsim_params(runs, _recovery_init(), fields=RECOVERY_FIELDS,
                             steps=250, lr=0.1, device="cpu")
    assert fit.loss < fit.loss0 / 100
    assert fit.improvement > 100
    assert fit.params.gemm_eff == pytest.approx(BASE.gemm_eff, rel=0.05)
    assert fit.params.link_bw == pytest.approx(BASE.link_bw, rel=0.10)


def _assert_rows(rows, ref_rows):
    assert len(rows) == len(ref_rows)
    for row, want in zip(rows, ref_rows):
        assert set(row) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(row[k], v, rtol=GRID_RTOL, atol=0,
                                       err_msg=k)


def test_whatif_grid_legacy_form(case):
    _, ref = case
    cfg = HPLConfig(N=4096, nb=128, P=4, Q=4)
    rows = whatif_grid(cfg, BASE, GRID_AXES, device="cpu")
    _assert_rows(rows, ref["grid_legacy"])
    # tests/test_sweep.py:104: each row is its single run
    base_t = simulate_hpl_fast(cfg, BASE, device="cpu")["time_s"]
    for row in rows:
        prm = dataclasses.replace(BASE,
                                  link_bw=BASE.link_bw * row["link_bw"],
                                  mem_bw=BASE.mem_bw * row["mem_bw"])
        single = simulate_hpl_fast(cfg, prm, device="cpu")["time_s"]
        assert row["time_s"] == pytest.approx(single, rel=GRID_RTOL)
        assert row["speedup"] == pytest.approx(base_t / row["time_s"],
                                               rel=GRID_RTOL)


@pytest.mark.parametrize("mode", ["scale", "abs"])
def test_whatif_grid_workload_form(case, mode):
    _, ref = case
    axes = GRID_AXES if mode == "scale" else ABS_AXES
    wl = get_workload("hpl")
    rows = whatif_grid(wl, "bdw-local", axes, mode=mode, device="cpu")
    _assert_rows(rows, ref["grid_workload" if mode == "scale"
                           else "grid_abs"])
    # the prebuilt-FastModel form gives the same rows
    model = wl.fastsim_model(get_platform("bdw-local"))
    assert whatif_grid(model, None, axes, mode=mode, device="cpu") == rows
    for row in rows:
        over = {n: (getattr(model.params, n) * row[n] if mode == "scale"
                    else row[n]) for n in axes}
        single = model.predict(dataclasses.replace(model.params, **over),
                               device="cpu")["time_s"]
        assert row["time_s"] == pytest.approx(single, rel=GRID_RTOL)


def test_whatif_grid_rejects_bad_arguments():
    with pytest.raises(ValueError, match="scale\\|abs"):
        whatif_grid(get_workload("hpl"), "bdw-local", GRID_AXES,
                    mode="log", device="cpu")
    with pytest.raises(ValueError, match="platform"):
        whatif_grid(get_workload("hpl"), None, GRID_AXES, device="cpu")


def test_host_measurements_run():
    """The microbenchmarks are numpy on the host, as in the reference:
    at tiny sizes they return finite, positive rates and a fit."""
    fr = measure_dgemm(sizes=[32, 64, 96], min_time=1e-3)
    assert len(fr.points) == 6 and np.isfinite(fr.r2) and fr.theta >= 0
    assert measure_stream(n=1 << 12, min_time=1e-3) > 0
    for op in ("swap", "scal", "copy"):
        nbytes, t = measure_memop(op, n=1 << 10, min_time=1e-3)
        assert nbytes > 0 and t > 0
    with pytest.raises(ValueError):
        measure_memop("nope")
    assert measure_dger(m=64, n=8, min_time=1e-3) > 0
    assert measure_small_overhead(min_time=1e-3) > 0
    assert FASTSIM_FIT_FIELDS == ("gemm_eff", "mem_bw", "link_bw", "theta",
                                  "net_latency")
