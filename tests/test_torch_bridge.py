"""Parity of the port's DES -> fastsim bridge
(``repro_torch.platforms.bridge``) with the JAX package's, on the CPU.

``fit_fastsim_to_des`` runs three DES probes on bdw-local (pure Python:
their times must be bit-equal to the reference's) and fits
``bcast_bw_scale`` and ``swap_bw_scale`` to them by gradient over 60
Adam steps; the fitted scales and the final loss must agree within 1e-6
relative.  The reference runs in a child interpreter that aliases
``jax.experimental.enable_x64`` to ``jax.enable_x64`` (never in this
process).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.apps.hpl import HPLConfig
from repro_torch.platforms import (BridgeFit, des_probe_runs,
                                   fit_fastsim_to_des, get_platform)
from repro_torch.platforms import bridge

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6

CHILD = r"""
import json
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
from repro.platforms import get_platform
from repro.platforms.bridge import fit_fastsim_to_des

fit = fit_fastsim_to_des(get_platform("bdw-local"))
print(json.dumps({
    "probes": [[c.N, c.nb, c.P, c.Q, t] for c, t in fit.probes],
    "calibration": fit.calibration, "loss0": fit.fit.loss0,
    "loss": fit.fit.loss, "history": fit.fit.history}))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", CHILD], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ours():
    return fit_fastsim_to_des(get_platform("bdw-local"), device="cpu")


def test_probes_bit_equal(reference, ours):
    assert [[c.N, c.nb, c.P, c.Q, t] for c, t in ours.probes] \
        == reference["probes"]
    assert all(c.lookahead == 0 for c, _ in ours.probes)


def test_calibration_within_1e6(reference, ours):
    assert isinstance(ours, BridgeFit)
    assert set(ours.calibration) == set(reference["calibration"])
    for name, want in reference["calibration"].items():
        np.testing.assert_allclose(ours.calibration[name], want, rtol=RTOL,
                                   atol=0, err_msg=name)
    np.testing.assert_allclose([ours.fit.loss0, ours.fit.loss],
                               [reference["loss0"], reference["loss"]],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(ours.fit.history, reference["history"],
                               rtol=RTOL, atol=0)
    assert ours.fit.loss < ours.fit.loss0


def test_fitted_platform_carries_the_calibration(ours):
    prm = ours.platform.fastsim()
    for name, value in ours.calibration.items():
        assert getattr(prm, name) == value
    base = get_platform("bdw-local").fastsim(calibrated=False)
    assert prm.gemm_eff == base.gemm_eff and prm.link_bw == base.link_bw


def test_explicit_probes_and_capacity():
    cfg = HPLConfig(N=512, nb=64, P=2, Q=2, lookahead=0)
    runs = des_probe_runs(get_platform("bdw-local"), [cfg])
    assert len(runs) == 1 and runs[0][0] is cfg and runs[0][1] > 0
    with pytest.raises(ValueError, match="no probe config"):
        des_probe_runs(get_platform("bdw-local"), [])


def test_regions_name_slice_6():
    """Named when ``regions=`` raised naming slice 6; slice 6 is ported
    now, so this holds that region probes run (a probe longer than the
    region is a region run within 10% of the exact DES) and that the
    bridge fits them."""
    from repro_torch.scale import RegionSpec
    plat = get_platform("bdw-local")
    region = RegionSpec(panels=6, warmup=2)
    cfg = HPLConfig(N=2048, nb=128, P=2, Q=2, lookahead=0)
    (c, t), = des_probe_runs(plat, [cfg], regions=region, device="cpu")
    exact = des_probe_runs(plat, [cfg])[0][1]
    assert c is cfg and t != exact and abs(t - exact) / exact < 0.10
    fit = fit_fastsim_to_des(plat, [cfg], regions=region, steps=2,
                             device="cpu")
    assert fit.probes == [(cfg, t)]


def test_missing_card_raises_before_any_probe(monkeypatch):
    """The device is resolved first: without a card the call raises at
    once, and no DES probe runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_probe(*a, **k):
        raise AssertionError("a DES probe ran before the device check")
    monkeypatch.setattr(bridge, "des_probe_runs", no_probe)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_fastsim_to_des(get_platform("bdw-local"))
