"""Parity of the port's representative-region simulation and per-scale
contention calibration (``repro_torch.scale``) with the JAX reference, on
the CPU.

A region run is the port's DES on a prefix of the iteration space (host
Python: its events and panel marks bit-identical to the reference's)
plus a tail priced by fastsim (the region result within 1e-12
relative).  The feature-fit fallback is a numpy fit on the host
(bit-identical).  Contention scales fitted to region probes agree within
1e-6, as the bridge's do.  The reference's own cases (regions within
10% of the exact DES, exact runs when the config fits the region, the
workload protocol, the per-scale table) are held on the port alone as
well.  The reference runs once per module in a child interpreter
(``torch_reference.run_reference``).
"""
import pytest
import torch

from repro_torch.core.apps.hpl import HPLConfig, HPLSim
from repro_torch.platforms import Platform, get_platform
from repro_torch.scale import (RegionHPLSim, RegionSpec, ScaleFit, as_region,
                               contention_drift, fit_contention_at_scale,
                               scaled_probe_configs, square_grid)
from repro_torch.workloads import get_workload
from torch_reference import run_reference

RTOL = 1e-12
FIT_RTOL = 1e-6
REGION_CFGS = [dict(N=4096, nb=128, P=2, Q=4), dict(N=6144, nb=128, P=4, Q=4),
               dict(N=4096, nb=128, P=2, Q=8)]
FIT_REGION = dict(panels=8, warmup=2)
FIT_PROBE = dict(N=3072, nb=128, P=4, Q=4, lookahead=0)

CHILD = r"""
from repro.core.apps.hpl import HPLConfig, HPLSim
from repro.platforms import get_platform
from repro.scale import (RegionHPLSim, RegionSpec, contention_drift,
                         fit_contention_at_scale)
from repro.workloads import get_workload

plat = get_platform("frontera")
stack = plat.des()


def region(sim):
    res = sim.run()
    return {"time_s": res.time_s, "gflops": res.gflops,
            "events": res.events, "marks": sorted(sim._marks.items())}


OUT["regions"], OUT["exact"] = [], []
for kw in PAYLOAD["cfgs"]:
    cfg = HPLConfig(lookahead=0, bcast=plat.mpi.bcast, **kw)
    OUT["regions"].append(region(RegionHPLSim(cfg, plat, region=12)))
    res = HPLSim(cfg, plat).run()
    OUT["exact"].append([res.time_s, res.events])
cfg = HPLConfig(lookahead=0, bcast=plat.mpi.bcast, **PAYLOAD["cfgs"][0])
OUT["fallback"] = region(RegionHPLSim(
    cfg, stack.node, stack.topology, region=12,
    ranks_per_node=stack.ranks_per_node, mpi_overhead=stack.mpi_overhead))
wl = get_workload("hpl", lookahead=0, **PAYLOAD["cfgs"][0])
OUT["hpl_des"] = wl.predict_des(plat, regions=12, trace=True)
tf = get_workload("transformer", mesh=(4, 8), num_layers=12)
OUT["tf_des"] = tf.predict_des(get_platform("tpu-v5e-pod"),
                               regions=RegionSpec(panels=6, warmup=2))
sf = fit_contention_at_scale(
    plat, 16, region=RegionSpec(**PAYLOAD["fit_region"]),
    probe_configs=[HPLConfig(bcast=plat.mpi.bcast, **PAYLOAD["fit_probe"])],
    steps=12)
OUT["fit"] = {"overrides": sf.overrides, "probes": [t for _, t in sf.probes],
              "note": dict(sf.platform.provenance)["contention@16"]}
_, table = contention_drift(plat, [4, 16],
                            region=RegionSpec(**PAYLOAD["fit_region"]),
                            steps=12)
OUT["drift"] = {str(k): v for k, v in table.items()}
"""


@pytest.fixture(scope="module")
def ref():
    return run_reference(CHILD, {"cfgs": REGION_CFGS,
                                 "fit_region": FIT_REGION,
                                 "fit_probe": FIT_PROBE})


def _region(sim):
    res = sim.run()
    return res, {"time_s": res.time_s, "gflops": res.gflops,
                 "events": res.events,
                 "marks": [list(kv) for kv in sorted(sim._marks.items())]}


def _assert_region(got, want):
    assert got["events"] == want["events"]
    assert got["marks"] == want["marks"]          # the DES prefix
    for key in ("time_s", "gflops"):
        assert got[key] == pytest.approx(want[key], rel=RTOL, abs=0), key


# ------------------------------------------------------------ RegionSpec

def test_as_region_normalization():
    assert as_region(None) == RegionSpec()
    assert as_region(16) == RegionSpec(panels=16)
    spec = RegionSpec(panels=20, warmup=4)
    assert as_region(spec) is spec
    with pytest.raises(TypeError):
        as_region(True)
    with pytest.raises(TypeError):
        as_region("12")
    with pytest.raises(ValueError):
        RegionSpec(panels=4, warmup=2)
    with pytest.raises(ValueError):
        RegionSpec(panels=12, warmup=0)


def test_square_grid():
    assert square_grid(16) == (4, 4)
    assert square_grid(12) == (3, 4)
    assert square_grid(10000) == (100, 100)
    assert square_grid(7) == (1, 7)
    with pytest.raises(ValueError):
        square_grid(0)


# ------------------------------------------------------------ HPL region

@pytest.mark.parametrize("i", range(len(REGION_CFGS)),
                         ids=["2x4", "4x4", "2x8"])
def test_region_hpl_parity_and_within_10pct_of_exact(ref, i):
    plat = get_platform("frontera")
    cfg = HPLConfig(lookahead=0, bcast=plat.mpi.bcast, **REGION_CFGS[i])
    exact = HPLSim(cfg, plat).run()
    assert [exact.time_s, exact.events] == ref["exact"][i]
    res, got = _region(RegionHPLSim(cfg, plat, region=12, device="cpu"))
    _assert_region(got, ref["regions"][i])
    assert res.region_approx and res.region_panels == 12
    assert res.events < exact.events
    err = abs(res.time_s - exact.time_s) / exact.time_s
    assert err < 0.10, f"region error {err:.1%} on {REGION_CFGS[i]}"
    assert res.gflops == pytest.approx(cfg.flops() / res.time_s / 1e9)


def test_region_hpl_exact_when_config_fits_region():
    plat = get_platform("frontera")
    cfg = HPLConfig(N=1024, nb=128, P=2, Q=2, lookahead=0,
                    bcast=plat.mpi.bcast)
    assert cfg.n_panels <= 12
    exact = HPLSim(cfg, plat).run()
    res = RegionHPLSim(cfg, plat, region=12, device="cpu").run()
    assert not res.region_approx and res.region_panels == 0
    assert res.time_s == exact.time_s and res.events == exact.events


def test_region_hpl_feature_fit_fallback_bit_identical(ref):
    plat = get_platform("frontera")
    stack = plat.des()
    cfg = HPLConfig(lookahead=0, bcast=plat.mpi.bcast, **REGION_CFGS[0])
    sim = RegionHPLSim(cfg, stack.node, stack.topology, region=12,
                       ranks_per_node=stack.ranks_per_node,
                       mpi_overhead=stack.mpi_overhead)
    assert sim._platform is None and sim._device is None
    res, got = _region(sim)
    assert got == ref["fallback"]
    err = abs(res.time_s - ref["exact"][0][0]) / ref["exact"][0][0]
    assert res.region_approx and err < 0.15, err


def test_region_hpl_through_workload_protocol(ref):
    plat = get_platform("frontera")
    wl = get_workload("hpl", lookahead=0, **REGION_CFGS[0])
    exact = wl.predict_des(plat)
    out = wl.predict_des(plat, regions=12, trace=True, device="cpu")
    want = ref["hpl_des"]
    assert set(out) == set(want)
    assert (out["events"], out["panels_simulated"], out["breakdown"]) == (
        want["events"], want["panels_simulated"], want["breakdown"])
    for key in ("time_s", "gflops", "tflops"):
        assert out[key] == pytest.approx(want[key], rel=RTOL, abs=0), key
    assert out["region_approx"] and out["breakdown"]["region_approx"]
    assert abs(out["time_s"] - exact["time_s"]) / exact["time_s"] < 0.10
    assert "region_approx" not in exact


def test_region_transformer_through_workload_protocol(ref):
    plat = get_platform("tpu-v5e-pod")
    wl = get_workload("transformer", mesh=(4, 8), num_layers=12)
    exact = wl.predict_des(plat)
    out = wl.predict_des(plat, regions=RegionSpec(panels=6, warmup=2))
    assert out == ref["tf_des"]               # host Python throughout
    assert out["region_approx"] and out["layers_simulated"] == 6
    assert abs(out["time_s"] - exact["time_s"]) / exact["time_s"] < 0.10
    small = get_workload("transformer", mesh=(4, 8), num_layers=4)
    assert "region_approx" not in small.predict_des(plat, regions=6)


def test_region_device_resolved_before_the_des(monkeypatch):
    """The tail's device is resolved at construction: without a card the
    default raises before any DES event runs; an exact-size config and
    the feature fit need no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plat = get_platform("frontera")
    cfg = HPLConfig(lookahead=0, bcast=plat.mpi.bcast, **REGION_CFGS[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RegionHPLSim(cfg, plat, region=12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_workload("hpl", lookahead=0, **REGION_CFGS[0]).predict_des(
            plat, regions=12)
    small = HPLConfig(N=1024, nb=128, P=2, Q=2, lookahead=0)
    assert RegionHPLSim(small, plat, region=12)._device is None


# --------------------------------------------- per-scale contention table

def test_with_contention_round_trip_and_provenance():
    plat = get_platform("frontera")
    p2 = plat.with_contention(10_000, {"bcast_bw_scale": 1.7},
                              note="region-fit test")
    assert plat.contention == ()
    assert p2.contention_dict == {10_000: {"bcast_bw_scale": 1.7}}
    assert dict(p2.provenance)["contention@10000"] == "region-fit test"
    assert Platform.from_dict(p2.to_dict()).contention_dict \
        == p2.contention_dict
    p4 = p2.with_contention(10_000, {"bcast_bw_scale": 2.1})
    assert p4.contention_dict == {10_000: {"bcast_bw_scale": 2.1}}


def test_fastsim_at_ranks_applies_nearest_log_space_entry():
    plat = (get_platform("frontera")
            .with_contention(100, {"bcast_bw_scale": 1.5})
            .with_contention(10_000, {"bcast_bw_scale": 3.0}))
    base = plat.fastsim()
    assert plat.fastsim(at_ranks=500).bcast_bw_scale == 1.5
    assert plat.fastsim(at_ranks=5000).bcast_bw_scale == 3.0
    assert plat.contention_for(3000) == {"bcast_bw_scale": 3.0}
    assert plat.fastsim(at_ranks=500).swap_bw_scale == base.swap_bw_scale
    assert plat.fastsim().bcast_bw_scale == base.bcast_bw_scale


def test_scaled_probe_configs_geometry():
    plat = get_platform("frontera")
    cfgs = scaled_probe_configs(plat, 64, region=RegionSpec(panels=12))
    assert all(c.P * c.Q == 64 and c.lookahead == 0 for c in cfgs)
    assert [c.n_panels for c in cfgs] == [36, 48]
    with pytest.raises(ValueError, match="capacity"):
        scaled_probe_configs(plat, 10**6)


def test_fit_contention_at_scale_within_1e6(ref):
    plat = get_platform("frontera")
    sf = fit_contention_at_scale(
        plat, 16, region=RegionSpec(**FIT_REGION),
        probe_configs=[HPLConfig(bcast=plat.mpi.bcast, **FIT_PROBE)],
        steps=12, device="cpu")
    want = ref["fit"]
    assert isinstance(sf, ScaleFit) and sf.at_ranks == 16
    assert [t for _, t in sf.probes] == pytest.approx(want["probes"],
                                                      rel=RTOL, abs=0)
    assert set(sf.overrides) == set(want["overrides"])
    for k, v in want["overrides"].items():
        assert sf.overrides[k] == pytest.approx(v, rel=FIT_RTOL, abs=0), k
    note = dict(sf.platform.provenance)["contention@16"]
    assert note == want["note"]
    assert "region-fit" in note and "panels=8" in note
    assert sf.platform.contention_dict[16] == sf.overrides
    assert sf.platform.fastsim(at_ranks=16).bcast_bw_scale \
        == sf.overrides["bcast_bw_scale"]


def test_contention_drift_within_1e6(ref):
    plat, table = contention_drift(get_platform("frontera"), [4, 16],
                                   region=RegionSpec(**FIT_REGION), steps=12,
                                   device="cpu")
    assert {str(k) for k in table} == set(ref["drift"])
    for ranks, over in table.items():
        for k, v in ref["drift"][str(ranks)].items():
            assert over[k] == pytest.approx(v, rel=FIT_RTOL, abs=0)
    assert set(plat.contention_dict) == {4, 16}
