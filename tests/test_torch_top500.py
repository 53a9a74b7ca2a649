"""Parity of the port's TOP500 pipeline (``repro_torch.top500``: the
parser, spec inference, the one-bucket fleet sweep and its calibration)
with the JAX reference, on the CPU.

The parser and inference are host Python copied from the reference:
rows and inferred ``Platform`` specs must be bit-identical (compared as
``to_dict``/JSON).  The fleet runs ``sweep_hpl`` in one forced bucket:
predicted and calibrated Rmax and the family factors within 1e-12
relative, with the same bucket and the same train/test splits.  The DES
bridge calibration agrees within 1e-6, as the bridge does.  The vendored
sample lists are the port's own copies, byte-equal to the reference's.
The reference runs once per module in a child interpreter
(``torch_reference.run_reference``); the fleet uses the reference tests'
smoke tuning (``max_ranks`` 256, ``panels_cap`` 2048).
"""
import dataclasses
import json
import os

import pytest

from repro_torch.core import fastsim
from repro_torch.core.fastsim import trace_count
from repro_torch.platforms import (Platform, bulk_register, get_platform,
                                   list_platforms, unregister)
from repro_torch.top500 import (CPUFamilyRule, FleetTuning,
                                ROW_SCHEMA_VERSION, SAMPLE_EDITIONS,
                                Top500Row, assign_splits,
                                calibrate_against_des, fabric_group,
                                infer_platform, infer_platforms,
                                list_sample_editions, load_sample,
                                parse_top500, predict_fleet,
                                sample_list_path, tune_scenario)
from torch_reference import ROOT, run_reference

RTOL = 1e-12
FIT_RTOL = 1e-6
SMOKE_TUNING = FleetTuning(max_ranks=256, panels_cap=2048)

CHILD = r"""
import dataclasses
from repro.top500 import (FleetTuning, calibrate_against_des,
                          infer_platforms, load_sample, predict_fleet,
                          tune_scenario)

OUT["rows"], OUT["platforms"] = {}, {}
for ed in PAYLOAD["editions"]:
    rows = load_sample(edition=ed)
    OUT["rows"][ed] = [dataclasses.asdict(r) for r in rows]
    OUT["platforms"][ed] = [p.to_dict() for p in infer_platforms(rows)]
tuning = FleetTuning(**PAYLOAD["tuning"])
plats = infer_platforms(load_sample())
OUT["tuned"] = [[dataclasses.asdict(c), s]
                for c, s in (tune_scenario(p, tuning) for p in plats)]
OUT["fleet"] = predict_fleet(load_sample(), tuning=tuning).to_dict()
res = calibrate_against_des(infer_platforms(load_sample()[:3]), steps=6)
OUT["des_cal"] = {"tables": res.tables, "donors": res.donors,
                  "platforms": [p.to_dict() for p in res.platforms]}
"""


@pytest.fixture(scope="module")
def ref():
    return run_reference(CHILD, {
        "editions": list(SAMPLE_EDITIONS),
        "tuning": dataclasses.asdict(SMOKE_TUNING)})


@pytest.fixture(scope="module")
def fleet():
    """The fleet's report, its new compiles counted from an empty shape
    set: ``trace_count`` counts every shape the process has dispatched, so
    a test of another file that ran the same bucket first in this worker
    would otherwise leave the fleet 0 to count.  The shapes seen before
    are merged back afterwards."""
    seen = set(fastsim._SHAPES_SEEN)
    fastsim._SHAPES_SEEN.clear()
    try:
        report = predict_fleet(load_sample(), tuning=SMOKE_TUNING,
                               device="cpu")
        report.new_compiles = trace_count()
    finally:
        fastsim._SHAPES_SEEN.update(seen)
    return report


def _row(**over):
    base = dict(rank=5, site="Test Site", system="Test Machine",
                processor="Intel Xeon Platinum 8280 28C 2.7GHz",
                cores=448448, interconnect="Mellanox InfiniBand HDR",
                rmax_tflops=23516.4, rpeak_tflops=38745.9)
    base.update(over)
    return Top500Row(**base)


def _json(x):
    """JSON-normalised (tuples to lists), as the reference's answer is."""
    return json.loads(json.dumps(x))


# ------------------------------------------------- parity: host Python

@pytest.mark.parametrize("edition", SAMPLE_EDITIONS)
def test_vendored_csv_byte_equal_to_reference(edition):
    ours = sample_list_path(edition)
    theirs = os.path.join(ROOT, "src", "repro", "top500", "data",
                          os.path.basename(ours))
    assert os.path.dirname(ours) == os.path.join(
        ROOT, "src", "repro_torch", "top500", "data")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("edition", SAMPLE_EDITIONS)
def test_parsed_rows_bit_identical(ref, edition):
    rows = load_sample(edition=edition)
    assert [dataclasses.asdict(r) for r in rows] == ref["rows"][edition]


@pytest.mark.parametrize("edition", SAMPLE_EDITIONS)
def test_inferred_platforms_bit_identical(ref, edition):
    plats = infer_platforms(load_sample(edition=edition))
    assert _json([p.to_dict() for p in plats]) == ref["platforms"][edition]


def test_tuned_scenarios_bit_identical(ref):
    plats = infer_platforms(load_sample())
    got = [[dataclasses.asdict(c), s]
           for c, s in (tune_scenario(p, SMOKE_TUNING) for p in plats)]
    assert _json(got) == ref["tuned"]


# ------------------------------------------------------- parity: fleet

def test_fleet_bucket_and_splits_equal(ref, fleet):
    want = ref["fleet"]
    got = _json(fleet.to_dict())
    assert got["bucket"] == want["bucket"]
    assert got["tuning"] == want["tuning"]
    assert fleet.compiles == want["compiles"] == 1
    assert [(m["name"], m["family"], m["split"], m["proxy_cfg"],
             m["proxy_scale"], m["provenance"]) for m in got["machines"]] \
        == [(m["name"], m["family"], m["split"], m["proxy_cfg"],
             m["proxy_scale"], m["provenance"]) for m in want["machines"]]
    assert got["calibration"]["n_train"] == want["calibration"]["n_train"]
    assert got["calibration"]["n_test"] == want["calibration"]["n_test"]


def test_fleet_rmax_and_factors_within_1e12(ref, fleet):
    want = ref["fleet"]
    got = fleet.to_dict()
    assert len(got["machines"]) == len(want["machines"]) >= 50
    for g, w in zip(got["machines"], want["machines"]):
        for key in ("predicted_tflops", "calibrated_tflops", "rel_err"):
            assert g[key] == pytest.approx(w[key], rel=RTOL, abs=0), (
                g["name"], key)
    factors = got["calibration"]["factors"]
    assert set(factors) == set(want["calibration"]["factors"])
    for fam, f in want["calibration"]["factors"].items():
        assert factors[fam] == pytest.approx(f, rel=RTOL, abs=0), fam
    for key in ("median_abs_err", "heldout_median_abs_err"):
        assert got[key] == pytest.approx(want[key], rel=RTOL, abs=0), key


def test_calibrate_against_des_within_1e6(ref):
    res = calibrate_against_des(infer_platforms(load_sample()[:3]),
                                steps=6, device="cpu")
    want = ref["des_cal"]
    assert res.donors == want["donors"]
    assert set(res.tables) == set(want["tables"])
    for fam, table in want["tables"].items():
        for f, v in table.items():
            assert res.tables[fam][f] == pytest.approx(v, rel=FIT_RTOL,
                                                       abs=0), (fam, f)
    for plat, w in zip(res.platforms, want["platforms"]):
        d = _json(plat.to_dict())
        assert d["provenance"] == w["provenance"]
        assert {k for k, _ in d["calibration"]} \
            == {k for k, _ in w["calibration"]}
        assert Platform.from_dict(plat.to_dict()) == plat
        fam = fabric_group(plat)
        assert plat.calibration_dict == res.tables[fam]
        assert plat.provenance_dict["calibration"].startswith("des-bridge:")
        assert all(0.01 < v < 50.0 for v in plat.calibration_dict.values())
    # the DES-bridge record survives a later residual pass
    report = predict_fleet(res.platforms, tuning=SMOKE_TUNING,
                           calibrate=True, device="cpu")
    for e in report.entries:
        assert e.platform.provenance_dict["calibration"].startswith(
            "des-bridge:")


# ----------------------------------------- the reference's fleet cases

def test_fleet_runs_as_single_batched_sweep(fleet):
    assert fleet.new_compiles <= 1
    assert fleet.compiles == fleet.new_compiles
    assert len(fleet.entries) >= 50
    for e in fleet.entries:
        assert e.cfg.n_panels <= fleet.bucket[0]
        assert e.cfg.P <= fleet.bucket[1]
        assert e.cfg.Q <= fleet.bucket[2]


def test_fleet_report_is_ranked_and_jsonable(fleet):
    ranked = fleet.ranked()
    preds = [e.calibrated_tflops or e.predicted_tflops for e in ranked]
    assert preds == sorted(preds, reverse=True)
    assert all(p > 0 for p in preds)
    d = fleet.to_dict()
    assert d["machines"][0]["predicted_rank"] == 1
    assert d["machines"][0]["provenance"]
    json.dumps(d)


def test_fleet_acceptance_heldout_median_error(fleet):
    cal = fleet.calibration
    assert cal.n_train >= 20 and cal.n_test >= 15
    assert cal.heldout_median_abs_err <= 0.15, cal.to_dict()
    for fam, f in cal.factors.items():
        assert 0.3 < f < 2.0, (fam, f)
    assert fleet.median_abs_err() <= 0.25


def test_fleet_split_is_deterministic_and_stratified(fleet):
    by_family = {}
    for e in fleet.entries:
        by_family.setdefault(e.family, []).append(e)
    for fam, group in by_family.items():
        marks = {e.split for e in group}
        assert marks <= {"train", "test"}
        assert marks == {"train"} if len(group) == 1 else "train" in marks
    before = [e.split for e in fleet.entries]
    assign_splits(fleet.entries)
    assert [e.split for e in fleet.entries] == before


def test_fleet_handles_platforms_without_published_rmax():
    plats = [get_platform("bdw-local"), get_platform("frontera")]
    report = predict_fleet(plats, tuning=SMOKE_TUNING, device="cpu")
    by_name = {e.platform.name: e for e in report.entries}
    assert by_name["bdw-local"].predicted_tflops > 0
    assert by_name["bdw-local"].rel_err != by_name["bdw-local"].rel_err
    assert by_name["bdw-local"].split == ""
    assert by_name["frontera"].split == "train"   # singleton family
    d = report.to_dict()
    assert json.loads(json.dumps(d))
    row = next(m for m in d["machines"] if m["name"] == "bdw-local")
    assert row["rel_err"] is None


def test_predict_fleet_empty_source_raises():
    with pytest.raises(ValueError, match="no machines"):
        predict_fleet([], device="cpu")


def test_family_factor_path_records_provenance():
    report = predict_fleet(infer_platforms(load_sample()[:6]),
                           tuning=SMOKE_TUNING, calibrate=True, device="cpu")
    for e in report.entries:
        assert e.platform.provenance_dict["calibration"] == "family-factor"


def test_tune_scenario_memory_rule_and_proxy_invariance():
    plat = infer_platform(_row())
    cfg, scale = tune_scenario(plat, SMOKE_TUNING)
    assert cfg.P * cfg.Q <= SMOKE_TUNING.max_ranks
    proxy_nodes = cfg.P * cfg.Q
    assert 8 * cfg.N ** 2 <= 0.75 * proxy_nodes * plat.node.hbm_bytes
    assert scale == pytest.approx(plat.scale.n_nodes / proxy_nodes)
    assert cfg.n_panels <= SMOKE_TUNING.panels_cap
    small = infer_platform(_row(cores=56 * 100,
                                rmax_tflops=100.0, rpeak_tflops=483.8))
    cfg_s, scale_s = tune_scenario(small, SMOKE_TUNING)
    assert scale_s == pytest.approx(1.0)
    assert cfg_s.P * cfg_s.Q == 100


# ---------------------------------------------- parser and inference

def test_parse_vendored_sample_is_clean():
    report = parse_top500(sample_list_path(), strict=True)
    assert len(report.rows) >= 50 and not report.skipped
    ranks = [r.rank for r in report.rows]
    assert ranks == sorted(ranks) and len(set(ranks)) == len(ranks)
    for r in report.rows:
        assert r.schema_version == ROW_SCHEMA_VERSION
        assert 0 < r.rmax_tflops <= r.rpeak_tflops
        assert r.cpu_cores > 0


def test_parse_header_aliases_tsv_and_gflops_columns():
    text = ("Rank\tName\tProcessor\tCores\tInterconnect\t"
            "Rmax\tRpeak\n"
            "7\tBox\tXeon Gold 6148 20C 2.4GHz\t4,000\tEDR\t"
            "100.5\t200.0\n")
    r = parse_top500(text).rows[0]
    assert (r.rank, r.system, r.cores) == (7, "Box", 4000)
    assert r.rmax_tflops == pytest.approx(100.5)
    text = ("Rank,Processor,Total Cores,Interconnect,"
            "Rmax [GFlop/s],Rpeak [GFlop/s]\n"
            "1,Xeon E5-2680v3 12C 2.5GHz,1000,Aries,50000,80000\n")
    r = parse_top500(text).rows[0]
    assert (r.rmax_tflops, r.rpeak_tflops) == (50.0, 80.0)


def test_parse_lenient_skips_and_strict_raises():
    text = ("Rank,Processor,Total Cores,Interconnect,Rmax,Rpeak\n"
            "1,Xeon Gold 6148 20C 2.4GHz,1000,EDR,10,20\n"
            "2,Xeon Gold 6148 20C 2.4GHz,not-a-number,EDR,10,20\n"
            "3,Xeon Gold 6148 20C 2.4GHz,1000,EDR,0,20\n"
            "4,Xeon Gold 6148 20C 2.4GHz,1000,,10,20\n")
    report = parse_top500(text)
    assert [r.rank for r in report.rows] == [1]
    assert [line for line, _ in report.skipped] == [2, 3, 4]
    with pytest.raises(ValueError, match="row 2"):
        parse_top500(text, strict=True)
    with pytest.raises(ValueError, match="interconnect"):
        parse_top500("Rank,Processor,Total Cores,Rmax,Rpeak\n"
                     "1,Xeon 20C 2GHz,100,1,2\n")
    with pytest.raises(ValueError, match="no fabric family rule"):
        infer_platform(_row(interconnect=""))
    with pytest.raises(ValueError, match="no CPU family rule"):
        infer_platform(_row(processor=""))


def test_infer_frontera_like_row_matches_hand_spec():
    plat = infer_platform(_row())
    prov = plat.provenance_dict
    assert plat.scale.n_nodes == 8008 and plat.node.cores == 56
    assert prov["cpu_family"] == "xeon-avx512"
    assert prov["peak_source"] == "processor-heuristic"
    assert plat.node.peak_flops == pytest.approx(56 * 32 * 2.7e9 * 0.70,
                                                 rel=1e-6)
    assert plat.fabric.kind == "fat-tree"
    assert plat.fabric.link_bw == pytest.approx(200e9 / 8)
    assert fabric_group(plat) == "infiniband"


def test_infer_fabric_kinds_from_interconnect_strings():
    cases = {"Aries interconnect": ("dragonfly", "aries"),
             "Slingshot-10": ("dragonfly", "slingshot"),
             "Tofu interconnect D": ("torus", "tofu"),
             "Custom 5D Torus": ("torus", "bluegene"),
             "Intel Omni-Path": ("fat-tree", "omnipath"),
             "25G Ethernet": ("fat-tree", "ethernet"),
             "Mystery Fabric 3000": ("fat-tree", "custom")}
    for text, (kind, family) in cases.items():
        plat = infer_platform(_row(interconnect=text))
        assert (plat.fabric.kind, fabric_group(plat)) == (kind, family), text


def test_infer_rescale_accelerator_and_overrides():
    plat = infer_platform(_row(
        processor="Marvell ThunderX2 28C 2.0GHz", cores=145152,
        rmax_tflops=1529.0, rpeak_tflops=2322.4))
    assert plat.provenance_dict["peak_source"].startswith("rpeak-rescaled")
    plat = infer_platform(_row(
        processor="IBM POWER9 22C 3.07GHz", cores=2414592,
        accel_cores=2211840, accelerator="NVIDIA Volta GV100",
        rmax_tflops=148600.0, rpeak_tflops=200794.9))
    assert plat.scale.n_nodes == 4608
    assert plat.node.accel_peak_flops > 0.5 * plat.node.peak_flops
    plat = infer_platform(_row(), overrides={"n_nodes": 100,
                                             "hbm_bytes": 64e9})
    assert plat.scale.n_nodes == 100
    assert "override 100" in plat.provenance_dict["n_nodes"]
    rule = CPUFamilyRule("my-chip", r".", 8, 1.0, 1, 1.0, 1.0, 4, 1.0)
    plat2 = infer_platform(_row(rpeak_tflops=448448 * 8 * 2.7 / 1e3),
                           cpu_families=(rule,))
    assert plat2.provenance_dict["cpu_family"] == "my-chip"
    assert plat2.node.cores == 28


@pytest.mark.parametrize("idx", [0, 1, 4, 10, 22])
def test_inferred_platforms_build_both_backends(idx):
    plat = infer_platforms([load_sample()[idx]])[0]
    assert plat.des().topology.n_links > 0
    prm = plat.fastsim()
    assert prm.peak_flops > 0 and prm.link_bw > 0
    assert Platform.from_json(plat.to_json()) == plat


def test_bulk_register_namespaces_inferred_platforms():
    plats = infer_platforms(load_sample()[:3])
    names = [f"t500torch/{p.name}" for p in plats]
    unregister(names)
    try:
        out = bulk_register(plats, namespace="t500torch")
        assert [p.name for p in out] == names
        assert get_platform(names[0]).scale.reported_tflops > 0
        assert plats[0].name not in list_platforms()
        with pytest.raises(ValueError, match="already registered"):
            bulk_register(plats[:1], namespace="t500torch")
    finally:
        unregister(names)


# ------------------------------------------------ vendored editions

def test_second_vendored_edition_parses_clean():
    assert list_sample_editions() == ["2020_06", "2020_11"]
    rows = load_sample(edition="2020_11")
    assert len(rows) >= 40
    ranks = [r.rank for r in rows]
    assert ranks == sorted(ranks) and len(set(ranks)) == len(ranks)


def test_editions_share_machines_and_record_upgrades():
    june = {r.system: r for r in load_sample(edition="2020_06")}
    nov = {r.system: r for r in load_sample(edition="2020_11")}
    assert len(set(june) & set(nov)) >= 30
    assert nov["Fugaku"].rmax_tflops > june["Fugaku"].rmax_tflops
    assert nov["Selene"].cores == 2 * june["Selene"].cores
    assert "JUWELS Booster Module" in set(nov) - set(june)
    assert "K computer" in set(june) - set(nov)
    assert len(infer_platforms(nov.values())) == len(nov)


def test_unknown_sample_edition_hints_close_match():
    with pytest.raises(ValueError,
                       match=r"unknown sample edition '2020_12'; did "
                             r"you mean: 2020_11"):
        sample_list_path("2020_12")
    with pytest.raises(ValueError, match=r"vendored: 2020_06, 2020_11"):
        sample_list_path("1993")
