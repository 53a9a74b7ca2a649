"""Parity of the port's campaign layer (``repro_torch.campaign``: specs,
expansion, the executor, journals, merge and reports, the CLI) with the
JAX reference, on the CPU.

Every ``campaign_run`` journal record equals the reference's apart from
floats, which agree within 1e-12 relative (they are ``sweep_hpl``,
``sweep_step`` and ``predict_fleet`` answers); the summaries' spec echo,
run counts, skipped cells and dispatch counts are equal, and so are the
drift tables of the two-edition TOP500 study (floats within 1e-12).
Both packages start each campaign from a cold compile state, so the
dispatch and compile counts compare as a fresh process's.  The
reference runs once per module in a child interpreter
(``torch_reference.run_reference``); its own campaign cases
(``tests/test_campaign.py``) are held on the port as well, with
``device="cpu"``.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.campaign import (Budget, CampaignSpec, PlatformSelector,
                                  campaign_report, dispatch_counts,
                                  edition_study_spec, expand, machine_key,
                                  merge_journals, render_markdown,
                                  render_text, run_campaign, write_csv)
from repro_torch.campaign.cli import main as campaign_main
from repro_torch.core import fastsim
from repro_torch.faults import FaultSpec
from repro_torch.serve import PredictionService
from repro_torch.top500 import FleetTuning
from repro_torch.workloads import stepsim
from torch_reference import assert_close, run_reference

CPU = "cpu"
SMOKE_TUNING = FleetTuning(max_ranks=256, panels_cap=2048)
TORUS_PLATFORMS = ("tpu-v5e-pod", "syn-torus-fugaku-4k",
                   "syn-torus-bgq-8k")
STRAGGLER = FaultSpec.straggler(rank=0, slowdown=1.5)


def accept_spec(**over):
    """The reference's acceptance matrix: 2 workloads x 3 platforms x
    2 seeds x a fault scenario (the N axis keeps HPL cells small)."""
    kw = dict(workloads=["hpl", "transformer"],
              platforms=list(TORUS_PLATFORMS),
              axes={"N": [1536, 1920]}, faults=[None, STRAGGLER],
              seeds=[0, 1])
    kw.update(over)
    return CampaignSpec.make("accept", **kw)


BAD_CELL = dict(workloads=["hpl"], platforms=["tpu-v5e-pod"],
                axes={"N": [1536]}, faults=[FaultSpec.fail_stop(rank=0)],
                seeds=[0])

CHILD = r"""
import json
from repro.campaign import (CampaignSpec, campaign_report,
                            edition_study_spec, run_campaign)
from repro.campaign.cli import main as campaign_main
from repro.core import fastsim
from repro.faults import FaultSpec
from repro.top500 import FleetTuning
from repro.workloads import stepsim


def cold():
    fastsim._compiled.cache_clear()
    stepsim._compiled.cache_clear()


def summary(res):
    meta = dict(res.summary["meta"])
    meta.pop("wall_s")
    return meta


spec = CampaignSpec.from_json(PAYLOAD["accept"])
cold()
res = run_campaign(spec)
OUT["accept_runs"] = [r for r in res.records if r["kind"] == "campaign_run"]
OUT["accept_summary"] = summary(res)
OUT["accept_lines"] = [l for l in res.lines() if '"campaign_run"' in l]
cold()
res = run_campaign(edition_study_spec(["2020_06", "2020_11"], limit=8),
                   tuning=FleetTuning(**PAYLOAD["tuning"]))
OUT["drift_runs"] = [r for r in res.records if r["kind"] == "campaign_run"]
OUT["drift_summary"] = summary(res)
OUT["drift_report"] = json.loads(json.dumps(campaign_report(res.records)))
bad = CampaignSpec.from_json(PAYLOAD["bad"])
OUT["bad"] = run_campaign(bad).run_records[0]["meta"]["result"]
cold()
campaign_main(["run", "--edition-study", "2020_06", "2020_11", "--limit",
               "6", "--max-ranks", "128", "--journal", PAYLOAD["journal"]])
"""


def _cold():
    """The port's compile state as in a fresh process."""
    fastsim._compiled.cache_clear()
    fastsim._SHAPES_SEEN.clear()
    stepsim._SHAPES_SEEN.clear()


def _summary(res):
    meta = dict(res.summary["meta"])
    meta.pop("wall_s")
    return json.loads(json.dumps(meta))


def _runs(res):
    return json.loads(json.dumps(res.run_records))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    journal = tmp_path_factory.mktemp("ref") / "cli.ndjson"
    out = run_reference(CHILD, {
        "accept": accept_spec().to_json(),
        "bad": CampaignSpec.make("badcell", **BAD_CELL).to_json(),
        "tuning": dataclasses.asdict(SMOKE_TUNING),
        "journal": str(journal)})
    out["cli_journal"] = [json.loads(l) for l in
                          journal.read_text().splitlines() if l]
    return out


@pytest.fixture(scope="module")
def accept_result(tmp_path_factory):
    journal = tmp_path_factory.mktemp("accept") / "runs.ndjson"
    _cold()
    res = run_campaign(accept_spec(), journal=journal, device=CPU)
    return res, journal


@pytest.fixture(scope="module")
def drift_result(tmp_path_factory):
    journal = tmp_path_factory.mktemp("drift") / "drift.ndjson"
    _cold()
    spec = edition_study_spec(["2020_06", "2020_11"], limit=8)
    res = run_campaign(spec, journal=journal, tuning=SMOKE_TUNING,
                       device=CPU)
    return res, journal


# ------------------------------------------------------ parity: journals

def test_acceptance_run_records_match_reference(ref, accept_result):
    res, _ = accept_result
    runs = _runs(res)
    assert len(runs) == len(ref["accept_runs"]) == 36
    assert_close(runs, ref["accept_runs"])


def test_acceptance_summary_matches_reference(ref, accept_result):
    res, _ = accept_result
    assert_close(_summary(res), ref["accept_summary"])
    d = res.summary["meta"]["dispatches"]
    assert d == ref["accept_summary"]["dispatches"]
    assert d["fastsim_dispatches"] == 1 and d["stepsim_dispatches"] == 1
    assert d["serve_sweeps"] == 2 and res.summary["meta"]["runs"] == 36


def test_acceptance_run_lines_equal_reference_apart_from_floats(
        ref, accept_result):
    res, _ = accept_result
    lines = [l for l in res.lines() if '"campaign_run"' in l]
    assert_close([json.loads(l) for l in lines],
                 [json.loads(l) for l in ref["accept_lines"]])


def test_edition_study_run_records_match_reference(ref, drift_result):
    res, _ = drift_result
    runs = _runs(res)
    assert len(runs) == len(ref["drift_runs"]) == 16
    assert_close(runs, ref["drift_runs"])


def test_edition_study_summary_matches_reference(ref, drift_result):
    res, _ = drift_result
    got = _summary(res)
    want = ref["drift_summary"]
    got.pop("metrics", None), want.pop("metrics", None)
    assert_close(got, want)
    assert all(e["compiles"] <= 1
               for e in res.summary["meta"]["editions"].values())


def test_drift_report_matches_reference(ref, drift_result):
    res, _ = drift_result
    report = json.loads(json.dumps(campaign_report(res.records)))
    assert_close(report, ref["drift_report"])
    fugaku = {d["machine"]: d for d in report["drift"]["machines"]}["fugaku"]
    assert fugaku["predicted_drift"] == pytest.approx(0.064, abs=0.005)


def test_bad_cell_error_record_matches_reference(ref):
    res = run_campaign(CampaignSpec.make("badcell", **BAD_CELL), device=CPU)
    assert res.run_records[0]["meta"]["result"] == ref["bad"]


def test_cli_edition_study_journal_matches_reference(ref, tmp_path, capsys):
    journal = tmp_path / "cli.ndjson"
    _cold()
    assert campaign_main(["run", "--edition-study", "2020_06", "2020_11",
                          "--limit", "6", "--max-ranks", "128", "--journal",
                          str(journal), "--device", "cpu"]) == 0
    capsys.readouterr()
    got = [json.loads(l) for l in journal.read_text().splitlines() if l]
    want = ref["cli_journal"]
    assert len(got) == len(want) == 13
    for rec in (got[-1], want[-1]):
        rec["meta"].pop("wall_s")
        rec.pop("metrics")
    assert_close(got, want)


# ---------------------------------------------------------- devices

def test_cuda_campaign_without_a_card_raises_before_expanding(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("repro_torch.campaign.exec.expand",
                        lambda *a, **k: pytest.fail("expanded"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_campaign(accept_spec())


def test_cuda_campaign_does_not_isolate_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_campaign(CampaignSpec.make("one", workloads=["hpl"],
                                       platforms=["bdw-local"]),
                     device="cuda")


def test_campaign_takes_a_caller_held_services_device(monkeypatch):
    """With ``service=`` and no ``device=``, the fleet runs where the
    service does: a CPU service needs no card for either part."""
    svc = PredictionService(device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = CampaignSpec.make(
        "both", workloads=["hpl"],
        platforms=["bdw-local", {"top500": "sample:2020_06", "limit": 2}])
    res = run_campaign(spec, service=svc, tuning=SMOKE_TUNING)
    grid, *fleet = [r["meta"] for r in res.run_records]
    assert grid["kind"] == "grid" and grid["result"]["status"] == "ok"
    assert [m["kind"] for m in fleet] == ["fleet", "fleet"]
    assert all(m["result"]["predicted_tflops"] > 0 for m in fleet)


def test_campaign_cli_defaults_to_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        campaign_main(["run", "--edition-study", "2020_06", "--limit",
                       "2"])


@pytest.mark.cuda
def test_acceptance_matrix_on_the_card_matches_the_cpu(accept_result):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res, _ = accept_result
    gpu = run_campaign(accept_spec(), device="cuda")
    assert_close(_runs(gpu), _runs(res))
    d = gpu.summary["meta"]["dispatches"]
    assert d["fastsim_dispatches"] == 1 and d["stepsim_dispatches"] == 1


# --------------------------------------------------- spec layer (port)

def test_spec_json_round_trip_exact():
    spec = accept_spec()
    assert CampaignSpec.from_json(spec.to_json()) == spec
    assert CampaignSpec.from_dict(json.loads(spec.to_json())) == spec


def test_spec_normalization_orders_axes_and_freezes():
    a = CampaignSpec.make("n", workloads=["hpl"], platforms=["frontera"],
                          axes={"nb": [128, 192], "N": [2048]})
    b = CampaignSpec.make("n", workloads=["hpl"], platforms=["frontera"],
                          axes={"N": [2048], "nb": (128, 192)})
    assert a == b and hash(a) == hash(b)
    assert [k for k, _ in a.axes] == ["N", "nb"]


def test_bare_kind_name_resolves_to_default_spec():
    spec = CampaignSpec.make("d", workloads=["transformer"],
                             platforms=["tpu-v5e-pod"])
    assert dict(spec.workloads[0].params)["num_layers"] >= 1


def test_selector_needs_exactly_one_source():
    with pytest.raises(ValueError, match="exactly one"):
        PlatformSelector()
    with pytest.raises(ValueError, match="exactly one"):
        PlatformSelector(registry="frontera", top500="sample:2020_06")
    with pytest.raises(ValueError, match="top500 selectors only"):
        PlatformSelector(registry="frontera", edition="x")


def test_selector_edition_label_defaults():
    assert PlatformSelector(top500="sample:2020_11").edition_label() \
        == "2020_11"
    assert PlatformSelector(top500="/data/nov.csv").edition_label() \
        == "nov"
    assert PlatformSelector(top500="sample:2020_11",
                            edition="late").edition_label() == "late"


@pytest.mark.parametrize("kw,match", [
    (dict(workloads=["hpll"], platforms=["frontera"]),
     r"unknown workload kind 'hpll'; did you mean: hpl\?"),
    (dict(workloads=["hpl"], platforms=["fronterra"]),
     r"unknown platform 'fronterra'; did you mean: frontera"),
    (dict(workloads=["hpl"], platforms=["frontera"], axes={"nbb": [128]}),
     r"axis key 'nbb' .*did you mean: nb\?"),
], ids=["workload", "platform", "axis"])
def test_unknown_names_hint_close_matches(kw, match):
    with pytest.raises(ValueError, match=match):
        CampaignSpec.make("bad", **kw).validate()


def test_axis_key_legal_when_any_workload_knows_it():
    spec = CampaignSpec.make(
        "mixed", workloads=["hpl", "transformer"],
        platforms=["tpu-v5e-pod"], axes={"num_layers": [2, 4]})
    spec.validate()
    m = expand(spec)
    hpl = [c for c in m.grid_cases if c.workload.kind == "hpl"]
    tf = [c for c in m.grid_cases if c.workload.kind == "transformer"]
    assert len(hpl) == 1 and len(tf) == 2
    assert all(c.overrides for c in tf) and not hpl[0].overrides


def test_budget_caps_expansion():
    with pytest.raises(ValueError, match="over budget max_runs=10"):
        expand(accept_spec(max_runs=10))
    assert Budget().max_runs == 4096
    with pytest.raises(ValueError, match=">= 1"):
        Budget(max_runs=0)


def test_spec_load_from_file(tmp_path):
    spec = accept_spec()
    p = tmp_path / "spec.json"
    p.write_text(spec.to_json())
    assert CampaignSpec.load(p) == spec


# ------------------------------------------------------------ expansion

def test_expand_is_deterministic():
    m1, m2 = expand(accept_spec()), expand(accept_spec())
    assert [c.key for c in m1.cases] == [c.key for c in m2.cases]
    assert m1.cases == m2.cases
    assert len(m1.grid_cases) == 36
    assert [c.index for c in m1.cases] == list(range(len(m1.cases)))


def test_expand_reseeds_faults_per_seed_axis():
    faulted = [c for c in expand(accept_spec()).grid_cases
               if c.fault is not None]
    assert faulted and all(c.fault.seed == c.seed for c in faulted)
    assert {c.fault.seed for c in faulted} == {0, 1}


def test_expand_skips_incompatible_cells_leniently():
    spec = CampaignSpec.make("skew", workloads=["hpl", "transformer"],
                             platforms=["frontera", "tpu-v5e-pod"],
                             seeds=[0])
    m = expand(spec)
    assert any("transformer" in key and "frontera" in key
               for key, _ in m.skipped)
    assert all("torus or multipod" in reason for _, reason in m.skipped)
    kinds = {(c.workload.kind, c.platform) for c in m.grid_cases}
    assert ("transformer", "frontera") not in kinds
    assert ("hpl", "frontera") in kinds
    with pytest.raises(ValueError, match="torus or multipod"):
        expand(spec, strict=True)


def test_machine_key_strips_list_position_prefix():
    assert machine_key("r017-selene") == "selene"
    assert machine_key("r1017-selene") == "selene"
    assert machine_key("frontera") == "frontera"


# ------------------------------------------------- execution (port)

def test_acceptance_matrix_journals_one_line_per_run(accept_result):
    res, journal = accept_result
    runs = [json.loads(l) for l in journal.read_text().splitlines() if l]
    assert len(runs) == 36 + 1
    kinds = [r["kind"] for r in runs]
    assert kinds.count("campaign_run") == 36
    assert kinds[-1] == "campaign_summary"
    for r in runs[:-1]:
        meta = r["meta"]
        assert meta["campaign"] == "accept"
        assert meta["result"]["status"] != "error"
        assert meta["result"]["time_s"] > 0
        kind = meta["workload"]["kind"]
        assert meta["result"]["tflops" if kind == "hpl"
                              else "tokens_per_s"] > 0


def test_faulted_runs_are_slower_than_clean(accept_result):
    res, _ = accept_result
    by_key = {r["meta"]["cell"]: r["meta"] for r in res.run_records}
    slower = checked = 0
    for key, meta in by_key.items():
        clean = by_key.get(key.replace("f1", "f0"))
        if meta["fault"] is None or clean is None \
                or meta["workload"]["kind"] != "hpl":
            continue
        checked += 1
        slower += (meta["result"]["time_s"]
                   >= clean["result"]["time_s"] - 1e-12)
    assert checked and slower == checked


def test_same_spec_gives_byte_equal_run_lines(accept_result):
    res, _ = accept_result
    res2 = run_campaign(accept_spec(), device=CPU)
    l1 = [l for l in res.lines() if '"campaign_run"' in l]
    l2 = [l for l in res2.lines() if '"campaign_run"' in l]
    assert l1 == l2
    s1, s2 = dict(res.summary["meta"]), dict(res2.summary["meta"])
    s1.pop("wall_s"), s2.pop("wall_s")
    d1, d2 = s1.pop("dispatches"), s2.pop("dispatches")
    assert s1 == s2
    for k in ("fastsim_dispatches", "stepsim_dispatches", "serve_sweeps"):
        assert d1[k] == d2[k]


def test_rerun_against_warm_cached_service_is_all_hits(accept_result):
    res, _ = accept_result
    svc = PredictionService(cache=True, device=CPU)
    first = run_campaign(accept_spec(), service=svc, device=CPU)
    second = run_campaign(accept_spec(), service=svc, device=CPU)
    d1 = first.summary["meta"]["dispatches"]
    d2 = second.summary["meta"]["dispatches"]
    grid = first.summary["meta"]["grid_runs"]
    assert d1["cache_hits"] == 0 and d1["cache_misses"] == grid
    assert d2["cache_hits"] == grid and d2["cache_misses"] == 0
    assert d2["serve_sweeps"] == 0
    assert d2["fastsim_dispatches"] == 0 == d2["stepsim_dispatches"]
    warm = [l for l in second.lines() if '"campaign_run"' in l]
    cold = [l for l in first.lines() if '"campaign_run"' in l]
    base = [l for l in res.lines() if '"campaign_run"' in l]
    assert warm == cold == base


def test_strict_run_raises_on_bad_cell():
    spec = CampaignSpec.make("badcell", **BAD_CELL)
    rec = run_campaign(spec, device=CPU).run_records[0]["meta"]["result"]
    assert rec["status"] == "error" and "fail_stop" in rec["error"]
    with pytest.raises(ValueError, match="fail_stop"):
        run_campaign(spec, strict=True, device=CPU)


def test_dispatch_counts_read_the_compile_counters():
    snap = {"counters": {
        'fastsim.compile_misses{bucket="16x64x128"}': 1.0,
        'fastsim.compile_hits{bucket="32x4x4"}': 2.0,
        'stepsim.compile_hits{bucket="step"}': 1.0,
        "serve.sweeps": 2.0, "serve.cache_hits": 3.0}}
    assert dispatch_counts(snap) == {
        "fastsim_compiles": 1, "fastsim_dispatches": 3,
        "stepsim_compiles": 0, "stepsim_dispatches": 1,
        "serve_sweeps": 2, "cache_hits": 3, "cache_misses": 0,
        "coalesced": 0}


# ------------------------------------------- the longitudinal TOP500 study

def test_edition_study_runs_both_fleets(drift_result):
    res, _ = drift_result
    assert sorted(res.fleet_reports) == ["2020_06", "2020_11"]
    assert len(res.matrix.fleet_cases) == 16
    for rec in res.run_records:
        meta = rec["meta"]
        assert meta["kind"] == "fleet"
        assert meta["edition"] in ("2020_06", "2020_11")
        assert meta["machine"] == machine_key(meta["platform"])
        assert meta["result"]["published_tflops"] > 0
    eds = res.summary["meta"]["editions"]
    assert eds["2020_06"]["calibration_factors"]
    assert all(e["compiles"] <= 1 for e in eds.values())


def test_drift_report_has_machine_and_factor_drift(drift_result):
    res, _ = drift_result
    drift = campaign_report(res.records)["drift"]
    assert drift["from"] == "2020_06" and drift["to"] == "2020_11"
    by_machine = {d["machine"]: d for d in drift["machines"]}
    fugaku = by_machine["fugaku"]
    assert fugaku["published_drift"] == pytest.approx(0.0637, abs=0.01)
    assert fugaku["predicted_drift"] > 0.0
    assert by_machine["selene"]["predicted_drift"] > 0.5
    assert "juwels-booster-module" in drift["appeared"]
    assert "tianhe-2a" in by_machine
    fams = {f["family"]: f for f in drift["calibration_factors"]}
    assert fams["infiniband"]["drift"] is not None


def test_drift_render_mentions_both_editions(drift_result):
    res, _ = drift_result
    report = campaign_report(res.records)
    md, txt = render_markdown(report), render_text(report)
    for out in (md, txt):
        assert "2020_06 -> 2020_11" in out and "fugaku" in out
    assert "## Calibration-factor drift" in md
    assert "CALIBRATION-FACTOR DRIFT" in txt
    assert md.startswith("# Campaign report")


# --------------------------------------------------- merge / report / CLI

def test_merge_tolerates_torn_journal(tmp_path, accept_result):
    res, journal = accept_result
    torn = tmp_path / "torn.ndjson"
    torn.write_text(journal.read_text() + '{"kind": "campaign_ru')
    merged = merge_journals([journal, torn])
    meta = merged[-1]["meta"]
    assert merged[-1]["kind"] == "campaign_merged"
    assert meta["n_runs"] == 72 and meta["n_summaries"] == 2
    assert meta["dispatches"]["serve_sweeps"] == 4
    with pytest.raises(ValueError, match="line 38"):
        merge_journals([torn], strict=True)


def test_csv_has_one_row_per_run(tmp_path, accept_result):
    res, _ = accept_result
    path = tmp_path / "runs.csv"
    assert write_csv(res.records, path) == 36
    lines = path.read_text().splitlines()
    assert len(lines) == 37 and lines[0].startswith("campaign,run,cell")


def test_cli_run_merge_report_round_trip(tmp_path, capsys):
    spec = CampaignSpec.make("cli", workloads=["hpl"],
                             platforms=["bdw-local"], axes={"N": [1536]},
                             seeds=[0, 1])
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(spec.to_json())
    j1 = tmp_path / "a.ndjson"
    assert campaign_main(["run", str(spec_path), "--journal", str(j1),
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "CAMPAIGN REPORT: cli" in out and "bdw-local" in out
    merged = tmp_path / "merged.ndjson"
    assert campaign_main(["merge", str(j1), str(j1),
                          "--out", str(merged)]) == 0
    rep_json, rep_csv = tmp_path / "report.json", tmp_path / "runs.csv"
    rep_md = tmp_path / "report.md"
    assert campaign_main(["report", str(merged), "--json", str(rep_json),
                          "--csv", str(rep_csv), "--md", str(rep_md)]) == 0
    capsys.readouterr()
    assert json.loads(rep_json.read_text())["n_runs"] == 4
    assert rep_csv.read_text().count("\n") == 5
    assert rep_md.read_text().startswith("# Campaign report")


def test_cli_run_without_spec_errors(capsys):
    assert campaign_main(["run", "--device", "cpu"]) == 2
    assert "need a spec file" in capsys.readouterr().err
