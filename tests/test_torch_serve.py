"""Parity of the port's prediction services (``repro_torch.serve``: the
result cache, ``PredictionService``, ``HPLPredictionService``, the warm
pool and lane sharding) with the JAX reference, on the CPU.

Results are ``sweep_hpl``/``sweep_step`` answers underneath: within 1e-12
relative of the reference's.  What the service adds on the host is
compared with ``==``: ``request_key`` digests, ``stats``, dispatch and
compile counts, error records, fallback reasons, the DES breakdowns
(copied Python: bit-identical) and the serving counters.  The compile
counter sequence (a warm pool, a repeat, two waves) runs in a fresh state
of each package.  The reference runs once per module in a child
interpreter (``torch_reference.run_reference``); its own serving cases
(``tests/test_serve_cache.py``, the serving cases of
``test_workloads.py``, ``test_faults.py``, ``test_scale.py``,
``test_top500.py`` and ``test_obs.py``) are held on the port as well,
with ``device="cpu"``.  Deadline cases use ``timeout_s=1e-9``, never a
wall-clock race.
"""
import ast
import dataclasses
import importlib
import json
import os

import pytest
import torch

from repro_torch.core import fastsim
from repro_torch.faults import FaultSpec
from repro_torch.obs import (COUNT_BUCKETS, NULL_METRICS, MetricsRegistry,
                             global_metrics, validate_prometheus_text)
from repro_torch.platforms import get_platform, register, unregister
from repro_torch.scale import RegionSpec
from repro_torch.serve import (HPLPredictionService, PredictionService,
                               PredictRequest, ResultCache, WorkloadRequest,
                               as_result_cache, predict_top500, request_key,
                               warm)
from repro_torch.serve.cache import platform_digest, spec_digest
from repro_torch.top500 import FleetTuning, sample_list_path
from repro_torch.workloads import HPLFastModel, get_workload, stepsim
from repro_torch.campaign.exec import dispatch_counts
from torch_reference import ROOT, assert_close, run_reference

CPU = "cpu"
SMOKE_TUNING = FleetTuning(max_ranks=256, panels_cap=2048)
HPL_SMALL = dict(N=1536, nb=128, P=2, Q=2, lookahead=0)
HPL_FAULT = dict(N=1536, nb=128, P=2, Q=4, lookahead=0)
TF_SMALL = {"mesh": [2, 4], "num_layers": 2}
STRAGGLER = FaultSpec.straggler(rank=0, slowdown=1.5)
ACCEPTANCE = (FaultSpec.straggler(rank=1, slowdown=2.0, seed=7)
              + FaultSpec.degraded_links(0.05, factor=0.5, seed=7))

#: the mixed wave ``chip_smoke.py`` serves: HPL on three buckets, the
#: transformer on two fabrics, a straggler and one DES breakdown
WAVE = [
    {"rid": 0, "platform": "bdw-local"},
    {"rid": 1, "platform": "tpu-v5e-pod"},
    {"rid": 2, "platform": "syn-mp-2pod-v5e"},
    {"rid": 3, "workload": "transformer", "platform": "tpu-v5e-pod"},
    {"rid": 4, "workload": "transformer",
     "platform": "syn-torus-fugaku-4k"},
    {"rid": 5, "platform": "bdw-local", "faults": STRAGGLER.to_dict()},
    {"rid": 6, "platform": "bdw-local", "breakdown": True},
]
#: requests whose content-addressed keys must equal the reference's
KEYS = [
    {"rid": 0, "platform": "frontera", "params": {"N": 2048}},
    {"rid": 1, "platform": "frontera", "params": {"N": 2048},
     "faults": STRAGGLER.to_dict()},
    {"rid": 2, "platform": "frontera", "params": {"N": 2048},
     "regions": 12},
    {"rid": 3, "platform": "bdw-local", "breakdown": True},
    {"rid": 4, "workload": "transformer", "platform": "tpu-v5e-pod"},
    {"rid": 5, "workload": "transformer", "platform": "tpu-v5e-pod",
     "params": TF_SMALL, "faults": ACCEPTANCE.to_dict()},
    {"rid": 6, "platform": "bdw-local", "params": HPL_SMALL},
    {"rid": 7, "platform": "syn-mp-2pod-v5e"},
]
ROUTES = [
    {"rid": 0, "platform": "tpu-v5e-pod"},
    {"rid": 1, "workload": "transformer", "platform": "tpu-v5e-pod"},
    {"rid": 2, "platform": "frontera", "params": {"N": 1536}},
]
REGION = {"rid": 0, "platform": "frontera", "breakdown": True,
          "regions": 12, "params": {"N": 4096, "nb": 128, "P": 2, "Q": 4,
                                    "lookahead": 0}}
FAULTED = [
    {"rid": 0, "platform": "bdw-local", "params": HPL_FAULT},
    {"rid": 1, "platform": "bdw-local", "params": HPL_FAULT,
     "faults": ACCEPTANCE.to_dict()},
]
DEADLINE = {"rid": 0, "workload": "transformer", "platform": "tpu-v5e-pod",
            "params": {"mesh": [4, 8], "num_layers": 8}, "breakdown": True,
            "timeout_s": 1e-9}
RANK_GUARD = {"rid": 1, "workload": "transformer",
              "platform": "syn-torus-fugaku-4k", "breakdown": True,
              "timeout_s": 60.0}
ISOLATED = [
    {"rid": 0, "platform": "bdw-local", "params": HPL_SMALL},
    {"rid": 1, "platform": "nope"},
    {"rid": 2, "workload": "transformer", "platform": "tpu-v5e-pod",
     "params": TF_SMALL},
]
#: the acceptance wave of the serving metrics: a retry (the first HPL
#: dispatch fails once), a deadline fallback and an isolated error
METRICS_WAVE = [
    {"rid": 0, "platform": "bdw-local", "params": HPL_SMALL},
    {"rid": 1, "workload": "transformer", "platform": "tpu-v5e-pod",
     "params": TF_SMALL, "breakdown": True, "timeout_s": 1e-9},
    {"rid": 2, "platform": "nope"},
]
PLATFORMS = ["bdw-local", "tpu-v5e-pod", "syn-mp-2pod-v5e"]

CHILD = r"""
import json
from repro.core import fastsim
from repro.faults import FaultSpec
from repro.obs import global_metrics
from repro.serve import (HPLPredictionService, PredictionService,
                         WorkloadRequest)
from repro.top500 import FleetTuning, sample_list_path
from repro.workloads import HPLFastModel, stepsim
from repro.campaign.exec import dispatch_counts


def mk(d):
    f = d.get("faults")
    return WorkloadRequest(
        rid=d["rid"], workload=d.get("workload", "hpl"),
        platform=d["platform"], params=dict(d.get("params", {})),
        faults=None if f is None else FaultSpec.from_dict(f),
        breakdown=d.get("breakdown", False), regions=d.get("regions"),
        timeout_s=d.get("timeout_s"))


def plain(x):
    return json.loads(json.dumps(x))


def wave(reqs, svc, **kw):
    out = svc.predict_batch([mk(d) for d in reqs], **kw)
    return {str(k): v for k, v in out.items()}


def cold():
    fastsim._compiled.cache_clear()           # cold process state
    stepsim._compiled.cache_clear()


def counter_sequence(svc):
    cold()
    out = []

    def compiles():
        return fastsim.trace_count() + stepsim.trace_count()

    with global_metrics(svc.metrics):
        for step in PAYLOAD["sequence"]:
            if step[0] == "warm":
                out.append(svc.warm(step[1], step[2], count=step[3]))
            else:
                pre = compiles()
                wave(step[1], svc)
                out.append(compiles() - pre)
    return out, dispatch_counts(svc.metrics.snapshot())


svc = PredictionService(cache=True)
OUT["wave"] = plain(wave(PAYLOAD["wave"], svc))
OUT["wave_stats"] = dict(svc.stats)
OUT["cached"] = plain(wave(PAYLOAD["wave"], svc))
OUT["cached_stats"] = dict(svc.stats)
svc = PredictionService(cache=True)
OUT["coalesced"] = plain(wave([dict(PAYLOAD["wave"][0], rid=i)
                               for i in range(8)], svc))
OUT["coalesced_stats"] = dict(svc.stats)
svc = PredictionService(cache=True)
keys = []
for d in PAYLOAD["keys"]:
    req = mk(d)
    svc._resolve(req)
    keys.append(svc._cache_key(req))
OUT["keys"] = keys
OUT["sequence"] = counter_sequence(PredictionService())

svc = PredictionService()
OUT["routes"] = plain(wave(PAYLOAD["routes"], svc))
OUT["routes_stats"] = dict(svc.stats)
OUT["region"] = plain(wave([PAYLOAD["region"]], PredictionService()))
OUT["faulted"] = plain(wave(PAYLOAD["faulted"], PredictionService()))
svc = PredictionService()
OUT["deadline"] = plain(wave([PAYLOAD["deadline"], PAYLOAD["rank_guard"]],
                             svc))
OUT["deadline_stats"] = dict(svc.stats)
svc = PredictionService()
OUT["isolated"] = plain(wave(PAYLOAD["isolated"], svc, isolate_errors=True))
OUT["isolated_stats"] = dict(svc.stats)

svc = PredictionService(backoff_s=0.001)
orig = HPLFastModel.sweep_models.__func__
state = {"n": 0}


def flaky(cls, models):
    state["n"] += 1
    if state["n"] == 1:
        raise RuntimeError("transient hiccup")
    return orig(cls, models)


HPLFastModel.sweep_models = classmethod(flaky)
try:
    OUT["metrics_wave"] = plain(wave(PAYLOAD["metrics_wave"], svc,
                                     isolate_errors=True))
finally:
    HPLFastModel.sweep_models = classmethod(orig)
OUT["metrics_stats"] = dict(svc.stats)
snap = svc.metrics.snapshot()
OUT["metrics_counters"] = snap["counters"]
OUT["metrics_hist_counts"] = {k: v["count"]
                              for k, v in snap["histograms"].items()}

cold()
hsvc = HPLPredictionService()
OUT["platforms"] = plain(hsvc.predict_platforms(PAYLOAD["platforms"]))
OUT["platforms_stats"] = dict(hsvc.stats)
cold()
hsvc = HPLPredictionService()
OUT["top500"] = plain(hsvc.predict_top500(
    sample_list_path(), tuning=FleetTuning(**PAYLOAD["tuning"])))
OUT["top500_stats"] = dict(hsvc.stats)
"""

#: warm hpl + transformer on tpu-v5e-pod (4 each), the same again, a
#: 4 + 4 wave, a wave of 3 HPL requests; then a warm at two lanes and a
#: 4-lane wave of the same bucket behind it, which a counter blind to the
#: lane count would miss
SEQUENCE = [
    ["warm", ["hpl", "transformer"], ["tpu-v5e-pod"], 4],
    ["warm", ["hpl", "transformer"], ["tpu-v5e-pod"], 4],
    ["wave", [{"rid": i, "workload": w, "platform": "tpu-v5e-pod"}
              for i, w in enumerate(["hpl", "transformer"] * 4)]],
    ["wave", [{"rid": i, "platform": "tpu-v5e-pod"} for i in range(3)]],
    ["warm", ["hpl"], ["bdw-local"], 2],
    ["wave", [{"rid": i, "platform": "bdw-local"} for i in range(4)]],
]


def _mk(d):
    f = d.get("faults")
    return WorkloadRequest(
        rid=d["rid"], workload=d.get("workload", "hpl"),
        platform=d["platform"], params=dict(d.get("params", {})),
        faults=None if f is None else FaultSpec.from_dict(f),
        breakdown=d.get("breakdown", False), regions=d.get("regions"),
        timeout_s=d.get("timeout_s"))


def _plain(x):
    return json.loads(json.dumps(x))


def _wave(reqs, svc, **kw):
    out = svc.predict_batch([_mk(d) for d in reqs], **kw)
    return _plain({str(k): v for k, v in out.items()})


def _cold():
    """The port's compile state as in a fresh process."""
    fastsim._compiled.cache_clear()
    fastsim._SHAPES_SEEN.clear()
    stepsim._SHAPES_SEEN.clear()


def _counter_sequence(svc):
    _cold()
    out = []

    def compiles():
        return fastsim.trace_count() + stepsim.trace_count()

    with global_metrics(svc.metrics):
        for step in SEQUENCE:
            if step[0] == "warm":
                out.append(svc.warm(step[1], step[2], count=step[3]))
            else:
                pre = compiles()
                _wave(step[1], svc)
                out.append(compiles() - pre)
    return _plain([out, dispatch_counts(svc.metrics.snapshot())])


@pytest.fixture(scope="module")
def ref():
    return run_reference(CHILD, {
        "wave": WAVE, "keys": KEYS, "sequence": SEQUENCE, "routes": ROUTES,
        "region": REGION, "faulted": FAULTED, "deadline": DEADLINE,
        "rank_guard": RANK_GUARD, "isolated": ISOLATED,
        "metrics_wave": METRICS_WAVE, "platforms": PLATFORMS,
        "tuning": dataclasses.asdict(SMOKE_TUNING)})


@pytest.fixture(scope="module")
def served():
    """The mixed wave on a cached CPU service, then the same wave again
    (all hits), and 8 identical requests on a fresh cached service."""
    svc = PredictionService(cache=True, device=CPU)
    out = {"wave": _wave(WAVE, svc), "wave_stats": dict(svc.stats)}
    out["cached"] = _wave(WAVE, svc)
    out["cached_stats"] = dict(svc.stats)
    svc = PredictionService(cache=True, device=CPU)
    out["coalesced"] = _wave([dict(WAVE[0], rid=i) for i in range(8)], svc)
    out["coalesced_stats"] = dict(svc.stats)
    return out


# ------------------------------------------------- parity: the mixed wave

def test_mixed_wave_matches_reference(ref, served):
    assert_close(served["wave"], ref["wave"])
    assert "breakdown" in served["wave"]["6"]
    assert served["wave"]["6"]["breakdown"] == ref["wave"]["6"]["breakdown"]
    assert served["wave"]["5"]["time_s"] > served["wave"]["0"]["time_s"]


def test_mixed_wave_stats_equal_reference(ref, served):
    stats = served["wave_stats"]
    assert stats == ref["wave_stats"]
    assert stats["sweeps"] == 2 and stats["des_breakdowns"] == 1
    assert stats["retries"] == stats["errors"] == stats["fallbacks"] == 0
    assert not any(r.get("degraded") for r in served["wave"].values())


def test_resubmitted_wave_is_all_hits(ref, served):
    assert served["cached_stats"] == ref["cached_stats"]
    assert served["cached_stats"]["cache_hits"] == len(WAVE)
    assert served["cached_stats"]["sweeps"] == 2          # no new sweep
    for rid, hit in served["cached"].items():
        assert hit.pop("cached") is True
        assert hit == served["wave"][rid]
    assert_close(served["cached"], {k: {f: v for f, v in r.items()
                                        if f != "cached"}
                                    for k, r in ref["cached"].items()})


def test_eight_identical_requests_coalesce(ref, served):
    assert served["coalesced_stats"] == ref["coalesced_stats"]
    assert served["coalesced_stats"]["coalesced"] == 7
    assert_close(served["coalesced"], ref["coalesced"])
    assert len({json.dumps(r, sort_keys=True)
                for r in served["coalesced"].values()}) == 1


@pytest.mark.parametrize("i", range(len(KEYS)))
def test_request_key_equals_reference(ref, i):
    svc = PredictionService(cache=True, device=CPU)
    req = _mk(KEYS[i])
    svc._resolve(req)
    assert svc._cache_key(req) == ref["keys"][i]


def test_compile_counter_sequence_equals_reference(ref):
    got = _counter_sequence(PredictionService(device=CPU))
    assert got == ref["sequence"]
    warm1, warm2, wave44, wave3, warm_two, wave4 = got[0]
    assert warm1["compiles"] > 0 and warm1["dispatches"] == 2
    assert warm2["compiles"] == 0 and wave44 == 0 and wave3 == 0
    assert warm_two["compiles"] == 1 and wave4 == 1


# ------------------------------------- parity: the reference's serving cases

def test_routes_mixed_workloads_match_reference(ref):
    svc = PredictionService(device=CPU)
    out = _wave(ROUTES, svc)
    assert_close(out, ref["routes"])
    assert dict(svc.stats) == ref["routes_stats"]
    assert svc.stats["batches"] == 1 and svc.stats["sweeps"] == 2
    plat = get_platform("tpu-v5e-pod")
    assert out["0"]["time_s"] == get_workload("hpl").predict(
        plat, device=CPU)["time_s"]
    assert out["1"]["step_s"] == get_workload("transformer").predict(
        plat, device=CPU)["step_s"]


def test_region_breakdown_matches_reference(ref):
    out = _wave([REGION], PredictionService(device=CPU))
    assert_close(out, ref["region"])
    assert out["0"]["region_approx"] and out["0"]["breakdown"][
        "region_approx"]
    assert out["0"]["breakdown"] == ref["region"]["0"]["breakdown"]


def test_faulted_requests_match_reference(ref):
    out = _wave(FAULTED, PredictionService(device=CPU))
    assert_close(out, ref["faulted"])
    assert out["1"]["time_s"] > out["0"]["time_s"]


def test_deadline_and_rank_guard_fallbacks_match_reference(ref):
    svc = PredictionService(device=CPU)
    out = _wave([DEADLINE, RANK_GUARD], svc)
    want = ref["deadline"]
    for got in (out, want):
        assert got["0"].pop("fallback_reason").startswith(
            ("deadline_exceeded", "wall_deadline"))
    assert_close(out, want)
    assert out["0"]["degraded"] and "breakdown" not in out["0"]
    assert out["1"]["fallback_reason"].startswith("max_des_ranks")
    assert dict(svc.stats) == ref["deadline_stats"]


def test_isolated_errors_match_reference(ref):
    svc = PredictionService(device=CPU)
    out = _wave(ISOLATED, svc, isolate_errors=True)
    assert_close(out, ref["isolated"])
    assert out["1"]["status"] == "error"
    assert out["1"]["error_type"] == "KeyError"
    assert dict(svc.stats) == ref["isolated_stats"]


def test_serving_counters_match_reference(ref, monkeypatch):
    svc = PredictionService(backoff_s=0.001, device=CPU)
    orig = HPLFastModel.sweep_models.__func__
    state = {"n": 0}

    def flaky(cls, models, **kw):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("transient hiccup")
        return orig(cls, models, **kw)

    monkeypatch.setattr(HPLFastModel, "sweep_models", classmethod(flaky))
    out = _wave(METRICS_WAVE, svc, isolate_errors=True)
    monkeypatch.undo()
    want = ref["metrics_wave"]
    for got in (out, want):
        assert got["1"].pop("fallback_reason").startswith(
            ("deadline_exceeded", "wall_deadline"))
    assert_close(out, want)
    assert dict(svc.stats) == ref["metrics_stats"]
    snap = svc.metrics.snapshot()
    assert snap["counters"] == ref["metrics_counters"]
    assert {k: v["count"] for k, v in snap["histograms"].items()} == \
        ref["metrics_hist_counts"]


def test_predict_platforms_matches_reference(ref):
    _cold()
    svc = HPLPredictionService(device=CPU)
    out = _plain(svc.predict_platforms(PLATFORMS))
    assert_close(out, ref["platforms"])
    assert svc.stats == ref["platforms_stats"]


def test_predict_top500_matches_reference(ref):
    _cold()
    svc = HPLPredictionService(device=CPU)
    out = _plain(svc.predict_top500(sample_list_path(),
                                    tuning=SMOKE_TUNING))
    assert_close(out, ref["top500"])
    assert svc.stats == ref["top500_stats"]
    assert out["machines"] and out["compiles"] <= 1
    assert svc.stats["scenarios"] >= 50


# --------------------------------------------------------- devices

@pytest.mark.parametrize("make", [
    lambda: PredictionService(),
    lambda: PredictionService(device="cuda", cache=True, shard=True),
    lambda: HPLPredictionService(),
    lambda: warm(["hpl"], ["bdw-local"]),
    lambda: predict_top500(sample_list_path(), tuning=SMOKE_TUNING),
], ids=["PredictionService", "PredictionService_cached",
        "HPLPredictionService", "warm", "predict_top500"])
def test_cuda_service_without_a_card_raises_at_construction(monkeypatch,
                                                             make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_missing_card_is_never_retried_or_isolated(monkeypatch):
    """The device is resolved before a request exists: nothing reaches
    the retry loop or ``isolate_errors``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(PredictionService, "_dispatch",
                        lambda self, *a: calls.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictionService(device="cuda", retries=5).predict_batch(
            [_mk(WAVE[0])], isolate_errors=True)
    assert not calls


def test_service_device_reaches_every_sweep(monkeypatch):
    seen = []
    orig = HPLFastModel.sweep_models.__func__

    def spy(cls, models, **kw):
        seen.append(kw["device"])
        return orig(cls, models, **kw)

    monkeypatch.setattr(HPLFastModel, "sweep_models", classmethod(spy))
    svc = PredictionService(device=CPU)
    svc.predict_batch([_mk({"rid": 0, "platform": "bdw-local"})])
    svc.warm(["hpl"], ["bdw-local"])
    assert seen == [torch.device("cpu")] * 2


def test_warm_cli_runs_on_the_cpu(capsys):
    from repro_torch.serve.__main__ import main
    assert main(["warm", "--platforms", "bdw-local", "--count", "2",
                 "--device", "cpu", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["dispatches"] == 1 and report["scenarios"] == 2
    assert report["service"] == "PredictionService"


def test_warm_cli_defaults_to_cuda(monkeypatch):
    from repro_torch.serve.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["warm", "--platforms", "bdw-local"])


@pytest.mark.cuda
def test_mixed_wave_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cpu = _wave(WAVE, PredictionService(device=CPU))
    svc = PredictionService(device="cuda")
    gpu = _wave(WAVE, svc)
    assert_close(gpu, cpu)
    assert svc.stats["sweeps"] == 2 and svc.stats["des_breakdowns"] == 1


@pytest.mark.cuda
def test_cached_wave_on_the_card_is_all_hits():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    svc = PredictionService(device="cuda", cache=True)
    first = _wave(WAVE, svc)
    again = _wave(WAVE, svc)
    assert svc.stats["cache_hits"] == len(WAVE)
    for rid, hit in again.items():
        assert hit.pop("cached") is True and hit == first[rid]


# ---------------------------------------------------- the cache (port)

def _req(rid, **kw):
    kw.setdefault("workload", "hpl")
    kw.setdefault("platform", "frontera")
    kw.setdefault("params", {"N": 1536})
    return WorkloadRequest(rid=rid, **kw)


def _svc(**kw):
    return PredictionService(device=CPU, **kw)


def test_key_is_content_addressed_and_fully_sensitive():
    wl = get_workload("hpl", N=2048).spec
    plat = get_platform("frontera")
    base = request_key(wl, plat)
    assert request_key(get_workload("hpl", N=2048).spec, plat) == base
    assert request_key(get_workload("hpl", N=2049).spec, plat) != base
    assert request_key(wl, dataclasses.replace(plat, name="other")) != base
    assert request_key(wl, plat, faults=FaultSpec.straggler(rank=0)) != base
    assert request_key(wl, plat, regions=12) != base
    assert request_key(wl, plat, breakdown=True) != base
    assert request_key(wl, plat, regions=12) == \
        request_key(wl, plat, regions=RegionSpec(panels=12, warmup=2))
    f = FaultSpec.straggler(rank=1, slowdown=2.0)
    assert request_key(wl, plat, faults=f) == \
        request_key(wl, plat, faults=json.loads(f.to_json()))


def test_digests_are_stable_across_equal_instances():
    plat = get_platform("frontera")
    assert platform_digest(plat) == platform_digest(
        dataclasses.replace(plat))
    assert spec_digest(get_workload("hpl", N=4096).spec) == \
        spec_digest(get_workload("hpl", N=4096).spec)


def test_as_result_cache_normalization():
    assert as_result_cache(None) is None
    assert as_result_cache(False) is None
    assert isinstance(as_result_cache(True), ResultCache)
    assert as_result_cache(7).max_entries == 7
    rc = ResultCache()
    assert as_result_cache(rc) is rc
    with pytest.raises(TypeError):
        as_result_cache("big")
    with pytest.raises(ValueError):
        ResultCache(max_entries=0)


def test_hit_is_bit_identical_to_miss_modulo_stamp():
    svc = _svc(cache=True)
    miss = svc.predict_batch([_req(0)])[0]
    hit = svc.predict_batch([_req(1)])[1]
    assert hit.pop("cached") is True
    assert "cached" not in miss
    assert hit == miss
    assert svc.stats["cache_hits"] == 1 and svc.stats["cache_misses"] == 1


def test_breakdown_hits_skip_the_des_but_carry_the_breakdown():
    svc = _svc(cache=True)
    miss = svc.predict_batch(
        [_req(0, platform="bdw-local", breakdown=True)])[0]
    assert "breakdown" in miss and svc.stats["des_breakdowns"] == 1
    hit = svc.predict_batch(
        [_req(1, platform="bdw-local", breakdown=True)])[1]
    assert hit["breakdown"] == miss["breakdown"]
    assert svc.stats["des_breakdowns"] == 1


def test_hit_payload_mutation_does_not_poison_the_cache():
    svc = _svc(cache=True)
    svc.predict_batch([_req(0)])
    first = svc.predict_batch([_req(1)])[1]
    first["time_s"] = -1.0
    again = svc.predict_batch([_req(2)])[2]
    assert again["time_s"] != -1.0


def test_lru_eviction_is_oldest_first_and_hits_refresh():
    rc = ResultCache(max_entries=2)
    rc.put("a", {"v": 1})
    rc.put("b", {"v": 2})
    assert rc.keys() == ["a", "b"]
    assert rc.get("a") == {"v": 1}
    rc.put("c", {"v": 3})
    assert rc.keys() == ["a", "c"]
    assert rc.get("b") is None
    assert rc.stats()["evictions"] == 1


def test_service_cache_respects_max_entries():
    svc = _svc(cache=1)
    svc.predict_batch([_req(0, params={"N": 1536})])
    svc.predict_batch([_req(1, params={"N": 1920})])
    assert len(svc.cache) == 1
    svc.predict_batch([_req(2, params={"N": 1536})])
    assert svc.stats["cache_hits"] == 0


def test_platform_reregistration_invalidates_by_name():
    plat = dataclasses.replace(get_platform("frontera"),
                               name="cachetest-inval")
    register(plat)
    try:
        svc = _svc(cache=True)
        svc.predict_batch([_req(0, platform="cachetest-inval")])
        assert len(svc.cache) == 1
        register(plat, overwrite=True)
        assert len(svc.cache) == 0
        assert svc.cache.stats()["invalidations"] == 1
        svc.predict_batch([_req(1, platform="frontera"),
                           _req(2, platform="cachetest-inval")])
        assert len(svc.cache) == 2
        unregister(["cachetest-inval"])
        assert len(svc.cache) == 1
    finally:
        unregister(["cachetest-inval"])


def test_duplicate_in_flight_keys_dispatch_exactly_once():
    svc = _svc(cache=True)
    with global_metrics(svc.metrics):
        out = svc.predict_batch([_req(i) for i in range(8)])
    assert svc.stats["sweeps"] == 1 and svc.stats["coalesced"] == 7
    snap = svc.metrics.snapshot()["counters"]
    assert snap.get("fastsim.lanes_live") == 1
    assert len({repr(sorted(r.items())) for r in out.values()}) == 1


def test_coalescing_preserves_per_request_results_on_mixed_waves():
    svc = _svc(cache=True)
    out = svc.predict_batch([_req(0, params={"N": 1536}),
                             _req(1, params={"N": 1920}),
                             _req(2, params={"N": 1536}),
                             _req(3, params={"N": 1920})])
    assert out[0] == out[2] and out[1] == out[3]
    assert out[0]["time_s"] != out[1]["time_s"]
    assert svc.stats["sweeps"] == 1 and svc.stats["coalesced"] == 2


def test_dispatch_failure_caches_nothing_and_stamps_unserved(monkeypatch):
    svc = _svc(cache=True, retries=0)
    svc.predict_batch([_req(0)])

    def explode(self, model_cls, reqs):
        raise RuntimeError("backend down")
    monkeypatch.setattr(PredictionService, "_dispatch", explode)
    hit_req, fail_req = _req(1), _req(2, params={"N": 1920})
    svc.submit(hit_req)
    svc.submit(fail_req)
    with pytest.raises(RuntimeError):
        svc.flush()
    assert hit_req.result.get("cached") is True
    assert fail_req.result["status"] == "error"
    assert len(svc.cache) == 1
    monkeypatch.undo()
    out = svc.predict_batch([_req(3, params={"N": 1920})])
    assert "cached" not in out[3]


def test_budgeted_and_degraded_requests_are_never_cached():
    svc = _svc(cache=True, max_des_ranks=1)
    out = svc.predict_batch([_req(0, breakdown=True, timeout_s=60.0)])[0]
    assert out["degraded"] is True
    assert len(svc.cache) == 0
    out = svc.predict_batch([_req(1, timeout_s=60.0)])[1]
    assert "cached" not in out and len(svc.cache) == 0
    assert svc.stats["cache_hits"] == 0 == svc.stats["cache_misses"]


def test_isolated_resolution_errors_never_touch_the_cache():
    svc = _svc(cache=True)
    out = svc.predict_batch(
        [_req(0), WorkloadRequest(rid=1, workload="hpl",
                                  platform="no-such-machine")],
        isolate_errors=True)
    assert out[1]["status"] == "error"
    assert len(svc.cache) == 1


# ------------------------------------------------- warm pool, sharding

def test_warm_pool_first_wave_pays_zero_compiles():
    _cold()
    svc = _svc()
    report = svc.warm(["hpl", "transformer"], ["tpu-v5e-pod"], count=4)
    assert report["compiles"] > 0 and report["dispatches"] == 2
    assert svc.warm(["hpl", "transformer"], ["tpu-v5e-pod"],
                    count=4)["compiles"] == 0
    pre = fastsim.trace_count() + stepsim.trace_count()
    out = svc.predict_batch([
        WorkloadRequest(rid=i, workload=w, platform="tpu-v5e-pod")
        for i, w in enumerate(["hpl", "transformer"] * 4)])
    assert len(out) == 8
    assert fastsim.trace_count() + stepsim.trace_count() == pre
    snap = svc.metrics.snapshot()["counters"]
    assert snap.get("serve.warm_compiles", 0) == report["compiles"]
    assert snap.get("serve.warm_dispatches") == 4


def test_warm_can_prime_the_result_cache():
    svc = _svc(cache=True)
    svc.warm(["hpl"], ["bdw-local"], count=2, prime_cache=True)
    out = svc.predict_batch([_req(0, platform="bdw-local", params={})])
    assert out[0]["cached"] is True
    assert svc.stats["cache_misses"] == 0


def test_module_warm_reports_its_service():
    report = warm(["hpl"], ["bdw-local"], count=2, device=CPU)
    assert report["service"] == "PredictionService"
    assert report["dispatches"] == 1 and report["scenarios"] == 2


SHARD_REQS = [{"rid": i, "platform": "frontera",
               "params": {"N": 1536 + 384 * i}} for i in range(4)]


def test_shard_single_device_is_bitwise_identical():
    base = _wave(SHARD_REQS[:3], _svc())
    assert _wave(SHARD_REQS[:3], _svc(shard=True)) == base


def test_shard_lanes_fallback_is_identity():
    cpu = torch.device(CPU)
    assert fastsim._shard_lanes(8, cpu) is None           # sharding off
    with fastsim.lane_sharding(True):
        assert fastsim._shard_lanes(8, cpu) is None       # one device
        assert fastsim._shard_lanes(6, cpu, [cpu] * 4) is None
        assert fastsim._shard_lanes(8, cpu, [cpu] * 4) == [cpu] * 4
    assert fastsim.shard_device_count(CPU) == 1
    assert fastsim.set_lane_sharding(False) is False


@pytest.fixture
def four_cpus(monkeypatch):
    monkeypatch.setattr(fastsim, "_local_devices", lambda dev: [dev] * 4)


def test_forced_four_device_shard_is_bitwise_identical(four_cpus):
    base = _wave(SHARD_REQS, _svc())
    svc = _svc(shard=True)
    with global_metrics(svc.metrics):
        shard = _wave(SHARD_REQS, svc)
    assert shard == base
    c = svc.metrics.snapshot()["counters"]
    assert c.get("fastsim.sharded_dispatches", 0) >= 1
    assert svc.metrics.snapshot()["gauges"][
        "fastsim.shard_devices"]["value"] == 4.0


@pytest.mark.parametrize("mode", ["params", "batch"])
def test_four_device_split_of_each_sweep_mode_is_bitwise(four_cpus, mode):
    plat = get_platform("bdw-local")
    prm = plat.fastsim()
    prms = [dataclasses.replace(prm, link_bw=prm.link_bw * (1 + i / 8))
            for i in range(8)]
    cfg = plat.hpl_config()
    cfgs = ([cfg] * 8 if mode == "params" else
            [dataclasses.replace(cfg, N=2048 + 256 * i) for i in range(8)])
    base = fastsim.sweep_hpl(cfgs, prms, device=CPU)
    with fastsim.lane_sharding(True):
        split = fastsim.sweep_hpl(cfgs, prms, device=CPU)
    assert split == base


def test_four_device_split_of_the_step_sweep_is_bitwise(four_cpus):
    model = get_workload("transformer").fastsim_model(
        get_platform("tpu-v5e-pod"))
    grid = [dataclasses.replace(model.params, n_layers=float(2 + i))
            for i in range(6)]
    base = stepsim.sweep_step(grid, device=CPU)
    with fastsim.lane_sharding(True):
        split = stepsim.sweep_step(grid, device=CPU)
    assert split == base


def test_resolution_memo_skips_unhashable_params():
    svc = _svc()
    req = WorkloadRequest(rid=0, workload="transformer",
                          platform="tpu-v5e-pod",
                          params={"mesh": [4, 8], "num_layers": 8})
    assert svc._memo_key(req) is None
    out = svc.predict_batch([req])
    assert out[0].get("status") != "error" and "step_s" in out[0]
    assert not svc._resolve_memo


# ------------------------------------ the reference's hardening cases

def test_all_or_nothing_and_breakdown_guard():
    svc = _svc()
    with pytest.raises(KeyError, match="unknown platform"):
        svc.predict_batch([
            WorkloadRequest(rid=0, workload="hpl", platform="bdw-local"),
            WorkloadRequest(rid=1, workload="hpl", platform="nope")])
    assert not svc._queue and svc.stats["requests"] == 0
    with pytest.raises(ValueError, match="max_des_ranks"):
        svc.predict_batch([WorkloadRequest(
            rid=0, workload="transformer", platform="syn-torus-fugaku-4k",
            breakdown=True)])
    out = svc.predict_batch([WorkloadRequest(
        rid=7, workload="transformer", platform="tpu-v5e-pod",
        params={"mesh": [2, 4], "num_layers": 2}, breakdown=True)])
    assert out[7]["breakdown"]["n_ranks"] == 8
    assert svc.predict_batch([]) == {}


def test_region_guard_uses_max_region_ranks():
    params = {"N": 4096, "nb": 128, "P": 4, "Q": 4, "lookahead": 0}
    with pytest.raises(ValueError, match="max_region_ranks"):
        _svc(max_region_ranks=8).predict_batch([WorkloadRequest(
            rid=0, workload="hpl", platform="frontera", params=params,
            breakdown=True, regions=12)])
    with pytest.raises(ValueError, match="max_des_ranks"):
        _svc(max_des_ranks=8).predict_batch([WorkloadRequest(
            rid=0, workload="hpl", platform="frontera", params=params,
            breakdown=True)])


def test_isolation_leaves_the_queue_clean():
    svc = _svc()
    out = svc.predict_batch(
        [WorkloadRequest(rid=9, workload="hpl", platform="nope")],
        isolate_errors=True)
    assert out[9]["status"] == "error" and not svc._queue
    assert svc.predict_batch([], isolate_errors=True) == {}
    assert svc.predict_batch([]) == {}


def test_retries_transient_backend_errors(monkeypatch):
    orig = HPLFastModel.sweep_models.__func__
    calls = {"n": 0}

    def flaky(cls, models, **kw):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient backend glitch")
        return orig(cls, models, **kw)

    monkeypatch.setattr(HPLFastModel, "sweep_models", classmethod(flaky))
    svc = _svc(backoff_s=1e-4)
    out = svc.predict_batch([_mk({"rid": 0, "platform": "bdw-local"})])
    assert "time_s" in out[0]
    assert calls["n"] == 3 and svc.stats["retries"] == 2
    calls["n"] = -100
    with pytest.raises(RuntimeError, match="transient"):
        svc.predict_batch([_mk({"rid": 1, "platform": "bdw-local"})])
    monkeypatch.undo()
    svc2 = _svc()
    with pytest.raises(KeyError):
        svc2.predict_batch([WorkloadRequest(rid=0, workload="hpl",
                                            platform="nope")])
    assert svc2.stats["retries"] == 0


def test_results_bit_identical_with_metrics_off():
    reqs = [{"rid": 0, "platform": "bdw-local", "params": HPL_SMALL},
            {"rid": 1, "workload": "transformer", "platform": "tpu-v5e-pod",
             "params": TF_SMALL},
            {"rid": 2, "platform": "bdw-local", "params": HPL_SMALL,
             "breakdown": True}]
    assert _wave(reqs, _svc()) == _wave(reqs, _svc(metrics=NULL_METRICS))


def test_wave_metrics_and_latency():
    svc = _svc()
    svc.predict_batch([_mk({"rid": i, "platform": "bdw-local",
                            "params": HPL_SMALL}) for i in range(3)])
    snap = svc.metrics.snapshot()
    c = snap["counters"]
    assert c["serve.requests"] == c["serve.scenarios"] == 3.0
    assert c["serve.batches"] == 1.0 and c["serve.sweeps"] == 1.0
    assert snap["gauges"]["serve.queue_depth"]["max"] == 3.0
    assert snap["gauges"]["serve.queue_depth"]["value"] == 0.0
    ws = snap["histograms"]["serve.wave_size"]
    assert ws["count"] == 1 and ws["sum"] == 3.0
    assert ws["bounds"] == list(COUNT_BUCKETS)
    assert snap["histograms"]["serve.request_latency_s"]["count"] == 3


def test_hardening_paths_visible_in_prometheus_and_manifest(monkeypatch):
    svc = _svc(backoff_s=0.001)
    orig = HPLFastModel.sweep_models.__func__
    state = {"n": 0}

    def flaky(cls, models, **kw):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("transient hiccup")
        return orig(cls, models, **kw)

    monkeypatch.setattr(HPLFastModel, "sweep_models", classmethod(flaky))
    out = svc.predict_batch([_mk(d) for d in METRICS_WAVE],
                            isolate_errors=True)
    assert out[0]["status"] == "ok"
    assert out[1]["degraded"] and out[2]["status"] == "error"
    samples = {name: value for name, labels, value in
               validate_prometheus_text(svc.prometheus())}
    for key in ("retries", "deadline_fallbacks", "errors_isolated"):
        assert samples[f"serve_{key}_total"] > 0
    rec = json.loads(svc.manifest())
    assert rec["metrics"]["counters"]["serve.retries"] > 0
    assert rec["meta"]["service"] == "PredictionService"
    assert rec["meta"]["stats"] == svc.stats


def test_rank_guard_trip_counter():
    svc = _svc()
    out = svc.predict_batch([_mk(RANK_GUARD)])
    assert out[1]["degraded"]
    c = svc.metrics.snapshot()["counters"]
    assert c["serve.rank_guard_trips"] == 1.0
    assert c["serve.fallbacks"] == 1.0
    assert "serve.deadline_fallbacks" not in c


def test_dispatch_failure_stamps_wave_and_keeps_queue_clean(monkeypatch):
    svc = _svc(retries=0)

    def broken(cls, models, **kw):
        raise RuntimeError("backend down")

    reqs = [_mk({"rid": 0, "platform": "bdw-local", "params": HPL_SMALL}),
            _mk({"rid": 1, "workload": "transformer",
                 "platform": "tpu-v5e-pod", "params": TF_SMALL})]
    monkeypatch.setattr(HPLFastModel, "sweep_models", classmethod(broken))
    with pytest.raises(RuntimeError, match="backend down"):
        svc.predict_batch(reqs)
    monkeypatch.undo()
    assert svc._queue == []
    for r in reqs:
        assert r.result["status"] == "error"
        assert r.result["error_type"] == "RuntimeError"
    c = svc.metrics.snapshot()["counters"]
    assert c["serve.dispatch_failures"] == 1.0
    out = svc.predict_batch([_mk({"rid": 9, "platform": "bdw-local",
                                  "params": HPL_SMALL})])
    assert out[9]["time_s"] > 0


def test_hpl_service_metric_parity():
    names = ["frontera", "bdw-local"]
    svc_g, svc_h = _svc(), HPLPredictionService(device=CPU)
    cfg = get_workload("hpl", N=1536).config(get_platform("frontera"))
    svc_g.predict_batch([
        WorkloadRequest(rid=0, workload="hpl", platform="frontera",
                        params={"N": 1536}),
        WorkloadRequest(rid=1, workload="hpl", platform="bdw-local")])
    svc_h.predict_batch([PredictRequest(rid=0, platform="frontera", cfg=cfg),
                         PredictRequest(rid=1, platform="bdw-local")])
    cg = svc_g.metrics.snapshot()["counters"]
    ch = svc_h.metrics.snapshot()["counters"]
    for key in ("serve.requests", "serve.batches", "serve.scenarios",
                "serve.sweeps"):
        assert cg[key] == ch[key], key
    hg = svc_g.metrics.snapshot()["histograms"]
    hh = svc_h.metrics.snapshot()["histograms"]
    assert hg["serve.request_latency_s"]["count"] == 2
    assert hh["serve.request_latency_s"]["count"] == 2
    assert hg["serve.wave_size"]["sum"] == hh["serve.wave_size"]["sum"]


def test_service_registries_merge_across_replicas():
    svcs = [_svc() for _ in range(2)]
    for i, svc in enumerate(svcs):
        svc.predict_batch([_mk({"rid": i, "platform": "bdw-local",
                                "params": HPL_SMALL})])
    fleet = MetricsRegistry()
    for svc in svcs:
        fleet.merge(svc.metrics)
    assert fleet.snapshot()["counters"]["serve.requests"] == 2.0


def test_hpl_service_breakdown_and_guard():
    svc = HPLPredictionService(device=CPU, max_des_ranks=8)
    with pytest.raises(ValueError, match="max_des_ranks"):
        svc.predict_batch([PredictRequest(rid=0, platform="bdw-local",
                                          breakdown=True)])
    with pytest.raises(ValueError, match="needs \\(cfg, params\\)"):
        HPLPredictionService(device=CPU).predict_batch(
            [PredictRequest(rid=0)])
    plat = get_platform("bdw-local")
    with pytest.raises(ValueError, match="needs a platform"):
        HPLPredictionService(device=CPU).predict_batch(
            [PredictRequest(rid=0, cfg=plat.hpl_config(),
                            params=plat.fastsim(), breakdown=True)])
    svc = HPLPredictionService(device=CPU)
    out = svc.predict_batch([PredictRequest(rid=0, platform="bdw-local",
                                            breakdown=True)])
    assert out[0]["breakdown"]["des_time_s"] == 0.05864729600365412
    assert svc.stats["des_breakdowns"] == 1


# ------------------------------------------------------------ TOP500

def test_predict_top500_from_csv_and_namespace():
    report = predict_top500(sample_list_path(), tuning=SMOKE_TUNING,
                            device=CPU)
    assert len(report.entries) >= 50 and report.compiles <= 1
    ns = "t500srv"
    report2 = predict_top500(sample_list_path(), namespace=ns,
                             tuning=SMOKE_TUNING, calibrate=False,
                             device=CPU)
    try:
        names = [e.platform.name for e in report2.entries]
        assert all(n.startswith(ns + "/") for n in names)
        assert get_platform(names[0]) is not None
        with pytest.raises(ValueError, match="already registered"):
            predict_top500(sample_list_path(), namespace=ns,
                           tuning=SMOKE_TUNING, calibrate=False, device=CPU)
        report3 = predict_top500(sample_list_path(), namespace=ns,
                                 overwrite=True, tuning=SMOKE_TUNING,
                                 calibrate=False, device=CPU)
        assert len(report3.entries) == len(report2.entries)
    finally:
        unregister([e.platform.name for e in report2.entries])


def test_predict_top500_surfaces_skipped_and_empty(tmp_path):
    good = tmp_path / "one_bad.csv"
    good.write_text(
        "Rank,Processor,Total Cores,Interconnect,Rmax,Rpeak\n"
        "1,Xeon Gold 6148 20C 2.4GHz,40000,EDR,500,768\n"
        "2,Xeon Gold 6148 20C 2.4GHz,bogus,EDR,500,768\n",
        encoding="utf-8")
    report = predict_top500(str(good), tuning=SMOKE_TUNING,
                            calibrate=False, device=CPU)
    assert len(report.entries) == 1
    assert [line for line, _ in report.skipped_rows] == [2]
    assert report.to_dict()["skipped_rows"]
    bad = tmp_path / "all_bad.csv"
    bad.write_text(
        "Rank,Processor,Total Cores,Interconnect,Rmax,Rpeak\n"
        "1,Xeon Gold 6148 20C 2.4GHz,bogus,EDR,500,768\n",
        encoding="utf-8")
    with pytest.raises(ValueError, match="no parseable rows"):
        predict_top500(str(bad), tuning=SMOKE_TUNING, device=CPU)


def test_predict_platforms_unknown_name_mid_batch_leaves_queue_clean():
    from repro_torch.core.apps.hpl import HPLConfig
    svc = HPLPredictionService(device=CPU)
    cfg = HPLConfig(N=1024, nb=128, P=2, Q=2)
    with pytest.raises(KeyError, match="no-such"):
        svc.predict_platforms(["frontera", "no-such-machine"], cfg=cfg)
    assert svc.stats["requests"] == 0 and not svc._queue
    out = svc.predict_platforms(["frontera", "pupmaya"], cfg=cfg)
    assert set(out) == {"frontera", "pupmaya"}
    assert svc.stats["requests"] == svc.stats["scenarios"] == 2


def test_predict_platforms_empty_sequence_is_a_noop():
    svc = HPLPredictionService(device=CPU)
    assert svc.predict_platforms([]) == {}
    assert svc.stats == {"requests": 0, "batches": 0, "scenarios": 0,
                         "traces": 0, "des_breakdowns": 0}


# ------------------------------------------------------------ exports

@pytest.mark.parametrize("package", ["serve", "campaign"])
def test_exports_match_the_reference(package):
    """``repro_torch.<package>`` exports every name ``repro.<package>``
    does (the reference's ``__all__``, read with ``ast``)."""
    path = os.path.join(ROOT, "src", "repro", package, "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", "") == "__all__")
    port = importlib.import_module(f"repro_torch.{package}")
    assert sorted(port.__all__) == sorted(names)
    assert all(hasattr(port, n) for n in names)
