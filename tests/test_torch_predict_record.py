"""Parity of the port's dry-run-record predictions
(``repro_torch.core.predict``: ``load_record``, ``predict_cell``,
``predict_cell_des``, ``whatif``) with the JAX reference, on the CPU.

The functions are host Python copied from the reference, so every answer
must be equal: ``StepPrediction`` fields (through ``dataclasses.asdict``),
the what-ifs' floats and the DES result.  The repository holds no
dry-run record, so the records here are synthetic, in the reference's
schema (``repro.launch.dryrun``: per-cell totals over all chips, ring
wire bytes per collective op), written once into a temporary directory
that both sides read.  ``repro.core.predict`` imports ``repro.core``,
which needs jax's x64 alias, so the reference runs once per module in a
child interpreter (``torch_reference.run_reference``).
"""
import dataclasses
import inspect
import json

import pytest

from repro_torch.core import load_record, predict_cell, predict_cell_des, \
    whatif
from repro_torch.core.predict import DRYRUN_DIR
from repro_torch.core.simxla import ici_from_platform
from repro_torch.platforms import get_platform
from torch_reference import run_reference


def _record(arch, shape, kind, flops, nbytes, colls, mesh="16x16",
            chips=256):
    return {"arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
            "kind": kind,
            "roofline": {"hlo_flops_total": flops, "hlo_bytes_total": nbytes},
            "collectives": {op: {"count": n, "wire_bytes": w}
                            for op, (n, w) in colls.items()}}


# every collective op the analytic model prices, over a train and a
# prefill record; the first is tests/test_system.py:124-130's.  The
# second is also the DES cell: 256 ranks at qwen2-0.5b's 24 layers, the
# all-reduce split between the layers and the tail, the all-gather in
# the layers (~1.4M events a run)
RECORDS = {
    "x__train_4k__16x16": _record(
        "x", "train_4k", "train", 2.56e17, 2.56e14,
        {"all-reduce": (10, 1e9)}),
    "qwen2-0.5b__train_4k__16x16": _record(
        "qwen2-0.5b", "train_4k", "train", 2.56e17, 2.56e14,
        {"all-reduce": (10, 1e9), "all-gather": (24, 5e8)}),
    "qwen2-0.5b__prefill_32k__2x16x16": _record(
        "qwen2-0.5b", "prefill_32k", "prefill", 2.5e15, 1.0e14,
        {"all-reduce": (48, 2.0e9), "reduce-scatter": (48, 1.2e9),
         "all-to-all": (24, 6.0e9), "collective-permute": (24, 2.5e8)},
        mesh="2x16x16", chips=512),
}
DES_RECORD = "qwen2-0.5b__train_4k__16x16"
# predict_cell's hardware arguments: the default platform, one by name,
# one as a spec, and explicit chip/ici/overlap (scales of tpu-v5e-pod's)
CASES = {
    "default": {},
    "platform_name": {"platform": "syn-torus-fugaku-4k"},
    "platform_spec": {"platform": "syn-mp-2pod-v5e", "as_spec": True},
    "chip_ici_overlap": {"peak_scale": 1.5, "hbm_scale": 0.75,
                         "link_scale": 3.0, "overlap": 0.25},
}
# benchmarks/sec5_whatif.py:47-49's three deltas, and all three at once
DELTAS = {
    "ici_x2": {"link_bw_scale": 2.0},
    "hbm_x2": {"hbm_bw_scale": 2.0},
    "peak_x2": {"peak_scale": 2.0},
    "all": {"link_bw_scale": 1.5, "hbm_bw_scale": 0.5, "peak_scale": 3.0},
}

# predict_cell's keyword arguments for a case of ``CASES``; runs on
# either package, with the names of the namespace it is executed in
HELPERS = r"""
def kwargs(case):
    case = dict(case)
    if "peak_scale" in case:
        plat = get_platform("tpu-v5e-pod")
        chip = plat.node_model()
        ici = ici_from_platform(plat)
        return {"chip": dataclasses.replace(
                    chip, peak_flops=chip.peak_flops * case["peak_scale"],
                    mem_bw=chip.mem_bw * case["hbm_scale"]),
                "ici": dataclasses.replace(
                    ici, link_bw=ici.link_bw * case["link_scale"]),
                "overlap": case["overlap"]}
    if case.pop("as_spec", False):
        case["platform"] = get_platform(case["platform"])
    return case
"""

CHILD = r"""
import dataclasses, inspect
from repro.core.predict import (load_record, predict_cell, predict_cell_des,
                                whatif)
from repro.core.simxla import ici_from_platform
from repro.platforms import get_platform

C = PAYLOAD
exec(C["helpers"])
d = C["dir"]
OUT["predict"] = {
    name: {key: dataclasses.asdict(predict_cell(
        *name.split("__"), dryrun_dir=d, **kwargs(case)))
        for key, case in C["cases"].items()}
    for name in C["records"]}
OUT["whatif"] = {}
for name in C["records"]:
    for key, kw in C["deltas"].items():
        w = whatif(*name.split("__"), dryrun_dir=d, **kw)
        OUT["whatif"][f"{name}/{key}"] = dict(
            w, baseline=dataclasses.asdict(w["baseline"]),
            whatif=dataclasses.asdict(w["whatif"]))
OUT["load"] = {name: load_record(*name.split("__"), dryrun_dir=d)
               for name in C["records"]}
try:
    load_record("qwen2-0.5b", "decode_32k", dryrun_dir=d)
except FileNotFoundError as exc:
    OUT["missing"] = str(exc)
OUT["des"] = predict_cell_des(*C["des"].split("__"), dryrun_dir=d)
OUT["signatures"] = {f.__name__: str(inspect.signature(f)) for f in
                     (load_record, predict_cell, predict_cell_des, whatif)}
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun")
    for name, rec in RECORDS.items():
        (root / f"{name}.json").write_text(json.dumps(rec))
    return root


@pytest.fixture(scope="module")
def ref(records):
    return run_reference(CHILD, {
        "helpers": HELPERS, "dir": str(records), "records": list(RECORDS),
        "cases": CASES, "deltas": DELTAS, "des": DES_RECORD})


_port = {}
exec(HELPERS, globals(), _port)
_kwargs = _port["kwargs"]


def _cell(name):
    return name.split("__")


def test_simulator_predicts_from_record(tmp_path):
    """tests/test_system.py:121-133 on the port."""
    rec = {"arch": "x", "shape": "train_4k", "mesh": "16x16", "chips": 256,
           "kind": "train",
           "roofline": {"hlo_flops_total": 2.56e17,
                        "hlo_bytes_total": 2.56e14},
           "collectives": {"all-reduce": {"count": 10,
                                          "wire_bytes": 1e9}}}
    (tmp_path / "x__train_4k__16x16.json").write_text(json.dumps(rec))
    p = predict_cell("x", "train_4k", dryrun_dir=tmp_path)
    assert p.step_s > 0
    assert p.compute_s == pytest.approx(1e15 / (197e12 * 0.9), rel=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", sorted(RECORDS))
def test_predict_cell_equals_the_reference(records, ref, name, case):
    got = predict_cell(*_cell(name), dryrun_dir=records,
                       **_kwargs(CASES[case]))
    assert dataclasses.asdict(got) == ref["predict"][name][case]


@pytest.mark.parametrize("delta", sorted(DELTAS))
@pytest.mark.parametrize("name", sorted(RECORDS))
def test_whatif_equals_the_reference(records, ref, name, delta):
    w = whatif(*_cell(name), dryrun_dir=records, **DELTAS[delta])
    want = ref["whatif"][f"{name}/{delta}"]
    assert sorted(w) == sorted(want) == ["baseline", "baseline_s",
                                         "speedup", "whatif", "whatif_s"]
    for key in ("baseline_s", "whatif_s", "speedup"):
        assert w[key] == want[key], key
    for key in ("baseline", "whatif"):
        assert dataclasses.asdict(w[key]) == want[key], key


def test_load_record_reads_what_the_reference_reads(records, ref):
    for name in RECORDS:
        assert load_record(*_cell(name), dryrun_dir=records) \
            == ref["load"][name]


def test_load_record_missing_file_names_the_reference_launcher(records,
                                                               ref):
    """The message gives the command for this cell: the reference's names
    its own launcher, the port's names ``repro_torch.launch.dryrun``,
    which writes the record."""
    with pytest.raises(FileNotFoundError) as exc:
        load_record("qwen2-0.5b", "decode_32k", dryrun_dir=records)
    msg = str(exc.value)
    args = "--arch qwen2-0.5b --shape decode_32k"
    assert f"python -m repro.launch.dryrun {args}" in ref["missing"]
    assert f"python -m repro_torch.launch.dryrun {args}" in msg
    assert str(records / "qwen2-0.5b__decode_32k__16x16.json") in msg
    assert DRYRUN_DIR.as_posix() == "experiments/dryrun"


def test_predict_cell_des_equals_the_reference(records, ref):
    """256 ranks at qwen2-0.5b's full depth on the host DES: step time,
    earliest finish and event count equal."""
    got = predict_cell_des(*_cell(DES_RECORD), dryrun_dir=records)
    assert got == ref["des"]
    assert got["events"] > 1_000_000


def test_host_functions_keep_the_reference_signatures(ref):
    """They touch no tensor, so they take no ``device``."""
    for f in (load_record, predict_cell, predict_cell_des, whatif):
        assert str(inspect.signature(f)) == ref["signatures"][f.__name__]
