"""The port's dry-run launcher (``repro_torch.launch.dryrun``) against the
reference's own records.

One module-scoped child interpreter runs the reference's ``run_cell`` on
the held cells at full width and depth (``repro/launch/dryrun.py`` forces
512 host devices itself).  Installed jax 0.9.0 makes ``jax.make_mesh``'s
axes Explicit, on which the reference's first sharding constraint raises;
the child aliases ``make_mesh`` to Auto axes, beside the
``enable_x64`` alias, in the child only.  While it compiles, the port's
``run_cell`` writes its records of the same cells here, on meta tensors.

Held, per cell: the exact fields ``==``; FLOPs (and the kernel-adjusted
FLOPs) in [0.8, 1.25] of the reference's; bytes in [1/3, 3] (kernel
adjusted, or raw for decode and where the reference's matcher removed no
tile); collective wire bytes per device, summed over every op kind, in
[1/3, 3]; ``predict_cell``'s
step time on the port's record in [1/3, 3] of the reference record's.
The gates are ``chip_smoke.py``'s (``dryrun_gates``), and so are the
reference's figures it carries (``REFERENCE_DRYRUN``), held here to the
child's.  Three planted faults each break their gate.
"""
import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import load_record, predict_cell, whatif
from repro_torch.launch import dryrun
from repro_torch.roofline import count as count_mod
from torch_reference import MAKE_MESH_ALIAS, ROOT, load_chip_smoke, \
    run_reference

REF_CHILD = MAKE_MESH_ALIAS + r"""
import contextlib, io, tempfile
from pathlib import Path
from repro.launch import dryrun
assert jax.device_count() == 512, jax.device_count()
out = Path(tempfile.mkdtemp())
for arch, shape, multi_pod, overrides, tag in PAYLOAD["cells"]:
    with contextlib.redirect_stdout(io.StringIO()):
        rec = dryrun.run_cell(arch, shape, multi_pod, out,
                              overrides=overrides or None, tag=tag)
    name = dryrun._cell_out(out, arch, shape, multi_pod, tag).name
    OUT[name] = rec
OUT["skip"] = dryrun.run_cell(*PAYLOAD["skip"], False, out)
OUT["files"] = sorted(p.name for p in out.iterdir())
OUT["jax"] = jax.__version__
"""


SCRIPT = load_chip_smoke()
CELLS = SCRIPT.DRYRUN_CELLS
KEYS = [SCRIPT.dryrun_key(c) for c in CELLS]
# D3's cells (the sweep's), whose reference records the constants carry
SWEEP_CELLS = [(a, s, False, {}, "") for a, s in SCRIPT.DRYRUN_SWEEP_CELLS]
REF_KEYS = KEYS + [SCRIPT.dryrun_key(c) for c in SWEEP_CELLS]


def _run(cell, out_dir):
    arch, shape, multi_pod, overrides, tag = cell
    return dryrun.run_cell(arch, shape, multi_pod, out_dir,
                           overrides=overrides or None, tag=tag)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """(the reference's records, the port's records, the reference
    child's skip record, files and jax version), by file name."""
    import threading
    box = {}

    def child():
        box["ref"] = run_reference(REF_CHILD, {
            "cells": [list(c) for c in CELLS + SWEEP_CELLS],
            "skip": list(SCRIPT.DRYRUN_SKIP)}, timeout=900)
    thread = threading.Thread(target=child)
    thread.start()
    out = tmp_path_factory.mktemp("port")
    try:
        port = {SCRIPT.dryrun_key(c): _run(c, out) for c in CELLS}
    finally:
        thread.join()
    ref = box["ref"]
    return {"ref": {k: ref[k + ".json"] for k in REF_KEYS}, "port": port,
            "dir": out, "skip": ref["skip"], "files": ref["files"],
            "jax": ref["jax"]}


def _summary(rec):
    return dict(SCRIPT.dryrun_summary(rec), step_s=SCRIPT.dryrun_step_s(rec))


def _gates(records, key):
    return SCRIPT.dryrun_gates(_summary(records["port"][key]),
                               _summary(records["ref"][key]))


def test_chip_constants_are_the_reference_records(records):
    """``REFERENCE_DRYRUN`` is the child's records of D1's and D3's cells,
    summarised and with ``predict_cell``'s step time; the what-ifs and the
    DES of D2 are the reference records' too (jax 0.9.0, as the constants
    say)."""
    from repro_torch.core import predict_cell_des
    assert records["jax"] == "0.9.0"
    assert SCRIPT.REFERENCE_DRYRUN == {
        k: _summary(records["ref"][k]) for k in REF_KEYS}
    ref_dir = records["dir"].parent / "ref"
    ref_dir.mkdir(exist_ok=True)
    for key in KEYS:
        rec = records["ref"][key]
        if not rec["tag"]:
            (ref_dir / f"{key}.json").write_text(json.dumps(rec))
    assert SCRIPT.REFERENCE_DRYRUN_WHATIF == {
        name: whatif(*SCRIPT.DRYRUN_WHATIF_CELL, dryrun_dir=ref_dir,
                     **kw)["whatif_s"]
        for name, kw in SCRIPT.RECORD_WHATIF.items()}
    des = predict_cell_des(*SCRIPT.DRYRUN_DES_CELL, dryrun_dir=ref_dir)
    assert SCRIPT.REFERENCE_DRYRUN_DES == {"step_s": des["step_s"],
                                           "events": des["events"]}


@pytest.mark.parametrize("key", KEYS)
def test_exact_fields_equal(records, key):
    got, want = records["port"][key], records["ref"][key]
    assert sorted(got) == sorted(set(want) | {"count_s"})
    for k in SCRIPT.DRYRUN_EXACT:
        assert got[k] == want[k], k
    for k in ("chips", "model_flops"):
        assert got["roofline"][k] == want["roofline"][k], k
    assert (got["roofline_kernel_adjusted"] is None) == \
        (want["roofline_kernel_adjusted"] is None)
    assert os.path.exists(records["dir"] / f"{key}.json")
    assert f"{key}.json" in records["files"]
    assert got["compile_s"] is None and got["count_s"] > 0
    assert set(got["memory_analysis"]) == {"error"}
    assert set(got["cost_analysis"]) == {"error"}


@pytest.mark.parametrize("gate", ["flops", "bytes", "collectives", "step_s"])
@pytest.mark.parametrize("key", KEYS)
def test_ratio_gates(records, key, gate):
    ratios, ok = _gates(records, key)[gate]
    assert ok, (key, gate, ratios)
    assert all(math.isfinite(r) for r in ratios)


def test_skip_record(records, tmp_path):
    """An attention arch at long_500k: the reference's record, no file."""
    got = dryrun.run_cell(*SCRIPT.DRYRUN_SKIP, False, tmp_path)
    assert got == records["skip"] == SCRIPT.REFERENCE_DRYRUN_SKIP
    assert not list(tmp_path.iterdir())


def test_set_parsing_and_tagged_file_name(records, monkeypatch, capsys):
    """``--set`` parses int, then float, then str; ``--tag`` names the
    file; ``--all`` hands ``--out`` and ``--force`` to ``sweep``;
    ``--force`` without ``--all`` is the reference's: it runs the cell
    ``--arch`` names, and with no arch the run exits 1 and writes
    nothing."""
    assert dryrun.parse_overrides(["a=3", "b=0.5", "c=dp", "d=1e3",
                                   "e=x=y"]) == {
        "a": 3, "b": 0.5, "c": "dp", "d": 1000.0, "e": "x=y"}
    assert records["port"][KEYS[2]]["overrides"] == {"force_scheme": "dp"}
    assert dryrun._cell_out(records["dir"], "qwen2-0.5b", "train_4k",
                            False, "dp").name == f"{KEYS[2]}.json"
    calls = []
    monkeypatch.setattr(dryrun, "sweep",
                        lambda out, force=False: calls.append((out, force)))
    dryrun.main(["--all", "--force", "--out", str(records["dir"] / "x")])
    dryrun.main(["--all", "--out", str(records["dir"] / "y")])
    assert calls == [(records["dir"] / "x", True),
                     (records["dir"] / "y", False)]
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--force", "--out", str(records["dir"] / "x")])
    assert exc.value.code == 1
    assert "KeyError" in capsys.readouterr().err
    assert not (records["dir"] / "x").exists()


def test_force_scheme_dp_reads_sp(records):
    """The reference's quirk: a dp cell, whose rules have no tp axis,
    reads "sp"; its collectives are the dp scheme's (no K/V gather)."""
    from repro_torch.sharding import make_rules
    cfg = get_config("qwen2-0.5b")
    import dataclasses
    rules = make_rules(dataclasses.replace(cfg, force_scheme="dp"),
                       global_batch=256)
    assert rules["tp"] == () and rules["sp"] == ()
    assert records["port"][KEYS[2]]["scheme"] == "sp" == \
        records["ref"][KEYS[2]]["scheme"]
    assert records["port"][KEYS[2]]["collectives"] != \
        records["port"][KEYS[0]]["collectives"]


def test_cli_exits_1_when_a_cell_cannot_be_counted(capsys, tmp_path):
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    assert exc.value.code == 1
    assert "no-such-arch" in capsys.readouterr().err


def _collectives(arch, shape_name="train_4k", **overrides):
    """The port's ``step_collectives`` for one cell on the 16x16 mesh."""
    import dataclasses
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.models.api import abstract_params
    from repro_torch.sharding import collectives, make_rules, tree_shardings
    from repro_torch.configs import get_shape
    cfg = dataclasses.replace(get_config(arch), **overrides)
    shape = get_shape(shape_name)
    mesh = make_production_mesh()
    rules = make_rules(cfg, mode="train" if shape.kind == "train"
                       else "serve", global_batch=shape.global_batch)
    specs = build_model(cfg, device="meta").param_specs()
    params = abstract_params(cfg)
    return collectives.step_collectives(
        cfg, shape, rules, mesh, specs,
        tree_shardings(specs, mesh, rules, params), params)


@pytest.mark.parametrize("arch", sorted(__import__(
    "repro_torch.configs", fromlist=["list_archs"]).list_archs()))
def test_every_parameter_leaf_is_classed(arch):
    """Every arch's train step gets its collectives: each parameter leaf
    of rank 2 or more is a product or per-channel, none unclassed."""
    ops = _collectives(arch)
    assert ops and all(math.isfinite(v["wire_bytes"]) and v["count"] > 0
                       for v in ops.values())


def test_an_unclassed_parameter_raises(monkeypatch):
    from repro_torch.sharding import collectives
    monkeypatch.delitem(collectives._PRODUCTS, "wq")
    with pytest.raises(NotImplementedError, match="layers/attn/wq"):
        _collectives("qwen2-0.5b")


@pytest.mark.parametrize("attn_block,all_to_alls", [
    (2048, 48), (4096, 0), (256, 0)])
def test_sp_backward_follows_the_block_span(attn_block, all_to_alls):
    """qwen2-0.5b train_4k on 16x16 holds 256 positions a device.  With
    2048-position KV blocks a block spans 8 devices and each of its 2
    blocks' backward in each of 24 layers exchanges its score tile; with
    one block (the direct path) or one device a block, the K and V
    gradients are reduce-scattered instead."""
    ops = _collectives("qwen2-0.5b", attn_block=attn_block)
    assert ops.get("all-to-all", {"count": 0})["count"] == all_to_alls
    rs = ops["reduce-scatter"]["count"]
    assert rs == (169 if all_to_alls else 169 + 48)


def test_count_rules():
    """A product's FLOPs and bytes; a view costs nothing; a broadcast
    input is read once; a floating element counts 4 bytes at least; an
    op with no rule and a read of data both raise."""
    a = torch.empty(8, 16, device="meta")
    b = torch.empty(16, 4, dtype=torch.bfloat16, device="meta")
    got = count_mod.count(lambda: a @ b.float())
    assert got["flops"] == 2 * 8 * 16 * 4
    assert got["bytes"] == (16 * 4 * 4 * 2) + (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert count_mod.count(lambda: a.view(16, 8).t())["bytes"] == 0
    row = torch.empty(16, device="meta")
    got = count_mod.count(lambda: a + row.expand(8, 16))
    assert got["bytes"] == (8 * 16 + 16 + 8 * 16) * 4
    got = count_mod.count(lambda: a + 1, chips=4)
    assert got["flops"] == 8 * 16 / 4
    with pytest.raises(NotImplementedError, match="no rule"):
        count_mod.count(lambda: torch.linalg.qr(a))
    with pytest.raises(Exception):
        count_mod.count(lambda: torch.nonzero(a))


def test_count_shares():
    """One device's count: an activation at ``replicas / chips`` of its
    global size; a persistent leaf, a view of it and a copy of it at its
    own share, a bfloat16 leaf converted to float32 once (its shard read
    at 2 bytes and written at 4); a product's FLOPs over ``split``'s
    parts; a clone computes nothing."""
    w = torch.empty(16, 8, device="meta")
    h = torch.empty(16, 8, dtype=torch.bfloat16, device="meta")
    x = torch.empty(4, 16, device="meta")
    got = count_mod.count(lambda: x @ w[:, :4], chips=8, replicas=2,
                          shards=[(w, 0.5)])
    assert got["flops"] == 2 * 4 * 16 * 4 / 4
    assert got["bytes"] == (4 * 16 + 4 * 4) * 4 / 4 + 16 * 4 * 4 * 0.5
    got = count_mod.count(lambda: w.clone() + 1, chips=8,
                          shards=[(w, 0.5)])
    assert got["flops"] == 16 * 8 / 8
    assert got["bytes"] == 16 * 8 * 4 * (0.5 * 3 + 1 / 8)
    got = count_mod.count(lambda: (h[0] + 1, h[1] + 1), chips=4,
                          shards=[(h, 0.25)])
    assert got["bytes"] == 16 * 8 * (2 + 4) * 0.25 + 2 * 8 * 4 * (0.25 + 1 / 4)
    got = count_mod.count(lambda: torch.bmm(x[None], w[None]), chips=2,
                          split=lambda func, args: 4)
    assert got["flops"] == 2 * 4 * 16 * 8 / 2 / 4


def test_train_dryrun_through_its_child(tmp_path):
    """``python -m repro_torch.launch.train --arch qwen2-0.5b --dryrun``
    writes the train_4k record through its child and exits 0;
    ``load_record`` reads it back."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-0.5b", "--dryrun"], capture_output=True, text=True,
        env=env, cwd=tmp_path, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[dryrun] qwen2-0.5b x train_4k x 16x16: count" in proc.stdout
    path = tmp_path / "experiments" / "dryrun" / \
        "qwen2-0.5b__train_4k__16x16.json"
    assert path.exists()
    rec = load_record("qwen2-0.5b", "train_4k",
                      dryrun_dir=tmp_path / "experiments" / "dryrun")
    assert rec["ok"] and rec["persistent_bytes_per_device"] == 275_615_240


def test_predictions_on_the_port_records(records, tmp_path):
    """``predict_cell`` reads the port's records; sec5's what-ifs on
    qwen3-moe train_4k run on them, each within the step_s limit of the
    reference record's, and a faster link or HBM never slows the step."""
    for key in KEYS:
        rec = records["port"][key]
        if not rec["tag"]:
            shutil.copy(records["dir"] / f"{key}.json", tmp_path)
    lo, hi = SCRIPT.DRYRUN_LIMITS["step_s"]
    for name, kw in SCRIPT.RECORD_WHATIF.items():
        w = whatif(*SCRIPT.DRYRUN_WHATIF_CELL, dryrun_dir=tmp_path, **kw)
        assert w["speedup"] >= 1.0
        assert lo <= w["whatif_s"] / SCRIPT.REFERENCE_DRYRUN_WHATIF[name] \
            <= hi
    assert predict_cell("qwen2-0.5b", "decode_32k",
                        dryrun_dir=tmp_path).step_s > 0


@pytest.fixture(scope="module")
def fault_gates(records):
    """Each planted fault's gates on its cell, from ``chip_smoke.py``'s
    own runner (the faults are run once, here)."""
    return SCRIPT.dryrun_fault_gates(SCRIPT.REFERENCE_DRYRUN)


@pytest.mark.parametrize("fault", sorted(SCRIPT.DRYRUN_FAULTS))
def test_planted_faults_break_their_gates(records, fault_gates, tmp_path,
                                          fault):
    """The fault breaks its gate against the reference record of its cell;
    without it the port's record of the cell passes that gate."""
    cell, gate = SCRIPT.DRYRUN_FAULTS[fault]
    key = SCRIPT.dryrun_key(cell)
    assert not fault_gates[fault][gate][1], fault_gates[fault]
    rec = records["port"].get(key) or _run(cell, tmp_path)
    gates = SCRIPT.dryrun_gates(_summary(rec), _summary(records["ref"][key]))
    assert gates[gate][1], gates


def test_chip_dryrun_checks_on_the_cpu(records, fault_gates, capsys):
    """``chip_smoke.py``'s D1 checks on this process's records, every gate
    passing and each fault breaking its gate, as on the card."""
    SCRIPT.dryrun_checks(records["port"], SCRIPT.REFERENCE_DRYRUN,
                         faults=fault_gates)
    text = capsys.readouterr().out
    for fault, (_, gate) in SCRIPT.DRYRUN_FAULTS.items():
        assert f"planted fault {fault}" in text
    assert "FAILED" not in text
