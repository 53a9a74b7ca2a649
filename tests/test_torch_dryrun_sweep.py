"""The port's dry-run sweep (``python -m repro_torch.launch.dryrun --all``)
against the reference's sweep on the same cut list of cells.

Each package's sweep runs in a child process of its own, through its own
dry-run ``main`` with ``--all``: the port's in ``chip_smoke.py``'s
``DRYRUN_SWEEP_CHILD`` (D3's), the reference's in ``REF_SWEEP_CHILD``
below, which cuts the list the same way.  Each patches its package's
``configs.list_archs`` and ``SHAPES`` and registers an arch the sweep's
children cannot find.  The list is qwen2-0.5b and mamba2-780m x
decode_32k and long_500k x both meshes, plus the unregistered arch at
both shapes.  One cell is seeded with an ``ok`` stub (left as it is) and
one with an ``"ok": false`` record (redone).

The reference's children (``python -m repro.launch.dryrun``) need both
jax aliases under jax 0.9.0: without ``make_mesh`` defaulting to Auto
axes every cell raises and is recorded as a failure.  A
``sitecustomize.py`` that sets them (``torch_reference.JAX_ALIASES``)
sits in a temporary directory on the reference child's ``PYTHONPATH``
only, so every interpreter that child starts imports it; the port's path
never has it, and the port's children import no jax.

Held: the file sets, the skip records and the failure records (but for
the ``error`` text, where both end in the same ``KeyError`` line) equal;
the stub kept and the failed record redone; every ``[sweep] <arch> x
<shape> x <mesh>`` line and the summary line equal (the ``[sweep] FAILED``
lines' stderr tails are not held); every ``ok`` record within
``dryrun_gates``' limits of the reference's; and ``--force`` redoing a
stub, on a one-arch, one-shape list.
"""
import json
import os
import subprocess
import sys
import threading

import pytest

from torch_reference import JAX_ALIASES, ROOT, load_chip_smoke

SRC = os.path.join(ROOT, "src")

# the reference's cut sweep, on the spec of ``chip_smoke.py``'s
# ``DRYRUN_SWEEP_CHILD`` (``cuda`` aside), answering as that child does
REF_SWEEP_CHILD = r"""
import contextlib, dataclasses, io, json, sys
from pathlib import Path
from repro import configs
from repro.launch import dryrun
spec = json.loads(sys.argv[1])
out = Path(spec["out"])
out.mkdir(parents=True, exist_ok=True)
live = {tuple(c) for c in spec["live"]}
if spec["planted"]:
    name, like = spec["planted"]
    configs.ARCHS[name] = dataclasses.replace(configs.ARCHS[like], name=name)
archs = sorted({c[0] for c in live})
configs.list_archs = lambda: archs
configs.SHAPES = {k: v for k, v in configs.SHAPES.items()
                  if k in {c[1] for c in live}}
for arch in archs:
    for shape in configs.SHAPES:
        for mesh in ("16x16", "2x16x16"):
            if (arch, shape, mesh) not in live:
                out.joinpath(f"{arch}__{shape}__{mesh}.json").write_text(
                    json.dumps({"ok": True}))
for name, rec in spec.get("seed", {}).items():
    out.joinpath(name).write_text(json.dumps(rec))
sys.argv = ["dryrun", "--all", "--out", str(out)] + (
    ["--force"] if spec.get("force") else [])
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    dryrun.main()
print(json.dumps({"stdout": buf.getvalue()}))
"""

SCRIPT = load_chip_smoke()
CHILDREN = {"repro": REF_SWEEP_CHILD, "repro_torch": SCRIPT.DRYRUN_SWEEP_CHILD}
PLANTED = "planted-unregistered"
LIVE = [(a, s, m) for a in ("mamba2-780m", "qwen2-0.5b", PLANTED)
        for s in ("decode_32k", "long_500k") for m in ("16x16", "2x16x16")]
STUB = {"ok": True, "seeded": "stub"}
SEED = {"qwen2-0.5b__decode_32k__2x16x16.json": STUB,
        "mamba2-780m__decode_32k__2x16x16.json": {"ok": False,
                                                  "error": "seeded"}}
FORCE_LIVE = [("qwen2-0.5b", "decode_32k", "16x16")]


def _sweep(package, out, env, **spec):
    proc = subprocess.run(
        [sys.executable, "-c", CHILDREN[package], json.dumps(dict(
            cuda=False, out=str(out), **spec))],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """{package: {"main"/"force": (the child's answer, its out dir)}},
    the four sweeps run at once."""
    root = tmp_path_factory.mktemp("sweeps")
    site = root / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(JAX_ALIASES)
    base = dict(os.environ, JAX_PLATFORMS="cpu")
    envs = {"repro": dict(base, PYTHONPATH=os.pathsep.join(
                [str(site), SRC] + [p for p in [os.environ.get(
                    "PYTHONPATH")] if p])),
            "repro_torch": dict(base, PYTHONPATH=os.pathsep.join(
                [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))}
    runs = {(pkg, name): (root / pkg / name, spec)
            for pkg in envs
            for name, spec in (
                ("main", dict(live=LIVE, planted=[PLANTED, "qwen2-0.5b"],
                              seed=SEED)),
                ("force", dict(live=FORCE_LIVE, planted=None, force=True,
                               seed={"qwen2-0.5b__decode_32k__16x16.json":
                                     STUB})))}
    box = {}

    def run(key):
        out, spec = runs[key]
        box[key] = (_sweep(key[0], out, envs[key[0]], **spec), out)
    threads = [threading.Thread(target=run, args=(k,)) for k in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(box) == len(runs), sorted(box)
    out = {}
    for (pkg, name), v in box.items():
        out.setdefault(pkg, {})[name] = v
    return out


def _records(out):
    return {name: json.loads((out / name).read_text())
            for name in sorted(os.listdir(out))}


def _lines(answer):
    """The sweep's own lines: each cell's and the summary, in order."""
    return [ln for ln in answer["stdout"].splitlines()
            if ln.startswith("[sweep] ") and not ln.startswith(
                "[sweep] FAILED")]


def test_file_sets_equal(sweeps):
    ref, port = sweeps["repro"]["main"][1], sweeps["repro_torch"]["main"][1]
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    assert len(os.listdir(port)) == len(LIVE)


def test_skip_records_equal(sweeps):
    ref = _records(sweeps["repro"]["main"][1])
    port = _records(sweeps["repro_torch"]["main"][1])
    skips = sorted(k for k, r in ref.items() if r.get("skipped"))
    assert skips == sorted(k for k, r in port.items() if r.get("skipped"))
    assert len(skips) == 4          # qwen2-0.5b and the planted arch
    for k in skips:
        assert port[k] == ref[k]
        assert port[k]["reason"] == "long_500k needs sub-quadratic attention"
    assert ref["qwen2-0.5b__long_500k__16x16.json"] == \
        SCRIPT.REFERENCE_DRYRUN_SWEEP_SKIP     # D3's constant


def test_failure_records_equal_but_for_the_error(sweeps):
    ref = _records(sweeps["repro"]["main"][1])
    port = _records(sweeps["repro_torch"]["main"][1])
    failed = sorted(k for k, r in ref.items() if r.get("ok") is False)
    assert failed == sorted(k for k, r in port.items()
                            if r.get("ok") is False)
    assert failed == [f"{PLANTED}__decode_32k__16x16.json",
                      f"{PLANTED}__decode_32k__2x16x16.json"]
    for k in failed:
        got, want = dict(port[k]), dict(ref[k])
        g, w = got.pop("error"), want.pop("error")
        assert got == want
        last = g.strip().splitlines()[-1]
        assert last == w.strip().splitlines()[-1]
        assert last.startswith(f"KeyError: \"unknown arch '{PLANTED}'")


def test_stub_kept_and_failure_redone(sweeps):
    for pkg in ("repro", "repro_torch"):
        recs = _records(sweeps[pkg]["main"][1])
        assert recs["qwen2-0.5b__decode_32k__2x16x16.json"] == STUB, pkg
        redone = recs["mamba2-780m__decode_32k__2x16x16.json"]
        assert redone["ok"] is True and redone["arch"] == "mamba2-780m", pkg


def test_sweep_lines_equal(sweeps):
    ref, port = sweeps["repro"]["main"][0], sweeps["repro_torch"]["main"][0]
    assert _lines(port) == _lines(ref)
    assert _lines(port)[-1] == "[sweep] done=6 failed=2 skipped=4"
    assert port["stdout"].count(f"[sweep] FAILED {PLANTED} x decode_32k:") \
        == 2


@pytest.mark.parametrize("name", [
    f"{a}__{s}__{m}.json" for a, s, m in LIVE
    if a != PLANTED and (a, s) != ("qwen2-0.5b", "long_500k")
    and (a, s, m) != ("qwen2-0.5b", "decode_32k", "2x16x16")])
def test_ok_records_within_the_gates(sweeps, name):
    ref = _records(sweeps["repro"]["main"][1])[name]
    port = _records(sweeps["repro_torch"]["main"][1])[name]
    want = dict(SCRIPT.dryrun_summary(ref), step_s=SCRIPT.dryrun_step_s(ref))
    got = dict(SCRIPT.dryrun_summary(port),
               step_s=SCRIPT.dryrun_step_s(port))
    gates = SCRIPT.dryrun_gates(got, want)
    assert all(ok for _, ok in gates.values()), gates


def test_force_redoes_the_stub(sweeps):
    """``--force`` on one arch and one shape: the seeded stub and the
    other mesh's stub are both redone, each by a child."""
    for pkg in ("repro", "repro_torch"):
        answer, out = sweeps[pkg]["force"]
        recs = _records(out)
        assert sorted(recs) == ["qwen2-0.5b__decode_32k__16x16.json",
                                "qwen2-0.5b__decode_32k__2x16x16.json"], pkg
        assert all(r["ok"] is True and r["arch"] == "qwen2-0.5b"
                   for r in recs.values()), pkg
        assert _lines(answer) == [
            "[sweep] qwen2-0.5b x decode_32k x 16x16",
            "[sweep] qwen2-0.5b x decode_32k x 2x16x16",
            "[sweep] done=2 failed=0 skipped=0"], pkg


def test_chip_sweep_gates_on_the_port(sweeps):
    """``chip_smoke.py``'s D3 gates read this run's port sweep as the
    reference's rules expect it, the seeded cells aside."""
    answer, out = sweeps["repro_torch"]["main"]
    spec = {"live": LIVE, "planted": [PLANTED, "qwen2-0.5b"]}
    files, runs, summary = SCRIPT.dryrun_sweep_expected(spec)
    assert sorted(os.listdir(out)) == files
    seeded_stub = "[sweep] qwen2-0.5b x decode_32k x 2x16x16"
    assert _lines(answer)[:-1] == [r for r in runs if r != seeded_stub]
    assert _lines(answer)[-1] == summary
    gates = SCRIPT.dryrun_sweep_gates(dict(spec, live=LIVE), answer, out)
    assert not gates["summary"]     # the seeded stub ran no child
    assert gates["files"] and gates["failure"]
