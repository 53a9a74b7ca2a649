"""The port's training loop and its launcher (``repro_torch.train.train``,
``repro_torch.launch.train``) against the JAX reference's
(``repro.train.loop``, ``repro.launch.train``), on the CPU.

The reference runs once for the module, in a child interpreter
(``torch_reference.run_reference``) started from a thread by the
module's first test, so the port's own tests (listed first) run while it
computes.  For reduced float32 qwen2-0.5b (AdamW), llava-next (the vlm
extras), whisper-medium (the encdec extras) and qwen3-moe (Adafactor, 2
microbatches) the child writes the reference's own
``make_train_state(cfg, PRNGKey(0))`` as a step-0 checkpoint into two
directories and runs the reference's ``train`` in the first; the port's
``train`` resumes from the second, so both start from the reference's
weights.  Limits:

* each loss within 1e-5 relative (``LOSS_LIMIT``, as the step's tests);
* every optimizer leaf of the step-4 checkpoint within ``STATE_LIMIT`` of
  the reference's, relative to the leaf's largest magnitude, and every
  parameter within ``PARAM_LIMIT`` of lr x steps (the counts equal);
* the step lists and manifests equal, the log lines equal once their
  loss and ``ms`` fields are parsed out, the printed losses within the
  loss limit plus half a unit of their fourth decimal (each side rounds
  its own loss);
* the launcher (reduced qwen2-0.5b at ``--smoke``, bf16 compute, seeded
  the same way) prints the reference launcher's lines, its losses within
  ``LAUNCH_LIMIT``.

The port alone: the reference's two system tests (``tests/test_system.py:
14-38``; the resume bit-equal in every leaf of params, opt and step, not
only params), the reference's edge cases, ``--dryrun`` refusing without a
process, the launcher's flags, and ``chip_smoke.py``'s training-loop
gates on reduced qwen2-0.5b with the CPU in the card's place.  Every test
runs its torch ops on one thread, as ``test_torch_train_step.py`` does.
"""
import argparse
import contextlib
import dataclasses
import importlib.util
import math
import os
import re
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from torch_reference import run_reference

from repro_torch.checkpoint import latest_step
from repro_torch.checkpoint import checkpoint as port_ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.launch import train as port_launcher
from repro_torch.train import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


# chip_smoke.py: its training-loop gates (run on the CPU below) and its
# comparators (``keyed``, ``leaf_gaps``, ``unequal_leaves``)
cs = _load_chip_smoke()

CPU = torch.device("cpu")
# name: (arch, microbatches)
CASES = {
    "qwen2-0.5b": ("qwen2-0.5b", 1),
    "llava-next": ("llava-next-mistral-7b", 1),
    "whisper-medium": ("whisper-medium", 1),
    "qwen3-moe-adafactor": ("qwen3-moe-235b-a22b", 2),
}
LOOP = {"steps": 4, "global_batch": 2, "seq_len": 32, "ckpt_every": 2,
        "log_every": 2}
LAUNCH_ARGV = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "3",
               "--global-batch", "2", "--seq-len", "32"]
LR = 3e-4                # train's default
LOSS_LIMIT = 1e-5
# measured: each loss within 2.8e-7 (whisper-medium).  The step-4
# checkpoints: optimizer leaves (AdamW's m and v, Adafactor's factors),
# the largest gap over the leaf's largest magnitude, measured at most
# 1.3e-5 (whisper's m of lnx/scale); parameters, the largest gap over
# lr x steps, the furthest four AdamW steps move a weight (an update is lr
# times m over sqrt(v), about 1 where the gradients agree in sign),
# measured 1.3e-2 at qwen2's attention key bias, which starts at zero and
# whose moments nearly cancel, so that AdamW's quotient magnifies the
# gradients' float32 differences, and at most 6.3e-3 elsewhere
STATE_LIMIT, PARAM_LIMIT = 1e-4, 5e-2
# bf16 compute, the reference's XLA against torch: the printed losses of
# the launcher's run measured 1 in their fourth decimal apart, 1.6e-5
LAUNCH_LIMIT = 1e-3

LINE = re.compile(r"(?:loss |-> )([\d.]+)|\((\d+) ms|median step (\d+) ms")

CHILD = r"""
import contextlib
import dataclasses
import io
import os
import shutil
import sys
# the reference's programs compile with LLVM's cheap passes (no fast-math
# either way, so the same float32 operations) and run on one thread: the
# suite runs several workers at once, and these programs are small
os.environ["XLA_FLAGS"] = ("--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax
from repro.checkpoint import checkpoint as ckpt
from repro.checkpoint import latest_step, save_checkpoint
from repro.configs import get_config, reduced
from repro.train.loop import train
from repro.train.step import make_train_state
import repro.launch.train as launcher

root, loop = PAYLOAD["root"], PAYLOAD["loop"]
saves = []
real_save = ckpt.AsyncCheckpointer.save


def save(self, step, state):
    saves.append(step)
    return real_save(self, step, state)


ckpt.AsyncCheckpointer.save = save


def seeded(cfg, where):
    state = make_train_state(cfg, jax.random.PRNGKey(0))
    for side in ("ref", "port"):
        save_checkpoint(f"{root}/{where}/{side}", 0, state)


for name, (arch, micro) in PAYLOAD["cases"].items():
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    seeded(cfg, name)
    lines, saves[:] = [], []
    res = train(cfg, ckpt_dir=f"{root}/{name}/ref", microbatches=micro,
                log_fn=lines.append, **loop)
    OUT[name] = {"losses": res["losses"], "lines": lines,
                 "saves": list(saves)}
    if name == "qwen2-0.5b":
        # the reference's edge case: a resume at or past ``steps``
        edge = f"{root}/{name}/edge"
        shutil.copytree(f"{root}/{name}/ref", edge)
        lines, saves[:] = [], []
        res = train(cfg, ckpt_dir=edge, log_fn=lines.append,
                    **dict(loop, steps=2))
        OUT["edge"] = {"losses": res["losses"], "first": res["first_loss"],
                       "final": res["final_loss"],
                       "median": res["median_step_s"], "lines": lines,
                       "saves": list(saves), "latest": latest_step(edge),
                       "steps": sorted(os.listdir(edge))}

seeded(reduced(get_config(PAYLOAD["launch_arch"])), "launch")
printed = io.StringIO()
sys.argv = (["repro.launch.train"] + PAYLOAD["launch_argv"]
            + ["--ckpt-dir", f"{root}/launch/ref"])
with contextlib.redirect_stdout(printed):
    launcher.main()
OUT["launch"] = printed.getvalue().splitlines()
"""


def _cfg(name):
    return dataclasses.replace(reduced(get_config(CASES[name][0])),
                               dtype="float32")


def _split_line(line):
    """(the line with its loss and ms fields blanked, the losses in it)."""
    losses = [float(m[1]) for m in LINE.finditer(line) if m[1]]
    return LINE.sub("<>", line), losses


def _assert_lines_match(got, want, limit):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        gs, gl = _split_line(g)
        ws, wl = _split_line(w)
        assert gs == ws, (g, w)
        for a, b in zip(gl, wl):
            assert abs(a - b) <= limit * abs(b) + 1e-4, (g, w)


def _arrays(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@contextlib.contextmanager
def _recorded_saves():
    saves = []
    real = port_ckpt.AsyncCheckpointer.save

    def save(self, step, state):
        saves.append(step)
        return real(self, step, state)
    port_ckpt.AsyncCheckpointer.save = save
    try:
        yield saves
    finally:
        port_ckpt.AsyncCheckpointer.save = real


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module, the worker's count restored
    after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference_child(tmp_path_factory):
    """The reference child, started in a thread; the module's first test
    requests it, so the port's own tests run while it computes.  Yields
    (root, thread, result)."""
    root = tmp_path_factory.mktemp("loop_ref")
    result = {}

    def run():
        try:
            result["out"] = run_reference(CHILD, {
                "root": str(root), "loop": LOOP, "cases": CASES,
                "launch_arch": "qwen2-0.5b", "launch_argv": LAUNCH_ARGV})
        except BaseException as e:           # re-raised by ``ref``
            result["error"] = e
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    yield root, thread, result
    thread.join()


@pytest.fixture(scope="module")
def ref(reference_child):
    """The reference's results (``OUT``) and the directory it wrote."""
    root, thread, result = reference_child
    thread.join()
    if "error" in result:
        raise result["error"]
    return root, result["out"]


@pytest.fixture(scope="module")
def port(ref):
    """The port's ``train`` on the CPU from each case's "port" directory
    (the reference's step-0 state): {name: losses, lines, saves}."""
    root, _ = ref
    out = {}
    for name, (_, micro) in CASES.items():
        lines = []
        with _recorded_saves() as saves:
            res = train(_cfg(name), ckpt_dir=str(root / name / "port"),
                        microbatches=micro, log_fn=lines.append,
                        device="cpu", **LOOP)
        out[name] = {"losses": res["losses"], "lines": lines,
                     "saves": saves}
    return out


# ------------------------------------------------ the port on its own


def _quiet(**kw):
    return dict(log_every=100, log_fn=lambda s: None, device="cpu", **kw)


def test_resume_is_bit_equal_to_the_straight_run(tmp_path,
                                                 reference_child):
    """``tests/test_system.py:14-29`` on the port: 6 steps straight against
    3, a checkpoint and 3 resumed, every leaf of params, opt and step
    bit-equal (the reference checks params only).  (It starts the
    reference child, which the tests at the end of the module read.)"""
    cfg = reduced(get_config("qwen2-0.5b"))
    straight = train(cfg, steps=6, global_batch=2, seq_len=32, **_quiet())
    d = tmp_path / "ck"
    train(cfg, steps=3, global_batch=2, seq_len=32, ckpt_dir=d,
          ckpt_every=3, **_quiet())
    lines = []
    resumed = train(cfg, steps=6, global_batch=2, seq_len=32, ckpt_dir=d,
                    ckpt_every=100, log_every=100, log_fn=lines.append,
                    device="cpu")
    assert lines[0] == "[train] resumed from step 3"
    assert [cs.LOOP_LINE.match(line)[1] for line in lines[1:]] == ["5"]
    assert resumed["losses"] == straight["losses"][3:]
    assert len(cs.keyed(straight["state"])) == 44
    assert cs.unequal_leaves(resumed["state"], straight["state"]) == []


def test_train_loss_decreases_meaningfully():
    """``tests/test_system.py:32-38`` on the port."""
    cfg = reduced(get_config("qwen2-0.5b"))
    res = train(cfg, steps=25, global_batch=4, seq_len=64, lr=1e-3,
                **_quiet())
    assert res["final_loss"] < res["first_loss"] - 0.2


def test_resume_at_or_past_steps_runs_no_step(tmp_path):
    """The reference's edge case: resumed at step 4 with ``steps=2``, the
    loop runs no step, returns NaN losses and a 0.0 median, and saves the
    restored state under step 2, next to step 4."""
    cfg = reduced(get_config("qwen2-0.5b"))
    d = tmp_path / "ck"
    first = train(cfg, steps=4, global_batch=2, seq_len=32, ckpt_dir=d,
                  **_quiet())
    with _recorded_saves() as saves:
        res = train(cfg, steps=2, global_batch=2, seq_len=32, ckpt_dir=d,
                    **_quiet())
    assert res["losses"] == [] and saves == [2]
    assert math.isnan(res["first_loss"]) and math.isnan(res["final_loss"])
    assert res["median_step_s"] == 0.0
    assert latest_step(d) == 4
    assert cs.unequal_leaves(res["state"], first["state"]) == []
    assert _arrays(d / "step_2" / "arrays.npz").keys() == \
        _arrays(d / "step_4" / "arrays.npz").keys()
    for key, arr in _arrays(d / "step_2" / "arrays.npz").items():
        assert np.array_equal(arr, _arrays(d / "step_4" / "arrays.npz")[key])


def test_a_multiple_of_ckpt_every_saves_the_last_step_twice(tmp_path):
    """As in the reference: with ``steps % ckpt_every == 0`` the last step
    is saved by the cadence and again at the end."""
    cfg = reduced(get_config("qwen2-0.5b"))
    with _recorded_saves() as saves:
        train(cfg, steps=4, global_batch=2, seq_len=16, ckpt_every=2,
              ckpt_dir=tmp_path / "ck", **_quiet())
    assert saves == [2, 4, 4]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2", "step_4"]


def test_a_run_without_steps_or_a_directory_returns_nan():
    res = train(reduced(get_config("qwen2-0.5b")), steps=0, global_batch=2,
                seq_len=16, **_quiet())
    assert res["losses"] == [] and math.isnan(res["final_loss"])
    assert int(res["state"].step) == 0


def test_dryrun_refuses_and_starts_no_process(monkeypatch):
    """``--dryrun`` starts ``python -m repro_torch.launch.dryrun --arch
    --shape [--multi-pod]`` in a child and exits with its code, as the
    reference's launcher starts its own dry-run; it starts nothing else
    and imports nothing of the reference.  (The name is the one the test
    had while the dry-run was not ported and the flag exited 2; it is
    kept so the test keeps its history, though the flag now runs.)"""
    started = []

    def call(cmd, *args, **kwargs):
        started.append(cmd)
        return 3
    monkeypatch.setattr(subprocess, "call", call)
    for name in ("Popen", "run", "check_call", "check_output"):
        monkeypatch.setattr(subprocess, name, lambda *a, **k: (
            _ for _ in ()).throw(AssertionError(f"{name} was called")))
    before = {m for m in sys.modules if m == "repro" or
              m.startswith("repro.")}
    with pytest.raises(SystemExit) as exc:
        port_launcher.main(["--arch", "qwen2-0.5b", "--dryrun",
                            "--multi-pod"])
    assert exc.value.code == 3
    assert started == [[sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "qwen2-0.5b", "--shape", "train_4k",
                        "--multi-pod"]]
    assert {m for m in sys.modules if m == "repro" or
            m.startswith("repro.")} == before


def _parser_of(main, *args):
    """The ``ArgumentParser`` that ``main`` builds, caught at its
    ``parse_args``."""
    caught = []

    class Caught(Exception):
        pass

    def parse_args(self, *a, **k):
        caught.append(self)
        raise Caught
    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse_args
    try:
        main(*args)
    except Caught:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return caught[0]


def _flags(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.type, a.nargs,
                                      a.const, a.required, type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_launcher_flags_are_the_references_and_device():
    import repro.launch.train as ref_launcher
    ref_flags = _flags(_parser_of(ref_launcher.main))
    port_flags = _flags(_parser_of(port_launcher.main, []))
    device = port_flags.pop(("--device",))
    assert device[:2] == ("device", "cuda")
    assert port_flags == ref_flags


def test_launcher_runs_on_the_cpu(capsys):
    """``--smoke --device cpu`` prints the loop's lines and the
    reference's closing line."""
    res = port_launcher.main(["--arch", "qwen2-0.5b", "--smoke", "--steps",
                              "3", "--global-batch", "2", "--seq-len", "16",
                              "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [cs.LOOP_LINE.match(line)[1] for line in lines[:2]] == ["0", "2"]
    done = cs.LOOP_DONE.match(lines[2])
    assert (done[1], done[2]) == (f"{res['first_loss']:.4f}",
                                  f"{res['final_loss']:.4f}")


def test_chip_train_loop_checks_on_the_cpu(tmp_path, capsys):
    """``chip_smoke.py``'s training-loop gates on reduced qwen2-0.5b, the
    CPU standing in for the card: TL1-TL3 and TL5 pass, TL4's launcher
    child prints TL1's losses, each planted fault breaks exactly its gates
    (``loop_checks`` checks both), and no kernel's plain version counts a
    launch (TL6)."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.maxmin_fair import masked_min_rows
    from repro_torch.kernels.ssd_scan import ssd_scan
    counted = (masked_min_rows, flash_attention_fwd, ssd_scan)
    before = [k.launches for k in counted]
    data = cs.LOOP_FAULT_DATA
    out = cs.loop_checks(
        CPU, reduced(get_config(cs.TRAIN_ARCH)),
        ["qwen2-0.5b", "llava-next-mistral-7b", "whisper-medium",
         cs.LOOP_MICROBATCH_ARCH], cs.TRAIN_ARCH, tmp_path, data=data,
        launch_argv=["--arch", cs.TRAIN_ARCH, "--smoke", "--steps", "3",
                     "--global-batch", str(data["global_batch"]),
                     "--seq-len", str(data["seq_len"]), "--lr",
                     str(data["lr"]), "--device", "cpu"])
    assert [k.launches for k in counted] == before
    assert len(out["losses"]) == cs.LOOP_STEPS
    text = capsys.readouterr().out
    assert "loop TL4" in text and "the losses TL1's" in text
    for fault, gates in cs.LOOP_FAULTS.items():
        assert f"planted fault {fault}: broke {sorted(gates)}" in text
    assert "planted fault None: broke []" in text


# ------------------------------------------ the port against the reference


@pytest.mark.parametrize("name", CASES)
def test_losses_match_the_reference(ref, port, name):
    want = ref[1][name]["losses"]
    got = port[name]["losses"]
    assert len(got) == len(want) == LOOP["steps"]
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_LIMIT * abs(w), (got, want)


@pytest.mark.parametrize("name", CASES)
def test_checkpoints_match_the_reference(ref, port, name):
    """Both directories hold the same steps with equal manifests; every
    leaf of the step-4 checkpoint within ``STATE_LIMIT``, the counts
    equal; both loops saved the same steps."""
    root, out = ref
    ref_dir, port_dir = root / name / "ref", root / name / "port"
    steps = sorted(os.listdir(ref_dir))
    assert steps == sorted(os.listdir(port_dir)) == [
        "step_0", "step_2", "step_4"]
    for step in steps:
        assert (port_dir / step / "manifest.json").read_text() == \
            (ref_dir / step / "manifest.json").read_text()
    want = _arrays(ref_dir / "step_4" / "arrays.npz")
    got = {k: torch.from_numpy(v)
           for k, v in _arrays(port_dir / "step_4" / "arrays.npz").items()}
    for key in (".step", ".opt/count"):
        assert int(got[key]) == int(want[key]) == LOOP["steps"]
    gaps = {}
    for key, w in want.items():
        diff = float((got[key].double() - torch.from_numpy(w).double())
                     .abs().max())
        if key.startswith(".params/"):
            gaps[key] = (diff / (LR * LOOP["steps"]), PARAM_LIMIT)
        else:
            gaps[key] = (diff / max(float(np.abs(w).max()), 1e-30),
                         STATE_LIMIT)
    bad = {k: g for k, (g, limit) in gaps.items() if not g <= limit}
    assert not bad, bad
    assert port[name]["saves"] == out[name]["saves"] == [2, 4, 4]


@pytest.mark.parametrize("name", CASES)
def test_log_lines_match_the_reference(ref, port, name):
    want = ref[1][name]["lines"]
    assert want[0] == "[train] resumed from step 0" and len(want) == 4
    _assert_lines_match(port[name]["lines"], want, LOSS_LIMIT)


def test_resume_past_steps_matches_the_reference(ref, tmp_path):
    """The edge case on a copy of each side's qwen2 directory after its
    4-step run: the same lines, saves, latest step and step list."""
    root, out = ref
    edge = tmp_path / "edge"
    shutil.copytree(root / "qwen2-0.5b" / "port", edge)
    lines = []
    with _recorded_saves() as saves:
        res = train(_cfg("qwen2-0.5b"), ckpt_dir=edge, log_fn=lines.append,
                    device="cpu", **dict(LOOP, steps=2))
    want = out["edge"]
    assert (res["losses"], lines, saves, latest_step(edge),
            sorted(os.listdir(edge))) == (
        want["losses"], want["lines"], want["saves"], want["latest"],
        want["steps"])
    assert math.isnan(res["first_loss"]) and math.isnan(want["first"])
    assert math.isnan(res["final_loss"]) and math.isnan(want["final"])
    assert res["median_step_s"] == want["median"] == 0.0


def test_launcher_prints_the_reference_launchers_lines(ref, capsys):
    """The port's launcher on the reference's step-0 state of reduced
    qwen2-0.5b (bf16 compute) against the reference launcher's lines."""
    root, out = ref
    port_launcher.main(LAUNCH_ARGV + ["--ckpt-dir",
                                      str(root / "launch" / "port"),
                                      "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    want = out["launch"]
    assert want[0] == "[train] resumed from step 0" and len(want) == 4
    assert want[-1].startswith("[train] done: loss ")
    _assert_lines_match(lines, want, LAUNCH_LIMIT)
    assert latest_step(root / "launch" / "port") == \
        latest_step(root / "launch" / "ref") == 3
