"""The port's checkpoints (``repro_torch.checkpoint``) and train state
(``repro_torch.train.make_train_state``) against the reference's
(``repro.checkpoint``, ``repro.train.step``), in process.

The on-disk format must be the reference's: for the same state the same
``manifest.json`` text and the same ``arrays.npz`` members (each member's
bytes: npy header and data), so each package restores the other's
checkpoints.  Checked on reduced qwen2-0.5b (AdamW) and reduced
qwen3-moe-235b-a22b (Adafactor), both ways; the state's keys, shapes and
dtypes for all ten archs (the reference's through ``jax.eval_shape``);
and the reference's own checkpoint tests (``tests/test_checkpoint_data.py``)
on the port.  jax is imported inside the fixtures, so the ``cuda`` tests
collect where it is not installed.
"""
import json
import threading
import zipfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import checkpoint as port_ckpt
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.train import TrainState, make_train_state

CPU = torch.device("cpu")
# the archs the cross-package round trips cover: AdamW, Adafactor
CROSS = ("qwen2-0.5b", "qwen3-moe-235b-a22b")


def _state(arch, seed=0, device="cpu"):
    gen = torch.Generator(device).manual_seed(seed)
    return make_train_state(reduced(get_config(arch)), gen, device=device)


def _leaves(tree):
    return port_ckpt._flatten(tree)


def _mid_run(state, seed):
    """``state`` with every optimizer leaf and the step filled from
    ``seed`` in place (moments that differ, as after some steps)."""
    gen = torch.Generator().manual_seed(seed)
    for key, leaf in _leaves(state).items():
        if leaf.dtype == torch.int32:
            leaf.fill_(seed + 3)
        elif key.startswith(".opt/"):
            leaf.uniform_(generator=gen)
    return state


def _members(npz):
    with zipfile.ZipFile(npz) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _assert_same_files(a, b):
    """Two step directories hold the same manifest text and the same
    npz members, byte for byte."""
    assert (a / "manifest.json").read_text() == \
        (b / "manifest.json").read_text()
    ma, mb = _members(a / "arrays.npz"), _members(b / "arrays.npz")
    assert list(ma) == list(mb)
    for name in ma:
        assert ma[name] == mb[name], name


class Boom:
    """A leaf no array can be made of: its save fails."""

    def __array__(self, *args, **kwargs):
        raise RuntimeError("boom: not an array")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference side, built once: each CROSS arch's reduced train
    state (PRNGKey 0) as numpy leaves by key, written by the reference
    under ``root/<arch>/step_3``; and every arch's state layout
    {key: (shape, dtype)} from ``jax.eval_shape``."""
    import jax
    from repro.checkpoint import save_checkpoint as ref_save
    from repro.checkpoint.checkpoint import _flatten as ref_flatten
    from repro.configs import get_config as ref_get
    from repro.configs import reduced as ref_reduced
    from repro.train.step import make_train_state as ref_make
    root = tmp_path_factory.mktemp("ref_ckpt")
    out = {"root": root, "states": {}, "arrays": {}, "layouts": {}}
    for arch in CROSS:
        state = ref_make(ref_reduced(ref_get(arch)), jax.random.PRNGKey(0))
        ref_save(root / arch, 3, state)
        out["states"][arch] = state
        out["arrays"][arch] = {k: np.asarray(v)
                               for k, v in ref_flatten(state)[0].items()}
    for arch in sorted(ARCHS):
        shapes = jax.eval_shape(
            lambda k, a=arch: ref_make(ref_reduced(ref_get(a)), k),
            jax.random.PRNGKey(0))
        out["layouts"][arch] = {k: (tuple(v.shape), str(v.dtype))
                                for k, v in ref_flatten(shapes)[0].items()}
    return out


# ------------------------------------------------- the train state

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_state_layout_equals_the_reference(ref, arch):
    state = _state(arch)
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in _leaves(state).items()}
    want = ref["layouts"][arch]
    assert list(got) == list(want)          # the flatten order too
    assert got == want
    assert isinstance(state, TrainState)
    assert set(state.opt) == ({"m", "v", "count"}
                              if get_config(arch).optimizer == "adamw"
                              else {"f", "count"})


def test_flatten_order_is_the_references():
    keys = list(_leaves(_state("qwen2-0.5b")))
    assert keys[0] == ".params/embed/tok" and keys[-1] == ".step"
    assert keys.index(".opt/count") < keys.index(".opt/m/embed/tok") < \
        keys.index(".opt/v/embed/tok") < keys.index(".step")
    ada = list(_leaves(_state("qwen3-moe-235b-a22b")))
    assert {".opt/f/embed/tok/vr", ".opt/f/embed/tok/vc",
            ".opt/f/final_norm/scale/v"} <= set(ada)


def test_count_and_step_are_int32_scalars(tmp_path, ref):
    save_checkpoint(tmp_path, 1, _state("qwen2-0.5b"))
    leaves = json.loads((tmp_path / "step_1" / "manifest.json").read_text()
                        )["leaves"]
    want = json.loads((ref["root"] / "qwen2-0.5b" / "step_3" /
                       "manifest.json").read_text())["leaves"]
    for key in (".opt/count", ".step"):
        assert leaves[key] == want[key] == {"shape": [], "dtype": "int32"}


def test_adamw_init_keeps_lists_for_the_calibration_fit():
    from repro_torch.train.optimizer import adamw_init, opt_init
    theta = torch.zeros(3, dtype=torch.float64)
    state = adamw_init([theta])
    assert [t.dtype for t in state["m"] + state["v"]] == [torch.float32] * 2
    assert state["count"].dtype == torch.int32 and state["count"].shape == ()
    assert opt_init("adamw") is adamw_init


# -------------------------------------- across the two packages

@pytest.mark.parametrize("arch", sorted(CROSS))
def test_reference_checkpoint_restores_in_the_port(ref, tmp_path, arch):
    src = ref["root"] / arch
    assert latest_step(src) == 3
    target = _state(arch, seed=1)
    got = restore_checkpoint(src, 3, target, device="cpu")
    assert isinstance(got, TrainState)
    flat = _leaves(got)
    want = ref["arrays"][arch]
    assert list(flat) == list(want)
    for key, arr in want.items():
        t = flat[key]
        assert t.device == CPU
        assert str(t.dtype).removeprefix("torch.") == str(arr.dtype)
        assert np.array_equal(t.numpy(), arr), key
    save_checkpoint(tmp_path, 3, got)
    _assert_same_files(src / "step_3", tmp_path / "step_3")


@pytest.mark.parametrize("arch", sorted(CROSS))
def test_port_checkpoint_restores_in_the_reference(ref, tmp_path, arch):
    from repro.checkpoint import restore_checkpoint as ref_restore
    from repro.checkpoint import save_checkpoint as ref_save
    from repro.checkpoint.checkpoint import _flatten as ref_flatten
    state = _mid_run(_state(arch, seed=2), seed=2)
    save_checkpoint(tmp_path / "port", 4, state)
    got = ref_restore(tmp_path / "port", 4, ref["states"][arch])
    flat = ref_flatten(got)[0]
    mine = _leaves(state)
    assert list(flat) == list(mine)
    for key, leaf in mine.items():
        assert np.array_equal(np.asarray(flat[key]), leaf.numpy()), key
        assert str(np.asarray(flat[key]).dtype) == \
            str(leaf.dtype).removeprefix("torch.")
    ref_save(tmp_path / "ref", 4, got)
    _assert_same_files(tmp_path / "port" / "step_4",
                       tmp_path / "ref" / "step_4")


def test_bfloat16_leaf_is_written_as_the_reference_and_restores_in_neither(
        tmp_path):
    import jax.numpy as jnp
    from repro.checkpoint import restore_checkpoint as ref_restore
    from repro.checkpoint import save_checkpoint as ref_save
    vals = np.arange(-3, 3, dtype=np.float32).reshape(2, 3) / 8
    save_checkpoint(tmp_path / "port", 1,
                    {"w": torch.tensor(vals, dtype=torch.bfloat16)})
    ref_save(tmp_path / "ref", 1, {"w": jnp.asarray(vals, jnp.bfloat16)})
    _assert_same_files(tmp_path / "port" / "step_1",
                       tmp_path / "ref" / "step_1")
    manifest = json.loads((tmp_path / "port" / "step_1" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["w"] == {"shape": [2, 3], "dtype": "bfloat16"}
    for where in ("port", "ref"):
        with pytest.raises(TypeError, match="w holds raw .V2"):
            restore_checkpoint(tmp_path / where, 1,
                               {"w": torch.zeros(2, 3)}, device="cpu")
        with pytest.raises(TypeError, match=r"\|V2 is not a valid JAX"):
            ref_restore(tmp_path / where, 1,
                        {"w": jnp.zeros((2, 3), jnp.bfloat16)})


@pytest.mark.parametrize("package", ["port", "reference"])
def test_shape_mismatch_raises_the_references_error(tmp_path, package):
    import jax.numpy as jnp
    from repro.checkpoint import restore_checkpoint as ref_restore
    save_checkpoint(tmp_path, 2, {"a": torch.ones(2, 3), "b": torch.ones(4)})
    with pytest.raises(ValueError) as err:
        if package == "port":
            restore_checkpoint(tmp_path, 2, {"a": torch.ones(3, 2),
                                             "b": torch.ones(4)},
                               device="cpu")
        else:
            ref_restore(tmp_path, 2, {"a": jnp.ones((3, 2)),
                                      "b": jnp.ones(4)})
    assert str(err.value) == \
        "shape mismatch for a: ckpt (2, 3) vs target (3, 2)"


# -------------------------------- the reference's tests, on the port

def test_checkpoint_roundtrip(tmp_path):
    state = _mid_run(_state("qwen2-0.5b"), seed=1)
    save_checkpoint(tmp_path, 7, state)
    assert latest_step(tmp_path) == 7
    restored = restore_checkpoint(tmp_path, 7, state, device="cpu")
    a, b = _leaves(state), _leaves(restored)
    assert list(a) == list(b)
    for key in a:
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy())
        assert b[key].dtype == a[key].dtype
        assert b[key].untyped_storage().data_ptr() != \
            a[key].untyped_storage().data_ptr()


def test_checkpoint_gc_keeps_last_k(tmp_path):
    state = _state("qwen2-0.5b")
    for s in (1, 2, 3, 4):
        save_checkpoint(tmp_path, s, state, keep_last=2)
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]


def test_async_checkpointer(tmp_path):
    state = _state("qwen2-0.5b")
    ck = AsyncCheckpointer(tmp_path)
    ck.save(5, state)
    ck.wait()
    assert latest_step(tmp_path) == 5
    restored = restore_checkpoint(tmp_path, 5, state, device="cpu")
    np.testing.assert_array_equal(
        state.params["embed"]["tok"].numpy(),
        restored.params["embed"]["tok"].numpy())


# ---------------------------------------------- the rest of the layer

@pytest.mark.parametrize("package", ["port", "reference"])
def test_latest_step_sees_only_complete_checkpoints(tmp_path, package):
    if package == "port":
        save, latest = save_checkpoint, latest_step
    else:
        from repro.checkpoint import latest_step as latest
        from repro.checkpoint import save_checkpoint as save
    assert latest(tmp_path / "missing") is None
    save(tmp_path, 3, {"x": np.ones(2, np.float32)})
    (tmp_path / ".tmp_step_9").mkdir()
    (tmp_path / "step_8").mkdir()            # no manifest: incomplete
    assert latest(tmp_path) == 3


def test_keep_last_0_keeps_every_step(tmp_path):
    state = {"x": torch.arange(4.0)}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, state, keep_last=0)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        [f"step_{s}" for s in (1, 2, 3, 4, 5)]


@pytest.mark.parametrize("package", ["port", "reference"])
def test_failed_save_leaves_latest_step_unchanged(tmp_path, package):
    if package == "port":
        save, latest, x = save_checkpoint, latest_step, torch.ones(3)
    else:
        import jax.numpy as jnp
        from repro.checkpoint import latest_step as latest
        from repro.checkpoint import save_checkpoint as save
        x = jnp.ones(3)
    save(tmp_path, 1, {"x": x})
    with pytest.raises(RuntimeError, match="boom"):
        save(tmp_path, 2, {"x": x, "y": Boom()})
    assert latest(tmp_path) == 1
    assert not (tmp_path / "step_2").exists()


@pytest.mark.parametrize("package", ["port", "reference"])
def test_async_error_is_raised_once_on_wait(tmp_path, package):
    if package == "port":
        cls, x = AsyncCheckpointer, torch.ones(3)
    else:
        import jax.numpy as jnp
        from repro.checkpoint import AsyncCheckpointer as cls
        x = jnp.ones(3)
    (tmp_path / "file").write_text("not a directory")
    ck = cls(tmp_path / "file" / "ckpt")
    ck.save(1, {"x": x})                     # its mkdir fails in the thread
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                # raised once


@pytest.mark.parametrize("package", ["port", "reference"])
def test_async_save_of_a_leaf_without_an_array_raises_in_save(tmp_path,
                                                              package):
    """The host copy is taken in ``save``, so a leaf that cannot become an
    array raises there, before any thread starts."""
    if package == "port":
        cls = AsyncCheckpointer
    else:
        from repro.checkpoint import AsyncCheckpointer as cls
    ck = cls(tmp_path)
    with pytest.raises(RuntimeError, match="boom"):
        ck.save(1, {"y": Boom()})
    ck.wait()
    assert latest_step(tmp_path) is None


def test_in_place_update_after_async_save_does_not_reach_the_file(
        tmp_path, monkeypatch):
    """CPU tensors: ``.cpu()`` is the tensor itself, so the host copy must
    be taken before ``save`` returns.  The writer is held until the live
    state has been updated in place, so a copy taken in the thread would
    read the update."""
    state = _state("qwen2-0.5b")
    before = {k: v.clone() for k, v in _leaves(state).items()}
    updated = threading.Event()
    write = port_ckpt.save_checkpoint

    def held(*args, **kwargs):
        assert updated.wait(60)
        return write(*args, **kwargs)
    monkeypatch.setattr(port_ckpt, "save_checkpoint", held)
    ck = AsyncCheckpointer(tmp_path)
    ck.save(2, state)
    for key, leaf in _leaves(state).items():
        leaf.add_(1)
    updated.set()
    ck.wait()
    with np.load(tmp_path / "step_2" / "arrays.npz") as data:
        for key, t in before.items():
            assert np.array_equal(data[key], t.numpy()), key


# ------------------------------------------------------------ the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(CROSS))
def test_train_state_round_trips_on_the_card(tmp_path, arch):
    _needs_card()
    state = _state(arch, device="cuda")
    save_checkpoint(tmp_path, 1, state)
    got = restore_checkpoint(tmp_path, 1, state, device="cuda")
    a, b = _leaves(state), _leaves(got)
    assert list(a) == list(b)
    for key in a:
        assert b[key].is_cuda and torch.equal(a[key], b[key]), key
        assert b[key].data_ptr() != a[key].data_ptr()


@pytest.mark.cuda
def test_async_save_on_the_card_keeps_the_state_of_save(tmp_path,
                                                        monkeypatch):
    _needs_card()
    state = _state("qwen2-0.5b", device="cuda")
    before = {k: v.cpu() for k, v in _leaves(state).items()}
    updated = threading.Event()
    write = port_ckpt.save_checkpoint

    def held(*args, **kwargs):
        assert updated.wait(60)
        return write(*args, **kwargs)
    monkeypatch.setattr(port_ckpt, "save_checkpoint", held)
    ck = AsyncCheckpointer(tmp_path)
    ck.save(2, state)
    for m in _leaves(state.opt["m"]).values():
        m.add_(1)
    updated.set()
    ck.wait()
    got = restore_checkpoint(tmp_path, 2, state, device="cuda")
    for key, leaf in _leaves(got).items():
        assert torch.equal(leaf.cpu(), before[key]), key


@pytest.mark.cuda
def test_cpu_checkpoint_restores_on_the_card(tmp_path):
    _needs_card()
    state = _state("qwen3-moe-235b-a22b")
    save_checkpoint(tmp_path, 1, state)
    got = restore_checkpoint(tmp_path, 1, state, device="cuda")
    for key, leaf in _leaves(state).items():
        assert torch.equal(_leaves(got)[key].cpu(), leaf), key


# ------------------------------- chip_smoke.py's phase, rehearsed

@pytest.fixture(scope="module")
def cs():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


@pytest.fixture
def counted_flash(cs, monkeypatch):
    """The flash kernel's plain version standing in for it, counting a
    launch as its wrapper does; no nvidia-smi here."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_attention import ops as fa_ops
    real = fa_ops.flash_attention

    def fa(q, k, v, causal=True):
        flash_attention_fwd.launches += 1
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(fa_ops, "flash_attention", fa)
    monkeypatch.setattr(cs, "card_line", lambda: "cpu")


def test_ckpt_phase_data_gate_equals_the_reference(cs):
    """C1 as the card runs it, at the phase's full data size (host numpy
    either way); the digests are the reference pipeline's."""
    import hashlib
    from repro.data import DataConfig as RefConfig
    from repro.data import SyntheticLM as RefLM
    batches = cs.ckpt_data_gate()
    ref = RefLM(RefConfig(**cs.CKPT_DATA))
    for step, want in cs.REFERENCE_CKPT_BATCH_SHA256.items():
        batch = ref.global_batch_at(step)
        assert hashlib.sha256(batch.tobytes()).hexdigest() == want
        assert np.array_equal(batches[step], batch)


def test_ckpt_checks_pass_and_each_fault_breaks_its_gates(cs, counted_flash,
                                                          tmp_path, capsys):
    """The phase's checks on reduced qwen2-0.5b for both its runs (the
    card runs the first at full width): every gate passes, and each
    planted fault breaks exactly the gates ``CKPT_FAULTS`` lists."""
    from repro_torch.data import DataConfig, SyntheticLM
    cfg = reduced(get_config(cs.CKPT_ARCH))
    tokens = SyntheticLM(DataConfig(**cs.CKPT_FAULT_DATA)).global_batch_at(0)
    launches = cs.ckpt_checks(CPU, cfg, tokens, cfg, tokens, tmp_path)
    assert launches == (cfg.num_layers,) * 3
    out = capsys.readouterr().out
    for fault, gates in cs.CKPT_FAULTS.items():
        assert f"planted fault {fault}: broke {sorted(gates)}" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == []


def test_ckpt_gates_fail_a_restore_that_aliases_the_live_state(
        cs, counted_flash, tmp_path, monkeypatch):
    """A restore that hands back the live tensors (zeroed after ``wait``)
    breaks C2 and C3."""
    import repro_torch.checkpoint as ckpt
    from repro_torch.data import DataConfig, SyntheticLM
    monkeypatch.setattr(ckpt, "restore_checkpoint",
                        lambda d, s, target, device: target)
    cfg = reduced(get_config(cs.CKPT_ARCH))
    tokens = SyntheticLM(DataConfig(**cs.CKPT_FAULT_DATA)).global_batch_at(0)
    run = cs.ckpt_run(CPU, cfg, tokens, tmp_path)
    assert sorted(g for g, why in run["gates"].items() if why) == \
        ["C2", "C3"]
