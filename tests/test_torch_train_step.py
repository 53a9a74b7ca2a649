"""The port's training step (``repro_torch.train``: ``make_train_step``,
``train_step``, ``loss_and_grads``, the AdamW and Adafactor updates, int8
gradient compression, microbatches and remat) against the JAX
reference's (``repro.train``), on the CPU.

The reference runs once for the module, in a child interpreter
(``torch_reference.run_reference``), started from a thread by the
module's first test, so the port's own tests (listed first) run while it
computes; arrays travel both ways as ``.npz`` files in a tmp
dir.  Both packages get the same inputs: the reference's ``Model.init``
parameters (PRNGKey 0 of the ``unsafe_rbg`` generator, which compiles
quicker than threefry; any draw serves), converted with
``convert.lm_params_from_reference``, and token, image and frame batches
drawn with numpy from a seed.  Configs are ``reduced`` and float32: one
arch of each family (qwen2-0.5b; phi3.5-moe under both ``moe_impl``;
llava-next; mamba2-780m; zamba2-2.7b; whisper-medium) and qwen3-moe for
Adafactor.  Limits, each a leaf's largest absolute gap over the
reference's largest magnitude:

* the loss and its metrics within 1e-5 relative, every gradient leaf
  within 1e-4;
* two optimizer updates on the reference's gradients (parameters and
  moments) within 1e-6, the count equal, the global norm within 1e-6
  (AdamW on a dense and a MoE tree, Adafactor on qwen3-moe);
* int8 compression of the reference's gradients within 1e-6 of the
  reference's quantizer (a quantizer step is 1/127 of the scale).

The port alone: microbatches 2 against 1 within 1e-5 (the step's metrics
the reference's: the loss the microbatches' mean, the rest the last
one's), the remat policies
within 1e-6 (and each recomputing the products it should), a pure step,
``use_kernel=True`` raising, updates of any tree, two falling steps for
all ten archs as the reference's
``tests/test_models.py::test_smoke_train_step`` takes, and
``chip_smoke.py``'s training gates on reduced qwen2-0.5b with the CPU in
the card's place.  Every test runs its torch ops on one thread: the
suite runs several workers at once, and these ops are small.
"""
import collections
import dataclasses
import importlib.util
import math
import os
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_reference import run_reference

from repro_torch._tree import leaves, map_with_keys
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import build_model
from repro_torch.models import layers as port_layers
from repro_torch.train import (TrainState, adafactor_init,
                               clip_by_global_norm, global_norm,
                               make_train_state, make_train_step, opt_init,
                               opt_update, train_step)
from repro_torch.train.step import compress_grads, loss_and_grads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


# chip_smoke.py: its training gates (run on the CPU below) and its
# comparators (``keyed``, ``leaf_gaps``), which every test here uses
cs = _load_chip_smoke()

CPU = torch.device("cpu")
LR = 1e-3
CASES = {
    "qwen2-0.5b": ("qwen2-0.5b", {}),
    "phi3.5-moe-einsum": ("phi3.5-moe-42b-a6.6b", {"moe_impl": "einsum"}),
    "phi3.5-moe-scatter": ("phi3.5-moe-42b-a6.6b", {"moe_impl": "scatter"}),
    "llava-next": ("llava-next-mistral-7b", {}),
    "mamba2-780m": ("mamba2-780m", {}),
    "zamba2-2.7b": ("zamba2-2.7b", {}),
    "whisper-medium": ("whisper-medium", {}),
    "qwen3-moe-adafactor": ("qwen3-moe-235b-a22b", {}),
}
# the cases whose updates and int8 compression the reference also runs:
# AdamW on a dense tree and on one with 3-d expert leaves, Adafactor
UPDATED = ("qwen2-0.5b", "phi3.5-moe-scatter", "qwen3-moe-adafactor")
BATCH, SEQ = 4, 32
GRAD_LIMIT, LOSS_LIMIT, UPDATE_LIMIT = 1e-4, 1e-5, 1e-6
MICRO_LIMIT, REMAT_LIMIT = 1e-5, 1e-6

CHILD = r"""
import dataclasses
import os
# the reference's programs compile with LLVM's cheap passes (no fast-math
# either way, so the same float32 operations) and run on one thread: the
# suite runs several workers at once, and these programs are small
os.environ["XLA_FLAGS"] = ("--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import numpy as np
import jax
import jax.numpy as jnp
from repro.checkpoint.checkpoint import _flatten
from repro.configs import get_config, reduced
from repro.models import build_model
from repro.train.optimizer import opt_init, opt_update
from repro.train.step import _dequantize_int8, _quantize_int8

jax.config.update("jax_default_prng_impl", "unsafe_rbg")
root, lr = PAYLOAD["root"], PAYLOAD["lr"]
inits = {}
for name, (arch, over) in PAYLOAD["cases"].items():
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              **over)
    model = build_model(cfg)
    if arch not in inits:          # phi3.5-moe's two impls share one tree
        inits[arch] = jax.jit(model.init)(jax.random.PRNGKey(0))
    params = inits[arch]
    with np.load(f"{root}/{name}_inputs.npz") as f:
        batch = {k: jnp.asarray(f[k]) for k in f.files}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, batch)
    OUT[name] = {"loss": float(loss),
                 "metrics": {k: float(v) for k, v in metrics.items()}}
    trees = {"params": params, "grads": grads}
    if name in PAYLOAD["updated"]:
        update = opt_update(cfg.optimizer)
        step = jax.jit(lambda p, g, o: update(p, g, o, lr=lr,
                                              max_grad_norm=float("inf")))
        s1 = step(params, grads, opt_init(cfg.optimizer)(params))
        s2 = step(s1[0], grads, s1[1])
        OUT[name]["grad_norm"] = [float(s1[2]), float(s2[2])]
        trees["s1"] = {"params": s1[0], "opt": s1[1]}
        trees["s2"] = {"params": s2[0], "opt": s2[1]}
        trees["comp"] = jax.jit(lambda g: jax.tree.map(
            lambda x: _dequantize_int8(*_quantize_int8(x)), g))(grads)
    arrays = {}
    for prefix, tree in trees.items():
        for k, v in _flatten(tree)[0].items():
            arrays[f"{prefix}/{k}"] = np.asarray(v)
    np.savez(f"{root}/{name}_ref.npz", **arrays)
"""


def _cfg(name):
    arch, over = CASES[name]
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                               **over)


def _inputs(cfg, seed, b=BATCH, s=SEQ):
    """A seeded batch in numpy: tokens, and the image embeddings or the
    encoder frames the family takes (scaled by 0.1, as the reference's
    smoke batches are)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s),
                                    dtype=np.int64)}
    if cfg.family == "vlm":
        batch["image_embeds"] = (rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "encdec":
        batch["encoder_embeds"] = (rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def _batch(cfg, seed, b=BATCH, s=SEQ):
    return {k: torch.from_numpy(v)
            for k, v in _inputs(cfg, seed, b=b, s=s).items()}


def _port(name, seed=0):
    """The port's own seeded parameters for a case, and a batch."""
    cfg = _cfg(name)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    return cfg, params, _batch(cfg, seed)


def _nest(flat):
    """{"a/b": x} -> {"a": {"b": x}}."""
    out = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v
    return out


def _assert_within(gaps, limit, what):
    bad = {k: v for k, v in gaps.items() if not v <= limit}
    assert not bad, f"{what} above {limit}: {bad}"


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


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
    """The reference child, started in a thread: the inputs written,
    ``run_reference`` running.  The module's first test requests it, so
    the port's own tests run while it computes.  Yields (root, thread,
    result)."""
    root = tmp_path_factory.mktemp("train_ref")
    for i, name in enumerate(CASES):
        np.savez(root / f"{name}_inputs.npz", **_inputs(_cfg(name), seed=i))
    result = {}

    def run():
        try:
            result["out"] = run_reference(CHILD, {
                "root": str(root), "lr": LR, "cases": CASES,
                "updated": list(UPDATED)})
        except BaseException as e:           # re-raised by ``ref``
            result["error"] = e
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    yield root, thread, result
    thread.join()


@pytest.fixture(scope="module")
def ref(reference_child):
    """The reference's results by case: its loss and metrics and grad
    norms (``OUT``), the batch, and its arrays by
    prefix (params, grads; s1, s2 and comp for ``UPDATED``) as {key:
    numpy array}."""
    root, thread, result = reference_child
    thread.join()
    if "error" in result:
        raise result["error"]
    out = result["out"]
    for name in CASES:
        with np.load(root / f"{name}_ref.npz") as f:
            arrays = {k: f[k] for k in f.files}
        with np.load(root / f"{name}_inputs.npz") as f:
            out[name]["batch"] = {k: torch.from_numpy(f[k]) for k in f.files}
        for prefix in ("params", "grads", "comp", "s1", "s2"):
            out[name][prefix] = {k[len(prefix) + 1:]: v
                                 for k, v in arrays.items()
                                 if k.startswith(prefix + "/")}
    return out


def _params(ref, name):
    return lm_params_from_reference(_nest(ref[name]["params"]), _cfg(name),
                                    device="cpu")


def _grads(ref, name):
    return map_with_keys(lambda _, a: torch.from_numpy(a.copy()),
                         _nest(ref[name]["grads"]))


# ------------------------------------------------ the port on its own


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_train_step(arch, reference_child):
    """The port's own two steps on every arch, reduced and as configured
    (bf16 compute): the loss finite and falling.  (It starts the
    reference child, which the tests at the end of the module read.)"""
    cfg = reduced(get_config(arch))
    state = make_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step, _ = make_train_step(cfg, lr=1e-3, device="cpu")
    batch = _batch(cfg, seed=7, b=2, s=64)
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)
    assert math.isfinite(float(m1["loss"]))
    assert float(m2["loss"]) < float(m1["loss"]), (arch, m1["loss"],
                                                   m2["loss"])


@pytest.mark.parametrize("name", CASES)
def test_microbatches_match_one_batch(name):
    """The loss and gradients of two microbatches against one batch
    (1e-5).  The vlm family's loss divides by one row's label count (its
    mask is (1, S), as the reference's), so there a batch's loss is the
    sum of its rows' means and each microbatch's half of it."""
    cfg, params, batch = _port(name)
    model = build_model(cfg, device="cpu")
    loss1, _, g1 = loss_and_grads(model, params, batch)
    loss2, _, g2 = loss_and_grads(model, params, batch, microbatches=2)
    if cfg.family == "vlm":
        loss2 = loss2 * 2
        g2 = map_with_keys(lambda _, g: g * 2, g2)
    assert _rel(float(loss2), float(loss1)) <= MICRO_LIMIT
    _assert_within(cs.leaf_gaps(g2, g1), MICRO_LIMIT,
                   f"{name} microbatches")


@pytest.mark.parametrize("name", ["qwen2-0.5b", "phi3.5-moe-scatter"])
def test_microbatched_step_metrics(name):
    """The microbatched step's metrics as the reference's step forms them
    (``src/repro/train/step.py:69-79``): the loss the mean of the
    microbatches' losses, the other metrics the last microbatch's, and
    ``grad_norm`` the norm of the averaged gradients."""
    cfg, params, batch = _port(name)
    model = build_model(cfg, device="cpu")
    halves = [{k: v[i * BATCH // 2:(i + 1) * BATCH // 2]
               for k, v in batch.items()} for i in range(2)]
    losses = [model.loss(params, half) for half in halves]
    _, _, grads = loss_and_grads(model, params, batch, microbatches=2)
    step, _ = make_train_step(cfg, lr=LR, microbatches=2, device="cpu")
    state = TrainState(params, opt_init(cfg.optimizer)(params),
                       torch.zeros((), dtype=torch.int32))
    _, metrics = step(state, batch)
    want = (losses[0][0] + losses[1][0]) / 2
    assert _rel(float(metrics["loss"]), float(want)) <= LOSS_LIMIT
    for key in ("ce", "aux", "tokens"):
        assert abs(float(metrics[key]) - float(losses[1][1][key])) \
            <= LOSS_LIMIT * max(1.0, abs(float(losses[1][1][key]))), key
    assert torch.equal(metrics["grad_norm"], global_norm(grads))
    if "moe" in params["layers"]:
        assert float(metrics["aux"]) > 0


@pytest.mark.parametrize("name", ["qwen2-0.5b", "phi3.5-moe-scatter",
                                  "mamba2-780m", "zamba2-2.7b",
                                  "whisper-medium"])
def test_remat_policies_agree(name):
    cfg, params, batch = _port(name)
    base = None
    for policy in ("none", "full", "dots", "dots_nb"):
        model = build_model(dataclasses.replace(cfg, remat=policy),
                            device="cpu")
        loss, _, grads = loss_and_grads(model, params, batch)
        if base is None:
            base = (float(loss), grads)
            continue
        assert _rel(float(loss), base[0]) <= REMAT_LIMIT, policy
        _assert_within(cs.leaf_gaps(grads, base[1]), REMAT_LIMIT, policy)


class _Products(TorchDispatchMode):
    """Counts the matrix products run (forward, backward and recompute)."""

    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm", "bmm", "baddbmm"):
            self.count[name] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_save_what_they_name():
    """"full" recomputes every product in the backward pass, "dots" none,
    "dots_nb" the batched ones only (the attention's); "none" keeps
    everything, so it runs each product once."""
    cfg, params, batch = _port("qwen2-0.5b")
    runs = {}
    for policy in ("none", "full", "dots", "dots_nb"):
        model = build_model(dataclasses.replace(cfg, remat=policy),
                            device="cpu")
        with _Products() as products:
            loss_and_grads(model, params, batch)
        runs[policy] = products.count
    none = runs["none"]
    assert none["mm"] > 0 and none["bmm"] > 0
    assert runs["dots"] == none
    assert runs["dots_nb"]["mm"] == none["mm"]
    assert runs["dots_nb"]["bmm"] > none["bmm"]
    assert runs["full"]["mm"] > none["mm"]
    assert runs["full"]["bmm"] == runs["dots_nb"]["bmm"]


def test_scoring_builds_no_graph():
    """With parameters that require no grad, ``Model.loss`` scores as it
    did: no graph, no remat, the same value with the kernel's CPU path."""
    cfg, params, batch = _port("qwen2-0.5b")
    loss, _ = build_model(cfg, device="cpu").loss(params, batch)
    assert not loss.requires_grad and loss.grad_fn is None
    kernel, _ = build_model(cfg, use_kernel=True, device="cpu").loss(params,
                                                                     batch)
    assert _rel(float(kernel), float(loss)) <= LOSS_LIMIT


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen3-moe-adafactor"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_is_pure(name, microbatches):
    """The input state and batch are left as they were, no ``.grad`` is
    filled, and the new state is new tensors with ``step + 1`` a 0-d
    int32."""
    cfg, params, batch = _port(name)
    state = TrainState(params, opt_init(cfg.optimizer)(params),
                       torch.zeros((), dtype=torch.int32))
    before = {k: v.clone() for k, v in cs.keyed(state).items()}
    tokens = batch["tokens"].clone()
    new, metrics = train_step(cfg, state, batch, lr=LR,
                              microbatches=microbatches, device="cpu")
    for key, leaf in cs.keyed(state).items():
        assert torch.equal(leaf, before[key]), key
        assert leaf.grad is None and not leaf.requires_grad, key
    assert torch.equal(batch["tokens"], tokens)
    ptrs = {t.untyped_storage().data_ptr() for t in leaves(state)}
    for key, leaf in cs.keyed(new).items():
        assert not leaf.requires_grad, key
        assert leaf.untyped_storage().data_ptr() not in ptrs, key
    assert new.step.dtype == torch.int32 and new.step.shape == ()
    assert int(new.step) == 1 and int(new.opt["count"]) == 1
    assert sorted(metrics) == ["aux", "ce", "grad_norm", "loss", "tokens"]
    assert isinstance(new, TrainState)


def test_use_kernel_raises_on_the_cpu():
    cfg = reduced(get_config("qwen2-0.5b"))
    with pytest.raises(RuntimeError, match="no backward"):
        make_train_step(cfg, use_kernel=True, device="cpu")
    state = make_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.long)}
    with pytest.raises(RuntimeError, match="no backward"):
        train_step(cfg, state, batch, use_kernel=True, device="cpu")


def test_the_step_runs_on_the_card_unless_asked():
    cfg = reduced(get_config("qwen2-0.5b"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError):
        make_train_step(cfg)


@pytest.mark.parametrize("tree", ["list", "tuple", "dict", "namedtuple"])
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_updates_take_any_tree(tree, opt):
    """An update of a tree steps each leaf as the update of the flat list
    in flatten order does, bit for bit, and returns the tree's
    containers; calibration steps ``[theta]`` this way."""
    gen = torch.Generator().manual_seed(3)
    flat = [torch.randn(3, 4, generator=gen), torch.randn(5, generator=gen),
            torch.randn(2, 3, 2, generator=gen)]
    grads = [torch.randn(t.shape, generator=gen) for t in flat]
    pair = collections.namedtuple("Pair", "b a c")
    make = {"list": list, "tuple": tuple,
            "dict": lambda xs: {"z": xs[2], "b": xs[0], "m": xs[1]},
            "namedtuple": lambda xs: pair(*xs)}[tree]
    params, gtree = make(flat), make(grads)
    order = leaves(params)
    update = opt_update(opt)
    want_p, want_o, want_gn = update(
        order, leaves(gtree), opt_init(opt)(order), lr=LR)
    got_p, got_o, got_gn = update(params, gtree, opt_init(opt)(params),
                                  lr=LR)
    assert type(got_p) is type(params)
    assert torch.equal(got_gn, want_gn)
    for a, b in zip(leaves(got_p), want_p):
        assert torch.equal(a, b)
    moments = ("m", "v") if opt == "adamw" else ("f",)
    for key in moments:
        for a, b in zip(leaves(got_o[key]), leaves(want_o[key])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_updates_refuse_gradients_of_another_tree(opt):
    params = [torch.ones(3, 4), torch.ones(5)]
    with pytest.raises(ValueError, match="1 leaves for 2 parameters"):
        opt_update(opt)(params, [torch.ones(3, 4)], opt_init(opt)(params),
                        lr=LR)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_clipped_update_is_the_update_of_scaled_gradients(opt):
    """With the clip on, an update equals the unclipped update of the
    gradients scaled by min(1, max_grad_norm / norm), bit for bit, and
    returns the norm before the clip."""
    name = "qwen2-0.5b" if opt == "adamw" else "qwen3-moe-adafactor"
    cfg, params, batch = _port(name)
    _, _, grads = loss_and_grads(build_model(cfg, device="cpu"), params,
                                 batch)
    update = opt_update(opt)
    got_p, got_o, gn = update(params, grads, opt_init(opt)(params), lr=LR,
                              max_grad_norm=0.5)
    scaled, gn2 = clip_by_global_norm(grads, 0.5)
    assert float(gn) > 0.5 and torch.equal(gn, gn2)
    assert torch.equal(gn, global_norm(grads))
    want_p, want_o, _ = update(params, scaled, opt_init(opt)(params), lr=LR,
                               max_grad_norm=math.inf)
    for a, b in zip(leaves((got_p, got_o)), leaves((want_p, want_o))):
        assert torch.equal(a, b)


def test_adafactor_factors_leaves_of_two_axes():
    params = {"w": torch.ones(3, 4, 5), "b": torch.ones(5)}
    state = adafactor_init(params)
    grads = {"w": torch.full((3, 4, 5), 0.5), "b": torch.full((5,), 0.5)}
    _, new, _ = opt_update("adafactor")(params, grads, state, lr=LR)
    assert new["f"]["w"]["vr"].shape == (3, 4)
    assert new["f"]["w"]["vc"].shape == (3, 5)
    assert new["f"]["b"]["v"].shape == (5,)
    assert int(new["count"]) == 1
    for leaf in leaves(state):
        assert float(leaf.abs().max()) == 0.0      # the input is untouched


def test_flash_wrapper_refuses_inputs_that_require_grad(monkeypatch):
    """The kernel writes its output through raw pointers, so it would come
    back without a ``grad_fn``: the wrapper refuses such inputs before any
    launch, as ``ssd_scan``'s does (the device is faked as a card's)."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    q = torch.randn(1, 8, 1, 2, 32, requires_grad=True)
    k = torch.randn(1, 8, 1, 32)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda", 0)))
    before = flash_attention_fwd.launches
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_fwd(q, k, k.clone())
    assert flash_attention_fwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["flash_attention_fwd", "ssd_scan"])
def test_cuda_wrappers_refuse_inputs_that_require_grad(wrapper):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    if wrapper == "flash_attention_fwd":
        from repro_torch.kernels.flash_attention import flash_attention_fwd
        q = torch.randn(1, 64, 1, 2, 64, device=dev, requires_grad=True)
        k = torch.randn(1, 64, 1, 64, device=dev)
        call = lambda: flash_attention_fwd(q, k, k.clone())     # noqa: E731
        counted = flash_attention_fwd
    else:
        from repro_torch.kernels.ssd_scan import ssd_scan
        x = torch.randn(1, 64, 2, 8, device=dev, requires_grad=True)
        bc = torch.randn(1, 64, 2, 16, device=dev)
        call = lambda: ssd_scan(x, torch.rand(1, 64, 2, device=dev),  # noqa
                                -torch.ones(2, device=dev), bc, bc.clone(),
                                64)
        counted = ssd_scan
    before = counted.launches
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert counted.launches == before
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    assert counted.launches == before + 1


def test_chip_train_checks_on_the_cpu(capsys):
    """``chip_smoke.py``'s training gates on reduced qwen2-0.5b, the CPU
    standing in for the card: T1-T6 pass, each planted fault breaks
    exactly its gates (``train_checks`` checks both), and no kernel's
    plain version counts a launch."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    cfg = reduced(get_config(cs.TRAIN_ARCH))
    tokens = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    global_batch=4, seed=0)).global_batch_at(0)
    before = flash_attention_fwd.launches
    out = cs.train_checks(CPU, cfg, tokens)
    assert flash_attention_fwd.launches == before
    assert set(out["remat"]) == set(cs.TRAIN_REMAT)
    assert out["f32_loss"] > 0 and out["bf16_loss"] > 0
    text = capsys.readouterr().out
    for fault, gates in cs.TRAIN_FAULTS.items():
        assert f"planted fault {fault}: broke {sorted(gates)}" in text
    assert "planted fault None: broke []" in text


# ------------------------------------------ the port against the reference


@pytest.mark.parametrize("name", CASES)
def test_loss_and_grads_match_reference(ref, name):
    cfg = _cfg(name)
    model = build_model(cfg, device="cpu")
    loss, metrics, grads = loss_and_grads(model, _params(ref, name),
                                          ref[name]["batch"])
    want = ref[name]
    assert _rel(float(loss), want["loss"]) <= LOSS_LIMIT
    assert sorted(metrics) == sorted(want["metrics"])
    assert float(metrics["tokens"]) == want["metrics"]["tokens"]
    assert _rel(float(metrics["ce"]), want["metrics"]["ce"]) <= LOSS_LIMIT
    assert abs(float(metrics["aux"]) - want["metrics"]["aux"]) \
        <= LOSS_LIMIT * max(1.0, abs(want["metrics"]["aux"]))
    _assert_within(cs.leaf_gaps(grads, want["grads"]), GRAD_LIMIT,
                   f"{name} gradients")


@pytest.mark.parametrize("name", UPDATED)
def test_update_on_the_reference_gradients_matches(ref, name):
    """Two steps of ``opt_update(cfg.optimizer)`` from ``opt_init`` on the
    reference's gradients: parameters and moments within 1e-6, the counts
    and the global norms as the reference's.  Both take them with the clip
    off (``max_grad_norm=inf``): the reference's float32 norm is up to
    ~5e-7 off its float64 value on these gradients (XLA's summation
    order), and the clip's scale enters ``v`` squared, which is no
    difference of the updates.  The clip itself is held above."""
    cfg = _cfg(name)
    params, grads = _params(ref, name), _grads(ref, name)
    update = opt_update(cfg.optimizer)
    p1, o1, gn1 = update(params, grads, opt_init(cfg.optimizer)(params),
                         lr=LR, max_grad_norm=math.inf)
    p2, o2, gn2 = update(p1, grads, o1, lr=LR, max_grad_norm=math.inf)
    for got, step in (({"params": p1, "opt": o1}, "s1"),
                      ({"params": p2, "opt": o2}, "s2")):
        want = ref[name][step]
        assert int(got["opt"]["count"]) == int(want["opt/count"])
        _assert_within(cs.leaf_gaps(got, want), UPDATE_LIMIT,
                       f"{name} {step}")
    for got, want in zip((gn1, gn2), ref[name]["grad_norm"]):
        assert _rel(float(got), want) <= UPDATE_LIMIT
    assert set(o1) == ({"m", "v", "count"} if cfg.optimizer == "adamw"
                       else {"f", "count"})


@pytest.mark.parametrize("name", UPDATED)
def test_grad_compression_matches_the_reference_quantizer(ref, name):
    grads = _grads(ref, name)
    got = cs.keyed(compress_grads(grads))
    # the reference's jit may form max|g| / 127 and g / scale as products
    # with reciprocals, an ulp away; a step of the quantizer is 1 / 127 of
    # the leaf's scale, far above this limit
    _assert_within(cs.leaf_gaps(got, ref[name]["comp"]), UPDATE_LIMIT,
                   f"{name} int8 compression")
    # each element within half a step of the original, up to the float32
    # roundings of g / scale and q * scale
    for key, g in cs.keyed(grads).items():
        half = float(g.abs().max()) / 254.0
        assert float((got[key] - g).abs().max()) <= half * (1 + 254 * 2**-23)


def test_planted_gradient_cut_fails_the_comparator(ref, monkeypatch):
    """Layer 1's attention output detached: the loss is unchanged, and the
    gradient comparison must fail on that layer's attention leaves."""
    name = "qwen2-0.5b"
    cfg = _cfg(name)
    real = port_layers.apply_attention

    def cut(p, x, *args, **kwargs):
        out, kv = real(p, x, *args, **kwargs)
        wq = p["wq"]
        return (out.detach() if wq.storage_offset() == wq.numel() else out,
                kv)
    monkeypatch.setattr(port_layers, "apply_attention", cut)
    loss, _, grads = loss_and_grads(build_model(cfg, device="cpu"),
                                    _params(ref, name), ref[name]["batch"])
    assert _rel(float(loss), ref[name]["loss"]) <= LOSS_LIMIT
    gaps = cs.leaf_gaps(grads, ref[name]["grads"])
    with pytest.raises(AssertionError, match="layers/attn/wq"):
        _assert_within(gaps, GRAD_LIMIT, f"{name} gradients")
    layer1 = grads["layers"]["attn"]["wo"][1]
    assert float(layer1.abs().max()) == 0.0
