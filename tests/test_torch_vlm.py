"""The port's vlm family (image embeddings prepended to the dense stack,
repro_torch.models.lm, ServeEngine) against the JAX reference, on the
CPU.

Weights are the reference's own ``Model.init`` tree for
``reduced(llava-next-mistral-7b)`` (2 layers, d 128, 4 heads of 32, 8
image tokens, vocab 512), converted with ``lm_params_from_reference``;
image embeddings are seeded normals times 0.1, as the reference's smoke
tests draw them (``tests/test_models.py:25-27``).  Limits, as the largest
absolute gap over the reference's largest magnitude: 1e-4 in float32, 5e-2
in bfloat16; the loss mask and labels equal.  Greedy tokens and engine
stats must equal the reference engine's (zero image prefix), run in a
child interpreter (``repro.serve`` needs the ``enable_x64`` alias).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import build_model, param_layout
from repro_torch.serve import Request, ServeEngine
from torch_reference import run_reference

ARCH = "llava-next-mistral-7b"
LIMIT = {"float32": 1e-4, "bfloat16": 5e-2}
N_IMG = 8                                  # reduced config's image tokens
PROMPT, DECODE_STEPS = 24, 6
MAX_LEN = N_IMG + 40
NEW_TOKENS = [5, 8, 3, 6, 4, 7]            # 6 requests: waves of 4 and 2


def _cfg_pair(dtype):
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    return (dataclasses.replace(jreduced(jget(ARCH)), dtype=dtype),
            dataclasses.replace(reduced(get_config(ARCH)), dtype=dtype))


@pytest.fixture(scope="module")
def ref_params():
    import jax
    from repro.models import build_model as jbuild
    jcfg, _ = _cfg_pair("float32")
    return jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))


def _gap(got, want) -> float:
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _batch(seed, b, s, vocab=512):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "image_embeds": (rng.standard_normal((b, N_IMG, 128))
                             * 0.1).astype(np.float32)}


def _jax(batch):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_config_is_the_reduced_reference():
    _, cfg = _cfg_pair("float32")
    assert (cfg.family, cfg.n_image_tokens, cfg.head_dim) == ("vlm", N_IMG,
                                                              32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_and_loss_match_reference(ref_params, use_kernel, dtype):
    """Logits over image and text positions, the loss mask (1, S) that
    starts after the image, the rolled labels, and the loss."""
    import jax
    from repro.models import build_model as jbuild
    jcfg, cfg = _cfg_pair(dtype)
    batch = _batch(2, 2, 32)
    jmodel = jbuild(jcfg, use_kernel=use_kernel)
    jlogits, (jaux, jmask, jlabels) = jax.jit(jmodel.forward)(
        ref_params, _jax(batch))
    jloss, jm = jax.jit(jmodel.loss)(ref_params, _jax(batch))
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    model = build_model(cfg, use_kernel=use_kernel, device="cpu")
    with torch.inference_mode():
        logits, (aux, mask, labels) = model.forward(params, _torch(batch))
        loss, m = model.loss(params, _torch(batch))
    assert logits.shape == (2, N_IMG + 32, cfg.vocab_padded)
    assert _gap(logits, jlogits) <= LIMIT[dtype]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert mask.shape == (1, N_IMG + 32)
    assert float(mask[0, :N_IMG].sum()) == 0 and float(mask[0, -1]) == 0
    for got, want in ((loss, jloss), (m["ce"], jm["ce"]),
                      (m["tokens"], jm["tokens"])):
        assert abs(float(got) - float(want)) <= LIMIT[dtype] * abs(
            float(want))
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_match_reference(ref_params, use_kernel, dtype):
    """Prefill of image + prompt (logits, K/V cache with the image's keys
    first), then decode steps, against the reference fed the same
    weights, image and tokens."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jbuild
    jcfg, cfg = _cfg_pair(dtype)
    jmodel = jbuild(jcfg, use_kernel=use_kernel)
    model = build_model(cfg, use_kernel=use_kernel, device="cpu")
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    batch = _batch(1, 2, PROMPT + DECODE_STEPS)
    pre = dict(batch, tokens=batch["tokens"][:, :PROMPT])
    jcache, jlogits = jax.jit(lambda p, b: jmodel.prefill(
        p, b, max_len=MAX_LEN))(ref_params, _jax(pre))
    with torch.inference_mode():
        cache, logits = model.prefill(params, _torch(pre), max_len=MAX_LEN)
    assert cache["len"] == int(jcache["len"]) == N_IMG + PROMPT
    for got, want in ((logits, jlogits), (cache["k"], jcache["k"]),
                      (cache["v"], jcache["v"])):
        assert _gap(got, want) <= LIMIT[dtype]
    decode = jax.jit(jmodel.decode)
    for n in range(PROMPT, PROMPT + DECODE_STEPS):
        nt = batch["tokens"][:, n:n + 1]
        jcache, jlogits = decode(ref_params, jcache, jnp.asarray(nt))
        with torch.inference_mode():
            cache, logits = model.decode(params, cache, torch.from_numpy(nt))
        assert cache["len"] == int(jcache["len"])
        for got, want in ((logits, jlogits), (cache["k"], jcache["k"]),
                          (cache["v"], jcache["v"])):
            assert _gap(got, want) <= LIMIT[dtype], n


def test_decode_matches_teacher_forcing(ref_params):
    """The port's ``tests/test_models.py:58-80`` for the vlm family:
    prefill of the image and 31 tokens, then one decode step, give the
    forward's logits at the same positions (float32, 2e-3 of scale)."""
    _, cfg = _cfg_pair("float32")
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    model = build_model(cfg, device="cpu")
    batch = _torch(_batch(3, 2, 32))
    with torch.inference_mode():
        logits, _ = model.forward(params, batch)
        pre = dict(batch, tokens=batch["tokens"][:, :31])
        cache, lg_pre = model.prefill(params, pre, max_len=N_IMG + 32)
        cache, lg_dec = model.decode(params, cache, batch["tokens"][:, 31:])
    scale = float(logits.abs().max())
    np.testing.assert_allclose(lg_pre.numpy(), logits[:, N_IMG + 30].numpy(),
                               atol=2e-3 * scale)
    np.testing.assert_allclose(lg_dec.numpy(), logits[:, N_IMG + 31].numpy(),
                               atol=2e-3 * scale)


def test_prefill_counts_the_image_against_max_len(ref_params):
    _, cfg = _cfg_pair("float32")
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    model = build_model(cfg, device="cpu")
    batch = _torch(_batch(4, 1, 12))
    with torch.inference_mode():
        cache, _ = model.prefill(params, batch, max_len=N_IMG + 12)
        assert cache["len"] == N_IMG + 12
        with pytest.raises(ValueError, match="max_len"):
            model.prefill(params, batch, max_len=N_IMG + 11)


def test_param_layout_matches_reference_tree(ref_params):
    import jax
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    _, cfg = _cfg_pair("float32")

    def shapes(layout):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v[0])
                for k, v in layout.items()}
    assert shapes(param_layout(cfg)) == jax.tree.map(
        lambda a: tuple(a.shape), ref_params)
    full = jax.eval_shape(jbuild(jget(ARCH)).init, jax.random.PRNGKey(0))
    assert shapes(param_layout(get_config(ARCH))) == jax.tree.map(
        lambda a: tuple(a.shape), full)


SERVE_CHILD = r"""
import dataclasses
import jax
import numpy as np
from repro.configs import get_config, reduced
from repro.serve import Request, ServeEngine

cfg = dataclasses.replace(reduced(get_config(PAYLOAD["arch"])),
                          dtype="float32")
params = ServeEngine(cfg, None).model.init(jax.random.PRNGKey(0))
eng = ServeEngine(cfg, params, batch_slots=PAYLOAD["slots"],
                  max_len=PAYLOAD["max_len"])
warm = eng.warm(PAYLOAD["warm"])
reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=n)
        for i, (p, n) in enumerate(zip(PAYLOAD["prompts"], PAYLOAD["new"]))]
out = eng.run(reqs)
OUT.update(tokens={str(k): v for k, v in out.items()}, stats=eng.stats,
           warm=warm)
"""


@pytest.fixture(scope="module")
def ref_serve():
    prompts = np.random.default_rng(5).integers(
        0, 512, (len(NEW_TOKENS), 10)).tolist()
    return prompts, run_reference(SERVE_CHILD, {
        "arch": ARCH, "slots": 4, "max_len": MAX_LEN, "warm": [10],
        "prompts": prompts, "new": NEW_TOKENS})


@pytest.mark.parametrize("use_kernel", [True, False])
def test_serve_engine_matches_reference(ref_params, ref_serve, use_kernel):
    """Each request prefilled behind a zero image prefix, as the
    reference's engine serves it; ``max_len`` covers image, prompt and
    new tokens."""
    prompts, want = ref_serve
    _, cfg = _cfg_pair("float32")
    params = lm_params_from_reference(ref_params, cfg, device="cpu")
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=MAX_LEN,
                      use_kernel=use_kernel, device="cpu")
    warm = eng.warm([10])
    out = eng.run([Request(rid=i, prompt=np.asarray(p, np.int32),
                           max_new_tokens=n)
                   for i, (p, n) in enumerate(zip(prompts, NEW_TOKENS))])
    assert [len(out[i]) for i in range(len(NEW_TOKENS))] == NEW_TOKENS
    assert {str(k): v for k, v in out.items()} == want["tokens"]
    assert eng.stats == want["stats"]
    assert warm == want["warm"]


@pytest.mark.cuda
def test_cuda_model_matches_the_cpu():
    """On the card, with the flash kernel in each layer's attention (the
    image and text positions, a ragged length): the same float32 logits,
    prefill and decode as the CPU's plain path, from the same seeded
    weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = _torch(_batch(6, 2, 37))
    got = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        model = build_model(cfg, use_kernel=True, device=dev)
        before = flash_attention_fwd.launches
        with torch.inference_mode():
            logits, _ = model.forward(p, b)
            pre = dict(b, tokens=b["tokens"][:, :36])
            cache, last = model.prefill(p, pre, max_len=N_IMG + 37)
            _, step = model.decode(p, cache, b["tokens"][:, 36:])
        got[dev] = ([t.cpu() for t in (logits, last, step)],
                    flash_attention_fwd.launches - before)
    assert got["cpu"][1] == 0 and got["cuda"][1] == 2 * cfg.num_layers
    for a, b in zip(got["cuda"][0], got["cpu"][0]):
        assert _gap(a, b.numpy()) <= LIMIT["float32"]


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}
