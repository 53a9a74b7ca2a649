"""The port's encdec family (whisper-medium: a non-causal encoder over
stub audio frames, a decoder with causal self-attention and
cross-attention) against the JAX reference, on the CPU.

Weights are the reference's own ``Model.init`` tree, converted with
``lm_params_from_reference``, for two configs: ``reduced(whisper-medium)``
(2 encoder + 2 decoder layers, d 128, 4 heads of 32, 16 frames, vocab
512) and whisper-medium's full widths cut to 2 + 2 layers ("wide": d 1024,
16 heads of 64, d_ff 4096, 1500 frames, vocab 51,865 padded to 51,968).
Encoder inputs are seeded normals x 0.1, as the reference's model tests
draw them.  Limits, as the largest absolute gap over the reference's
largest magnitude (logits over the real vocabulary: the padded entries are
-1e30 in both): 1e-4 in float32, 5e-2 in bfloat16.  Greedy tokens and
engine stats must be equal.  The reference engine runs in a child
interpreter (``repro.serve`` imports ``repro.core``, which needs the
``enable_x64`` alias).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import build_model, layers, param_layout
from repro_torch.models import lm as lm_mod
from repro_torch.serve import Request, ServeEngine
from torch_reference import run_reference

LIMIT = {"float32": 1e-4, "bfloat16": 5e-2}
SEQ, PROMPT, MAX_LEN, DECODE_STEPS = 32, 24, 40, 8
NEW_TOKENS = [5, 8, 3, 6, 4, 7]           # 6 requests: waves of 4 and 2
# case -> overrides of whisper-medium (reduced(...) for "reduced")
CASES = {"reduced": None,
         "wide": {"num_layers": 2, "num_encoder_layers": 2}}


def _cfg_pair(case, dtype):
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced

    def make(get, red):
        base = get("whisper-medium")
        over = CASES[case]
        cfg = red(base) if over is None else dataclasses.replace(base,
                                                                 **over)
        return dataclasses.replace(cfg, dtype=dtype)
    return make(jget, jreduced), make(get_config, reduced)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameter tree (numpy) of a case, drawn once."""
    import jax
    from repro.models import build_model as jbuild
    trees = {}

    def get(case):
        if case not in trees:
            jcfg, _ = _cfg_pair(case, "float32")
            trees[case] = jax.tree.map(
                np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
        return trees[case]
    return get


def _gap(got, want, vocab=None) -> float:
    got = got.float().numpy() if torch.is_tensor(got) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    return float(np.abs(got - want).max() / np.abs(want).max())


def _batch(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    enc = (rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
           * 0.1).astype(np.float32)
    return toks, enc


@pytest.mark.parametrize("case", sorted(CASES))
def test_configs_are_the_documented_ones(case):
    _, cfg = _cfg_pair(case, "float32")
    assert (cfg.family, cfg.num_layers, cfg.num_encoder_layers,
            cfg.norm, cfg.act, cfg.attn_block) == (
        "encdec", 2, 2, "ln", "gelu", 2048)
    if case == "reduced":
        assert (cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
                cfg.encoder_seq, cfg.vocab_size) == (128, 4, 32, 16, 512)
    else:
        assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.resolved_head_dim, cfg.d_ff, cfg.encoder_seq,
                cfg.vocab_size, cfg.vocab_padded) == (
            1024, 16, 16, 64, 4096, 1500, 51865, 51968)


@pytest.mark.parametrize("case", sorted(CASES))
def test_param_layout_matches_reference_tree(ref_params, case):
    """Same keys and shapes as the reference's init: ``enc_layers`` (the
    dense layer tree), ``enc_norm`` and decoder layers of {ln1, attn, lnx,
    cross, ln2, mlp}; for the wide case also whisper-medium's full tree
    (shapes only, no weights drawn)."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    _, cfg = _cfg_pair(case, "float32")

    def shapes(layout):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v[0])
                for k, v in layout.items()}
    want = jax.tree.map(lambda a: tuple(a.shape), ref_params(case))
    assert shapes(param_layout(cfg)) == want
    assert set(want) == {"embed", "final_norm", "layers", "enc_layers",
                         "enc_norm"}
    assert set(want["layers"]) == {"ln1", "attn", "lnx", "cross", "ln2",
                                   "mlp"}
    if case == "wide":
        full = jax.eval_shape(jbuild(jget("whisper-medium")).init,
                              jax.random.PRNGKey(0))
        assert shapes(param_layout(get_config("whisper-medium"))) == \
            jax.tree.map(lambda a: tuple(a.shape), full)


@pytest.fixture(scope="module")
def ref_forward(ref_params):
    """The reference's forward (logits, mask, labels) and loss (loss, ce,
    tokens) on a case's seeded batch, once per (case, dtype): the
    reference ignores ``use_kernel`` for this family, as the port does."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jbuild
    out = {}

    def get(case, dtype):
        if (case, dtype) not in out:
            jcfg, cfg = _cfg_pair(case, dtype)
            toks, enc = _batch(cfg, 2, 2, SEQ)
            batch = {"tokens": jnp.asarray(toks),
                     "encoder_embeds": jnp.asarray(enc)}
            jmodel = jbuild(jcfg)
            logits, (_, mask, labels) = jax.jit(jmodel.forward)(
                ref_params(case), batch)
            loss, metrics = jax.jit(jmodel.loss)(ref_params(case), batch)
            out[case, dtype] = (toks, enc, np.asarray(logits, np.float32),
                                np.asarray(mask), np.asarray(labels),
                                float(loss), float(metrics["ce"]),
                                float(metrics["tokens"]))
        return out[case, dtype]
    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_loss_match_reference(ref_params, ref_forward, case,
                                          use_kernel, dtype):
    """Logits, mask and labels of ``forward``, and ``loss`` with its
    metrics, with the reference fed the same weights, tokens and encoder
    inputs; the port gives the same answer with and without
    ``use_kernel``."""
    _, cfg = _cfg_pair(case, dtype)
    toks, enc, jlogits, jmask, jlabels, jloss, jce, jtokens = ref_forward(
        case, dtype)
    model = build_model(cfg, use_kernel=use_kernel, device="cpu")
    params = lm_params_from_reference(ref_params(case), cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(toks),
             "encoder_embeds": torch.from_numpy(enc)}
    with torch.inference_mode():
        logits, (aux, mask, labels) = model.forward(params, batch)
    loss, metrics = model.loss(params, batch)
    assert logits.dtype == model.dtype and logits.shape == jlogits.shape
    assert _gap(logits, jlogits, cfg.vocab_size) <= LIMIT[dtype]
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_array_equal(labels.numpy(), jlabels)
    assert float(aux) == 0.0
    for got, want in ((loss, jloss), (metrics["ce"], jce)):
        assert abs(float(got) - want) <= LIMIT[dtype] * abs(want)
    assert float(metrics["tokens"]) == jtokens


def _leaves(tree):
    return {k: v for k, v in tree.items() if k != "len"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_reference(ref_params, case, dtype):
    """Prefill logits and every cache leaf (k, v, ck, cv, len) at
    S = 24, then 8 decode steps (logits and caches); ``init_cache`` with
    ``enc_len`` 0 and 5 gives the reference's shapes."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jbuild
    jcfg, cfg = _cfg_pair(case, dtype)
    jmodel = jbuild(jcfg)
    model = build_model(cfg, device="cpu")
    params = lm_params_from_reference(ref_params(case), cfg, device="cpu")
    toks, enc = _batch(cfg, 1, 2, PROMPT + DECODE_STEPS)
    v = cfg.vocab_size
    for enc_len in (0, 5):
        want = jmodel.init_cache(2, MAX_LEN, enc_len=enc_len)
        got = model.init_cache(2, MAX_LEN, enc_len=enc_len)
        assert {k: tuple(x.shape) for k, x in _leaves(got).items()} == {
            k: tuple(x.shape) for k, x in _leaves(want).items()}
        assert all(x.dtype == model.dtype for x in _leaves(got).values())
    jcache, jlogits = jax.jit(lambda p, b: jmodel.prefill(
        p, b, max_len=MAX_LEN))(ref_params(case), {
            "tokens": jnp.asarray(toks[:, :PROMPT]),
            "encoder_embeds": jnp.asarray(enc)})
    with torch.inference_mode():
        cache, logits = model.prefill(params, {
            "tokens": torch.from_numpy(toks[:, :PROMPT]),
            "encoder_embeds": torch.from_numpy(enc)}, max_len=MAX_LEN)

    def compare(cache, jcache, logits, jlogits, where):
        assert cache["len"] == int(jcache["len"]), where
        got, want = _leaves(cache), _leaves(jcache)
        assert set(got) == set(want) == {"k", "v", "ck", "cv"}, where
        for name in want:
            assert got[name].shape == want[name].shape, (where, name)
            assert got[name].dtype == model.dtype, (where, name)
            assert _gap(got[name], want[name]) <= LIMIT[dtype], (where, name)
        assert logits.dtype == model.dtype and logits.shape == jlogits.shape
        assert _gap(logits, jlogits, v) <= LIMIT[dtype], where

    compare(cache, jcache, logits, jlogits, "prefill")
    assert cache["ck"].shape == (cfg.num_layers, 2, cfg.encoder_seq,
                                 cfg.n_kv_heads, cfg.resolved_head_dim)
    decode = jax.jit(jmodel.decode)
    for step in range(DECODE_STEPS):
        nt = toks[:, PROMPT + step:PROMPT + step + 1]
        jcache, jlogits = decode(ref_params(case), jcache, jnp.asarray(nt))
        with torch.inference_mode():
            cache, logits = model.decode(params, cache, torch.from_numpy(nt))
        compare(cache, jcache, logits, jlogits, f"decode step {step}")


def test_prefill_and_decode_equal_forward(ref_params):
    """The cached path against ``forward`` at the same positions (float32,
    1e-4): prefill's last logits and each teacher-forced decode step's."""
    _, cfg = _cfg_pair("reduced", "float32")
    params = lm_params_from_reference(ref_params("reduced"), cfg,
                                      device="cpu")
    model = build_model(cfg, device="cpu")
    toks, enc = (torch.from_numpy(a) for a in _batch(cfg, 3, 2, SEQ))
    with torch.inference_mode():
        want = model.forward(params, {"tokens": toks,
                                      "encoder_embeds": enc})[0]
        cache, last = model.prefill(params, {"tokens": toks[:, :PROMPT],
                                             "encoder_embeds": enc},
                                    max_len=SEQ)
        got = [last]
        for t in range(PROMPT, SEQ - 1):
            cache, logits = model.decode(params, cache, toks[:, t:t + 1])
            got.append(logits)
    assert _gap(torch.stack(got, 1), want[:, PROMPT - 1:SEQ - 1].numpy()) \
        <= 1e-4


@pytest.mark.parametrize("shape", [(1500, 1024), (8192, 1024), (16, 128)])
def test_sinusoidal_positions_match_reference(shape):
    from repro.models.layers import sinusoidal_positions as jpe
    got = layers.sinusoidal_positions(*shape)
    assert got.dtype == torch.float32 and got.shape == shape
    assert float(np.abs(got.numpy() - np.asarray(jpe(*shape))).max()) \
        <= 1e-6


@pytest.mark.parametrize("pos", [0, 8191, 8192, 9000])
def test_decode_position_row_clamps_as_the_reference(pos):
    """The reference's decode slices row ``pos`` of an 8192-row table with
    ``lax.dynamic_slice_in_dim``, which clamps past the last row; the port
    reads the same row, held here on the table alone."""
    import jax.numpy as jnp
    from jax import lax
    from repro.models.layers import sinusoidal_positions as jpe
    d = 1024
    want = np.asarray(lax.dynamic_slice_in_dim(
        jpe(lm_mod.DECODE_POSITIONS, d), jnp.asarray(pos, jnp.int32), 1,
        axis=0))
    got = lm_mod.decode_position_row(pos, d, torch.device("cpu"))
    assert got.shape == (1, d)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6
    assert torch.equal(got, layers.sinusoidal_positions(
        lm_mod.DECODE_POSITIONS, d)[min(pos, 8191)][None])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cross_attention_functions_match_reference(ref_params, case, dtype):
    """``init_cross_attention`` draws the self-attention tree; ``cross_kv``
    and ``apply_cross_attention`` on decoder layer 0's weights, a seeded
    encoder output and a seeded query stream."""
    import jax.numpy as jnp
    from repro.models import layers as jl
    jcfg, cfg = _cfg_pair(case, dtype)
    tree = {k: v[0] for k, v in ref_params(case)["layers"]["cross"].items()}
    p = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    lay = layers.init_cross_attention(cfg, generator=torch.Generator(),
                                      device=torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in lay.items()} == {
        k: v.shape for k, v in tree.items()}
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    tdt = getattr(torch, dtype)
    jk, jv = jl.cross_kv(tree, jnp.asarray(enc, dtype), jcfg)
    k, v = layers.cross_kv(p, torch.from_numpy(enc).to(tdt), cfg)
    assert k.dtype == tdt and k.shape == jk.shape
    assert _gap(k, jk) <= LIMIT[dtype] and _gap(v, jv) <= LIMIT[dtype]
    want = jl.apply_cross_attention(tree, jnp.asarray(x, dtype), jcfg, jk,
                                    jv)
    got = layers.apply_cross_attention(p, torch.from_numpy(x).to(tdt), cfg,
                                       k, v)
    assert got.dtype == tdt and got.shape == want.shape
    assert _gap(got, want) <= LIMIT[dtype]


def test_init_is_seeded_and_stacks_both_stacks():
    _, cfg = _cfg_pair("reduced", "float32")
    model = build_model(cfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(0))
    b = model.init(torch.Generator().manual_seed(0))
    flat = lambda t: [x for v in t.values() for x in (  # noqa: E731
        flat(v) if isinstance(v, dict) else [v])]
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert a["enc_layers"]["attn"]["wq"].shape == (2, 128, 4, 1, 32)
    assert a["layers"]["cross"]["wk"].shape == (2, 128, 4, 32)
    assert torch.equal(a["enc_norm"]["bias"], torch.zeros(128))
    assert abs(a["layers"]["cross"]["wq"].std().item()
               - 1 / np.sqrt(128)) < 0.01


def test_no_kernel_on_any_encdec_path(ref_params, monkeypatch):
    """Built with ``use_kernel``, the family calls the attention kernel's
    entry point nowhere: the reference runs every encdec attention
    plain."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    _, cfg = _cfg_pair("reduced", "float32")
    params = lm_params_from_reference(ref_params("reduced"), cfg,
                                      device="cpu")
    calls = []
    real = fa_ops.flash_attention
    monkeypatch.setattr(fa_ops, "flash_attention",
                        lambda *a, **k: calls.append(None) or real(*a, **k))
    model = build_model(cfg, use_kernel=True, device="cpu")
    toks, enc = (torch.from_numpy(a) for a in _batch(cfg, 4, 1, SEQ))
    batch = {"tokens": toks, "encoder_embeds": enc}
    with torch.inference_mode():
        model.forward(params, batch)
        model.loss(params, batch)
        cache, _ = model.prefill(params, {"tokens": toks[:, :-1],
                                          "encoder_embeds": enc},
                                 max_len=SEQ)
        model.decode(params, cache, toks[:, -1:])
    assert calls == []


def test_convert_rejects_a_tree_without_the_encoder_norm(ref_params):
    _, cfg = _cfg_pair("reduced", "float32")
    tree = dict(ref_params("reduced"))
    del tree["enc_norm"]
    with pytest.raises(ValueError, match="has keys"):
        lm_params_from_reference(tree, cfg, device="cpu")
    tree = dict(ref_params("reduced"), enc_layers=dict(
        ref_params("reduced")["enc_layers"], ln1={
            "scale": np.ones(7), "bias": np.zeros(7)}))
    with pytest.raises(ValueError, match="enc_layers/ln1/scale has shape"):
        lm_params_from_reference(tree, cfg, device="cpu")


def test_engine_stacks_the_cross_cache_of_a_wave_of_4(ref_params,
                                                      monkeypatch):
    """A wave of 4 requests decodes on one cache whose every leaf, the
    cross-attention's ck and cv included, is the four prefills' caches
    concatenated on the batch axis, slot i from request i."""
    _, cfg = _cfg_pair("reduced", "float32")
    params = lm_params_from_reference(ref_params("reduced"), cfg,
                                      device="cpu")
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=MAX_LEN,
                      device="cpu")
    prefills, first = [], []
    real_prefill, real_decode = eng.model.prefill, eng.model.decode

    def prefill(*args, **kwargs):
        cache, logits = real_prefill(*args, **kwargs)
        prefills.append({k: v.clone() for k, v in _leaves(cache).items()})
        return cache, logits

    def decode(params, cache, tokens):
        if not first:
            first.append({k: v.clone() for k, v in _leaves(cache).items()})
        return real_decode(params, cache, tokens)
    monkeypatch.setattr(eng.model, "prefill", prefill)
    monkeypatch.setattr(eng.model, "decode", decode)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 10))
    eng.run([Request(rid=i, prompt=p.astype(np.int32), max_new_tokens=3)
             for i, p in enumerate(prompts)])
    assert len(prefills) == 4 and len(first) == 1
    for name, stacked in first[0].items():
        assert stacked.shape[1] == 4, name
        for i, one in enumerate(prefills):
            assert torch.equal(stacked[:, i:i + 1], one[name]), (name, i)
    assert first[0]["ck"].shape == (cfg.num_layers, 4, cfg.encoder_seq,
                                    cfg.n_kv_heads, cfg.resolved_head_dim)


SERVE_CHILD = r"""
import dataclasses
import numpy as np
from repro.configs import get_config, reduced
from repro.serve import Request, ServeEngine

cfg = dataclasses.replace(reduced(get_config("whisper-medium")),
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
    """Prompts, and the reference engine's tokens, stats and warm report
    for reduced whisper-medium (one child)."""
    prompts = np.random.default_rng(3).integers(
        0, 512, (len(NEW_TOKENS), 10)).tolist()
    payload = {"slots": 4, "max_len": MAX_LEN, "warm": [10],
               "prompts": prompts, "new": NEW_TOKENS}
    return prompts, run_reference(SERVE_CHILD, payload, timeout=900)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_serve_engine_matches_reference(ref_params, ref_serve, use_kernel):
    """6 requests in waves of 4 and 2 behind the engine's zero encoder
    frames: tokens, stats and the warm report equal the reference
    engine's, with or without ``use_kernel``."""
    prompts, want = ref_serve
    _, cfg = _cfg_pair("reduced", "float32")
    params = lm_params_from_reference(ref_params("reduced"), cfg,
                                      device="cpu")
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
