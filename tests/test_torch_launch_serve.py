"""The port's serving launcher (repro_torch.launch.serve) and the decode
step's clamp past a full cache, against the JAX reference, on the CPU.

One child interpreter runs the reference for the whole module: its
launcher (``repro.launch.serve.main``) for each of the ten archs at
``--smoke --requests 2 --batch-slots 2``, in the config's bf16 and in
float32, with ``ServeEngine`` wrapped to keep the engine's tokens, its
``stats``, its parameter tree and the logits of every prefill and decode
call; llava at ``--prompt-len 2 --max-new 2``, which raises; and, for a
dense, moe, hybrid and encdec config, the engine with a cache shorter than
prompt + new tokens, so every decode call site of the reference
(``src/repro/models/lm.py:445``, ``:485``, ``:503``) writes past its end.
The port serves the same requests on the reference's tree
(``lm_params_from_reference``).  Its printed request and token counts and
its ``stats`` must equal the reference's, and its tokens too: in float32
exactly, in bf16 equal or a near-tie, where the reference's two candidate
logits in its own step lie within 5e-2 of that step's largest magnitude
(the bf16 gap limit of tests/test_torch_lm.py).
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine
from torch_reference import run_reference

LIMIT = {"float32": 1e-4, "bfloat16": 5e-2}
SMOKE = ["--smoke", "--requests", "2", "--batch-slots", "2"]
# the reference launcher's defaults under SMOKE: 2 requests, 32 prompt
# tokens, 16 new tokens, a cache of 49 positions
REQUESTS, PROMPT, NEW, SLOTS = 2, 32, 16, 2
# the clamp across families: 3 requests (waves of 2 and 1) of 8 prompt
# tokens and 12 new, a cache of 12 positions (llava's 8 image tokens
# would not fit, and the vlm path is the launcher's own llava case)
CLAMP_ARCHS = ("qwen2-0.5b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b",
               "whisper-medium")
CLAMP = {"requests": 3, "prompt": 8, "new": 12, "slots": 2, "max_len": 12}
LINE = re.compile(r"\[serve\] (\d+) requests, (\d+) tokens in [\d.]+s "
                  r"\([\d.]+ tok/s\) — stats (\{.*\})$")

CHILD = r"""
import contextlib, dataclasses, io, os, sys
import numpy as np
import repro.configs as C
import repro.serve.engine as E
from repro.launch import serve as launcher

DIR = PAYLOAD["dir"]
ENGINES = []
_init, _run = E.ServeEngine.__init__, E.ServeEngine.run


def recording_init(self, *a, **k):
    # keep each engine, and the logits of its every prefill and decode call
    _init(self, *a, **k)
    ENGINES.append(self)
    self.rows = []
    vocab = self.cfg.vocab_size
    prefill, decode = self._prefill, self._decode

    def keep(fn):
        def call(*args):
            cache, logits = fn(*args)
            self.rows.append(np.asarray(logits[:, :vocab], np.float32))
            return cache, logits
        return call
    self._prefill, self._decode = keep(prefill), keep(decode)


def recording_run(self, reqs):
    self.results = _run(self, reqs)
    return self.results


E.ServeEngine.__init__, E.ServeEngine.run = recording_init, recording_run


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def launch(argv, dtype):
    real = C.reduced
    C.reduced = lambda cfg, **kw: dataclasses.replace(real(cfg, **kw),
                                                      dtype=dtype)
    sys.argv = ["serve"] + argv
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            launcher.main()
    finally:
        C.reduced = real
    return buf.getvalue().strip().splitlines()[-1], ENGINES[-1]


def record(eng, name, **extra):
    np.savez(os.path.join(DIR, name + ".logits.npz"), *eng.rows)
    return dict(stats=eng.stats, tokens={str(k): v for k, v in
                                         eng.results.items()}, **extra)


OUT["launch"], OUT["clamp"] = {}, {}
for arch in C.ARCHS:
    for dtype in ("bfloat16", "float32"):
        line, eng = launch(["--arch", arch] + PAYLOAD["smoke"], dtype)
        OUT["launch"][f"{arch}.{dtype}"] = record(eng, f"{arch}.{dtype}",
                                                  line=line)
    np.savez(os.path.join(DIR, arch + ".npz"), **flat(eng.params))
    if arch in PAYLOAD["clamp_archs"]:
        c = PAYLOAD["clamp"]
        cfg = dataclasses.replace(C.reduced(C.get_config(arch)),
                                  dtype="float32")
        short = E.ServeEngine(cfg, eng.params, batch_slots=c["slots"],
                              max_len=c["max_len"])
        rng = np.random.default_rng(1)
        short.run([E.Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, c["prompt"]).astype(np.int32),
            max_new_tokens=c["new"]) for i in range(c["requests"])])
        OUT["clamp"][arch] = record(short, f"{arch}.clamp")
try:
    launch(["--arch", "llava-next-mistral-7b"] + PAYLOAD["smoke"]
           + ["--prompt-len", "2", "--max-new", "2"], "bfloat16")
    OUT["raise"] = None
except ValueError as exc:
    OUT["raise"] = str(exc)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's launcher lines, tokens, stats, trees and logits."""
    d = tmp_path_factory.mktemp("launch_ref")
    out = run_reference(CHILD, {"dir": str(d), "smoke": SMOKE,
                                "clamp_archs": list(CLAMP_ARCHS),
                                "clamp": CLAMP})
    out["dir"] = d
    return out


def _tree(ref, arch):
    """The reference's ``Model.init(PRNGKey(0))`` tree, nested again."""
    tree = {}
    with np.load(os.path.join(ref["dir"], arch + ".npz")) as z:
        for key in z.files:
            *path, leaf = key.split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def _ref_logits(ref, name, n, slots, new):
    """Request id -> the reference's logits, one row per token it chose:
    per wave of ``slots``, each request's prefill, then one decode step
    over the wave per further token."""
    with np.load(os.path.join(ref["dir"], name + ".logits.npz")) as z:
        rows = iter([z[f"arr_{i}"] for i in range(len(z.files))])
        out = {}
        for w in range(0, n, slots):
            wave = range(w, min(w + slots, n))
            for rid in wave:
                out[rid] = [next(rows)[0]]
            for _ in range(new - 1):
                row = next(rows)
                for i, rid in enumerate(wave):
                    out[rid].append(row[i])
        assert next(rows, None) is None
    return out


def _same_or_near_tie(got, want, logits, limit, label):
    """Each request's tokens equal the reference's, or first part where
    the reference's two candidates are a near-tie (reported)."""
    assert sorted(got) == sorted(want)
    for rid in sorted(want):
        t = next((t for t, (a, b) in enumerate(zip(got[rid], want[rid]))
                  if a != b), None)
        assert len(got[rid]) == len(want[rid]), (label, rid)
        if t is None:
            continue
        lg = logits[int(rid)][t]
        a, b = want[rid][t], got[rid][t]
        tie = float(abs(lg[a] - lg[b]) / np.abs(lg).max())
        print(f"{label}: request {rid} first differs at token {t} "
              f"(reference {a}, port {b}); the reference's logits differ "
              f"by {tie:.3e} of scale (limit {limit})")
        assert tie <= limit, (label, rid, t, tie)


def _parse(line):
    m = LINE.match(line)
    assert m, line
    return int(m.group(1)), int(m.group(2)), m.group(3)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_launcher_matches_reference(ref, capsys, arch, dtype):
    want = ref["launch"][f"{arch}.{dtype}"]
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    params = lm_params_from_reference(_tree(ref, arch), cfg, device="cpu")
    tokens, stats, dt = launcher.serve(cfg, params, requests=REQUESTS,
                                       batch_slots=SLOTS, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert _parse(line) == _parse(want["line"]) == (
        REQUESTS, REQUESTS * NEW, str(want["stats"]))
    assert stats == want["stats"] == {"prefills": REQUESTS,
                                      "decode_steps": NEW - 1,
                                      "tokens_out": REQUESTS * NEW}
    assert dt > 0
    got = {str(k): v for k, v in tokens.items()}
    if dtype == "float32":
        assert got == want["tokens"]
    else:
        logits = _ref_logits(ref, f"{arch}.{dtype}", REQUESTS, SLOTS, NEW)
        with capsys.disabled():
            _same_or_near_tie(got, want["tokens"], logits, LIMIT[dtype],
                              f"launcher {arch} {dtype}")


def test_llava_decodes_past_its_cache_as_the_reference_does(ref,
                                                            monkeypatch):
    """llava's 8 image tokens + 32 prompt tokens fill 40 of the launcher's
    49 cache positions, so decode steps 10-15 write past the end in both
    packages (the port raised there before the clamp).  float32: the
    logits of every step, those six included, within 1e-4 of the
    reference's scale (tokens alone could hide a wrong cache row)."""
    arch = "llava-next-mistral-7b"
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    assert cfg.n_image_tokens + PROMPT + NEW - 1 > PROMPT + NEW + 1
    params = lm_params_from_reference(_tree(ref, arch), cfg, device="cpu")
    rows = []
    real = ServeEngine.__init__

    def recording_init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        for name in ("prefill", "decode"):
            fn = getattr(self.model, name)

            def call(*a, _fn=fn, **k):
                cache, logits = _fn(*a, **k)
                rows.append(logits[:, :cfg.vocab_size].float().numpy())
                return cache, logits
            setattr(self.model, name, call)
    monkeypatch.setattr(ServeEngine, "__init__", recording_init)
    _, stats, _ = launcher.serve(cfg, params, requests=REQUESTS,
                                 batch_slots=SLOTS, device="cpu")
    assert stats == {"prefills": 2, "decode_steps": 15, "tokens_out": 32}
    with np.load(os.path.join(ref["dir"], arch + ".float32.logits.npz")) as z:
        want = [z[f"arr_{i}"] for i in range(len(z.files))]
    assert len(rows) == len(want) == REQUESTS + NEW - 1
    gaps = [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(rows, want)]
    assert max(gaps) <= LIMIT["float32"], gaps
    # the steps past the cache's end are the last six
    assert max(gaps[-6:]) <= LIMIT["float32"]


def test_a_prefill_longer_than_the_cache_raises_in_both(ref):
    """llava at ``--prompt-len 2 --max-new 2``: 8 image + 2 prompt
    positions against a cache of 5.  The reference raises ValueError; so
    does the port's prefill."""
    assert ref["raise"] is not None
    with pytest.raises(ValueError, match="max_len 5"):
        launcher.main(["--arch", "llava-next-mistral-7b"] + SMOKE
                      + ["--prompt-len", "2", "--max-new", "2",
                         "--device", "cpu"])


@pytest.mark.parametrize("arch", CLAMP_ARCHS)
def test_decode_past_a_short_cache_matches_reference(ref, arch):
    """Every decode call site writes past a cache shorter than prompt +
    new tokens: dense, moe (the dense stack), the hybrid's shared block
    and the encdec decoder's self-attention.  float32: tokens and stats
    equal."""
    want = ref["clamp"][arch]
    c = CLAMP
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    params = lm_params_from_reference(_tree(ref, arch), cfg, device="cpu")
    eng = ServeEngine(cfg, params, batch_slots=c["slots"],
                      max_len=c["max_len"], device="cpu")
    rng = np.random.default_rng(1)
    out = eng.run([Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, c["prompt"]).astype(np.int32),
        max_new_tokens=c["new"]) for i in range(c["requests"])])
    assert c["prompt"] + c["new"] - 1 > c["max_len"]
    assert eng.stats == want["stats"] == {
        "prefills": 3, "decode_steps": 2 * (c["new"] - 1), "tokens_out": 36}
    assert {str(k): v for k, v in out.items()} == want["tokens"]


def test_main_on_the_cpu_prints_the_reference_line(ref, capsys):
    """``main`` with ``--device cpu`` draws the port's own seed-0 weights
    (not the reference's, so only the counts and stats are compared)."""
    tokens, stats, _ = launcher.main(["--arch", "qwen2-0.5b"] + SMOKE
                                     + ["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    want = ref["launch"]["qwen2-0.5b.bfloat16"]
    assert _parse(line) == _parse(want["line"])
    assert stats == want["stats"] and sorted(tokens) == [0, 1]
    assert all(0 <= t < 512 for v in tokens.values() for t in v)


def test_seed_params_are_drawn_on_the_cpu_generator():
    """The launcher's weights are ``Model.init`` on a CPU generator seeded
    0, whatever the device, so the card serves the host's weights."""
    cfg = reduced(get_config("qwen2-0.5b"))

    def leaves(tree):
        return [x for v in tree.values()
                for x in (leaves(v) if isinstance(v, dict) else [v])]
    want = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    got = launcher.seed_params(cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
    assert len(leaves(got)) == len(leaves(want)) > 10


def test_main_without_a_card_raises_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "qwen2-0.5b"] + SMOKE)
