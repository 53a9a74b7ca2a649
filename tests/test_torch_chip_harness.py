"""chip_smoke.py's own checking machinery, on the CPU at small sizes: the
MoE routing record/replay (``RoutingLog``), the residual-stream
record/replay (``StreamLog``), the float32 flash element bound
(``f32_excess``), the teacher-forced comparison (``scored_phase``), and
the served-token comparison (``plain_serve``'s per-step logits, its
schedule check, and ``compare_served``'s near-tie gate), and the zamba2
loss phase (``hybrid_run``'s instruments, ``hybrid_loss_phase``'s gates
and launch counts) and serve phase on the reduced hybrid model, and the
dry-run-record phase (``record_phase``, host Python but for one fastsim
call) passing and failing on a planted mismatch.  These run on the card
around the kernels; here each kernel's plain version runs in its
place."""
import dataclasses
import importlib.util
import math
import os

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def _moe(impl):
    cfg = dataclasses.replace(reduced(get_config("phi3.5-moe-42b-a6.6b")),
                              dtype="float32", moe_impl=impl)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _batch(cfg, seed=0, s=32):
    gen = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (2, s),
                                    generator=gen)}


def _forward_and_loss(model, params, batch):
    with torch.inference_mode():
        logits, (aux, _, _) = model.forward(params, batch)
        loss, _ = model.loss(params, batch)
    return logits, aux, loss


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_routing_replay_reproduces_the_run_bit_for_bit(cs, impl):
    cfg, model, params = _moe(impl)
    batch = _batch(cfg)
    log = cs.RoutingLog()
    with log.record():
        want = _forward_and_loss(model, params, batch)
    assert len(log.calls) == 2 * cfg.num_layers
    assert all(c.shape == (2, 32, cfg.moe.top_k) for c in log.calls)
    with log.replay():
        got = _forward_and_loss(model, params, batch)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    again = cs.RoutingLog()
    with again.record():
        _forward_and_loss(model, params, batch)
    assert again.flips(log) == (0, 2 * cfg.num_layers * 2 * 32)


def test_routing_replay_takes_the_recorded_decisions(cs):
    """Replayed decisions are used, not the run's own: replaying another
    batch's decisions moves the output, with the same call shapes."""
    cfg, model, params = _moe("einsum")
    other = cs.RoutingLog()
    with other.record():
        _forward_and_loss(model, params, _batch(cfg, seed=1))
    batch = _batch(cfg)
    want = _forward_and_loss(model, params, batch)
    with other.replay():
        got = _forward_and_loss(model, params, batch)
    assert not torch.equal(got[0], want[0])
    log = cs.RoutingLog()
    with log.record():
        _forward_and_loss(model, params, batch)
    n, total = log.flips(other)
    assert 0 < n <= total


def test_routing_replay_refuses_a_mismatch(cs):
    """More calls than recorded, fewer (a recorded decision left unused),
    another shape, and flips between runs of different calls all
    raise."""
    cfg, model, params = _moe("einsum")
    batch = _batch(cfg)
    one, two = cs.RoutingLog(), cs.RoutingLog()
    with one.record(), torch.inference_mode():
        model.forward(params, batch)                  # one call a layer
    with two.record():
        _forward_and_loss(model, params, batch)       # two calls a layer
    with pytest.raises(cs.SmokeFailure, match="no decision"):
        with one.replay():
            _forward_and_loss(model, params, batch)
    with pytest.raises(cs.SmokeFailure, match="calls of"):
        with two.replay(), torch.inference_mode():
            model.forward(params, batch)
    with pytest.raises(cs.SmokeFailure, match="routes"):
        with one.replay(), torch.inference_mode():
            model.forward(params, _batch(cfg, s=16))
    with pytest.raises(cs.SmokeFailure, match="different routing calls"):
        one.flips(two)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llava-next-mistral-7b"])
def test_stream_replay_feeds_each_layer_the_recorded_input(cs, arch):
    """Replaying a run's own stream reproduces it bit for bit; replayed
    under another batch, every layer takes the recorded input in place of
    its own; a run of other calls raises."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))

    def batch(seed):
        b = _batch(cfg, seed)
        if cfg.family == "vlm":
            b["image_embeds"] = torch.randn(
                2, cfg.n_image_tokens, cfg.d_model,
                generator=torch.Generator().manual_seed(seed)) * 0.1
        return b
    routes, stream = cs.RoutingLog(), cs.StreamLog()
    with routes.record(), stream.record():
        want = _forward_and_loss(model, params, batch(0))
    assert len(stream.inputs) == len(stream.attention) == 2 * cfg.num_layers
    own = cs.StreamLog()
    with routes.replay(), own.replay(stream):
        got = _forward_and_loss(model, params, batch(0))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b)
               for a, b in zip(own.compared(), stream.compared()))
    other = cs.StreamLog()
    with routes.replay(), other.replay(stream):
        _forward_and_loss(model, params, batch(1))
    assert all(torch.equal(a, b) for a, b in zip(other.inputs,
                                                 stream.inputs))
    with pytest.raises(cs.SmokeFailure, match="stream replay"):
        with cs.StreamLog().replay(stream), torch.inference_mode():
            model.forward(params, batch(0))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 64, 2, 3, 32), (2, 100, 1, 4, 128)])
def test_f32_bound_holds_for_the_plain_version_and_breaks_on_a_fault(
        cs, shape, causal):
    """The float32 element bound on the plain attention (float32 sums in
    another order than the kernel's, within the same rounding budget), and
    a lost 16-key tile for the last 16 query rows above it."""
    from repro_torch.kernels.flash_attention import attention_ref
    b, s, g, r, hd = shape
    gen = torch.Generator().manual_seed(sum(shape))
    q = torch.randn(b, s, g, r, hd, generator=gen)
    k = torch.randn(b, s, g, hd, generator=gen)
    v = torch.randn(b, s, g, hd, generator=gen)
    mask = cs.visible_mask(s, s, causal, q.device)
    assert cs.f32_excess(attention_ref(q, k, v, causal=causal), q, k, v,
                         mask) <= 1.0
    qpos = torch.arange(s)[:, None]
    kpos = torch.arange(s)[None, :]
    lost = mask & ~((qpos >= s - 16) & (kpos >= s - 32) & (kpos < s - 16))
    qs = q.double() / math.sqrt(hd)
    p = torch.softmax(torch.einsum("bqgrk,bsgk->bgrqs", qs, k.double())
                      .masked_fill(~lost, -math.inf), dim=-1)
    faulty = torch.einsum("bgrqs,bsgk->bqgrk", p, v.double()).float()
    assert cs.f32_excess(faulty, q, k, v, mask) > 1.0


def _qwen2():
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                              dtype="float32")
    return cfg, build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))


def test_plain_serve_logits_are_each_served_tokens_step(cs):
    """Waves of 4 and 2: each request's logits at token t are those of a
    prefill of its prompt and first t tokens (float32, 1e-4 of scale),
    and the token is their argmax."""
    cfg, params = _qwen2()
    spec = (6, 10, 5, 4)
    ref, logits = cs.plain_serve(torch.device("cpu"), cfg, params, spec)
    model = build_model(cfg, device="cpu")
    reqs = cs.serve_requests(cfg, *spec[:3])
    assert sorted(ref) == list(range(6))
    for r in reqs:
        assert len(logits[r.rid]) == len(ref[r.rid]) == 5
        for t in range(5):
            prefix = [int(x) for x in r.prompt] + ref[r.rid][:t]
            with torch.inference_mode():
                want = model.prefill(params, {"tokens": torch.tensor(
                    [prefix])}, max_len=len(prefix))[1][0, :cfg.vocab_size]
            got = logits[r.rid][t]
            assert float((got - want).abs().max()
                         / want.abs().max()) <= 1e-4
            assert int(got.argmax()) == ref[r.rid][t]


def test_compare_served_gates_a_token_that_is_no_near_tie(cs):
    cfg, params = _qwen2()
    spec = (2, 10, 4, 2)
    dev = torch.device("cpu")
    plain = cs.plain_serve(dev, cfg, params, spec)
    ref, logits = plain
    cs.compare_served(dev, cfg, params, {k: list(v) for k, v in ref.items()},
                      spec, plain)
    worst = {k: list(v) for k, v in ref.items()}
    worst[1][2] = int(logits[1][2].argmin())          # far from a tie
    with pytest.raises(cs.SmokeFailure, match="not a near-tie"):
        cs.compare_served(dev, cfg, params, worst, spec, plain)
    short = {k: v[:-1] for k, v in ref.items()}
    with pytest.raises(cs.SmokeFailure, match="token counts differ"):
        cs.compare_served(dev, cfg, params, short, spec, plain)


def test_plain_serve_refuses_calls_out_of_schedule(cs, monkeypatch):
    """An engine that serves each wave in reverse makes as many calls of
    each kind and batch size as the schedule, but feeds them other
    tokens: reading its logits as the schedule's would misattribute
    them, so it raises."""
    import repro_torch.serve as serve

    class Reversed(serve.ServeEngine):
        def _run_wave(self, wave):
            return super()._run_wave(wave[::-1])
    cfg, params = _qwen2()
    monkeypatch.setattr(serve, "ServeEngine", Reversed)
    with pytest.raises(cs.SmokeFailure, match="do not follow its waves"):
        cs.plain_serve(torch.device("cpu"), cfg, params, (4, 10, 3, 2))


def _scored(arch, impl="einsum"):
    cfg = dataclasses.replace(reduced(get_config(arch)), moe_impl=impl)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    image = None
    if cfg.family == "vlm":
        image = torch.randn(2, cfg.n_image_tokens, cfg.d_model,
                            generator=gen) * 0.1
    return cfg, params, tokens, image


@pytest.mark.parametrize("arch,impl", [("phi3.5-moe-42b-a6.6b", "einsum"),
                                       ("phi3.5-moe-42b-a6.6b", "scatter"),
                                       ("llava-next-mistral-7b", "einsum")])
def test_scored_phase_passes_the_plain_version(cs, monkeypatch, arch, impl):
    """The teacher-forced phase with the kernel's plain version in its
    place passes every gate, and each planted fault reads above every
    limit (the phase itself checks both), in float32 and bfloat16."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    cfg, params, tokens, image = _scored(arch, impl)
    cs.scored_phase(torch.device("cpu"), cfg, params, tokens, 4, image)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llava-next-mistral-7b"])
def test_scored_phase_fails_a_kernel_one_percent_off(cs, monkeypatch, arch):
    """An attention 1% off its function fails the phase."""
    from repro_torch.kernels.flash_attention import attention_ref, ops
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, causal=True:
                        attention_ref(q, k, v, causal=causal) * 1.01)
    cfg, params, tokens, image = _scored(arch)
    with pytest.raises(cs.SmokeFailure, match="gap|bound"):
        cs.scored_phase(torch.device("cpu"), cfg, params, tokens, 4, image)


@pytest.fixture
def hybrid(cs, monkeypatch):
    """Reduced zamba2 at head_dim 80 (4 ssm layers in 2 groups) with the
    phase cut to its size, and each kernel's plain version standing in for
    it through the entry point the model calls, counting a launch as the
    kernel's wrapper does."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ssd_scan
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(cs, "HYBRID_B", 2)
    monkeypatch.setattr(cs, "HYBRID_S", 64)
    monkeypatch.setattr(cs, "HYBRID_LOSS_LAUNCHES",
                        {"ssd_scan": 4, "flash_attention_fwd": 2})
    real_fa, real_ssd = fa_ops.flash_attention, ssd_ops.ssd

    def fa(q, k, v, causal=True):
        flash_attention_fwd.launches += 1
        return real_fa(q, k, v, causal=causal)

    def ssd(*args, **kwargs):
        ssd_scan.launches += 1
        return real_ssd(*args, **kwargs)
    monkeypatch.setattr(fa_ops, "flash_attention", fa)
    monkeypatch.setattr(ssd_ops, "ssd", ssd)
    cfg = reduced(get_config("zamba2-2.7b"), head_dim=80)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    return cfg, params


def test_hybrid_loss_phase_passes_the_plain_versions(cs, hybrid):
    """Every gate of the zamba2 loss phase passes with the kernels' plain
    versions, and each planted fault reads above its kernel's limits and
    within the other's (the phase checks both), in float32 and bfloat16;
    the launches are one scan an ssm layer and one flash call a group."""
    cfg, params = hybrid
    launches = cs.hybrid_loss_phase(torch.device("cpu"), cfg, params)
    assert launches == {"ssd_scan": 4, "flash_attention_fwd": 2}


@pytest.mark.parametrize("kernel", ["ssd", "flash_attention"])
def test_hybrid_loss_phase_fails_a_kernel_one_percent_off(cs, hybrid,
                                                          monkeypatch,
                                                          kernel):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    module = ssd_ops if kernel == "ssd" else fa_ops
    inner = getattr(module, kernel)
    monkeypatch.setattr(module, kernel,
                        lambda *args, **kwargs: inner(*args, **kwargs) * 1.01)
    cfg, params = hybrid
    with pytest.raises(cs.SmokeFailure, match="kernel reads|differ"):
        cs.hybrid_loss_phase(torch.device("cpu"), cfg, params)


def test_hybrid_loss_phase_counts_launches(cs, hybrid, monkeypatch):
    """A scan that does not reach the kernel (its launch uncounted) fails
    the phase."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    monkeypatch.setattr(ssd_ops, "ssd", ssd_scan_ref)
    cfg, params = hybrid
    with pytest.raises(cs.SmokeFailure, match="launches"):
        cs.hybrid_loss_phase(torch.device("cpu"), cfg, params)


def test_hybrid_run_is_the_unhooked_run_bit_for_bit(cs, hybrid):
    """The phase's instruments (every scan and flash call also run through
    its plain version, every flash call held to its float64 bound) leave
    the float32 run unchanged: the logits and loss equal those of the
    model run bare, and each instrument reads one value a call."""
    cfg, params = hybrid
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg, use_kernel=True, device="cpu")
    batch = _batch(cfg, s=64)
    with torch.inference_mode():
        want = model.forward(params, batch)[0]
    loss = model.loss(params, batch)[0]
    logits, got_loss, scans, attn, excess = cs.hybrid_run(model, params,
                                                          batch)
    assert torch.equal(logits, want) and torch.equal(got_loss, loss)
    assert (len(scans), len(attn), len(excess)) == (4, 2, 2)
    assert max(excess) <= 1.0


def test_hybrid_serve_phase_launches_no_kernel(cs, hybrid):
    """zamba2's engine with ``use_kernel`` (the default) serves with no
    launch, as the reference's (its prefill runs plain attention and the
    chunked scan), and its tokens equal the plain engine's in float32 and
    bfloat16."""
    cfg, params = hybrid
    assert cs.serve_phase(torch.device("cpu"), cfg, params,
                          (4, 12, 5, 4)) == 0


def test_record_phase_passes_on_the_cpu(cs, monkeypatch, capsys):
    """The dry-run-record phase on the CPU: every answer equals the
    reference's constants.  Its DES cells are cut here to the prefill
    record (~1M events); the straggler call still runs its two 256-rank
    qwen2-0.5b DES runs."""
    cell = ("qwen2-0.5b", "prefill_32k", "16x16")
    assert cell in cs.RECORD_DES
    monkeypatch.setattr(cs, "RECORD_DES", [cell])
    cs.record_phase(torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.count("equal=True") == len(cs.DRYRUN_RECORDS) + len(
        cs.RECORD_WHATIF) + 3
    assert "equal=False" not in out and "ok=False" not in out


def test_record_phase_fails_a_reference_one_ulp_off(cs, monkeypatch):
    """A mismatch fails the phase through ``check``: here the first
    record's step time, one ulp off, before any DES runs."""
    want = {k: dict(v) for k, v in cs.REFERENCE_RECORD_PREDICT.items()}
    name = next(iter(want))
    want[name]["step_s"] = math.nextafter(want[name]["step_s"], math.inf)
    monkeypatch.setattr(cs, "REFERENCE_RECORD_PREDICT", want)
    with pytest.raises(cs.SmokeFailure, match=f"predict_cell {name}"):
        cs.record_phase(torch.device("cpu"))
