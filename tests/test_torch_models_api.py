"""The port's ``models.api`` (abstract trees as meta tensors, and
``make_batch``) against the reference's ``repro.models.api``.

One reference child builds the reference's ``input_specs``,
``input_logical_specs``, ``abstract_params``, ``abstract_state`` and
``abstract_cache`` for all ten archs at full width and every applicable
shape (32 cells) and returns each leaf's key, shape and dtype; the
port's must be the same, every leaf a meta tensor.  At reduced configs a
real ``Model.init``, ``make_train_state`` and ``init_cache`` must match
the abstract trees leaf for leaf.  ``make_batch`` cannot draw the
reference's values (jax's threefry stream), so it is held to its own
contract: ``input_specs``' shapes and dtypes, tokens in range, the
scale, one seed one batch.  Last, ``chip_smoke.py``'s ``api_checks`` on
the CPU at reduced sizes, with a count of the bytes ops make standing in
for the card's peak allocation.
"""
import importlib.util
import json
import os
import time

import pytest
import torch

from repro_torch._tree import map_with_keys
from repro_torch.configs import (ARCHS, SHAPES, ShapeConfig, get_config,
                                 reduced, shape_applicable)
from repro_torch.models import api, build_model
from repro_torch.train import TrainState, make_train_state
from torch_host_rise import host_rise as _host_rise
from torch_reference import run_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES
         if shape_applicable(get_config(a), SHAPES[s])]

REFERENCE = r"""
from repro.checkpoint.checkpoint import _flatten
from repro.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro.models import api

def desc(tree):
    return [[k, list(v.shape), str(v.dtype)]
            for k, v in _flatten(tree)[0].items()]

for arch in sorted(ARCHS):
    cfg = get_config(arch)
    OUT[arch] = {"params": desc(api.abstract_params(cfg)),
                 "state": desc(api.abstract_state(cfg)), "cells": {}}
    for name, shape in SHAPES.items():
        if shape_applicable(cfg, shape):
            OUT[arch]["cells"][name] = {
                "inputs": desc(api.input_specs(cfg, shape)),
                "logical": api.input_logical_specs(cfg, shape),
                "cache": desc(api.abstract_cache(cfg, shape))}
"""


@pytest.fixture(scope="module")
def ref():
    return run_reference(REFERENCE)


def _keyed(tree):
    out = {}
    map_with_keys(out.__setitem__, tree)
    return out


def _desc(tree):
    """[key, shape, dtype] of every leaf, as the reference child writes
    them (a Python int reads as a 0-d int32)."""
    return [[k, [] if isinstance(v, int) else list(v.shape),
             "int32" if isinstance(v, int)
             else str(v.dtype).removeprefix("torch.")]
            for k, v in _keyed(tree).items()]


def _all_meta(tree):
    return all(isinstance(v, torch.Tensor) and v.is_meta
               for v in _keyed(tree).values())


def test_the_cells_are_the_32_applicable_ones():
    assert len(CELLS) == 32


@pytest.mark.parametrize("tree", ["params", "state"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_and_state_equal_the_references(ref, arch, tree):
    cfg = get_config(arch)
    got = (api.abstract_params(cfg) if tree == "params"
           else api.abstract_state(cfg))
    assert _desc(got) == ref[arch][tree]      # keys in flatten order too
    assert _all_meta(got)
    if tree == "state":
        assert isinstance(got, TrainState)
        assert (tuple(got.step.shape), got.step.dtype) == ((), torch.int32)
        assert set(got.opt) == ({"m", "v", "count"}
                                if cfg.optimizer == "adamw"
                                else {"f", "count"})


@pytest.mark.parametrize("part", ["inputs", "logical", "cache"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_trees_equal_the_references(ref, arch, shape, part):
    cfg, shp = get_config(arch), SHAPES[shape]
    want = ref[arch]["cells"][shape][part]
    if part == "logical":
        got = api.input_logical_specs(cfg, shp)
        assert json.loads(json.dumps(got)) == want
        assert list(got) == list(api.input_specs(cfg, shp))
        return
    got = (api.input_specs(cfg, shp) if part == "inputs"
           else api.abstract_cache(cfg, shp))
    assert _desc(got) == want
    assert _all_meta(got)
    if part == "cache":
        assert got["len"].is_meta and got["len"].dtype == torch.int32
        assert tuple(got["len"].shape) == ()


def test_init_cache_keeps_its_python_int_len():
    cache = build_model(reduced(get_config("qwen2-0.5b")),
                        device="cpu").init_cache(2, 16)
    assert type(cache["len"]) is int and cache["len"] == 0
    assert api.abstract_cache(get_config("qwen2-0.5b"),
                              SHAPES["decode_32k"])["len"].is_meta


def test_abstract_params_of_the_largest_config_take_no_time():
    """qwen3-moe-235b-a22b: 940 GB of float32 parameters, none drawn."""
    cfg = get_config("qwen3-moe-235b-a22b")
    t0 = time.perf_counter()
    params = api.abstract_params(cfg)
    took = time.perf_counter() - t0
    assert took < 1.0, took
    nbytes = sum(v.numel() * v.element_size()
                 for v in _keyed(params).values())
    assert nbytes > 9e11


SMALL = {"train": ShapeConfig("small_train", "train", 64, 2),
         "prefill": ShapeConfig("small_prefill", "prefill", 64, 2),
         "decode": ShapeConfig("small_decode", "decode", 32, 3)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_real_trees_match_the_abstract_ones(arch):
    """At reduced configs the real ``Model.init``, ``make_train_state`` and
    ``init_cache`` have the abstract trees' keys, shapes and dtypes."""
    cfg = reduced(get_config(arch))
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg, device="cpu").init(gen)
    assert _desc(params) == _desc(api.abstract_params(cfg))
    state = make_train_state(cfg, gen, device="cpu")
    assert _desc(state) == _desc(api.abstract_state(cfg))
    for shape in SMALL.values():
        real = build_model(cfg, device="cpu").init_cache(
            shape.global_batch, shape.seq_len, enc_len=cfg.encoder_seq or 0)
        assert _desc(real) == _desc(api.abstract_cache(cfg, shape))


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_make_batch_matches_input_specs(arch, kind):
    cfg, shape = reduced(get_config(arch)), SMALL[kind]
    batch = api.make_batch(cfg, shape, device="cpu")
    specs = api.input_specs(cfg, shape)
    assert list(batch) == list(specs)
    for key, t in batch.items():
        assert (t.shape, t.dtype, t.device) == (specs[key].shape,
                                                specs[key].dtype, CPU)
        if t.dtype.is_floating_point:
            assert abs(float(t.std()) / 0.02 - 1.0) < 0.1
        else:
            assert 0 <= int(t.min()) and int(t.max()) < cfg.vocab_size


def test_make_batch_scale_and_range_at_size():
    """Over a million draws: the std is ``scale`` within 1%, the mean 0,
    and the tokens cover the vocabulary's ends."""
    cfg = reduced(get_config("llava-next-mistral-7b"), n_image_tokens=2048)
    shape = ShapeConfig("img", "prefill", 2048 + 4096, 4)
    batch = api.make_batch(cfg, shape, scale=0.5, device="cpu")
    img, tok = batch["image_embeds"], batch["tokens"]
    assert img.numel() > 1e6
    assert abs(float(img.std()) / 0.5 - 1.0) < 0.01
    assert abs(float(img.mean())) < 0.01
    assert (int(tok.min()), int(tok.max())) == (0, cfg.vocab_size - 1)


def test_one_seed_gives_one_batch():
    cfg, shape = reduced(get_config("whisper-medium")), SMALL["prefill"]
    a = api.make_batch(cfg, shape, device="cpu")
    b = api.make_batch(cfg, shape, torch.Generator().manual_seed(0),
                       device="cpu")
    c = api.make_batch(cfg, shape, torch.Generator().manual_seed(1),
                       device="cpu")
    for key in a:
        assert torch.equal(a[key], b[key])
        assert not torch.equal(a[key], c[key])
    # the draws run in input_specs' order from one generator
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           dtype=torch.int32)
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen)
    assert torch.equal(a["tokens"], tokens)
    assert torch.equal(a["encoder_embeds"], frames * 0.02)


def test_api_keeps_the_references_names():
    import repro.models.api as ref_api
    public = {n for n in vars(ref_api) if not n.startswith("_")
              and callable(getattr(ref_api, n))
              and getattr(ref_api, n).__module__ == ref_api.__name__}
    assert public == {"input_specs", "input_logical_specs",
                      "abstract_params", "abstract_state", "abstract_cache",
                      "make_batch"}
    for name in public:
        assert getattr(api, name).__module__ == api.__name__


# ------------------------------------------ chip_smoke.py's api phase


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def test_chip_api_checks_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s A1-A3 on reduced configs at small shapes, the
    CPU standing in for the card: every gate passes, and the first two
    planted faults break exactly their gates (``api_checks`` checks
    both).  The third draws the card's batch on a CUDA generator, which
    the CPU has not: it runs on the card only."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.maxmin_fair import masked_min_rows
    from repro_torch.kernels.ssd_scan import ssd_scan
    cs = _load_chip_smoke()
    monkeypatch.setattr(cs, "device_rise", _host_rise)
    counted = (masked_min_rows, flash_attention_fwd, ssd_scan)
    before = [k.launches for k in counted]
    cells = [(reduced(get_config(a)), s) for a in sorted(ARCHS)
             for s in SMALL.values()]
    real = (reduced(get_config(cs.API_ARCH)), SMALL["prefill"])
    batch_cells = [(c, s) for c, s in cells if s is SMALL["prefill"]] + \
        [(c, s) for c, s in cells
         if c == real[0] and s is not SMALL["prefill"]]
    faults = ("params_built_on_card", "leaf_cast_bf16")
    out = cs.api_checks(CPU, cells, real, batch_cells, faults=faults)
    assert out["rise"] == 0
    assert [k.launches for k in counted] == before
    text = capsys.readouterr().out
    assert f"api A1 {len(cells)} cells: device rise 0 bytes" in text
    assert "every leaf equal" in text
    assert "planted fault None: broke []" in text
    for fault in faults:
        assert f"planted fault {fault}: broke " \
               f"{sorted(cs.API_FAULTS[fault])}" in text


def test_the_cpu_stand_in_sees_a_real_draw():
    """The stand-in for the card's peak reads the bytes a real draw makes
    and nothing for meta tensors."""
    with _host_rise(CPU) as rise:
        api.abstract_state(get_config("qwen2-0.5b"))
    assert rise["bytes"] == 0
    with _host_rise(CPU) as rise:
        torch.randn(1000)
    assert rise["bytes"] == 4000
