"""The port's ``roofline`` (a copy of the reference's) against the
reference's on the CPU: ``==`` on every answer, since the code is the
same.

The programs are compiled by jax here (single-device: a matmul, scans of
12 and of 5 x 3, a 1M elementwise program, a convolution, a gather, a
dynamic slice and update, and ``value_and_grad`` of reduced qwen2-0.5b's
and mamba2-780m's ``Model.loss``), and in one child interpreter with 8
forced host devices (every collective kind, in both replica-group
notations, one inside a scan).  On each program's HLO text both
packages' ``analyze``, ``parse_hlo_module``, ``parse_hlo_collectives``,
``collective_bytes``, ``top_instructions`` (by bytes and by flops),
``_loop_multipliers`` and ``pattern_traffic`` (``score_matcher`` and
``chunk_matcher``) must agree; ``model_flops`` and ``roofline_terms`` on
every (arch, shape) cell, with and without the config and with another
``Hardware``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest

import repro.roofline as ref_roofline
from repro.configs import get_config as ref_get_config
from repro.configs import get_shape as ref_get_shape
from repro.configs import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.roofline import analysis as ref_an
from repro.roofline import hlo_parse as ref_hp

import repro_torch.roofline as port_roofline
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.roofline import analysis as port_an
from repro_torch.roofline import hlo_parse as port_hp
from torch_reference import run_reference

F32 = jnp.float32


def _sds(*shape, dtype=F32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _scan12(x, y):
    return jax.lax.scan(lambda c, _: (c @ y, ()), x, None, length=12)[0]


def _scan5x3(x, y):
    def outer(c, _):
        return jax.lax.scan(lambda c2, _: (c2 @ y, ()), c, None,
                            length=3)[0], ()
    return jax.lax.scan(outer, x, None, length=5)[0]


def _conv(x, w):
    return jax.lax.conv_general_dilated(x, w, (1, 1), "SAME")


def _loss_grad(arch, b=2, s=64):
    """value_and_grad of reduced ``arch``'s loss (the train step's
    program, without the update)."""
    model = ref_build_model(ref_reduced(ref_get_config(arch)))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    batch = {"tokens": _sds(b, s, dtype=jnp.int32)}
    return _compiled(jax.value_and_grad(lambda p, bt: model.loss(p, bt)[0]),
                     params, batch)


LOCAL = {
    "matmul_512": lambda: _compiled(lambda x, y: x @ y, _sds(512, 512),
                                    _sds(512, 512)),
    "scan_12": lambda: _compiled(_scan12, _sds(256, 256), _sds(256, 256)),
    "scan_5x3": lambda: _compiled(_scan5x3, _sds(128, 128), _sds(128, 128)),
    "elementwise_1m": lambda: _compiled(lambda x: x * 2 + 1, _sds(1 << 20)),
    "conv": lambda: _compiled(_conv, _sds(2, 8, 32, 32), _sds(16, 8, 3, 3)),
    "gather": lambda: _compiled(lambda x, i: x[i] * 2, _sds(1024, 64),
                                _sds(128, dtype=jnp.int32)),
    "dynamic_slice": lambda: _compiled(
        lambda x, s: jax.lax.dynamic_slice(x, (s, 0), (16, 64)) + 1,
        _sds(1024, 64), _sds(dtype=jnp.int32)),
    "dynamic_update_slice": lambda: _compiled(
        lambda x, u, s: jax.lax.dynamic_update_slice(x, u * 2, (s, 0)),
        _sds(1024, 64), _sds(16, 64), _sds(dtype=jnp.int32)),
    "qwen2_loss_grad": lambda: _loss_grad("qwen2-0.5b"),
    "mamba2_loss_grad": lambda: _loss_grad("mamba2-780m"),
}

# programs on 8 forced host devices: GSPMD (iota replica groups) and
# shard_map (explicit groups); the last reduces inside a scan of 6 on a
# 4 x 2 mesh (groups of 2)
COLLECTIVES_CHILD = r"""
import re
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.roofline.analysis import collective_bytes, parse_hlo_collectives
from repro.roofline.hlo_parse import analyze
assert jax.device_count() == 8, jax.device_count()
mesh = jax.make_mesh((8,), ("x",))
mesh2 = jax.make_mesh((4, 2), ("a", "b"))

def sds(*s):
    return jax.ShapeDtypeStruct(s, jnp.float32)

def smap(fn, m, i, o):
    return jax.jit(jax.shard_map(fn, mesh=m, in_specs=i, out_specs=o,
                                 check_vma=False))

def scan_psum(x):
    body = lambda c, _: (jax.lax.psum(jnp.tanh(c), "b"), ())
    return jax.lax.scan(body, x, None, length=6)[0]

ring = [(i, (i + 1) % 8) for i in range(8)]
progs = {
    "gspmd_all_reduce": (jax.jit(
        lambda a, b: a @ b,
        in_shardings=(NamedSharding(mesh, P(None, "x")),
                      NamedSharding(mesh, P("x", None))),
        out_shardings=NamedSharding(mesh, P(None, None))),
        (sds(256, 256), sds(256, 256))),
    "gspmd_all_gather": (jax.jit(
        lambda a: a * 2, in_shardings=NamedSharding(mesh, P("x", None)),
        out_shardings=NamedSharding(mesh, P(None, None))),
        (sds(256, 128),)),
    "all_gather": (smap(lambda x: jax.lax.all_gather(x, "x", tiled=True),
                        mesh, P("x"), P(None)), (sds(64, 32),)),
    "reduce_scatter": (smap(
        lambda x: jax.lax.psum_scatter(x, "x", tiled=True), mesh, P(None),
        P("x")), (sds(64, 32),)),
    "all_to_all": (smap(lambda x: jax.lax.all_to_all(x, "x", 0, 1,
                                                     tiled=True),
                        mesh, P("x", None), P(None, "x")), (sds(64, 64),)),
    "collective_permute": (smap(lambda x: jax.lax.ppermute(x, "x", ring),
                                mesh, P("x"), P("x")), (sds(64, 32),)),
    "scan_all_reduce_2d": (smap(scan_psum, mesh2, P("a", "b"), P("a", None)),
                           (sds(64, 32),)),
}
for name, (fn, args) in progs.items():
    text = fn.lower(*args).compile().as_text()
    OUT[name] = {
        "text": text,
        "kinds": sorted(set(re.findall(
            r" (all-gather|all-reduce|reduce-scatter|all-to-all|"
            r"collective-permute)(?:-start)?\(", text))),
        "analyze": analyze(text),
        "parse_hlo_collectives": parse_hlo_collectives(text),
        "collective_bytes": collective_bytes(text)}
"""

KINDS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute"}
COLLECTIVE_PROGRAMS = ("gspmd_all_reduce", "gspmd_all_gather", "all_gather",
                       "reduce_scatter", "all_to_all", "collective_permute",
                       "scan_all_reduce_2d")
PROGRAMS = tuple(LOCAL) + COLLECTIVE_PROGRAMS


@pytest.fixture(scope="module")
def child():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        return run_reference(COLLECTIVES_CHILD)


@pytest.fixture(scope="module")
def texts(child):
    out = {name: make() for name, make in LOCAL.items()}
    out.update({name: child[name]["text"] for name in COLLECTIVE_PROGRAMS})
    return out


def _module_tree(comps):
    """``parse_hlo_module``'s answer as plain data."""
    return {name: {"instrs": [[i.name, i.type_str, i.opcode, i.rest,
                               i.operands] for i in c.instrs],
                   "symbols": c.symbols}
            for name, c in comps.items()}


# matcher arguments: each reads non-zero traffic on some program (checked
# below); the attention scores of the reduced models at S = 64 are
# (..., 64, 64) tiles, mamba2's intra-chunk matrices (32, 32)
MATCHERS = {"score_64_64": ("score_matcher", (64, 64)),
            "score_64_32": ("score_matcher", (64, 32)),
            "chunk_32": ("chunk_matcher", (32,)),
            "chunk_64": ("chunk_matcher", (64,))}


def _traffic(matcher):
    name, args = MATCHERS[matcher]
    return lambda an, hp, t: hp.pattern_traffic(t, getattr(hp, name)(*args))


FUNCTIONS = {
    "analyze": lambda an, hp, t: hp.analyze(t),
    "parse_hlo_module": lambda an, hp, t: _module_tree(
        hp.parse_hlo_module(t)),
    "parse_hlo_collectives": lambda an, hp, t: an.parse_hlo_collectives(t),
    "collective_bytes": lambda an, hp, t: an.collective_bytes(t),
    "top_instructions_bytes": lambda an, hp, t: hp.top_instructions(
        t, n=50, key="bytes"),
    "top_instructions_flops": lambda an, hp, t: hp.top_instructions(
        t, n=50, key="flops"),
    "loop_multipliers": lambda an, hp, t: hp._loop_multipliers(
        hp.HloAnalyzer(t)),
    **{f"pattern_traffic_{m}": _traffic(m) for m in MATCHERS},
}


@pytest.mark.parametrize("function", sorted(FUNCTIONS))
@pytest.mark.parametrize("program", PROGRAMS)
def test_port_answers_equal_the_references(texts, program, function):
    text = texts[program]
    fn = FUNCTIONS[function]
    want = fn(ref_an, ref_hp, text)
    got = fn(port_an, port_hp, text)
    assert type(got) is type(want)
    assert got == want


@pytest.mark.parametrize("program", COLLECTIVE_PROGRAMS)
def test_collectives_equal_the_childs_answers(child, program):
    """The reference's answers made in the 8-device child, through JSON
    (floats round-trip exactly), against the port's here."""
    ref = child[program]
    text = ref["text"]
    got = json.loads(json.dumps({
        "analyze": port_hp.analyze(text),
        "parse_hlo_collectives": port_an.parse_hlo_collectives(text),
        "collective_bytes": port_an.collective_bytes(text)}))
    assert got == {k: ref[k] for k in got}
    assert ref["analyze"]["coll_wire_bytes"] > 0
    assert set(ref["analyze"]["collectives"]) == set(ref["kinds"])


def test_the_child_emits_every_collective_kind(child):
    kinds = set()
    for name in COLLECTIVE_PROGRAMS:
        kinds |= set(child[name]["kinds"])
    assert kinds == KINDS
    # a collective inside a scan counts once a trip
    assert child["scan_all_reduce_2d"]["analyze"]["collectives"][
        "all-reduce"]["count"] == 6.0
    # both replica-group notations: iota ([1,8]<=[8]) and explicit lists
    assert "replica_groups=[1,8]" in child["gspmd_all_reduce"]["text"]
    assert "replica_groups={{0,1}" in child["scan_all_reduce_2d"]["text"]


@pytest.mark.parametrize("matcher", sorted(MATCHERS))
def test_each_matcher_reads_traffic_on_some_program(texts, matcher):
    """A zero against a zero proves nothing: each matcher's arguments are
    such that the reference reads bytes and dot flops on some program."""
    fn = _traffic(matcher)
    reads = [fn(ref_an, ref_hp, texts[p]) for p in LOCAL]
    assert max(r["bytes"] for r in reads) > 0
    assert max(r["dot_flops"] for r in reads) > 0


@pytest.mark.parametrize("program,flops", [
    ("matmul_512", 2 * 512 ** 3), ("scan_12", 12 * 2 * 256 ** 3),
    ("scan_5x3", 15 * 2 * 128 ** 3)])
def test_trip_counts_multiply(texts, program, flops):
    """The programs are the ones they are meant to be: the reference's own
    test_roofline.py bounds on the same shapes."""
    got = port_hp.analyze(texts[program])["flops"]
    assert abs(got - flops) / flops < 0.05, got


def test_the_exports_and_hardware_are_the_references():
    assert port_roofline.__all__ == ref_roofline.__all__
    assert dataclasses.asdict(port_an.HW) == dataclasses.asdict(ref_an.HW)
    assert [f.name for f in dataclasses.fields(port_an.Hardware)] == \
        [f.name for f in dataclasses.fields(ref_an.Hardware)]
    for name in ("Hardware", "HW", "parse_hlo_collectives",
                 "collective_bytes", "model_flops", "roofline_terms"):
        assert hasattr(port_an, name), name
    for name in ("parse_hlo_module", "HloAnalyzer", "Cost", "analyze",
                 "score_matcher", "chunk_matcher", "pattern_traffic",
                 "_loop_multipliers", "top_instructions"):
        assert hasattr(port_hp, name), name


CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES
         if shape_applicable(get_config(a), SHAPES[s])]
# (per-device flops, bytes, collective bytes, chips): each term dominant
# once, and a zero step
INPUTS = [(1e12, 1e9, 1e6, 256), (1e9, 1e12, 1e6, 256),
          (1e9, 1e6, 1e12, 512), (0.0, 0.0, 0.0, 1)]
# every field off its default (arbitrary values, not a real part's)
OTHER_HW = {"peak_flops": 3e14, "hbm_bw": 1.5e12, "link_bw": 1e11,
            "ici_links": 6, "dcn_bw": 1e10, "hbm_per_chip": 3.2e10,
            "idle_watts": 55.0, "dynamic_watts": 245.0}


def test_the_cells_are_the_32_applicable_ones():
    assert len(CELLS) == 32


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_roofline_terms_equal_the_references(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    shp, ref_shp = SHAPES[shape], ref_get_shape(shape)
    assert port_an.model_flops(cfg, shp) == ref_an.model_flops(ref_cfg,
                                                                ref_shp)
    hws = [(None, None), (port_an.Hardware(**OTHER_HW),
                          ref_an.Hardware(**OTHER_HW))]
    for flops, nbytes, coll, chips in INPUTS:
        kw = dict(per_device_flops=flops, per_device_bytes=nbytes,
                  per_device_coll_bytes=coll, chips=chips)
        for port_hw, ref_hw in hws:
            extra = ({}, {}) if port_hw is None else \
                ({"hw": port_hw}, {"hw": ref_hw})
            assert port_an.roofline_terms(**kw, **extra[0]) == \
                ref_an.roofline_terms(**kw, **extra[1])
            got = port_an.roofline_terms(**kw, cfg=cfg, shape=shp,
                                         **extra[0])
            want = ref_an.roofline_terms(**kw, cfg=ref_cfg, shape=ref_shp,
                                         **extra[1])
            assert got == want
            assert "mfu_at_bound" in got
