"""The port's sharding rules, meshes and logical spec trees
(``repro_torch.sharding``, ``launch.mesh``, ``Model.param_specs`` /
``cache_specs``, ``opt_state_specs``, ``state_specs``) against the
reference's ``repro.sharding.specs`` on the CPU.

In this process (``repro.sharding.specs``, ``repro.models`` and
``repro.train.step`` import under the installed jax): the reference's
``tests/test_sharding.py`` cases on tuples; ``make_rules`` and
``scheme_for`` over every arch x ``force_scheme`` x mode x mesh x global
batch, and the degraded ``dp_size=8`` mesh that ``ft/elastic.py`` plans
for; ``resolve``, ``legalize`` and ``shard_shape`` on hypothesis draws
(``shard_shape`` against ``NamedSharding.shard_shape`` on an
``AbstractMesh``); the spec trees of all ten archs, key for key.  In one
reference child with 512 forced host devices, as ``repro.launch.dryrun``
runs: the resolved, legalized spec of every leaf and the persistent
bytes per device (``sharded_bytes``) of all 32 (arch, shape) cells on
both production meshes, which must be ``==``.
"""
import dataclasses
import json

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.sharding import specs as ref_specs
from repro.train import optimizer as ref_optimizer
from repro.train import step as ref_step

from repro_torch._tree import map_with_keys
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_production_mesh
from repro_torch.models import api, build_model
from repro_torch.sharding import (legalize, make_rules, map_specs, resolve,
                                  scheme_for, shard_shape, sharded_bytes,
                                  tree_pspecs, tree_shardings)
from repro_torch.train import TrainState, opt_state_specs, state_specs
from torch_reference import run_reference

CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES
         if shape_applicable(get_config(a), SHAPES[s])]
MESHES = {"16x16": False, "2x16x16": True}
PROPS = settings(max_examples=300, deadline=None, database=None)

REFERENCE = r"""
import jax
import jax.numpy as jnp
import numpy as np
from repro.checkpoint.checkpoint import _flatten
from repro.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro.launch.mesh import make_production_mesh
from repro.models import build_model
from repro.models.api import abstract_cache, abstract_params, abstract_state
from repro.sharding.specs import make_rules, tree_shardings
from repro.train.step import state_specs
assert jax.device_count() == 512, jax.device_count()

def bf16_params(p):                      # repro/launch/dryrun.py:67-70
    return jax.tree.map(
        lambda s: (jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
                   if jnp.issubdtype(s.dtype, jnp.floating) else s), p)

def sharded_bytes(abs_tree, sh_tree):    # repro/launch/dryrun.py:72-82
    leaves = zip(jax.tree.leaves(abs_tree), jax.tree.leaves(sh_tree))
    total = 0
    for a, sh in leaves:
        shard = sh.shard_shape(a.shape)
        total += int(np.prod(shard)) * a.dtype.itemsize
    return total

for arch in sorted(ARCHS):
    cfg = get_config(arch)
    model = build_model(cfg)
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape):
            continue
        for mesh_name, multi_pod in (("16x16", False), ("2x16x16", True)):
            mesh = make_production_mesh(multi_pod=multi_pod)
            rules = make_rules(
                cfg, multi_pod=multi_pod,
                mode="train" if shape.kind == "train" else "serve",
                global_batch=shape.global_batch)
            if shape.kind == "train":
                state = abstract_state(cfg)
                trees = {"state": (state, tree_shardings(
                    state_specs(cfg, model), mesh, rules, state))}
            else:
                params = bf16_params(abstract_params(cfg))
                cache = abstract_cache(cfg, shape)
                trees = {"params": (params, tree_shardings(
                             model.param_specs(), mesh, rules, params)),
                         "cache": (cache, tree_shardings(
                             model.cache_specs(), mesh, rules, cache))}
            OUT[f"{arch}__{name}__{mesh_name}"] = {
                "chips": int(mesh.devices.size),
                "bytes": sum(sharded_bytes(a, s) for a, s in trees.values()),
                "specs": {t: {k: list(sh.spec)
                              for k, sh in _flatten(s)[0].items()}
                          for t, (a, s) in trees.items()}}
"""


@pytest.fixture(scope="module")
def ref():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=512")
        return run_reference(REFERENCE)


def _bf16(tree):
    """The dry-run's ``bf16_params`` on the port's meta trees."""
    return map_with_keys(lambda _, t: t.to(torch.bfloat16)
                         if t.dtype.is_floating_point else t, tree)


def _port_cell(arch, shape_name, multi_pod):
    """``run_cell``'s layout on the port: the mesh and {tree name: (the
    abstract tree, its legalized specs)}."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = make_rules(cfg, multi_pod=multi_pod,
                       mode="train" if shape.kind == "train" else "serve",
                       global_batch=shape.global_batch)
    model = build_model(cfg, device="meta")
    if shape.kind == "train":
        pairs = {"state": (api.abstract_state(cfg), state_specs(cfg, model))}
    else:
        pairs = {"params": (_bf16(api.abstract_params(cfg)),
                            model.param_specs()),
                 "cache": (api.abstract_cache(cfg, shape),
                           model.cache_specs())}
    return mesh, {name: (tree, tree_shardings(spec, mesh, rules, tree))
                  for name, (tree, spec) in pairs.items()}


def _spec_items(tree, prefix=""):
    """{key: spec leaf} of a spec tree, keyed as jax paths print (dict keys
    sorted, a ``NamedTuple`` field as ``.field``, joined by ``/``)."""
    if type(tree) is tuple or tree is None:
        return {prefix: tree}
    if isinstance(tree, tuple):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    else:
        items = sorted(tree.items())
    out = {}
    for k, v in items:
        out.update(_spec_items(v, f"{prefix}/{k}" if prefix else k))
    return out


def _json(x):
    return json.loads(json.dumps(x))


# ------------------------------------------ tests/test_sharding.py on tuples


def test_scheme_selection():
    assert scheme_for(get_config("granite-34b"), 16) == "tp"      # R=48
    assert scheme_for(get_config("stablelm-3b"), 16) == "tp"      # G=32
    assert scheme_for(get_config("qwen3-moe-235b-a22b"), 16) == "tp"  # R=16
    assert scheme_for(get_config("qwen2-0.5b"), 16) == "sp"       # G=2,R=7
    assert scheme_for(get_config("minitron-8b"), 16) == "sp"      # G=8,R=4
    assert scheme_for(get_config("mamba2-780m"), 16) == "tp"      # ssm


def test_resolve_dedups_axes():
    rules = {"a": ("model",), "b": ("model",), "c": ("data", "model")}
    assert resolve(("a", "b"), rules) == ("model", None)
    assert resolve(("c", None), rules) == (("data", "model"), None)
    assert resolve(None, rules) == ()


def test_rules_decode_small_batch_replicates_dp():
    cfg = get_config("zamba2-2.7b")
    assert make_rules(cfg, mode="serve", global_batch=1)["dp"] == ()
    assert make_rules(cfg, mode="serve", global_batch=128)["dp"] == ("data",)


def test_legalize_drops_nondivisible_axes():
    mesh = Mesh(("data", "model"), (16, 16))
    # 896 % 256 != 0 but % 16 == 0
    assert legalize((("data", "model"), None), (896, 7), mesh) == \
        ("data", None)
    assert legalize(("model",), (50280,), mesh) == (None,)  # 50280 % 16


# ------------------------------------------------------------- the meshes


def test_meshes_are_the_references_shapes():
    mesh = make_production_mesh()
    assert (mesh.axis_names, mesh.shape, mesh.chips) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    assert list(mesh.shape) == ["data", "model"]
    pods = make_production_mesh(multi_pod=True)
    assert (pods.shape, pods.chips) == (
        {"pod": 2, "data": 16, "model": 16}, 512)
    assert list(pods.shape) == ["pod", "data", "model"]
    assert make_local_mesh() == Mesh(("data", "model"), (1, 1))
    assert make_local_mesh(4, 2).shape == {"data": 4, "model": 2}
    # the reference's axis names and sizes
    ref_abstract = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert dict(ref_abstract.shape) == pods.shape


@pytest.mark.parametrize("bad", [(("data",), (1, 2)),
                                 (("data", "data"), (1, 2)),
                                 (("data", "model"), (0, 2))])
def test_mesh_refuses_a_malformed_layout(bad):
    with pytest.raises(ValueError):
        Mesh(*bad)


# ------------------------------------------------------ rules: every choice


def _grid_cfgs(arch):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    for force in (None, "tp", "sp", "dp"):
        yield (dataclasses.replace(ref_cfg, force_scheme=force),
               dataclasses.replace(cfg, force_scheme=force))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_make_rules_equal_the_references(arch):
    """Every ``force_scheme`` x mode x mesh x global batch, the tp sizes
    the rules are asked with, and the degraded (8, 16) mesh
    ``ft/elastic.py`` plans for (``dp_size=8``)."""
    n = 0
    for ref_cfg, cfg in _grid_cfgs(arch):
        for tp_size in (1, 2, 4, 8, 16, 32):
            assert scheme_for(cfg, tp_size) == \
                ref_specs.scheme_for(ref_cfg, tp_size)
        for mode in ("train", "serve"):
            for multi_pod in (False, True):
                for batch in (None, 1, 32, 128, 256):
                    for dp_size in (None, 8):
                        kw = dict(multi_pod=multi_pod, mode=mode,
                                  global_batch=batch, dp_size=dp_size)
                        assert make_rules(cfg, **kw) == \
                            ref_specs.make_rules(ref_cfg, **kw), kw
                        n += 1
    assert n == 4 * 2 * 2 * 5 * 2


# ------------------------------------------------ resolution: hypothesis

AXES = ("pod", "data", "model")
NAMES = ("dp", "fsdp", "tp", "tp_kv", "tp_rep", "ep", "sp", "kv_seq",
         "vocab", "unknown")
axis_tuples = st.lists(st.sampled_from(AXES), max_size=3,
                       unique=True).map(tuple)
rule_sets = st.dictionaries(st.sampled_from(NAMES[:-1]), axis_tuples)
logical_specs = st.none() | st.lists(st.none() | st.sampled_from(NAMES),
                                     max_size=6).map(tuple)
entries = st.none() | st.sampled_from(AXES) | st.lists(
    st.sampled_from(AXES), min_size=2, max_size=3, unique=True).map(tuple)
mesh_sizes = st.tuples(*(st.sampled_from((1, 2, 3, 4, 8, 16))
                         for _ in AXES))
dims = st.lists(st.sampled_from((1, 2, 3, 6, 7, 8, 16, 24, 48, 64, 96, 256,
                                 896, 4864, 50280)), max_size=5).map(tuple)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


@PROPS
@given(logical_specs, rule_sets)
def test_resolve_equals_the_references(logical, rules):
    got = resolve(logical, rules)
    assert type(got) is tuple
    assert got == tuple(ref_specs.resolve(logical, rules))


@PROPS
@given(st.lists(entries, max_size=5).map(tuple), dims, mesh_sizes)
def test_legalize_equals_the_references(pspec, shape, sizes):
    mesh = Mesh(AXES, sizes)
    got = legalize(pspec, shape, mesh)
    assert got == tuple(ref_specs.legalize(P(*pspec), shape,
                                           _FakeMesh(dict(zip(AXES, sizes)))))
    assert len(got) == len(pspec)


@PROPS
@given(st.lists(entries, max_size=5).map(tuple), dims, mesh_sizes)
def test_shard_shape_equals_named_sharding(pspec, shape, sizes):
    """A legalized spec on the port against ``NamedSharding.shard_shape``
    on the same abstract mesh; a spec that names an axis twice or does
    not divide raises ``ValueError`` in both."""
    mesh = Mesh(AXES, sizes)
    ref_mesh = AbstractMesh(sizes, AXES)
    # the legalized spec, then the spec as drawn: the port raises where
    # jax does (a ValueError, or for a repeated axis jax's
    # DuplicateSpecError, which is no ValueError)
    for spec in (legalize(pspec, shape, mesh), pspec):
        if len(spec) > len(shape):
            continue
        try:
            want = NamedSharding(ref_mesh, P(*spec)).shard_shape(shape)
        except Exception:
            with pytest.raises(ValueError):
                shard_shape(spec, shape, mesh)
        else:
            assert shard_shape(spec, shape, mesh) == tuple(want)


def test_shard_shape_refuses_what_jax_refuses():
    mesh = Mesh(("data", "model"), (2, 4))
    assert shard_shape(("data", None), (4, 6), mesh) == (2, 6)
    assert shard_shape((), (), mesh) == ()
    assert shard_shape(("data", None), (4,), mesh) == (2,)
    for spec, shape in [(("model", "model"), (8, 8)),
                        (("data", None), (3, 6)),
                        ((None, "data"), (4,))]:
        with pytest.raises(ValueError):
            shard_shape(spec, shape, mesh)


# ------------------------------------------------------- the spec trees


def _plain(tree):
    """A spec tree as JSON-like data: a ``NamedTuple`` as its fields, a
    spec leaf a list, ``None`` kept."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"." + f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        assert all(e is None or isinstance(e, str) for e in tree), tree
        return list(tree)
    assert tree is None, tree
    return tree


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_trees_equal_the_references(arch):
    """``param_specs``, ``cache_specs``, both optimizers'
    ``opt_state_specs`` and ``state_specs``, key for key; the spec leaves
    pair with the abstract trees leaf for leaf."""
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    ref_model = ref_build_model(ref_get_config(arch))
    pspec = model.param_specs()
    assert _plain(pspec) == _plain(ref_model.param_specs())
    assert _plain(model.cache_specs()) == _plain(ref_model.cache_specs())
    for name in ("adamw", "adafactor"):
        assert _plain(opt_state_specs(name, pspec)) == _plain(
            ref_optimizer.opt_state_specs(name, ref_model.param_specs()))
    sspec = state_specs(cfg, model)
    assert isinstance(sspec, TrainState) and sspec.step is None
    assert _plain(sspec) == _plain(ref_step.state_specs(
        ref_get_config(arch), ref_model))
    # every spec names one dim per leaf dim, and pairs with its leaf
    state = api.abstract_state(cfg)
    leaves = {}
    map_with_keys(leaves.__setitem__, state)
    specs = _spec_items(sspec)
    assert sorted(specs) == sorted(leaves)
    for key, spec in specs.items():
        assert spec is None or len(spec) == leaves[key].dim(), key
    for shape in SHAPES.values():
        if shape_applicable(cfg, shape):
            cache = api.abstract_cache(cfg, shape)
            keys = {}
            map_with_keys(keys.__setitem__, cache)
            assert sorted(_spec_items(model.cache_specs())) == sorted(keys)


def test_spec_walkers_keep_tuples_as_leaves():
    """A plain tuple and ``None`` are spec leaves; a ``NamedTuple`` stays a
    container; dict keys come out sorted."""
    tree = TrainState(params={"b": ("fsdp", None), "a": (None,)},
                      opt={"count": None}, step=None)
    seen = []
    out = map_specs(lambda s: seen.append(s) or s, tree)
    assert seen == [(None,), ("fsdp", None), None, None]
    assert isinstance(out, TrainState) and out == tree
    rules = {"fsdp": ("data", "model")}
    assert tree_pspecs(tree, rules) == TrainState(
        params={"a": (None,), "b": (("data", "model"), None)},
        opt={"count": ()}, step=())
    mesh = make_production_mesh()
    abs_tree = TrainState(
        params={"a": torch.empty(3, device="meta"),
                "b": torch.empty(896, 7, device="meta")},
        opt={"count": torch.empty((), dtype=torch.int32, device="meta")},
        step=torch.empty((), dtype=torch.int32, device="meta"))
    sh = tree_shardings(tree, mesh, rules, abs_tree)
    assert sh.params == {"a": (None,), "b": ("data", None)}
    assert tree_shardings(tree, mesh, rules) == tree_pspecs(tree, rules)
    # 3 * 4 + 896 / 16 * 7 * 4 + 4 + 4
    assert sharded_bytes(abs_tree, sh, mesh) == 12 + 1568 + 8
    with pytest.raises(ValueError):
        tree_shardings({"a": (None,)}, mesh, rules, {"b": abs_tree.step})


# ------------------------------------- the dry-run's layout: every cell


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_specs_and_bytes_equal_the_references(ref, arch, shape):
    """Both meshes: the resolved, legalized spec of every leaf and the
    persistent bytes per device, ``==`` the reference's."""
    for mesh_name, multi_pod in MESHES.items():
        want = ref[f"{arch}__{shape}__{mesh_name}"]
        mesh, laid = _port_cell(arch, shape, multi_pod)
        assert mesh.chips == want["chips"]
        got = {name: _json(_spec_items(sh)) for name, (_, sh) in laid.items()}
        assert got == want["specs"], (arch, shape, mesh_name)
        assert sum(sharded_bytes(tree, sh, mesh)
                   for tree, sh in laid.values()) == want["bytes"]


def test_the_issues_figures(ref):
    """The figures the dry-run's records will carry, read off the child
    (a few of the 64)."""
    want = {("qwen2-0.5b", "train_4k"): (275_615_240, 275_615_240),
            ("qwen2-0.5b", "prefill_32k"): (112_234_244, 87_068_420),
            ("qwen2-0.5b", "decode_32k"): (263_229_188, 162_565_892),
            ("mamba2-780m", "long_500k"): (156_436_996, 156_436_996),
            ("qwen3-moe-235b-a22b", "decode_32k"): (33_374_052_356,
                                                    31_796_994_052),
            ("zamba2-2.7b", "long_500k"): (3_385_351_748, 3_385_351_748)}
    assert len(ref) == 2 * len(CELLS) == 64
    for (arch, shape), pair in want.items():
        got = tuple(sum(sharded_bytes(t, s, mesh) for t, s in laid.values())
                    for mesh, laid in (_port_cell(arch, shape, mp)
                                       for mp in MESHES.values()))
        assert got == pair == tuple(
            ref[f"{arch}__{shape}__{m}"]["bytes"] for m in MESHES)
