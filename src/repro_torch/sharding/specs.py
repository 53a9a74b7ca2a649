"""Logical-axis sharding rules and resolution onto the physical mesh: port
of ``repro.sharding.specs`` on plain tuples.

Logical axes used by the model spec trees:
  dp      — batch (data parallel), maps to ("pod","data") or ("data",)
  fsdp    — ZeRO-style parameter shard dim
  tp      — tensor-parallel dim (d_ff, ssm d_inner, vocab)
  tp_kv   — attention KV-group dim (G)
  tp_rep  — attention q-replication dim (R = H / G)
  ep      — MoE expert dim
  sp      — activation sequence dim (sequence parallelism / context parallel)
  kv_seq  — decode-time KV-cache sequence dim

Scheme selection per arch, as in the reference:
  'tp'  — Megatron-style TP when G or R divides the model-axis size.
  'sp'  — FSDP(+model axis) + sequence parallelism when neither divides
          (qwen2 G=2,R=7; minitron/phi/llava G=8,R=4): weights are sharded
          over both mesh axes for storage, activations over seq.
  'dp'  — only when ``cfg.force_scheme`` asks for it.

A resolved spec is a tuple with one entry per array dim, each ``None``, an
axis name or a tuple of axis names: the entries of the reference's
``PartitionSpec``, so ``tuple(P(...))`` equals the port's answer.  Where
the reference builds a ``NamedSharding`` over a jax mesh, the port keeps
the legalized spec tuple and a plain ``launch.mesh.Mesh``; ``shard_shape``
is ``NamedSharding.shard_shape`` and ``sharded_bytes`` the dry-run's sum
of per-device persistent bytes.

A spec tree is nested dicts (keys in sorted order, as jax flattens them),
lists and ``NamedTuple``s whose leaves are plain tuples or ``None``, as the
reference's ``_spec_leaf`` reads them; ``repro_torch._tree`` would take a
plain tuple for a container, so the spec walkers here are their own.
The reference's ``use_rules``, ``active_rules`` and ``constrain`` are not
ported: ``constrain`` is the identity without a mesh, and the port runs
every model on one device, so nothing reads a rules context.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

Rules = Dict[str, Tuple[str, ...]]
Spec = Tuple[Any, ...]


def _spec_leaf(x) -> bool:
    return type(x) is tuple or x is None


def map_specs(fn: Callable[[Any], Any], tree):
    """``fn`` on every spec leaf of ``tree`` (``jax.tree.map`` with the
    reference's ``_spec_leaf``), the same containers around the results."""
    if _spec_leaf(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [map_specs(fn, v) for v in tree]
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def _pairs(spec_tree, tree, path: str = "") -> List[Tuple[Any, Any]]:
    """(spec leaf, the subtree of ``tree`` at its place) in flatten order:
    jax's ``treedef.flatten_up_to(tree)`` for the spec tree's treedef,
    which requires the same containers down to the spec leaves."""
    if _spec_leaf(spec_tree):
        return [(spec_tree, tree)]
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        if type(tree) is not type(spec_tree):
            raise ValueError(f"{path or '.'}: a {type(spec_tree).__name__} "
                             f"spec for a {type(tree).__name__}")
        return [p for f in spec_tree._fields
                for p in _pairs(getattr(spec_tree, f), getattr(tree, f),
                                f"{path}.{f}")]
    if isinstance(spec_tree, dict):
        if not isinstance(tree, dict) or sorted(tree) != sorted(spec_tree):
            got = sorted(tree) if isinstance(tree, dict) \
                else type(tree).__name__
            raise ValueError(f"{path or '.'}: spec keys {sorted(spec_tree)}"
                             f", tree {got}")
        return [p for k in sorted(spec_tree)
                for p in _pairs(spec_tree[k], tree[k], f"{path}/{k}")]
    if isinstance(spec_tree, list):
        if not isinstance(tree, list) or len(tree) != len(spec_tree):
            raise ValueError(f"{path or '.'}: a list of {len(spec_tree)} "
                             "specs for another tree")
        return [p for i, (s, t) in enumerate(zip(spec_tree, tree))
                for p in _pairs(s, t, f"{path}/{i}")]
    raise TypeError(f"not a spec tree node: {type(spec_tree).__name__}")


def scheme_for(cfg, tp_size: int) -> str:
    if getattr(cfg, "force_scheme", None):
        return cfg.force_scheme
    if cfg.family == "ssm":
        return "tp"
    g, r = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    if g % tp_size == 0 or r % tp_size == 0:
        return "tp"
    return "sp"


def make_rules(cfg, *, multi_pod: bool = False, mode: str = "train",
               tp_size: int = 16, dp_size: Optional[int] = None,
               global_batch: Optional[int] = None) -> Rules:
    dp_axes: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    if dp_size is None:
        dp_size = (2 * 16) if multi_pod else 16
    if global_batch is not None and global_batch % dp_size != 0:
        dp_axes = ()  # tiny-batch decode (e.g. long_500k B=1): replicate batch
    sch = scheme_for(cfg, tp_size)
    g = cfg.n_kv_heads
    r = cfg.n_heads // max(cfg.n_kv_heads, 1)

    rules: Rules = {
        "dp": dp_axes,
        "ep": ("model",),
        "kv_seq": ("model",),
        "vocab": ("model",),
    }
    if sch == "dp":
        # pure data parallelism over every mesh axis
        rules["dp"] = dp_axes + ("model",)
        if global_batch is not None and global_batch % (dp_size * tp_size):
            rules["dp"] = dp_axes
        rules["tp"] = ()
        rules["tp_kv"] = ()
        rules["tp_rep"] = ()
        rules["sp"] = ()
        rules["fsdp"] = ("data",) if mode == "train" else ("model",)
    elif sch == "tp":
        rules["tp"] = ("model",)
        rules["tp_kv"] = ("model",) if g % tp_size == 0 else ()
        rules["tp_rep"] = (("model",) if (g % tp_size != 0
                                          and r % tp_size == 0) else ())
        rules["sp"] = ()
        rules["fsdp"] = ("data",) if mode == "train" else ()
    else:  # 'sp' scheme
        rules["tp"] = ()
        rules["tp_kv"] = ()
        rules["tp_rep"] = ()
        rules["sp"] = ("model",)
        rules["fsdp"] = (("data", "model") if mode == "train"
                         else ("model",))
    # MoE experts always shard over model; expert-internal fsdp dim follows
    # the global fsdp rule
    return rules


def resolve(logical: Optional[Tuple], rules: Rules) -> Spec:
    """logical: tuple of logical names / None per dim -> resolved spec,
    ``()`` for ``None``; a mesh axis serves one dim of a spec at most."""
    if logical is None:
        return ()
    out: list = []
    used: set = set()
    for name in logical:
        if name is None:
            out.append(None)
            continue
        axes = rules.get(name, ())
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        out.append(_entry(axes))
    return tuple(out)


def _entry(axes: Tuple[str, ...]):
    """A spec entry as ``PartitionSpec`` holds it: None, a name, or a
    tuple of two or more names."""
    if len(axes) == 0:
        return None
    if len(axes) == 1:
        return axes[0]
    return tuple(axes)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def legalize(pspec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes from any dim they do not divide evenly (jit rejects
    uneven shardings for its arguments)."""
    out = []
    for i, entry in enumerate(pspec):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        axes = _axes(entry)
        while axes:
            if shape[i] % math.prod(mesh.shape[a] for a in axes) == 0:
                break
            axes = axes[:-1]
        out.append(_entry(axes))
    return tuple(out)


def tree_shardings(spec_tree, mesh, rules: Rules, abs_tree=None):
    """Map a tree of logical specs to resolved spec tuples (the
    reference's ``NamedSharding``s over ``mesh``).  If ``abs_tree`` (the
    matching tree of tensors, meta ones included) is given, every spec is
    legalized against its leaf's shape."""
    if abs_tree is None:
        return tree_pspecs(spec_tree, rules)
    out = []
    for spec, leaf in _pairs(spec_tree, abs_tree):
        shape = tuple(getattr(leaf, "shape", ()))
        out.append(legalize(resolve(spec, rules), shape, mesh))
    it = iter(out)
    return map_specs(lambda _: next(it), spec_tree)


def tree_pspecs(spec_tree, rules: Rules):
    return map_specs(lambda spec: resolve(spec, rules), spec_tree)


def shard_shape(spec: Spec, shape, mesh) -> Tuple[int, ...]:
    """One device's block of an array of ``shape`` laid out by ``spec``
    on ``mesh`` (``NamedSharding.shard_shape``).  Raises ``ValueError``,
    as jax does, for a spec that names a mesh axis twice, that shards a
    dim the array lacks, or whose axes do not divide their dim."""
    names = [a for entry in spec for a in _axes(entry)]
    if len(set(names)) != len(names):
        raise ValueError(f"spec {spec} names a mesh axis more than once")
    if any(entry is not None for entry in spec[len(shape):]):
        raise ValueError(f"spec {spec} shards a dim of shape {shape} "
                         "that does not exist")
    out = []
    for i, dim in enumerate(shape):
        parts = math.prod(mesh.shape[a] for a in
                          _axes(spec[i] if i < len(spec) else None))
        if dim % parts:
            raise ValueError(f"spec {spec} splits dim {i} of shape {shape} "
                             f"into {parts} parts")
        out.append(dim // parts)
    return tuple(out)


def sharded_bytes(abs_tree, shardings, mesh) -> int:
    """Exact persistent bytes per device of ``abs_tree`` laid out by
    ``shardings`` (``tree_shardings``' answer for it) on ``mesh``: each
    leaf's ``shard_shape`` elements times its element size, summed (the
    reference's dry-run ``sharded_bytes``)."""
    return sum(math.prod(shard_shape(spec, tuple(leaf.shape), mesh))
               * leaf.element_size()
               for spec, leaf in _pairs(shardings, abs_tree))
