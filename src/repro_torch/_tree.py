"""The one walker over the port's trees (nested dicts, lists, tuples and
``NamedTuple``s of tensors), in the order ``jax.tree_util`` flattens the
reference's pytrees.  The optimizers and the checkpoint format both use
it, so a state's leaves come out in the same order for both."""
from __future__ import annotations

from typing import Any, Callable


def map_with_keys(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(key, leaf)`` on every leaf of ``tree`` in the reference's
    flatten order, the same containers around the results.  A key is the
    path as jax prints it: dict keys in sorted order, list and tuple items
    by index, a ``NamedTuple`` field as ``.field``, joined by ``/``.
    ``None`` is an empty subtree, as in jax."""
    def key(part) -> str:
        return f"{prefix}/{part}" if prefix else str(part)
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_keys(fn, getattr(tree, f), key(f".{f}"))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: map_with_keys(fn, tree[k], key(k)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_keys(fn, v, key(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def leaves(tree) -> list:
    """The leaves of ``tree`` in the reference's flatten order."""
    out: list = []
    map_with_keys(lambda _, x: out.append(x), tree)
    return out


def unflatten(tree, values) -> Any:
    """``tree``'s containers around ``values``, taken in flatten order
    (jax's ``treedef.unflatten``)."""
    it = iter(values)
    return map_with_keys(lambda _, x: next(it), tree)

