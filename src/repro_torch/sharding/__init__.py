"""Logical-axis sharding rules on plain tuples: port of ``repro.sharding``
(``specs``; ``pipeline`` is not ported yet)."""
from .specs import (Rules, legalize, make_rules, map_specs, resolve,
                    scheme_for, shard_shape, sharded_bytes, tree_pspecs,
                    tree_shardings)

__all__ = ["Rules", "make_rules", "scheme_for", "resolve", "legalize",
           "map_specs", "tree_shardings", "tree_pspecs", "shard_shape",
           "sharded_bytes"]
