from .node import NodeModel, frontera_node, pupmaya_node
from .network import Flow, Link, Network
from . import topology

__all__ = ["NodeModel", "TPU_V5E", "frontera_node", "pupmaya_node",
           "Link", "Network", "Flow", "topology"]


def __getattr__(name):
    # lazy: TPU_V5E is built from the platform registry on first access
    if name == "TPU_V5E":
        from . import node
        return node.TPU_V5E
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
