"""Platform layer: declarative machine specs driving the simulation
backends.

    from repro_torch.platforms import get_platform
    plat = get_platform("frontera")
    node, topo, rpn, overhead = plat.des()     # discrete-event stack
    prm = plat.fastsim()                       # vectorized fastsim params
    cfg = plat.hpl_config()                    # the machine's Rmax run

Bridge utilities (``fit_fastsim_to_des``) are exposed lazily: the bridge
imports ``core.apps.hpl`` and ``core.calibrate``, and ``core`` imports
this package.
"""
from .spec import (FabricSpec, MPIStackSpec, NodeSpec, Platform,
                   ScaleSpec)
from .registry import (add_invalidation_hook, bulk_register,
                       get_platform, list_platforms, register, unregister)
from .build import DESStack, build_des, build_fastsim, build_ici, \
    build_node, build_topology

__all__ = ["FabricSpec", "MPIStackSpec", "NodeSpec", "Platform",
           "ScaleSpec", "get_platform", "list_platforms", "register",
           "bulk_register", "unregister", "add_invalidation_hook",
           "DESStack", "build_des", "build_fastsim", "build_ici",
           "build_node", "build_topology", "fit_fastsim_to_des",
           "des_probe_runs", "BridgeFit"]

_BRIDGE_NAMES = ("fit_fastsim_to_des", "des_probe_runs", "BridgeFit",
                 "DEFAULT_PROBES", "DEFAULT_FIT_FIELDS")


def __getattr__(name):
    # bridge imports apps.hpl + calibrate; resolve lazily to keep this
    # package importable from inside core's own import chain
    if name in _BRIDGE_NAMES:
        from . import bridge
        return getattr(bridge, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
