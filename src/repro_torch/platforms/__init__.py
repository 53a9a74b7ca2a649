"""Platform layer: declarative machine specs driving the simulation
backends.

    from repro_torch.platforms import get_platform
    plat = get_platform("frontera")
    node, topo, rpn, overhead = plat.des()     # hardware stack
    prm = plat.fastsim()                       # vectorized fastsim params
    cfg = plat.hpl_config()                    # the machine's Rmax run

The DES-to-fastsim bridge (``fit_fastsim_to_des``) waits for the DES
slice.
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
           "build_node", "build_topology"]
