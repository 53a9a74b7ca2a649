"""Backend adapters: one Platform spec -> either simulation stack.

``build_des`` materializes the discrete-event stack (NodeModel +
Topology + SimMPI knobs); ``build_fastsim`` derives the vectorized
simulator's FastSimParams from the same spec, so the two fidelities are
guaranteed to describe the same machine.  fastsim (and therefore torch)
is imported lazily.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hardware.node import NodeModel, node_from_spec
from repro_torch.core.hardware.topology import (Dragonfly, FatTreeTwoLevel,
                                                MultiPod, Topology, Torus)

from .spec import FabricSpec, NodeSpec, Platform


@dataclasses.dataclass(frozen=True)
class DESStack:
    """Everything HPLSim needs: the hardware pair plus MPI-stack knobs.
    ``trace`` asks the consuming sim to attach a TraceRecorder."""
    node: NodeModel
    topology: Topology
    ranks_per_node: int = 1
    mpi_overhead: float = 5e-7
    trace: bool = False

    def __iter__(self):
        return iter((self.node, self.topology, self.ranks_per_node,
                     self.mpi_overhead))


def build_node(spec: NodeSpec) -> NodeModel:
    return node_from_spec(spec)


def build_topology(fab: FabricSpec, n_nodes: int) -> Topology:
    if fab.kind == "fat-tree":
        if fab.nodes_per_edge <= 0 or fab.n_core <= 0:
            raise ValueError("fat-tree fabric needs nodes_per_edge and "
                             "n_core")
        return FatTreeTwoLevel(n_nodes, fab.nodes_per_edge, fab.n_core,
                               link_bw=fab.link_bw,
                               hop_latency=fab.hop_latency,
                               uplink_bw=fab.uplink_bw,
                               base_latency=fab.base_latency)
    if fab.kind == "dragonfly":
        cap = fab.n_groups * fab.routers_per_group * fab.nodes_per_router
        if cap < n_nodes:
            raise ValueError(f"dragonfly {fab.n_groups}x"
                             f"{fab.routers_per_group}x"
                             f"{fab.nodes_per_router} holds {cap} nodes "
                             f"< {n_nodes}")
        return Dragonfly(fab.n_groups, fab.routers_per_group,
                         fab.nodes_per_router, link_bw=fab.link_bw,
                         global_bw=fab.global_bw,
                         hop_latency=fab.hop_latency,
                         nonminimal=fab.nonminimal,
                         base_latency=fab.base_latency)
    if fab.kind == "torus":
        if math.prod(fab.dims) < n_nodes:
            raise ValueError(f"torus {fab.dims} holds {math.prod(fab.dims)} "
                             f"nodes < {n_nodes}")
        return Torus(fab.dims, link_bw=fab.link_bw,
                     hop_latency=fab.hop_latency,
                     base_latency=fab.base_latency)
    if fab.kind == "multipod":
        pod_size = math.prod(fab.dims)
        if fab.n_pods <= 0 or pod_size <= 0:
            raise ValueError("multipod fabric needs n_pods and pod dims")
        pods = [Torus(fab.dims, link_bw=fab.link_bw,
                      hop_latency=fab.hop_latency,
                      base_latency=fab.base_latency)
                for _ in range(fab.n_pods)]
        return MultiPod(pods, pod_size, dcn_bw_per_node=fab.dcn_bw_per_node,
                        dcn_latency=fab.dcn_latency)
    raise ValueError(f"unknown fabric kind {fab.kind!r}")


def build_des(platform: Platform, *, trace: bool = False) -> DESStack:
    return DESStack(node=build_node(platform.node),
                    topology=build_topology(platform.fabric,
                                            platform.scale.n_nodes),
                    ranks_per_node=platform.scale.ranks_per_node,
                    mpi_overhead=platform.mpi.overhead,
                    trace=trace)


def derived_net_latency(platform: Platform) -> float:
    """Effective small-message latency when the spec doesn't pin one:
    software overhead + fabric base latency + a typical 2-hop traversal
    (what a DES message actually pays end to end)."""
    fab = platform.fabric
    return platform.mpi.overhead + fab.base_latency + 2.0 * fab.hop_latency


def build_ici(platform: Platform, **overrides):
    """ICI parameters for the analytic TPU-network backend: its model
    (``core/simxla.py``) comes with the DES stack, ROADMAP §1 slice 4."""
    raise NotImplementedError(
        "build_ici: the ICI backend (core/simxla.py) is not ported yet; "
        "it comes with the DES stack (ROADMAP §1, slice 4)")


def build_fastsim(platform: Platform, *, calibrated: bool = True):
    from repro_torch.core.fastsim import FastSimParams

    net_latency = platform.mpi.net_latency
    if net_latency is None:
        net_latency = derived_net_latency(platform)
    prm = FastSimParams.from_node(
        build_node(platform.node), link_bw=platform.fabric.link_bw,
        ranks_per_node=platform.scale.ranks_per_node,
        net_latency=net_latency, hop_latency=platform.fabric.hop_latency)
    if calibrated and platform.calibration:
        prm = dataclasses.replace(prm, **platform.calibration_dict)
    return prm
