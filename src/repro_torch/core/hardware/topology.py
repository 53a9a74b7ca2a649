"""Network topologies with *dynamically computed* routing.

The paper (§III-A2): storing all routing paths at init costs O(nodes^2)
memory at scale; D-mod-K (fat-tree) and minimal/non-minimal (dragonfly)
routes can be computed on the fly instead.  Every topology below computes
``route(src, dst) -> [Link]`` arithmetically — no routing tables — which is
what keeps 10^4-rank simulations in a few hundred MB (paper Fig 7 / our
fig7 benchmark).

Topologies: two-level fat-tree (paper's 10,008-node scalability rig and
Frontera's 6-core/182-leaf HDR fabric), dragonfly, 2-D/3-D torus (TPU ICI
— the hardware-adaptation target), and a pod-of-pods DCN wrapper.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from .network import Link


class Topology:
    base_latency: float = 0.0

    def route(self, src: int, dst: int) -> List[Link]:
        raise NotImplementedError

    @property
    def n_links(self) -> int:
        """True link count — the memory-scaling denominator of Fig 7.
        Subclasses that don't keep a flat ``links`` collection override
        this with their structural count."""
        return len(getattr(self, "links", []))

    def iter_links(self) -> List[Link]:
        """Every link, in a deterministic structural order — the fault
        layer's sampling universe (a seeded ``link_frac`` pick must hit
        the same links run-to-run)."""
        links = getattr(self, "links", None)
        if links is None:
            raise NotImplementedError(f"{type(self).__name__}.iter_links")
        return list(links.values()) if isinstance(links, dict) \
            else list(links)

    def node_links(self, node: int) -> List[Link]:
        """Links adjacent to ``node`` (for node-scoped link faults)."""
        raise NotImplementedError(f"{type(self).__name__}.node_links")


class FatTreeTwoLevel(Topology):
    """nodes -> edge switches -> core switches, D-mod-K up-routing.

    nodes_per_edge nodes attach to each edge switch; every edge switch has
    one uplink to each of n_core core switches.  The uplink for a packet is
    chosen as ``dst_node mod n_core`` (D-mod-K [Zahavi]) — deterministic,
    computed per-call, no tables.
    """

    def __init__(self, n_nodes: int, nodes_per_edge: int, n_core: int,
                 link_bw: float, hop_latency: float = 90e-9,
                 uplink_bw: Optional[float] = None,
                 base_latency: float = 1e-6):
        self.n_nodes = n_nodes
        self.nodes_per_edge = nodes_per_edge
        self.n_core = n_core
        self.n_edge = (n_nodes + nodes_per_edge - 1) // nodes_per_edge
        self.base_latency = base_latency
        ub = uplink_bw or link_bw
        # node<->edge links (one duplex pair per node, modeled per-direction)
        self.node_up = [Link(link_bw, hop_latency, f"n{i}-up")
                        for i in range(n_nodes)]
        self.node_down = [Link(link_bw, hop_latency, f"n{i}-dn")
                          for i in range(n_nodes)]
        # edge<->core per-direction links
        self.edge_up = [[Link(ub, hop_latency, f"e{e}-c{c}-up")
                         for c in range(n_core)] for e in range(self.n_edge)]
        self.edge_down = [[Link(ub, hop_latency, f"e{e}-c{c}-dn")
                           for c in range(n_core)] for e in range(self.n_edge)]

    def route(self, src: int, dst: int) -> List[Link]:
        if src == dst:
            return []
        se, de = src // self.nodes_per_edge, dst // self.nodes_per_edge
        if se == de:
            return [self.node_up[src], self.node_down[dst]]
        c = dst % self.n_core          # D-mod-K
        return [self.node_up[src], self.edge_up[se][c],
                self.edge_down[de][c], self.node_down[dst]]

    @property
    def n_links(self) -> int:
        return 2 * self.n_nodes + 2 * self.n_edge * self.n_core

    def iter_links(self) -> List[Link]:
        return (self.node_up + self.node_down
                + [l for row in self.edge_up for l in row]
                + [l for row in self.edge_down for l in row])

    def node_links(self, node: int) -> List[Link]:
        return [self.node_up[node], self.node_down[node]]


def _registry_topology(platform_name: str, n_nodes: Optional[int] = None,
                       **fabric_over):
    import dataclasses as _dc

    from repro_torch.platforms.build import build_topology
    from repro_torch.platforms.registry import get_platform
    plat = get_platform(platform_name)
    fab = _dc.replace(plat.fabric, **fabric_over) if fabric_over \
        else plat.fabric
    return build_topology(fab, plat.scale.n_nodes if n_nodes is None
                          else n_nodes)


def paper_fat_tree(link_bw: float = 100e9 / 8) -> FatTreeTwoLevel:
    """The paper's Fig 7 rig (registry: paper-fat-tree-10008)."""
    return _registry_topology("paper-fat-tree-10008", link_bw=link_bw)


def frontera_fat_tree(n_nodes: int = 8008,
                      link_bw: float = 100e9 / 8) -> FatTreeTwoLevel:
    """Frontera's HDR fat-tree (registry: frontera)."""
    return _registry_topology("frontera", n_nodes=n_nodes, link_bw=link_bw)


class Dragonfly(Topology):
    """Canonical dragonfly (Kim et al. 2008): g groups of a routers, p nodes
    per router, h global links per router.  Minimal routing (l-g-l) computed
    arithmetically; optional Valiant non-minimal via an intermediate group.
    """

    def __init__(self, n_groups: int, routers_per_group: int,
                 nodes_per_router: int, link_bw: float,
                 global_bw: Optional[float] = None,
                 hop_latency: float = 100e-9, nonminimal: bool = False,
                 base_latency: float = 1e-6):
        self.g, self.a, self.p = n_groups, routers_per_group, nodes_per_router
        self.nonminimal = nonminimal
        self.base_latency = base_latency
        gb = global_bw or link_bw
        n_routers = self.g * self.a
        self.n_nodes = n_routers * self.p
        self.node_up = [Link(link_bw, hop_latency) for _ in range(self.n_nodes)]
        self.node_down = [Link(link_bw, hop_latency) for _ in range(self.n_nodes)]
        # local all-to-all within group: per ordered router pair
        self.local = {}
        for grp in range(self.g):
            for i in range(self.a):
                for j in range(self.a):
                    if i != j:
                        self.local[(grp, i, j)] = Link(link_bw, hop_latency)
        # one global link per ordered group pair (aggregated)
        self.glob = {}
        for s in range(self.g):
            for d in range(self.g):
                if s != d:
                    self.glob[(s, d)] = Link(gb, hop_latency)

    def _locate(self, node: int) -> Tuple[int, int]:
        r = node // self.p
        return r // self.a, r % self.a

    def route(self, src: int, dst: int) -> List[Link]:
        if src == dst:
            return []
        sg, sr = self._locate(src)
        dg, dr = self._locate(dst)
        path = [self.node_up[src]]
        if sg == dg:
            if sr != dr:
                path.append(self.local[(sg, sr, dr)])
        else:
            groups = [sg, dg]
            if self.nonminimal:
                mid = (sg + dg) % self.g   # deterministic "random" Valiant
                if mid not in (sg, dg):
                    groups = [sg, mid, dg]
            # The aggregated (a, b) global link attaches to router
            # (b mod a_count) in group a — the egress — and lands on
            # router (a mod a_count) in group b — the ingress.
            cur_r = sr
            for a, b in zip(groups[:-1], groups[1:]):
                egress = b % self.a
                if cur_r != egress:
                    path.append(self.local[(a, cur_r, egress)])
                path.append(self.glob[(a, b)])
                cur_r = a % self.a
            if cur_r != dr:
                path.append(self.local[(dg, cur_r, dr)])
        path.append(self.node_down[dst])
        return path

    @property
    def n_links(self) -> int:
        return 2 * self.n_nodes + len(self.local) + len(self.glob)

    def iter_links(self) -> List[Link]:
        return (self.node_up + self.node_down + list(self.local.values())
                + list(self.glob.values()))

    def node_links(self, node: int) -> List[Link]:
        return [self.node_up[node], self.node_down[node]]


class Torus(Topology):
    """k-D torus with per-direction links — the TPU ICI fabric.

    Dimension-order routing, shortest wrap direction per dim.  A TPU v5e
    pod is a (16, 16) torus with ~50 GB/s per link per direction.
    """

    def __init__(self, dims: Tuple[int, ...], link_bw: float = 50e9,
                 hop_latency: float = 500e-9, base_latency: float = 1e-6):
        self.dims = tuple(dims)
        self.base_latency = base_latency
        self.n_nodes = math.prod(dims)
        # links[(node, dim, dir)] — dir in {+1, -1}
        self.links: Dict[Tuple[int, int, int], Link] = {}
        for n in range(self.n_nodes):
            for d in range(len(dims)):
                if dims[d] == 1:
                    continue
                self.links[(n, d, +1)] = Link(link_bw, hop_latency)
                self.links[(n, d, -1)] = Link(link_bw, hop_latency)

    def coords(self, node: int) -> Tuple[int, ...]:
        out = []
        for d in reversed(self.dims):
            out.append(node % d)
            node //= d
        return tuple(reversed(out))

    def node_at(self, coords) -> int:
        n = 0
        for c, d in zip(coords, self.dims):
            n = n * d + c
        return n

    def node_links(self, node: int) -> List[Link]:
        return [l for (n, _, _), l in self.links.items() if n == node]

    def route(self, src: int, dst: int) -> List[Link]:
        if src == dst:
            return []
        sc, dc = list(self.coords(src)), self.coords(dst)
        path: List[Link] = []
        cur = sc
        for d in range(len(self.dims)):
            size = self.dims[d]
            if size == 1:
                continue
            while cur[d] != dc[d]:
                fwd = (dc[d] - cur[d]) % size
                step = +1 if fwd <= size - fwd else -1
                node = self.node_at(cur)
                path.append(self.links[(node, d, step)])
                cur[d] = (cur[d] + step) % size
        return path


class MultiPod(Topology):
    """Pods (any intra-pod topology) joined by a DCN: per-pod up/down links
    through a non-blocking core (the cross-pod "pod" mesh axis)."""

    def __init__(self, pod_topos: List[Topology], pod_size: int,
                 dcn_bw_per_node: float = 25e9, dcn_latency: float = 10e-6):
        self.pods = pod_topos
        self.pod_size = pod_size
        self.base_latency = max(p.base_latency for p in pod_topos)
        self.dcn_latency = dcn_latency
        self.n_nodes = pod_size * len(pod_topos)
        self.dcn_up = [Link(dcn_bw_per_node * pod_size, dcn_latency)
                       for _ in pod_topos]
        self.dcn_down = [Link(dcn_bw_per_node * pod_size, dcn_latency)
                         for _ in pod_topos]

    def route(self, src: int, dst: int) -> List[Link]:
        sp, dp = src // self.pod_size, dst // self.pod_size
        sl, dl = src % self.pod_size, dst % self.pod_size
        if sp == dp:
            return self.pods[sp].route(sl, dl)
        # exit via pod gateway (node 0), cross DCN, enter at gateway
        return (self.pods[sp].route(sl, 0) + [self.dcn_up[sp],
                                              self.dcn_down[dp]]
                + self.pods[dp].route(0, dl))

    @property
    def n_links(self) -> int:
        return sum(p.n_links for p in self.pods) + 2 * len(self.pods)

    def iter_links(self) -> List[Link]:
        out: List[Link] = []
        for p in self.pods:
            out.extend(p.iter_links())
        return out + self.dcn_up + self.dcn_down

    def node_links(self, node: int) -> List[Link]:
        pod, local = node // self.pod_size, node % self.pod_size
        return self.pods[pod].node_links(local)
