"""Parity of the port's platform layer (specs, registry, backends and
topologies) with the JAX reference package.

The reference's platform package imports its fastsim, which needs the
``jax.experimental.enable_x64`` alias, so the reference side runs in a
child interpreter that sets it; this process never does.  Specs are
compared byte for byte (``to_json``), FastSimParams field for field, and
topologies by route: for seeded node pairs, the links of each route as
(index in ``iter_links()``, name, capacity, latency).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.convert import platform_from_reference
from repro_torch.core.hardware.node import TPU_V5E, frontera_node, local_node
from repro_torch.core.hardware.topology import frontera_fat_tree
from repro_torch.platforms import (bulk_register, build_ici, get_platform,
                                   list_platforms, unregister)
from repro_torch.platforms.registry import add_invalidation_hook

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROUTES = 24

CHILD = r"""
import dataclasses, json, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
from repro.platforms import build_ici, get_platform, list_platforms

pairs = json.loads(sys.stdin.read())
out = {"names": list_platforms(), "platforms": {}}
for name in list_platforms():
    plat = get_platform(name)
    topo = plat.topology()
    index = {id(l): j for j, l in enumerate(topo.iter_links())}
    out["platforms"][name] = {
        "json": plat.to_json(),
        "fastsim": dataclasses.asdict(plat.fastsim()),
        "fastsim_raw": dataclasses.asdict(plat.fastsim(calibrated=False)),
        "n_links": topo.n_links,
        "ici": dataclasses.asdict(build_ici(plat)),
        "routes": [[[index[id(l)], l.name, l.capacity, l.latency]
                    for l in topo.route(s, d)] for s, d in pairs[name]],
    }
print(json.dumps(out))
"""


def _pairs():
    rng = np.random.default_rng(7)
    out = {}
    for name in list_platforms():
        n = get_platform(name).scale.n_nodes
        src = rng.integers(0, n, N_ROUTES)
        dst = rng.integers(0, n, N_ROUTES)
        dst[0] = src[0]                 # a self-send: empty route
        out[name] = [[int(s), int(d)] for s, d in zip(src, dst)]
    return out


@pytest.fixture(scope="module")
def ref():
    pairs = _pairs()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", CHILD],
                          input=json.dumps(pairs), capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return pairs, json.loads(proc.stdout.strip().splitlines()[-1])


def test_same_registry_names(ref):
    _, out = ref
    assert out["names"] == list_platforms()
    assert len(list_platforms()) == 13


@pytest.mark.parametrize("name", list_platforms())
def test_to_json_byte_equal(ref, name):
    _, out = ref
    assert get_platform(name).to_json() == out["platforms"][name]["json"]


@pytest.mark.parametrize("name", list_platforms())
def test_build_fastsim_field_equal(ref, name):
    _, out = ref
    plat = get_platform(name)
    assert dataclasses.asdict(plat.fastsim()) == \
        out["platforms"][name]["fastsim"]
    assert dataclasses.asdict(plat.fastsim(calibrated=False)) == \
        out["platforms"][name]["fastsim_raw"]


@pytest.mark.parametrize("name", list_platforms())
def test_topology_routes_equal(ref, name):
    pairs, out = ref
    topo = get_platform(name).topology()
    assert topo.n_links == out["platforms"][name]["n_links"]
    index = {id(l): j for j, l in enumerate(topo.iter_links())}
    routes = [[[index[id(l)], l.name, l.capacity, l.latency]
               for l in topo.route(s, d)] for s, d in pairs[name]]
    assert routes == out["platforms"][name]["routes"]
    assert routes[0] == []


@pytest.mark.parametrize("name", list_platforms())
def test_platform_from_reference_json(ref, name):
    _, out = ref
    js = out["platforms"][name]["json"]
    plat = platform_from_reference(js)
    assert plat == get_platform(name)
    assert plat.to_json() == js


def test_registry_node_shims():
    assert local_node().name == "bdw-2699v4"
    assert frontera_node().peak_flops == get_platform("frontera").node.peak_flops
    assert TPU_V5E.name == "tpu-v5e"
    topo = frontera_fat_tree()
    assert topo.n_links == 18200
    assert [l.name for l in topo.route(0, 88)] == \
        ["n0-up", "e0-c4-up", "e2-c4-dn", "n88-dn"]


def test_bulk_register_namespaces_and_notifies():
    seen = []
    add_invalidation_hook(seen.append)
    base = get_platform("bdw-local")
    try:
        out = bulk_register([base, dataclasses.replace(base, name="other")],
                            namespace="t")
        assert [p.name for p in out] == ["t/bdw-local", "t/other"]
        with pytest.raises(ValueError, match="already registered"):
            bulk_register([base], namespace="t")
        bulk_register([base], namespace="t", overwrite=True)
        assert seen == ["t/bdw-local"]
    finally:
        unregister(["t/bdw-local", "t/other"])
    assert "t/other" not in list_platforms()


def test_hpl_config_and_unported_backends(ref):
    """Frontera's run geometry and its backends; the ICI backend came
    with the DES slice and now equals the reference's on every platform
    (field for field: the same float expressions)."""
    _, reference = ref
    plat = get_platform("frontera")
    cfg = plat.hpl_config()
    assert (cfg.N, cfg.nb, cfg.P, cfg.Q, cfg.n_panels) == \
        (9_282_848, 384, 88, 91, 24175)
    with pytest.raises(ValueError, match="no default N"):
        dataclasses.replace(plat, scale=dataclasses.replace(
            plat.scale, hpl_n=0)).hpl_config()
    for name in list_platforms():
        assert dataclasses.asdict(build_ici(get_platform(name))) == \
            reference["platforms"][name]["ici"], name
    assert build_ici(plat, link_bw=1.0).link_bw == 1.0
    node, topo, rpn, overhead = plat.des()
    assert (node.name, topo.n_links, rpn, overhead) == \
        ("clx-8280", 18200, 1, 5e-7)
