"""The port's max-min fair allocation (repro_torch.kernels.maxmin_fair)
against the JAX reference.

On the CPU the kernel wrapper computes its plain version, which is held
against the reference's Pallas kernel run in interpret mode: exactly
equal, since a min does no arithmetic.  ``waterfill`` is held at rtol
1e-4 (tests/test_kernels.py's tolerance) and to link conservation.  The
CUDA kernel itself runs only on the card (``-m cuda``; chip_smoke.py
holds it against the plain version at the main path's shapes).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.maxmin_fair import (INF, flow_incidence,
                                             masked_min_rows,
                                             masked_min_rows_ref, waterfill,
                                             waterfill_ref)
from repro_torch.platforms import get_platform

SHAPES = [(64, 128, 0.1), (256, 256, 0.03), (8, 128, 0.5)]


@pytest.fixture(scope="module")
def jref():
    """The reference's max-min functions, imported only by the tests that
    use them: the GPU machine, which runs the ``cuda`` tests, has no jax."""
    import jax.numpy as jnp
    from repro.kernels.maxmin_fair import kernel, ops, ref
    return types.SimpleNamespace(
        jnp=jnp, minrows=kernel.masked_min_rows, waterfill=ops.waterfill,
        minrows_ref=ref.masked_min_rows_ref, waterfill_ref=ref.waterfill_ref)


def _inputs(f, l, density, seed):
    rng = np.random.default_rng(seed)
    adj = (rng.random((f, l)) < density).astype(np.int8)
    vals = (rng.random(l) * 100).astype(np.float32)
    return adj, vals


def _conserves(adj, caps, rates):
    usage = adj.astype(np.float64).T @ np.minimum(
        np.asarray(rates, np.float64), 1e30)
    return bool((usage <= np.asarray(caps, np.float64) * (1 + 1e-3)).all())


@pytest.mark.parametrize("f,l,density", SHAPES)
def test_masked_min_rows_equals_pallas_kernel(jref, f, l, density):
    adj, vals = _inputs(f, l, density, seed=f * l)
    jnp = jref.jnp
    ref = np.asarray(jref.minrows(jnp.asarray(adj), jnp.asarray(vals),
                                  bf=min(256, f), bl=128, interpret=True))
    out = masked_min_rows(torch.from_numpy(adj), torch.from_numpy(vals))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_masked_min_rows_ragged_and_empty_rows(jref):
    adj, vals = _inputs(37, 45, 0.05, seed=3)
    adj[0] = 0                                   # a flow with no link
    adj[1, :3] = -1                              # non-positive: no link
    ref = np.asarray(jref.minrows_ref(jref.jnp.asarray(adj),
                                      jref.jnp.asarray(vals)))
    out = masked_min_rows(torch.from_numpy(adj), torch.from_numpy(vals))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out[0].item() == np.float32(INF)


def test_waterfill_matches_reference_and_conserves(jref):
    adj, _ = _inputs(128, 128, 0.05, seed=4)
    caps = (np.random.default_rng(5).random(128) * 1e9 + 1e8).astype(
        np.float32)
    ref = np.asarray(jref.waterfill(jref.jnp.asarray(adj),
                                    jref.jnp.asarray(caps), use_kernel=True))
    out = waterfill(torch.from_numpy(adj), torch.from_numpy(caps))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4)
    assert _conserves(adj, caps, out.numpy())


def test_waterfill_des_shared_bottleneck(jref):
    """Two flows share a 10 GB/s link; the second is held to 2 GB/s by its
    own link, so the first gets 8 GB/s (the DES network's answer)."""
    adj = np.array([[1, 1, 0], [1, 0, 1]], np.int8)
    caps = np.array([10e9, 100e9, 2e9], np.float32)
    out = waterfill(torch.from_numpy(adj), torch.from_numpy(caps))
    np.testing.assert_allclose(out.numpy(), [8e9, 2e9], rtol=1e-5)
    ref = np.asarray(jref.waterfill(jref.jnp.asarray(adj),
                                    jref.jnp.asarray(caps), use_kernel=False))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4)


def test_waterfill_ring_broadcast_on_bdw_local(jref):
    """HPL's 1-ring panel broadcast in every process row at once, routed
    over bdw-local's fat tree: rank (p, q) on node p + q*P sends to
    (p, (q+1) % Q)."""
    plat = get_platform("bdw-local")
    P, Q = plat.scale.grid
    pairs = [(p + q * P, p + ((q + 1) % Q) * P)
             for q in range(Q) for p in range(P)]
    adj, caps = flow_incidence(plat.topology(), pairs)
    assert adj.shape == (16, plat.topology().n_links)
    assert (adj.sum(axis=1) == 4).all()          # every route crosses edges
    ref = np.asarray(jref.waterfill(jref.jnp.asarray(adj),
                                    jref.jnp.asarray(caps)))
    out = waterfill(torch.from_numpy(adj), torch.from_numpy(caps))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4)
    assert _conserves(adj, caps, out.numpy())


def test_waterfill_ragged_against_reference_plain(jref):
    adj, _ = _inputs(37, 45, 0.08, seed=11)
    adj[5] = 0                                   # a self-send: INF rate
    caps = (np.random.default_rng(12).random(45) * 1e9 + 1e8).astype(
        np.float32)
    ref = np.asarray(jref.waterfill_ref(jref.jnp.asarray(adj),
                                        jref.jnp.asarray(caps)))
    out = waterfill(torch.from_numpy(adj), torch.from_numpy(caps))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4)
    plain = waterfill_ref(torch.from_numpy(adj), torch.from_numpy(caps))
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    assert _conserves(adj, caps, out.numpy())


def test_cpu_tensors_never_launch():
    before = masked_min_rows.launches
    adj, vals = _inputs(64, 128, 0.1, seed=1)
    masked_min_rows(torch.from_numpy(adj), torch.from_numpy(vals))
    waterfill(torch.from_numpy(adj), torch.from_numpy(vals))
    assert masked_min_rows.launches == before


def test_wrapper_checks_inputs():
    adj, vals = _inputs(8, 16, 0.5, seed=2)
    with pytest.raises(TypeError, match="int8"):
        masked_min_rows(torch.from_numpy(adj).float(), torch.from_numpy(vals))
    with pytest.raises(TypeError, match="float32"):
        masked_min_rows(torch.from_numpy(adj), torch.from_numpy(vals).double())
    with pytest.raises(ValueError, match=r"\(F, L\)"):
        masked_min_rows(torch.from_numpy(adj), torch.from_numpy(vals[:8]))


def test_waterfill_refuses_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    adj = torch.ones((2, 2), dtype=torch.int8)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        waterfill(adj, torch.ones(2))


def test_plain_version_matches_reference_plain(jref):
    adj, vals = _inputs(40, 70, 0.1, seed=9)
    ref = np.asarray(jref.minrows_ref(jref.jnp.asarray(adj),
                                      jref.jnp.asarray(vals)))
    out = masked_min_rows_ref(torch.from_numpy(adj), torch.from_numpy(vals))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("f,l,density", SHAPES + [(1000, 300, 0.05)])
def test_cuda_kernel_equals_plain_version(f, l, density):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    adj, vals = _inputs(f, l, density, seed=f + l)
    a, v = torch.from_numpy(adj).cuda(), torch.from_numpy(vals).cuda()
    before = masked_min_rows.launches
    out = masked_min_rows(a, v)
    torch.cuda.synchronize()
    assert masked_min_rows.launches == before + 1
    assert torch.equal(out, masked_min_rows_ref(a, v))
