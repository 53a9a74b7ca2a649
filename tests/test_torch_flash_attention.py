"""The port's flash attention (repro_torch.kernels.flash_attention) against
the JAX reference.

On the CPU, ``ops.flash_attention`` computes the plain version; both it
and ``attention_ref`` are held against the reference's Pallas kernel run
in interpret mode, at tests/test_kernels.py's shapes and tolerances:
2e-5 in float32 (summation order), 2e-2 in bfloat16 (the kernel rounds p
to bf16 before the P.V product, the plain version the normalized
probabilities), and at two head_dim-80 shapes (stablelm-3b's and zamba2's
head dim: 32 heads a KV group of 1, and GQA), and at R = 16 and R = 48
query heads a KV group at hd 128 (qwen3-moe-235b-a22b's and granite-34b's
group ratios, reduced widths).  A ragged length (S = 200),
which the Pallas kernel asserts on, is held against the reference's
``attention_ref``.  The CUDA
kernel itself runs only on the card (``-m cuda``).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_fwd)

# (B, S, G, R, hd): tests/test_kernels.py's shapes, two at hd 80, two at
# wide query groups (R = 16, R = 48), then a ragged one
SHAPES = [(1, 128, 1, 1, 64), (2, 256, 2, 4, 64), (1, 256, 1, 7, 32),
          (1, 512, 4, 2, 128), (1, 128, 32, 1, 80), (2, 256, 2, 3, 80),
          (1, 256, 4, 16, 128), (1, 256, 1, 48, 128)]
WIDE_R = 16
RAGGED = (1, 200, 2, 7, 64)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PORT_FNS = {"attention_ref": attention_ref, "flash_attention": flash_attention}


@pytest.fixture(scope="module")
def jref():
    """The reference's attention, imported only by the tests that use it:
    the GPU machine, which runs the ``cuda`` tests, has no jax."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.kernel import flash_attention_fwd
    from repro.kernels.flash_attention.ref import attention_ref as jref_fn
    return types.SimpleNamespace(jnp=jnp, kernel=flash_attention_fwd,
                                 ref=jref_fn)


def _inputs(shape, seed):
    b, s, g, r, hd = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, g, r, hd), np.float32),
            rng.standard_normal((b, s, g, hd), np.float32),
            rng.standard_normal((b, s, g, hd), np.float32))


def _both(arrays, dtype, jnp):
    """The same values in both frameworks: float32 numpy, rounded to
    bfloat16 the same way (round to nearest even) on each side."""
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


@pytest.mark.parametrize("fn", sorted(PORT_FNS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES + [RAGGED],
                         ids=lambda s: "x".join(map(str, s)))
def test_matches_reference(jref, shape, causal, dtype, fn):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(shape, seed=sum(shape)),
                                      dtype, jref.jnp)
    if shape == RAGGED:
        want = jref.ref(jq, jk, jv, causal=causal)
    else:
        want = jref.kernel(jq, jk, jv, causal=causal, bq=128, bk=128,
                           interpret=True)
    got = PORT_FNS[fn](tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_cpu_tensors_never_launch():
    before = flash_attention_fwd.launches
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 16, 1, 2, 32), 0))
    flash_attention(q, k, v)
    assert flash_attention_fwd.launches == before


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 16, 2, 3, 32), 1))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="must be"):
        flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="disagree"):
        flash_attention(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q, k.to(torch.bfloat16), v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES + [RAGGED, (2, 77, 3, 5, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_matches_plain_version(shape, causal, dtype):
    """The kernel element by element against the plain version.  At
    R >= 16 query heads a group, a planted fault (the R heads of each group
    rotated by one, a wrong q * R row flattening) must read above the same
    limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = (torch.from_numpy(a).cuda().to(getattr(torch, dtype))
               for a in _inputs(shape, seed=sum(shape)))
    before = flash_attention_fwd.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    want = attention_ref(q, k, v, causal=causal).float().cpu().numpy()
    np.testing.assert_allclose(got.float().cpu().numpy(), want,
                               atol=TOL[dtype], rtol=TOL[dtype])
    if shape[3] >= WIDE_R:
        rotated = got.roll(1, dims=3).float().cpu().numpy()
        excess = np.abs(rotated - want) - TOL[dtype] * (1 + np.abs(want))
        assert excess.max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(300, 300), (77, 200), (200, 77)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("r", [1, 7])
@pytest.mark.parametrize("hd", [32, 64, 80, 128])
def test_cuda_bf16_kernel_ragged_lengths(hd, r, sq, sk, causal):
    """The bf16 kernel (wgmma, TMA K/V ring) at every head dim (hd 80 padded
    to 96 columns in shared memory), with R = 1
    and R = 7 query heads a group, ragged Sq and Sk (none a multiple of the
    128-key tile, Sq != Sk either way): against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(hd + r + sq + sk)
    q = torch.from_numpy(rng.standard_normal((2, sq, 2, r, hd), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, sk, 2, hd), np.float32))
            for _ in range(2))
    q, k, v = (t.cuda().to(torch.bfloat16) for t in (q, k, v))
    before = flash_attention_fwd.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    want = attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(300, 177), (77, 200)],
                         ids=lambda v: str(v))
def test_cuda_f32_kernel_covers_every_column_at_hd_80(sq, sk, causal):
    """The float32 kernel gives each lane ceil(80 / 32) = 3 output columns,
    the third only on lanes 0-15: every column of the output, 64-79
    included, against the plain version (a dropped column would read 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(sq + sk)
    q = torch.from_numpy(rng.standard_normal((2, sq, 2, 3, 80), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, sk, 2, 80), np.float32))
            .cuda() for _ in range(2))
    q = q.cuda()
    got = flash_attention(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (got - want).abs().amax(dim=(0, 1, 2, 3))
    assert err.shape == (80,) and float(err.max()) <= TOL["float32"]
    assert float(want[..., 64:].abs().max()) > 0.1
