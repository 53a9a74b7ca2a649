"""The port's SSD chunk scan (repro_torch.kernels.ssd_scan) against the JAX
reference.

On the CPU, ``ops.ssd`` computes the plain version (``ssd_scan_ref``).
At tests/test_kernels.py's four shapes, and at zamba2-2.7b's P = 64,
N = 64 and chunk 256, it is held against the reference's Pallas kernel
run in interpret mode and against the port's
``ssd_ref_sequential`` (the exact recurrence), with the reference test's
own limits: rtol 2e-4 / atol 2e-3 in float32 and rtol 5e-2 / atol 5e-1
in bfloat16 (the cumulative decay exponent is summed in float32 over a
chunk, and bfloat16 inputs carry 8 mantissa bits).  A ragged S, which the
Pallas kernel asserts on, is held against ``ssd_ref_sequential``; the
port's ``ssd_chunked`` against the reference's for y and the final
state within 1e-4 of scale (float32: only the summation order differs);
B and C given as one group's broadcast to the heads (head stride 0, as
the model passes them) against the exact recurrence.  ``ssd_split_ref``,
the plain mirror of the CUDA kernel's three passes, is held against the
Pallas kernel at the four shapes and against the exact recurrence there,
at ragged lengths, below the chunk and on the head-stride-0 view, with
the same limits.  The CUDA kernel itself runs only on the card
(``-m cuda``).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import (ssd, ssd_ref_sequential, ssd_scan,
                                          ssd_scan_ref, ssd_split_ref)
from repro_torch.models.mamba2 import ssd_chunked

# (B, S, H, P, N, chunk): tests/test_kernels.py's shapes, then zamba2-2.7b's
# P, N and chunk (N = 64: the kernel's 128-wide template, columns n >= 64
# masked) over two chunks
SHAPES = [(1, 64, 1, 8, 4, 16), (2, 128, 3, 16, 8, 32),
          (1, 256, 2, 64, 16, 64), (1, 128, 2, 32, 128, 128),
          (1, 512, 2, 64, 64, 256)]
TOL = {"float32": (2e-4, 2e-3), "bfloat16": (5e-2, 5e-1)}   # rtol, atol
PORT_FNS = {"ssd": ssd, "ssd_scan_ref": ssd_scan_ref}
# (B, S, H, P, N, chunk) beyond SHAPES for the split decomposition: ragged
# last chunks, an S below the chunk (one chunk of S positions)
SPLIT_EXTRA = [(2, 100, 3, 16, 8, 32), (2, 47, 3, 16, 8, 64),
               (2, 300, 3, 16, 8, 256), (1, 40, 2, 16, 8, 64)]


@pytest.fixture(scope="module")
def jref():
    """The reference's kernel and oracles, imported only by the tests that
    use them: the GPU machine, which runs the ``cuda`` tests, has no jax."""
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.kernel import ssd_scan as jkernel
    from repro.kernels.ssd_scan.ref import ssd_ref_sequential as jseq
    from repro.models.mamba2 import ssd_chunked as jchunked
    return types.SimpleNamespace(jnp=jnp, kernel=jkernel, seq=jseq,
                                 chunked=jchunked)


def _inputs(b, s, h, p, n, seed):
    """x, dt (softplus of a normal), A (-exp of a normal), B, C as numpy
    float32, the distributions of the reference's kernel test."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    B = rng.standard_normal((b, s, h, n), np.float32)
    C = rng.standard_normal((b, s, h, n), np.float32)
    return x, dt, A, B, C


def _torch(arrays, dtype):
    """x, B, C in ``dtype`` (rounded to nearest even, as jnp's astype);
    dt and A stay float32."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrays)
    dt_ = getattr(torch, dtype)
    return x.to(dt_), dt, A, B.to(dt_), C.to(dt_)


def _jax(arrays, dtype, jnp):
    x, dt, A, B, C = (jnp.asarray(a) for a in arrays)
    dt_ = getattr(jnp, dtype)
    return x.astype(dt_), dt, A, B.astype(dt_), C.astype(dt_)


def _close(got, want, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("fn", sorted(PORT_FNS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_reference_kernel(jref, shape, dtype, fn):
    *dims, chunk = shape
    arrays = _inputs(*dims, seed=sum(shape))
    want = jref.kernel(*_jax(arrays, dtype, jref.jnp), chunk, interpret=True)
    got = PORT_FNS[fn](*_torch(arrays, dtype), chunk)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_exact_recurrence(jref, shape, dtype):
    """``ops.ssd`` against the port's ``ssd_ref_sequential``, and that
    against the reference's."""
    *dims, chunk = shape
    arrays = _inputs(*dims, seed=sum(shape) + 1)
    inputs = _torch(arrays, dtype)
    seq = ssd_ref_sequential(*inputs)
    _close(ssd(*inputs, chunk), seq.float().numpy(), dtype)
    _close(seq, jref.seq(*_jax(arrays, dtype, jref.jnp)), dtype)


@pytest.mark.parametrize("s,chunk", [(100, 32), (47, 64), (300, 256)])
def test_ragged_length_is_dt_zero_padding(s, chunk):
    """A ragged S (the Pallas kernel asserts S % chunk == 0) equals the
    exact recurrence, and equals running the padded input and cutting."""
    arrays = _inputs(2, s, 3, 16, 8, seed=s)
    inputs = _torch(arrays, "float32")
    got = ssd_scan_ref(*inputs, chunk)
    _close(got, ssd_ref_sequential(*inputs).numpy(), "float32")
    pad = -s % min(chunk, s)
    x, dt, A, B, C = inputs
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in (x, dt, B, C)]
    whole = ssd_scan_ref(padded[0], padded[1], A, padded[2], padded[3],
                         chunk)[:, :s]
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


def _shared_group(inputs):
    """B and C cut to head 0's and broadcast to every head as a view with
    head stride 0, as the model's ``_heads_bc`` passes one group."""
    x, dt, A, B, C = inputs
    return (x, dt, A, *(t[:, :, :1].expand_as(t) for t in (B, C)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_group_view_matches_exact_recurrence(dtype):
    inputs = _shared_group(_torch(_inputs(2, 96, 4, 16, 8, seed=11), dtype))
    assert inputs[3].stride(2) == 0 and inputs[4].stride(2) == 0
    want = ssd_ref_sequential(*(t.contiguous() for t in inputs))
    _close(ssd(*inputs, 32), want.float().numpy(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_ref_matches_reference_kernel(jref, shape, dtype):
    """The kernel's three-pass decomposition against the Pallas kernel."""
    *dims, chunk = shape
    arrays = _inputs(*dims, seed=sum(shape) + 2)
    want = jref.kernel(*_jax(arrays, dtype, jref.jnp), chunk, interpret=True)
    got = ssd_split_ref(*_torch(arrays, dtype), chunk)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_head", "shared"])
@pytest.mark.parametrize("shape", SHAPES + SPLIT_EXTRA,
                         ids=lambda s: "x".join(map(str, s)))
def test_split_ref_matches_exact_recurrence(shape, shared, dtype):
    """The decomposition against the exact recurrence at the four shapes,
    ragged lengths and an S below the chunk, with B and C per head or one
    group's broadcast to every head (head stride 0)."""
    *dims, chunk = shape
    inputs = _torch(_inputs(*dims, seed=sum(shape) + 3), dtype)
    if shared:
        inputs = _shared_group(inputs)
        assert inputs[3].stride(2) == 0 or inputs[3].shape[2] == 1
    want = ssd_ref_sequential(*(t.contiguous() for t in inputs))
    got = ssd_split_ref(*inputs, chunk)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _close(got, want.float().numpy(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(128, 32), (100, 32)])
def test_ssd_chunked_matches_reference(jref, s, chunk, dtype):
    """The model's plain scan, y and final state, against the reference's
    (both in the compute dtype with a float32 state)."""
    arrays = _inputs(2, s, 3, 16, 8, seed=7 + s)
    y, state = ssd_chunked(*_torch(arrays, dtype), chunk)
    jy, jstate = jref.chunked(*_jax(arrays, dtype, jref.jnp), chunk)
    limit = 1e-4 if dtype == "float32" else 5e-2
    for got, want in ((y, jy), (state, jstate)):
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        assert (np.abs(got.float().numpy() - want).max()
                / np.abs(want).max()) <= limit
    assert y.dtype == getattr(torch, dtype) and state.dtype == torch.float32


def test_cpu_tensors_never_launch():
    before = ssd_scan.launches
    ssd(*_torch(_inputs(1, 16, 2, 8, 4, 0), "float32"), 8)
    assert ssd_scan.launches == before


def test_kernel_wrapper_refuses_what_it_does_not_take():
    x, dt, A, B, C = _torch(_inputs(1, 16, 2, 8, 4, 1), "float32")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssd_scan(x, dt, A, B, C)
    with pytest.raises(ValueError, match="must be"):
        ssd(x[0], dt, A, B, C)
    with pytest.raises(ValueError, match="must both be"):
        ssd(x, dt, A, B[..., :2], C)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd(x, dt, A, B.to(torch.bfloat16), C)
    with pytest.raises(TypeError, match="dt and A must be float32"):
        ssd(x, dt.double(), A, B, C)


@pytest.mark.parametrize("case", ["requires_grad", "P>128", "N>128",
                                  "chunk>256"])
def test_kernel_wrapper_refuses_sizes_and_grad(monkeypatch, case):
    """Refusals that come before any launch: an input that would need a
    backward (the kernel has none), and sizes above the kernel's limits.
    CPU tensors pass as CUDA ones here so the checks past the device test
    run; nothing is launched."""
    p, n, s, chunk = 8, 4, 16, 8
    if case == "P>128":
        p = 129
    elif case == "N>128":
        n = 129
    elif case == "chunk>256":
        s, chunk = 300, 257
    x, dt, A, B, C = _torch(_inputs(1, s, 2, p, n, 2), "float32")
    if case == "requires_grad":
        x.requires_grad_(True)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda", 0)))
    err = RuntimeError if case == "requires_grad" else ValueError
    match = "no backward" if case == "requires_grad" else "takes P <= 128"
    with pytest.raises(err, match=match):
        ssd_scan(x, dt, A, B, C, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + [(2, 100, 4, 32, 16, 256),
                                            (1, 300, 3, 64, 128, 256),
                                            (1, 256, 4, 64, 128, 256),
                                            (2, 300, 4, 64, 64, 256),
                                            (1, 300, 2, 128, 128, 256),
                                            (2, 200, 2, 128, 128, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_matches_plain_version(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    *dims, chunk = shape
    inputs = [t.cuda() for t in _torch(_inputs(*dims, seed=sum(shape)),
                                       dtype)]
    before = ssd_scan.launches
    got = ssd(*inputs, chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    _close(got.cpu(), ssd_scan_ref(*inputs, chunk).float().cpu().numpy(),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 300, 4, 64, 128, 256),
                                   (1, 256, 4, 64, 128, 256),
                                   (1, 300, 2, 128, 128, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_takes_a_shared_group_view(shape, dtype):
    """One chunk (NC = 1), a ragged last chunk, and P = N = 128, with one
    group's B and C read through head stride 0; the kernel against the
    plain version and against the split decomposition it mirrors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    *dims, chunk = shape
    inputs = _shared_group([t.cuda() for t in _torch(
        _inputs(*dims, seed=12), dtype)])
    got = ssd(*inputs, chunk)
    _close(got.cpu(), ssd_scan_ref(*inputs, chunk).float().cpu().numpy(),
           dtype)
    _close(got.cpu(), ssd_split_ref(*inputs, chunk).float().cpu().numpy(),
           dtype)
