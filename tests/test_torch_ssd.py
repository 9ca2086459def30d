"""K7's plain versions, the route of the port's ``ssd_chunk_scan`` on CPU
tensors, against the reference: its Pallas SSD kernel in interpret mode
on the sweep of tests/test_kernels.py (float32 at 2e-5, bfloat16 inputs
at the sweep's 5e-2), the float64 recurrences (the port's and the
reference's) at ragged lengths with an initial and a final state (1e-4),
and the reference's lax ``_ssd_chunked`` at every length it takes (1e-4,
tests/test_ssm.py's bar), and at the lengths it rejects the recurrence.
Inputs come from numpy with fixed seeds, by the sweep's laws; the kernel
itself is held to the plain version on the card
(tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_chunk_scan_op
from repro.kernels.ssd import ssd_chunk_scan_ref as jax_recurrence
from repro.models.ssm import _ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd import (ssd_chunk_scan, ssd_chunk_scan_plain,
                                     ssd_chunk_scan_ref)
from repro_torch.models.ssm import _ssd_chunked

TOL = {"float32": 2e-5, "bfloat16": 5e-2}      # tests/test_kernels.py
RTOL = dict(rtol=1e-4, atol=1e-4)              # tests/test_ssm.py


def _softplus(v):
    return np.logaddexp(v, 0.0)


def _inputs(seed, B, nh, G, S, hd, n):
    """Kernel layout, the sweep's laws: x, B, C normal, dt = softplus of a
    normal, A = -exp(normal / 2), a = dt * A; float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, nh, S, hd)).astype(np.float32)
    dt = _softplus(rng.normal(size=(B, nh, S))).astype(np.float32)
    A = -np.exp(rng.normal(size=(nh,)) * 0.5).astype(np.float32)
    a = (dt * A[None, :, None]).astype(np.float32)
    Bm = rng.normal(size=(B, G, S, n)).astype(np.float32)
    Cm = rng.normal(size=(B, G, S, n)).astype(np.float32)
    return x, a, dt, Bm, Cm


def _t(arrays, dtype="float32"):
    return [torch.as_tensor(v).to(getattr(torch, dtype)) for v in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nh,G,S,hd,n,ck", [
    (2, 4, 2, 64, 8, 16, 16),
    (1, 2, 1, 128, 16, 8, 32),
    (2, 2, 2, 64, 8, 8, 64),
])
def test_plain_matches_reference_kernel(B, nh, G, S, hd, n, ck, dtype):
    """The shapes of test_kernels.py::test_ssd_kernel_sweep; x, B and C
    in ``dtype``, a and dt float32, y in x's type from both."""
    x, a, dt, Bm, Cm = _inputs(3, B, nh, G, S, hd, n)
    xt, Bt, Ct = _t((x, Bm, Cm), dtype)
    before = ssd_chunk_scan.launches
    y, h = ssd_chunk_scan(xt, torch.as_tensor(a), torch.as_tensor(dt), Bt,
                          Ct, chunk=ck)
    assert ssd_chunk_scan.launches == before          # CPU: no kernel
    assert y.dtype == xt.dtype and y.shape == (B, nh, S, hd)
    assert h.dtype == torch.float32 and h.shape == (B, nh, n, hd)
    jd = getattr(jnp, dtype)
    ref = ssd_chunk_scan_op(jnp.asarray(x).astype(jd), jnp.asarray(a),
                            jnp.asarray(dt), jnp.asarray(Bm).astype(jd),
                            jnp.asarray(Cm).astype(jd), chunk=ck,
                            interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("S", [1, 17, 41, 65])
def test_plain_matches_recurrence_at_ragged_lengths(S, chunk, with_h0):
    """Any S, a short last chunk: y and the final state equal the float64
    recurrence's, the port's copy, which without h0 equals the
    reference's (repro/kernels/ssd/ref.py) to float64 rounding."""
    B, nh, G, hd, n = 2, 4, 2, 8, 16
    x, a, dt, Bm, Cm = _inputs(S, B, nh, G, S, hd, n)
    h0 = (np.random.default_rng(7).normal(size=(B, nh, n, hd))
          .astype(np.float32) if with_h0 else None)
    args = _t((x, a, dt, Bm, Cm))
    h0t = None if h0 is None else torch.as_tensor(h0)
    y, h = ssd_chunk_scan_plain(*args, chunk=chunk, h0=h0t)
    y64, h64 = ssd_chunk_scan_ref(*args, h0=h0t)
    assert y64.dtype == h64.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), y64.numpy(), **RTOL)
    np.testing.assert_allclose(h.numpy(), h64.numpy(), **RTOL)
    if h0 is None:
        ref = jax_recurrence(x, a, dt, Bm, Cm)
        np.testing.assert_allclose(y64.numpy(), np.asarray(ref, np.float64),
                                   rtol=1e-6, atol=1e-6)


def _model_layout(seed, B, S, nh, G, hd, n):
    """The model's layout: xh (B,S,nh,hd), dt (B,S,nh), A (nh,), Bm/Cm
    (B,S,G,n), test_ssm.py's laws."""
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, S, nh, hd)).astype(np.float32)
    dt = _softplus(rng.normal(size=(B, S, nh))).astype(np.float32)
    A = -np.exp(rng.normal(size=(nh,)) * 0.5).astype(np.float32)
    Bm = rng.normal(size=(B, S, G, n)).astype(np.float32)
    Cm = rng.normal(size=(B, S, G, n)).astype(np.float32)
    return xh, dt, A, Bm, Cm


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("S,chunk", [(1, 16), (8, 16), (40, 16), (64, 16),
                                     (96, 32), (70, 32)])
def test_ssd_chunked_matches_reference(S, chunk, with_h0):
    """Lengths the reference's lax path takes (S divisible by its
    S // chunk chunks): it cuts S = 40 at chunk 16 into 2 x 20, the port
    into 16 + 16 + 8; y and the final state agree at test_ssm.py's 1e-4."""
    B, nh, G, hd, n = 2, 4, 2, 8, 16
    arrays = _model_layout(S, B, S, nh, G, hd, n)
    h0 = (np.random.default_rng(1).normal(size=(B, nh, n, hd))
          .astype(np.float32) if with_h0 else None)
    y, h = _ssd_chunked(*_t(arrays), chunk,
                        h0=None if h0 is None else torch.as_tensor(h0))
    jy, jh = jax_ssd_chunked(*(jnp.asarray(v) for v in arrays), chunk,
                             h0=None if h0 is None else jnp.asarray(h0))
    assert y.shape == (B, S, nh, hd) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **RTOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **RTOL)


@pytest.mark.parametrize("S", [41, 65, 97])
def test_ssd_chunked_takes_lengths_the_reference_rejects(S):
    """The reference cuts S into S // 16 equal chunks and fails where they
    do not divide S (ROADMAP.md queue 3); the port masks a short last
    chunk and matches the float64 recurrence there."""
    B, nh, G, hd, n = 1, 4, 2, 8, 16
    arrays = _model_layout(S, B, S, nh, G, hd, n)
    with pytest.raises(TypeError):
        jax_ssd_chunked(*(jnp.asarray(v) for v in arrays), 16)
    xh, dt, A, Bm, Cm = _t(arrays)
    y, h = _ssd_chunked(xh, dt, A, Bm, Cm, 16)
    a = (dt * A).transpose(1, 2)
    y64, h64 = ssd_chunk_scan_ref(xh.transpose(1, 2), a, dt.transpose(1, 2),
                                  Bm.transpose(1, 2), Cm.transpose(1, 2))
    np.testing.assert_allclose(y.numpy(), y64.transpose(1, 2).numpy(),
                               **RTOL)
    np.testing.assert_allclose(h.numpy(), h64.numpy(), **RTOL)


@pytest.mark.cuda
def test_wrapper_raises_for_unbuilt_shapes_on_the_card():
    """On a CUDA tensor the wrapper launches K7 or raises: a (head_dim,
    d_state) it was not built for, or a chunk past 256, is a
    ``ValueError``, and the plain version is never taken."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    for hd, n, chunk in ((32, 16, 16), (16, 32, 16), (16, 16, 512)):
        x, a, dt, Bm, Cm = (t.to(dev) for t in
                            _t(_inputs(0, 1, 2, 1, 8, hd, n)))
        before = ssd_chunk_scan.launches
        with pytest.raises(ValueError):
            ssd_chunk_scan(x, a, dt, Bm, Cm, chunk=chunk)
        assert ssd_chunk_scan.launches == before
