"""The port's shared layers against ``repro.models.layers`` on the same
float32 inputs, within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-6, atol=1e-6)


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_rms_norm_matches_reference():
    rng = _rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3.0
    g = rng.normal(size=(48,)).astype(np.float32)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)
    got = tl.rms_norm(torch.as_tensor(x), torch.as_tensor(g), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("positions", [
    np.arange(7, dtype=np.int32),                       # shared sequence
    np.array([0, 13, 250], np.int32)[:, None, None],    # per-sequence
])
def test_apply_rope_matches_reference(positions):
    rng = _rng(1)
    B = 3
    S = 7 if positions.ndim == 1 else 1
    x = rng.normal(size=(B, 4, S, 16)).astype(np.float32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(positions), 10000.0)
    got = tl.apply_rope(torch.as_tensor(x), torch.as_tensor(positions),
                        10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_frequencies_identical():
    np.testing.assert_array_equal(tl.rope_frequencies(64, 10000.0),
                                  jl.rope_frequencies(64, 10000.0))


def test_swiglu_matches_reference():
    """``wg`` is the gate: h * sigmoid(g) * g, in the reference's order."""
    rng = _rng(2)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wi", (32, 80)), ("wg", (32, 80)), ("wo", (80, 32)))}
    want = jl.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x))
    got = tl.swiglu({k: torch.as_tensor(v) for k, v in p.items()},
                    torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dtype_names():
    assert tl.dtype_of("bfloat16") is torch.bfloat16
    assert tl.dtype_of("float32") is torch.float32
