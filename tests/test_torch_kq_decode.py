"""K3 in the port: its plain PyTorch version against the reference's
Pallas kernel (interpret mode) and jnp oracle, on the reference kernel
sweep (varlen lengths, non-divisible tails); the wrapper's CPU routing;
and a lazy build (the module imports where there is no nvcc)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kq_decode import (kq_decode_attention_op,
                                     kq_decode_attention_ref)
from repro_torch.kernels import build
from repro_torch.kernels.kq_decode import kq_decode as k3_mod
from repro_torch.kernels.kq_decode import (kq_decode_attention,
                                           kq_decode_attention_ref as
                                           torch_ref)

# the reference kernel tests' tolerances (tests/test_kernels.py:15-17)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, B, H, Hkv, T, Rk, Rv):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Rk)).astype(np.float32),
            rng.normal(size=(B, Hkv, T, Rk)).astype(np.float32),
            rng.normal(size=(B, Hkv, T, Rv)).astype(np.float32))


def _both(arrays, dtype):
    """The same values as jnp and torch arrays of ``dtype`` (both round
    float32 to bfloat16 to nearest even)."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,Rk,Rv,bt,lengths", [
    (1, 4, 2, 64, 16, 16, 16, (64,)),
    (2, 8, 2, 128, 32, 16, 32, (101, 7)),        # mixed lengths, GQA m=4
    (1, 4, 1, 256, 8, 8, 64, (6,)),
    (2, 4, 4, 64, 16, 32, 16, (32, 64)),
    (3, 4, 2, 100, 16, 16, 16, (100, 37, 1)),    # T % bt != 0 tail block
    (2, 2, 2, 80, 8, 8, 32, (80, 50)),           # tail block + varlen
    (2, 12, 4, 70, 37, 45, 32, (70, 33)),        # odd ranks, m=3
])
def test_plain_k3_matches_reference_kernel(B, H, Hkv, T, Rk, Rv, bt,
                                           lengths, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(1, B, H, Hkv, T, Rk, Rv), dtype)
    lens = np.asarray(lengths, np.int32)
    want = kq_decode_attention_op(jq, jk, jv, jnp.asarray(lens),
                                  block_t=bt, scale=0.25)
    oracle = kq_decode_attention_ref(jq, jk, jv, jnp.asarray(lens),
                                     scale=0.25)
    got = kq_decode_attention(tq, tk, tv, torch.as_tensor(lens),
                              scale=0.25)
    assert got.dtype == tq.dtype and got.shape == (B, H, Rv)
    for ref in (want, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   **TOL[dtype])


def test_zero_length_gives_zero_like_the_kernel():
    """lengths == 0: the port follows the kernel (acc / max(l, 1e-30) =
    0), not the jnp oracle, which averages the masked cache uniformly."""
    arrays = _inputs(2, 2, 4, 2, 16, 8, 8)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    lens = np.asarray([0, 5], np.int32)
    got = kq_decode_attention(tq, tk, tv, torch.as_tensor(lens)).numpy()
    kern = np.asarray(kq_decode_attention_op(jq, jk, jv, jnp.asarray(lens),
                                             block_t=8))
    oracle = np.asarray(kq_decode_attention_ref(jq, jk, jv,
                                                jnp.asarray(lens)))
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got, kern, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(oracle[0], arrays[2][0].mean(axis=1)
                               .repeat(2, axis=0), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[1], oracle[1], rtol=2e-5, atol=2e-5)


def test_dead_rows_do_not_leak_nan():
    """Cache rows at or past the length may hold anything (NaN too)."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(3, 1, 2, 1, 12, 4, 4))
    lens = torch.tensor([5], dtype=torch.int32)
    clean = kq_decode_attention(q, k, v, lens)
    k[:, :, 5:] = float("nan")
    v[:, :, 5:] = float("nan")
    dirty = kq_decode_attention(q, k, v, lens)
    np.testing.assert_array_equal(dirty.numpy(), clean.numpy())


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    """On a CPU tensor the wrapper runs the plain version: nothing is
    built or launched."""
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return torch_ref(*a, **kw)

    def no_build(name):
        raise AssertionError(f"built {name} for a CPU call")

    monkeypatch.setattr(k3_mod, "kq_decode_attention_ref", spy)
    monkeypatch.setattr(build, "load", no_build)
    before = kq_decode_attention.launches
    q, k, v = (torch.as_tensor(a) for a in _inputs(4, 2, 4, 2, 16, 8, 8))
    kq_decode_attention(q, k, v, torch.tensor([3, 16], dtype=torch.int32))
    assert calls == [1]
    assert kq_decode_attention.launches == before


def test_module_imports_without_nvcc(tmp_path):
    """Importing the kernel module and running it on CPU tensors needs
    no compiler: the build is lazy (here with an empty PATH)."""
    code = (
        "import torch\n"
        "from repro_torch.kernels import build\n"
        "from repro_torch.kernels.kq_decode import kq_decode_attention\n"
        "q = torch.randn(1, 2, 4); k = torch.randn(1, 1, 8, 4)\n"
        "out = kq_decode_attention(q, k, k, torch.tensor([8], "
        "dtype=torch.int32))\n"
        "assert out.shape == (1, 2, 4) and not build._loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path),
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"

