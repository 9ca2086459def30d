"""K6's plain version, the route of the port's ``flash_attention`` on CPU
tensors, against the reference: its Pallas flash kernel in interpret mode
on the sweep of tests/test_kernels.py (float32 at 2e-5, bfloat16 at
2e-2), and its lax ``blockwise_attention``, packed and masked, on the
window cases of tests/test_attention.py plus d_head 80, a sequence that
is no multiple of any tile and windows at and past the sequence.  Inputs
come from numpy with fixed seeds; the kernel itself is held to this
plain version on the card (tests/test_torch_cuda.py)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import flash_attention_op
from repro.models.attention import blockwise_attention
from repro_torch.kernels.flash import flash as flash_mod
from repro_torch.kernels.flash import flash_attention, flash_attention_ref
from repro_torch.models import attention as attn_mod

TOL = {"float32": 2e-5, "bfloat16": 2e-2}       # tests/test_kernels.py


def _inputs(seed, B, H, Hkv, S, dh):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, h, S, dh)).astype(np.float32)
            for h in (H, Hkv, Hkv)]


def _torch(arrays, dtype):
    return [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,dh,b,window", [
    (1, 2, 2, 64, 16, 16, 0),
    (2, 4, 2, 128, 32, 32, 0),
    (1, 4, 1, 64, 8, 16, 0),
    (1, 2, 2, 64, 16, 16, 24),
    (2, 2, 2, 64, 16, 32, 0),
])
def test_matches_reference_flash_kernel(B, H, Hkv, S, dh, b, window, dtype):
    """The shapes of test_kernels.py::test_flash_kernel_sweep; the
    reference kernel runs in interpret mode with its test's tiles."""
    arrays = _inputs(0, B, H, Hkv, S, dh)
    before = flash_attention.launches
    out = flash_attention(*_torch(arrays, dtype), window=window)
    assert flash_attention.launches == before        # CPU: no kernel
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, H, S, dh)
    ref = flash_attention_op(*_jax(arrays, dtype), causal=True,
                             window=window, block_q=b, block_k=b,
                             interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dh,dv", [(8, 8), (32, 32), (96, 96), (24, 16),
                                   (192, 128)])
def test_matches_reference_flash_kernel_at_every_width(dh, dv, window,
                                                       dtype):
    """The head widths the kernel takes beyond the sweep's: dh 8 and 24
    (no multiple of 16), phi-3-vision's 96, reduced MLA (24, 16) and
    deepseek-v2-lite's MLA (192, 128), S 64, m 2; the reference kernel in
    interpret mode with 16 x 16 tiles."""
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=(1, h, 64, d)).astype(np.float32)
              for h, d in ((4, dh), (2, dh), (2, dv))]
    out = flash_attention(*_torch(arrays, dtype), window=window)
    assert out.dtype == getattr(torch, dtype) and out.shape == (1, 4, 64, dv)
    ref = flash_attention_op(*_jax(arrays, dtype), causal=True,
                             window=window, block_q=16, block_k=16,
                             interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def test_wrapper_table_matches_the_cuda_instantiations():
    """``HEAD_DIMS`` in the wrapper and ``FLASH_PAIRS`` in the CUDA source
    name the same (dh, dv) pairs, read as text."""
    src = (Path(flash_mod.__file__).resolve().parents[1] / "csrc"
           / "flash.cu").read_text()
    body = re.search(r"#define FLASH_PAIRS\(X\)((?:[^\n]*\\\n)*[^\n]*)",
                     src).group(1)
    pairs = [(int(a), int(b)) for a, b in
             re.findall(r"X\((\d+), (\d+)\)", body)]
    assert len(pairs) == len(set(pairs))
    assert set(pairs) == set(flash_mod.HEAD_DIMS)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("B,H,Hkv,S,dh,b,window", [
    (2, 4, 4, 64, 16, 16, 0),
    (1, 8, 2, 128, 32, 32, 0),
    (2, 4, 2, 64, 16, 16, 24),      # sliding window
    (1, 2, 1, 96, 8, 32, 0),        # S not a multiple of the default tile
    (1, 8, 2, 64, 80, 16, 16),      # danube's d_head 80, window of a tile
    (2, 4, 2, 77, 16, 16, 9),       # S no multiple of any tile
    (1, 4, 2, 48, 16, 16, 48),      # window = S
    (1, 4, 2, 48, 16, 16, 100),     # window past S
])
def test_matches_blockwise_attention(B, H, Hkv, S, dh, b, window, packed):
    """test_attention.py::test_blockwise_matches_reference's cases and
    more, float32 at 2e-5: the lax flash schedule the reference runs
    under prefill and calibration."""
    arrays = _inputs(1, B, H, Hkv, S, dh)
    out = flash_attention(*_torch(arrays, "float32"), window=window)
    ref = blockwise_attention(*_jax(arrays, "float32"), causal=True,
                              window=window, block_q=b, block_k=b,
                              packed=packed)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_window_of_one_is_the_value_itself():
    q, k, v = _torch(_inputs(2, 1, 4, 2, 19, 16), "float32")
    out = flash_attention_ref(q, k, v, window=1)
    np.testing.assert_allclose(out.numpy(),
                               v.repeat_interleave(2, dim=1).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_not_causal_with_window_matches_reference_attention():
    from repro.models.attention import reference_attention
    arrays = _inputs(3, 1, 4, 2, 33, 16)
    out = flash_attention(*_torch(arrays, "float32"), causal=False,
                          window=7, scale=0.3)
    ref = reference_attention(*_jax(arrays, "float32"), causal=False,
                              window=7, scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_wrapper_raises_off_cpu_and_cuda():
    q, k, v = (t.to("meta") for t in _torch(_inputs(4, 1, 2, 2, 8, 16),
                                            "float32"))
    with pytest.raises(ValueError, match="device"):
        flash_attention(q, k, v)


def test_model_attention_has_no_second_plain_copy():
    """The model's prefill and calibration reach K6 through
    ``flash_attention``; the plain causal attention lives once, in
    ``kernels.flash.ref``."""
    assert attn_mod.flash_attention is flash_attention
    assert not hasattr(attn_mod, "causal_attention")
