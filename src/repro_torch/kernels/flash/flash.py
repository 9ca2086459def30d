"""K6 on Hopper: causal GQA flash attention with an optional sliding
window.

Replaces the reference's Pallas TPU kernel ``_flash_kernel``
(``src/repro/kernels/flash/flash.py:29``, entry point ``flash_attention``
at ``:79``).  The kernel is CUDA C++ for ``sm_90a`` in
``repro_torch/kernels/csrc/flash.cu`` (its header says what bounds it and
how the design answers that), compiled with ``nvcc`` at first use and
called through a plain C entry point with ``ctypes`` on PyTorch's current
stream.

``flash_attention`` takes the plain version (``flash_attention_ref``)
only for tensors on the CPU.  For CUDA tensors it launches the kernel or
raises: there is no fallback.  The kernel reads q, k and v through their
strides (the last dim contiguous; in bfloat16 16-byte aligned rows, which
its 16-byte copies need), so the caller's transposed views need no copy.
It is built for the (q/k, v) head widths of ``HEAD_DIMS``, which match
the source's ``FLASH_PAIRS``.  Every launch adds one to
``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash.ref import flash_attention_ref

# (dh, dv) the kernel is built for: the reduced configs, the reference's
# sweep, tinyllama, danube, phi-3-vision, llama2-7b, then reduced and
# full MLA (deepseek-v2-lite)
HEAD_DIMS = ((8, 8), (16, 16), (32, 32), (64, 64), (80, 80), (96, 96),
             (128, 128), (24, 16), (192, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = build.load("flash")
    fn = lib.flash_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9
                       + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,S,dh); k: (B,Hkv,S,dh); v: (B,Hkv,S,dv) -> (B,H,S,dv) in
    q's type.

    Query s of head h attends key t of kv head ``h // (H // Hkv)`` when
    ``t <= s`` (``causal``) and ``s - t < window`` (``window`` > 0).
    Inputs float32 or bfloat16, all of one type; f32 softmax statistics
    and accumulation; the output is contiguous."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be 4-d")
    B, H, S, dh = q.shape
    Hkv, dv = k.shape[1], v.shape[-1]
    if tuple(k.shape) != (B, Hkv, S, dh) or tuple(v.shape) != (B, Hkv, S,
                                                                dv):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}; the kernel "
                         f"takes k (B, Hkv, S, dh) and v (B, Hkv, S, dv)")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"Hkv={Hkv}")
    if (dh, dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (dh, dv) = "
                         f"{(dh, dv)}; the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; want one of float32 / bfloat16 for "
                        f"all three")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError("flash_attention: tensors on different "
                             "devices")
        if t.stride(-1) != 1:
            raise ValueError("flash_attention: the last dim must be "
                             "contiguous")
        if q.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(
                st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
                if n > 1)):
            raise ValueError("flash_attention: bfloat16 rows must start "
                             "16-byte aligned (base and strides)")
    scale = scale or 1.0 / math.sqrt(dh)
    out = torch.empty((B, H, S, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], B, H, Hkv, S,
        dh, dv, int(window or 0), int(bool(causal)), float(scale),
        _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
