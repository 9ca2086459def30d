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

On fake tensors (a dry run) ``flash_attention`` returns an output of
the kernel's shape and type and computes nothing; under an active op
count each call books ``flash_work`` (``kernels.booking``).

``flash_attention_train`` runs it under autograd (``FlashAttention``);
its backward, ``flash_attention_backward``, is plain PyTorch with a
counter of its own, as the reference has no backward kernel: it is not
the plain version of the forward, which never runs on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import booking, build
from repro_torch.kernels.flash.ref import (NEG_INF, attention_mask,
                                           flash_attention_ref)

# (dh, dv) the kernel is built for: the reduced configs, the reference's
# sweep, tinyllama, danube, phi-3-vision, llama2-7b, then reduced and
# full MLA (deepseek-v2-lite)
HEAD_DIMS = ((8, 8), (16, 16), (32, 32), (64, 64), (80, 80), (96, 96),
             (128, 128), (24, 16), (192, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def band_pairs(S: int, window: int = 0, causal: bool = True) -> int:
    """The (query, key) pairs K6 attends over a sequence of ``S``:
    causal ``t <= s``, and ``s - t < window`` with a window."""
    if not causal:
        if not window or window >= S:
            return S * S
        return S * S - (S - window) * (S - window + 1) // 2
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_work(B: int, H: int, Hkv: int, S: int, dh: int, dv: int,
               itemsize: int, window: int = 0, causal: bool = True):
    """(flops, bytes) of one K6 call: 2 (dh + dv) flops a (query, key)
    pair of the band (``band_pairs``) a query head, against q, k, v and
    the output (``itemsize`` bytes an element) moved once."""
    return (2 * (dh + dv) * band_pairs(S, window, causal) * B * H,
            B * S * (H + Hkv) * (dh + dv) * itemsize)


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
    if booking.active():
        B, H, S, dh = q.shape
        booking.book("flash_attention", *flash_work(
            B, H, k.shape[1], S, dh, v.shape[-1], q.element_size(),
            int(window or 0), causal))
    if booking.is_fake(q):
        return q.new_empty((*q.shape[:3], v.shape[-1]))
    if q.device.type == "cpu":
        with booking.unseen():
            return flash_attention_ref(q, k, v, causal=causal,
                                       window=window, scale=scale)
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
        raise build.KernelError(f"flash kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             scale: Optional[float] = None,
                             block_q: int = 128):
    """Gradients of ``flash_attention`` in plain PyTorch: (dq, dk, dv) in
    the inputs' types, for the output gradient ``dout``.

    The reference has no backward kernel: its gradient is XLA's autodiff
    of the lax ``blockwise_attention``.  This is that gradient, written
    out.  Per block of ``block_q`` queries it recomputes the scores over
    the keys the block can see, their row LSE, P = exp(S - LSE) under the
    same causal / window mask and the block's output O = P V, then dP =
    dO V^T, dS = P * (dP - rowsum(dO * O)), dQ = dS K * scale, dK += dS^T
    Q * scale and dV += P^T dO (the group's m query heads summed into
    their kv head), all in float32.  The forward's output is not read:
    O is recomputed in float32, so a bfloat16 output's rounding does not
    reach the gradient.  Memory is bounded by a block's (m, block_q,
    keys) scores, not by S^2.  Each call adds one to
    ``flash_attention_backward.launches``."""
    with torch.profiler.record_function("flash_attention_backward"):
        B, H, S, dh = q.shape
        Hkv, Sk = k.shape[1], k.shape[2]
        m = H // Hkv
        scale = scale or 1.0 / math.sqrt(dh)
        qg = q.reshape(B, Hkv, m, S, dh).float()
        dog = dout.reshape(B, Hkv, m, S, -1).float()
        kf, vf = k.float(), v.float()
        dq = torch.empty_like(qg)
        dk = torch.zeros_like(kf)
        dv = torch.zeros_like(vf)
        for i0 in range(0, S, block_q):
            i1 = min(S, i0 + block_q)
            lo = max(0, i0 - window + 1) if window else 0
            hi = min(Sk, i1) if causal else Sk
            mask = attention_mask(torch.arange(i0, i1, device=q.device),
                                  torch.arange(lo, hi, device=q.device),
                                  causal=causal, window=window)
            qi, doi = qg[:, :, :, i0:i1], dog[:, :, :, i0:i1]
            kj, vj = kf[:, :, lo:hi], vf[:, :, lo:hi]
            s = torch.einsum("bgmqd,bgtd->bgmqt", qi, kj) * scale
            s = s.masked_fill(~mask, NEG_INF)
            p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
            o = torch.einsum("bgmqt,bgte->bgmqe", p, vj)
            dp = torch.einsum("bgmqe,bgte->bgmqt", doi, vj)
            ds = p * (dp - (doi * o).sum(dim=-1, keepdim=True))
            dq[:, :, :, i0:i1] = torch.einsum("bgmqt,bgtd->bgmqd", ds,
                                              kj) * scale
            dk[:, :, lo:hi] += torch.einsum("bgmqt,bgmqd->bgtd", ds,
                                            qi) * scale
            dv[:, :, lo:hi] += torch.einsum("bgmqt,bgmqe->bgte", p, doi)
    flash_attention_backward.launches += 1
    return (dq.reshape(B, H, S, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


flash_attention_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """K6 under autograd: the forward is ``flash_attention`` (the kernel on
    a CUDA tensor, the plain version on a CPU one), the backward
    ``flash_attention_backward``.  Saves q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        """The output of ``flash_attention``."""
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)

    @staticmethod
    def backward(ctx, dout):
        """dq, dk, dv from ``flash_attention_backward``."""
        dq, dk, dv = flash_attention_backward(*ctx.saved_tensors, dout,
                                              **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention`` with gradients (``FlashAttention``): the
    training forward of ``attn_train``."""
    return FlashAttention.apply(q, k, v, causal, int(window or 0), scale)
