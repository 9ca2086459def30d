"""K3 on Hopper: decode attention over the KQ-SVD-compressed dense cache.

Replaces the reference's Pallas TPU kernel ``_kq_decode_kernel``
(``src/repro/kernels/kq_decode/kq_decode.py:53``).  The kernel itself is
CUDA C++ for ``sm_90a`` in ``repro_torch/kernels/csrc/kq_decode.cu``:
bfloat16 runs the tensor-core decode body ``csrc/kq_decode_tc.cuh``
(shared with K1, K4 and K5), float32 the CUDA-core body
``csrc/kq_attend.cuh`` (each header says what bounds it and how the
design answers that).  It is compiled with ``nvcc`` at first use and
called through a plain C entry point with ``ctypes`` on PyTorch's
current stream.

``kq_decode_attention_span`` runs K3 over one span of a sequence-cut
cache (a rank's share of a sequence-parallel decode on a device mesh)
and returns the float32 rows with their log-sum-exp, the form of K4's
split partials, which ``combine_split_partials`` merges across spans
(the same kernel bodies, through a second entry point of
``csrc/kq_decode.cu``).

Each wrapper takes its plain version (``kq_decode_attention_ref``,
``kq_decode_attention_span_ref``) only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises: there is no fallback.  Every
launch adds one to ``kq_decode_attention.launches``, or to
``kq_decode_attention_span.launches`` for the span entry point.  On fake
tensors (a dry run) each returns outputs of the kernel's shapes and
types and computes nothing; under an active op count each call books
``kq_decode_work`` / ``kq_decode_span_work`` (``kernels.booking``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import booking, build
from repro_torch.kernels.kq_decode.ref import (kq_decode_attention_ref,
                                              kq_decode_attention_span_ref)

MAX_RANK = 256        # largest Rk / Rv the kernel takes
MAX_GROUP = 16        # largest GQA group m = H / Hkv the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = build.load("kq_decode")
    for name, n_ptr in (("kq_decode_launch", 5), ("kq_decode_span_launch",
                                                  6)):
        fn = getattr(lib, name)
        if not fn.argtypes:
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def kq_decode_work(B: int, H: int, Hkv: int, Rk: int, Rv: int,
                   itemsize: int, live: int):
    """(flops, bytes) of one K3 call over ``live`` cache entries in all:
    2 (Rk + Rv) flops an entry a query head, against the live keys and
    values, the queries and outputs (``itemsize`` bytes an element) and
    the (B,) int32 lengths moved once."""
    return (2 * live * H * (Rk + Rv),
            live * Hkv * (Rk + Rv) * itemsize + B * H * (Rk + Rv) * itemsize
            + B * 4)


def kq_decode_span_work(B: int, H: int, Hkv: int, Rk: int, Rv: int,
                        itemsize: int, live: int):
    """(flops, bytes) of one K3 span call: ``kq_decode_work`` with float32
    rows and their LSE written in place of the outputs."""
    return (2 * live * H * (Rk + Rv),
            live * Hkv * (Rk + Rv) * itemsize + B * H * Rk * itemsize
            + B * H * (Rv + 1) * 4 + B * 4)


def _book(fn, work, qc, kc, vc, lengths) -> None:
    """Book one call of wrapper ``fn`` by ``work`` with the active
    counts."""
    if booking.active():
        B, H, Rk = qc.shape
        Hkv, T = kc.shape[1:3]
        booking.book(fn.__name__, *work(
            B, H, Hkv, Rk, vc.shape[-1], qc.element_size(),
            booking.live_count(lengths, T)))


def _check(qc, kc, vc, lengths) -> None:
    """Raise on what K3 does not take: shapes, types, devices, layout."""
    B, H, Rk = qc.shape
    Bk, Hkv, T, Rk2 = kc.shape
    Rv = vc.shape[-1]
    if (Bk, Rk2) != (B, Rk) or vc.shape[:3] != (B, Hkv, T):
        raise ValueError(f"kq_decode_attention: shapes qc {tuple(qc.shape)}"
                         f" kc {tuple(kc.shape)} vc {tuple(vc.shape)}")
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"kq_decode_attention: group H/Hkv = {H}/{Hkv} "
                         f"must be a whole number <= {MAX_GROUP}")
    if not (0 < Rk <= MAX_RANK and 0 < Rv <= MAX_RANK):
        raise ValueError(f"kq_decode_attention: ranks Rk={Rk}, Rv={Rv} "
                         f"outside 1..{MAX_RANK}")
    if qc.dtype not in _DTYPES or kc.dtype != qc.dtype \
            or vc.dtype != qc.dtype:
        raise TypeError(f"kq_decode_attention: dtypes {qc.dtype}, "
                        f"{kc.dtype}, {vc.dtype}; want one of float32 / "
                        f"bfloat16 for all three")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise TypeError("kq_decode_attention: lengths must be (B,) int32")
    for t in (qc, kc, vc, lengths):
        if t.device != qc.device:
            raise ValueError("kq_decode_attention: tensors on different "
                             "devices")
        if not t.is_contiguous():
            raise ValueError("kq_decode_attention: tensors must be "
                             "contiguous")


def kq_decode_attention(qc: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                        lengths: torch.Tensor, *,
                        scale: float = 1.0) -> torch.Tensor:
    """qc: (B,H,Rk); kc: (B,Hkv,T,Rk); vc: (B,Hkv,T,Rv) -> (B,H,Rv).

    ``lengths``: (B,) int32 count of live cache entries per sequence
    (positions ``0..lengths[b]-1`` attend; 0 gives a zero row).  Inputs
    float32 or bfloat16, all of one type; f32 accumulation; the output is
    in the query's type."""
    _book(kq_decode_attention, kq_decode_work, qc, kc, vc, lengths)
    if booking.is_fake(qc):
        return qc.new_empty((qc.shape[0], qc.shape[1], vc.shape[-1]))
    if qc.device.type == "cpu":
        with booking.unseen():
            return kq_decode_attention_ref(qc, kc, vc, lengths, scale=scale)
    if qc.device.type != "cuda":
        raise ValueError(f"kq_decode_attention: unsupported device "
                         f"{qc.device}")
    _check(qc, kc, vc, lengths)
    B, H, _ = qc.shape
    Hkv, T, Rk = kc.shape[1:]
    Rv = vc.shape[-1]
    out = torch.empty((B, H, Rv), dtype=qc.dtype, device=qc.device)
    stream = torch.cuda.current_stream(qc.device).cuda_stream
    err = _library().kq_decode_launch(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, Hkv, T, Rk, Rv, float(scale),
        _DTYPES[qc.dtype], stream)
    if err != 0:
        raise build.KernelError(
            f"kq_decode kernel launch failed: cudaError {err}")
    kq_decode_attention.launches += 1
    return out


kq_decode_attention.launches = 0


def kq_decode_attention_span(qc: torch.Tensor, kc: torch.Tensor,
                             vc: torch.Tensor, lengths: torch.Tensor, *,
                             scale: float = 1.0):
    """K3 over one span of a cache: ``(out (B,H,Rv), lse (B,H))``, both
    float32, the span's softmax rows and their log-sum-exp.

    Shapes and types as ``kq_decode_attention``; ``lengths[b]`` counts the
    span's live entries (a rank holding positions ``[t0, t0 + T)`` passes
    ``clamp(pos + 1 - t0, 0, T)``).  A span with no live entry gives a
    zero row and an LSE of ``-1e30 + log(1e-30)``."""
    _book(kq_decode_attention_span, kq_decode_span_work, qc, kc, vc, lengths)
    if booking.is_fake(qc):
        B, H = qc.shape[:2]
        return (qc.new_empty((B, H, vc.shape[-1]), dtype=torch.float32),
                qc.new_empty((B, H), dtype=torch.float32))
    if qc.device.type == "cpu":
        with booking.unseen():
            return kq_decode_attention_span_ref(qc, kc, vc, lengths,
                                                scale=scale)
    if qc.device.type != "cuda":
        raise ValueError(f"kq_decode_attention_span: unsupported device "
                         f"{qc.device}")
    _check(qc, kc, vc, lengths)
    B, H, _ = qc.shape
    Hkv, T, Rk = kc.shape[1:]
    Rv = vc.shape[-1]
    out = torch.empty((B, H, Rv), dtype=torch.float32, device=qc.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=qc.device)
    stream = torch.cuda.current_stream(qc.device).cuda_stream
    err = _library().kq_decode_span_launch(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, Hkv, T, Rk, Rv, float(scale),
        _DTYPES[qc.dtype], stream)
    if err != 0:
        raise build.KernelError(
            f"kq_decode span kernel launch failed: cudaError {err}")
    kq_decode_attention_span.launches += 1
    return out, lse


kq_decode_attention_span.launches = 0
