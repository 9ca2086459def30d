"""K1 and K2 on Hopper: attention over the KQ-SVD-compressed paged cache.

``kq_decode_paged_attention`` (K1) replaces the reference's Pallas TPU
kernel ``_kq_decode_paged_kernel`` (``src/repro/kernels/kq_decode/
paged.py:63``, entry point ``kq_decode_paged_attention`` at ``:436``, the
unsplit kernel without scales); ``kq_prefill_paged_attention`` (K2)
replaces ``_kq_prefill_paged_kernel`` (``paged.py:292``, entry point at
``:342``).  Both kernels are CUDA C++ for ``sm_90a`` in
``repro_torch/kernels/csrc/kq_paged.cu`` over the kernel body they share
with K3 (``csrc/kq_attend.cuh``, whose header says what bounds them and
how the design answers that), compiled with ``nvcc`` at first use and
called through plain C entry points with ``ctypes`` on PyTorch's current
stream.  Split-KV (``num_splits``) and int8 pages (scales) are K4 and K5,
not ported yet.

Each wrapper takes its plain version (``ref.py``) only for tensors on the
CPU.  For CUDA tensors it launches the kernel or raises: there is no
fallback.  Every launch adds one to the wrapper's ``launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kq_decode.kq_decode import (_DTYPES, MAX_GROUP,
                                                     MAX_RANK)
from repro_torch.kernels.kq_decode.ref import (kq_decode_paged_attention_ref,
                                               kq_prefill_paged_attention_ref)


def _library() -> ctypes.CDLL:
    lib = build.load("kq_paged")
    for fn, n_ptr, n_int in ((lib.kq_decode_paged_launch, 6, 7),
                             (lib.kq_prefill_paged_launch, 7, 8)):
        if not fn.argtypes:
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def _check(name: str, qc: torch.Tensor, kc_pool: torch.Tensor,
           vc_pool: torch.Tensor, block_table: torch.Tensor,
           per_row: tuple) -> None:
    """Raise on what the kernel does not take: shapes, types, devices,
    layout.  ``per_row``: the (B,) int32 tensors (lengths, pos0)."""
    B, H, Rk = qc.shape[0], qc.shape[1], qc.shape[-1]
    P, Hkv, ps, Rk2 = kc_pool.shape
    Rv = vc_pool.shape[-1]
    if Rk2 != Rk or vc_pool.shape[:3] != (P, Hkv, ps) \
            or block_table.ndim != 2 or block_table.shape[0] != B:
        raise ValueError(f"{name}: shapes qc {tuple(qc.shape)} kc_pool "
                         f"{tuple(kc_pool.shape)} vc_pool "
                         f"{tuple(vc_pool.shape)} block_table "
                         f"{tuple(block_table.shape)}")
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"{name}: group H/Hkv = {H}/{Hkv} must be a whole "
                         f"number <= {MAX_GROUP}")
    if not (0 < Rk <= MAX_RANK and 0 < Rv <= MAX_RANK):
        raise ValueError(f"{name}: ranks Rk={Rk}, Rv={Rv} outside "
                         f"1..{MAX_RANK}")
    if qc.dtype not in _DTYPES or kc_pool.dtype != qc.dtype \
            or vc_pool.dtype != qc.dtype:
        raise TypeError(f"{name}: dtypes {qc.dtype}, {kc_pool.dtype}, "
                        f"{vc_pool.dtype}; want one of float32 / bfloat16 "
                        f"for all three")
    if block_table.dtype != torch.int32 or any(
            t.dtype != torch.int32 or tuple(t.shape) != (B,)
            for t in per_row):
        raise TypeError(f"{name}: block_table and lengths / pos0 must be "
                        f"int32, the latter of shape (B,)")
    for t in (qc, kc_pool, vc_pool, block_table, *per_row):
        if t.device != qc.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _cuda_only(name: str, qc: torch.Tensor) -> None:
    if qc.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qc.device}")


def kq_decode_paged_attention(qc: torch.Tensor, kc_pool: torch.Tensor,
                              vc_pool: torch.Tensor, lengths: torch.Tensor,
                              block_table: torch.Tensor, *,
                              scale: float = 1.0) -> torch.Tensor:
    """K1.  qc: (B,H,Rk); kc_pool: (P,Hkv,ps,Rk); vc_pool: (P,Hkv,ps,Rv);
    lengths: (B,) int32 live entries per slot; block_table: (B, n_pages)
    int32 physical page of each logical page -> (B,H,Rv).

    Position t of slot b attends iff t < lengths[b] (0 gives a zero row);
    lengths past ``n_pages * ps`` are clamped to it.  Inputs float32 or
    bfloat16, all of one type; f32 accumulation; output in qc's type."""
    if qc.device.type == "cpu":
        return kq_decode_paged_attention_ref(qc, kc_pool, vc_pool, lengths,
                                             block_table, scale=scale)
    name = "kq_decode_paged_attention"
    _cuda_only(name, qc)
    if qc.ndim != 3:
        raise ValueError(f"{name}: qc must be (B, H, Rk), got "
                         f"{tuple(qc.shape)}")
    _check(name, qc, kc_pool, vc_pool, block_table, (lengths,))
    B, H, _ = qc.shape
    _, Hkv, ps, Rk = kc_pool.shape
    Rv = vc_pool.shape[-1]
    out = torch.empty((B, H, Rv), dtype=qc.dtype, device=qc.device)
    stream = torch.cuda.current_stream(qc.device).cuda_stream
    _launched(name, _library().kq_decode_paged_launch(
        qc.data_ptr(), kc_pool.data_ptr(), vc_pool.data_ptr(),
        lengths.data_ptr(), block_table.data_ptr(), out.data_ptr(), B, H,
        Hkv, ps, block_table.shape[1], Rk, Rv, float(scale),
        _DTYPES[qc.dtype], stream))
    kq_decode_paged_attention.launches += 1
    return out


def kq_prefill_paged_attention(qc: torch.Tensor, kc_pool: torch.Tensor,
                               vc_pool: torch.Tensor, lengths: torch.Tensor,
                               pos0: torch.Tensor, block_table: torch.Tensor,
                               *, scale: float = 1.0) -> torch.Tensor:
    """K2.  qc: (B,H,S,Rk) chunk queries, query s of slot b at position
    ``pos0[b] + s``; pools and block_table as K1; lengths: (B,) int32
    live entries (pos0 + the chunk's real tokens, already written) ->
    (B,H,S,Rv).

    Query s attends positions t <= pos0[b] + s with t < lengths[b]; a
    bucket-padding query (pos0[b] + s >= lengths[b]) sees the whole
    prefix, a garbage row the caller drops."""
    if qc.device.type == "cpu":
        return kq_prefill_paged_attention_ref(qc, kc_pool, vc_pool, lengths,
                                              pos0, block_table, scale=scale)
    name = "kq_prefill_paged_attention"
    _cuda_only(name, qc)
    if qc.ndim != 4:
        raise ValueError(f"{name}: qc must be (B, H, S, Rk), got "
                         f"{tuple(qc.shape)}")
    _check(name, qc, kc_pool, vc_pool, block_table, (lengths, pos0))
    B, H, S, _ = qc.shape
    _, Hkv, ps, Rk = kc_pool.shape
    Rv = vc_pool.shape[-1]
    out = torch.empty((B, H, S, Rv), dtype=qc.dtype, device=qc.device)
    stream = torch.cuda.current_stream(qc.device).cuda_stream
    _launched(name, _library().kq_prefill_paged_launch(
        qc.data_ptr(), kc_pool.data_ptr(), vc_pool.data_ptr(),
        lengths.data_ptr(), pos0.data_ptr(), block_table.data_ptr(),
        out.data_ptr(), B, H, Hkv, S, ps, block_table.shape[1], Rk, Rv,
        float(scale), _DTYPES[qc.dtype], stream))
    kq_prefill_paged_attention.launches += 1
    return out


kq_decode_paged_attention.launches = 0
kq_prefill_paged_attention.launches = 0
