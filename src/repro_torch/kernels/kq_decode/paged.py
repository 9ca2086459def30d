"""K1, K2, K4 and K5 on Hopper: attention over the KQ-SVD-compressed
paged cache.

``kq_decode_paged_attention`` is the paged decode of the reference's
``kq_decode_paged_attention`` (``src/repro/kernels/kq_decode/paged.py:
436``) and launches one of three kernels:

* K1, ``_kq_decode_paged_kernel`` (``paged.py:63``), unsplit over fp
  pages;
* K4, ``_kq_decode_paged_split_kernel`` (``paged.py:120``), split-KV
  over fp pages, with the merge the reference does in jnp
  (``combine_split_partials``, ``paged.py:196``): in bfloat16 inside the
  same launch, in float32 by ``kq_combine_splits``;
* K5, either kernel over int8 pages with per-token bf16 scales
  (``kscale``/``vscale``, the reference's ``quant=True``).

``kq_prefill_paged_attention`` (K2) replaces ``_kq_prefill_paged_kernel``
(``paged.py:292``, entry point at ``:342``).  The kernels are CUDA C++
for ``sm_90a`` in ``repro_torch/kernels/csrc/kq_paged.cu``, compiled with
``nvcc`` at first use and called through plain C entry points with
``ctypes`` on PyTorch's current stream.  In bfloat16, K1, K4 and K5 run
the tensor-core decode body they share with K3 (``csrc/kq_decode_tc.cuh``:
a thread-block cluster per (slot, kv group) or split span, ``cp.async``
staging straight from the pages, ``mma.sync`` products, a merge through
distributed shared memory, and the split spans merged by the last CTA of
each (slot, kv group) to finish: one launch); bfloat16 K2, bound by
operations, has a body of its own (``csrc/kq_prefill.cuh``: ``wgmma``,
64-row tiles of the flattened (position, head) rows, a ``cp.async`` ring
staged through the block table).  float32 (the reduced parity runs)
runs every one of them on the CUDA-core body ``csrc/kq_attend.cuh``.
Each header says what bounds its kernels and how the design answers
that.  Every body takes every group up to ``MAX_GROUP`` (int8 pages:
``MAX_GROUP_INT8``) and every rank up to ``MAX_RANK``.

Each wrapper takes its plain version (``ref.py``, and
``combine_split_partials`` here) only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises: there is no fallback.  Each
wrapper counts its kernel's launches in its ``launches`` attribute: K1
``kq_decode_paged_attention``, K4 ``kq_decode_paged_split``, K5
``kq_decode_paged_int8`` and ``kq_decode_paged_int8_split``, the merge
``kq_combine_splits``, K2 ``kq_prefill_paged_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kq_decode.kq_decode import (_DTYPES, MAX_GROUP,
                                                     MAX_RANK)
from repro_torch.kernels.kq_decode.ref import (
    kq_decode_paged_attention_int8_ref, kq_decode_paged_attention_ref,
    kq_decode_paged_partials_ref, kq_prefill_paged_attention_ref,
    resolve_splits)

MAX_GROUP_INT8 = 8    # int8 pages are instantiated for groups m <= 8


_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of the C entry points of csrc/kq_paged.cu
_SIGNATURES = {
    "kq_decode_paged_launch": [_P] * 11 + [_I] * 9 + [ctypes.c_float, _I,
                                                     _P],
    "kq_prefill_paged_launch": [_P] * 7 + [_I] * 8 + [ctypes.c_float, _I,
                                                      _P],
    "kq_combine_splits_launch": [_P] * 3 + [_I] * 6 + [_P],
}


def _library() -> ctypes.CDLL:
    lib = build.load("kq_paged")
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        if not fn.argtypes:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def combine_split_partials(o_parts: torch.Tensor,
                           lse: torch.Tensor) -> torch.Tensor:
    """Merge per-split partial (out, LSE) pairs, the flash-decoding
    combine (plain version of ``kq_combine_splits``).

    o_parts: (..., S, m, Rv) split-local softmax aggregates; lse:
    (..., S, m) split-local log-sum-exp.  With ``lse* = max_s lse_s`` and
    ``w_s = exp(lse_s - lse*)`` the softmax over all splits is
    ``sum_s w_s out_s / sum_s w_s``: every exponent is <= 0, so the merge
    never overflows.  Returns (..., m, Rv) in float32."""
    w = torch.exp(lse - lse.amax(dim=-2, keepdim=True))      # (..., S, m)
    num = (w[..., None] * o_parts).sum(dim=-3)
    return num / w.sum(dim=-2).clamp_min(1e-30)[..., None]


def _check(name: str, qc: torch.Tensor, kc_pool: torch.Tensor,
           vc_pool: torch.Tensor, block_table: torch.Tensor,
           per_row: tuple, scales: tuple = ()) -> None:
    """Raise on what the kernel does not take: shapes, types, devices,
    layout.  ``per_row``: the (B,) int32 tensors (lengths, pos0);
    ``scales``: the (P,Hkv,ps,1) bf16 scale pools of int8 pools."""
    B, H, Rk = qc.shape[0], qc.shape[1], qc.shape[-1]
    P, Hkv, ps, Rk2 = kc_pool.shape
    Rv = vc_pool.shape[-1]
    if Rk2 != Rk or vc_pool.shape[:3] != (P, Hkv, ps) \
            or block_table.ndim != 2 or block_table.shape[0] != B \
            or any(tuple(t.shape) != (P, Hkv, ps, 1) for t in scales):
        raise ValueError(f"{name}: shapes qc {tuple(qc.shape)} kc_pool "
                         f"{tuple(kc_pool.shape)} vc_pool "
                         f"{tuple(vc_pool.shape)} block_table "
                         f"{tuple(block_table.shape)} scales "
                         f"{[tuple(t.shape) for t in scales]}")
    max_group = MAX_GROUP_INT8 if scales else MAX_GROUP
    if H % Hkv or H // Hkv > max_group:
        raise ValueError(f"{name}: group H/Hkv = {H}/{Hkv} must be a whole "
                         f"number <= {max_group}")
    if not (0 < Rk <= MAX_RANK and 0 < Rv <= MAX_RANK):
        raise ValueError(f"{name}: ranks Rk={Rk}, Rv={Rv} outside "
                         f"1..{MAX_RANK}")
    pool_dtype = torch.int8 if scales else qc.dtype
    if qc.dtype not in _DTYPES or kc_pool.dtype != pool_dtype \
            or vc_pool.dtype != pool_dtype \
            or any(t.dtype != torch.bfloat16 for t in scales):
        raise TypeError(f"{name}: dtypes qc {qc.dtype}, pools "
                        f"{kc_pool.dtype}, {vc_pool.dtype}, scales "
                        f"{[t.dtype for t in scales]}; want qc float32 or "
                        f"bfloat16, pools of its type (or int8 with "
                        f"bfloat16 scales)")
    if block_table.dtype != torch.int32 or any(
            t.dtype != torch.int32 or tuple(t.shape) != (B,)
            for t in per_row):
        raise TypeError(f"{name}: block_table and lengths / pos0 must be "
                        f"int32, the latter of shape (B,)")
    for t in (qc, kc_pool, vc_pool, block_table, *per_row, *scales):
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


# The fused split merge's arrival counters, one int32 buffer per
# (device, stream): see ``_arrivals``.  Each (slot, kv group) owns
# ARRIVAL_STRIDE of them, a 128-byte line (``kCountStride`` in
# csrc/kq_decode_tc.cuh).
_ARRIVALS: dict = {}
ARRIVAL_STRIDE = 32


def _arrivals(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters for bf16 split decode on
    ``stream`` of ``device``, all zero.  The kernel counts each (slot, kv
    group)'s CTAs on its own line of them and its last CTA stores 0
    back, so the buffer stays zero between launches and is allocated
    once, not zeroed
    per call (``torch.zeros`` would be a launch of its own).  Two streams
    never share one: their launches may overlap.  A call that needs more
    grows it, zeroed anew, to at least twice its size."""
    key = (device, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < n:
        size = n if buf is None else max(n, 2 * buf.numel())
        buf = _ARRIVALS[key] = torch.zeros(size, dtype=torch.int32,
                                           device=device)
    return buf


def _decode(name: str, qc, kc_pool, vc_pool, lengths, block_table, scale,
            scales=(), span: int = 0, n_splits: int = 1,
            merge: bool = False):
    """Check and launch the paged decode kernel: unsplit (``n_splits``
    1) into a new (B,H,Rv) output, else into new f32 partials
    (B,Hkv,n,m,Rv) and lse (B,Hkv,n,m) over spans of ``span`` pages,
    returned; with ``merge`` (bfloat16 only) the same launch also merges
    the partials into a new (B,H,Rv) output, which is returned."""
    _cuda_only(name, qc)
    if qc.ndim != 3:
        raise ValueError(f"{name}: qc must be (B, H, Rk), got "
                         f"{tuple(qc.shape)}")
    _check(name, qc, kc_pool, vc_pool, block_table, (lengths,), scales)
    B, H, _ = qc.shape
    _, Hkv, ps, Rk = kc_pool.shape
    Rv = vc_pool.shape[-1]
    dev = qc.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = o_part = lse = count = None
    if n_splits == 1 or merge:
        out = torch.empty((B, H, Rv), dtype=qc.dtype, device=dev)
    if n_splits > 1:
        o_part, lse = (
            torch.empty((B, Hkv, n_splits, H // Hkv, Rv),
                        dtype=torch.float32, device=dev),
            torch.empty((B, Hkv, n_splits, H // Hkv), dtype=torch.float32,
                        device=dev))
    if merge:
        count = _arrivals(dev, stream, B * Hkv * ARRIVAL_STRIDE)

    def ptr(t):
        return None if t is None else t.data_ptr()

    ks, vs = scales or (None, None)
    _launched(name, _library().kq_decode_paged_launch(
        qc.data_ptr(), kc_pool.data_ptr(), vc_pool.data_ptr(), ptr(ks),
        ptr(vs), lengths.data_ptr(), block_table.data_ptr(), ptr(out),
        ptr(o_part), ptr(lse), ptr(count), B, H, Hkv, ps,
        block_table.shape[1], Rk, Rv, max(span, 1), n_splits, float(scale),
        _DTYPES[qc.dtype], stream))
    return (o_part, lse) if out is None else out


def kq_decode_paged_attention(qc: torch.Tensor, kc_pool: torch.Tensor,
                              vc_pool: torch.Tensor, lengths: torch.Tensor,
                              block_table: torch.Tensor, *,
                              scale: float = 1.0, num_splits: int = 1,
                              kscale: Optional[torch.Tensor] = None,
                              vscale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Paged decode.  qc: (B,H,Rk); kc_pool: (P,Hkv,ps,Rk); vc_pool:
    (P,Hkv,ps,Rv); lengths: (B,) int32 live entries per slot; block_table:
    (B, n_pages) int32 physical page of each logical page -> (B,H,Rv).

    Position t of slot b attends iff t < lengths[b] (0 gives a zero row);
    lengths past ``n_pages * ps`` are clamped to it.  qc float32 or
    bfloat16; pools of qc's type, or int8 with ``kscale``/``vscale``
    (P,Hkv,ps,1) bf16 per-token scales (K5, both or neither); f32
    accumulation; output in qc's type.

    ``num_splits`` > 1 cuts the table's ``n_pages`` pages into spans
    resolved as the reference does (``resolve_splits``); with more than
    one span this runs K4 (or K5 split) and the merge, else K1 (or K5).
    On a bfloat16 CUDA tensor the split is one launch that merges its
    spans itself, counted on ``kq_decode_paged_split`` (or
    ``kq_decode_paged_int8_split``); float32, and the plain versions on
    the CPU, write the partials and merge them with
    ``kq_combine_splits``.  K1 is launched here and counted on this
    function."""
    if (kscale is None) != (vscale is None):
        raise ValueError("kscale/vscale must be passed together")
    quant = kscale is not None
    n, span = resolve_splits(num_splits, block_table.shape[1])
    if n > 1:
        split = kq_decode_paged_int8_split if quant else kq_decode_paged_split
        if qc.device.type == "cuda" and qc.dtype == torch.bfloat16:
            out = _decode(split.__name__, qc, kc_pool, vc_pool, lengths,
                          block_table, scale,
                          scales=(kscale, vscale) if quant else (),
                          span=span, n_splits=n, merge=True)
            split.launches += 1
            return out
        o_part, lse = split(qc, kc_pool, vc_pool, lengths, block_table,
                            span=span, n_splits=n, scale=scale,
                            **(dict(kscale=kscale, vscale=vscale)
                               if quant else {}))
        B, H, Rv = qc.shape[0], qc.shape[1], vc_pool.shape[-1]
        return kq_combine_splits(
            o_part, lse, torch.empty((B, H, Rv), dtype=qc.dtype,
                                     device=qc.device))
    if quant:
        return kq_decode_paged_int8(qc, kc_pool, vc_pool, kscale, vscale,
                                    lengths, block_table, scale=scale)
    if qc.device.type == "cpu":
        return kq_decode_paged_attention_ref(qc, kc_pool, vc_pool, lengths,
                                             block_table, scale=scale)
    out = _decode("kq_decode_paged_attention", qc, kc_pool, vc_pool,
                  lengths, block_table, scale)
    kq_decode_paged_attention.launches += 1
    return out


def kq_decode_paged_split(qc: torch.Tensor, kc_pool: torch.Tensor,
                          vc_pool: torch.Tensor, lengths: torch.Tensor,
                          block_table: torch.Tensor, *, span: int,
                          n_splits: int, scale: float = 1.0):
    """K4, the split-KV decode over fp pages, before the merge: f32
    partials (B,Hkv,n,m,Rv) and lse (B,Hkv,n,m) of spans of ``span``
    pages (``span * n_splits`` covers the table).  This entry writes the
    partials only; ``kq_decode_paged_attention`` merges them in the same
    launch on bfloat16."""
    if qc.device.type == "cpu":
        return kq_decode_paged_partials_ref(
            qc, kc_pool, vc_pool, lengths, block_table, span=span,
            n_splits=n_splits, scale=scale)
    res = _decode("kq_decode_paged_split", qc, kc_pool, vc_pool, lengths,
                  block_table, scale, span=span, n_splits=n_splits)
    kq_decode_paged_split.launches += 1
    return res


def kq_decode_paged_int8(qc: torch.Tensor, kc_pool: torch.Tensor,
                         vc_pool: torch.Tensor, kscale: torch.Tensor,
                         vscale: torch.Tensor, lengths: torch.Tensor,
                         block_table: torch.Tensor, *,
                         scale: float = 1.0) -> torch.Tensor:
    """K5, the unsplit decode over int8 pools with (P,Hkv,ps,1) bf16
    per-token scales, dequantized in registers -> (B,H,Rv) in qc's type
    (groups m <= 8)."""
    if qc.device.type == "cpu":
        return kq_decode_paged_attention_int8_ref(
            qc, kc_pool, vc_pool, kscale, vscale, lengths, block_table,
            scale=scale)
    out = _decode("kq_decode_paged_int8", qc, kc_pool, vc_pool, lengths,
                  block_table, scale, scales=(kscale, vscale))
    kq_decode_paged_int8.launches += 1
    return out


def kq_decode_paged_int8_split(qc: torch.Tensor, kc_pool: torch.Tensor,
                               vc_pool: torch.Tensor, lengths: torch.Tensor,
                               block_table: torch.Tensor, *, span: int,
                               n_splits: int, kscale: torch.Tensor,
                               vscale: torch.Tensor, scale: float = 1.0):
    """K5 split: ``kq_decode_paged_split`` over int8 pools with their
    bf16 per-token scales (groups m <= 8)."""
    if qc.device.type == "cpu":
        return kq_decode_paged_partials_ref(
            qc, kc_pool, vc_pool, lengths, block_table, span=span,
            n_splits=n_splits, scale=scale, kscale=kscale, vscale=vscale)
    res = _decode("kq_decode_paged_int8_split", qc, kc_pool, vc_pool,
                  lengths, block_table, scale, scales=(kscale, vscale),
                  span=span, n_splits=n_splits)
    kq_decode_paged_int8_split.launches += 1
    return res


def kq_combine_splits(o_part: torch.Tensor, lse: torch.Tensor,
                      out: torch.Tensor) -> torch.Tensor:
    """The split merge, into ``out`` (returned).  o_part:
    (B,Hkv,S,m,Rv) f32; lse: (B,Hkv,S,m) f32; out: (B,Hkv*m,Rv) float32
    or bfloat16.  On the CPU the plain version
    (``combine_split_partials``) fills ``out``."""
    B, Hkv, n, m, Rv = o_part.shape
    if o_part.device.type == "cpu":
        return out.copy_(combine_split_partials(o_part, lse).reshape(
            out.shape))
    name = "kq_combine_splits"
    _cuda_only(name, o_part)
    if tuple(lse.shape) != (B, Hkv, n, m) \
            or tuple(out.shape) != (B, Hkv * m, Rv) or Rv > MAX_RANK:
        raise ValueError(f"{name}: shapes o_part {tuple(o_part.shape)} lse "
                         f"{tuple(lse.shape)} out {tuple(out.shape)}")
    if o_part.dtype != torch.float32 or lse.dtype != torch.float32 \
            or out.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtypes {o_part.dtype}, {lse.dtype}, "
                        f"{out.dtype}")
    for t in (o_part, lse, out):
        if t.device != o_part.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous on one "
                             f"device")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _launched(name, _library().kq_combine_splits_launch(
        o_part.data_ptr(), lse.data_ptr(), out.data_ptr(), B, Hkv, n, m, Rv,
        _DTYPES[out.dtype], stream))
    kq_combine_splits.launches += 1
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
kq_decode_paged_split.launches = 0
kq_decode_paged_int8.launches = 0
kq_decode_paged_int8_split.launches = 0
kq_combine_splits.launches = 0
kq_prefill_paged_attention.launches = 0
