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

``kq_decode_attention`` takes the plain version
(``kq_decode_attention_ref``) only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises: there is no fallback.  Every
launch adds one to ``kq_decode_attention.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kq_decode.ref import kq_decode_attention_ref

MAX_RANK = 256        # largest Rk / Rv the kernel takes
MAX_GROUP = 16        # largest GQA group m = H / Hkv the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = build.load("kq_decode")
    fn = lib.kq_decode_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def kq_decode_attention(qc: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                        lengths: torch.Tensor, *,
                        scale: float = 1.0) -> torch.Tensor:
    """qc: (B,H,Rk); kc: (B,Hkv,T,Rk); vc: (B,Hkv,T,Rv) -> (B,H,Rv).

    ``lengths``: (B,) int32 count of live cache entries per sequence
    (positions ``0..lengths[b]-1`` attend; 0 gives a zero row).  Inputs
    float32 or bfloat16, all of one type; f32 accumulation; the output is
    in the query's type."""
    if qc.device.type == "cpu":
        return kq_decode_attention_ref(qc, kc, vc, lengths, scale=scale)
    if qc.device.type != "cuda":
        raise ValueError(f"kq_decode_attention: unsupported device "
                         f"{qc.device}")
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
    out = torch.empty((B, H, Rv), dtype=qc.dtype, device=qc.device)
    stream = torch.cuda.current_stream(qc.device).cuda_stream
    err = _library().kq_decode_launch(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, Hkv, T, Rk, Rv, float(scale),
        _DTYPES[qc.dtype], stream)
    if err != 0:
        raise RuntimeError(f"kq_decode kernel launch failed: cudaError {err}")
    kq_decode_attention.launches += 1
    return out


kq_decode_attention.launches = 0
