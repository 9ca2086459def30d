"""K7 on Hopper: the Mamba-2 SSD chunk scan.

Replaces the reference's Pallas TPU kernel ``_ssd_kernel``
(``src/repro/kernels/ssd/ssd.py:26``, entry point ``ssd_chunk_scan`` at
``:64``).  The kernels are CUDA C++ for ``sm_90a`` in
``repro_torch/kernels/csrc/ssd.cu``, compiled with ``nvcc`` at first use
and called through plain C entry points with ``ctypes`` on PyTorch's
current stream.  The input type picks the body: bfloat16 runs the
chunk-parallel tensor-core body (``csrc/ssd_tc.cuh``: three kernels, the
chunk-local states, the state pass over chunks and the scan, on float32
scratch the wrapper allocates), float32 the first body (``ssd.cu``, one
block per (b, head), true f32 arithmetic).  Each header says what bounds
its body and how the design answers that.

``ssd_chunk_scan`` takes the plain version (``ssd_chunk_scan_plain``)
only for tensors on the CPU.  For CUDA tensors it launches the kernels
or raises: there is no fallback.  The kernels read x, a, dt, B and C
through their strides (the last dim of x, B and C contiguous), so the
model's (B, S, nh, hd) views need no copy.  Every call that launches
adds one to ``ssd_chunk_scan.launches``, whatever number of kernels the
body runs.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd.ref import ssd_chunk_scan_plain

# (head_dim, d_state) the kernel is built for: the reference kernel sweep
# and SSM tests, the reduced configs, mamba2-2.7b and jamba
SHAPES = ((8, 8), (8, 16), (16, 8), (16, 16), (64, 128), (128, 64))
MAX_CHUNK = 256
_DTYPES = (torch.float32, torch.bfloat16)


def _library() -> ctypes.CDLL:
    lib = build.load("ssd")
    for fn, n_ptr, n_int in ((lib.ssd_launch, 8, 7),
                             (lib.ssd_tc_launch, 10, 8)):
        if not fn.argtypes:
            fn.argtypes = ([ctypes.c_void_p] * n_ptr
                           + [ctypes.c_longlong] * 18
                           + [ctypes.c_int] * n_int + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def ssd_chunk_scan(x: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
                   h0: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Bsz,nh,S,hd); a = dt*A and dt: (Bsz,nh,S) float32; B/C:
    (Bsz,G,S,n); h0: optional (Bsz,nh,n,hd) initial state.  Returns y
    (Bsz,nh,S,hd) in ``out_dtype`` (default x's type) and the final state
    (Bsz,nh,n,hd) float32.

    Any S: chunks of ``chunk`` tokens (1..256) and a shorter last one.
    x, B and C float32 or bfloat16, all of one type; f32 state.  On the
    card y is a view of (Bsz,S,nh,hd) memory, the model's layout, so
    ``y.transpose(1, 2)`` is contiguous; bfloat16 inputs run the
    tensor-core body (three kernel launches, counted as one call),
    float32 ones the f32 body."""
    if x.device.type == "cpu":
        return ssd_chunk_scan_plain(x, a, dt, B, C, chunk=chunk, h0=h0,
                                    out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan: unsupported device {x.device}")
    if x.ndim != 4 or B.ndim != 4 or C.ndim != 4 or a.ndim != 3 \
            or dt.ndim != 3:
        raise ValueError("ssd_chunk_scan: x, B, C must be 4-d, a and dt 3-d")
    Bsz, nh, S, hd = x.shape
    G, n = B.shape[1], B.shape[-1]
    if tuple(B.shape) != (Bsz, G, S, n) or tuple(C.shape) != (Bsz, G, S, n) \
            or tuple(a.shape) != (Bsz, nh, S) \
            or tuple(dt.shape) != (Bsz, nh, S):
        raise ValueError(f"ssd_chunk_scan: shapes x {tuple(x.shape)} a "
                         f"{tuple(a.shape)} dt {tuple(dt.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)}")
    if G == 0 or nh % G:
        raise ValueError(f"ssd_chunk_scan: nh={nh} is not a multiple of "
                         f"G={G}")
    if (hd, n) not in SHAPES:
        raise ValueError(f"ssd_chunk_scan: (head_dim, d_state) = ({hd}, {n})"
                         f" not in the built shapes {SHAPES}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_chunk_scan: chunk {chunk} not in "
                         f"1..{MAX_CHUNK}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_chunk_scan: dtypes x {x.dtype}, B {B.dtype}, "
                        f"C {C.dtype}; want one of float32 / bfloat16 for "
                        f"all three")
    if a.dtype != torch.float32 or dt.dtype != torch.float32:
        raise TypeError("ssd_chunk_scan: a and dt must be float32")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.float32, x.dtype):
        raise TypeError(f"ssd_chunk_scan: out_dtype {out_dtype}; want "
                        f"float32 or x's type")
    for t in (x, a, dt, B, C):
        if t.device != x.device:
            raise ValueError("ssd_chunk_scan: tensors on different devices")
    for t in (x, B, C):
        if t.stride(-1) != 1:
            raise ValueError("ssd_chunk_scan: the last dim of x, B and C "
                             "must be contiguous")
    if h0 is not None:
        if tuple(h0.shape) != (Bsz, nh, n, hd) or h0.device != x.device:
            raise ValueError(f"ssd_chunk_scan: h0 {tuple(h0.shape)} on "
                             f"{h0.device}; want ({Bsz}, {nh}, {n}, {hd})")
        h0 = h0.to(torch.float32).contiguous()
        if h0.data_ptr() % 16:       # the state pass reads 16-byte units
            h0 = h0.clone()
    y = torch.empty((Bsz, S, nh, hd), dtype=out_dtype,
                    device=x.device).transpose(1, 2)
    h = torch.empty((Bsz, nh, n, hd), dtype=torch.float32, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), a.data_ptr(), dt.data_ptr(), B.data_ptr(),
            C.data_ptr(), 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
            h.data_ptr())
    strides = (*x.stride()[:3], *a.stride(), *dt.stride(), *B.stride()[:3],
               *C.stride()[:3], *y.stride()[:3])
    if x.dtype == torch.bfloat16:
        # scratch: each chunk's cum, and its local state, then h_in
        cum = torch.empty((Bsz, nh, S), dtype=torch.float32, device=x.device)
        st = torch.empty((Bsz, nh, -(-S // chunk), n, hd),
                         dtype=torch.float32, device=x.device)
        err = lib.ssd_tc_launch(*ptrs, cum.data_ptr(), st.data_ptr(),
                                *strides, Bsz, nh, G, S, hd, n, chunk,
                                int(out_dtype == torch.float32), stream)
    else:                           # float32: y too
        err = lib.ssd_launch(*ptrs, *strides, Bsz, nh, G, S, hd, n, chunk,
                             stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: cudaError {err}")
    ssd_chunk_scan.launches += 1
    return y, h


ssd_chunk_scan.launches = 0
