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

On fake tensors (a dry run) ``ssd_chunk_scan`` returns outputs of the
kernels' shapes, types and layout and computes nothing; under an active
op count each call books ``ssd_work`` (``kernels.booking``).

``ssd_chunk_scan_train`` runs it under autograd (``SSDChunkScan``); its
backward, ``ssd_chunk_scan_backward``, is plain PyTorch with a counter
of its own, as the reference has no backward kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import booking, build
from repro_torch.kernels.ssd.ref import chunk_scan_f32, ssd_chunk_scan_plain

# (head_dim, d_state) the kernel is built for: the reference kernel sweep
# and SSM tests, the reduced configs, mamba2-2.7b and jamba
SHAPES = ((8, 8), (8, 16), (16, 8), (16, 16), (64, 128), (128, 64))
MAX_CHUNK = 256
_DTYPES = (torch.float32, torch.bfloat16)


def ssd_work(B: int, nh: int, G: int, S: int, hd: int, n: int, chunk: int,
             itemsize: int, out_itemsize: int):
    """(flops, bytes) of one K7 call: the causal pairs of each chunk times
    2 (n + hd) flops, plus 4 n hd a token for the carried term and the
    state update, a head; against x and y (``itemsize`` and
    ``out_itemsize`` bytes an element), B and C, a and dt (float32) and
    the final float32 state moved once."""
    lens = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    pairs = sum(L * (L + 1) // 2 for L in lens)
    return (B * nh * (2 * pairs * (n + hd) + 4 * S * n * hd),
            B * nh * S * hd * (itemsize + out_itemsize)
            + 2 * B * G * S * n * itemsize + 2 * B * nh * S * 4
            + B * nh * n * hd * 4)


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
    if booking.active():
        Bsz, nh, S, hd = x.shape
        booking.book("ssd_chunk_scan", *ssd_work(
            Bsz, nh, B.shape[1], S, hd, B.shape[-1], chunk,
            x.element_size(), torch.finfo(out_dtype or x.dtype).bits // 8))
    if booking.is_fake(x):
        Bsz, nh, S, hd = x.shape
        return (x.new_empty((Bsz, S, nh, hd),
                            dtype=out_dtype or x.dtype).transpose(1, 2),
                x.new_empty((Bsz, nh, B.shape[-1], hd), dtype=torch.float32))
    if x.device.type == "cpu":
        with booking.unseen():
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
        raise build.KernelError(f"ssd kernel launch failed: cudaError {err}")
    ssd_chunk_scan.launches += 1
    return y, h


ssd_chunk_scan.launches = 0


def ssd_chunk_scan_backward(x, a, dt, B, C, h0, dy, dh, *, chunk: int = 128):
    """Gradients of ``ssd_chunk_scan`` in plain PyTorch: (dx, da, ddt, dB,
    dC, dh0) in the inputs' types (dh0 None without ``h0``), for the
    output gradients ``dy`` (of y) and ``dh`` (of the final state).

    The reference has no backward kernel: its gradient is XLA's autodiff
    of the lax ``_ssd_chunked``.  This recomputes the same chunked
    algorithm in float32 (``ref.chunk_scan_f32``) under autograd and
    differentiates it; it is not the forward's plain version, which never
    runs on a CUDA tensor.  Each call adds one to
    ``ssd_chunk_scan_backward.launches``."""
    with torch.enable_grad(), torch.profiler.record_function(
            "ssd_chunk_scan_backward"):
        ins = [t.detach().requires_grad_() for t in (x, a, dt, B, C)]
        if h0 is not None:
            ins.append(h0.detach().requires_grad_())
        y, h = chunk_scan_f32(*ins[:5], chunk=chunk,
                              h0=ins[5] if h0 is not None else None)
        grads = torch.autograd.grad((y, h), ins, (dy.float(), dh.float()),
                                    allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g.to(t.dtype)
             for g, t in zip(grads, ins)]
    ssd_chunk_scan_backward.launches += 1
    return (*grads[:5], grads[5] if h0 is not None else None)


ssd_chunk_scan_backward.launches = 0


class SSDChunkScan(torch.autograd.Function):
    """K7 under autograd: the forward is ``ssd_chunk_scan`` (the kernels on
    CUDA tensors, the plain version on CPU ones), the backward
    ``ssd_chunk_scan_backward``.  Saves the inputs."""

    @staticmethod
    def forward(ctx, x, a, dt, B, C, h0, chunk, out_dtype):
        """y and the final state, from ``ssd_chunk_scan``."""
        y, h = ssd_chunk_scan(x, a, dt, B, C, chunk=chunk, h0=h0,
                              out_dtype=out_dtype)
        ctx.save_for_backward(x, a, dt, B, C, h0)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        """The inputs' gradients from ``ssd_chunk_scan_backward``."""
        x, a, dt, B, C, h0 = ctx.saved_tensors
        grads = ssd_chunk_scan_backward(x, a, dt, B, C, h0, dy, dh,
                                        chunk=ctx.chunk)
        return (*grads, None, None)


def ssd_chunk_scan_train(x: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor, *,
                         chunk: int = 128, h0: Optional[torch.Tensor] = None,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunk_scan`` with gradients (``SSDChunkScan``): the SSM
    layer's full-sequence forward."""
    return SSDChunkScan.apply(x, a, dt, B, C, h0, chunk, out_dtype)
