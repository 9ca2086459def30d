"""Plain PyTorch versions of K7, the Mamba-2 SSD chunk scan.

``ssd_chunk_scan_plain`` is the chunked algorithm of the reference's
``_ssd_kernel`` (``src/repro/kernels/ssd/ssd.py:26``) and lax
``_ssd_chunked`` (``src/repro/models/ssm.py:84``) in float32, for any
sequence length: chunks of ``chunk`` tokens and a shorter last one.  It
is the kernel's plain version (the route of CPU tensors, and what the
kernel is held to on the card).

``ssd_chunk_scan_ref`` is the token-by-token recurrence in float64, the
port's copy of ``repro/kernels/ssd/ref.py`` with the initial and final
state added: the oracle both are held to.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, G, S, n) per-group B or C -> (B, nh, S, n) per head."""
    return t.repeat_interleave(rep, dim=1) if rep > 1 else t


def ssd_chunk_scan_plain(x: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor, *,
                         chunk: int = 128, h0: Optional[torch.Tensor] = None,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Bsz,nh,S,hd); a = dt*A and dt: (Bsz,nh,S); B/C: (Bsz,G,S,n);
    h0: optional (Bsz,nh,n,hd) initial state.  Returns y (Bsz,nh,S,hd) in
    ``out_dtype`` (default x's type) and the final state (Bsz,nh,n,hd)
    float32.  Head h reads group ``h // (nh / G)``.

    Per chunk, with ``cum`` the chunk's running sum of a:
    y_i = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
          + exp(cum_i) C_i h,
    h  <- h exp(cum_last) + sum_j B_j^T exp(cum_last - cum_j) dt_j x_j.
    The decay is masked before ``exp`` (the upper triangle's exponents
    are positive and overflow).  ``cum`` is summed in float64 and rounded
    to float32, so it does not depend on the order of addition: the
    kernel's block-wide scan gives the same values, where two float32
    sums over a chunk of 256 (cum reaches hundreds) drift apart by some
    1e-4 and move y by some 1e-3 through the exps.  The reference sums in
    float32 in order."""
    y, h = chunk_scan_f32(x, a, dt, B, C, chunk=chunk, h0=h0)
    return y.to(out_dtype or x.dtype), h


def chunk_scan_f32(x: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked algorithm of ``ssd_chunk_scan_plain``, y in float32:
    differentiable, so ``ssd_chunk_scan_backward`` takes its gradient
    (the counterpart of XLA's autodiff of the reference's lax
    ``_ssd_chunked``)."""
    Bsz, nh, S, hd = x.shape
    rep = nh // B.shape[1]
    n = B.shape[-1]
    xf, af, dtf = x.float(), a.float(), dt.float()
    Bh, Ch = _heads(B.float(), rep), _heads(C.float(), rep)
    h = (torch.zeros((Bsz, nh, n, hd), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float().clone())
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(S, c0 + chunk))
        xc, Bc, Cc = xf[:, :, sl], Bh[:, :, sl], Ch[:, :, sl]
        dtc = dtf[:, :, sl]
        cum = torch.cumsum(af[:, :, sl].double(), dim=-1).float()  # B,nh,L
        L = cum.shape[-1]
        causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
        diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal,
                                                                   -1e30)
        w = (Cc @ Bc.transpose(-1, -2)) * torch.exp(diff) * dtc[..., None, :]
        y = w @ xc + (Cc * torch.exp(cum)[..., None]) @ h
        wj = torch.exp(cum[..., -1:] - cum) * dtc                # (B,nh,L)
        h = (h * torch.exp(cum[..., -1])[..., None, None]
             + (Bc * wj[..., None]).transpose(-1, -2) @ xc)
        ys.append(y)
    y = torch.cat(ys, dim=2) if ys else torch.zeros_like(xf)
    return y, h


def ssd_chunk_scan_ref(x: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, *,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence in float64, shapes as in
    ``ssd_chunk_scan_plain``: h_t = exp(a_t) h_{t-1} + dt_t B_t x_t^T,
    y_t = C_t h_t.  Returns y and the final state, both float64, on the
    inputs' device."""
    Bsz, nh, S, hd = x.shape
    rep = nh // B.shape[1]
    n = B.shape[-1]
    xd, ad, dtd = x.double(), a.double(), dt.double()
    Bh, Ch = _heads(B.double(), rep), _heads(C.double(), rep)
    h = (torch.zeros((Bsz, nh, n, hd), dtype=torch.float64, device=x.device)
         if h0 is None else h0.double().clone())
    y = torch.zeros_like(xd)
    for t in range(S):
        upd = (Bh[:, :, t] * dtd[:, :, t, None])[..., :, None] \
            * xd[:, :, t, None, :]
        h = h * torch.exp(ad[:, :, t])[..., None, None] + upd
        y[:, :, t] = (Ch[:, :, t, None, :] @ h)[:, :, 0]
    return y, h
