"""Mamba-2 SSD (state-space duality) blocks, in PyTorch.

Torch counterpart of ``repro.models.ssm``.  Prefill runs the chunked SSD
algorithm (arXiv:2405.21060 §6) in K7 (``kernels/ssd``) on the card;
decode is the O(1) recurrent update

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T,    y_t = C_t h_t + D x_t

in plain PyTorch, updating the state in place.  The decode state (B, nh,
d_state, head_dim) is the whole cache, which is why KQ-SVD has nothing to
compress in this family.

Layout: x (B, S, D) -> in_proj -> [z (d_in), xBC (d_in + 2*G*S_st), dt (nh)],
causal conv over xBC, SSD over heads of size head_dim.

Where the reference's lax ``_ssd_chunked`` cuts S into ``S // chunk``
equal chunks (and fails when they do not divide S), the port takes any S:
chunks of ``chunk_size`` tokens and a shorter last one.  The answer does
not depend on the chunking; only its rounding does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import SSMConfig
from repro_torch.kernels.ssd import ssd_chunk_scan
from repro_torch.models.layers import init_dense, rms_norm


def _dims(s: SSMConfig, d_model: int):
    d_in = s.d_inner(d_model)
    nh = s.n_heads(d_model)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, nh, conv_dim


def init_ssm(gen: torch.Generator, d_model: int, s: SSMConfig, dtype,
             device) -> Dict[str, torch.Tensor]:
    """Mamba-2 style SSM params (fused in-proj, depthwise conv, per-head
    decay / dt / skip in float32, gated-norm out-proj), drawn from
    ``gen`` with the reference's shapes and laws."""
    d_in, nh, conv_dim = _dims(s, d_model)
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + nh
    dt = np.exp(np.linspace(np.log(s.dt_min), np.log(s.dt_max), nh))
    conv = torch.randn((conv_dim, s.d_conv), generator=gen,
                       device=gen.device) / np.sqrt(s.d_conv)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {
        "in_proj": init_dense(gen, (d_model, proj_out), d_model, dtype,
                              device),
        "conv": conv.to(device=device, dtype=dtype),
        "a_log": f32(np.log(np.linspace(1.0, 16.0, nh, dtype=np.float32))),
        "dt_bias": f32(np.log(np.expm1(dt))),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=device),
        "norm": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": init_dense(gen, (d_in, d_model), d_in, dtype, device),
    }


def _split_proj(p, x, s: SSMConfig, d_model: int):
    d_in, nh, _ = _dims(s, d_model)
    gs = s.n_groups * s.d_state
    proj = x @ p["in_proj"]
    z = proj[..., :d_in]
    xBC = proj[..., d_in: 2 * d_in + 2 * gs]
    dt = proj[..., 2 * d_in + 2 * gs:]
    return z, xBC, dt


def _conv_apply(weight: torch.Tensor, xBC: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Causal depthwise conv, width K.  xBC: (B, S, Cdim).

    With ``state`` (B, Cdim, K-1) the convolution sees the carried
    context; returns (out, new_state), the new state the last K-1 columns
    of [state, xBC^T] (with fewer than K-1 new tokens, part of the old
    state).  Written as K shifted slices summed in float32, as the
    reference's windows are (no cuDNN convolution, so no TF32), over
    (B, S + K - 1, Cdim) so that ``out`` keeps xBC's layout with Cdim
    contiguous (K7 reads its slices in place); the sum is rounded to x's
    type before the f32 SiLU, as the reference's einsum result is."""
    B, S, Cd = xBC.shape
    K = weight.shape[1]
    if state is None:
        state = torch.zeros((B, Cd, K - 1), dtype=xBC.dtype,
                            device=xBC.device)
    full = torch.cat([state.to(xBC.dtype).transpose(1, 2), xBC],
                     dim=1)                                   # (B,S+K-1,Cd)
    w = weight.float().T                                      # (K, Cd)
    out = full[:, 0:S].float() * w[0]
    for k in range(1, K):
        out = out + full[:, k:k + S].float() * w[k]
    new_state = full[:, full.shape[1] - (K - 1):].transpose(1, 2)
    return F.silu(out.to(xBC.dtype).float()).to(xBC.dtype), new_state


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD through K7.

    xh: (B,S,nh,hd); dt: (B,S,nh) (already softplus'ed); A: (nh,)
    negative; Bm/Cm: (B,S,G,S_st); h0: optional carried state.  Returns y
    (B,S,nh,hd) float32 and the final state (B,nh,S_st,hd) float32.  The
    kernel reads the (B,S,...) tensors through transposed views."""
    a = dt * A[None, None, :]                                 # (B,S,nh) <= 0
    y, h = ssd_chunk_scan(xh.transpose(1, 2), a.transpose(1, 2),
                          dt.transpose(1, 2), Bm.transpose(1, 2),
                          Cm.transpose(1, 2), chunk=chunk, h0=h0,
                          out_dtype=torch.float32)
    return y.transpose(1, 2), h


def ssm_forward(p: Dict, x: torch.Tensor, s: SSMConfig,
                state: Optional[Dict] = None, return_state: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence SSD.  x: (B,S,D).  ``state`` (conv tail and SSM
    state) continues a sequence; ``return_state`` returns the state after
    its last token."""
    B, S, D = x.shape
    d_in, nh, conv_dim = _dims(s, D)
    gs = s.n_groups * s.d_state
    z, xBC, dt = _split_proj(p, x, s, D)
    conv_state = state["conv"] if state else None
    xBC, conv_state = _conv_apply(p["conv"], xBC, conv_state)
    xs = xBC[..., :d_in].reshape(B, S, nh, s.head_dim)
    Bm = xBC[..., d_in:d_in + gs].reshape(B, S, s.n_groups, s.d_state)
    Cm = xBC[..., d_in + gs:].reshape(B, S, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["a_log"])
    h0 = state["s"] if state else None
    y, h = _ssd_chunked(xs, dt, A, Bm, Cm, s.chunk_size, h0=h0)
    y = y + xs.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["norm"])
    out = y @ p["out_proj"]
    new_state = ({"conv": conv_state.contiguous(), "s": h}
                 if return_state else None)
    return out, new_state


def ssm_decode(p: Dict, x: torch.Tensor, state: Dict, s: SSMConfig
               ) -> Tuple[torch.Tensor, Dict]:
    """Single-token recurrent step.  x: (B,1,D).  ``state`` is updated in
    place and returned."""
    B, _, D = x.shape
    d_in, nh, conv_dim = _dims(s, D)
    gs = s.n_groups * s.d_state
    z, xBC, dt = _split_proj(p, x, s, D)
    xBC, conv_state = _conv_apply(p["conv"], xBC, state["conv"])
    xs = xBC[:, 0, :d_in].reshape(B, nh, s.head_dim).float()
    Bm = xBC[:, 0, d_in:d_in + gs].reshape(B, s.n_groups, s.d_state)
    Cm = xBC[:, 0, d_in + gs:].reshape(B, s.n_groups, s.d_state)
    rep = nh // s.n_groups
    Bm = Bm.float().repeat_interleave(rep, dim=1)            # (B,nh,S_st)
    Cm = Cm.float().repeat_interleave(rep, dim=1)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    decay = torch.exp(dt * A[None, :])                       # (B,nh)
    h = state["s"]                                           # (B,nh,S_st,hd)
    h.mul_(decay[..., None, None]).add_(
        (Bm * dt[..., None])[..., :, None] * xs[..., None, :])
    state["conv"].copy_(conv_state)
    y = (Cm[:, :, None, :] @ h)[:, :, 0]                     # (B,nh,hd)
    y = y + xs * p["d_skip"][None, :, None]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["norm"])
    out = y @ p["out_proj"]
    return out, state


def make_ssm_state(s: SSMConfig, d_model: int, batch: int,
                   dtype=torch.bfloat16, device="cpu"
                   ) -> Dict[str, torch.Tensor]:
    """Zeroed recurrent state: conv tail (model dtype) and the float32 SSM
    state."""
    d_in, nh, conv_dim = _dims(s, d_model)
    return {
        "conv": torch.zeros((batch, conv_dim, s.d_conv - 1), dtype=dtype,
                            device=device),
        "s": torch.zeros((batch, nh, s.d_state, s.head_dim),
                         dtype=torch.float32, device=device),
    }
