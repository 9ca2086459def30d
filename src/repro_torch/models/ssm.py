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

On a mesh (DTensor activations) the projections and the gated norm run
as DTensor operations, the depthwise conv on each rank's channels and
K7 (or the decode recurrence) on each rank's heads through
``local_map``: channels and heads on the model axis where they divide
it, as ``launch.specs.cache_spec`` places the ``conv`` and ``s`` state,
the groups' B / C replicated there (their gradients partial sums over
it).  The state is updated in place on each rank's shard.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import SSMConfig
from repro_torch.kernels.ssd import ssd_chunk_scan, ssd_chunk_scan_train
from repro_torch.models.layers import init_dense, rms_norm
from repro_torch.sharding.partition import (grad_placed, is_dtensor,
                                            mesh_axes, partial_where,
                                            redistributed, remap,
                                            shard_range)


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
    # on a mesh the slices' gradients come back in several placements
    # (heads cut, B / C partial): redistributed to the product's own
    # before its (B S, .) rows meet them (the production meshes)
    proj = grad_placed(x @ p["in_proj"])
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
    kernel reads the (B,S,...) tensors through transposed views.  Where an
    input needs a gradient (the training forward) K7 runs under autograd
    (``ssd_chunk_scan_train``), else the wrapper alone."""
    return _scan(xh, dt * A[None, None, :], dt, Bm, Cm, chunk, h0)


def _scan(xh, a, dt, Bm, Cm, chunk: int, h0=None):
    """K7 on (B,S,...) tensors, ``a = dt * A`` given (``_ssd_chunked``)."""
    args = [t.transpose(1, 2) for t in (xh, a, dt, Bm, Cm)]
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in args + [h0])
    scan = ssd_chunk_scan_train if grad else ssd_chunk_scan
    y, h = scan(*args, chunk=chunk, h0=h0, out_dtype=torch.float32)
    return y.transpose(1, 2), h


def ssm_forward(p: Dict, x: torch.Tensor, s: SSMConfig,
                state: Optional[Dict] = None, return_state: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence SSD.  x: (B,S,D).  ``state`` (conv tail and SSM
    state) continues a sequence; ``return_state`` returns the state after
    its last token."""
    if is_dtensor(x):
        return _forward_sharded(p, x, s, state, return_state)
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
    if is_dtensor(x):
        return _decode_sharded(p, x, state, s)
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


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------


def _layout(x, n: int, state=None):
    """``(rows, cut)`` placements of a (B, n, ...) activation: ``rows``
    its batch as ``state``'s (or x's rows), ``cut`` that with dim 1
    (channels or heads, n of them) on the model axis where it divides
    n, as ``launch.specs.cache_spec`` places the ``conv`` and ``s``
    state."""
    from torch.distributed.tensor import Shard
    rows = remap((state if state is not None else x).placements, {0: 0})
    msize = mesh_axes(x.device_mesh).get("model", 1)
    cut = tuple(Shard(1) if name == "model" and msize > 1 and n % msize == 0
                else pl for name, pl in zip(x.device_mesh.mesh_dim_names,
                                            rows))
    return rows, cut


def _conv_sharded(weight, xBC, state=None, in_place: bool = False):
    """``_conv_apply`` on each rank's channels (``local_map``): xBC (B,S,Cd)
    and the weight cut on the model axis where it divides Cd, the batch
    as ``state``'s (or xBC's rows).  Returns the conv output and the new
    state (the state updated in place with ``in_place``)."""
    from torch.distributed.tensor.experimental import local_map
    rows, cut = _layout(xBC, xBC.shape[-1], state)
    x_pl, w_pl = remap(cut, {0: 0, 1: 2}), remap(cut, {1: 0})
    w_grad = partial_where(w_pl, rows)
    xBC, weight = redistributed(xBC, x_pl), redistributed(weight, w_pl)

    def local(w, x, st):
        out, new = _conv_apply(w, x, st)
        if in_place:
            st.copy_(new)
            new = st
        return out, new

    if state is None:
        return local_map(lambda w, x: local(w, x, None),
                         out_placements=(list(x_pl), list(cut)),
                         in_placements=(w_pl, x_pl),
                         in_grad_placements=(w_grad, x_pl),
                         device_mesh=xBC.device_mesh)(weight, xBC)
    return local_map(local, out_placements=(list(x_pl), list(cut)),
                     in_placements=(w_pl, x_pl, cut),
                     device_mesh=xBC.device_mesh)(weight, xBC, state)


def _local_groups(Bm: torch.Tensor, nh: int, h0: int, nhl: int):
    """The groups (dim 2 of (B,S,G,n) or dim 1 of (B,G,n)) of local heads
    ``h0 .. h0 + nhl`` out of ``nh``."""
    G = Bm.shape[-2]
    rep = nh // G
    if G == 1 or nhl == nh:
        return Bm
    g0 = h0 // rep
    return Bm.narrow(-2, g0, max(1, nhl // rep))


def _forward_sharded(p, x, s: SSMConfig, state, return_state):
    """``ssm_forward`` on a mesh (module docstring): K7 on each rank's
    heads under ``local_map``, under autograd where its inputs need
    gradients (training)."""
    from torch.distributed.tensor.experimental import local_map
    B, S, D = x.shape
    d_in, nh, conv_dim = _dims(s, D)
    gs = s.n_groups * s.d_state
    z, xBC, dt = _split_proj(p, x, s, D)
    xBC, conv_state = _conv_sharded(p["conv"], xBC,
                                    state["conv"] if state else None)
    xs = xBC[..., :d_in].reshape(B, S, nh, s.head_dim)
    Bm = xBC[..., d_in:d_in + gs].reshape(B, S, s.n_groups, s.d_state)
    Cm = xBC[..., d_in + gs:].reshape(B, S, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["a_log"])
    a = dt * A[None, None, :]
    rows, cut = _layout(x, nh, state["s"] if state else None)
    h_pl = remap(cut, {0: 0, 1: 2})
    xs, a, dt = (redistributed(t, h_pl) for t in (xs, a, dt))
    Bm, Cm = redistributed(Bm, rows), redistributed(Cm, rows)
    g_grad = partial_where(rows, h_pl)
    h0 = shard_range(xs, 2)[0]
    nhl = xs.to_local().shape[2]
    ins = [xs, a, dt, Bm, Cm]
    in_pl = [h_pl, h_pl, h_pl, rows, rows]
    if state is not None:
        ins.append(redistributed(state["s"], cut))
        in_pl.append(cut)

    def local(xs, a, dt, Bm, Cm, h0_state=None):
        return _scan(xs, a, dt, _local_groups(Bm, nh, h0, nhl),
                     _local_groups(Cm, nh, h0, nhl), s.chunk_size, h0_state)

    y, h = local_map(local, out_placements=(list(h_pl), list(cut)),
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(in_pl[:3]) + (g_grad, g_grad)
                     + tuple(in_pl[5:]),
                     device_mesh=x.device_mesh)(*ins)
    y = y + xs.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["norm"])
    out = y @ p["out_proj"]
    new_state = {"conv": conv_state, "s": h} if return_state else None
    return out, new_state


def _decode_sharded(p, x, state: Dict, s: SSMConfig):
    """``ssm_decode`` on a mesh, over ``conv`` / ``s`` state placed by
    ``cache_shardings``: the conv on each rank's channels and the
    recurrence on each rank's heads (``local_map``), both states updated
    in place."""
    from torch.distributed.tensor.experimental import local_map
    B, _, D = x.shape
    d_in, nh, conv_dim = _dims(s, D)
    gs = s.n_groups * s.d_state
    z, xBC, dt = _split_proj(p, x, s, D)
    xBC, _ = _conv_sharded(p["conv"], xBC, state["conv"], in_place=True)
    xs = xBC[:, 0, :d_in].reshape(B, nh, s.head_dim)
    Bm = xBC[:, 0, d_in:d_in + gs].reshape(B, s.n_groups, s.d_state)
    Cm = xBC[:, 0, d_in + gs:].reshape(B, s.n_groups, s.d_state)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    rows, cut = _layout(x, nh, state["s"])
    heads = remap(cut, {1: 0})                 # a (nh,) vector's
    xs, dt = redistributed(xs, cut), redistributed(dt, cut)
    A, skip = (redistributed(t, heads) for t in (A, p["d_skip"]))
    Bm, Cm = redistributed(Bm, rows), redistributed(Cm, rows)
    h0 = shard_range(xs, 1)[0]
    nhl = xs.to_local().shape[1]

    def local(xs, dt, A, skip, Bm, Cm, h):
        Bl, Cl = (_local_groups(t, nh, h0, nhl).float() for t in (Bm, Cm))
        rep = nhl // Bl.shape[1]
        Bl, Cl = (t.repeat_interleave(rep, dim=1) for t in (Bl, Cl))
        xs = xs.float()
        decay = torch.exp(dt * A[None, :])
        h.mul_(decay[..., None, None]).add_(
            (Bl * dt[..., None])[..., :, None] * xs[..., None, :])
        return (Cl[:, :, None, :] @ h)[:, :, 0] + xs * skip[None, :, None]

    sp = redistributed(state["s"], cut)
    y = local_map(local, out_placements=list(cut),
                  in_placements=(cut, cut, heads, heads, rows, rows, cut),
                  device_mesh=x.device_mesh)(xs, dt, A, skip, Bm, Cm, sp)
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["norm"])
    return y @ p["out_proj"], state
