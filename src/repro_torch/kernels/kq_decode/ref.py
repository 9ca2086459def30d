"""Plain PyTorch version of K3, the compressed-cache decode attention.

The same function as the CUDA kernel in ``csrc/kq_decode.cu``, written
with tensor ops: the CPU tests use it, the wrapper takes it for tensors
on the CPU, and ``chip_smoke.py`` holds the kernel against it on the
card.  It follows the kernel (and the reference's Pallas kernel), not the
reference's jnp oracle, where they differ: a sequence of length 0 gets
``acc / max(sum, 1e-30) = 0`` rather than a uniform average over the
masked cache.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def kq_decode_attention_ref(qc: torch.Tensor, kc: torch.Tensor,
                            vc: torch.Tensor, lengths: torch.Tensor, *,
                            scale: float = 1.0) -> torch.Tensor:
    """qc: (B,H,Rk); kc: (B,Hkv,T,Rk); vc: (B,Hkv,T,Rv) -> (B,H,Rv).

    ``lengths``: (B,) count of live cache entries per sequence; position
    t of sequence b attends iff t < lengths[b].  f32 arithmetic, output
    in ``qc``'s type."""
    B, H, Rk = qc.shape
    Hkv, T = kc.shape[1], kc.shape[2]
    m = H // Hkv
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=qc.device)
    if lengths.ndim == 0:
        lengths = lengths.expand(B)
    qg = qc.reshape(B, Hkv, m, Rk).float()
    s = torch.einsum("bgmr,bgtr->bgmt", qg, kc.float()) * scale
    valid = (torch.arange(T, device=qc.device)[None, :]
             < lengths[:, None])[:, None, None, :]           # (B,1,1,T)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - mx), torch.zeros_like(s))
    # dead rows zeroed: p is 0 there, but 0 * NaN would still be NaN
    v = torch.where(valid.reshape(B, 1, T, 1), vc.float(),
                    torch.zeros((), device=vc.device))
    acc = torch.einsum("bgmt,bgtr->bgmr", p, v)
    out = acc / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, H, -1).to(qc.dtype)
