"""Plain PyTorch versions of K3, K1 and K2, the compressed-cache
attention kernels (reference: ``src/repro/kernels/kq_decode/ref.py``).

The same functions as the CUDA kernels in ``csrc/kq_decode.cu`` and
``csrc/kq_paged.cu``, written with tensor ops: the CPU tests use them,
the wrappers take them for tensors on the CPU, and ``chip_smoke.py``
holds the kernels against them on the card.  They follow the kernels
(and the reference's Pallas kernels), not the reference's jnp oracles,
where they differ: a query that sees no cache entry (length 0) gets
``acc / max(sum, 1e-30) = 0`` rather than a uniform average over the
masked cache.
"""
from __future__ import annotations

import torch

from repro_torch.serving.paged_cache import gather_pages

NEG_INF = -1e30


def _per_row(x, batch: int, device) -> torch.Tensor:
    """A (B,) int32 tensor from a per-row argument; scalars broadcast."""
    x = torch.as_tensor(x, dtype=torch.int32, device=device)
    return x.expand(batch) if x.ndim == 0 else x


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
    lengths = _per_row(lengths, B, qc.device)
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


def kq_decode_paged_attention_ref(qc: torch.Tensor, kc_pool: torch.Tensor,
                                  vc_pool: torch.Tensor, lengths,
                                  block_table: torch.Tensor, *,
                                  scale: float = 1.0) -> torch.Tensor:
    """Plain version of K1, the paged compressed decode: gather each
    slot's pages, then K3's plain version.

    qc: (B,H,Rk); kc_pool/vc_pool: (P,Hkv,ps,R); block_table:
    (B, n_pages) int32 -> (B,H,Rv)."""
    return kq_decode_attention_ref(qc, gather_pages(kc_pool, block_table),
                                   gather_pages(vc_pool, block_table),
                                   lengths, scale=scale)


def kq_prefill_paged_attention_ref(qc: torch.Tensor, kc_pool: torch.Tensor,
                                   vc_pool: torch.Tensor, lengths, pos0,
                                   block_table: torch.Tensor, *,
                                   scale: float = 1.0) -> torch.Tensor:
    """Plain version of K2, the paged prefill-append attention.

    qc: (B,H,S,Rk), query ``s`` of row ``b`` at position ``pos0[b] + s``;
    it attends cache positions ``t <= pos0[b] + s`` and ``t < lengths[b]``
    (a bucket-padding query, ``pos0[b] + s >= lengths[b]``, sees the whole
    prefix).  A query that sees nothing (length 0) gets 0, as in K3.
    Returns (B,H,S,Rv) in ``qc``'s type; f32 arithmetic."""
    B, H, S, Rk = qc.shape
    Hkv = kc_pool.shape[1]
    m = H // Hkv
    kc = gather_pages(kc_pool, block_table).float()       # (B,Hkv,T,Rk)
    vc = gather_pages(vc_pool, block_table).float()
    T = kc.shape[2]
    lengths = _per_row(lengths, B, qc.device)
    pos0 = _per_row(pos0, B, qc.device)
    qg = qc.reshape(B, Hkv, m, S, Rk).float()
    s = torch.einsum("bgmsr,bgtr->bgmst", qg, kc) * scale
    qpos = pos0[:, None] + torch.arange(S, device=qc.device)[None, :]
    t = torch.arange(T, device=qc.device)
    mask = ((t[None, None, :] <= qpos[:, :, None])
            & (t[None, None, :] < lengths[:, None, None]))[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                    torch.zeros_like(s))
    # dead rows zeroed: p is 0 there, but 0 * NaN would still be NaN
    live = (t[None, :] < lengths[:, None])[:, None, :, None]   # (B,1,T,1)
    v = torch.where(live, vc, torch.zeros((), device=vc.device))
    acc = torch.einsum("bgmst,bgtr->bgmsr", p, v)
    out = acc / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, H, S, -1).to(qc.dtype)
