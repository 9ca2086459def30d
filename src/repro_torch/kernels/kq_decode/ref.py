"""Plain PyTorch versions of K1-K5, the compressed-cache attention kernels
(reference: ``src/repro/kernels/kq_decode/ref.py``).

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


def kq_decode_attention_span_ref(qc: torch.Tensor, kc: torch.Tensor,
                                 vc: torch.Tensor, lengths: torch.Tensor, *,
                                 scale: float = 1.0):
    """Plain version of K3's span output: over one span of a cache (its
    first ``lengths[b]`` entries live), the float32 rows
    ``acc / max(l, 1e-30)`` (B,H,Rv) and their log-sum-exp
    ``max + log(max(l, 1e-30))`` (B,H), the form of K4's split partials.
    An empty span (length 0) gives a zero row and an LSE of
    ``-1e30 + log(1e-30)``, which the merge weighs 0 beside any live
    span."""
    B, H, Rk = qc.shape
    Hkv, T = kc.shape[1], kc.shape[2]
    m = H // Hkv
    lengths = _per_row(lengths, B, qc.device)
    qg = qc.reshape(B, Hkv, m, Rk).float()
    s = torch.einsum("bgmr,bgtr->bgmt", qg, kc.float()) * scale
    valid = (torch.arange(T, device=qc.device)[None, :]
             < lengths[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - mx), torch.zeros_like(s))
    v = torch.where(valid.reshape(B, 1, T, 1), vc.float(),
                    torch.zeros((), device=vc.device))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgmt,bgtr->bgmr", p, v) / den
    lse = (mx + torch.log(den))[..., 0]
    return out.reshape(B, H, -1), lse.reshape(B, H)


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


def kq_decode_paged_attention_int8_ref(qc: torch.Tensor, kc_pool: torch.Tensor,
                                       vc_pool: torch.Tensor,
                                       kscale: torch.Tensor,
                                       vscale: torch.Tensor, lengths,
                                       block_table: torch.Tensor, *,
                                       scale: float = 1.0) -> torch.Tensor:
    """Plain version of K5 unsplit: dequantize the int8 pools in float32
    (``code * per-token scale``), then K1's plain version.

    kc_pool/vc_pool: (P,Hkv,ps,R) int8; kscale/vscale: (P,Hkv,ps,1)
    bf16 -> (B,H,Rv) in qc's type."""
    return kq_decode_paged_attention_ref(
        qc, kc_pool.float() * kscale.float(),
        vc_pool.float() * vscale.float(), lengths, block_table, scale=scale)


def resolve_splits(num_splits: int, n_pages: int):
    """(splits, span in pages) of the split-KV decode over a block table
    ``n_pages`` wide, as the reference resolves them: clamp to the page
    count, take ``span = ceil(n_pages / n)``, then drop the trailing
    splits that would start past the table (n_pages 8, 3 splits -> span
    3, 3 splits; n_pages 4, 3 splits -> span 2, 2 splits)."""
    n = max(1, min(int(num_splits), int(n_pages)))
    span = -(-n_pages // n)
    return -(-n_pages // span), span


def kq_decode_paged_attention_split_ref(qc: torch.Tensor,
                                        kc_pool: torch.Tensor,
                                        vc_pool: torch.Tensor, lengths,
                                        block_table: torch.Tensor, *,
                                        num_splits: int,
                                        scale: float = 1.0) -> torch.Tensor:
    """Split-KV oracle, written independently of the combine helper so
    the two can be held against each other: per span of pages a masked
    softmax aggregate and its log-sum-exp, merged with
    ``w_s = exp(lse_s - max_s lse_s)``.  Equals
    ``kq_decode_paged_attention_ref`` to float tolerance for every length
    and split count.  (B,H,Rk) -> (B,H,Rv) in qc's type."""
    B, H, Rk = qc.shape
    Hkv, ps = kc_pool.shape[1], kc_pool.shape[2]
    m = H // Hkv
    kc = gather_pages(kc_pool, block_table).float()         # (B,Hkv,T,Rk)
    vc = gather_pages(vc_pool, block_table).float()
    T = kc.shape[2]
    lengths = _per_row(lengths, B, qc.device)
    n, span = resolve_splits(num_splits, block_table.shape[1])
    qg = qc.reshape(B, Hkv, m, Rk).float()
    t = torch.arange(T, device=qc.device)
    outs, lses = [], []
    for s_idx in range(n):
        lo, hi = s_idx * span * ps, min((s_idx + 1) * span * ps, T)
        sc = torch.einsum("bgmr,bgtr->bgmt", qg, kc[:, :, lo:hi]) * scale
        valid = (t[lo:hi][None, :] < lengths[:, None])[:, None, None, :]
        sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
        mx = sc.amax(dim=-1)
        p = torch.where(valid, torch.exp(sc - mx[..., None]),
                        torch.zeros_like(sc))
        den = p.sum(dim=-1).clamp_min(1e-30)
        # dead rows zeroed: p is 0 there, but 0 * NaN would still be NaN
        v = torch.where(valid[:, :, 0, :, None], vc[:, :, lo:hi],
                        torch.zeros((), device=vc.device))
        outs.append(torch.einsum("bgmt,bgtr->bgmr", p, v) / den[..., None])
        lses.append(torch.where(p.sum(dim=-1) > 0, mx + torch.log(den),
                                torch.full_like(mx, NEG_INF)))
    o = torch.stack(outs, dim=-3)                             # (B,Hkv,n,m,Rv)
    lse = torch.stack(lses, dim=-2)                           # (B,Hkv,n,m)
    w = torch.exp(lse - lse.amax(dim=-2, keepdim=True))
    out = (w[..., None] * o).sum(dim=-3) \
        / w.sum(dim=-2).clamp_min(1e-30)[..., None]
    return out.reshape(B, H, -1).to(qc.dtype)


def kq_decode_paged_partials_ref(qc: torch.Tensor, kc_pool: torch.Tensor,
                                 vc_pool: torch.Tensor, lengths,
                                 block_table: torch.Tensor, *, span: int,
                                 n_splits: int, scale: float = 1.0,
                                 kscale=None, vscale=None):
    """Plain version of K4 (and, with scales, of K5 split) before the
    merge: the f32 partials the kernel writes for spans of ``span`` pages,
    ``out_s = acc / max(l, 1e-30)`` (B,Hkv,n,m,Rv) and
    ``lse_s = m + log(max(l, 1e-30))`` (B,Hkv,n,m).  An empty span gives
    out 0 and lse ``-1e30 + log(1e-30)``, as in the kernel.  Lengths past
    the table's capacity are clamped to it, as in the kernel.  Int8 pools
    are dequantized (gathered first: the same products) before the dot."""
    B, H, Rk = qc.shape
    Hkv, ps = kc_pool.shape[1], kc_pool.shape[2]
    m = H // Hkv
    kc = gather_pages(kc_pool, block_table).float()
    vc = gather_pages(vc_pool, block_table).float()
    if kscale is not None:
        kc = kc * gather_pages(kscale, block_table).float()
        vc = vc * gather_pages(vscale, block_table).float()
    T = kc.shape[2]
    L = n_splits * span * ps                  # >= T: the last span padded
    kc = torch.nn.functional.pad(kc, (0, 0, 0, L - T))
    vc = torch.nn.functional.pad(vc, (0, 0, 0, L - T))
    lengths = _per_row(lengths, B, qc.device).clamp(0, T)
    qg = qc.reshape(B, Hkv, m, Rk).float()
    s = torch.einsum("bgmr,bgstr->bgsmt", qg,
                     kc.reshape(B, Hkv, n_splits, span * ps, Rk)) * scale
    valid = (torch.arange(L, device=qc.device)[None, :]
             < lengths[:, None]).reshape(B, 1, n_splits, 1, span * ps)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    mx = s.amax(dim=-1)                                       # (B,Hkv,n,m)
    p = torch.where(valid, torch.exp(s - mx[..., None]), torch.zeros_like(s))
    den = p.sum(dim=-1).clamp_min(1e-30)
    v = torch.where(valid.reshape(B, 1, n_splits, span * ps, 1),
                    vc.reshape(B, Hkv, n_splits, span * ps, -1),
                    torch.zeros((), device=vc.device))
    o = torch.einsum("bgsmt,bgstr->bgsmr", p, v) / den[..., None]
    return o, mx + torch.log(den)
