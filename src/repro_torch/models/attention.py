"""Attention for the dense family: prefill, cached decode, compression.

Torch counterpart of the dense subset of ``repro.models.attention`` with
the same tensor layouts at every public function: q ``(B, H, S, dh)``,
caches ``(B, Hkv, T, R)``, page pools ``(P, Hkv, page_size, R)``,
compressed queries ``(B, H, R)``.

* ``causal_attention`` is masked causal attention as plain f32 matmul and
  softmax — what the reference's lax ``blockwise_attention`` computes for
  prefill and calibration (a Hopper flash kernel, K6, replaces it later);
* ``decode_attention`` is one-token attention over a full cache, and
  ``chunk_decode_attention`` a chunk of queries over one;
* the compressed decode path scores with ``(q B_q)(K A_k)^T`` and maps
  values out with ``C_v``, which absorbs ``W^O``: over the dense cache in
  K3, over the paged cache in K1; a chunk of a chunked prefill attends
  the pages in K2 (``repro_torch.kernels.kq_decode``).

A ``block_table`` (B, n_pages) selects the paged cache: new entries are
written through it into the pools (``serving.paged_cache``), and without
projections attention reads the gathered pages with the plain functions
above, as the reference's lax path does.

Caches are updated in place (the reference returns new arrays): a decode
step or a prefill chunk writes into the tensors it was given and returns
the same dict.  Softmax statistics are f32 whatever the activation type.
Sliding windows and quantized caches belong to later slices of the port
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.kq_decode import (kq_decode_attention,
                                           kq_decode_paged_attention,
                                           kq_prefill_paged_attention)
from repro_torch.models.layers import apply_rope, init_dense
from repro_torch.serving.paged_cache import (append_chunk, append_token,
                                             gather_pages)

NEG_INF = -1e30


def _unsupported(cfg: ModelConfig) -> None:
    if cfg.sliding_window:
        raise NotImplementedError(
            "sliding-window attention is not ported yet (ROADMAP.md queue "
            "1, models off the main path)")
    if cfg.cache_quant != "none":
        raise NotImplementedError(
            f"cache_quant={cfg.cache_quant!r} is not ported yet (ROADMAP.md "
            f"queue 1, page layouts and quantized caches)")


def batched_positions(pos, batch: int, device) -> torch.Tensor:
    """Normalize a decode position argument to a (B,) int64 tensor;
    scalars broadcast."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=device)
    if pos.ndim == 0:
        pos = pos.expand(batch)
    if tuple(pos.shape) != (batch,):
        raise ValueError(f"positions of shape {tuple(pos.shape)} for a "
                         f"batch of {batch}")
    return pos


def scatter_time(cache: torch.Tensor, val: torch.Tensor,
                 slot: torch.Tensor) -> torch.Tensor:
    """Write one time slot per sequence, in place.

    cache: (B, Hkv, T, R); val: (B, Hkv, 1, R); slot: (B,) destination
    index of each sequence."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, slot] = val[:, :, 0].to(cache.dtype)
    return cache


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Masked causal GQA attention in f32.  q: (B,H,S,dh); k/v:
    (B,Hkv,S,*) -> (B,H,S,dv) in q's type."""
    B, H, S, dh = q.shape
    Hkv = k.shape[1]
    m = H // Hkv
    scale = scale or 1.0 / math.sqrt(dh)
    qg = q.reshape(B, Hkv, m, S, dh).float()
    s = torch.einsum("bgmsd,bgtd->bgmst", qg, k.float()) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgmst,bgtd->bgmsd", p, v.float())
    return out.reshape(B, H, S, -1).to(q.dtype)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, valid_mask: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """q: (B,H,1,dk); cache_k/v: (B,Hkv,T,*); valid_mask: (B,T) ->
    (B,Hkv,m,rv) in the cache's type."""
    B, H, _, dk = q.shape
    Hkv = cache_k.shape[1]
    m = H // Hkv
    qg = q.reshape(B, Hkv, m, dk).float()
    s = torch.einsum("bgmd,bgtd->bgmt", qg, cache_k.float()) * scale
    s = s.masked_fill(~valid_mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgmt,bgtr->bgmr", p.to(cache_v.dtype), cache_v)


def chunk_decode_attention(qg: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, qpos: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """A chunk of S queries over a cache whose entries for the chunk are
    already written.  qg: (B,Hkv,m,S,dk); cache_k/v: (B,Hkv,T,*); qpos:
    (B,S) per-query positions, query s of row b attending t <= qpos[b, s]
    -> (B,Hkv,m,S,rv) in the cache's type."""
    T = cache_k.shape[2]
    s = torch.einsum("bgmsd,bgtd->bgmst", qg.float(), cache_k.float()) \
        * scale
    mask = torch.arange(T, device=qg.device)[None, None, :] \
        <= qpos[:, :, None]                                   # (B,S,T)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgmst,bgtr->bgmsr", p.to(cache_v.dtype), cache_v)


# ---------------------------------------------------------------------------
# Attention layer (params + modes)
# ---------------------------------------------------------------------------


def padded_heads(cfg: ModelConfig) -> int:
    """Query-head count after TP padding (``qhead_pad`` or n_heads)."""
    return cfg.qhead_pad or cfg.n_heads


def head_mask(cfg: ModelConfig) -> Optional[np.ndarray]:
    """(Hp,) mask of real query heads under group-preserving padding
    (``qhead_pad``): each kv group pads from m to m_p query heads with
    zero weights, so the padded model computes the unpadded function."""
    Hp, H = padded_heads(cfg), cfg.n_heads
    if Hp == H:
        return None
    Hkv = cfg.n_kv_heads
    m, m_p = H // Hkv, Hp // Hkv
    return ((np.arange(Hp) % m_p) < m).astype(np.float32)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> Dict[str, torch.Tensor]:
    """Init q/k/v/o projections (pad query heads zeroed)."""
    D, Hkv, dh = cfg.d_model, cfg.n_kv_heads, cfg.d_head
    Hp = padded_heads(cfg)
    p = {
        "wq": init_dense(gen, (D, Hp, dh), D, dtype, device),
        "wk": init_dense(gen, (D, Hkv, dh), D, dtype, device),
        "wv": init_dense(gen, (D, Hkv, dh), D, dtype, device),
        "wo": init_dense(gen, (Hp, dh, D), Hp * dh, dtype, device),
    }
    mask = head_mask(cfg)
    if mask is not None:
        mk = torch.as_tensor(mask, dtype=dtype, device=device)
        p["wq"] = p["wq"] * mk[None, :, None]
        p["wo"] = p["wo"] * mk[:, None, None]
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bhse"): x (B,S,D), w (D,H,e) -> (B,H,S,e)."""
    B, S, _ = x.shape
    D, H, e = w.shape
    return (x @ w.reshape(D, H * e)).reshape(B, S, H, e).transpose(1, 2)


def _qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Project + rope.  x: (B,S,D) -> q (B,H,S,dh), k/v (B,Hkv,S,dh)."""
    q = apply_rope(_project(x, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, p["wk"]), positions, cfg.rope_theta)
    v = _project(x, p["wv"])
    return q, k, v


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bhse,hed->bsd"): o (B,H,S,e), wo (H,e,D) -> (B,S,D)."""
    B, H, S, e = o.shape
    return o.transpose(1, 2).reshape(B, S, H * e) @ wo.reshape(H * e, -1)


def attn_calibrate(p, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal attention plus the post-RoPE q/k/v captures of the KQ-SVD
    calibration pass (pad query heads excluded from the captures)."""
    _unsupported(cfg)
    S = x.shape[1]
    q, k, v = _qkv(p, x, cfg, torch.arange(S, device=x.device))
    y = _out(causal_attention(q, k, v), p["wo"])
    if padded_heads(cfg) != cfg.n_heads:
        Hkv = cfg.n_kv_heads
        m, m_p = cfg.n_heads // Hkv, padded_heads(cfg) // Hkv
        B_, _, S_, dh_ = q.shape
        q = q.reshape(B_, Hkv, m_p, S_, dh_)[:, :, :m].reshape(
            B_, cfg.n_heads, S_, dh_)
    return y, {"k": k, "q": q, "v": v}


def group_output_weights(p, cfg: ModelConfig) -> np.ndarray:
    """W^O stacked per kv group: (Hkv, dh, m*D) float64 on the host, for
    the value-path solve (pad query heads excluded)."""
    wo = p["wo"].detach().float().cpu().numpy().astype(np.float64)
    Hp, dh, D = wo.shape
    Hkv = cfg.n_kv_heads
    m, m_p = cfg.n_heads // Hkv, Hp // Hkv
    wo = wo.reshape(Hkv, m_p, dh, D)[:, :m]
    return wo.transpose(0, 2, 1, 3).reshape(Hkv, dh, m * D)


def make_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    proj_rank: Tuple[int, int] = (0, 0),
                    dtype=torch.bfloat16, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Empty (zeroed) cache for one attention layer: ``kc``/``vc``
    (B, Hkv, T, R) with projections, else ``k``/``v`` (B, Hkv, T, dh).
    With (batch, max_len) read as (pages, page_size) these are the page
    pools (P, Hkv, ps, R) of the paged cache: the fp page layout, the
    only one ported, has the dense leaves' shapes."""
    _unsupported(cfg)
    Hkv = cfg.n_kv_heads
    rk, rv = proj_rank
    if rk:
        return {"kc": torch.zeros(batch, Hkv, max_len, rk, dtype=dtype,
                                  device=device),
                "vc": torch.zeros(batch, Hkv, max_len, rv, dtype=dtype,
                                  device=device)}
    return {"k": torch.zeros(batch, Hkv, max_len, cfg.d_head, dtype=dtype,
                             device=device),
            "v": torch.zeros(batch, Hkv, max_len, cfg.d_head, dtype=dtype,
                             device=device)}


def attn_prefill(p, x: torch.Tensor, cfg: ModelConfig, max_len: int,
                 proj: Optional[Dict] = None):
    """Full-sequence attention; returns output and a length-``max_len``
    cache holding the prompt's (compressed) entries at [0, S)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, torch.arange(S, device=x.device))
    y = _out(causal_attention(q, k, v), p["wo"])
    ranks = ((proj["a_k"].shape[-1], proj["a_v"].shape[-1]) if proj
             else (0, 0))
    cache = make_attn_cache(cfg, B, max_len, ranks, x.dtype, x.device)
    if proj is not None:
        cache["kc"][:, :, :S] = torch.einsum("bhtd,hdr->bhtr", k,
                                             proj["a_k"])
        cache["vc"][:, :, :S] = torch.einsum("bhtd,hdr->bhtr", v,
                                             proj["a_v"])
    else:
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
    return y, cache


def attn_prefill_chunk(p, x: torch.Tensor, cache: Dict, pos0: torch.Tensor,
                       cfg: ModelConfig, proj: Optional[Dict] = None,
                       block_table: Optional[torch.Tensor] = None,
                       valid: Optional[torch.Tensor] = None):
    """One bucket-padded prompt chunk straight into pages.

    x: (B,S,D) chunk whose first token sits at position ``pos0[b]``;
    ``valid``: (B,S) bool of real (non-padding) tokens, a contiguous
    prefix per row, or a (B,) count of them.  The chunk's (compressed)
    k/v entries are written through ``block_table`` into the pools in
    place (padding goes to the garbage page); then its queries attend
    the written pages, earlier chunks and its own, causally by position:
    in K2 with projections, over the gathered pages without.  Padding
    queries give garbage rows that the caller drops."""
    if block_table is None:
        raise ValueError("attn_prefill_chunk requires a paged cache "
                         "(block_table)")
    _unsupported(cfg)
    B, S, _ = x.shape
    dh = cfg.d_head
    scale = 1.0 / math.sqrt(dh)
    pos0 = batched_positions(pos0, B, x.device)
    if valid is None:
        valid = torch.ones((B, S), dtype=torch.bool, device=x.device)
    n_valid = valid if valid.ndim == 1 else valid.sum(dim=1)
    positions = pos0[:, None] + torch.arange(S, device=x.device)[None, :]
    q, k_new, v_new = _qkv(p, x, cfg, positions[:, None, :])
    lengths = (pos0 + n_valid).to(torch.int32)
    Hkv = cfg.n_kv_heads
    Hp = padded_heads(cfg)
    m_p = Hp // Hkv
    qg = q.reshape(B, Hkv, m_p, S, dh)
    if proj is not None:
        kc = append_chunk(cache["kc"], block_table, pos0,
                          torch.einsum("bhtd,hdr->bhtr", k_new, proj["a_k"]),
                          valid)
        vc = append_chunk(cache["vc"], block_table, pos0,
                          torch.einsum("bhtd,hdr->bhtr", v_new, proj["a_v"]),
                          valid)
        qc = torch.einsum("bgmsd,gdr->bgmsr", qg, proj["b_q"])
        agg = kq_prefill_paged_attention(
            qc.reshape(B, Hp, S, -1).contiguous(), kc, vc, lengths,
            pos0.to(torch.int32), block_table, scale=scale
        ).reshape(B, Hkv, m_p, S, -1)
        m = cfg.n_heads // Hkv                 # real heads (c_v is real-m)
        c_v = proj["c_v"].reshape(Hkv, -1, m, cfg.d_model)
        y = torch.einsum("bgmsr,grmd->bsd", agg[:, :, :m], c_v)
    else:
        kk = append_chunk(cache["k"], block_table, pos0, k_new, valid)
        vv = append_chunk(cache["v"], block_table, pos0, v_new, valid)
        agg = chunk_decode_attention(qg, gather_pages(kk, block_table),
                                     gather_pages(vv, block_table),
                                     positions, scale)
        y = _out(agg.reshape(B, Hp, S, dh), p["wo"])
    return y.to(x.dtype), cache


def attn_decode(p, x: torch.Tensor, cache: Dict, pos: torch.Tensor,
                cfg: ModelConfig, proj: Optional[Dict] = None,
                block_table: Optional[torch.Tensor] = None):
    """One-token decode.  x: (B,1,D); pos: (B,) per-sequence index of the
    new token.  Writes the token's (compressed) entry into ``cache`` in
    place and attends positions ``<= pos[b]``; with projections the
    attention runs in K3 over the dense cache, in K1 over the paged one.
    ``block_table`` (B, n_pages) selects the paged cache: the entry is
    written through it into the pools, and without projections attention
    reads the gathered pages."""
    _unsupported(cfg)
    B = x.shape[0]
    scale = 1.0 / math.sqrt(cfg.d_head)
    q, k_new, v_new = _qkv(p, x, cfg, pos[:, None, None])     # S = 1
    Hkv = cfg.n_kv_heads
    Hp = padded_heads(cfg)
    paged = block_table is not None
    if proj is not None:
        k_st = torch.einsum("bhtd,hdr->bhtr", k_new, proj["a_k"])
        v_st = torch.einsum("bhtd,hdr->bhtr", v_new, proj["a_v"])
        if paged:
            append_token(cache["kc"], block_table, pos, k_st[:, :, 0])
            append_token(cache["vc"], block_table, pos, v_st[:, :, 0])
        else:
            scatter_time(cache["kc"], k_st, pos)
            scatter_time(cache["vc"], v_st, pos)
        qg = q.reshape(B, Hkv, Hp // Hkv, cfg.d_head)
        qc = torch.einsum("bgmd,gdr->bgmr", qg, proj["b_q"]).reshape(
            B, Hp, -1).contiguous()
        vc = cache["vc"]
        lengths = (pos + 1).to(torch.int32)
        agg = (kq_decode_paged_attention(qc, cache["kc"], vc, lengths,
                                         block_table, scale=scale)
               if paged else
               kq_decode_attention(qc, cache["kc"], vc, lengths,
                                   scale=scale)
               ).reshape(B, Hkv, Hp // Hkv, vc.shape[-1])
        m = cfg.n_heads // Hkv                 # real heads (c_v is real-m)
        c_v = proj["c_v"].reshape(Hkv, -1, m, cfg.d_model)
        y = torch.einsum("bgmr,grmd->bd", agg[:, :, :m], c_v)[:, None, :]
    else:
        if paged:
            append_token(cache["k"], block_table, pos, k_new[:, :, 0])
            append_token(cache["v"], block_table, pos, v_new[:, :, 0])
            keys = gather_pages(cache["k"], block_table)
            vals = gather_pages(cache["v"], block_table)
        else:
            keys = scatter_time(cache["k"], k_new, pos)
            vals = scatter_time(cache["v"], v_new, pos)
        T = keys.shape[2]
        valid = torch.arange(T, device=x.device)[None, :] <= pos[:, None]
        agg = decode_attention(q, keys, vals, valid, scale)
        y = _out(agg.reshape(B, Hp, 1, cfg.d_head), p["wo"])
    return y.to(x.dtype), cache
