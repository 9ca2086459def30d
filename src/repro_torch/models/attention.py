"""Attention for the dense family: prefill, cached decode, compression.

Torch counterpart of the dense subset of ``repro.models.attention`` with
the same tensor layouts at every public function: q ``(B, H, S, dh)``,
caches ``(B, Hkv, T, R)``, page pools ``(P, Hkv, page_size, R)``,
compressed queries ``(B, H, R)``.

* full-sequence causal attention, with the sliding window where the
  config has one, runs in K6 (``repro_torch.kernels.flash``) under
  ``attn_prefill`` and ``attn_calibrate``: what the reference's lax
  ``blockwise_attention`` computes there;
* ``decode_attention`` is one-token attention over a full cache, and
  ``chunk_decode_attention`` a chunk of queries over one;
* ``split_decode_attention``, ``int8_decode_attention`` and
  ``int8_split_decode_attention`` are the reference's lax decode twins
  for split-KV and the int8 cache, as plain PyTorch;
* the compressed decode path scores with ``(q B_q)(K A_k)^T`` and maps
  values out with ``C_v``, which absorbs ``W^O``: over the dense cache in
  K3, over the paged cache in K1, split-KV (``num_splits`` > 1) in K4,
  over int8 pages in K5; a chunk of a chunked prefill attends fp pages in
  K2 (``repro_torch.kernels.kq_decode``).

A ``block_table`` (B, n_pages) selects the paged cache: new entries are
written through it into the pools (``serving.paged_cache``), and without
projections attention reads the gathered pages with the plain functions
above, as the reference's lax path does.  With projections the pages
follow the page layout that ``cfg.cache_quant`` selects
(``serving.page_layouts``): fp, int8 with scale pools, or SVDq.  The
reference has no kernel for SVDq pages, nor for a prefill chunk over
quantized pages, nor for the dense int8 cache (``cfg.cache_quant`` int8
without pages): those read gathered, decoded pages with the plain
functions, as the reference does.

A sliding window (``cfg.sliding_window`` = W) makes the dense cache a
ring of ``min(max_len, W)`` slots: position p lives in slot ``p % W`` and
``slot_pos`` (B, T) records which position each slot holds (-1: empty);
decode attends the slots with ``slot_pos >= 0`` and ``slot_pos > pos -
W``, through the plain ``decode_attention`` (``int8_decode_attention``
for the dense int8 cache), as the reference routes it (its K3 branch is
``and not W``).  The paged store and chunked prefill take no window and
raise ``NotImplementedError``, as the reference does.

Caches are updated in place (the reference returns new arrays): a decode
step or a prefill chunk writes into the tensors it was given and returns
the same dict.  Softmax statistics are f32 whatever the activation type.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash import flash_attention
from repro_torch.kernels.kq_decode import (kq_decode_attention,
                                           kq_decode_paged_attention,
                                           kq_prefill_paged_attention)
from repro_torch.models.layers import apply_rope, init_dense
from repro_torch.serving.page_layouts import get_layout, quantize_int8
from repro_torch.serving.paged_cache import (append_chunk, append_token,
                                             gather_pages)

NEG_INF = -1e30


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

    cache: (B, Hkv, T, R) (or (B, Hkv, T), a scale plane); val: the same
    with T = 1; slot: (B,) destination index of each sequence."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, slot] = val[:, :, 0].to(cache.dtype)
    return cache


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


def _segments(s: torch.Tensor, vm: torch.Tensor, num_splits: int):
    """Split the time axis of scores ``s`` (B,Hkv,m,T) and their mask
    ``vm`` (B,T) into S contiguous segments as the reference does
    (``S = min(num_splits, T)``, ``seg = ceil(T / S)``, trailing empty
    segments dropped), padding the last one: -> scores (B,Hkv,m,S,seg),
    mask (B,1,1,S,seg), and the padding width."""
    B, Hkv, m, T = s.shape
    S = max(1, min(int(num_splits), T))
    seg = -(-T // S)
    S = -(-T // seg)
    pad = S * seg - T
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF).reshape(
        B, Hkv, m, S, seg)
    vmp = torch.nn.functional.pad(vm, (0, pad)).reshape(B, 1, 1, S, seg)
    return s, vmp, S, seg, pad


def _merge_segments(p: torch.Tensor, mx: torch.Tensor, o_un: torch.Tensor
                    ) -> torch.Tensor:
    """Per-segment probabilities ``p`` (B,Hkv,m,S,seg) with their max
    ``mx`` (B,Hkv,m,S) and unnormalized aggregates ``o_un``
    (B,Hkv,m,S,R) -> the log-sum-exp merge over segments (B,Hkv,m,R),
    float32.  An empty segment (no valid token) has lse -1e30 and weight
    0 beside any live one."""
    l = p.sum(dim=-1)
    den = l.clamp_min(1e-30)
    o = o_un.float() / den[..., None]
    lse = torch.where(l > 0, mx + torch.log(den), torch.full_like(mx, NEG_INF))
    w = torch.exp(lse - lse.amax(dim=-1, keepdim=True))
    num = (w[..., None] * o).sum(dim=-2)
    return num / w.sum(dim=-1).clamp_min(1e-30)[..., None]


def split_decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, valid_mask: torch.Tensor,
                           scale: float, num_splits: int) -> torch.Tensor:
    """Split-KV twin of ``decode_attention`` (reference
    ``split_decode_attention``): the time axis is cut into ``num_splits``
    segments, each gives a partial (out, LSE) pair, and the pairs merge
    by the log-sum-exp rule.  q: (B,H,1,dk); cache_k/v: (B,Hkv,T,*);
    valid_mask: (B,T) -> (B,Hkv,m,rv) in the cache's type."""
    B, H, _, dk = q.shape
    Hkv = cache_k.shape[1]
    m = H // Hkv
    qg = q.reshape(B, Hkv, m, dk).float()
    s = torch.einsum("bgmd,bgtd->bgmt", qg, cache_k.float()) * scale
    s = s.masked_fill(~valid_mask[:, None, None, :], NEG_INF)
    s, vmp, S, seg, pad = _segments(s, valid_mask, num_splits)
    v = torch.nn.functional.pad(cache_v.float(), (0, 0, 0, pad)).reshape(
        B, Hkv, S, seg, -1)
    mx = s.amax(dim=-1)                                      # (B,Hkv,m,S)
    p = torch.where(vmp, torch.exp(s - mx[..., None]), torch.zeros_like(s))
    agg = _merge_segments(p, mx, torch.einsum("bgmst,bgstr->bgmsr", p, v))
    return agg.to(cache_v.dtype)


def int8_decode_attention(qg: torch.Tensor, k8: torch.Tensor,
                          v8: torch.Tensor, kscale: torch.Tensor,
                          vscale: torch.Tensor, valid: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Decode over the dense int8 cache (reference
    ``int8_decode_attention``): scores from the int8 keys scaled per
    token, the probability mass pre-multiplied by the value scales, the
    value product in bf16.  No kernel in the reference: plain PyTorch.

    qg: (B,Hkv,m,R); k8/v8: (B,Hkv,T,R) int8; kscale/vscale: (B,Hkv,T);
    valid: (B,T) -> (B,Hkv,m,R) bf16."""
    s = torch.einsum("bgmr,bgtr->bgmt", qg.float(), k8.float()) * scale
    s = s * kscale.float()[:, :, None, :]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    pv = torch.softmax(s, dim=-1) * vscale.float()[:, :, None, :]
    return torch.einsum("bgmt,bgtr->bgmr", pv.to(torch.bfloat16),
                        v8.to(torch.bfloat16))


def int8_split_decode_attention(qg: torch.Tensor, k8: torch.Tensor,
                                v8: torch.Tensor, kscale: torch.Tensor,
                                vscale: torch.Tensor, valid: torch.Tensor,
                                scale: float, num_splits: int
                                ) -> torch.Tensor:
    """Split-KV twin of ``int8_decode_attention`` (reference
    ``int8_split_decode_attention``): the segment / partial-LSE / merge
    algebra of ``split_decode_attention`` over the int8 math.  The port's
    paged int8 decode runs K5 instead; this is the reference's lax route,
    kept as its plain counterpart.  Shapes as ``int8_decode_attention``."""
    B, Hkv, m, _ = qg.shape
    s = torch.einsum("bgmr,bgtr->bgmt", qg.float(), k8.float()) * scale
    s = s * kscale.float()[:, :, None, :]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    s, vmp, S, seg, pad = _segments(s, valid, num_splits)
    vs = torch.nn.functional.pad(vscale.float(), (0, pad)).reshape(
        B, Hkv, 1, S, seg)
    v = torch.nn.functional.pad(v8, (0, 0, 0, pad)).reshape(
        B, Hkv, S, seg, -1).to(torch.bfloat16)
    mx = s.amax(dim=-1)
    p = torch.where(vmp, torch.exp(s - mx[..., None]), torch.zeros_like(s))
    pv = (p * vs).to(torch.bfloat16)
    agg = _merge_segments(p, mx, torch.einsum("bgmst,bgstr->bgmsr", pv, v))
    return agg.to(torch.bfloat16)


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
    S = x.shape[1]
    q, k, v = _qkv(p, x, cfg, torch.arange(S, device=x.device))
    y = _out(flash_attention(q, k, v, window=cfg.sliding_window), p["wo"])
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
                    dtype=torch.bfloat16, device=None, paged: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """Empty (zeroed) cache for one attention layer: ``kc``/``vc``
    (B, Hkv, T, R) with projections, else ``k``/``v`` (B, Hkv, T, dh);
    with ``cfg.cache_quant == "int8"`` the compressed leaves are int8
    with (B, Hkv, T) bf16 ``kscale``/``vscale`` planes (the dense int8
    cache).  ``paged=True`` reads (batch, max_len) as (pages, page_size)
    and, with projections, builds the pools (P, Hkv, ps, width) of the
    page layout ``cfg.cache_quant`` selects: fp data pages (the dense
    leaves' shapes), or int8 / packed data pages plus width-1 bf16 scale
    pools.  A sliding window W makes the time axis a ring of
    ``T = min(max_len, W)`` slots and adds ``slot_pos`` (B, T) int32, the
    position each slot holds, -1 while it is empty."""
    W = cfg.sliding_window or 0
    T = min(max_len, W) if W else max_len
    Hkv = cfg.n_kv_heads
    rk, rv = proj_rank

    def zeros(*shape, dt=dtype):
        return torch.zeros(*shape, dtype=dt, device=device)

    if paged and rk:
        layout = get_layout(cfg)
        return {name: zeros(batch, Hkv, T, width, dt=ldt or dtype)
                for side, rank in (("k", rk), ("v", rv))
                for name, width, ldt in layout.leaves(side, rank)}
    if not rk:
        cache = {"k": zeros(batch, Hkv, T, cfg.d_head),
                 "v": zeros(batch, Hkv, T, cfg.d_head)}
    elif cfg.cache_quant != "int8":
        cache = {"kc": zeros(batch, Hkv, T, rk),
                 "vc": zeros(batch, Hkv, T, rv)}
    else:
        cache = {"kc": zeros(batch, Hkv, T, rk, dt=torch.int8),
                 "vc": zeros(batch, Hkv, T, rv, dt=torch.int8),
                 "kscale": zeros(batch, Hkv, T, dt=torch.bfloat16),
                 "vscale": zeros(batch, Hkv, T, dt=torch.bfloat16)}
    if W:
        cache["slot_pos"] = torch.full((batch, T), -1, dtype=torch.int32,
                                       device=device)
    return cache


def attn_prefill(p, x: torch.Tensor, cfg: ModelConfig, max_len: int,
                 proj: Optional[Dict] = None):
    """Full-sequence attention (K6 on the card); returns output and a
    length-``max_len`` cache holding the prompt's (compressed, with the
    int8 cache quantized) entries at [0, S).  With a sliding window W the
    cache is the ring of ``make_attn_cache``: the last ``min(S, W)``
    entries go to slots ``pos % W`` and ``slot_pos`` records them."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, torch.arange(S, device=x.device))
    W = cfg.sliding_window or 0
    y = _out(flash_attention(q, k, v, window=W), p["wo"])
    ranks = ((proj["a_k"].shape[-1], proj["a_v"].shape[-1]) if proj
             else (0, 0))
    cache = make_attn_cache(cfg, B, max_len, ranks, x.dtype, x.device)
    first = max(0, S - W) if W else 0          # the entries the cache keeps
    k_st, v_st = k[:, :, first:], v[:, :, first:]
    if proj is not None:
        k_st = torch.einsum("bhtd,hdr->bhtr", k_st, proj["a_k"])
        v_st = torch.einsum("bhtd,hdr->bhtr", v_st, proj["a_v"])
        if cfg.cache_quant == "int8":
            (k_st, ks), (v_st, vs) = quantize_int8(k_st), quantize_int8(v_st)
            updates = {"kc": k_st, "vc": v_st, "kscale": ks, "vscale": vs}
        else:
            updates = {"kc": k_st, "vc": v_st}
    else:
        updates = {"k": k_st, "v": v_st}
    slots = slice(0, S)
    if W:                                      # ring slots of the kept
        kept = torch.arange(first, S, device=x.device)
        slots = kept % W
        cache["slot_pos"][:, slots] = kept.to(torch.int32)
    for name, val in updates.items():
        cache[name][:, :, slots] = val.to(cache[name].dtype)
    return y, cache


def _decoded_pages(layout, cache: Dict, block_table: torch.Tensor,
                   side: str, rank: int) -> torch.Tensor:
    """One side's pages gathered through the table and decoded to float:
    (B, Hkv, n_pages * ps, rank)."""
    return layout.decode(side, {
        name: gather_pages(cache[name], block_table)
        for name, _, _ in layout.leaves(side, rank)}, rank)


def _cv_out(agg: torch.Tensor, c_v: torch.Tensor, eq: str) -> torch.Tensor:
    """``einsum(eq, agg, c_v)`` in the promoted type of the two (float32
    where decoded quantized pages made ``agg`` float32), as the
    reference's einsum promotes."""
    dt = torch.promote_types(agg.dtype, c_v.dtype)
    return torch.einsum(eq, agg.to(dt), c_v.to(dt))


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
    in K2 over fp pages with projections, over the gathered pages
    without.  Over quantized pages every leaf of the layout is written,
    and the queries attend the gathered, decoded pages with
    ``chunk_decode_attention``: the reference's own route (it has no
    kernel there).  Padding queries give garbage rows that the caller
    drops."""
    if block_table is None:
        raise ValueError("attn_prefill_chunk requires a paged cache "
                         "(block_table)")
    if cfg.sliding_window:
        raise NotImplementedError(
            "chunked prefill supports full-attention stacks only "
            "(no sliding window)")
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
        k_st = torch.einsum("bhtd,hdr->bhtr", k_new, proj["a_k"])
        v_st = torch.einsum("bhtd,hdr->bhtr", v_new, proj["a_v"])
        layout = get_layout(cfg)
        for name, val in {**layout.encode("k", k_st),
                          **layout.encode("v", v_st)}.items():
            append_chunk(cache[name], block_table, pos0, val, valid)
        qc = torch.einsum("bgmsd,gdr->bgmsr", qg, proj["b_q"])
        if layout.kernel == "fp":
            agg = kq_prefill_paged_attention(
                qc.reshape(B, Hp, S, -1).contiguous(), cache["kc"],
                cache["vc"], lengths, pos0.to(torch.int32), block_table,
                scale=scale).reshape(B, Hkv, m_p, S, -1)
        else:
            agg = chunk_decode_attention(
                qc, _decoded_pages(layout, cache, block_table, "k",
                                   proj["a_k"].shape[-1]),
                _decoded_pages(layout, cache, block_table, "v",
                               proj["a_v"].shape[-1]), positions, scale)
        m = cfg.n_heads // Hkv                 # real heads (c_v is real-m)
        c_v = proj["c_v"].reshape(Hkv, -1, m, cfg.d_model)
        y = _cv_out(agg[:, :, :m], c_v, "bgmsr,grmd->bsd")
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
                block_table: Optional[torch.Tensor] = None,
                num_splits: int = 1):
    """One-token decode.  x: (B,1,D); pos: (B,) per-sequence index of the
    new token.  Writes the token's (compressed) entry into ``cache`` in
    place and attends positions ``<= pos[b]``.  ``block_table``
    (B, n_pages) selects the paged cache: the entry is written through it
    into the pools (every leaf of the page layout).  With projections the
    attention runs

    * over fp pages in K1, or in K4 with ``num_splits`` > 1;
    * over int8 pages in K5 (split likewise);
    * over SVDq pages on the gathered, decoded pages with the plain
      ``decode_attention`` / ``split_decode_attention`` (no kernel in the
      reference either);
    * over the dense cache in K3, or with ``cfg.cache_quant == "int8"``
      in the plain ``int8_decode_attention``, as in the reference;
    * over the ring cache of a sliding window with the plain
      ``decode_attention`` (``int8_decode_attention`` for the int8
      cache), as the reference routes it.

    Without projections attention reads the (gathered) cache with the
    plain ``decode_attention`` / ``split_decode_attention``.  With a
    sliding window W the token goes to ring slot ``pos % W`` and
    ``slot_pos`` records it; the paged cache takes no window."""
    B = x.shape[0]
    scale = 1.0 / math.sqrt(cfg.d_head)
    q, k_new, v_new = _qkv(p, x, cfg, pos[:, None, None])     # S = 1
    Hkv = cfg.n_kv_heads
    Hp = padded_heads(cfg)
    paged = block_table is not None
    lengths = (pos + 1).to(torch.int32)
    W = cfg.sliding_window or 0
    if W and paged:
        raise NotImplementedError("paged cache supports full-attention "
                                  "stacks only (no sliding window)")
    slot = pos % W if W else pos                # the dense cache's slot
    if W:
        cache["slot_pos"][torch.arange(B, device=x.device), slot] = \
            pos.to(torch.int32)

    def seen(T: int) -> torch.Tensor:          # (B, T): entries attended
        if W:
            sp = cache["slot_pos"]
            return (sp >= 0) & (sp > pos[:, None] - W)
        return torch.arange(T, device=x.device)[None, :] <= pos[:, None]

    if proj is None:
        if paged:
            append_token(cache["k"], block_table, pos, k_new[:, :, 0])
            append_token(cache["v"], block_table, pos, v_new[:, :, 0])
            keys = gather_pages(cache["k"], block_table)
            vals = gather_pages(cache["v"], block_table)
        else:
            keys = scatter_time(cache["k"], k_new, slot)
            vals = scatter_time(cache["v"], v_new, slot)
        valid = seen(keys.shape[2])
        agg = (split_decode_attention(q, keys, vals, valid, scale,
                                      num_splits)
               if paged and num_splits > 1 else
               decode_attention(q, keys, vals, valid, scale))
        y = _out(agg.reshape(B, Hp, 1, cfg.d_head), p["wo"])
        return y.to(x.dtype), cache
    k_st = torch.einsum("bhtd,hdr->bhtr", k_new, proj["a_k"])
    v_st = torch.einsum("bhtd,hdr->bhtr", v_new, proj["a_v"])
    rk, rv = proj["a_k"].shape[-1], proj["a_v"].shape[-1]
    qc = torch.einsum("bgmd,gdr->bgmr", q.reshape(B, Hkv, Hp // Hkv,
                                                  cfg.d_head),
                      proj["b_q"]).reshape(B, Hp, -1).contiguous()
    if paged:
        layout = get_layout(cfg)
        for name, val in {**layout.encode("k", k_st),
                          **layout.encode("v", v_st)}.items():
            append_token(cache[name], block_table, pos, val[:, :, 0])
        if layout.kernel is not None:          # K1 / K4, or K5 on int8
            scales = ({"kscale": cache["kscale"], "vscale": cache["vscale"]}
                      if layout.kernel == "int8" else {})
            agg = kq_decode_paged_attention(
                qc, cache["kc"], cache["vc"], lengths, block_table,
                scale=scale, num_splits=num_splits, **scales)
        else:
            keys = _decoded_pages(layout, cache, block_table, "k", rk)
            vals = _decoded_pages(layout, cache, block_table, "v", rv)
            valid = seen(keys.shape[2])
            agg = (split_decode_attention(qc[:, :, None], keys, vals, valid,
                                          scale, num_splits)
                   if num_splits > 1 else
                   decode_attention(qc[:, :, None], keys, vals, valid,
                                    scale))
    elif cfg.cache_quant == "int8":
        (k8, ks), (v8, vs) = quantize_int8(k_st), quantize_int8(v_st)
        scatter_time(cache["kc"], k8, slot)
        scatter_time(cache["vc"], v8, slot)
        scatter_time(cache["kscale"], ks, slot)
        scatter_time(cache["vscale"], vs, slot)
        agg = int8_decode_attention(
            qc.reshape(B, Hkv, Hp // Hkv, -1), cache["kc"], cache["vc"],
            cache["kscale"], cache["vscale"], seen(cache["kc"].shape[2]),
            scale)
    else:
        scatter_time(cache["kc"], k_st, slot)
        scatter_time(cache["vc"], v_st, slot)
        agg = (decode_attention(qc[:, :, None], cache["kc"], cache["vc"],
                                seen(cache["kc"].shape[2]), scale) if W
               else kq_decode_attention(qc, cache["kc"], cache["vc"],
                                        lengths, scale=scale))
    agg = agg.reshape(B, Hkv, Hp // Hkv, rv)
    m = cfg.n_heads // Hkv                     # real heads (c_v is real-m)
    c_v = proj["c_v"].reshape(Hkv, -1, m, cfg.d_model)
    y = _cv_out(agg[:, :, :m], c_v, "bgmr,grmd->bd")[:, None, :]
    return y.to(x.dtype), cache
