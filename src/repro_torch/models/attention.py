"""Attention for the dense family: prefill, cached decode, compression.

Torch counterpart of the dense subset of ``repro.models.attention`` with
the same tensor layouts at every public function: q ``(B, H, S, dh)``,
caches ``(B, Hkv, T, R)``, page pools ``(P, Hkv, page_size, R)``,
compressed queries ``(B, H, R)``.

* full-sequence causal attention, with the sliding window where the
  config has one, runs in K6 (``repro_torch.kernels.flash``) under
  ``attn_prefill`` and ``attn_calibrate``, and under autograd in
  ``attn_train``: what the reference's lax ``blockwise_attention``
  computes there (``reference_attention``, K6's plain version, and
  ``blockwise_attention`` over it are its plain counterparts, for tests);
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

On a mesh (DTensor activations) ``attn_prefill`` and ``attn_decode`` run
K6 and K3 on each rank's local tensors (``local_map``) over the dense
cache that ``launch.specs.cache_shardings`` places: kv heads on the model
axis where they divide it, else the sequence, whose spans each rank
attends (K3's span output; ``decode_attention_span`` and
``int8_decode_attention_span`` for the full, ring and int8 caches) and
merges by their LSE (``Span``, ``sharding.partition.merge_spans``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash import (flash_attention, flash_attention_ref,
                                       flash_attention_train)
from repro_torch.kernels.kq_decode import (kq_decode_attention,
                                           kq_decode_attention_span,
                                           kq_decode_paged_attention,
                                           kq_prefill_paged_attention)
from repro_torch.models.layers import apply_rope, init_dense
from repro_torch.serving.page_layouts import get_layout, quantize_int8
from repro_torch.serving.paged_cache import (append_chunk, append_token,
                                             gather_pages)
from repro_torch.sharding.partition import (axis_size, cut_axes, grad_placed,
                                            is_dtensor, merge_spans,
                                            placed_like, redistributed,
                                            remap, shard_range, zeros_placed)

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
                 slot: torch.Tensor, axis: int = 1,
                 t0: Optional[int] = None) -> torch.Tensor:
    """Write one time slot per sequence, in place.

    cache: (B, ...); val: the same with the time axis of size 1; slot:
    (B,) destination index of each sequence; ``axis`` is the time axis
    within a batch element: 1 for (B, Hkv, T, R) caches (and (B, Hkv, T)
    scale planes), 0 for MLA's (B, T, R).  With ``t0`` the cache is one
    rank's span of a sequence-cut cache, holding slots ``t0 ..
    t0 + T - 1``: a row whose slot lies outside it keeps its entry
    (another rank owns the slot)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    new = val.select(axis + 1, 0).to(cache.dtype)
    if t0 is None:
        cache[(rows,) + (slice(None),) * axis + (slot,)] = new
        return cache
    T = cache.shape[axis + 1]
    local = slot - t0
    index = (rows,) + (slice(None),) * axis + (local.clamp(0, T - 1),)
    own = ((local >= 0) & (local < T)).reshape((-1,) + (1,) * (new.ndim - 1))
    cache[index] = torch.where(own, new, cache[index])
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


def _span_softmax(s: torch.Tensor, valid: torch.Tensor):
    """Softmax rows of one span: scores ``s`` (B,...,T) float32 and
    ``valid`` (B,T) -> probabilities normalised within the span and the
    span's log-sum-exp (B,...).  A row with no valid entry gets zero
    probabilities and an LSE of ``-1e30 + log(1e-30)``, as K3's span
    output gives it."""
    vm = valid.reshape((valid.shape[0],) + (1,) * (s.ndim - 2)
                       + (valid.shape[-1],))
    s = s.masked_fill(~vm, NEG_INF)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.where(vm, torch.exp(s - mx), torch.zeros_like(s))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return p / den, (mx + torch.log(den))[..., 0]


def decode_attention_span(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, valid_mask: torch.Tensor,
                          scale: float):
    """``decode_attention`` over one rank's span of a sequence-cut cache:
    the float32 rows (B,Hkv,m,rv) and their LSE (B,Hkv,m), which
    ``merge_spans`` merges over the ranks.  Shapes as
    ``decode_attention``, ``valid_mask`` the span's (B,T)."""
    B, H, _, dk = q.shape
    Hkv = cache_k.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, dk).float()
    s = torch.einsum("bgmd,bgtd->bgmt", qg, cache_k.float()) * scale
    p, lse = _span_softmax(s, valid_mask)
    return torch.einsum("bgmt,bgtr->bgmr", p, cache_v.float()), lse


def int8_decode_attention_span(qg: torch.Tensor, k8: torch.Tensor,
                               v8: torch.Tensor, kscale: torch.Tensor,
                               vscale: torch.Tensor, valid: torch.Tensor,
                               scale: float):
    """``int8_decode_attention`` over one rank's span: the span's
    probabilities pre-multiplied by the value scales, the value product in
    bf16, as there; returns the float32 rows and their LSE.  Shapes as
    ``int8_decode_attention``."""
    s = torch.einsum("bgmr,bgtr->bgmt", qg.float(), k8.float()) * scale
    s = s * kscale.float()[:, :, None, :]
    p, lse = _span_softmax(s, valid)
    pv = p * vscale.float()[:, :, None, :]
    return torch.einsum("bgmt,bgtr->bgmr", pv.to(torch.bfloat16),
                        v8.to(torch.bfloat16)).float(), lse


@dataclass(frozen=True)
class Span:
    """One rank's share of a decode on a mesh: the cache it holds covers
    positions (ring slots) ``t0 ..``, and mesh ``axes`` cut the sequence
    (empty: the rank holds it whole).  ``merge`` merges the ranks' rows
    over those axes."""

    t0: int = 0
    mesh: Any = None
    axes: Tuple[str, ...] = ()

    def merge(self, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """``merge_spans`` over this span's axes."""
        return merge_spans(out, lse, self.mesh, self.axes)


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


# the reference's O(S^2)-memory oracle is K6's plain version: f32 scores
# and values, the output in q's type (the reference's is in v's)
reference_attention = flash_attention_ref


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        block_q: int = 512, scale: Optional[float] = None):
    """The reference's lax ``blockwise_attention`` as plain blocks: q:
    (B,H,S,dh), k/v: (B,Hkv,S,*).  Each block of ``block_q`` queries
    attends the keys it can see, so memory is bounded by a block's
    scores; a block size that does not divide S falls back to one block,
    as there."""
    S = q.shape[2]
    bq = min(block_q, S)
    if S % bq:
        return reference_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    outs = []
    for i0 in range(0, S, bq):
        lo = max(0, i0 - window + 1) if window else 0
        hi = i0 + bq if causal else S
        # keys [lo, hi) at positions lo..: shift the queries to match
        outs.append(reference_attention(
            q[:, :, i0:i0 + bq], k[:, :, lo:hi], v[:, :, lo:hi],
            causal=causal, window=window, scale=scale, pos0_q=i0 - lo))
    return torch.cat(outs, dim=2)


def _attend_train(q, k, v, cfg: ModelConfig, pos0: int, h0: int):
    """RoPE, K6 under autograd and the pad-head mask on one shard's heads:
    q (B, Hl, S, dh) holds query heads ``h0 .. h0 + Hl`` of the model's,
    k / v (B, Hkv', S, dh) the kv heads of the shard (all of them when
    the rules replicate them).  Each query head reads its own kv group:
    a contiguous slice of kv heads where the shard's query heads fill
    whole groups or lie in one, else one kv head a query head."""
    S = q.shape[2]
    pos = torch.arange(S, device=q.device) + pos0
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    return _attend_heads(q, k, v, cfg, h0, flash_attention_train)


def _attend_heads(q, k, v, cfg: ModelConfig, h0: int, attend):
    """``attend`` (K6, or K6 under autograd) of one shard's query heads
    ``h0 .. h0 + Hl`` over their kv groups, and the pad-head mask: each
    query head reads its own kv group, a contiguous slice of kv heads
    where the shard's query heads fill whole groups or lie in one, else
    one kv head a query head (k / v hold every kv head, or the shard's
    own)."""
    Hl = q.shape[1]
    Hp = padded_heads(cfg)
    if Hl != Hp and k.shape[1] == cfg.n_kv_heads:
        m = Hp // cfg.n_kv_heads                 # query heads a kv group
        if m % Hl == 0 or Hl % m == 0:
            kv = slice(h0 // m, h0 // m + max(1, Hl // m))
        else:
            kv = (h0 + torch.arange(Hl, device=q.device)) // m
        k, v = k[:, kv], v[:, kv]
    out = attend(q, k, v, window=cfg.sliding_window)
    mask = head_mask(cfg)
    if mask is not None:
        out = out * torch.as_tensor(mask[h0:h0 + Hl], dtype=out.dtype,
                                    device=out.device)[None, :, None, None]
    return out


def _attend_train_sharded(q, k, v, cfg: ModelConfig, pos0: int):
    """``_attend_train`` on every rank's own batch rows and heads of
    DTensor q / k / v (``local_map``): K6 runs on the local tensors.
    Where the rules replicate k and v on a mesh dim that shards q's
    heads, each rank reads only its heads' groups, so their gradients
    come back as partial sums on that dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    h0 = shard_range(q, 1)[0]
    kv_grad = tuple(Partial() if qp == Shard(1) and kp == Replicate()
                    else kp for qp, kp in zip(q.placements, k.placements))
    fn = local_map(_attend_train, out_placements=list(q.placements),
                   in_placements=(q.placements, k.placements, v.placements,
                                  None, None, None),
                   in_grad_placements=(q.placements, kv_grad, kv_grad,
                                       None, None, None),
                   device_mesh=mesh)
    return fn(q, k, v, cfg, pos0, h0)


def attn_train(p, x: torch.Tensor, cfg: ModelConfig,
               pos0: int = 0) -> torch.Tensor:
    """Full-sequence causal attention with gradients (training): K6 under
    autograd (``flash_attention_train``; its backward plain PyTorch).
    Pad query heads (``qhead_pad``) have their outputs zeroed, so their
    weights' gradients stay zero, as in the reference.  On DTensor
    activations (a mesh) K6 runs per shard (``_attend_train_sharded``)."""
    q, k, v = (_project(x, p[w]) for w in ("wq", "wk", "wv"))
    if is_dtensor(q):
        # k / v's gradients come back as partial sums over the model axis
        # where it cuts q's heads but not theirs: reduced here, before the
        # projection's (B S, .) rows meet them (the production meshes)
        k, v = grad_placed(k), grad_placed(v)
        out = _attend_train_sharded(q, k, v, cfg, pos0)
    else:
        out = _attend_train(q, k, v, cfg, pos0, 0)
    return _out(out, p["wo"])


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
    entries go to slots ``pos % W`` and ``slot_pos`` records them.  On
    DTensor activations (a mesh) K6 runs per shard and each rank writes
    its shard of the cache (``_prefill_sharded``)."""
    if is_dtensor(x):
        return _prefill_sharded(p, x, cfg, max_len, proj)
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, torch.arange(S, device=x.device))
    W = cfg.sliding_window or 0
    y = _out(flash_attention(q, k, v, window=W), p["wo"])
    cache = make_attn_cache(cfg, B, max_len, _ranks(proj), x.dtype,
                            x.device)
    first = max(0, S - W) if W else 0          # the entries the cache keeps
    updates = _cache_entries(k[:, :, first:], v[:, :, first:], cfg, proj)
    slots = slice(0, S)
    if W:                                      # ring slots of the kept
        kept = torch.arange(first, S, device=x.device)
        slots = kept % W
        cache["slot_pos"][:, slots] = kept.to(torch.int32)
    for name, val in updates.items():
        cache[name][:, :, slots] = val.to(cache[name].dtype)
    return y, cache


def _ranks(proj: Optional[Dict]) -> Tuple[int, int]:
    """The compression ranks of ``proj`` ((0, 0) without projections)."""
    return ((proj["a_k"].shape[-1], proj["a_v"].shape[-1]) if proj
            else (0, 0))


def _cache_entries(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                   proj: Optional[Dict]) -> Dict[str, torch.Tensor]:
    """The cache leaves' entries of keys and values (B,Hkv,S,dh): raw,
    compressed by ``a_k`` / ``a_v``, or compressed and quantized for the
    dense int8 cache."""
    if proj is None:
        return {"k": k, "v": v}
    k_st = torch.einsum("bhtd,hdr->bhtr", k, proj["a_k"])
    v_st = torch.einsum("bhtd,hdr->bhtr", v, proj["a_v"])
    if cfg.cache_quant == "int8":
        (k_st, ks), (v_st, vs) = quantize_int8(k_st), quantize_int8(v_st)
        return {"kc": k_st, "vc": v_st, "kscale": ks, "vscale": vs}
    return {"kc": k_st, "vc": v_st}


def _heads_cfg(cfg: ModelConfig, n: int) -> ModelConfig:
    """``cfg`` with the head counts of one of ``n`` head shards (a shard
    holds whole kv groups, so the group sizes stay)."""
    if n == 1:
        return cfg
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // n, n_kv_heads=cfg.n_kv_heads // n,
        qhead_pad=cfg.qhead_pad // n)


def _prefill_sharded(p, x, cfg: ModelConfig, max_len: int,
                     proj: Optional[Dict]):
    """``attn_prefill`` on a mesh.  The cache is made under
    ``cache_shardings`` (``seq_sharded`` for a batch of one, the dry
    run's rule), each rank allocating only its shard; q / k / v come out
    of the projections as the rules place the weights and take the
    cache's batch placement; then on each rank (``local_map``) RoPE, K6
    over the rank's query heads and their kv groups, and the compressed
    (quantized) entries of the rank's kv heads written into the
    positions (ring slots) its shard of the cache holds.  The output
    projection contracts the heads as DTensor matrix products."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch.specs import cache_shardings
    mesh = x.device_mesh
    B, S, _ = x.shape
    W = cfg.sliding_window or 0
    meta = make_attn_cache(cfg, B, max_len, _ranks(proj), x.dtype, "meta")
    sh = cache_shardings(meta, mesh, seq_sharded=B == 1)
    cache = {}
    for name, t in meta.items():
        cache[name] = zeros_placed(t.shape, t.dtype, mesh,
                                   sh[name].placements)
        if name == "slot_pos":
            cache[name].to_local().fill_(-1)
    ref = cache["kc" if proj else "k"]
    t0, _ = shard_range(ref, 2)
    rows = remap(ref.placements, {0: 0})
    q, k, v = (_project(x, p[w]) for w in ("wq", "wk", "wv"))
    q = redistributed(q, tuple(r if isinstance(r, Shard) else
                     (qp if qp == Shard(1) else Replicate())
                     for r, qp in zip(rows, q.placements)))
    h0 = shard_range(q, 1)[0]
    kv_pl = remap(ref.placements, {0: 0, 1: 1})
    k, v = redistributed(k, kv_pl), redistributed(v, kv_pl)
    names = [n for n in cache if n != "slot_pos"]
    pj = ({n: redistributed(proj[n], remap(ref.placements, {1: 0}))
           for n in ("a_k", "a_v")} if proj else {})

    def local(q, k, v, a_k, a_v, *leaves):
        pos = torch.arange(S, device=q.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        out = _attend_heads(q, k, v, cfg, h0, flash_attention)
        lp = {"a_k": a_k, "a_v": a_v} if proj else None
        first = max(0, S - W) if W else 0
        kept = np.arange(first, S)
        dest = kept % W if W else kept
        T = leaves[0].shape[2]
        sel = np.nonzero((dest >= t0) & (dest < t0 + T))[0]
        src = torch.as_tensor(sel + first, device=q.device)
        dst = torch.as_tensor(dest[sel] - t0, device=q.device)
        updates = _cache_entries(k.index_select(2, src),
                                 v.index_select(2, src), cfg, lp)
        for name, leaf in zip(names, leaves):
            leaf[:, :, dst] = updates[name].to(leaf.dtype)
        return out

    args = [q, k, v, pj.get("a_k"), pj.get("a_v")] + [cache[n] for n in names]
    out = local_map(local, out_placements=list(q.placements),
                    in_placements=tuple(a.placements if a is not None
                                        else None for a in args),
                    device_mesh=mesh)(*args)
    if W:
        kept = torch.arange(max(0, S - W), S, device=ref.to_local().device)
        cache["slot_pos"].to_local()[:, kept % W] = kept.to(torch.int32)
    return _out(out, p["wo"]), cache


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
                num_splits: int = 1, span: Optional[Span] = None):
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
    ``slot_pos`` records it; the paged cache takes no window.

    On DTensor activations (a mesh) each rank runs this function on its
    own rows, heads and span of the dense cache (``_decode_sharded``):
    ``span`` says which positions its cache holds and which mesh axes
    cut the sequence.  The new entry is written by the rank that holds
    its position, and where axes cut the sequence each rank attends its
    span (K3's span output; the plain span functions for the full, int8
    and ring caches) and the spans merge by their LSE."""
    if is_dtensor(x):
        return _decode_sharded(p, x, cache, pos, cfg, proj, block_table,
                               num_splits)
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
    t0 = None if span is None else span.t0
    cut = span is not None and bool(span.axes)
    if W and span is None:        # a mesh's replicated ring: the caller's
        cache["slot_pos"][torch.arange(B, device=x.device), slot] = \
            pos.to(torch.int32)

    def seen(T: int) -> torch.Tensor:          # (B, T): entries attended
        if W:
            sp = cache["slot_pos"]
            if span is not None:
                sp = sp[:, span.t0:span.t0 + T]
            return (sp >= 0) & (sp > pos[:, None] - W)
        return (torch.arange(T, device=x.device)[None, :] + (t0 or 0)
                <= pos[:, None])

    def write(name: str, val: torch.Tensor) -> torch.Tensor:
        return scatter_time(cache[name], val, slot, t0=t0)

    if proj is None:
        if paged:
            append_token(cache["k"], block_table, pos, k_new[:, :, 0])
            append_token(cache["v"], block_table, pos, v_new[:, :, 0])
            keys = gather_pages(cache["k"], block_table)
            vals = gather_pages(cache["v"], block_table)
        else:
            keys, vals = write("k", k_new), write("v", v_new)
        valid = seen(keys.shape[2])
        if cut:
            agg = span.merge(*decode_attention_span(q, keys, vals, valid,
                                                    scale)).to(vals.dtype)
        elif paged and num_splits > 1:
            agg = split_decode_attention(q, keys, vals, valid, scale,
                                         num_splits)
        else:
            agg = decode_attention(q, keys, vals, valid, scale)
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
        for name, val in (("kc", k8), ("vc", v8), ("kscale", ks),
                          ("vscale", vs)):
            write(name, val)
        args = (qc.reshape(B, Hkv, Hp // Hkv, -1), cache["kc"], cache["vc"],
                cache["kscale"], cache["vscale"], seen(cache["kc"].shape[2]),
                scale)
        agg = (span.merge(*int8_decode_attention_span(*args))
               .to(torch.bfloat16) if cut else int8_decode_attention(*args))
    else:
        write("kc", k_st)
        write("vc", v_st)
        if W:
            args = (qc[:, :, None], cache["kc"], cache["vc"],
                    seen(cache["kc"].shape[2]), scale)
            agg = (span.merge(*decode_attention_span(*args))
                   .to(cache["vc"].dtype) if cut
                   else decode_attention(*args))
        elif cut:
            T = cache["kc"].shape[2]
            span_len = (pos + 1 - span.t0).clamp(0, T).to(torch.int32)
            agg = span.merge(*kq_decode_attention_span(
                qc, cache["kc"], cache["vc"], span_len, scale=scale)
            ).to(qc.dtype)
        else:
            agg = kq_decode_attention(qc, cache["kc"], cache["vc"], lengths,
                                      scale=scale)
    agg = agg.reshape(B, Hkv, Hp // Hkv, rv)
    m = cfg.n_heads // Hkv                     # real heads (c_v is real-m)
    c_v = proj["c_v"].reshape(Hkv, -1, m, cfg.d_model)
    y = _cv_out(agg[:, :, :m], c_v, "bgmr,grmd->bd")[:, None, :]
    return y.to(x.dtype), cache


def _decode_sharded(p, x, cache: Dict, pos: torch.Tensor, cfg: ModelConfig,
                    proj: Optional[Dict], block_table, num_splits: int):
    """``attn_decode`` on a mesh, over a dense cache placed by
    ``cache_shardings``.  The weights and projections take the cache's
    head placement (kv heads on the model axis where they divide it, else
    replicated), x the cache's batch placement; then every rank runs
    ``attn_decode`` on its local tensors (``local_map``) with the head
    counts of its shard and its ``Span``.  Where heads are sharded the
    output is a partial sum over their axis; it is reduced to x's
    placements.  A ring's ``slot_pos`` is replicated: every rank records
    every row's new slot in its copy first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if block_table is not None:
        raise NotImplementedError(
            "decode on a mesh takes the dense cache (the paged cache is "
            "the data-sharded engine's)")
    ref = cache["kc" if proj else "k"]
    mesh = ref.device_mesh
    pos = torch.as_tensor(pos, device=ref.to_local().device)
    heads = cut_axes(ref, 1)
    span = Span(shard_range(ref, 2)[0], mesh, cut_axes(ref, 2))
    b0, nb = shard_range(ref, 0)
    W = cfg.sliding_window or 0
    if W:
        sp = cache["slot_pos"].to_local()
        sp[torch.arange(sp.shape[0], device=sp.device), pos % W] = \
            pos.to(torch.int32)
    lcfg = _heads_cfg(cfg, axis_size(heads, mesh))
    xl = redistributed(x, remap(ref.placements, {0: 0}))
    w_pl = {n: remap(ref.placements, {1: d})
            for n, d in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0))}
    pw = {n: redistributed(p[n], pl) for n, pl in w_pl.items()}
    pj = ({n: redistributed(t, remap(ref.placements, {1: 0}))
           for n, t in proj.items()} if proj else {})
    names = sorted(cache)
    pnames = sorted(pj)

    def local(x, pos, *rest):
        lp = dict(zip(("wo", "wq", "wk", "wv"), rest[:4]))
        lproj = dict(zip(pnames, rest[4:4 + len(pnames)])) or None
        lc = dict(zip(names, rest[4 + len(pnames):]))
        if W:
            lc["slot_pos"] = lc["slot_pos"][b0:b0 + nb]
        return attn_decode(lp, x, lc, pos[b0:b0 + nb], lcfg, lproj,
                           span=span)[0]

    args = ([xl, pos] + [pw[n] for n in ("wo", "wq", "wk", "wv")]
            + [pj[n] for n in pnames] + [cache[n] for n in names])
    out_pl = tuple(Shard(0) if pl == Shard(0) else
                   Partial() if pl == Shard(1) else Replicate()
                   for pl in ref.placements)
    y = local_map(local, out_placements=list(out_pl),
                  in_placements=tuple(a.placements if is_dtensor(a)
                                      else None for a in args),
                  device_mesh=mesh)(*args)
    return placed_like(y, x), cache
