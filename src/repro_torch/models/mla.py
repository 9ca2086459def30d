"""Multi-head Latent Attention (DeepSeek-V2) with latent-cache compression.

Torch counterpart of ``repro.models.mla``.  MLA stores one trained
low-rank latent ``c = x W_d`` (``kv_lora_rank`` wide) and a shared rotary
key ``k_r`` per token.  Decode uses the absorbed form, attention over the
latent with per-head absorbed queries: a GQA group of ``H`` query heads
over one kv head, so KQ-SVD compresses the latent after the fact

    cc  = c A_k   (rank R  < kv_lora)   for the scores,
    ccv = c A_v   (rank Rv < kv_lora)   for the values,
    q'' = (q_nope W_uk^T) B_q,  out = (p ccv) C_v  (C_v absorbs W_uv W_o).

The rope sub-cache (``qk_rope_dim``) stays exact.

Full-sequence attention (``mla_train``, ``mla_calibrate``,
``mla_prefill``) materialises per-head keys ``[c W_uk, k_r]`` of width
``nope + rope`` and values ``c W_uv``, and runs causal attention with
scale ``1/sqrt(nope + rope)``: what the reference's lax
``blockwise_attention`` computes there, so on the card it is K6 at
(192, 128) with ``H = Hkv`` (under autograd in ``mla_train``), on the
CPU K6's plain version.  Decode is plain PyTorch, as the reference's is
plain jnp: no kernel exists for it.  Caches are ``(B, T, R)`` leaves,
the time axis 1 (``c`` or ``cc``/``ccv``, and ``kr``), written in place
through ``scatter_time(..., axis=0)``.

On a mesh (DTensor activations) the projections run as DTensor matrix
products, K6 per shard of query heads through ``local_map``
(``_attend_sharded``: RoPE and the shared rope key on each rank, whose
gradient comes back as a partial sum over the head axis), and each rank
writes its shard of the latent cache, whose sequence the model axis
cuts (``launch.specs.cache_spec``: the latent has no head dim).  Decode
on a mesh runs ``mla_decode`` on each rank's rows and span of the
latent with the weights gathered, the spans merged by their LSE.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash import flash_attention, flash_attention_train
from repro_torch.models.attention import (NEG_INF, Span, _out, _project,
                                          _span_softmax, batched_positions,
                                          scatter_time)
from repro_torch.models.layers import apply_rope, init_dense
from repro_torch.sharding.partition import (cut_axes, is_dtensor,
                                            placed_like, redistributed,
                                            remap, shard_range, zeros_placed)


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype,
             device) -> Dict[str, torch.Tensor]:
    """Down / up projections, the decoupled rope path and the output
    projection."""
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    lora = m.kv_lora_rank
    return {
        "wq": init_dense(gen, (D, H, qk), D, dtype, device),
        "wd": init_dense(gen, (D, lora + m.qk_rope_dim), D, dtype, device),
        "wuk": init_dense(gen, (lora, H, m.qk_nope_dim), lora, dtype,
                          device),
        "wuv": init_dense(gen, (lora, H, m.v_head_dim), lora, dtype, device),
        "wo": init_dense(gen, (H, m.v_head_dim, D), H * m.v_head_dim, dtype,
                         device),
    }


def _scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim)


def _mla_project(p, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """x: (B,S,D) -> q_nope (B,H,S,nope), q_rope (B,H,S,rope), c
    (B,S,lora), k_rope (B,1,S,rope), rope applied at ``positions``."""
    m = cfg.mla
    q = _project(x, p["wq"])
    q_nope = q[..., :m.qk_nope_dim]
    q_rope = apply_rope(q[..., m.qk_nope_dim:], positions, cfg.rope_theta)
    down = x @ p["wd"]
    c = down[..., :m.kv_lora_rank]
    k_rope = apply_rope(down[..., m.kv_lora_rank:][:, None], positions,
                        cfg.rope_theta)
    return q_nope, q_rope, c, k_rope


def _full_attention(p, x: torch.Tensor, cfg: ModelConfig, projected,
                    attend) -> torch.Tensor:
    """Causal attention over materialised per-head keys and values:
    ``attend`` is K6 (``flash_attention``) or K6 under autograd."""
    q_nope, q_rope, c, k_rope = projected
    H = cfg.n_heads
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([_project(c, p["wuk"]), k_rope.expand(-1, H, -1, -1)],
                  dim=-1)
    v = _project(c, p["wuv"])
    return _out(attend(q, k, v, scale=_scale(cfg)), p["wo"])


def _attend_local(q, k_nope, v, k_rope, cfg: ModelConfig, attend):
    """RoPE on the rope parts of q (B,Hl,S,nope+rope) and of the shared
    key ``k_rope`` (B,1,S,rope), then ``attend`` over the keys
    ``[k_nope, k_rope]`` of the Hl heads."""
    m = cfg.mla
    pos = torch.arange(q.shape[2], device=q.device)
    q = torch.cat([q[..., :m.qk_nope_dim],
                   apply_rope(q[..., m.qk_nope_dim:], pos, cfg.rope_theta)],
                  dim=-1)
    kr = apply_rope(k_rope, pos, cfg.rope_theta)
    k = torch.cat([k_nope, kr.expand(-1, q.shape[1], -1, -1)], dim=-1)
    return attend(q, k, v, scale=_scale(cfg))


def _attend_sharded(p, x, cfg: ModelConfig, attend):
    """Full-sequence MLA on a mesh: the per-head queries, keys and values
    as DTensor products (heads where the rules put them), K6 on each
    rank's heads (``local_map``), the shared rope key replicated over the
    head axis and its gradient a partial sum there.  Returns the output
    and the latent ``c`` (B,S,lora) and unroped ``k_rope`` (B,1,S,rope)
    for the cache."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    m = cfg.mla
    q = _project(x, p["wq"])
    down = x @ p["wd"]
    c = down[..., :m.kv_lora_rank]
    k_rope = down[..., m.kv_lora_rank:][:, None]
    k_nope, v = _project(c, p["wuk"]), _project(c, p["wuv"])
    kn_pl = tuple(k_nope.placements)
    q, v = redistributed(q, kn_pl), redistributed(v, kn_pl)
    kr_pl = tuple(Replicate() if pl == Shard(1) else pl for pl in kn_pl)
    k_rope = redistributed(k_rope, kr_pl)
    kr_grad = tuple(Partial() if pl == Shard(1) else pl for pl in kn_pl)
    out = local_map(lambda q, kn, v, kr: _attend_local(q, kn, v, kr, cfg,
                                                       attend),
                    out_placements=list(kn_pl),
                    in_placements=(kn_pl, kn_pl, kn_pl, kr_pl),
                    in_grad_placements=(kn_pl, kn_pl, kn_pl, kr_grad),
                    device_mesh=x.device_mesh)(q, k_nope, v, k_rope)
    return _out(out, p["wo"]), c, k_rope


def mla_train(p, x: torch.Tensor, cfg: ModelConfig,
              pos0: int = 0) -> torch.Tensor:
    """Full-sequence MLA with gradients: K6 under autograd (per shard of
    heads on a mesh)."""
    if is_dtensor(x):
        return _attend_sharded(p, x, cfg, flash_attention_train)[0]
    positions = torch.arange(x.shape[1], device=x.device) + pos0
    return _full_attention(p, x, cfg, _mla_project(p, x, cfg, positions),
                           flash_attention_train)


def mla_calibrate(p, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Output and the latent-compression captures, the Hkv = 1 GQA form:
    k = v = the latent ``c`` (B,1,S,lora), q the absorbed queries
    ``q_nope W_uk^T`` (B,H,S,lora)."""
    positions = torch.arange(x.shape[1], device=x.device)
    projected = _mla_project(p, x, cfg, positions)
    y = _full_attention(p, x, cfg, projected, flash_attention)
    q_nope, _, c, _ = projected
    q_abs = torch.einsum("bhse,lhe->bhsl", q_nope, p["wuk"])
    return y, {"k": c[:, None], "q": q_abs, "v": c[:, None]}


def mla_group_output_weights(p, cfg: ModelConfig) -> np.ndarray:
    """Absorbed ``W_vo = W_uv W_o`` stacked over heads: (1, lora, H*D)
    float64 on the host.  The products run in float64 on the params'
    device, one matrix product per head (a numpy einsum over the full
    width takes seconds a layer on the host)."""
    wuv = p["wuv"].detach().double()                         # (lora, H, dv)
    wo = p["wo"].detach().double()                           # (H, dv, D)
    w_vo = torch.bmm(wuv.transpose(0, 1), wo).transpose(0, 1)  # (lora,H,D)
    return w_vo.reshape(1, wuv.shape[0], -1).cpu().numpy()


def make_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   proj_rank: Tuple[int, int] = (0, 0),
                   dtype=torch.bfloat16, device=None
                   ) -> Dict[str, torch.Tensor]:
    """Zeroed (B, T, R) decode cache: compressed ``cc``/``ccv`` with
    KQ-SVD ranks, else the raw latent ``c``; and the rope keys ``kr``."""
    m = cfg.mla
    rk, rv = proj_rank

    def zeros(width):
        return torch.zeros((batch, max_len, width), dtype=dtype,
                           device=device)
    cache = ({"cc": zeros(rk), "ccv": zeros(rv)} if rk
             else {"c": zeros(m.kv_lora_rank)})
    cache["kr"] = zeros(m.qk_rope_dim)
    return cache


def mla_prefill(p, x: torch.Tensor, cfg: ModelConfig, max_len: int,
                proj: Optional[Dict] = None):
    """Full-prompt MLA (K6 on the card): the output and a length-
    ``max_len`` cache holding the prompt's (compressed) latent and rope
    keys at [0, S)."""
    if is_dtensor(x):
        return _prefill_sharded(p, x, cfg, max_len, proj)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    projected = _mla_project(p, x, cfg, positions)
    y = _full_attention(p, x, cfg, projected, flash_attention)
    _, _, c, k_rope = projected
    cache = make_mla_cache(cfg, B, max_len, _mla_ranks(proj), x.dtype,
                           x.device)
    if proj is not None:
        cache["cc"][:, :S] = (c @ proj["a_k"][0]).to(cache["cc"].dtype)
        cache["ccv"][:, :S] = (c @ proj["a_v"][0]).to(cache["ccv"].dtype)
    else:
        cache["c"][:, :S] = c.to(cache["c"].dtype)
    cache["kr"][:, :S] = k_rope[:, 0].to(cache["kr"].dtype)
    return y, cache


def _mla_ranks(proj: Optional[Dict]) -> Tuple[int, int]:
    return ((proj["a_k"].shape[-1], proj["a_v"].shape[-1]) if proj
            else (0, 0))


def _prefill_sharded(p, x, cfg: ModelConfig, max_len: int,
                     proj: Optional[Dict]):
    """``mla_prefill`` on a mesh: ``_attend_sharded``, then each rank
    writes the positions of its shard of the cache (made under
    ``cache_shardings``, ``seq_sharded`` for a batch of one): the latent
    (compressed by the replicated factors) and the roped keys of its
    rows."""
    from repro_torch.launch.specs import cache_shardings
    mesh = x.device_mesh
    B, S, _ = x.shape
    y, c, k_rope = _attend_sharded(p, x, cfg, flash_attention)
    meta = make_mla_cache(cfg, B, max_len, _mla_ranks(proj), x.dtype, "meta")
    sh = cache_shardings(meta, mesh, seq_sharded=B == 1)
    cache = {n: zeros_placed(t.shape, t.dtype, mesh, sh[n].placements)
             for n, t in meta.items()}
    ref = cache["kr"]
    t0, T = shard_range(ref, 1)
    rows = remap(ref.placements, {0: 0})
    c = redistributed(c, rows)
    k_rope = redistributed(k_rope, rows)
    lo, hi = min(max(t0, 0), S), min(t0 + T, S)   # prompt positions held
    cl = c.to_local()
    vals = {"kr": apply_rope(k_rope.to_local(),
                             torch.arange(S, device=cl.device),
                             cfg.rope_theta)[:, 0]}
    if proj is not None:
        for n, f in (("cc", "a_k"), ("ccv", "a_v")):
            vals[n] = cl @ redistributed(proj[f], remap(ref.placements, {})
                               ).to_local()[0]
    else:
        vals["c"] = cl
    for n, v in vals.items():
        cache[n].to_local()[:, lo - t0:hi - t0] = \
            v[:, lo:hi].to(cache[n].dtype)
    return y, cache


def mla_decode(p, x: torch.Tensor, cache: Dict, pos, cfg: ModelConfig,
               proj: Optional[Dict] = None, span: Optional[Span] = None):
    """One-token absorbed-form decode.  x: (B,1,D); pos: (B,) index of
    each new token (a scalar broadcasts).  Writes the token's (compressed)
    latent and rope key into ``cache`` in place and attends positions
    ``<= pos[b]``; returns ``(y (B,1,D), cache)``.  On DTensor
    activations (a mesh) each rank runs this function on its rows and
    span of the latent (``span``: the first position it holds and the
    axes that cut the sequence), the new entry written by the rank that
    holds its position and the spans merged by their LSE."""
    if is_dtensor(x):
        return _decode_sharded(p, x, cache, pos, cfg, proj)
    B = x.shape[0]
    H = cfg.n_heads
    scale = _scale(cfg)
    t0 = None if span is None else span.t0
    cut = span is not None and bool(span.axes)
    pos = batched_positions(pos, B, x.device)
    q_nope, q_rope, c_new, kr_new = _mla_project(p, x, cfg,
                                                 pos[:, None, None])
    q_abs = torch.einsum("bhe,lhe->bhl", q_nope[:, :, 0], p["wuk"])
    kr = scatter_time(cache["kr"], kr_new[:, 0], pos, axis=0, t0=t0)
    T = kr.shape[1]
    valid = (torch.arange(T, device=x.device)[None, :] + (t0 or 0)
             <= pos[:, None])
    s_rope = torch.einsum("bhe,bte->bht", q_rope[:, :, 0].float(),
                          kr.float())

    def attend(q, keys, vals):
        s = torch.einsum("bhr,btr->bht", q.float(), keys.float())
        if cut:
            prob, lse = _span_softmax((s + s_rope) * scale, valid)
            out = torch.einsum("bht,btr->bhr", prob, vals.float())
            return span.merge(out, lse).to(vals.dtype)
        s = ((s + s_rope) * scale).masked_fill(~valid[:, None, :], NEG_INF)
        prob = torch.softmax(s, dim=-1)
        return torch.einsum("bht,btr->bhr", prob.to(vals.dtype), vals)

    if proj is not None:
        cc = scatter_time(cache["cc"], c_new @ proj["a_k"][0], pos, axis=0,
                          t0=t0)
        ccv = scatter_time(cache["ccv"], c_new @ proj["a_v"][0], pos,
                           axis=0, t0=t0)
        agg = attend(q_abs @ proj["b_q"][0], cc, ccv)
        c_v = proj["c_v"][0].reshape(-1, H, cfg.d_model)     # (Rv,H,D)
        y = torch.einsum("bhr,rhd->bd", agg, c_v)[:, None]
    else:
        cc = scatter_time(cache["c"], c_new, pos, axis=0, t0=t0)
        agg = attend(q_abs, cc, cc)
        v = torch.einsum("bhl,lhe->bhe", agg, p["wuv"])
        y = torch.einsum("bhe,hed->bd", v, p["wo"])[:, None]
    return y.to(x.dtype), cache


def _decode_sharded(p, x, cache: Dict, pos, cfg: ModelConfig,
                    proj: Optional[Dict]):
    """``mla_decode`` on a mesh, over a latent cache placed by
    ``cache_shardings``: the weights and factors gathered (replicated), x
    taking the cache's batch placement, and every rank running
    ``mla_decode`` on its rows and its ``Span`` (``local_map``); the
    output is reduced to x's placements."""
    from torch.distributed.tensor.experimental import local_map
    ref = cache["kr"]
    mesh = ref.device_mesh
    pos = batched_positions(pos, x.shape[0], ref.to_local().device)
    span = Span(shard_range(ref, 1)[0], mesh, cut_axes(ref, 1))
    b0, nb = shard_range(ref, 0)
    rows = remap(ref.placements, {0: 0})
    wn = sorted(p)
    pw = [redistributed(p[n], remap(ref.placements, {})) for n in wn]
    pn = sorted(proj) if proj else []
    pj = [redistributed(proj[n], remap(ref.placements, {})) for n in pn]
    names = sorted(cache)

    def local(x, pos, *rest):
        lp = dict(zip(wn, rest[:len(wn)]))
        lproj = dict(zip(pn, rest[len(wn):len(wn) + len(pn)])) or None
        lc = dict(zip(names, rest[len(wn) + len(pn):]))
        return mla_decode(lp, x, lc, pos[b0:b0 + nb], cfg, lproj,
                          span=span)[0]

    args = [redistributed(x, rows), pos] + pw + pj + [cache[n] for n in names]
    y = local_map(local, out_placements=list(rows),
                  in_placements=tuple(a.placements if is_dtensor(a)
                                      else None for a in args),
                  device_mesh=mesh)(*args)
    return placed_like(y, x), cache
