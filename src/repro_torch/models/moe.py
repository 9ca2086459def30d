"""Mixture-of-Experts FFN with capacity dispatch (GShard-style), in PyTorch.

Torch counterpart of ``repro.models.moe`` with the same arithmetic:

* the router runs in float32 (its weight is float32): softmax over the
  experts, the top ``k`` of each token, the gates renormalised by their
  sum clamped at 1e-9.  Ties among equal probabilities go to the lower
  expert index, as ``lax.top_k`` breaks them (a stable descending sort);
* each (token, choice) takes the next of its expert's ``C`` capacity
  slots in token-major order, a cumulative sum over the flattened
  ``(N * k)`` one-hot, so the drops (``pos >= C``) fall on the same
  choices as in the reference; masked (dead) tokens take no slot;
* dispatch is an index gather of the tokens into ``(E, C)`` slots, a
  sentinel row of zeros filling the empty ones; the experts run as
  batched matrix products over ``E`` (plain ``torch.bmm``, as the
  reference's ``einsum`` is plain XLA outside any Pallas kernel); the
  outputs gather back and combine with the gates;
* the router statistics ``load_balance``, ``router_z`` and
  ``dropped_frac``, over live tokens when a mask is given;
* DeepSeek's shared experts and Arctic's parallel dense residual FFN add
  their SwiGLU outputs.

``route`` is the router and the capacity assignment alone (the keep mask
and the slots), which ``moe_ffn`` runs first.  ``n_groups`` splits the
tokens into that many dispatch groups, each with its own capacity: by
default one group per rank of the data axes, as in the reference (one
group without a mesh, and one where the groups do not divide the
tokens).  On a mesh (``_moe_ffn_sharded``) the groups lie on the data
axes and the experts on the model axis: each rank routes and dispatches
its own groups (``local_map``: DTensor has no rule for the scatter and
the gathers), the dispatched slots go from group-major to expert-major
(the model axis cutting the experts) for the expert products, and back
to group-major (gathered over the model axis) for the combine, the two
reshards the reference's ``shard`` calls place.  The scatter of slot ids writes
every dropped or dead choice to one sentinel column, which is cut off
before anything reads the buffer, so its nondeterministic duplicates on
CUDA never reach a result.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import MoEConfig
from repro_torch.models.layers import init_dense, init_swiglu, swiglu
from repro_torch.sharding.partition import (axis_size, gather_dp,
                                            is_dtensor, partial_where,
                                            redistributed, remap, shard,
                                            shard_range)
from repro_torch.tree import tree_map


def _init_stack(gen: torch.Generator, shape: Tuple[int, int, int],
                fan_in: int, dtype, device) -> torch.Tensor:
    """``init_dense`` of an ``(E, rows, cols)`` expert stack drawn one
    expert at a time into the final tensor: a full-width stack (Arctic's
    (128, 7168, 4864) is 17.8 GB in float32) never exists in float32."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        out[e] = init_dense(gen, shape[1:], fan_in, dtype, device)
    return out


def init_moe(gen: torch.Generator, d_model: int, mo: MoEConfig, dtype,
             device) -> Dict:
    """Router (float32) and the stacked expert SwiGLU weights, plus the
    shared experts' and the dense residual's SwiGLUs when configured."""
    E, ff = mo.n_experts, mo.expert_ff
    p = {
        "router": init_dense(gen, (d_model, E), d_model, torch.float32,
                             device),
        "wi_e": _init_stack(gen, (E, d_model, ff), d_model, dtype, device),
        "wg_e": _init_stack(gen, (E, d_model, ff), d_model, dtype, device),
        "wo_e": _init_stack(gen, (E, ff, d_model), ff, dtype, device),
    }
    if mo.n_shared_experts:
        p["shared"] = init_swiglu(gen, d_model, mo.n_shared_experts * ff,
                                  dtype, device)
    if mo.dense_residual:
        p["residual"] = init_swiglu(gen, d_model,
                                    mo.dense_residual_ff or ff, dtype,
                                    device)
    return p


def _capacity(n_tokens: int, mo: MoEConfig, mode: str) -> int:
    """Expert capacity per dispatch group: ``ceil(k * N * cf / E)``, cf
    the configured capacity factor floored at 4.0 in ``decode``, at 2.0
    in ``prefill`` / ``calibrate`` / ``chunk`` and not at all in
    ``train``; at least 1 and at most N."""
    floor = {"decode": 4.0, "train": 0.0}.get(mode, 2.0)
    cf = max(mo.capacity_factor, floor)
    c = int(math.ceil(mo.top_k * n_tokens * cf / mo.n_experts))
    return max(1, min(c, n_tokens))


def route(p: Dict, x: torch.Tensor, mo: MoEConfig, mode: str = "train",
          n_groups: Optional[int] = None,
          token_mask: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The router and the capacity assignment of ``moe_ffn``.

    x: (B, S, D).  Returns ``G``, ``Ng``, ``C`` (groups, tokens a group,
    slots an expert), ``logits`` / ``probs`` (G, Ng, E) float32, ``gates``
    (G, Ng, k) renormalised, ``onehot`` (G, Ng*k, E) int64 of the choices
    (zero for dead tokens), ``keep`` (G, Ng*k) bool of the choices that
    got a slot, ``slot_ids`` (G, Ng*k): each kept choice's slot
    ``expert * C + position``, the sentinel ``E * C`` for the others, and
    ``live`` (G, Ng*k) bool or None."""
    B, S, D = x.shape
    N = B * S
    E, K = mo.n_experts, mo.top_k
    G = n_groups or axis_size(("pod", "data"))
    if N % G:
        G = 1
    Ng = N // G
    C = _capacity(Ng, mo, mode)
    logits = x.reshape(G, Ng, D).float() @ p["router"]       # (G, Ng, E)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = order.values[..., :K], order.indices[..., :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each (token, choice) among its expert's slots, in
    # token-major order
    flat_e = experts.reshape(G, Ng * K)
    onehot = torch.nn.functional.one_hot(flat_e, E)          # (G, NgK, E)
    live = None
    if token_mask is not None:
        live = token_mask.reshape(G, Ng).bool().repeat_interleave(K, dim=1)
        onehot = onehot * live[..., None]    # dead tokens take no slot
    pos_in_e = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
    keep = pos_in_e < C
    if live is not None:
        keep = keep & live
    slot_ids = torch.where(keep, flat_e * C + pos_in_e,
                           torch.full_like(flat_e, E * C))
    return {"G": G, "Ng": Ng, "C": C, "logits": logits, "probs": probs,
            "gates": gates, "onehot": onehot, "keep": keep,
            "slot_ids": slot_ids, "live": live}


def moe_ffn(p: Dict, x: torch.Tensor, mo: MoEConfig, mode: str = "train",
            n_groups: Optional[int] = None,
            token_mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y in x's type, aux statistics in float32).

    ``token_mask``: optional (B, S) bool of live tokens.  Masked tokens
    (finished or empty serving slots, a chunk's padding) take no expert
    slot, so they cannot crowd live tokens out, and are left out of the
    aux statistics; their routed output is zero.  The call runs inside a
    ``moe_ffn`` profiler range, which the card's profile reads."""
    with torch.profiler.record_function("moe_ffn"):
        if is_dtensor(x):
            return _moe_ffn_sharded(p, x, mo, mode, n_groups, token_mask)
        return _moe_ffn(p, x, mo, mode, n_groups, token_mask)


def _dispatch(xg: torch.Tensor, slot_ids: torch.Tensor, E: int, C: int,
              K: int) -> torch.Tensor:
    """Each group's tokens gathered into its (E, C) expert slots: xg (G,
    Ng, D), slot_ids (G, Ng*K) -> (G, E*C, D), zeros in the empty slots.
    The token ids go into the slots by a scatter; the sentinel column
    E*C takes every dropped choice and is cut off, and row Ng of the
    tokens is zeros."""
    G, Ng, D = xg.shape
    dev = xg.device
    token_ids = torch.arange(Ng, device=dev).repeat_interleave(K).expand(
        G, Ng * K)
    dispatch = torch.full((G, E * C + 1), Ng, dtype=torch.int64, device=dev)
    dispatch.scatter_(1, slot_ids, token_ids)
    dispatch = dispatch[:, :E * C]
    g_ix = torch.arange(G, device=dev)[:, None]
    xp = torch.cat([xg, xg.new_zeros(G, 1, D)], dim=1)
    return xp[g_ix, dispatch]


def _experts(ein: torch.Tensor, p: Dict) -> torch.Tensor:
    """The experts' SwiGLUs as batched products over E: ein (E, rows, D)
    -> (E, rows, D)."""
    h = torch.bmm(ein, p["wi_e"])
    g = torch.bmm(ein, p["wg_e"])
    h = h * g * torch.sigmoid(g.float()).to(h.dtype)
    return torch.bmm(h, p["wo_e"])


def _combine(out_g: torch.Tensor, slot_ids: torch.Tensor,
             gates: torch.Tensor) -> torch.Tensor:
    """Each (token, choice)'s expert output gathered from its group's
    slots and weighed by its gate: out_g (G, E*C, D), slot_ids (G,
    Ng*K), gates (G, Ng, K) -> (G, Ng, D); a dropped choice reads the
    zero row E*C."""
    G, _, D = out_g.shape
    Ng, K = gates.shape[1:]
    out_p = torch.cat([out_g, out_g.new_zeros(G, 1, D)], dim=1)
    g_ix = torch.arange(G, device=out_g.device)[:, None]
    gathered = out_p[g_ix, slot_ids]                          # (G, NgK, D)
    return (gathered.reshape(G, Ng, K, D)
            * gates[..., None].to(gathered.dtype)).sum(2)


def _moe_ffn(p, x, mo, mode, n_groups, token_mask):
    B, S, D = x.shape
    N = B * S
    E, K = mo.n_experts, mo.top_k
    r = route(p, x, mo, mode, n_groups, token_mask)
    G, Ng, C = r["G"], r["Ng"], r["C"]
    keep, slot_ids, onehot = r["keep"], r["slot_ids"], r["onehot"]
    expert_in = _dispatch(x.reshape(G, Ng, D), slot_ids, E, C, K)

    ein = expert_in.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    eout = _experts(ein, p)                                   # (E, GC, D)
    out_g = eout.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
    y = _combine(out_g, slot_ids, r["gates"]).reshape(B, S, D)

    # aux statistics (f32), over live tokens when a mask is given
    probs = r["probs"]
    counts = (onehot * keep[..., None]).sum((0, 1)).float()   # (E,)
    zsq = torch.logsumexp(r["logits"], dim=-1) ** 2
    if r["live"] is None:
        me = probs.mean((0, 1))
        ce = counts / (N * K)
        dropped = 1.0 - keep.float().mean()
        router_z = zsq.mean()
    else:
        tok_live = token_mask.reshape(G, Ng).float()
        n_live = tok_live.sum().clamp_min(1.0)
        me = (probs * tok_live[..., None]).sum((0, 1)) / n_live
        ce = counts / (n_live * K)
        live_choices = tok_live.sum() * K          # 0 if the batch is dead
        dropped = ((live_choices - keep.sum())
                   / live_choices.clamp_min(1.0))
        router_z = (zsq * tok_live).sum() / n_live
    aux = {"load_balance": E * (me * ce).sum(),
           "router_z": router_z,
           "dropped_frac": dropped}

    xf = x.reshape(N, D)
    if "shared" in p:
        y = y + swiglu(p["shared"], xf).reshape(B, S, D).to(y.dtype)
    if "residual" in p:
        y = y + swiglu(p["residual"], xf).reshape(B, S, D).to(y.dtype)
    return y.to(x.dtype), aux


def _moe_ffn_sharded(p, x, mo, mode, n_groups, token_mask):
    """``_moe_ffn`` on a mesh.  The G groups (G = the data axes' size
    unless the caller says, 1 where the groups do not divide the tokens)
    are contiguous runs of the token-major rows, so each rank's rows of x
    (batch-sharded over the data axes, and gathered first where its
    shards do not hold whole groups) are its groups.  Each rank routes,
    assigns capacity and dispatches its own groups on its local tensors
    (``local_map``) and keeps their router sums; the slots (G, E, C, D)
    go expert-major, the experts on the model axis, for the expert
    products (DTensor batched products over the experts each rank
    holds), come back group-major, gathered over the model axis, and each
    rank combines its groups' outputs into its rows.  The statistics are
    the groups' sums over all groups, as ``_moe_ffn`` takes them."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    B, S, D = x.shape
    N = B * S
    E, K = mo.n_experts, mo.top_k
    dp = ("pod", "data")
    mesh = x.device_mesh
    p = tree_map(gather_dp, p)          # FSDP's gather at use (no-op after)
    G = n_groups or axis_size(dp, mesh)
    if N % G:
        G = 1
    Ng = N // G
    C = _capacity(Ng, mo, mode)
    rows = remap(x.placements, {0: 0})
    n_x = 1
    for i, pl in enumerate(rows):
        n_x *= mesh.size(i) if pl == Shard(0) else 1
    if G % n_x or (N // n_x) % Ng:           # shards that split a group
        rows = (Replicate(),) * len(rows)
    xl = redistributed(x, rows)
    b0, _ = shard_range(xl, 0)
    g0 = b0 * S // Ng
    r_pl = (Replicate(),) * mesh.ndim
    router = redistributed(p["router"], r_pl)
    r_grad = partial_where(r_pl, rows)
    tm = (None if token_mask is None else
          torch.as_tensor(token_mask).reshape(G, Ng))

    def local_route(x, router):
        Gl = x.shape[0] * S // Ng
        xg = x.reshape(Gl, Ng, D)
        mask = None if tm is None else tm[g0:g0 + Gl].to(x.device)
        r = route({"router": router}, xg, mo, mode, Gl, mask)
        keep, onehot = r["keep"], r["onehot"]
        zsq = torch.logsumexp(r["logits"], dim=-1) ** 2       # (Gl, Ng)
        live = (torch.ones_like(zsq) if mask is None
                else mask.reshape(Gl, Ng).float())
        stats = torch.cat([
            (r["probs"] * live[..., None]).sum(1),                # (Gl, E)
            (onehot * keep[..., None]).sum(1).float(),            # counts
            (zsq * live).sum(1, keepdim=True),
            live.sum(1, keepdim=True),
            keep.float().sum(1, keepdim=True)], dim=-1)
        return (_dispatch(xg, r["slot_ids"], E, C, K).reshape(Gl, E, C, D),
                r["slot_ids"], r["gates"], stats)

    expert_in, slot_ids, gates, stats = local_map(
        local_route, out_placements=(list(rows),) * 4,
        in_placements=(rows, r_pl), in_grad_placements=(rows, r_grad),
        device_mesh=mesh)(xl, router)
    expert_in = shard(expert_in, dp, None, None, None)
    ein = shard(expert_in.transpose(0, 1), "model", dp, None, None)
    eout = _experts(ein.reshape(E, G * C, D), p).reshape(E, G, C, D)
    eout = shard(eout, "model", dp, None, None)
    out_g = redistributed(shard(eout.transpose(0, 1).reshape(G, E * C, D),
                                dp, None, None), rows)

    def local_combine(out_g, slot_ids, gates):
        return _combine(out_g, slot_ids, gates).reshape(-1, S, D)

    y = local_map(local_combine, out_placements=list(rows),
                  in_placements=(rows, rows, rows),
                  device_mesh=mesh)(out_g, slot_ids, gates)

    tot = stats.sum(0)
    prob_sum, counts = tot[:E], tot[E:2 * E]
    zsum, n_live, kept = tot[2 * E], tot[2 * E + 1], tot[2 * E + 2]
    if token_mask is None:
        me, ce = prob_sum / N, counts / (N * K)
        dropped = 1.0 - kept / (N * K)
        router_z = zsum / N
    else:
        n = n_live.clamp_min(1.0)
        me, ce = prob_sum / n, counts / (n * K)
        live_choices = n_live * K
        dropped = (live_choices - kept) / live_choices.clamp_min(1.0)
        router_z = zsum / n
    aux = {"load_balance": E * (me * ce).sum(), "router_z": router_z,
           "dropped_frac": dropped}

    xf = x.reshape(N, D)
    if "shared" in p:
        y = y + swiglu(p["shared"], xf).reshape(B, S, D).to(y.dtype)
    if "residual" in p:
        y = y + swiglu(p["residual"], xf).reshape(B, S, D).to(y.dtype)
    return y.to(x.dtype), aux
