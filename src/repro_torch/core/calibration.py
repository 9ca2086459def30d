"""Streaming calibration: accumulate Gram statistics, then solve projections.

The paper concatenates 128 x 2048-token caches into T=262,144-row matrices
and SVDs them.  We instead accumulate the d x d Gram matrices

    G_K = K^T K,   G_Q = sum_j Q_j^T Q_j (GQA group stack, Thm 5),
    G_V = V^T V

per (layer, kv-head) in float64 on the host, which is exact for every
solver in ``projections.py`` and needs O(heads * d^2) memory instead of
O(T * d).  The captures arrive as host numpy arrays: the torch ``LM``
copies them off the device before they get here.

Interface contract with the model: ``model.calibrate(params, tokens)``
returns per-attention-layer captures ``{"k": (B,Hkv,T,dk), "q": (B,H,T,dk),
"v": (B,Hkv,T,dv)}`` (post-RoPE; MLA layers emit the latent as k/v with the
absorbed per-head queries — see DESIGN.md) and the model exposes the
per-group stacked output weights ``(Hkv, dv, Do_group)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.config import CompressionConfig
from repro_torch.core.projections import (Factors, KeyProjection,
                                          ValueProjection, select_rank,
                                          solve_key, solve_value)


@dataclass
class LayerGrams:
    """Gram statistics for one attention layer (per kv head)."""

    g_k: np.ndarray            # (Hkv, dk, dk)
    g_q: np.ndarray            # (Hkv, dk, dk) — group-stacked queries
    g_v: np.ndarray            # (Hkv, dv, dv)
    tokens: int = 0


@dataclass
class ModelProjections:
    """Solved projections for every attention layer, shape-uniform.

    Arrays are zero-padded to the layer-max rank so they stack cleanly for
    scan-over-layers execution; ``ranks_k``/``ranks_v`` record the true
    per-layer ranks (paper's per-layer selection).
    """

    a_k: np.ndarray            # (L_attn, Hkv, dk, R)
    b_q: np.ndarray            # (L_attn, Hkv, dk, R)
    a_v: Optional[np.ndarray]  # (L_attn, Hkv, dv, Rv)
    c_v: Optional[np.ndarray]  # (L_attn, Hkv, Rv, Do_group)
    ranks_k: List[int] = field(default_factory=list)
    ranks_v: List[int] = field(default_factory=list)
    method: str = "kqsvd"

    @property
    def rank_k(self) -> int:
        return self.a_k.shape[-1]

    @property
    def rank_v(self) -> int:
        return 0 if self.a_v is None else self.a_v.shape[-1]


class GramAccumulator:
    """Streaming Gram accumulation over calibration batches."""

    def __init__(self, n_layers: int):
        self.layers: List[Optional[LayerGrams]] = [None] * n_layers

    def update(self, ordinal: int, k: np.ndarray, q: np.ndarray,
               v: np.ndarray) -> None:
        """Accumulate one batch of captures for attention layer ``ordinal``.

        k: (B, Hkv, T, dk), q: (B, H, T, dk), v: (B, Hkv, T, dv).
        """
        k = np.asarray(k, np.float64)
        q = np.asarray(q, np.float64)
        v = np.asarray(v, np.float64)
        B, Hkv, T, dk = k.shape
        H = q.shape[1]
        m = H // Hkv
        # group-stack queries: head j belongs to group j // m
        qg = q.reshape(B, Hkv, m * T, dk)
        g_k = _head_grams(k)
        g_q = _head_grams(qg)
        g_v = _head_grams(v)
        st = self.layers[ordinal]
        if st is None:
            self.layers[ordinal] = LayerGrams(g_k, g_q, g_v, B * T)
        else:
            st.g_k += g_k
            st.g_q += g_q
            st.g_v += g_v
            st.tokens += B * T

    def update_from_captures(self, captures: Sequence[Dict]) -> None:
        for ordinal, cap in enumerate(captures):
            self.update(ordinal, cap["k"], cap["q"], cap["v"])

    # -- solving -----------------------------------------------------------

    def layer_factors(self, ordinal: int):
        st = self.layers[ordinal]
        assert st is not None, f"no statistics for layer {ordinal}"
        fk = [Factors.from_gram(g) for g in st.g_k]
        fq = [Factors.from_gram(g) for g in st.g_q]
        fv = [Factors.from_gram(g) for g in st.g_v]
        return fk, fq, fv

    def solve(self, cfg: CompressionConfig,
              w_out: Sequence[np.ndarray]) -> ModelProjections:
        """Solve projections for every layer with statistics.

        ``w_out[l]``: (Hkv, dv, Do_group) stacked output weights per layer.
        Rank: per-layer energy rule (paper) unless cfg.rank_{k,v} pins it;
        arrays are zero-padded to the max rank for shape uniformity.
        """
        assert cfg.method != "none"
        n = len(self.layers)
        key_projs: List[List[KeyProjection]] = []
        val_projs: List[List[ValueProjection]] = []
        ranks_k: List[int] = []
        ranks_v: List[int] = []
        for l in range(n):
            fk, fq, fv = self.layer_factors(l)
            rk = cfg.rank_k or select_rank(tuple(fk), cfg.epsilon)
            rv = cfg.rank_v or select_rank(tuple(fv), cfg.epsilon)
            ranks_k.append(rk)
            ranks_v.append(rv)
            key_projs.append([solve_key(cfg.method, fk[h], fq[h], rk)
                              for h in range(len(fk))])
            if cfg.compress_values:
                val_projs.append([solve_value(cfg.method, fv[h],
                                              w_out[l][h], rv)
                                  for h in range(len(fv))])
        Rk = max(ranks_k)
        a_k = _stack_pad([[p.A for p in layer] for layer in key_projs], Rk)
        b_q = _stack_pad([[p.B for p in layer] for layer in key_projs], Rk)
        a_v = c_v = None
        if cfg.compress_values:
            Rv = max(ranks_v)
            a_v = _stack_pad([[p.A for p in layer] for layer in val_projs],
                             Rv)
            c_v = _stack_pad_rows([[p.C for p in layer]
                                   for layer in val_projs], Rv)
        return ModelProjections(a_k=a_k, b_q=b_q, a_v=a_v, c_v=c_v,
                                ranks_k=ranks_k, ranks_v=ranks_v,
                                method=cfg.method)


def _head_grams(x: np.ndarray) -> np.ndarray:
    """(B, H, T, d) -> (H, d, d) per-head Gram ``sum_bt x^T x``, as one
    float64 matrix product per head (BLAS; an einsum over all axes is
    the same sum, taken in another order)."""
    rows = x.transpose(1, 0, 2, 3).reshape(x.shape[1], -1, x.shape[-1])
    return np.matmul(rows.transpose(0, 2, 1), rows)


def _stack_pad(layers: List[List[np.ndarray]], R: int) -> np.ndarray:
    """Stack (d, r_l) factors into (L, H, d, R), zero-padding columns."""
    out = []
    for layer in layers:
        heads = []
        for M in layer:
            pad = R - M.shape[1]
            heads.append(np.pad(M, ((0, 0), (0, pad))) if pad else M)
        out.append(np.stack(heads))
    return np.stack(out)


def _stack_pad_rows(layers: List[List[np.ndarray]], R: int) -> np.ndarray:
    """Stack (r_l, Do) factors into (L, H, R, Do), zero-padding rows."""
    out = []
    for layer in layers:
        heads = []
        for M in layer:
            pad = R - M.shape[0]
            heads.append(np.pad(M, ((0, pad), (0, 0))) if pad else M)
        out.append(np.stack(heads))
    return np.stack(out)


# ---------------------------------------------------------------------------
# Driver: calibrate a model over a token stream
# ---------------------------------------------------------------------------


def calibrate_model(model, params, batches, cfg: CompressionConfig
                    ) -> ModelProjections:
    """Run calibration batches through ``model`` and solve projections.

    ``model`` follows the model protocol: ``model.calibrate(params,
    tokens)`` returns per-attention-layer captures, and
    ``model.group_output_weights(params)`` the stacked (Hkv, dv, Do_group)
    output weights per attention layer.
    """
    acc: Optional[GramAccumulator] = None
    for batch in batches:
        captures = model.calibrate(params, batch)
        if acc is None:
            acc = GramAccumulator(len(captures))
        acc.update_from_captures(captures)
    assert acc is not None, "no calibration batches supplied"
    w_out = model.group_output_weights(params)
    return acc.solve(cfg, w_out)
