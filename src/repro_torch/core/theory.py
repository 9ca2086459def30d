"""Closed-form error formulas from the paper's theory (Thms 1-4).

The port's copy of the reference's numpy module (it imports no JAX),
over the port's own solvers; the property tests hold both to the
paper's claims:

* ``opt_error``        — Thm 2: opt = sum_{i>R} sigma_i(KQ^T)^2.
* ``score_error``      — ||K A B^T Q^T - K Q^T||_F^2 for any projection.
* ``thm3_gap``         — err_KSVD - opt =
      sum_{i<=R} sigma_i(KQ^T)^2 - ||K V_K V_K^T Q^T||_F^2  >= 0.
* ``thm1_bound``       — the output-error upper bound.
* ``mha_outputs``      — exact vs compressed attention outputs, for the
      relative-error metrics of §6 (Fig. 1 / Fig. 2).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.projections import (Factors, KeyProjection,
                                          ValueProjection,
                                          kq_singular_values)


def score_error(K: np.ndarray, Q: np.ndarray, proj: KeyProjection) -> float:
    """||(K A) (Q B)^T - K Q^T||_F^2 (float64)."""
    K = np.asarray(K, np.float64)
    Q = np.asarray(Q, np.float64)
    approx = (K @ proj.A) @ (Q @ proj.B).T
    return float(np.linalg.norm(approx - K @ Q.T, "fro") ** 2)


def opt_error(K: np.ndarray, Q: np.ndarray, rank: int) -> float:
    """Thm 2: optimal error = tail spectral energy of K Q^T."""
    s = kq_singular_values(Factors.from_matrix(K), Factors.from_matrix(Q))
    return float(np.sum(s[rank:] ** 2))


def ksvd_error(K: np.ndarray, Q: np.ndarray, rank: int) -> float:
    """err_KSVD = ||K Vk Vk^T Q^T - K Q^T||_F^2."""
    _, _, V = np.linalg.svd(np.asarray(K, np.float64), full_matrices=False)
    Vk = V[:rank].T
    K = np.asarray(K, np.float64)
    Q = np.asarray(Q, np.float64)
    return float(np.linalg.norm(K @ Vk @ Vk.T @ Q.T - K @ Q.T, "fro") ** 2)


def thm3_gap(K: np.ndarray, Q: np.ndarray, rank: int) -> Dict[str, float]:
    """Both sides of Thm 3's identity; callers assert they match and >= 0."""
    K64 = np.asarray(K, np.float64)
    Q64 = np.asarray(Q, np.float64)
    s = kq_singular_values(Factors.from_matrix(K64),
                           Factors.from_matrix(Q64))
    _, _, V = np.linalg.svd(K64, full_matrices=False)
    Vk = V[:rank].T
    projected = K64 @ Vk @ Vk.T @ Q64.T
    lhs = ksvd_error(K, Q, rank) - opt_error(K, Q, rank)
    rhs = float(np.sum(s[:rank] ** 2) - np.linalg.norm(projected, "fro") ** 2)
    return {"lhs": lhs, "rhs": rhs}


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def mha_outputs(K: np.ndarray, Q: np.ndarray, V: np.ndarray,
                W: np.ndarray,
                kproj: Optional[KeyProjection],
                vproj: Optional[ValueProjection],
                causal: bool = False) -> Dict[str, np.ndarray]:
    """Exact vs compressed single-head attention outputs.

    Returns exact / approx outputs plus the intermediate score matrices,
    for the Fig. 1-style relative-error metrics.
    """
    K = np.asarray(K, np.float64)
    Q = np.asarray(Q, np.float64)
    V = np.asarray(V, np.float64)
    W = np.asarray(W, np.float64)
    d = K.shape[1]
    scores = Q @ K.T / np.sqrt(d)
    if kproj is not None:
        scores_a = (Q @ kproj.B) @ (K @ kproj.A).T / np.sqrt(d)
    else:
        scores_a = scores
    if causal:
        Tq, Tk = scores.shape
        mask = np.triu(np.ones((Tq, Tk), bool), k=Tk - Tq + 1)
        scores = np.where(mask, -np.inf, scores)
        scores_a = np.where(mask, -np.inf, scores_a)
    P = softmax(scores)
    Pa = softmax(scores_a)
    out = P @ (V @ W)
    if vproj is not None:
        out_a = Pa @ ((V @ vproj.A) @ vproj.C)
    else:
        out_a = Pa @ (V @ W)
    return {"out": out, "out_approx": out_a,
            "scores": scores, "scores_approx": scores_a}


def relative_fro(M: np.ndarray, Mt: np.ndarray) -> float:
    """Paper's metric: ||M - Mt||_F^2 / ||M||_F^2."""
    denom = float(np.linalg.norm(M, "fro") ** 2)
    if denom == 0.0:
        return 0.0
    return float(np.linalg.norm(M - Mt, "fro") ** 2) / denom


def thm1_bound(K: np.ndarray, Q: np.ndarray, V: np.ndarray, W: np.ndarray,
               K_approx: np.ndarray, V_approx: np.ndarray) -> float:
    """Single-head instance of the Thm 1 upper bound (spectral norms)."""
    d = K.shape[1]
    VW = np.asarray(V, np.float64) @ np.asarray(W, np.float64)
    VWa = np.asarray(V_approx, np.float64) @ np.asarray(W, np.float64)
    t1 = (np.linalg.norm(VW, 2) / np.sqrt(d)
          * np.linalg.norm(Q @ (K - K_approx).T, 2))
    t2 = np.linalg.norm(VW - VWa, 2)
    return float(t1 + t2)
