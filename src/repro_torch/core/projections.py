"""Closed-form low-rank projection solvers (the paper's contribution).

Key/query path — given per-head calibration caches K in R^{T x d} and
Q in R^{T_q x d} (T_q = m*T under GQA stacking, Thm 5), produce factors
(A, B) in R^{d x R} such that scores are computed as (qB)(kA)^T:

* ``kqsvd``  — Thm 2 optimum:  A = K^+ U_hat, B = K^T U_hat with U_hat the
  top-R left singular vectors of K Q^T.  Computed via the O(T d^2) core-
  matrix trick (never forming the T x T_q product):
      K = U_K S_K V_K^T,  Q = U_Q S_Q V_Q^T,
      M = S_K V_K^T V_Q S_Q = U' S' V'^T        (r_k x r_q, tiny)
      => SVD(K Q^T) = (U_K U') S' (U_Q V')^T    [paper's App. has a typo:
                                                 right factor is U_Q V']
      A = V_K S_K^{-1} U'_R,   B = V_K S_K U'_R.
* ``ksvd``   — A = B = top-R right singular vectors of K (Palu/LoRC/ECKVH).
* ``eigen``  — A = B = top-R right singular vectors of [K; Q]
  (EigenAttention/Zack); equals eigenvectors of G_K + G_Q.

Value/output path (App. B) — given V in R^{T x d} and the (stacked) output
projection W in R^{d x Do}, produce A_v in R^{d x Rv} and C in R^{Rv x Do}
with  V A_v C  ~=  V W:

* ``kqsvd``:  N = S_V V_V^T W = U' S' V'^T,
              A_v = V_V S_V^{-1} U'_R,  C = S'_R V'^T_R.
* baselines:  A_v = top-R right singular vectors of V, C = A_v^T W.

Every solver accepts either raw caches or precomputed Gram matrices (the
streaming calibration path); both are supported through ``Factors``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.svd import (energy_rank, gram, gram_factors,
                                  right_factors, safe_inv_sigma, thin_svd)


@dataclass
class Factors:
    """Right-singular factors (V, sigma) of a calibration matrix."""

    V: np.ndarray       # (d, r)
    sigma: np.ndarray   # (r,)

    @staticmethod
    def from_matrix(M: np.ndarray) -> "Factors":
        V, s = right_factors(M)
        return Factors(V, s)

    @staticmethod
    def from_gram(G: np.ndarray) -> "Factors":
        V, s = gram_factors(G)
        return Factors(V, s)


@dataclass
class KeyProjection:
    """Score-path factors: scores = (q @ B) @ (k @ A)^T / sqrt(d)."""

    A: np.ndarray       # (d, R)
    B: np.ndarray       # (d, R)
    method: str = "kqsvd"

    @property
    def rank(self) -> int:
        return self.A.shape[1]


@dataclass
class ValueProjection:
    """Output-path factors: out = p @ (v @ A) @ C  (C absorbs W^O)."""

    A: np.ndarray       # (d, Rv)
    C: np.ndarray       # (Rv, Do)
    method: str = "kqsvd"

    @property
    def rank(self) -> int:
        return self.A.shape[1]


# ---------------------------------------------------------------------------
# Core-matrix machinery
# ---------------------------------------------------------------------------


def kq_core_matrix(fk: Factors, fq: Factors) -> np.ndarray:
    """M = S_K V_K^T V_Q S_Q — the tiny core whose SVD gives SVD(KQ^T)."""
    return (fk.sigma[:, None] * (fk.V.T @ fq.V)) * fq.sigma[None, :]


def kq_singular_values(fk: Factors, fq: Factors) -> np.ndarray:
    """Singular values of K Q^T, via the core matrix (O(d^3))."""
    M = kq_core_matrix(fk, fq)
    return np.linalg.svd(M, compute_uv=False)


# ---------------------------------------------------------------------------
# Key/query solvers
# ---------------------------------------------------------------------------


def solve_kq_svd(fk: Factors, fq: Factors, rank: int) -> KeyProjection:
    """Thm 2 optimum from factored calibration statistics."""
    M = kq_core_matrix(fk, fq)
    Um, _, _ = thin_svd(M)
    R = min(rank, Um.shape[1])
    Ur = Um[:, :R]
    inv_s = safe_inv_sigma(fk.sigma)
    A = fk.V @ (inv_s[:, None] * Ur)
    B = fk.V @ (fk.sigma[:, None] * Ur)
    return KeyProjection(A=A, B=B, method="kqsvd")


def solve_k_svd(fk: Factors, rank: int) -> KeyProjection:
    R = min(rank, fk.V.shape[1])
    P = fk.V[:, :R]
    return KeyProjection(A=P, B=P, method="ksvd")


def solve_eigen(fk: Factors, fq: Factors, rank: int) -> KeyProjection:
    """Top-R right singular vectors of [K; Q] == eigvecs of G_K + G_Q."""
    GK = fk.V @ np.diag(fk.sigma ** 2) @ fk.V.T
    GQ = fq.V @ np.diag(fq.sigma ** 2) @ fq.V.T
    V, _ = gram_factors(GK + GQ)
    R = min(rank, V.shape[1])
    P = V[:, :R]
    return KeyProjection(A=P, B=P, method="eigen")


def solve_key(method: str, fk: Factors, fq: Optional[Factors],
              rank: int) -> KeyProjection:
    if method == "kqsvd":
        assert fq is not None, "KQ-SVD needs query statistics"
        return solve_kq_svd(fk, fq, rank)
    if method == "ksvd":
        return solve_k_svd(fk, rank)
    if method == "eigen":
        assert fq is not None, "Eigen needs query statistics"
        return solve_eigen(fk, fq, rank)
    raise ValueError(f"unknown method {method!r}")


# ---------------------------------------------------------------------------
# Value/output solvers (App. B)
# ---------------------------------------------------------------------------


def solve_value_output(fv: Factors, W: np.ndarray,
                       rank: int) -> ValueProjection:
    """min_{A,C} ||V A C - V W||_F via SVD of N = S_V V_V^T W."""
    W = np.asarray(W, dtype=np.float64)
    N = (fv.sigma[:, None] * (fv.V.T @ W))
    Un, sn, Vn = thin_svd(N)
    R = min(rank, Un.shape[1])
    inv_s = safe_inv_sigma(fv.sigma)
    A = fv.V @ (inv_s[:, None] * Un[:, :R])
    C = sn[:R, None] * Vn[:, :R].T
    return ValueProjection(A=A, C=C, method="kqsvd")


def solve_value_plain(fv: Factors, W: np.ndarray,
                      rank: int) -> ValueProjection:
    """Baseline: SVD of V alone; C = A^T W (K-SVD-style value path)."""
    R = min(rank, fv.V.shape[1])
    A = fv.V[:, :R]
    C = A.T @ np.asarray(W, dtype=np.float64)
    return ValueProjection(A=A, C=C, method="ksvd")


def solve_value(method: str, fv: Factors, W: np.ndarray,
                rank: int) -> ValueProjection:
    if method == "kqsvd":
        return solve_value_output(fv, W, rank)
    return solve_value_plain(fv, W, rank)


# ---------------------------------------------------------------------------
# Rank selection (paper §3.3 / §6 "Rank selection")
# ---------------------------------------------------------------------------


def select_rank(factors_per_head: Tuple[Factors, ...],
                epsilon: float) -> int:
    """Per-layer rank: energy rule on the head-averaged spectrum."""
    spectra = np.stack([f.sigma[: min(len(f.sigma) for f in
                                      factors_per_head)]
                        for f in factors_per_head])
    mean_sigma = spectra.mean(axis=0)
    return energy_rank(mean_sigma, epsilon)


# ---------------------------------------------------------------------------
# Convenience: solve from raw matrices (tests / small benchmarks)
# ---------------------------------------------------------------------------


def key_projection_from_caches(method: str, K: np.ndarray,
                               Q: Optional[np.ndarray],
                               rank: int, use_gram: bool = False
                               ) -> KeyProjection:
    if use_gram:
        fk = Factors.from_gram(gram(K))
        fq = Factors.from_gram(gram(Q)) if Q is not None else None
    else:
        fk = Factors.from_matrix(K)
        fq = Factors.from_matrix(Q) if Q is not None else None
    return solve_key(method, fk, fq, rank)


def value_projection_from_caches(method: str, V: np.ndarray, W: np.ndarray,
                                 rank: int, use_gram: bool = False
                                 ) -> ValueProjection:
    fv = Factors.from_gram(gram(V)) if use_gram else Factors.from_matrix(V)
    return solve_value(method, fv, W, rank)
