"""SVD helpers used by the projection solvers.

Two interchangeable factor paths:

* ``thin_svd``: exact ``numpy.linalg.svd`` on the (T, d) cache matrix —
  the paper's approach;
* ``gram_factors``: recover right-singular vectors and singular values from
  the d x d Gram matrix — our streaming adaptation (DESIGN.md §4.1), which
  never materializes the T x d calibration matrix.

All solver code consumes the ``(V, sigma)`` pair, so both paths are
property-tested to agree.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def thin_svd(M: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Thin SVD, float64, descending singular values."""
    U, s, Vt = np.linalg.svd(np.asarray(M, dtype=np.float64),
                             full_matrices=False)
    return U, s, Vt.T


def right_factors(M: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(V, sigma) of M from an exact SVD."""
    _, s, V = thin_svd(M)
    return V, s


def gram(M: np.ndarray) -> np.ndarray:
    """d x d Gram matrix in float64."""
    M = np.asarray(M, dtype=np.float64)
    return M.T @ M


def gram_factors(G: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(V, sigma) of the original matrix from its Gram matrix.

    eigh(G) = V diag(sigma^2) V^T.  Eigenvalues are clipped at zero before
    the square root (they can go slightly negative in floating point).
    """
    G = np.asarray(G, dtype=np.float64)
    G = 0.5 * (G + G.T)
    w, V = np.linalg.eigh(G)
    w = np.clip(w, 0.0, None)
    order = np.argsort(w)[::-1]
    w = w[order]
    V = V[:, order]
    return V, np.sqrt(w)


def safe_inv_sigma(sigma: np.ndarray, rcond: float = 1e-12) -> np.ndarray:
    """Pseudo-inverse of a singular-value vector (Moore–Penrose style)."""
    smax = sigma.max() if sigma.size else 0.0
    cutoff = rcond * smax
    inv = np.zeros_like(sigma)
    nz = sigma > cutoff
    inv[nz] = 1.0 / sigma[nz]
    return inv


def energy_rank(sigma: np.ndarray, epsilon: float) -> int:
    """Smallest R with sum_{j<=R} sigma_j^2 >= (1-eps) * sum sigma_j^2.

    The paper's rank-selection rule (§3.3).  Returns at least 1.
    """
    s2 = np.asarray(sigma, dtype=np.float64) ** 2
    total = s2.sum()
    if total <= 0.0:
        return 1
    c = np.cumsum(s2) / total
    R = int(np.searchsorted(c, 1.0 - epsilon) + 1)
    return max(1, min(R, len(s2)))
