"""The paper's theorems on the port's closed-form solvers and its copy of
``core/theory.py``: every case of tests/test_projections.py (Thms 1-5)
and of tests/test_theory_properties.py (hypothesis), and the port's
theory functions equal to the reference's on the same arrays."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core.projections import (Factors,
                                          key_projection_from_caches,
                                          kq_singular_values,
                                          value_projection_from_caches)
from repro_torch.core.svd import (energy_rank, gram, gram_factors,
                                  right_factors)
from repro_torch.core.theory import (ksvd_error, mha_outputs, opt_error,
                                     relative_fro, score_error, thm1_bound,
                                     thm3_gap)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def low_rank_ish(rng, T, d, decay=3.0):
    return rng.normal(size=(T, d)) @ np.diag(
        np.exp(-decay * np.arange(d) / d))


@pytest.fixture
def kq(rng):
    T, d = 256, 32
    return low_rank_ish(rng, T, d), rng.normal(size=(T, d))


def test_thm2_matches_bruteforce_svd(kq):
    K, Q = kq
    for R in (2, 8, 16):
        pk = key_projection_from_caches("kqsvd", K, Q, R)
        err = score_error(K, Q, pk)
        s = np.linalg.svd(K @ Q.T, compute_uv=False)
        assert np.isclose(err, np.sum(s[R:] ** 2), rtol=1e-8)


def test_kqsvd_is_optimal_among_methods(kq):
    K, Q = kq
    for R in (4, 8, 16):
        errs = {m: score_error(K, Q,
                               key_projection_from_caches(m, K, Q, R))
                for m in ("kqsvd", "ksvd", "eigen")}
        assert errs["kqsvd"] <= errs["ksvd"] + 1e-9
        assert errs["kqsvd"] <= errs["eigen"] + 1e-9


def test_thm3_identity_and_nonnegative_gap(kq):
    K, Q = kq
    for R in (4, 12):
        g = thm3_gap(K, Q, R)
        assert np.isclose(g["lhs"], g["rhs"], rtol=1e-6, atol=1e-8)
        assert g["lhs"] >= -1e-8


def test_thm4_eigen_degenerates_to_ksvd(kq):
    """beta -> inf: Eigen's subspace converges to K-SVD's."""
    K, Q = kq
    R = 8
    e_ksvd = ksvd_error(K, Q, R)
    gaps = []
    for beta in (1.0, 10.0, 100.0, 1000.0):
        pe = key_projection_from_caches("eigen", K * beta, Q / beta, R)
        # rescaling leaves K Q^T unchanged; evaluate on original K, Q
        err = score_error(K * beta, Q / beta, pe)
        gaps.append(abs(err - e_ksvd))
    assert gaps[-1] < gaps[0]
    assert gaps[-1] / max(e_ksvd, 1e-12) < 1e-3


def test_kqsvd_invariant_to_rescaling(kq):
    K, Q = kq
    R = 8
    base = score_error(K, Q, key_projection_from_caches("kqsvd", K, Q, R))
    for beta in (0.1, 10.0, 1000.0):
        p = key_projection_from_caches("kqsvd", K * beta, Q / beta, R)
        err = score_error(K * beta, Q / beta, p)
        assert np.isclose(err, base, rtol=1e-6)


def test_thm5_gqa_stacking(rng):
    """Stacked-queries solution is optimal for the group objective."""
    T, d, R, m = 128, 16, 5, 4
    K = low_rank_ish(rng, T, d)
    Qs = [rng.normal(size=(T, d)) for _ in range(m)]
    Qstack = np.concatenate(Qs, axis=0)
    p = key_projection_from_caches("kqsvd", K, Qstack, R)
    group_err = sum(score_error(K, Qi, p) for Qi in Qs)
    assert np.isclose(group_err, score_error(K, Qstack, p), rtol=1e-9)
    s = np.linalg.svd(K @ Qstack.T, compute_uv=False)
    assert np.isclose(group_err, np.sum(s[R:] ** 2), rtol=1e-7)


def test_gram_path_equals_exact_path(kq):
    K, Q = kq
    for method in ("kqsvd", "ksvd", "eigen"):
        pg = key_projection_from_caches(method, K, Q, 8, use_gram=True)
        pe = key_projection_from_caches(method, K, Q, 8, use_gram=False)
        assert np.isclose(score_error(K, Q, pg), score_error(K, Q, pe),
                          rtol=1e-6)


def test_value_output_optimality(rng):
    T, d, D, R = 200, 16, 48, 6
    V = low_rank_ish(rng, T, d)
    W = rng.normal(size=(d, D))
    pv = value_projection_from_caches("kqsvd", V, W, R)
    err = np.linalg.norm((V @ pv.A) @ pv.C - V @ W, "fro") ** 2
    s = np.linalg.svd(V @ W, compute_uv=False)
    assert np.isclose(err, np.sum(s[R:] ** 2), rtol=1e-7)
    pb = value_projection_from_caches("ksvd", V, W, R)
    errb = np.linalg.norm((V @ pb.A) @ pb.C - V @ W, "fro") ** 2
    assert err <= errb + 1e-9


def test_efficient_kq_singular_values(rng):
    K = low_rank_ish(rng, 100, 12)
    Q = rng.normal(size=(80, 12))
    s_fast = kq_singular_values(Factors.from_matrix(K),
                                Factors.from_matrix(Q))
    s_true = np.linalg.svd(K @ Q.T, compute_uv=False)
    np.testing.assert_allclose(s_fast, s_true[: len(s_fast)], rtol=1e-8,
                               atol=1e-10)


def test_thm1_upper_bound_holds(rng):
    """Thm 1: the output-error bound dominates the actual error
    (single-head instance, spectral norm)."""
    T, d, D, R = 64, 16, 24, 6
    K = low_rank_ish(rng, T, d)
    Q = rng.normal(size=(T, d))
    V = low_rank_ish(rng, T, d)
    W = rng.normal(size=(d, D))
    kp = key_projection_from_caches("kqsvd", K, Q, R)
    vp = value_projection_from_caches("kqsvd", V, W, R)
    o = mha_outputs(K, Q, V, W, kp, vp)
    actual = np.linalg.norm(o["out"] - o["out_approx"], 2)
    K_approx = K @ kp.A @ kp.B.T
    # the value path approximates V W directly; bound it via an effective
    # V_tilde = V A C W^+ (pseudo-inverse pullback)
    V_approx = (V @ vp.A) @ vp.C @ np.linalg.pinv(W)
    bound = thm1_bound(K, Q, V, W, K_approx, V_approx)
    assert actual <= bound + 1e-8, (actual, bound)


sizes = st.tuples(st.integers(20, 80), st.integers(4, 16),
                  st.integers(1, 8))


def _mats(T, d, seed):
    rng = np.random.default_rng(seed)
    K = rng.normal(size=(T, d)) @ np.diag(
        np.exp(-2.0 * np.arange(d) / d))
    Q = rng.normal(size=(T, d))
    return K, Q


@settings(max_examples=25, deadline=None)
@given(sizes, st.integers(0, 2**31 - 1))
def test_optimality_ordering(size, seed):
    T, d, R = size
    R = min(R, d - 1) or 1
    K, Q = _mats(T, d, seed)
    opt = opt_error(K, Q, R)
    for m in ("ksvd", "eigen"):
        err = score_error(K, Q, key_projection_from_caches(m, K, Q, R))
        assert err >= opt - 1e-6 * max(1.0, opt)
    ekq = score_error(K, Q, key_projection_from_caches("kqsvd", K, Q, R))
    assert np.isclose(ekq, opt, rtol=1e-6, atol=1e-8)


@settings(max_examples=25, deadline=None)
@given(sizes, st.floats(0.01, 100.0), st.integers(0, 2**31 - 1))
def test_scale_invariance(size, beta, seed):
    T, d, R = size
    R = min(R, d - 1) or 1
    K, Q = _mats(T, d, seed)
    e1 = score_error(K, Q, key_projection_from_caches("kqsvd", K, Q, R))
    e2 = score_error(K * beta, Q / beta,
                     key_projection_from_caches("kqsvd", K * beta,
                                                Q / beta, R))
    assert np.isclose(e1, e2, rtol=1e-5, atol=1e-8)


@settings(max_examples=25, deadline=None)
@given(sizes, st.integers(0, 2**31 - 1))
def test_thm3_gap_nonnegative(size, seed):
    T, d, R = size
    R = min(R, d - 1) or 1
    K, Q = _mats(T, d, seed)
    gap = ksvd_error(K, Q, R) - opt_error(K, Q, R)
    assert gap >= -1e-6 * max(1.0, opt_error(K, Q, R))


@settings(max_examples=30, deadline=None)
@given(st.integers(2, 64), st.floats(0.001, 0.9),
       st.integers(0, 2**31 - 1))
def test_energy_rank_properties(d, eps, seed):
    rng = np.random.default_rng(seed)
    sigma = np.sort(np.abs(rng.normal(size=d)))[::-1]
    R = energy_rank(sigma, eps)
    assert 1 <= R <= d
    s2 = sigma ** 2
    assert s2[:R].sum() >= (1 - eps) * s2.sum() - 1e-12
    if R > 1:
        assert s2[: R - 1].sum() < (1 - eps) * s2.sum() + 1e-12
    # monotone: smaller eps -> rank at least as large
    assert energy_rank(sigma, eps / 2) >= R


@settings(max_examples=20, deadline=None)
@given(st.integers(10, 60), st.integers(3, 12),
       st.integers(0, 2**31 - 1))
def test_gram_factors_match_svd(T, d, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(T, d))
    Vg, sg = gram_factors(gram(M))
    Ve, se = right_factors(M)
    np.testing.assert_allclose(sg[: len(se)], se, rtol=1e-6, atol=1e-8)
    # compare projectors (signs/rotations of V may differ)
    Pg = Vg[:, :3] @ Vg[:, :3].T
    Pe = Ve[:, :3] @ Ve[:, :3].T
    gap = se[2] - se[3] if len(se) > 3 else 1.0
    if gap > 1e-3 * se[0]:                     # well-separated subspace
        np.testing.assert_allclose(Pg, Pe, atol=1e-5 / max(gap, 1e-3))


def test_theory_equals_reference(rng):
    """Each formula of the port's ``theory`` gives the reference's number
    on the same float64 arrays and projections."""
    from repro.core import theory as ref
    from repro.core.projections import (
        key_projection_from_caches as ref_key,
        value_projection_from_caches as ref_value)
    T, d, D, R = 64, 16, 24, 6
    K, V = low_rank_ish(rng, T, d), low_rank_ish(rng, T, d)
    Q, W = rng.normal(size=(T, d)), rng.normal(size=(d, D))
    kp, vp = (key_projection_from_caches("kqsvd", K, Q, R),
              value_projection_from_caches("kqsvd", V, W, R))
    rkp, rvp = ref_key("kqsvd", K, Q, R), ref_value("kqsvd", V, W, R)
    assert score_error(K, Q, kp) == ref.score_error(K, Q, rkp)
    assert opt_error(K, Q, R) == ref.opt_error(K, Q, R)
    assert ksvd_error(K, Q, R) == ref.ksvd_error(K, Q, R)
    assert thm3_gap(K, Q, R) == ref.thm3_gap(K, Q, R)
    for causal in (False, True):
        mine = mha_outputs(K, Q, V, W, kp, vp, causal=causal)
        theirs = ref.mha_outputs(K, Q, V, W, rkp, rvp, causal=causal)
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k])
        assert relative_fro(mine["out"], mine["out_approx"]) == \
            ref.relative_fro(theirs["out"], theirs["out_approx"])
    Ka, Va = K @ kp.A @ kp.B.T, V @ vp.A @ vp.C @ np.linalg.pinv(W)
    assert thm1_bound(K, Q, V, W, Ka, Va) == ref.thm1_bound(K, Q, V, W,
                                                            Ka, Va)
