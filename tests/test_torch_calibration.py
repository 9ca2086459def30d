"""Calibration in the port: captures from the torch LM give the same
KQ-SVD projections as the reference's, full-rank compression is exact,
and the synthetic calibration tokens are identical."""
import jax
import numpy as np
import pytest
import torch

from repro.config import CompressionConfig as JaxCompression
from repro.configs import get_config as jax_config
from repro.core.calibration import GramAccumulator as JaxAccumulator
from repro.core.calibration import calibrate_model as jax_calibrate
from repro.data import calibration_batches as jax_batches
from repro.models import build_model as jax_model
from repro_torch import bridge
from repro_torch.config import CompressionConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.core.calibration import GramAccumulator, calibrate_model
from repro_torch.data import calibration_batches
from repro_torch.models import build_model as torch_model


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("vocab,n_seqs,seq_len,batch,seed", [
    (256, 8, 64, 4, 17), (32000, 5, 33, 2, 3)])
def test_calibration_tokens_identical(vocab, n_seqs, seq_len, batch, seed):
    mine = calibration_batches(vocab, n_seqs, seq_len, batch, seed)
    ref = jax_batches(vocab, n_seqs, seq_len, batch, seed)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_gram_accumulator_matches_reference():
    rng = np.random.default_rng(0)
    B, Hkv, H, T, d = 3, 2, 6, 20, 8
    k, q, v = (rng.normal(size=s) for s in ((B, Hkv, T, d), (B, H, T, d),
                                             (B, Hkv, T, d)))
    mine, ref = GramAccumulator(1), JaxAccumulator(1)
    mine.update(0, k, q, v)
    ref.update(0, k, q, v)
    for name in ("g_k", "g_q", "g_v"):
        np.testing.assert_allclose(getattr(mine.layers[0], name),
                                   getattr(ref.layers[0], name),
                                   rtol=1e-12, atol=1e-12)
    assert mine.layers[0].tokens == ref.layers[0].tokens



@pytest.mark.parametrize("L", [1, 6])
def test_solve_in_threads_matches_reference(L):
    """``GramAccumulator.solve`` over one layer (solved alone) and six
    (side by side in threads) gives the reference's serial solve within
    float64 rounding, and leaves numpy's BLAS on as many threads as
    before."""
    from repro_torch.core.calibration import _openblas_thread_setters
    rng = np.random.default_rng(5)
    B, Hkv, H, T, d, Do = 2, 2, 4, 40, 16, 48
    mine, ref = GramAccumulator(L), JaxAccumulator(L)
    for l in range(L):
        k, q, v = (rng.normal(size=s) for s in ((B, Hkv, T, d),
                                                 (B, H, T, d),
                                                 (B, Hkv, T, d)))
        mine.update(l, k, q, v)
        ref.update(l, k, q, v)
    w_out = [rng.normal(size=(Hkv, d, Do)) for _ in range(L)]
    before = [n for _, n in _openblas_thread_setters()]
    got = mine.solve(CompressionConfig(method="kqsvd", epsilon=0.05), w_out)
    want = ref.solve(JaxCompression(method="kqsvd", epsilon=0.05), w_out)
    assert [n for _, n in _openblas_thread_setters()] == before
    assert got.ranks_k == want.ranks_k and got.ranks_v == want.ranks_v
    for name in ("a_k", "b_q", "a_v", "c_v"):
        a, b = getattr(got, name), getattr(want, name)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-12 * np.abs(b).max())

def _models(arch="tinyllama-1.1b"):
    jm = jax_model(jax_config(arch).reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_model(torch_config(arch).reduced(), "cpu")
    return jm, jp, tm, bridge.params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("method", ["kqsvd", "ksvd", "eigen"])
def test_torch_captures_solve_to_reference_projections(method):
    """calibrate_model over the torch LM == over the JAX LM.  Compared
    through sign-free products (A_k B_q^T, A_v C_v): eigenvector signs
    are not part of the solution."""
    jm, jp, tm, tp = _models()
    batches = calibration_batches(jm.cfg.vocab_size, 4, 32, batch=2)
    mine = calibrate_model(tm, tp, batches,
                           CompressionConfig(method=method, epsilon=0.1))
    ref = jax_calibrate(jm, jp, batches,
                        JaxCompression(method=method, epsilon=0.1))
    assert mine.ranks_k == ref.ranks_k and mine.ranks_v == ref.ranks_v
    assert mine.a_k.shape == ref.a_k.shape and mine.c_v.shape == ref.c_v.shape
    for prod, names in (("lhdr,lher->lhde", ("a_k", "b_q")),
                        ("lhdr,lhro->lhdo", ("a_v", "c_v"))):
        got = np.einsum(prod, *(getattr(mine, n) for n in names))
        want = np.einsum(prod, *(getattr(ref, n) for n in names))
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def test_full_rank_compression_is_exact():
    """Full-rank projections reproduce the uncompressed logits (the
    reference's test_compression_e2e bar, 2e-4), prefill and decode."""
    jm, jp, tm, tp = _models()
    cfg = tm.cfg
    batches = calibration_batches(cfg.vocab_size, 6, 32, batch=2)
    mp = calibrate_model(tm, tp, batches, CompressionConfig(
        method="kqsvd", rank_k=cfg.d_head, rank_v=cfg.d_head))
    proj = tm.projections_pytree(mp)
    B, S, extra = 2, 16, 4
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (B, S + extra))
    lr, cr = tm.prefill(tp, toks[:, :S], S + extra)
    lc, cc = tm.prefill(tp, toks[:, :S], S + extra, proj=proj)
    np.testing.assert_allclose(lc.numpy(), lr.numpy(), rtol=2e-4, atol=2e-4)
    for t in range(extra):
        tok = toks[:, S + t: S + t + 1]
        lr, cr = tm.decode_step(tp, cr, tok, S + t)
        lc, cc = tm.decode_step(tp, cc, tok, S + t, proj=proj)
        np.testing.assert_allclose(lc.numpy(), lr.numpy(), rtol=2e-4,
                                   atol=2e-4)
