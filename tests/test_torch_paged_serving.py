"""The port's paged engine against the reference's (greedy, reduced
tinyllama-1.1b, float32, bridged weights): the same out_tokens with the
exact-length paged prefill and with chunked prefill, on the cases of the
reference's test_chunked_prefill.py and test_paged_cache.py — chunk
boundaries, refill, an oversubscribed pool, truncation, the compressed
cache at calibrated ranks (K1's and K2's plain versions on the CPU) and a
decode next to a slot that prefills.  Every drain must return the whole
pool."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.config import CompressionConfig as JaxCompression
from repro.config import ServeConfig as JaxServe
from repro.configs import get_config as jax_config
from repro.core.calibration import GramAccumulator
from repro.models import build_model as jax_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.config import ServeConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.serving import Request, ServingEngine, pages_needed


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CHUNK = 4


@functools.lru_cache(maxsize=None)
def models():
    jcfg = jax_config("tinyllama-1.1b").reduced()
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    acc = GramAccumulator(len(jm.attn_layers))
    for i in range(2):
        toks = np.random.default_rng(5 + i).integers(
            0, jcfg.vocab_size, (2, 32)).astype(np.int32)
        acc.update_from_captures([jax.tree.map(np.asarray, c)
                                  for c in jm.calibrate(jp, toks)])
    mp = acc.solve(JaxCompression(method="kqsvd", epsilon=0.1),
                   jm.group_output_weights(jp))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return (jcfg, jp, torch_config("tinyllama-1.1b").reduced(), tp, mp,
            bridge.projections_from_jax(mp))


def _prompts(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, L).astype(np.int32) for L in lens]


def _paged(**kw):
    base = dict(max_seq_len=64, max_batch=4, temperature=0.0,
                decode_chunk=4, paged=True, page_size=4)
    base.update(kw)
    return base


def _chunked(**kw):
    return _paged(chunked_prefill=True, prefill_chunk=CHUNK,
                  prefill_buckets=(2, CHUNK), **kw)


def serve_both(prompts, max_new, sc_kw, compressed=False):
    """Serve the same requests on both engines: identical greedy tokens,
    and each drain returns the whole pool.  Returns the port's engine and
    requests."""
    jcfg, jp, tcfg, tp, jmp, tmp = models()
    jeng = JaxEngine(jcfg, jp, JaxServe(**sc_kw),
                     projections=jmp if compressed else None)
    teng = ServingEngine(tcfg, tp, ServeConfig(**sc_kw),
                         projections=tmp if compressed else None,
                         device="cpu")
    jr = [JaxRequest(rid=i, prompt=p, max_new_tokens=max_new)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p, max_new_tokens=max_new)
          for i, p in enumerate(prompts)]
    jeng.generate(jr)
    teng.generate(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert [r.truncated for r in tr] == [r.truncated for r in jr]
    for eng in (jeng, teng):
        assert eng.pool.free_count == eng.pool.n_pages
    assert teng.n_prefill_chunks == jeng.n_prefill_chunks
    assert teng.peak_used_pages == jeng.peak_used_pages
    return teng, tr


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["full", "kqsvd"])
def test_exact_length_paged_matches_reference(compressed):
    """``paged`` without chunked prefill: each prompt prefilled at its
    exact length and repaged into the pool; more requests than slots."""
    teng, tr = serve_both(_prompts(3, [3, 9, 6, 12, 5, 8]), 6, _paged(),
                          compressed)
    assert all(r.done and len(r.out_tokens) == 6 for r in tr)
    assert teng.n_prefill_chunks == 0 and not teng.prefill_chunk_shapes


@pytest.mark.parametrize("rem", [0, 1, CHUNK - 1],
                         ids=["chunk-aligned", "one-over", "one-under"])
def test_chunked_matches_reference_at_chunk_boundaries(rem):
    L = 2 * CHUNK + rem
    teng, tr = serve_both(_prompts(7 + rem, [L]), 6, _chunked())
    assert teng.n_prefill_chunks == -(-L // CHUNK)
    assert teng.prefill_chunk_shapes <= set(ServeConfig(
        **_chunked()).buckets)


def test_chunked_mixed_lengths_match_reference():
    """A refilling batch of mixed lengths (more requests than slots),
    many distinct lengths but chunk shapes only from the buckets."""
    prompts = _prompts(11, [3, 9, 6, 12, 5, 8, 1, 13])
    teng, tr = serve_both(prompts, 5, _chunked())
    assert all(r.done and len(r.out_tokens) == 5 for r in tr)
    assert teng.prefill_chunk_shapes <= {2, CHUNK}
    assert teng.n_prefill_tokens == sum(len(p) for p in prompts)


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["exact", "chunked"])
def test_oversubscribed_pool_reuses_pages(chunked):
    """A pool of 12 pages for 4 slots of 8: reserve admission holds
    requests back until pages free up, and freed pages serve later
    requests."""
    kw = (_chunked if chunked else _paged)(max_seq_len=32, n_pages=12)
    prompts = _prompts(19, [9, 14, 6, 11, 3, 12])
    teng, tr = serve_both(prompts, 8, kw)
    assert all(r.done and len(r.out_tokens) == 8 for r in tr)
    assert teng.peak_used_pages <= 12
    assert sum(pages_needed(len(p) + 8, 4) for p in prompts) > 12


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["exact", "chunked"])
def test_truncation_matches_reference(chunked):
    prompt = (np.arange(10) % 256).astype(np.int32)
    kw = (_chunked if chunked else _paged)(max_seq_len=12, max_batch=2)
    _, tr = serve_both([prompt], 8, kw)
    assert tr[0].done and tr[0].truncated and len(tr[0].out_tokens) == 3


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["exact", "chunked"])
def test_compressed_paged_matches_reference(chunked):
    """The KQ-SVD cache at calibrated ranks in pages: decode through
    K1's plain version, chunks through K2's."""
    kw = (_chunked if chunked else _paged)()
    teng, tr = serve_both(_prompts(13, [9, 5, 14, 2, 7]), 5, kw,
                          compressed=True)
    assert teng.ranks[0] < teng.cfg.d_head
    assert all(len(r.out_tokens) == 5 for r in tr)


def test_decode_unchanged_while_other_slot_prefills():
    """A decoding slot's tokens are the same as when served alone while a
    long prompt prefills chunk by chunk next to it, one chunk per step."""
    _, _, tcfg, tp, _, _ = models()
    short, long = _prompts(17, [3, 20])
    kw = _chunked(max_batch=2, prefill_chunks_per_step=1)
    teng, tr = serve_both([short, long], 8, kw)
    # the long prompt needs five chunk steps: the short one decoded beside
    assert teng.n_prefill_chunks == 1 + 5
    for r, p in zip(tr, (short, long)):
        solo = ServingEngine(tcfg, tp, ServeConfig(**kw), device="cpu")
        alone = [Request(rid=0, prompt=p, max_new_tokens=8)]
        solo.generate(alone)
        assert alone[0].out_tokens == r.out_tokens


def test_oversize_request_fails_and_the_rest_serve():
    """A request whose worst case exceeds the whole pool fails with
    ``oversize`` at admission; the batch keeps serving."""
    _, _, tcfg, tp, _, _ = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(**_chunked(
        max_seq_len=32, n_pages=3)), device="cpu")
    reqs = [Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                    max_new_tokens=4),
            Request(rid=1, prompt=np.arange(20, dtype=np.int32),
                    max_new_tokens=4)]
    eng.generate(reqs)
    assert reqs[1].failed and reqs[1].error.kind == "oversize"
    assert reqs[0].done and not reqs[0].failed and \
        len(reqs[0].out_tokens) == 4
    assert eng.error_counts["oversize"] == 1
    assert eng.pool.free_count == eng.pool.n_pages


def test_cancel_mid_prefill_frees_pages():
    _, _, tcfg, tp, _, _ = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(**_chunked(max_batch=2)),
                        device="cpu")
    reqs = [Request(rid=0, prompt=np.arange(20, dtype=np.int32),
                    max_new_tokens=4),
            Request(rid=1, prompt=np.arange(5, dtype=np.int32),
                    max_new_tokens=4)]
    eng.start(reqs)
    eng.step()
    assert eng._prefilled[0] is not None        # still mid-prefill
    assert eng.cancel(0)
    while eng.step():
        pass
    assert reqs[0].error.kind == "cancelled"
    assert len(reqs[1].out_tokens) == 4
    assert eng.pool.free_count == eng.pool.n_pages
