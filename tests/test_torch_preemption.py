"""The port's optimistic admission with preempt-and-requeue against the
reference's, case for case with tests/test_preemption.py (greedy, reduced
tinyllama-1.1b, float32, bridged weights): under an oversubscribed pool
both ``preempt_mode`` values give the JAX engine's tokens, which are also
the reserve engine's on an ample pool, with the same preemptions, swaps
and victims; LIFO and priority victims, the admission window, the
same-step refill and the oversize failure.  Every drain returns the whole
pool."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JaxServe
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.config import ServeConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.serving import Request, ServingEngine


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def models():
    jcfg = jax_config("tinyllama-1.1b").reduced()
    jp = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, jp, torch_config("tinyllama-1.1b").reduced(), tp


def _prompts(lens, seed=3):
    vocab = models()[2].vocab_size
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _reqs(cls, prompts, max_new, priorities=None):
    pr = priorities or [0] * len(prompts)
    return [cls(rid=i, prompt=p, max_new_tokens=max_new, priority=q)
            for i, (p, q) in enumerate(zip(prompts, pr))]


def run_port(sc_kw, prompts, max_new=6, priorities=None):
    _, _, tcfg, tp = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(**sc_kw), device="cpu")
    reqs = _reqs(Request, prompts, max_new, priorities)
    eng.generate(reqs)
    return eng, reqs


def serve_both(sc_kw, prompts, max_new=6, priorities=None):
    """Both engines on the same requests: identical tokens, outcomes and
    scheduler counters; each paged drain returns the whole pool."""
    jcfg, jp, _, _ = models()
    jeng = JaxEngine(jcfg, jp, JaxServe(**sc_kw))
    jr = _reqs(JaxRequest, prompts, max_new, priorities)
    jeng.generate(jr)
    teng, tr = run_port(sc_kw, prompts, max_new, priorities)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert [(r.done, r.truncated, r.failed) for r in tr] == \
        [(r.done, r.truncated, r.failed) for r in jr]
    for name in ("n_preempted", "preempted_rids", "n_swapped_out",
                 "n_swapped_in", "n_completed", "n_failed", "n_retried",
                 "n_prefill_chunks", "peak_used_pages"):
        assert getattr(teng, name) == getattr(jeng, name), name
    if teng.pool is not None:
        for eng in (jeng, teng):
            assert eng.pool.free_count == eng.pool.n_pages
    return teng, tr


# five requests of worst case 3 pages each (prompt ~14 + 6 new @ ps=8)
# against a 9-page pool: sum of worst cases 15 > 9 -- oversubscribed
OVERSUB = dict(max_seq_len=32, max_batch=4, temperature=0.0,
               decode_chunk=4, paged=True, page_size=8)
LENS = (14, 13, 14, 13, 14)


def _oversub_case(**kw):
    prompts = _prompts(LENS)
    _, reserve = run_port(OVERSUB, prompts)
    eng, opt = serve_both(dict(OVERSUB, n_pages=9, admission="optimistic",
                               **kw), prompts)
    for d, p in zip(reserve, opt):
        assert d.out_tokens == p.out_tokens, d.rid
        assert p.done and not p.truncated and not p.failed
    return eng


def test_optimistic_recompute_matches_reserve():
    eng = _oversub_case()
    assert eng.n_preempted >= 1
    assert eng.n_swapped_out == 0
    assert eng.pool.free_count == eng.pool.n_pages


def test_optimistic_swap_matches_reserve():
    """Victims round-trip host memory: a byte-exact restore, the same
    tokens, every victim resumed."""
    eng = _oversub_case(preempt_mode="swap")
    assert eng.n_preempted >= 1
    assert eng.n_swapped_out >= 1
    assert eng.n_swapped_in == eng.n_swapped_out
    assert eng.n_swap_fallbacks == 0
    assert eng.pool.free_count == eng.pool.n_pages


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_optimistic_chunked_prefill_matches_reserve(mode):
    """Through chunked prefill: victims come back with their generated
    tokens as prompt suffix, rebuilt chunk by chunk (mid-prefill victims
    recompute in either mode)."""
    base = dict(max_seq_len=32, max_batch=4, temperature=0.0,
                decode_chunk=4, paged=True, page_size=4,
                chunked_prefill=True, prefill_chunk=8)
    prompts = _prompts((14, 13, 14, 13, 14, 6), seed=5)
    _, reserve = run_port(base, prompts)
    eng, opt = serve_both(dict(base, n_pages=10, admission="optimistic",
                               preempt_mode=mode), prompts)
    assert [r.out_tokens for r in reserve] == [r.out_tokens for r in opt]
    assert eng.n_preempted >= 1


def test_victims_are_lifo():
    """When growth exhausts the pool the youngest admission is evicted
    and requeued at the head of the pending queue; the oldest keeps
    running."""
    _, _, tcfg, tp = models()
    sc_kw = dict(max_seq_len=32, max_batch=2, temperature=0.0,
                 decode_chunk=4, paged=True, page_size=8, n_pages=5,
                 admission="optimistic")
    prompts = _prompts((14, 14), seed=7)
    eng = ServingEngine(tcfg, tp, ServeConfig(**sc_kw), device="cpu")
    reqs = _reqs(Request, prompts, 6)
    eng.start(reqs)
    eng.step()
    assert eng._slot_req[0] is reqs[0]
    assert eng._slot_req[1] is None
    assert eng._pending and eng._pending[0] is reqs[1]
    assert eng.n_preempted == 1 and eng.preempted_rids == [1]
    while eng.step():
        pass
    assert all(r.done and not r.failed for r in reqs)
    _, both = serve_both(sc_kw, prompts)
    assert [r.out_tokens for r in both] == [r.out_tokens for r in reqs]
    # the preempted request still matches a solo run
    _, solo = run_port(dict(sc_kw, max_batch=1), [prompts[1]])
    assert reqs[1].out_tokens == solo[0].out_tokens


def _leg(leg, **kw):
    """The legs of tests/conftest.py's engine matrix that the port
    serves: dense slots, paged chunked, and paged-preempt (optimistic
    admission on a pool of one worst-case sequence)."""
    if leg != "dense":
        kw.update(paged=True, page_size=4, chunked_prefill=True,
                  prefill_chunk=8)
    if leg == "paged-preempt":
        kw.update(n_pages=max(2, kw["max_seq_len"] // 4),
                  admission="optimistic", watermark_low=0.1)
    return kw


@pytest.mark.parametrize("leg", ["dense", "paged", "paged-preempt"])
def test_oversubscribed_matrix_engine(leg):
    """On each leg: every request served, and (paged-preempt, whose pool
    is one worst-case sequence) preempted at least once; the tokens match
    a solo run of each request and the JAX engine's."""
    prompts = _prompts((14, 13, 14, 13), seed=11)
    eng, reqs = serve_both(_leg(leg, max_seq_len=32, max_batch=4,
                                temperature=0.0, decode_chunk=4),
                           prompts, max_new=5)
    assert all(r.done and not r.failed for r in reqs)
    if leg == "paged-preempt":
        assert eng.n_preempted >= 1
    solo_kw = _leg(leg, max_seq_len=32, max_batch=1, temperature=0.0,
                   decode_chunk=4)
    for i, p in enumerate(prompts):
        _, solo = run_port(solo_kw, [p], max_new=5)
        assert reqs[i].out_tokens == solo[0].out_tokens, i


def test_reserve_window_admits_small_request_past_blocked_head():
    """A short request overtakes a long one whose worst case does not
    fit the unreserved pool yet."""
    _, _, tcfg, tp = models()
    sc = ServeConfig(max_seq_len=32, max_batch=2, temperature=0.0,
                     decode_chunk=4, paged=True, page_size=8, n_pages=4)
    prompts = _prompts((8, 8, 6), seed=13)
    reqs = [Request(rid=0, prompt=prompts[0], max_new_tokens=8),
            Request(rid=1, prompt=prompts[1], max_new_tokens=24),
            Request(rid=2, prompt=prompts[2], max_new_tokens=6)]
    eng = ServingEngine(tcfg, tp, sc, device="cpu")
    eng.start(reqs)
    eng.step()
    resident = {r.rid for r in eng._slot_req if r is not None}
    assert 1 not in resident and not reqs[1].done
    assert resident == {0, 2}
    while eng.step():
        pass
    assert all(r.done and not r.failed for r in reqs)
    assert len(reqs[1].out_tokens) == 24 and not reqs[1].truncated


@pytest.mark.parametrize("leg", ["dense", "paged-preempt"])
def test_freed_slot_refills_in_same_step(leg):
    """When a request finishes, the next one is admitted (and starts
    prefilling) in the same step its slot frees."""
    _, _, tcfg, tp = models()
    sc = ServeConfig(**_leg(leg, max_seq_len=32, max_batch=1,
                            temperature=0.0, decode_chunk=4))
    reqs = _reqs(Request, _prompts((6, 6), seed=17), 4)
    eng = ServingEngine(tcfg, tp, sc, device="cpu")
    eng.start(reqs)
    for _ in range(64):
        eng.step()
        if reqs[0].done:
            break
    assert reqs[0].done
    assert eng._slot_req[0] is reqs[1]
    while eng.step():
        pass
    assert reqs[1].done and len(reqs[1].out_tokens) == 4


def test_priority_two_tier_oversubscription():
    """Victims go by (priority, LIFO stamp): rid 3, the first pure-LIFO
    victim of this workload, marked high tier is never preempted, and the
    tokens still match the ample pool's and the JAX engine's."""
    prompts = _prompts(LENS, seed=23)
    _, reference = run_port(OVERSUB, prompts)
    small = dict(OVERSUB, n_pages=9, admission="optimistic",
                 watermark_low=0.1)
    neutral, _ = run_port(small, prompts)
    assert 3 in neutral.preempted_rids
    eng, reqs = serve_both(small, prompts,
                           priorities=[int(i == 3) for i in range(5)])
    assert eng.n_preempted >= 1
    assert 3 not in eng.preempted_rids
    for d, p in zip(reference, reqs):
        assert d.out_tokens == p.out_tokens, d.rid
        assert p.done and not p.failed


@pytest.mark.parametrize("admission", ["reserve", "optimistic"])
def test_too_big_request_fails_without_aborting_batch(admission):
    """A request whose worst case exceeds the whole pool fails at
    admission (``oversize``) while the rest of the batch completes."""
    sc_kw = dict(max_seq_len=32, max_batch=2, temperature=0.0,
                 decode_chunk=4, paged=True, page_size=8, n_pages=2,
                 admission=admission)
    prompts = _prompts((6, 6, 5), seed=19)
    jcfg, jp, tcfg, tp = models()
    engines = []
    for eng, cls in ((JaxEngine(jcfg, jp, JaxServe(**sc_kw)), JaxRequest),
                     (ServingEngine(tcfg, tp, ServeConfig(**sc_kw),
                                    device="cpu"), Request)):
        reqs = [cls(rid=0, prompt=prompts[0], max_new_tokens=4),
                cls(rid=1, prompt=prompts[1], max_new_tokens=20),
                cls(rid=2, prompt=prompts[2], max_new_tokens=3)]
        eng.generate(reqs)
        engines.append(reqs)
    jr, reqs = engines
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jr]
    assert reqs[1].failed and reqs[1].done and not reqs[1].out_tokens
    assert reqs[1].error.kind == "oversize"
    assert eng.n_failed == 1 and eng.error_counts["oversize"] == 1
    assert len(reqs[0].out_tokens) == 4 and len(reqs[2].out_tokens) == 3
    assert eng.pool.free_count == eng.pool.n_pages


def test_watchdog_counts_re_prefill_as_no_progress():
    """Re-prefilling what a preempted request had already prefilled is
    thrash, not progress: only a chunk past the request's high watermark
    resets the watchdog (reference ``_finish_chunk``)."""
    _, _, tcfg, tp = models()
    sc = ServeConfig(**_leg("paged", max_seq_len=32, max_batch=1,
                            temperature=0.0, decode_chunk=4))
    eng = ServingEngine(tcfg, tp, sc, device="cpu")
    req = Request(rid=0, prompt=_prompts((14,))[0], max_new_tokens=4)
    eng.start([req])
    eng._progress = False
    eng._admit()
    eng._prefill_step()
    assert eng._progress and eng._pf_best[id(req)] == 8
    eng._preempt(0)
    eng._admit()
    eng._progress = False
    eng._prefill_step()                 # the same 8 tokens again
    assert not eng._progress
    eng._prefill_step()                 # new ground: tokens 8..14
    assert eng._progress and eng._pf_best[id(req)] == 14
    while eng.step():
        pass
    assert req.done and len(req.out_tokens) == 4
    assert eng.pool.free_count == eng.pool.n_pages


def test_request_priority_field_matches_reference():
    fields = {f.name: f.default for f in dataclasses.fields(Request)}
    jfields = {f.name: f.default for f in dataclasses.fields(JaxRequest)}
    assert fields["priority"] == jfields["priority"] == 0
