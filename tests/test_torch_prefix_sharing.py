"""The port's prefix sharing with copy-on-write against the reference's,
case for case with tests/test_prefix_sharing.py (greedy, reduced
tinyllama-1.1b, float32, bridged weights): the same tokens as the JAX
engine and as the engine without sharing, with the same shared pages,
full hits, forks, reclaims and peak pages; sharing under both preemption
modes; and the refcounted pool, the ``PrefixIndex`` (keys, pages, LRU and
reclaim order) and the cached block-table export, call for call against
``repro.serving.paged_cache``.  After every drain only index pins are
left in the pool."""
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
from repro.serving import paged_cache as jpc
from repro_torch import bridge
from repro_torch.config import ServeConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import paged_cache as tpc


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


def _sc(**kw) -> dict:
    base = dict(max_seq_len=32, max_batch=4, temperature=0.0,
                decode_chunk=4, paged=True, page_size=4,
                chunked_prefill=True, prefill_chunk=4)
    base.update(kw)
    return base


def _family(n_common, tails, seed=0):
    """Prompts sharing one ``n_common``-token prefix + distinct tails."""
    vocab = models()[2].vocab_size
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, n_common).astype(np.int32)
    return [np.concatenate([common,
                            rng.integers(0, vocab, k).astype(np.int32)])
            for k in tails]


def _drained_invariant(eng):
    """After a full drain every remaining reference belongs to the prefix
    index (one pinned page per entry)."""
    assert eng.pool.free_count + eng._pindex.n_pinned == eng.pool.n_pages


def run_port(sc_kw, prompts, max_new=5):
    _, _, tcfg, tp = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(**sc_kw), device="cpu")
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, _news(max_new,
                                                          prompts)))]
    eng.generate(reqs)
    return eng, reqs


def _news(max_new, prompts):
    return (list(max_new) if isinstance(max_new, (list, tuple))
            else [max_new] * len(prompts))


COUNTERS = ("n_shared_pages", "n_shared_tokens", "n_full_hits",
            "n_cow_forks", "n_reclaimed", "n_preempted", "n_swapped_out",
            "n_swapped_in", "n_prefill_chunks", "peak_used_pages",
            "n_completed", "n_failed")


def serve_both(sc_kw, prompts, max_new=5):
    """Both engines on the same requests: identical tokens, outcomes and
    sharing / preemption counters, and the same index pins left after the
    drain.  Returns the port's engine and its token lists."""
    jcfg, jp, _, _ = models()
    jeng = JaxEngine(jcfg, jp, JaxServe(**sc_kw))
    jr = [JaxRequest(rid=i, prompt=p.copy(), max_new_tokens=m)
          for i, (p, m) in enumerate(zip(prompts, _news(max_new, prompts)))]
    jeng.generate(jr)
    teng, tr = run_port(sc_kw, prompts, max_new)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert [(r.done, r.failed) for r in tr] == [(r.done, r.failed)
                                               for r in jr]
    for name in COUNTERS:
        assert getattr(teng, name) == getattr(jeng, name), name
    assert teng.pool.free_count == jeng.pool.free_count
    if teng._pindex is not None:
        assert list(teng._pindex._entries) == list(jeng._pindex._entries)
        _drained_invariant(teng)
    return teng, [r.out_tokens for r in tr]


# ---------------------------------------------------------------------------
# Acceptance: parity + savings + COW divergence
# ---------------------------------------------------------------------------


def test_shared_prefix_parity_and_savings():
    """Identical outputs, lower peak pool occupancy and fewer prefill
    chunks for a concurrently admitted batch sharing a long prefix."""
    prompts = _family(16, (3, 5, 2, 3), seed=1)
    off, out_off = run_port(_sc(), prompts)
    on, out_on = serve_both(_sc(share_prefix=True), prompts)
    assert [r.out_tokens for r in out_off] == out_on
    assert on.peak_used_pages < off.peak_used_pages
    assert on.n_prefill_chunks < off.n_prefill_chunks
    assert on.n_shared_pages > 0


def test_shared_prefix_sequential_reuse_skips_prefill():
    """A finished request's pages stay in the index: an exact duplicate
    skips prefill (terminal logits hit), a prompt extending it prefills
    only its tail."""
    p = _family(10, (0,), seed=2)[0]
    ext = np.concatenate([p, np.asarray([5, 9, 2, 7], np.int32)])
    eng, outs = serve_both(_sc(share_prefix=True, max_batch=1),
                           [p, p, ext])
    assert eng.n_full_hits >= 1
    assert outs[1][:5] == outs[0][:5]
    for i, prompt in enumerate((p, p, ext)):
        _, solo = run_port(_sc(max_batch=1), [prompt])
        assert outs[i] == solo[0].out_tokens, i


def test_cow_fork_on_mid_decode_divergence():
    """Two requests sharing a prompt whose last page is partial: the
    writer forks the shared page before its decode appends."""
    p = _family(10, (0,), seed=3)[0]
    eng, outs = serve_both(_sc(share_prefix=True, max_batch=1), [p, p],
                           max_new=[3, 6])
    assert eng.n_full_hits >= 1
    assert eng.n_cow_forks >= 1
    assert outs[1][:3] == outs[0]
    _, solo = run_port(_sc(max_batch=1), [p], max_new=6)
    assert outs[1] == solo[0].out_tokens


def test_cow_fork_on_partial_page_prefill():
    """A prompt extending a cached prefix mid-page forks the shared
    partial page on its first prefill write (K2 with pos0 > 0 over shared
    pages)."""
    p = _family(10, (0,), seed=5)[0]
    ext = np.concatenate([p, np.asarray([3, 11, 4, 6], np.int32)])
    eng, outs = serve_both(_sc(share_prefix=True, max_batch=1), [p, ext])
    assert eng.n_cow_forks >= 1
    assert eng.n_shared_tokens >= 10
    _, solo = run_port(_sc(max_batch=1), [ext])
    assert outs[1] == solo[0].out_tokens


def test_shared_pages_survive_sibling_release():
    """Releasing one sharer only drops its references: the sibling still
    decoding from the shared pages is unaffected."""
    prompts = _family(12, (2, 2), seed=7)
    eng, outs = serve_both(_sc(share_prefix=True, max_batch=2), prompts,
                           max_new=[2, 8])
    for i, (p, m) in enumerate(zip(prompts, (2, 8))):
        _, solo = run_port(_sc(max_batch=1), [p], max_new=m)
        assert outs[i] == solo[0].out_tokens, i


# ---------------------------------------------------------------------------
# Sharing x preemption
# ---------------------------------------------------------------------------


OVERSUB = dict(max_seq_len=32, max_batch=4, temperature=0.0,
               decode_chunk=4, paged=True, page_size=8,
               chunked_prefill=True, prefill_chunk=8, share_prefix=True)


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_sharing_under_preemption_matches_ample(mode):
    """Preempting slots whose rows hold shared pages corrupts no sibling:
    the ample pool's tokens, preemptions observed, only index pins left."""
    prompts = _family(8, (6, 5, 6, 5, 6), seed=3)
    _, ref = run_port(OVERSUB, prompts, max_new=6)
    eng, out = serve_both(dict(OVERSUB, n_pages=6, admission="optimistic",
                               preempt_mode=mode, watermark_low=0.1),
                          prompts, max_new=6)
    assert out == [r.out_tokens for r in ref]
    assert eng.n_preempted >= 1
    if mode == "swap":
        assert eng.n_swapped_out >= 1
        assert eng.n_swapped_in == eng.n_swapped_out


def test_index_reclaim_under_pool_pressure():
    """Pages only the index pins are reclaimed (LRU) before any live slot
    is preempted."""
    prompts = _family(8, (6, 5, 6, 5, 6), seed=3)
    eng, out = serve_both(dict(OVERSUB, n_pages=5, admission="optimistic",
                               preempt_mode="recompute", watermark_low=0.1),
                          prompts, max_new=6)
    assert eng.n_reclaimed >= 1
    _, ref = run_port(OVERSUB, prompts, max_new=6)
    assert out == [r.out_tokens for r in ref]


# ---------------------------------------------------------------------------
# PagePool refcounts
# ---------------------------------------------------------------------------


def test_pool_share_free_refcounts():
    pools = [jpc.PagePool(4), tpc.PagePool(4)]
    for pool in pools:
        (a, b) = pool.alloc(2)
        assert pool.ref(a) == 1
        pool.share([a])
        assert pool.ref(a) == 2
        pool.free([a])
        assert pool.ref(a) == 1
        assert pool.used_count == 2
        pool.free([a])
        assert pool.ref(a) == 0 and pool.free_count == 3
        with pytest.raises(ValueError):
            pool.free([a])
        with pytest.raises(ValueError):
            pool.share([a])
        with pytest.raises(ValueError):
            pool.share([0])
        pool.free([b])
    assert [p._free for p in pools[1:]] == [pools[0]._free]


def test_pool_refcount_invariants_hypothesis():
    """Across random alloc / share / free sequences the port's pool hands
    out the reference's pages, never recycles a referenced page, never
    leaks, and free_count complements the distinct live pages."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    ops = st.lists(st.tuples(st.sampled_from(["alloc", "share", "free"]),
                             st.integers(0, 7)), max_size=60)

    @settings(deadline=None, max_examples=60)
    @given(ops)
    def run(seq):
        jpool, pool = jpc.PagePool(8), tpc.PagePool(8)
        refs = {}
        for op, k in seq:
            if op == "alloc":
                n = (k % 3) + 1
                if n > pool.free_count:
                    for p_ in (jpool, pool):
                        with pytest.raises(Exception) as exc:
                            p_.alloc(n)
                        assert type(exc.value).__name__ == \
                            "PagePoolExhausted"
                    continue
                got = pool.alloc(n)
                assert got == jpool.alloc(n)
                for p in got:
                    assert p not in refs
                    refs[p] = 1
            elif op == "share" and refs:
                p = sorted(refs)[k % len(refs)]
                pool.share([p])
                jpool.share([p])
                refs[p] += 1
            elif op == "free" and refs:
                p = sorted(refs)[k % len(refs)]
                pool.free([p])
                jpool.free([p])
                refs[p] -= 1
                if not refs[p]:
                    del refs[p]
            assert pool.used_count == len(refs) == jpool.used_count
            assert all(pool.ref(p) == c for p, c in refs.items())
        for p in sorted(refs):
            for _ in range(refs[p]):
                pool.free([p])
        assert pool.free_count == pool.n_pages

    run()


# ---------------------------------------------------------------------------
# PrefixIndex
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [jpc, tpc], ids=["reference", "port"])
def test_prefix_index_match_and_chain(mod):
    pool = mod.PagePool(8)
    idx = mod.PrefixIndex(capacity=8)
    prompt = np.arange(10, dtype=np.int32)
    k0 = mod.PrefixIndex.child_key(mod.PrefixIndex.ROOT, prompt[:4])
    k1 = mod.PrefixIndex.child_key(k0, prompt[4:8])
    kt = mod.PrefixIndex.child_key(k1, prompt[8:10])
    # the keys are the reference's, digest for digest
    assert kt == jpc.PrefixIndex.child_key(
        jpc.PrefixIndex.child_key(jpc.PrefixIndex.child_key(
            b"", prompt[:4]), prompt[4:8]), prompt[8:10])
    p0, p1, pt = pool.alloc(3)
    assert idx.insert(k0, p0, 4, pool)
    assert idx.insert(k1, p1, 4, pool)
    assert idx.insert(kt, pt, 2, pool, logits=np.ones(3))
    assert not idx.insert(k0, 99, 4, pool)      # dedupe keeps the original
    assert pool.ref(p0) == 2
    pages, n, full, chain, logits = idx.match(prompt, 4, pool)
    assert pages == [p0, p1, pt] and n == 10 and full == 8
    assert chain == k1 and logits is not None
    assert pool.ref(pt) == 3
    pool.free(pages)
    other = prompt.copy()
    other[6] = 99
    pages2, n2, _, _, lg = idx.match(other, 4, pool)
    assert pages2 == [p0] and n2 == 4 and lg is None
    pool.free(pages2)


def _index_ops(mod):
    """One sequence of index calls; returns what each observable said."""
    pool = mod.PagePool(8)
    idx = mod.PrefixIndex(capacity=3)
    keys = [mod.PrefixIndex.child_key(mod.PrefixIndex.ROOT,
                                      np.asarray([i, i + 1], np.int32))
            for i in range(5)]
    pages = pool.alloc(5)
    seen = []
    for k, p in zip(keys, pages):
        seen.append(idx.insert(k, p, 2, pool))
    idx.touch([keys[2]])
    seen.append(idx.get(keys[3])[:2])
    seen.append(idx.get(keys[0]))               # LRU-evicted
    pool.free(pages)
    seen.append((list(idx._entries), idx.reclaimable(pool),
                 pool.free_count))
    seen.append(idx.reclaim(pool, need_free=7))
    seen.append((list(idx._entries), pool.free_count))
    return seen


def test_prefix_index_lru_and_reclaim_order_match_reference():
    """The same calls leave the same entries in the same LRU order and
    reclaim the same pages first."""
    assert _index_ops(tpc) == _index_ops(jpc)


def test_prefix_index_capacity_and_reclaim():
    pool = tpc.PagePool(8)
    idx = tpc.PrefixIndex(capacity=2)
    keys = [tpc.PrefixIndex.child_key(tpc.PrefixIndex.ROOT,
                                      np.asarray([i], np.int32))
            for i in range(3)]
    pages = pool.alloc(3)
    for k, p in zip(keys, pages):
        idx.insert(k, p, 1, pool)
    assert len(idx) == 2
    assert pool.ref(pages[0]) == 1
    pool.free(pages)
    assert pool.free_count == 6
    assert idx.reclaimable(pool) == 2
    dropped = idx.reclaim(pool, need_free=8)
    assert dropped == 2 and pool.free_count == 8 and len(idx) == 0


def test_prefix_index_reclaim_skips_shared_entries():
    pool = tpc.PagePool(4)
    idx = tpc.PrefixIndex(capacity=4)
    (p0, p1) = pool.alloc(2)
    idx.insert(tpc.PrefixIndex.child_key(b"", np.asarray([0], np.int32)),
               p0, 1, pool)
    idx.insert(tpc.PrefixIndex.child_key(b"", np.asarray([1], np.int32)),
               p1, 1, pool)
    pool.free([p1])
    assert idx.reclaimable(pool) == 1
    idx.reclaim(pool, need_free=4)
    assert len(idx) == 1
    assert pool.ref(p0) == 2


# ---------------------------------------------------------------------------
# Satellites: cached device export, config validation, accounting
# ---------------------------------------------------------------------------


def test_block_table_device_export_is_cached():
    pool = tpc.PagePool(8)
    bt = tpc.BlockTables(2, 4, torch.device("cpu"))
    bt.assign(0, pool.alloc(2))
    dev1 = bt.device()
    assert bt.device() is dev1
    live = np.asarray([True, False])
    dev_live = bt.device(live=live)
    assert dev_live is not dev1
    assert bt.device(live=live.copy()) is dev_live
    assert bt.device(live=np.asarray([True, True])) is not dev_live
    new = pool.alloc(1)[0]
    bt.set_page(0, 1, new)                      # a COW fork drops it
    dev2 = bt.device()
    assert dev2 is not dev1 and int(dev2[0, 1]) == new
    assert bt.device() is dev2
    bt.release(0, pool)
    assert bt.device() is not dev2


def test_share_prefix_requires_chunked_prefill():
    with pytest.raises(ValueError, match="chunked_prefill"):
        ServeConfig(paged=True, page_size=4, share_prefix=True)
    with pytest.raises(ValueError, match="capacity"):
        ServeConfig(paged=True, page_size=4, chunked_prefill=True,
                    prefill_chunk=4, share_prefix=True,
                    prefix_index_capacity=0)


def test_reserve_admission_not_pessimized_by_decode_growth():
    """Pages a slot allocates while growing count as private: request B
    (worst case 4) is admitted while A (worst case 8) still decodes."""
    _, _, tcfg, tp = models()
    rng = np.random.default_rng(29)
    a = rng.integers(0, tcfg.vocab_size, 4).astype(np.int32)
    bp = rng.integers(0, tcfg.vocab_size, 4).astype(np.int32)
    eng = ServingEngine(tcfg, tp, ServeConfig(**_sc(
        share_prefix=True, max_batch=2, n_pages=12)), device="cpu")
    reqs = [Request(rid=0, prompt=a, max_new_tokens=28),
            Request(rid=1, prompt=bp, max_new_tokens=12)]
    eng.start([reqs[0]])
    grown = False
    for _ in range(3):
        eng.step()
        grown = grown or len(eng._btabs.slot_pages[0]) > 2
    assert grown and not reqs[0].done
    eng._pending.append(reqs[1])
    eng.step()
    assert eng._slot_req[1] is reqs[1]
    while eng.step():
        pass
    assert all(r.done and not r.failed for r in reqs)


@pytest.mark.parametrize("admission", ["reserve", "optimistic"])
def test_tight_pool_sharing_never_raises(admission):
    """Tight pools under both policies: every batch drains, never raises,
    gives the JAX engine's tokens; a request is dropped only when its
    whole worst case exceeds the pool."""
    prompts = _family(8, (6, 5, 12, 5, 6), seed=31)
    kw = dict(share_prefix=True, page_size=4, prefill_chunk=8)
    _, ref = run_port(_sc(**kw), prompts, max_new=6)
    for n_pages in (5, 6, 7, 8):
        eng, out = serve_both(_sc(**kw, n_pages=n_pages, admission=admission,
                                  watermark_low=0.1
                                  if admission == "optimistic" else 0.0),
                              prompts, max_new=6)
        for i, toks in enumerate(out):
            if toks:
                assert toks == ref[i].out_tokens, (n_pages, i)
            else:
                worst = eng._worst_case_pages(
                    Request(rid=i, prompt=prompts[i], max_new_tokens=6))
                assert worst > n_pages, (n_pages, i)


def test_worst_case_charges_private_tail_only():
    """Under reserve admission two same-prefix requests hold slots at
    once in a pool that two independent worst cases would overflow."""
    _, _, tcfg, tp = models()
    prompts = _family(8, (2, 2, 2), seed=11)
    eng = ServingEngine(tcfg, tp, ServeConfig(**_sc(
        share_prefix=True, max_batch=2, n_pages=7)), device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    eng.start(reqs)
    eng.step()
    concurrent = False
    for _ in range(64):
        resident = [r for r in eng._slot_req if r is not None]
        concurrent = concurrent or len(resident) == 2
        if not eng.step():
            break
    assert concurrent
    assert all(r.done and not r.failed for r in reqs)
    for i, p in enumerate(prompts):
        _, solo = run_port(_sc(max_batch=1), [p], max_new=4)
        assert reqs[i].out_tokens == solo[0].out_tokens, i


def test_swap_checksum_failure_degrades_or_fails():
    """A swapped-out buffer whose bytes changed fails its crc at swap-in:
    with ``swap_fallback`` the victim recomputes and keeps its tokens,
    without it the request fails with ``swap_failed``."""
    prompts = _family(8, (6, 5, 6, 5, 6), seed=3)
    _, ref = run_port(OVERSUB, prompts, max_new=6)
    _, _, tcfg, tp = models()
    for fallback in (True, False):
        sc = ServeConfig(**OVERSUB, n_pages=6, admission="optimistic",
                         preempt_mode="swap", watermark_low=0.1,
                         swap_fallback=fallback)
        eng = ServingEngine(tcfg, tp, sc, device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        eng.start(reqs)
        flipped = None
        while eng.step():
            if flipped is None and eng._swapped:
                st = next(iter(eng._swapped.values()))
                st["bufs"][0]["k"].view(torch.uint8).view(-1)[0] ^= 0xFF
                flipped = next(r for r in reqs if id(r) in eng._swapped)
        assert flipped is not None
        if fallback:
            assert eng.n_swap_fallbacks >= 1
            assert [r.out_tokens for r in reqs] == \
                [r.out_tokens for r in ref]
        else:
            assert flipped.failed and flipped.error.kind == "swap_failed"
            assert eng.error_counts["swap_failed"] == 1
        _drained_invariant(eng)
