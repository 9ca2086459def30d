"""The port's invariant audits and ``cancel`` against the reference's, case
for case with tests/test_invariants.py (greedy, reduced tinyllama-1.1b,
float32, bridged weights).  Both engines step through the same
oversubscribed sharing and swap workload in lockstep: after every step
the pool's refcounts and free list, the block tables, the scheduler dump
and the audit's verdict are the same, and the same seeded corruption
draws the same violation messages.  ``cancel`` at any stage leaves both
engines in the same audited state and gives the same tokens.  The port's
layout audit, reshaped for its per-layer caches, catches a dropped scale
pool, a wrong page axis and a wrong dtype."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JaxServe
from repro.configs import get_config as jax_config
from repro.core.calibration import GramAccumulator
from repro.config import CompressionConfig as JaxCompression
from repro.models import build_model as jax_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import invariants as jinv
from repro_torch import bridge
from repro_torch.config import ServeConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.serving import (InvariantViolation, Request, ServingEngine,
                                 audit, scheduler_dump)
from repro_torch.serving.invariants import refcount_histogram


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


# oversubscribed sharing + swap workload: every audited structure is
# exercised (shared refcounts > 1, COW, index pins, swap state)
SC = dict(max_seq_len=32, max_batch=4, temperature=0.0,
          decode_chunk=4, paged=True, page_size=8,
          chunked_prefill=True, prefill_chunk=8, share_prefix=True,
          admission="optimistic", preempt_mode="swap", n_pages=8,
          watermark_low=0.1)


def _reqs(cls, max_new=6, n=6):
    vocab = models()[2].vocab_size
    rng = np.random.default_rng(3)
    common = rng.integers(0, vocab, 10).astype(np.int32)
    prompts = [np.concatenate([common, rng.integers(
                   0, vocab, k).astype(np.int32)])
               for k in (4, 3, 4, 3, 4, 6)[:n]]
    return [cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


def _pair(max_new=6, n=6, **kw):
    """Both engines started on the same requests: ``(port, its requests,
    reference, its requests)``."""
    jcfg, jp, tcfg, tp = models()
    sc = {**SC, **kw}
    teng = ServingEngine(tcfg, tp, ServeConfig(**sc), device="cpu")
    jeng = JaxEngine(jcfg, jp, JaxServe(**sc))
    tr, jr = _reqs(Request, max_new, n), _reqs(JaxRequest, max_new, n)
    teng.start(tr)
    jeng.start(jr)
    return teng, tr, jeng, jr


def _state(eng) -> tuple:
    return (list(np.asarray(eng.pool._refs)), list(eng.pool._free),
            [list(p) for p in eng._btabs.slot_pages],
            np.asarray(eng._btabs.rows).tolist(), list(eng._prefilled),
            [r.rid for r in eng._pending], len(eng._swapped))


def _verdict(audit_fn, eng):
    try:
        audit_fn(eng)
    except AssertionError as e:
        return e.violations
    return None


def _lockstep(teng, jeng, limit=200):
    """Step both engines together; after every step the same state, dump
    and (clean) audit.  Returns the steps run."""
    steps = 0
    while True:
        busy_t, busy_j = teng.step(), jeng.step()
        assert busy_t == busy_j
        assert _state(teng) == _state(jeng), steps
        assert scheduler_dump(teng) == jinv.scheduler_dump(jeng), steps
        assert _verdict(audit, teng) is None
        assert _verdict(jinv.audit, jeng) is None
        steps += 1
        assert steps < limit
        if not busy_t:
            return steps


def test_audit_clean_through_full_lifecycle():
    """Audit after every step of an oversubscribed sharing and swap drain
    never raises, in lockstep with the reference, from before the first
    admission to the final release."""
    teng, tr, jeng, jr = _pair(max_new=8, n_pages=6)
    audit(teng)
    assert scheduler_dump(teng) == jinv.scheduler_dump(jeng)
    _lockstep(teng, jeng)
    audit(teng)
    assert all(r.done and not r.failed for r in tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert teng.n_preempted == jeng.n_preempted >= 1


@pytest.mark.parametrize("k", [1, 3])
def test_audit_every_samples_steps(k):
    """``audit_every=k`` audits every k-th step only: ``n_audits`` lands
    at step_count // k in both engines, with the same tokens."""
    teng, tr, jeng, jr = _pair(max_new=6, n_pages=6, audit=True,
                               audit_every=k)
    steps = _lockstep(teng, jeng)
    assert teng.n_audits == jeng.n_audits == teng._step_count // k
    assert teng._step_count == steps
    assert all(r.done and not r.failed for r in tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]


def test_audit_count_independent_of_pool_size():
    counts = {}
    for n_pages in (12, 48):        # both ample: same admission schedule
        teng, tr, jeng, jr = _pair(
            max_new=4, n=3, n_pages=n_pages, audit=True, audit_every=2,
            admission="reserve", preempt_mode="recompute",
            share_prefix=False)
        _lockstep(teng, jeng)
        counts[n_pages] = (teng.n_audits, teng._step_count)
        assert counts[n_pages] == (jeng.n_audits, jeng._step_count)
    assert counts[12] == counts[48]


def test_audit_every_validation():
    for bad in (0, -2):
        with pytest.raises(ValueError):
            ServeConfig(audit_every=bad)
        with pytest.raises(ValueError):
            JaxServe(audit_every=bad)


def _run_until_live(teng, jeng):
    for _ in range(16):
        teng.step()
        jeng.step()
        if any(r is not None for r in teng._slot_req):
            assert _state(teng) == _state(jeng)
            return
    raise AssertionError("no slot ever became live")


def _owned(eng) -> int:
    return next(p for b in range(eng.sc.max_batch)
                for p in eng._btabs.slot_pages[b])


def _both_violations(teng, jeng):
    v_t, v_j = _verdict(audit, teng), _verdict(jinv.audit, jeng)
    assert v_t == v_j
    return v_t


def test_audit_detects_refcount_drift():
    teng, _, jeng, _ = _pair()
    _run_until_live(teng, jeng)
    owned = _owned(teng)
    for eng in (teng, jeng):
        eng.pool._refs[owned] += 1
    bad = _both_violations(teng, jeng)
    assert bad and any(f"page {owned}" in v and "refcount" in v for v in bad)
    for eng in (teng, jeng):
        eng.pool._refs[owned] -= 1
    assert _both_violations(teng, jeng) is None


def test_audit_detects_free_list_corruption():
    teng, _, jeng, _ = _pair()
    _run_until_live(teng, jeng)
    owned = _owned(teng)
    for eng in (teng, jeng):
        eng.pool._free.append(owned)
    bad = _both_violations(teng, jeng)
    assert any("both free and" in v for v in bad)
    for eng in (teng, jeng):
        eng.pool._free.pop()
    if teng.pool.free_count:                    # drop one: leaked
        dropped = [eng.pool._free.pop() for eng in (teng, jeng)]
        assert any("leaked" in v for v in _both_violations(teng, jeng))
        for eng, p in zip((teng, jeng), dropped):
            eng.pool._free.append(p)
    assert _both_violations(teng, jeng) is None


def test_audit_detects_block_table_and_slot_corruption():
    teng, _, jeng, _ = _pair()
    _run_until_live(teng, jeng)
    b = next(b for b in range(teng.sc.max_batch)
             if teng._slot_req[b] is not None
             and teng._btabs.slot_pages[b])
    k = len(teng._btabs.slot_pages[b])
    saved = teng._btabs.rows[b, k:].copy()
    for eng in (teng, jeng):
        eng._btabs.rows[b, k:] = 1              # stale entry past owned
    assert any("stale row" in v for v in _both_violations(teng, jeng))
    for eng in (teng, jeng):
        eng._btabs.rows[b, k:] = saved
    old = teng._private[b]
    for eng in (teng, jeng):
        eng._private[b] = 99
    assert any("private" in v for v in _both_violations(teng, jeng))
    for eng in (teng, jeng):
        eng._private[b] = old
    assert _both_violations(teng, jeng) is None


def test_violation_carries_all_checks_and_dump():
    teng, _, jeng, _ = _pair()
    _run_until_live(teng, jeng)
    owned = _owned(teng)
    for eng in (teng, jeng):
        eng.pool._refs[owned] += 1
        eng.pool._free.append(owned)
    with pytest.raises(InvariantViolation) as ei:
        audit(teng)
    assert len(ei.value.violations) >= 2
    assert "pool:" in str(ei.value)             # scheduler dump inline
    with pytest.raises(jinv.InvariantViolation) as ej:
        jinv.audit(jeng)
    assert str(ei.value) == str(ej.value)


def test_scheduler_dump_and_histogram():
    teng, _, jeng, _ = _pair()
    _run_until_live(teng, jeng)
    dump = scheduler_dump(teng)
    assert "pool:" in dump and "slot" in dump and "rid=" in dump
    assert dump == jinv.scheduler_dump(jeng)
    hist = refcount_histogram(teng)
    assert sum(hist.values()) == teng.pool.n_pages
    assert any(rc >= 1 for rc in hist)
    assert hist == jinv.refcount_histogram(jeng)


# ---------------------------------------------------------------------------
# The layout audit on the port's per-layer caches
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def projections():
    """Full-rank KQ-SVD projections solved by the reference, bridged."""
    jcfg, jp, _, _ = models()
    jm = jax_model(jcfg)
    acc = GramAccumulator(len(jm.attn_layers))
    toks = jax.random.randint(jax.random.PRNGKey(5), (2, 32), 0,
                              jcfg.vocab_size)
    acc.update_from_captures([jax.tree.map(np.asarray, c)
                              for c in jm.calibrate(jp, toks)])
    mp = acc.solve(JaxCompression(method="kqsvd", rank_k=jcfg.d_head,
                                  rank_v=jcfg.d_head),
                   jm.group_output_weights(jp))
    return bridge.projections_from_jax(mp)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_layout_audit_on_per_layer_pools(quant):
    """Every leaf of every layer: the pool's page axis (garbage page
    included) at 0, the layout's width and dtype, the layout's leaf set.
    int8 pages carry their bf16 scale pools; each corruption is named."""
    _, _, tcfg, tp = models()
    sc = dict(SC, max_batch=2, cache_quant=quant)
    eng = ServingEngine(tcfg, tp, ServeConfig(**sc),
                        projections=projections(), device="cpu")
    eng.start(_reqs(Request, n=2))
    eng.step()
    audit(eng)
    layer = eng._cache[1]
    names = sorted(layer)
    assert names == (["kc", "kscale", "vc", "vscale"] if quant == "int8"
                     else ["kc", "vc"])
    scale = "kscale" if quant == "int8" else "kc"
    saved = layer[scale]
    layer[scale] = saved[:-1]                   # page axis one short
    bad = _verdict(audit, eng)
    assert any(f"layer 1/{scale}: page axis" in v for v in bad)
    layer[scale] = saved.to(torch.float64)      # wrong dtype
    assert any(f"layer 1/{scale}: dtype" in v for v in _verdict(audit, eng))
    del layer[scale]                            # a pool dropped
    assert any("layer 1: cache leaves" in v for v in _verdict(audit, eng))
    layer[scale] = saved
    audit(eng)


# ---------------------------------------------------------------------------
# cancel() at every lifecycle stage
# ---------------------------------------------------------------------------


def _drain_and_check(teng, tr, jeng, jr, cancelled):
    _lockstep(teng, jeng)
    audit(teng)
    for r in tr:
        if r.rid in cancelled:
            assert r.failed and r.error.kind == "cancelled"
        else:
            assert r.done and not r.failed, r.rid
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert teng.pool.free_count + teng._pindex.n_pinned == teng.pool.n_pages


def test_cancel_pending_request():
    teng, tr, jeng, jr = _pair()                # 6 requests, 4 slots
    teng.step()
    jeng.step()
    waiting = [r.rid for r in teng._pending]
    assert waiting == [r.rid for r in jeng._pending] and waiting
    assert teng.cancel(waiting[0]) and jeng.cancel(waiting[0])
    audit(teng)
    assert tr[waiting[0]].out_tokens == []
    _drain_and_check(teng, tr, jeng, jr, {waiting[0]})


def test_cancel_resident_request():
    teng, tr, jeng, jr = _pair()
    teng.step()
    jeng.step()
    b = next(b for b in range(teng.sc.max_batch)
             if teng._slot_req[b] is not None)
    rid = teng._slot_req[b].rid
    assert teng.cancel(rid) and jeng.cancel(rid)
    assert teng._slot_req[b] is None
    assert _state(teng) == _state(jeng)
    audit(teng)
    _drain_and_check(teng, tr, jeng, jr, {rid})


def test_cancel_swapped_out_request():
    teng, tr, jeng, jr = _pair(max_new=12)
    for _ in range(64):
        teng.step()
        jeng.step()
        if teng._swapped:
            break
    assert teng._swapped and len(jeng._swapped) == len(teng._swapped)
    key = next(iter(teng._swapped))
    victim = next(r for r in teng._pending if id(r) == key)
    assert teng.cancel(victim.rid) and jeng.cancel(victim.rid)
    assert key not in teng._swapped
    assert _state(teng) == _state(jeng)
    audit(teng)
    _drain_and_check(teng, tr, jeng, jr, {victim.rid})


def test_cancel_unknown_or_done_returns_false():
    teng, tr, _, _ = _pair(n=2)
    assert not teng.cancel(999)
    assert teng.cancel(tr[0].rid)
    assert not teng.cancel(tr[0].rid)           # already terminal
    while teng.step():
        pass
    assert not teng.cancel(tr[1].rid)           # completed normally
    with pytest.raises(RuntimeError, match="start"):
        ServingEngine(models()[2], models()[3], ServeConfig(**SC),
                      device="cpu").cancel(0)


def test_cancel_at_arbitrary_stage_property():
    """Cancelling any request after any number of steps: both engines in
    the same audited state, and the rest of the batch drains to the same
    tokens (hypothesis explores the (step, rid) grid)."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=10, deadline=None)
    @hyp.given(steps=st.integers(min_value=0, max_value=8),
               rid=st.integers(min_value=0, max_value=5))
    def prop(steps, rid):
        teng, tr, jeng, jr = _pair()
        for _ in range(steps):
            if not (teng.step() | jeng.step()):
                break
        assert teng.cancel(rid) == jeng.cancel(rid)
        audit(teng)
        assert _state(teng) == _state(jeng)
        _lockstep(teng, jeng)
        for r in tr:
            assert r.done
            assert (not r.failed) or r.error.kind == "cancelled"
        assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
        assert (teng.pool.free_count + teng._pindex.n_pinned
                == teng.pool.n_pages)

    prop()


def test_dataclass_fields_unchanged():
    """The audit reads the engine state it names: the port's ServeConfig
    keeps the reference's audit fields and defaults."""
    ours = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxServe)}
    for name in ("audit", "audit_every", "chaos_seed", "chaos_rate",
                 "stall_steps", "admission_retries", "swap_fallback",
                 "guard_numerics"):
        assert ours[name] == ref[name], name
