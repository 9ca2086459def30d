"""The port's fault injection against the reference's, case for case with
tests/test_faults.py (greedy, reduced tinyllama-1.1b, float32, bridged
weights).  The injector's schedule, streams, corruption and checksum equal
``repro.serving.faults`` call for call.  In every engine scenario both
engines get the same schedule and requests and give the same
``fired_log``, tokens, outcomes and error kinds, the same counters
(retries, swap fallbacks, audits, preemptions, swaps, forks) and a pool
whole again but for index pins; the same runs without faults give the
same tokens where the reference's do.  Last, the reference's
``paged-chaos`` leg (tests/conftest.py) on the port against the port's
legacy engine."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JaxServe
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_model
from repro.serving import EngineStalledError as JaxStalled
from repro.serving import FaultInjector as JaxInjector
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import faults as jfaults
from repro_torch import bridge
from repro_torch.config import ServeConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.serving import (FAULT_POINTS, RECOVERABLE_POINTS,
                                 EngineStalledError, FaultInjector, FaultSpec,
                                 Request, ServingEngine, checksum, invariants)

# what both engines must agree on after a drain


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COUNTERS = ("n_preempted", "preempted_rids", "n_swapped_out", "n_swapped_in",
            "n_swap_fallbacks", "n_retried", "n_audits", "n_completed",
            "n_failed", "error_counts", "n_shared_pages", "n_full_hits",
            "n_cow_forks", "n_reclaimed", "n_prefill_chunks",
            "peak_used_pages", "_step_count")


@functools.lru_cache(maxsize=None)
def models():
    jcfg = jax_config("tinyllama-1.1b").reduced()
    jp = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, jp, torch_config("tinyllama-1.1b").reduced(), tp


# ---------------------------------------------------------------------------
# The injector against the reference's (no model)
# ---------------------------------------------------------------------------


def test_spec_validation():
    for cls, inj in ((FaultSpec, FaultInjector),
                     (jfaults.FaultSpec, JaxInjector)):
        with pytest.raises(ValueError, match="unknown fault point"):
            cls("bad_point", nth=1)
        with pytest.raises(ValueError, match="exactly one"):
            cls("page_alloc", nth=1, prob=0.5)
        with pytest.raises(ValueError, match="exactly one"):
            cls("page_alloc")
        with pytest.raises(ValueError, match="1-based"):
            cls("page_alloc", nth=0)
        with pytest.raises(ValueError, match="prob"):
            cls("page_alloc", prob=1.5)
        with pytest.raises(ValueError, match="unknown fault point"):
            inj(0).fires("bad_point")
    assert FAULT_POINTS == jfaults.FAULT_POINTS
    assert RECOVERABLE_POINTS == jfaults.RECOVERABLE_POINTS


def test_nth_trigger_fires_exactly_once():
    inj = FaultInjector(seed=0).add("page_alloc", nth=3)
    seq = [inj.fires("page_alloc") for _ in range(8)]
    assert seq == [False, False, True] + [False] * 5
    assert inj.hits("page_alloc") == 8
    assert inj.fired_log == [("page_alloc", 3)]
    assert inj.points_fired() == ("page_alloc",)


def test_prob_stream_matches_reference_and_is_point_independent():
    def run(cls, seed, interleave):
        inj = cls(seed=seed)
        inj.add("swap_out", prob=0.5, times=None)
        seq = []
        for _ in range(64):
            if interleave:            # traffic at other points must not
                inj.fires("page_alloc")   # reshuffle this stream
                inj.fires("nan_logits")
            seq.append(inj.fires("swap_out"))
        return seq, inj.fired_log

    base = run(FaultInjector, 7, interleave=False)
    assert any(base[0]) and not all(base[0])    # a real Bernoulli mix
    assert run(FaultInjector, 7, interleave=True) == base
    assert run(FaultInjector, 8, interleave=False) != base
    for seed in (7, 8):
        assert run(FaultInjector, seed, interleave=True) == \
            run(JaxInjector, seed, interleave=True)


def test_times_budget_caps_firings():
    inj = FaultInjector(seed=0).add("swap_out", prob=1.0, times=3)
    assert sum(inj.fires("swap_out") for _ in range(10)) == 3
    inj = FaultInjector(seed=0).add("prefill_delay", prob=1.0)
    assert sum(inj.fires("prefill_delay") for _ in range(10)) == 1


@pytest.mark.parametrize("rate", [1.0, 0.05])
def test_chaos_schedule_matches_reference(rate):
    """``chaos`` arms the recoverable points only, and each point's
    firings over 300 hits equal the reference's."""
    ours, ref = FaultInjector.chaos(0, rate), JaxInjector.chaos(0, rate)
    for _ in range(300):
        for p in FAULT_POINTS:
            assert ours.fires(p) == ref.fires(p), p
    assert ours.fired_log == ref.fired_log
    assert "nan_logits" not in ours.points_fired()
    if rate == 1.0:
        assert set(ours.points_fired()) == set(RECOVERABLE_POINTS)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_corrupt_flips_one_byte_as_the_reference_does(dtype):
    """One byte flipped, the same byte as the reference's, reproducibly;
    on a CPU tensor (the port's swap buffers) the same byte too, and the
    crc catches it."""
    buf = np.arange(32).astype(dtype)
    out = FaultInjector(seed=3).corrupt("swap_corrupt", buf)
    assert out.shape == buf.shape and out.dtype == buf.dtype
    diff = np.nonzero(buf.view(np.uint8).reshape(-1)
                      != out.view(np.uint8).reshape(-1))[0]
    assert len(diff) == 1
    assert np.array_equal(out, JaxInjector(seed=3).corrupt("swap_corrupt",
                                                           buf))
    t = FaultInjector(seed=3).corrupt("swap_corrupt", torch.from_numpy(buf))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.from_numpy(
        buf).dtype
    assert np.array_equal(t.numpy(), out)
    assert checksum([out]) != checksum([buf])


def test_corrupt_bf16_tensor():
    """The int8 pages' scale leaves are bf16: one byte flips there too."""
    t = torch.linspace(-3, 3, 24).to(torch.bfloat16).reshape(2, 3, 4)
    out = FaultInjector(seed=1).corrupt("swap_corrupt", t)
    assert out.dtype == torch.bfloat16 and out.shape == t.shape
    diff = (out.view(torch.uint8) != t.view(torch.uint8)).sum()
    assert int(diff) == 1 and checksum([out]) != checksum([t])


def test_checksum_over_pytree_matches_reference():
    tree = {"k": np.arange(6, dtype=np.float32).reshape(2, 3),
            "v": np.ones(4, np.int32)}
    same = {"k": tree["k"].copy(), "v": tree["v"].copy()}
    assert checksum(tree) == checksum(same) == jfaults.checksum(tree)
    same["v"][0] = 2
    assert checksum(tree) != checksum(same)
    assert checksum(same) == jfaults.checksum(same)


# ---------------------------------------------------------------------------
# Engine scenarios, both engines
# ---------------------------------------------------------------------------

# the reference's chaos workload: four short sharers publish prefix-index
# entries and finish fast, a duplicate of a finisher hits its terminal
# entry and forks the shared partial page, and three long fresh requests
# grow the decode footprint past the 8-page pool (swap preemption and
# reclaim under pressure)
CHAOS_SC = dict(max_seq_len=32, max_batch=4, temperature=0.0,
                decode_chunk=4, paged=True, page_size=8,
                chunked_prefill=True, prefill_chunk=8,
                share_prefix=True, admission="optimistic",
                preempt_mode="swap", n_pages=8, watermark_low=0.1)
SMALL_PAGED = dict(max_seq_len=32, max_batch=2, temperature=0.0,
                   decode_chunk=4, paged=True, page_size=8)


def _rand(rng, n):
    return rng.integers(0, models()[2].vocab_size, n).astype(np.int32)


def _chaos_reqs(cls):
    rng = np.random.default_rng(3)
    common = _rand(rng, 10)

    def fam(k):
        return np.concatenate([common, _rand(rng, k)])

    p0, p1, p2, p3 = fam(4), fam(3), fam(4), fam(3)
    specs = [(p0, 2), (p1, 2), (p2, 2), (p3, 2), (p1.copy(), 12),
             (_rand(np.random.default_rng(21), 14), 12),
             (_rand(np.random.default_rng(22), 13), 12),
             (_rand(np.random.default_rng(23), 14), 12)]
    return [cls(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(specs)]


def _simple(lens, seed, max_new, extra=None):
    """Random prompts of ``lens``; ``extra``: Request fields by rid."""
    def make(cls):
        rng = np.random.default_rng(seed)
        return [cls(rid=i, prompt=_rand(rng, n), max_new_tokens=max_new,
                    **(extra or {}).get(i, {})) for i, n in enumerate(lens)]
    return make


WORKLOADS = {
    "chaos": _chaos_reqs,
    "retry": _simple((8, 8), 5, 4),
    "stall": _simple((12,), 5, 4),
    "short": _simple((8,), 5, 4),
    "numerics": _simple((8, 8), 9, 6),
    "guard": _simple((8,), 9, 4),
    "deadline": _simple((8, 8), 11, 24, {0: dict(deadline_steps=3)}),
    "ttft": _simple((14, 14), 13, 4, {0: dict(ttft_deadline_steps=1),
                                      1: dict(ttft_deadline_steps=20)}),
}


def _injector(cls, schedule):
    """``schedule``: None, or ``(seed, ((point, nth, prob, times), ...))``;
    a fresh injector of class ``cls`` for one engine."""
    if schedule is None:
        return None
    seed, specs = schedule
    inj = cls(seed)
    for point, nth, prob, times in specs:
        inj.add(point, nth=nth, prob=prob, times=times)
    return inj


def _summary(eng, reqs) -> dict:
    out = {"tokens": [list(r.out_tokens) for r in reqs],
           "outcomes": [(r.done, r.truncated, r.failed)
                        + ((r.error.kind, r.error.detail, r.error.step)
                           if r.error else ()) for r in reqs],
           "fired": list(eng.faults.fired_log) if eng.faults else [],
           "counters": {n: getattr(eng, n) for n in COUNTERS}}
    if eng.pool is not None:
        pins = eng._pindex.n_pinned if eng._pindex is not None else 0
        out["drained"] = eng.pool.free_count + pins == eng.pool.n_pages
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(sc_items, workload, schedule):
    jcfg, jp, _, _ = models()
    eng = JaxEngine(jcfg, jp, JaxServe(**dict(sc_items)),
                    faults=_injector(JaxInjector, schedule))
    reqs = WORKLOADS[workload](JaxRequest)
    eng.generate(reqs)
    return _summary(eng, reqs)


def _port(sc_kw, workload, schedule=None):
    _, _, tcfg, tp = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(**sc_kw), device="cpu",
                        faults=_injector(FaultInjector, schedule))
    reqs = WORKLOADS[workload](Request)
    eng.generate(reqs)
    return eng, reqs


def serve_both(sc_kw, workload, schedule=None):
    """The port and the JAX engine on the same config, requests and fault
    schedule: identical summaries (tokens, outcomes, firings, counters,
    drained pool)."""
    eng, reqs = _port(sc_kw, workload, schedule)
    got = _summary(eng, reqs)
    want = _jax_run(tuple(sorted(sc_kw.items())), workload, schedule)
    for key in want:
        assert got[key] == want[key], key
    return eng, reqs, got


def _baseline(workload="chaos", **kw):
    return _jax_run(tuple(sorted(dict(CHAOS_SC, **kw).items())), workload,
                    None)["tokens"]


ALL_POINTS = (0, (("page_alloc", 2, None, 1), ("copy_page", 1, None, 1),
                  ("swap_out", 1, None, 1), ("swap_corrupt", 1, None, 1),
                  ("swap_in", 1, None, 1), ("prefix_reclaim", 1, None, 1),
                  ("prefill_delay", 6, None, 1), ("nan_logits", 8, None, 1)))


def test_chaos_every_fault_point_acceptance():
    """One schedule fires all eight points in one mixed batch: exactly
    one request dies (``numerics``); every other one gives the fault-free
    run's tokens; audits after every step; the pool drains."""
    ref = _baseline()
    eng, reqs, got = serve_both(dict(CHAOS_SC, audit=True), "chaos",
                                ALL_POINTS)
    assert set(eng.faults.points_fired()) == set(FAULT_POINTS)
    failed = [r for r in reqs if r.failed]
    assert len(failed) == 1 and failed[0].error.kind == "numerics"
    assert failed[0].error.step > 0
    for i, r in enumerate(reqs):
        if not r.failed:
            assert r.out_tokens == ref[i], r.rid
            assert r.done and not r.truncated
    assert eng.n_retried >= 1 and eng.n_swap_fallbacks >= 1
    assert eng.n_preempted >= 1 and eng.n_audits == eng._step_count
    assert got["drained"]
    invariants.audit(eng)


def test_chaos_acceptance_reproduces_bit_for_bit():
    schedule = (0, (("swap_corrupt", 1, None, 1),
                    ("prefill_delay", 6, None, 1),
                    ("page_alloc", None, 0.2, None)))
    _, _, a = serve_both(CHAOS_SC, "chaos", schedule)
    _, _, b = serve_both(CHAOS_SC, "chaos", schedule)
    assert a == b
    assert a["fired"]


def test_config_chaos_seed_preserves_parity():
    """``ServeConfig.chaos_seed`` builds the recoverable schedule in the
    engine: faults fire, and every request completes with the fault-free
    tokens."""
    ref = _baseline()
    eng, reqs, got = serve_both(dict(CHAOS_SC, audit=True, chaos_seed=0,
                                     chaos_rate=0.25), "chaos")
    assert got["fired"]
    assert got["tokens"] == ref
    assert all(r.done and not r.failed for r in reqs)
    assert got["drained"]


def test_swap_corruption_detected_and_recomputed():
    ref = _baseline()
    eng, reqs, got = serve_both(dict(CHAOS_SC, audit=True), "chaos",
                                (0, (("swap_corrupt", 1, None, 1),)))
    assert eng.faults.points_fired() == ("swap_corrupt",)
    assert eng.n_swap_fallbacks >= 1
    assert got["tokens"] == ref
    assert all(not r.failed for r in reqs)


def test_swap_failure_terminal_without_fallback():
    ref = _baseline(swap_fallback=False)
    eng, reqs, got = serve_both(
        dict(CHAOS_SC, audit=True, swap_fallback=False), "chaos",
        (0, (("swap_in", 1, None, 1),)))
    failed = [r for r in reqs if r.failed]
    assert len(failed) == 1 and failed[0].error.kind == "swap_failed"
    assert "swap_in" in failed[0].error.detail
    for i, r in enumerate(reqs):
        if not r.failed:
            assert r.out_tokens == ref[i], r.rid
    assert got["drained"]


def test_admission_retry_exhaustion_fails_pool_exhausted():
    sc = dict(SMALL_PAGED, n_pages=8, admission="optimistic",
              admission_retries=2, audit=True)
    eng, reqs, _ = serve_both(sc, "retry",
                              (0, (("page_alloc", None, 1.0, None),)))
    assert all(r.failed and r.error.kind == "pool_exhausted" for r in reqs)
    assert eng.n_retried >= 2 * 2
    assert eng.error_counts["pool_exhausted"] == 2
    assert eng.pool.free_count == eng.pool.n_pages


def test_watchdog_raises_on_stall():
    """Every chunk delayed forever: after ``stall_steps`` steps without
    progress both engines raise, with the same step count, and the port's
    dump names the stuck slot as the reference's does."""
    sc = dict(SMALL_PAGED, chunked_prefill=True, prefill_chunk=8,
              stall_steps=5, audit=True)
    schedule = (0, (("prefill_delay", None, 1.0, None),))
    jcfg, jp, tcfg, tp = models()
    raised = []
    for eng_cls, sc_cls, req_cls, inj_cls, err, p, c, kw in (
            (ServingEngine, ServeConfig, Request, FaultInjector,
             EngineStalledError, tp, tcfg, {"device": "cpu"}),
            (JaxEngine, JaxServe, JaxRequest, JaxInjector, JaxStalled, jp,
             jcfg, {})):
        eng = eng_cls(c, p, sc_cls(**sc), faults=_injector(inj_cls, schedule),
                      **kw)
        with pytest.raises(err) as ei:
            eng.generate(WORKLOADS["stall"](req_cls))
        raised.append((ei.value.n_steps, eng.faults.fired_log))
        assert "slot 0" in ei.value.dump and "rid=0" in ei.value.dump
        assert "pool:" in ei.value.dump
    assert raised[0] == raised[1]
    assert raised[0][0] == 5


def test_stall_steps_zero_disables_watchdog():
    _, reqs, _ = serve_both(dict(max_seq_len=32, max_batch=2,
                                 temperature=0.0, decode_chunk=4,
                                 stall_steps=0), "short")
    assert reqs[0].done and not reqs[0].failed


def test_numerics_quarantine_fails_only_poisoned_slot():
    sc = dict(max_seq_len=32, max_batch=2, temperature=0.0, decode_chunk=4)
    _, base, _ = serve_both(sc, "numerics")
    eng, reqs, _ = serve_both(sc, "numerics",
                              (0, (("nan_logits", 1, None, 1),)))
    assert reqs[0].failed and reqs[0].error.kind == "numerics"
    assert reqs[0].out_tokens == []
    assert not reqs[1].failed
    assert reqs[1].out_tokens == base[1].out_tokens
    assert eng.error_counts["numerics"] == 1


def test_numerics_quarantine_on_paged_chunked_engine():
    """The poison lands on the device logits of the paged engine too, and
    the quarantined slot's pages go back to the pool."""
    sc = dict(SMALL_PAGED, chunked_prefill=True, prefill_chunk=8)
    eng, reqs, got = serve_both(sc, "numerics",
                                (0, (("nan_logits", 2, None, 1),)))
    assert [r.failed for r in reqs].count(True) == 1
    assert got["drained"]


def test_guard_numerics_off_keeps_legacy_behavior():
    _, reqs, _ = serve_both(dict(max_seq_len=32, max_batch=1,
                                 temperature=0.0, decode_chunk=4,
                                 guard_numerics=False), "guard",
                            (0, (("nan_logits", 1, None, 1),)))
    assert not reqs[0].failed and reqs[0].done


def test_total_deadline_fails_with_partial_output():
    _, reqs, _ = serve_both(dict(max_seq_len=64, max_batch=2,
                                 temperature=0.0, decode_chunk=2),
                            "deadline")
    assert reqs[0].failed and reqs[0].error.kind == "deadline"
    assert 0 < len(reqs[0].out_tokens) < 24
    assert "3 steps" in reqs[0].error.detail
    assert reqs[1].done and not reqs[1].failed
    assert len(reqs[1].out_tokens) == 24


def test_ttft_deadline():
    eng, reqs, _ = serve_both(dict(SMALL_PAGED, chunked_prefill=True,
                                   prefill_chunk=8), "ttft")
    assert reqs[0].failed and reqs[0].error.kind == "deadline"
    assert "TTFT" in reqs[0].error.detail and reqs[0].out_tokens == []
    assert reqs[1].done and not reqs[1].failed
    assert eng.pool.free_count == eng.pool.n_pages


@pytest.mark.parametrize("point", RECOVERABLE_POINTS)
def test_fault_points_recoverable_one_at_a_time(point):
    """Each recoverable point, armed alone on its first hit, keeps the
    whole batch's greedy tokens, in both engines alike."""
    ref = _baseline()
    _, reqs, got = serve_both(dict(CHAOS_SC, audit=True), "chaos",
                              (0, ((point, 1, None, 1),)))
    assert all(r.done and not r.failed for r in reqs), point
    assert got["tokens"] == ref, point


def _chaos_leg(**kw):
    """tests/conftest.py's ``paged-chaos`` leg applied to ``kw``."""
    T = kw.get("max_seq_len", 4096)
    leg = dict(paged=True, page_size=4, chunked_prefill=True,
               prefill_chunk=8, n_pages=max(2, T // 4),
               admission="optimistic", watermark_low=0.1, share_prefix=True,
               preempt_mode="swap", chaos_seed=0, audit=True, audit_every=2)
    return {**leg, **kw}


def test_paged_chaos_leg_matches_legacy_engine():
    """The reference's ``paged-chaos`` ServeConfig on the port: the
    reference's firings, audits and counters, and the tokens of the
    port's legacy engine (dense slots, no faults) on the same requests."""
    base = dict(max_seq_len=32, max_batch=4, temperature=0.0,
                decode_chunk=4)
    _, legacy, _ = serve_both(base, "chaos")
    eng, reqs, got = serve_both(_chaos_leg(**base), "chaos")
    assert got["fired"]
    assert eng.n_audits == eng._step_count // 2
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in legacy]
    assert all(r.done and not r.failed for r in reqs)
    assert got["drained"]
