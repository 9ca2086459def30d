"""The port's token-budget scheduler against the reference's, case for
case with tests/test_budget.py (greedy, reduced tinyllama-1.1b, float32,
bridged weights).  With budgets 1, 6 and 16 the budgeted port gives the
JAX engine's ``budget_log``, fused steps, truncated chunks, tokens and
outcomes, and the tokens of both legacy engines; the accounting rules
hold every step (decode charged first, prefill only in the residual,
admission capped at the budget).  Last, the reference's ``paged-budget``
and ``paged-quant`` legs (tests/conftest.py: chaos, sampled audits and the
budget on fp pages, and on int8 pages with per-chunk split counts) on
the port against the JAX engine and the port's legacy engine."""
import dataclasses
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


BASE = dict(max_seq_len=32, max_batch=4, temperature=0.0,
            decode_chunk=4, paged=True, page_size=4,
            chunked_prefill=True, prefill_chunk=8)
LENS = (18, 3, 12, 9, 26, 5, 14)        # mixed multi/sub-chunk prompts
COUNTERS = ("budget_log", "n_fused_steps", "n_truncated_chunks",
            "n_prefill_chunks", "n_completed", "n_failed", "error_counts",
            "n_preempted", "n_swapped_out", "n_swapped_in",
            "n_swap_fallbacks", "n_retried", "n_audits", "n_shared_pages",
            "n_cow_forks", "peak_used_pages", "_step_count")


@functools.lru_cache(maxsize=None)
def models():
    jcfg = jax_config("tinyllama-1.1b").reduced()
    jp = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return jcfg, jp, torch_config("tinyllama-1.1b").reduced(), tp


@functools.lru_cache(maxsize=None)
def projections():
    """Full-rank KQ-SVD projections solved by the reference, and their
    bridged copies (tests/test_page_layouts.py's ``setup``)."""
    jcfg, jp, _, _ = models()
    jm = jax_model(jcfg)
    acc = GramAccumulator(len(jm.attn_layers))
    for i in range(2):
        toks = jax.random.randint(jax.random.PRNGKey(5 + i), (2, 32), 0,
                                  jcfg.vocab_size)
        acc.update_from_captures([jax.tree.map(np.asarray, c)
                                  for c in jm.calibrate(jp, toks)])
    mp = acc.solve(JaxCompression(method="kqsvd", rank_k=jcfg.d_head,
                                  rank_v=jcfg.d_head),
                   jm.group_output_weights(jp))
    return mp, bridge.projections_from_jax(mp)


def mk_reqs(cls, lens=LENS, max_new=6, seed=0):
    vocab = models()[2].vocab_size
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, int(n)).astype(np.int32),
                max_new_tokens=max_new)
            for i, n in enumerate(lens)]


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
def _jax_run(sc_items, reqs_key, quant=False):
    jcfg, jp, _, _ = models()
    kw = {}
    if quant:
        # the reference's Pallas route: its int8 arithmetic is the port's
        # K5's (tests/test_torch_quant_serving.py)
        jcfg = dataclasses.replace(jcfg, use_pallas=True)
        kw["projections"] = projections()[0]
    eng = JaxEngine(jcfg, jp, JaxServe(**dict(sc_items)), **kw)
    reqs = mk_reqs(JaxRequest, *reqs_key)
    eng.generate(reqs)
    return _summary(eng, reqs)


def serve_both(sc_kw, lens=LENS, max_new=6, seed=0, quant=False):
    """The port and the JAX engine on the same config and requests:
    identical summaries (tokens, outcomes, firings, budget log and
    counters, drained pool)."""
    _, _, tcfg, tp = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(**sc_kw), device="cpu",
                        projections=projections()[1] if quant else None)
    reqs = mk_reqs(Request, lens, max_new, seed)
    eng.generate(reqs)
    got = _summary(eng, reqs)
    want = _jax_run(tuple(sorted(sc_kw.items())), (tuple(lens), max_new,
                                                   seed), quant)
    for key in want:
        assert got[key] == want[key], key
    return eng, reqs, got


def check_accounting(eng):
    """Every step: decode charged first, prefill only in the residual,
    admission never lifting occupancy past the budget."""
    budget = eng.sc.max_num_batched_tokens
    for e in eng.budget_log:
        assert e["n_decode"] <= budget, e
        assert e["prefill_tokens"] <= budget - e["n_decode"], e


def test_config_validation():
    for cls in (ServeConfig, JaxServe):
        with pytest.raises(ValueError, match="max_num_batched_tokens"):
            cls(**BASE, max_num_batched_tokens=-1)
        with pytest.raises(ValueError, match="chunked_prefill"):
            cls(max_seq_len=32, max_batch=4, max_num_batched_tokens=8)


@pytest.mark.parametrize("budget", [1, 6, 16])
def test_parity_with_legacy_scheduler(budget):
    """Greedy tokens are scheduling-invariant: the budgeted port gives the
    legacy engines' tokens and the budgeted JAX engine's budget log, for
    any budget."""
    _, legacy, _ = serve_both(BASE)
    eng, budgeted, _ = serve_both(dict(BASE, max_num_batched_tokens=budget))
    for a, b in zip(legacy, budgeted):
        assert a.out_tokens == b.out_tokens, (budget, a.rid)
        assert len(b.out_tokens) == 6
    assert eng.n_failed == 0
    assert len(eng.budget_log) == eng._step_count
    check_accounting(eng)


def test_decode_charged_before_prefill():
    eng, _, _ = serve_both(dict(BASE, max_num_batched_tokens=6))
    check_accounting(eng)
    mixed = [e for e in eng.budget_log
             if e["n_decode"] and e["prefill_tokens"]]
    assert mixed, "no step mixed decode with prefill"


def test_chunk_truncation_at_residual():
    eng, reqs, _ = serve_both(dict(BASE, max_num_batched_tokens=6),
                              lens=(26,), max_new=4)
    assert reqs[0].done and not reqs[0].failed
    assert len(reqs[0].out_tokens) == 4
    assert eng.n_truncated_chunks > 0
    assert all(e["prefill_tokens"] <= 6 for e in eng.budget_log)


def test_budget_one_serializes():
    lens = (9, 4, 12)
    _, legacy, _ = serve_both(BASE, lens=lens)
    eng, reqs, _ = serve_both(dict(BASE, max_num_batched_tokens=1),
                              lens=lens)
    for a, b in zip(legacy, reqs):
        assert a.out_tokens == b.out_tokens
    for e in eng.budget_log:
        assert e["n_decode"] + e["prefill_tokens"] <= 1, e
    assert eng.n_fused_steps == 0


def test_fused_steps_fire():
    """Decode and prefill overlap, so the first staged chunk rides the
    decode chunk; no request loses tokens to the fusion (a slot finishing
    its prompt mid-step is armed after the decode chunk)."""
    lens = (4, 26, 20, 9, 18)
    _, legacy, _ = serve_both(BASE, lens=lens)
    eng, reqs, _ = serve_both(dict(BASE, max_num_batched_tokens=8),
                              lens=lens)
    assert eng.n_fused_steps > 0
    for r, lr in zip(reqs, legacy):
        assert r.done and not r.failed
        assert r.out_tokens == lr.out_tokens and len(r.out_tokens) == 6
    check_accounting(eng)


def test_deferred_activation_arms_after_the_decode_chunk():
    """A fused step's completing slot is queued with its logits on the
    device and armed only after the step's decode chunk: at the step's
    end it is decodable, its next-token logits are the chunk's."""
    _, _, tcfg, tp = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(**BASE,
                                              max_num_batched_tokens=8),
                        device="cpu")
    reqs = mk_reqs(Request, (4, 12), max_new=12)
    eng.start(reqs)
    seen = False
    while True:
        before = eng._prefilled[1]
        busy = eng.step()
        assert eng._activation_queue is None
        if (eng.budget_log[-1]["fused"] and before is not None
                and eng._prefilled[1] is None and eng._slot_req[1]):
            seen = True              # slot 1's last chunk rode the decode
            assert not eng._done[1] and eng._pos[1] == 12
            assert len(reqs[1].out_tokens) == 0
        if not busy:
            break
    assert seen and all(len(r.out_tokens) == 12 for r in reqs)


def test_oversize_prompt_structured_failure():
    _, _, tcfg, tp = models()
    vocab = tcfg.vocab_size
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, vocab, 40).astype(np.int32),
               rng.integers(0, vocab, 8).astype(np.int32)]
    out = []
    for eng in (ServingEngine(tcfg, tp, ServeConfig(
                    **BASE, max_num_batched_tokens=6), device="cpu"),
                JaxEngine(models()[0], models()[1], JaxServe(
                    **BASE, max_num_batched_tokens=6))):
        cls = Request if isinstance(eng, ServingEngine) else JaxRequest
        reqs = [cls(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        eng.generate(reqs)
        assert reqs[0].failed and reqs[0].error.kind == "oversize"
        assert reqs[0].out_tokens == []
        assert reqs[1].done and not reqs[1].failed
        assert len(reqs[1].out_tokens) == 4
        assert eng.error_counts["oversize"] == 1
        out.append((_summary(eng, reqs), eng.budget_log))
    assert out[0] == out[1]
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        ServingEngine(tcfg, tp, ServeConfig(**BASE), device="cpu").start(
            [Request(rid=0, prompt=prompts[0])])


def test_bucket_error_is_structured_failure(monkeypatch):
    """``bucket_for`` raising mid-prefill fails the request with
    ``oversize`` through the budget path in both engines; its pages are
    unwound and the batch goes on."""
    summaries = []
    for cls in (ServeConfig, JaxServe):
        orig = cls.bucket_for

        def boom(self, n, orig=orig):
            if n == 2:                   # the 10-token prompt's tail
                raise ValueError(f"no bucket for chunk of {n}")
            return orig(self, n)

        monkeypatch.setattr(cls, "bucket_for", boom)
    _, _, tcfg, tp = models()
    for eng, req_cls in (
            (ServingEngine(tcfg, tp, ServeConfig(**BASE,
                                                 max_num_batched_tokens=8),
                           device="cpu"), Request),
            (JaxEngine(models()[0], models()[1],
                       JaxServe(**BASE, max_num_batched_tokens=8)),
             JaxRequest)):
        reqs = mk_reqs(req_cls, (10, 8), max_new=4, seed=3)
        eng.generate(reqs)
        assert reqs[0].failed and reqs[0].error.kind == "oversize"
        assert "no bucket" in reqs[0].error.detail
        assert reqs[1].done and not reqs[1].failed
        assert len(reqs[1].out_tokens) == 4
        assert eng.error_counts["oversize"] == 1
        assert eng.pool.free_count == eng.pool.n_pages
        summaries.append(_summary(eng, reqs))
    assert summaries[0] == summaries[1]


def _leg(leg, **kw):
    """tests/conftest.py's ``paged-budget`` / ``paged-quant`` leg applied
    to ``kw``."""
    T = kw.get("max_seq_len", 4096)
    out = dict(paged=True, page_size=4, chunked_prefill=True,
               prefill_chunk=8, n_pages=max(2, T // 4),
               admission="optimistic", watermark_low=0.1, share_prefix=True,
               preempt_mode="swap", chaos_seed=0, audit=True, audit_every=2,
               max_num_batched_tokens=6)
    if leg == "paged-quant":
        out.update(cache_quant="int8", decode_splits=0)
    return {**out, **kw}


@pytest.mark.parametrize("leg", ["paged-budget", "paged-quant"])
def test_budget_legs_match_legacy_engine(leg):
    """The reference's budget legs on the port: the JAX engine's firings,
    audits, budget log and tokens, and the tokens of the port's legacy
    engine on the same pages (fp, or int8 with projections)."""
    base = dict(max_seq_len=32, max_batch=4, temperature=0.0,
                decode_chunk=4)
    quant = leg == "paged-quant"
    legacy_kw = dict(base, paged=True, page_size=4, chunked_prefill=True,
                     prefill_chunk=8, cache_quant="int8") if quant else base
    _, legacy, _ = serve_both(legacy_kw, quant=quant)
    eng, reqs, got = serve_both(_leg(leg, **base), quant=quant)
    assert got["fired"] and eng.n_fused_steps > 0
    assert eng.n_audits == eng._step_count // 2
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in legacy]
    assert all(r.done and not r.failed for r in reqs)
    assert got["drained"]
    check_accounting(eng)
