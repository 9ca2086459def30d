"""The port's data-axis sharded serving engine against the reference's,
case for case with tests/test_sharded.py, in one process on the CPU
(every shard on the CPU device: ``devices=["cpu"] * S``).

The reference's mesh-backed checks run in a subprocess on four forced
host devices; here they run on the port's engine in-process, on the
reference script's own configuration, requests and calibration (reduced
tinyllama-1.1b, float32, bridged weights and projections, greedy): the
``shards=4`` and ``shards=2`` engines give the reference's ``shards=1``
engine's tokens on its 12 skewed requests, every shard completes a
request, pool exhaustion preempts only the exhausted shard's slots, and
identical prompts on different shards share no pages.  The in-process
units (``pick_shard``'s scoring and capacity, the config's validation)
run against the reference's functions on the same inputs.  Beside them:
``serve_devices``, the slot slices, ``audit_sharded`` and the CLI's
``--shards``."""
import functools
import re
from types import SimpleNamespace

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
from repro.serving.engine import pick_shard as jax_pick_shard
from repro_torch import bridge
from repro_torch.config import ServeConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.serving import Request, ServingEngine, invariants
from repro_torch.serving.engine import ShardedServingEngine, pick_shard
from repro_torch.sharding.partition import (serve_devices, slot_slice,
                                            slot_slices)

# tests/test_sharded.py's SCRIPT configuration


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(max_seq_len=64, temperature=0.0, decode_chunk=4, paged=True,
            page_size=4, chunked_prefill=True, prefill_chunk=8,
            share_prefix=True, preempt_mode="swap",
            admission="optimistic", watermark_low=0.1, audit=True,
            audit_every=2)
LENS = [3, 30, 5, 26, 4, 22, 6, 18, 5, 7, 9, 11]


@functools.lru_cache(maxsize=None)
def setup():
    """The reference script's model, params, KQ-SVD projections (ranks
    16, calibrated on two random (2, 32) batches) and prompts, drawn in
    its order: the 12 skewed prompts, the isolation case's four, then
    the two shared prompts; with the port's twins."""
    cfg = jax_config("tinyllama-1.1b").reduced()
    model = jax_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    acc = GramAccumulator(len(model.attn_layers))
    for i in range(2):
        toks = jax.random.randint(jax.random.PRNGKey(5 + i), (2, 32), 0,
                                  cfg.vocab_size)
        caps = model.calibrate(params, toks)
        acc.update_from_captures([jax.tree.map(np.asarray, c)
                                  for c in caps])
    proj = acc.solve(JaxCompression(method="kqsvd", rank_k=16, rank_v=16),
                     model.group_output_weights(params))
    rng = np.random.default_rng(0)
    skewed = [rng.integers(0, cfg.vocab_size, size=L).astype(np.int32)
              for L in LENS]
    iso = [(rng.integers(0, cfg.vocab_size, size=L).astype(np.int32), new)
           for L, new in ((16, 16), (16, 16), (5, 4), (5, 4))]
    P = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    Q = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    return (cfg, params, proj, torch_config("tinyllama-1.1b").reduced(),
            bridge.params_from_jax(jax.tree.map(np.asarray, params)),
            bridge.projections_from_jax(proj), skewed, iso, (P, Q))


@functools.lru_cache(maxsize=None)
def reference_tokens():
    """The reference's ``shards=1`` engine on the 12 skewed requests."""
    cfg, params, proj, _, _, _, skewed, _, _ = setup()
    eng = JaxEngine(cfg, params, JaxServe(**BASE, max_batch=8, n_pages=64,
                                          shards=1), projections=proj)
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(skewed)]
    eng.generate(reqs)
    assert all(r.done and not r.failed for r in reqs)
    return [list(r.out_tokens) for r in reqs]


def port_engine(shards, **kw):
    _, _, _, tcfg, tp, tproj, _, _, _ = setup()
    sc = ServeConfig(**{**BASE, "shards": shards, **kw})
    if shards == 1:
        return ServingEngine(tcfg, tp, sc, projections=tproj, device="cpu")
    return ServingEngine(tcfg, tp, sc, projections=tproj,
                         devices=["cpu"] * shards)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_matches_reference_one_shard(shards):
    """12 requests over 8 slots: the 4 queued ones route to whichever
    shard frees pages first.  Every shard count gives the reference's
    ``shards=1`` tokens; ``shards == 1`` builds no sharded class; the
    workers on one device share the params and the projections; audits
    ran; the counters sum over the shards; and at 4 shards every shard
    completed a request (the skew rebalanced)."""
    eng = port_engine(shards, max_batch=8, n_pages=64)
    assert isinstance(eng, ShardedServingEngine) == (shards > 1)
    if shards == 1:
        assert type(eng) is ServingEngine
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(setup()[6])]
    eng.generate(reqs)
    assert [list(r.out_tokens) for r in reqs] == reference_tokens()
    assert all(r.done and not r.failed for r in reqs)
    assert eng.n_completed == 12 and eng.n_audits > 0
    if shards == 1:
        return
    done = [w.n_completed for w in eng.workers]
    assert sum(done) == 12 and min(done) >= 1, done
    assert eng.n_decode_steps == sum(w.n_decode_steps for w in eng.workers)
    assert eng.pool.n_pages == 64 and eng._local_phys == 64 // shards
    for w in eng.workers:
        assert w.params is eng.params and w.proj is eng.proj
        assert w.sc.shards == 1 and w.sc.seed == eng.sc.seed + w._shard
    assert [w._slots for w in eng.workers] == slot_slices(8, shards)


def test_pool_exhaustion_stays_on_its_shard():
    """Shard 0 takes two sequences whose prompts fit its 10-page pool but
    outgrow it in decode; shard 1 two short ones: only shard 0's slots are
    preempted and every request completes (swap keeps the progress)."""
    eng = port_engine(2, max_batch=4, n_pages=20)
    iso = [Request(rid=i, prompt=p, max_new_tokens=n)
           for i, (p, n) in enumerate(setup()[7])]
    eng.generate(iso)
    assert all(r.done and not r.failed for r in iso), [r.error for r in iso]
    w0, w1 = eng.workers
    assert w0.n_preempted > 0, "shard 0 never oversubscribed"
    assert w1.n_preempted == 0, "exhaustion leaked to shard 1"
    assert set(eng.preempted_rids) <= {0, 1}, eng.preempted_rids
    assert eng.n_preempted == w0.n_preempted


def test_prefix_index_stays_on_its_shard():
    """Identical prompts routed to different shards share no pages (each
    worker owns its own index), and their tokens agree."""
    P, Q = setup()[8]
    eng = port_engine(2, max_batch=4, n_pages=32)
    # routing fills shard 0's two slots first: [P, Q] -> s0, [P, Q] -> s1
    pre = [Request(rid=i, prompt=p.copy(), max_new_tokens=5)
           for i, p in enumerate([P, Q, P, Q])]
    eng.generate(pre)
    assert all(r.done and not r.failed for r in pre)
    assert pre[0].out_tokens == pre[2].out_tokens
    assert pre[1].out_tokens == pre[3].out_tokens
    assert eng.n_shared_pages == 0 and eng.n_full_hits == 0
    ix = [w._pindex for w in eng.workers]
    assert ix[0] is not None and ix[0] is not ix[1]


def test_shards_validation():
    base = dict(max_seq_len=32, max_batch=4, paged=True, page_size=4,
                chunked_prefill=True, prefill_chunk=8)
    with pytest.raises(ValueError, match="shards must be >= 1"):
        ServeConfig(**base, shards=0)
    with pytest.raises(ValueError, match="paged=True"):
        ServeConfig(max_seq_len=32, max_batch=4, shards=2)
    with pytest.raises(ValueError, match="token-budget"):
        ServeConfig(**base, shards=2, max_num_batched_tokens=6)
    with pytest.raises(ValueError, match="max_batch 3"):
        ServeConfig(max_seq_len=32, max_batch=3, paged=True, page_size=4,
                    chunked_prefill=True, prefill_chunk=8, shards=2)
    with pytest.raises(ValueError, match="total_pages 5"):
        ServeConfig(**base, shards=2, n_pages=5)
    assert ServeConfig(**base, shards=2, n_pages=8).shards == 2


def _stub(shard, free_slots, pending, free, used, high):
    pool = SimpleNamespace(free_count=free, used_count=used,
                           high_pages=high)
    return SimpleNamespace(_shard=shard, pool=pool,
                           _slot_req=[None] * free_slots,
                           _pending=[object()] * pending)


def _same_pick(workers, capacity=None):
    """The port's pick equals the reference's on the same stubs."""
    got = pick_shard(workers, capacity)
    assert got is jax_pick_shard(workers, capacity)
    return got


def test_pick_shard_scoring():
    a = _stub(0, free_slots=2, pending=0, free=4, used=6, high=8)
    b = _stub(1, free_slots=2, pending=0, free=9, used=1, high=8)
    assert _same_pick([a, b]) is b        # 2 vs 7
    c = _stub(1, free_slots=2, pending=0, free=3, used=9, high=8)
    assert _same_pick([a, c]) is a        # past the watermark: 2 vs 0
    d = _stub(0, free_slots=1, pending=0, free=5, used=0, high=8)
    e = _stub(1, free_slots=1, pending=0, free=5, used=0, high=8)
    assert _same_pick([d, e]) is d        # ties to the lower index


def test_pick_shard_capacity():
    a = _stub(0, free_slots=2, pending=2, free=9, used=0, high=8)
    b = _stub(1, free_slots=1, pending=0, free=2, used=7, high=8)
    assert _same_pick([a, b]) is b        # a backlog takes capacity
    assert _same_pick([a, _stub(1, 1, 1, 9, 0, 8)]) is None
    x = _stub(0, free_slots=2, pending=0, free=9, used=0, high=8)
    y = _stub(1, free_slots=2, pending=0, free=9, used=0, high=8)
    assert _same_pick([x, y], [0, 1]) is y
    assert _same_pick([x, y], [0, 0]) is None


def test_serve_devices_and_slot_slices(monkeypatch):
    """An explicit device repeats once a shard; without one, the first
    CUDA devices, and a ValueError naming the count when fewer exist."""
    assert serve_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert serve_devices(2) == [torch.device("cuda", 0),
                                torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="needs 4 devices, found 2"):
        serve_devices(4)
    assert slot_slice(2, 4) == slice(8, 12)
    assert slot_slices(8, 4) == [slice(0, 2), slice(2, 4), slice(4, 6),
                                 slice(6, 8)]
    with pytest.raises(ValueError, match="equal shards"):
        slot_slices(6, 4)


def test_audit_sharded_catches_a_request_owned_twice():
    """A request both in the global queue and in a shard's local queue,
    and a shard cache leaf off its device, fail the cross-shard audit;
    the engine as started passes it."""
    eng = port_engine(2, max_batch=4, n_pages=16)
    r = Request(rid=7, prompt=np.arange(5, dtype=np.int32))
    eng.start([r])
    invariants.audit_sharded(eng)
    eng.workers[1]._pending.append(r)
    with pytest.raises(invariants.InvariantViolation,
                       match="both in the global queue"):
        invariants.audit_sharded(eng)
    eng.workers[1]._pending.clear()
    eng.workers[0].device = torch.device("meta")
    with pytest.raises(invariants.InvariantViolation, match="holds cache"):
        invariants.audit_sharded(eng)


def test_cli_serves_two_shards(capsys):
    """``--shards 2 --device cpu`` serves every request, both shards on
    the CPU, the pooled pool whole after the drain."""
    from repro_torch.launch.serve import main
    main(["--arch", "tinyllama-1.1b", "--reduced", "--method", "kqsvd",
          "--paged", "--prefill-chunk", "8", "--page-size", "4",
          "--shards", "2", "--requests", "6", "--max-new-tokens", "4",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req ") == 6 and "[failed" not in out
    assert "sharded: 2 shard(s)" in out and "devices: cpu, cpu" in out
    pool = re.search(r"page pool: (\d+) pages .* (\d+) free after", out)
    assert pool and pool.group(1) == pool.group(2), out
