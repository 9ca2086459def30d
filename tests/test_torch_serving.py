"""The port's dense-slot serving engine against the reference's (dense
leg, greedy): the same out_tokens on the reference test_serving.py cases
— mixed lengths with refill, truncation, EOS, the compressed cache — and
the port's own failure semantics."""
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
from repro_torch.serving import (EngineStalledError, Request, ServingEngine,
                                 sample_token)
from repro_torch.serving.engine import ShardedServingEngine


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


def serve_both(prompts, max_new, compressed=False, **sc_kw):
    """Serve the same requests on both engines; returns both lists."""
    jcfg, jp, tcfg, tp, jmp, tmp = models()
    kw = dict(max_seq_len=64, max_batch=4, temperature=0.0)
    kw.update(sc_kw)
    jeng = JaxEngine(jcfg, jp, JaxServe(**kw),
                     projections=jmp if compressed else None)
    teng = ServingEngine(tcfg, tp, ServeConfig(**kw),
                         projections=tmp if compressed else None,
                         device="cpu")
    jr = [JaxRequest(rid=i, prompt=p, max_new_tokens=max_new)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p, max_new_tokens=max_new)
          for i, p in enumerate(prompts)]
    jeng.generate(jr)
    teng.generate(tr)
    return jeng, jr, teng, tr


def _prompts(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, L).astype(np.int32) for L in lens]


def test_mixed_lengths_match_reference_and_one_by_one():
    """More requests than slots (refill), mixed lengths: the port's
    batch == the reference's batch == the port serving each alone."""
    prompts = _prompts(3, [3, 9, 6, 12, 5, 8])
    _, jr, teng, tr = serve_both(prompts, 6, decode_chunk=4)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and not r.truncated and len(r.out_tokens) == 6
               for r in tr)
    _, _, tcfg, tp, _, _ = models()
    for p, r in zip(prompts[:2], tr):
        single = ServingEngine(tcfg, tp, dataclasses.replace(
            teng.sc, max_batch=1), device="cpu")
        r1 = [Request(rid=0, prompt=p, max_new_tokens=6)]
        single.generate(r1)
        assert r1[0].out_tokens == r.out_tokens


def test_truncation_matches_reference():
    prompt = (np.arange(10) % 256).astype(np.int32)
    _, jr, _, tr = serve_both([prompt], 8, max_seq_len=12, max_batch=2,
                              decode_chunk=4)
    assert tr[0].done and tr[0].truncated
    assert tr[0].out_tokens == jr[0].out_tokens
    assert len(tr[0].out_tokens) == 3


def test_eos_matches_reference():
    prompt = (np.arange(8) * 7 % 256).astype(np.int32)
    _, _, _, probe = serve_both([prompt], 5, max_batch=1)
    eos = int(probe[0].out_tokens[1])
    _, jr, _, tr = serve_both([prompt], 5, max_batch=2, decode_chunk=4,
                              eos_token=eos)
    assert tr[0].out_tokens == jr[0].out_tokens == probe[0].out_tokens[:2]
    assert tr[0].done and not tr[0].truncated


def test_compressed_engine_matches_reference():
    """Mixed lengths through the KQ-SVD-compressed cache (K3's plain
    version on the CPU), with the reference's capacity gain."""
    prompts = _prompts(5, [4, 11, 7])
    jeng, jr, teng, tr = serve_both(prompts, 5, compressed=True)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert teng.capacity_gain() == jeng.capacity_gain() > 1.0
    assert teng.ranks == jeng.ranks


def test_decode_steps_counted_per_model_call():
    """Each request's first token comes from its prefill logits, so
    ``max_new - 1`` model decode steps serve a lone request."""
    _, _, tcfg, tp, _, _ = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(max_seq_len=64, max_batch=2,
                                              decode_chunk=4), device="cpu")
    eng.generate([Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                          max_new_tokens=7)])
    assert eng.n_decode_steps == 6


def test_temperature_sampling_in_distribution():
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]]).repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    draws = sample_token(logits, 0.7, gen).numpy()
    freq = np.bincount(draws, minlength=4) / draws.size
    want = torch.softmax(logits[0] / 0.7, -1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.03)


def test_cancel_deadline_and_zero_budget():
    _, _, tcfg, tp, _, _ = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(max_seq_len=64, max_batch=2,
                                              decode_chunk=2), device="cpu")
    reqs = [Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                    max_new_tokens=20),
            Request(rid=1, prompt=np.arange(6, dtype=np.int32),
                    max_new_tokens=20, deadline_steps=2),
            Request(rid=2, prompt=np.arange(3, dtype=np.int32),
                    max_new_tokens=0),
            Request(rid=3, prompt=np.arange(3, dtype=np.int32),
                    max_new_tokens=3)]
    eng.start(reqs)
    eng.step()
    assert eng.cancel(0) and not eng.cancel(0)
    while eng.step():
        pass
    assert reqs[0].error.kind == "cancelled"
    assert reqs[1].error.kind == "deadline"
    assert reqs[2].done and reqs[2].out_tokens == []
    assert reqs[3].done and len(reqs[3].out_tokens) == 3
    assert eng.error_counts["cancelled"] == eng.error_counts["deadline"] == 1


def test_nonfinite_logits_fail_only_that_slot(monkeypatch):
    _, _, tcfg, tp, _, _ = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(max_seq_len=64, max_batch=2,
                                              decode_chunk=2), device="cpu")
    decode = eng.model.decode_step

    def poisoned(*a, **kw):
        lg, cache = decode(*a, **kw)
        lg[1] = float("nan")
        return lg, cache

    monkeypatch.setattr(eng.model, "decode_step", poisoned)
    reqs = [Request(rid=i, prompt=np.arange(4 + i, dtype=np.int32),
                    max_new_tokens=5) for i in range(2)]
    eng.generate(reqs)
    assert not reqs[0].failed and len(reqs[0].out_tokens) == 5
    assert reqs[1].error.kind == "numerics"


def test_watchdog_raises_on_no_progress(monkeypatch):
    _, _, tcfg, tp, _, _ = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(max_seq_len=64, max_batch=1,
                                              stall_steps=3), device="cpu")
    eng.start([Request(rid=0, prompt=np.arange(4, dtype=np.int32))])
    monkeypatch.setattr(eng, "_step_inner", lambda: True)
    with pytest.raises(EngineStalledError):
        for _ in range(3):
            eng.step()


@pytest.mark.parametrize("later", [
    dict(paged=True, page_size=4, max_seq_len=64, chunked_prefill=True,
         prefill_chunk=8, max_batch=8, shards=2),
    dict(audit=True, audit_every=2),
    dict(paged=True, page_size=4, max_seq_len=64, chunked_prefill=True,
         prefill_chunk=8, max_num_batched_tokens=6),
    dict(audit=True), dict(chaos_seed=0)])
def test_later_slice_features_raise(later):
    """No serving feature is refused any more: sharded serving builds the
    sharded engine (every shard on the given device), and it, audits,
    chaos and the token budget build and serve."""
    _, _, tcfg, tp, _, _ = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(**{"max_seq_len": 64,
                                                 **later}), device="cpu")
    sharded = later.get("shards", 1) > 1
    assert isinstance(eng, ShardedServingEngine) == sharded
    if sharded:
        assert eng.devices == [torch.device("cpu")] * 2
    reqs = [Request(rid=i, prompt=np.arange(4 + i, dtype=np.int32),
                    max_new_tokens=3) for i in range(2)]
    eng.generate(reqs)
    assert all(r.done and not r.failed and len(r.out_tokens) == 3
               for r in reqs)


@pytest.mark.parametrize("flags", [
    ["--audit"], ["--chaos-seed", "0"], ["--shards", "2"],
    ["--max-batched-tokens", "6", "--audit"]])
def test_cli_refuses_flags_of_later_slices(flags, capsys):
    """Every flag of the reference CLI parses now: ``--shards`` (turning
    on chunked prefill, so paging), the audits, chaos and the token
    budget (the budget turning on chunked prefill)."""
    from repro_torch.launch.serve import parse_args
    argv = ["--arch", "tinyllama-1.1b", *flags]
    args = parse_args(argv)
    assert args.audit == ("--audit" in flags)
    assert args.chaos_seed == (0 if "--chaos-seed" in flags else None)
    assert args.shards == (2 if "--shards" in flags else 1)
    if "--max-batched-tokens" in flags:
        assert args.max_batched_tokens == 6 and args.prefill_chunk == 8
        assert args.paged
    if "--shards" in flags:
        assert args.prefill_chunk == 8 and args.paged
        assert "enabling chunked prefill" in capsys.readouterr().out


def test_cli_serves_optimistic_swap_with_sharing(capsys):
    """A CPU drive of the CLI with optimistic admission, swap, sharing and
    two priority tiers on an oversubscribed pool: its implications and
    report lines, every request served in full."""
    from repro_torch.launch import serve as cli
    cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--method", "kqsvd",
              "--requests", "8", "--prompt-len", "14", "--max-new-tokens",
              "6", "--decode-chunk", "4", "--page-size", "4", "--n-pages",
              "12", "--shared-frac", "0.5", "--admission", "optimistic",
              "--preempt-mode", "swap", "--watermark-low", "0.1",
              "--share-prefix", "--priority", "0,1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "enabling chunked prefill (--prefill-chunk 8)" in out
    assert "enabling --paged" in out
    served = [ln for ln in out.splitlines() if ln.startswith("req ")]
    assert len(served) == 8 and not any("failed" in ln for ln in served)
    assert all(ln.count(",") == 5 for ln in served)      # 6 tokens each
    line = next(ln for ln in out.splitlines()
                if ln.startswith("admission=optimistic"))
    n_pre = int(line.split("preemptions=")[1].split()[0])
    swaps = line.split("swap out/in ")[1].split(")")[0].split("/")
    assert n_pre >= 1 and swaps[0] == swaps[1] and int(swaps[0]) >= 1
    assert "failed=0" in line
    sharing = next(ln for ln in out.splitlines()
                   if ln.startswith("prefix sharing:"))
    assert int(sharing.split()[2]) > 0          # pages shared


def test_cli_serves_chaos_audit_budget(capsys):
    """A CPU drive of the CLI with chaos, audits and the token budget: the
    reference CLI's chaos and budget lines, every request served."""
    from repro_torch.launch import serve as cli
    cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--method", "kqsvd",
              "--requests", "8", "--prompt-len", "14", "--max-new-tokens",
              "6", "--decode-chunk", "4", "--paged", "--prefill-chunk", "8",
              "--page-size", "4", "--chaos-seed", "0", "--audit",
              "--max-batched-tokens", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    served = [ln for ln in out.splitlines() if ln.startswith("req ")]
    assert len(served) == 8 and not any("failed" in ln for ln in served)
    assert "chaos(seed=0, rate=0.05): " in out
    audits = next(ln for ln in out.splitlines() if ln.startswith("audits:"))
    assert int(audits.split()[1]) > 0
    budget = next(ln for ln in out.splitlines()
                  if ln.startswith("token budget 6/step"))
    assert " 0 fused" not in budget and " 0 chunk(s) truncated" not in budget


def test_cli_parses_ported_flags():
    from repro_torch.launch.serve import parse_args
    args = parse_args(["--arch", "tinyllama-1.1b", "--reduced",
                       "--shared-frac", "0.5", "--deadline-steps", "3",
                       "--device", "cpu"])
    assert (args.shared_frac, args.deadline_steps, args.device) == \
        (0.5, 3, "cpu")
