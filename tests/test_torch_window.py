"""The sliding-window ring cache in the port against the reference, on
reduced h2o-danube-1.8b (window 16, float32, bridged weights): prefill
and decode across the window (prompts of W - 1, W, W + 1 and more
tokens, decode wrapping the ring) against the reference's
``train_logits`` and its own prefill / decode, per-sequence positions
over one ring, the bridge at danube's own head layout, calibration
through K6's window branch (its plain version here), the dense-slot
engine's greedy tokens with the full cache, KQ-SVD
and the dense int8 cache, the refusal of paged storage, and the CLI."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CompressionConfig as JaxCompression
from repro.config import ServeConfig as JaxServe
from repro.configs import get_config as jax_config
from repro.core.calibration import GramAccumulator
from repro.core.calibration import calibrate_model as jax_calibrate
from repro.models import build_model as jax_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.config import CompressionConfig, ServeConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.core.calibration import calibrate_model
from repro_torch.data import calibration_batches
from repro_torch.launch import serve as cli
from repro_torch.models import build_model as torch_model
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


ARCH = "h2o-danube-1.8b"
TOL = dict(rtol=2e-4, atol=2e-4)       # test_models_smoke.py's bar


@functools.lru_cache(maxsize=None)
def models():
    """Reference model, params and KQ-SVD projections (calibrated on 32
    tokens, twice the window), and the port's twins."""
    jcfg = jax_config(ARCH).reduced()
    tcfg = torch_config(ARCH).reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.sliding_window == 16
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
    tm = torch_model(tcfg, "cpu")
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return jm, jp, mp, tm, tp, bridge.projections_from_jax(mp)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("S", [15, 16, 17, 20])
def test_prefill_then_decode_across_window_matches_train_logits(S):
    """Mirror of test_models_smoke.py::test_swa_ring_cache_decode: the
    ring cache's prefill and decode logits equal the full-sequence
    windowed logits of the reference and its own prefill / decode, for
    prompts of W - 1, W, W + 1 and W + 4 tokens and 8 steps that wrap the
    ring."""
    jm, jp, _, tm, tp, _ = models()
    extra = 8
    toks = np.random.default_rng(S).integers(
        0, jm.cfg.vocab_size, (1, S + extra)).astype(np.int32)
    full, _ = jm.train_logits(jp, {"tokens": toks})
    jl, jc = jm.prefill(jp, {"tokens": toks[:, :S]}, S + extra)
    tl, tc = tm.prefill(tp, toks[:, :S], S + extra)
    assert tc[0]["k"].shape[2] == 16 and tc[0]["slot_pos"].shape == (1, 16)
    _close(tl[:, 0], full[:, S - 1])
    _close(tl, jl)
    np.testing.assert_array_equal(
        tc[0]["slot_pos"].numpy(),
        np.asarray(jc["steps"]["layers"][0]["slot_pos"][0]))
    for t in range(extra):
        tok = toks[:, S + t: S + t + 1]
        jl, jc = jm.decode_step(jp, jc, tok, jnp.int32(S + t))
        tl, tc = tm.decode_step(tp, tc, tok, S + t)
        _close(tl[:, 0], full[:, S + t])
        _close(tl, jl)


def test_bridge_at_danube_head_layout():
    """The bridge and the ring at h2o-danube-1.8b's own head layout (32
    query heads on 8 kv heads, d_head 80), narrow elsewhere (2 layers,
    d_model 128, window 16): the bridged port gives the reference's
    prefill and ring decode logits."""
    cfg = dict(n_heads=32, n_kv_heads=8, d_head=80, d_model=128)
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), **cfg)
    tcfg = dataclasses.replace(torch_config(ARCH).reduced(), **cfg)
    jm, tm = jax_model(jcfg), torch_model(tcfg, "cpu")
    jp = jm.init(jax.random.PRNGKey(1))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    assert tuple(tp["layers"][0]["attn"]["wk"].shape) == (128, 8, 80)
    S, extra = 20, 4
    toks = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, (2, S + extra)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": toks[:, :S]}, S + extra)
    tl, tc = tm.prefill(tp, toks[:, :S], S + extra)
    _close(tl, jl)
    for t in range(extra):
        tok = toks[:, S + t: S + t + 1]
        jl, jc = jm.decode_step(jp, jc, tok, jnp.int32(S + t))
        tl, tc = tm.decode_step(tp, tc, tok, S + t)
        _close(tl, jl)


@pytest.mark.parametrize("cache_quant", ["none", "int8"])
def test_compressed_ring_decode_matches_reference(cache_quant):
    """KQ-SVD over the ring (the plain decode route, as the reference
    takes), with the fp and the dense int8 cache, after prefill and after
    each decode step across the wrap: every layer's ``slot_pos`` equals
    the reference's; the fp cache's leaves agree within 1e-5 and the
    logits within 2e-4.  Over the int8 cache the first layer's leaves
    (fed the embeddings alone) are bit-identical, and the logits agree
    within the bf16 bar of tests/test_kernels.py, 2e-2: both packages
    round the value product to bf16 (``int8_decode_attention``), and
    float32 noise from earlier layers can move a value across a bf16 or
    int8 rounding boundary (the same holds without a window)."""
    jm, jp, mp, tm, tp, tmp = models()
    jm = jax_model(dataclasses.replace(jm.cfg, cache_quant=cache_quant))
    tm = torch_model(dataclasses.replace(tm.cfg, cache_quant=cache_quant),
                     "cpu")
    jproj = jm.projections_pytree(mp, jnp.float32)
    tproj = tm.projections_pytree(tmp)
    B, S, extra = 2, 18, 6
    toks = np.random.default_rng(3).integers(
        0, jm.cfg.vocab_size, (B, S + extra)).astype(np.int32)
    tol = 2e-4 if cache_quant == "none" else 2e-2

    def check(tl, tc, jl, jc):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol)
        for i, layer in enumerate(tc):
            ref = jc["steps"]["layers"][0]
            assert set(layer) == set(ref)
            for name, t in layer.items():
                want = np.asarray(ref[name][i]).astype(np.float32)
                if name == "slot_pos" or i == 0 and cache_quant == "int8":
                    np.testing.assert_array_equal(t.float().numpy(), want)
                elif cache_quant == "none":
                    np.testing.assert_allclose(t.float().numpy(), want,
                                               rtol=1e-5, atol=1e-5)

    jl, jc = jm.prefill(jp, {"tokens": toks[:, :S]}, 32, proj=jproj)
    tl, tc = tm.prefill(tp, toks[:, :S], 32, proj=tproj)
    check(tl, tc, jl, jc)
    for t in range(extra):
        tok = toks[:, S + t: S + t + 1]
        jl, jc = jm.decode_step(jp, jc, tok, jnp.int32(S + t), proj=jproj)
        tl, tc = tm.decode_step(tp, tc, tok, S + t, proj=tproj)
        check(tl, tc, jl, jc)


def test_varlen_ring_decode_matches_reference():
    """Mirror of test_attention.py::test_varlen_decode_sliding_window:
    lengths (20, 6), one past the window and one inside it, prefilled one
    by one into one batched ring and decoded 4 steps at per-sequence
    positions; equal to the reference's batch and to the port's own
    one-sequence decode."""
    from test_attention import merge_slot_caches
    jm, jp, _, tm, tp, _ = models()
    lens, extra = (20, 6), 4
    B, T = len(lens), max(lens) + extra + 2
    toks = np.random.default_rng(2).integers(
        0, jm.cfg.vocab_size, (B, max(lens) + extra)).astype(np.int32)
    jcs, tcs = [], []
    for b, L in enumerate(lens):
        jcs.append(jm.prefill(jp, {"tokens": toks[b: b + 1, :L]}, T)[1])
        tcs.append(tm.prefill(tp, toks[b: b + 1, :L], T)[1])
    jc = merge_slot_caches(jcs)
    tc = [{k: torch.cat([c[i][k] for c in tcs]) for k in tcs[0][i]}
          for i in range(len(tcs[0]))]
    singles = [[{k: t.clone() for k, t in layer.items()} for layer in c]
               for c in tcs]
    pos = np.asarray(lens, np.int32)
    for t in range(extra):
        feed = np.stack([toks[b, lens[b] + t] for b in range(B)])[:, None]
        jl, jc = jm.decode_step(jp, jc, feed, jnp.asarray(pos + t))
        tl, tc = tm.decode_step(tp, tc, feed, pos + t)
        _close(tl, jl)
        for b, L in enumerate(lens):
            l1, singles[b] = tm.decode_step(tp, singles[b], feed[b: b + 1],
                                            L + t)
            np.testing.assert_allclose(tl[b].numpy(), l1[0].numpy(),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", ["kqsvd", "ksvd"])
def test_window_calibration_solves_to_reference_projections(method):
    """Captures through the windowed prefill of sequences twice the
    window: calibrate_model over the torch LM == over the JAX LM, by the
    sign-free products (test_torch_calibration.py's comparison)."""
    jm, jp, _, tm, tp, _ = models()
    batches = calibration_batches(jm.cfg.vocab_size, 4, 32, batch=2)
    mine = calibrate_model(tm, tp, batches,
                           CompressionConfig(method=method, epsilon=0.1))
    ref = jax_calibrate(jm, jp, batches,
                        JaxCompression(method=method, epsilon=0.1))
    assert mine.ranks_k == ref.ranks_k and mine.ranks_v == ref.ranks_v
    for prod, names in (("lhdr,lher->lhde", ("a_k", "b_q")),
                        ("lhdr,lhro->lhdo", ("a_v", "c_v"))):
        got = np.einsum(prod, *(getattr(mine, n) for n in names))
        want = np.einsum(prod, *(getattr(ref, n) for n in names))
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("method,cache_quant", [
    ("none", "none"), ("kqsvd", "none"), ("kqsvd", "int8")],
    ids=["full", "kqsvd", "kqsvd-dense-int8"])
def test_engine_matches_reference(method, cache_quant):
    """The dense-slot engine over the ring: 5 requests of 9..40 prompt
    tokens (past the window and inside it) and 12 new tokens on 3 slots,
    so slots are reused, give the reference engine's greedy tokens."""
    jm, jp, jmp, tm, tp, tmp = models()
    jcfg = dataclasses.replace(jm.cfg, cache_quant=cache_quant)
    tcfg = dataclasses.replace(tm.cfg, cache_quant=cache_quant)
    kw = dict(max_seq_len=64, max_batch=3, temperature=0.0, decode_chunk=4)
    compressed = method != "none"
    jeng = JaxEngine(jcfg, jp, JaxServe(**kw),
                     projections=jmp if compressed else None)
    teng = ServingEngine(tcfg, tp, ServeConfig(**kw),
                         projections=tmp if compressed else None,
                         device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab_size, L).astype(np.int32)
               for L in (9, 40, 16, 17, 25)]
    jr = [JaxRequest(rid=i, prompt=p, max_new_tokens=12)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p, max_new_tokens=12)
          for i, p in enumerate(prompts)]
    jeng.generate(jr)
    teng.generate(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and len(r.out_tokens) == 12 for r in tr)
    assert teng._cache[0]["slot_pos"].shape == (3, 16)


def test_reused_slot_ring_is_overwritten():
    """A slot that served a long prompt and then a short one holds only
    the short one's positions: prefill builds a whole ring (empty slots
    -1) and the insert copies every leaf, ``slot_pos`` included."""
    _, _, _, tm, tp, _ = models()
    eng = ServingEngine(tm.cfg, tp, ServeConfig(max_seq_len=64, max_batch=1,
                                                decode_chunk=4),
                        device="cpu")
    rng = np.random.default_rng(4)
    rs = [Request(rid=i, prompt=rng.integers(0, 256, L).astype(np.int32),
                  max_new_tokens=2) for i, L in enumerate((30, 5))]
    eng.generate(rs)
    sp = eng._cache[0]["slot_pos"][0].tolist()
    assert sorted(p for p in sp if p >= 0) == list(range(6))
    assert sp.count(-1) == 16 - 6


@pytest.mark.parametrize("sc_kw", [
    dict(paged=True, page_size=4, max_seq_len=64),
    dict(paged=True, page_size=4, max_seq_len=64, chunked_prefill=True,
         prefill_chunk=8)], ids=["paged", "paged-chunked"])
def test_paged_window_raises_like_the_reference(sc_kw):
    jm, jp, _, tm, tp, _ = models()
    with pytest.raises(NotImplementedError, match="sliding window"):
        JaxEngine(jm.cfg, jp, JaxServe(**sc_kw))
    with pytest.raises(NotImplementedError, match="sliding window"):
        ServingEngine(tm.cfg, tp, ServeConfig(**sc_kw), device="cpu")


def test_paged_cache_and_chunks_refuse_a_window():
    _, _, _, tm, tp, _ = models()
    with pytest.raises(NotImplementedError, match="sliding window"):
        tm.init_paged_cache(8, 4)
    dense = torch_model(dataclasses.replace(tm.cfg, sliding_window=0),
                        "cpu")
    pcache = dense.init_paged_cache(8, 4)
    with pytest.raises(NotImplementedError, match="sliding window"):
        tm.prefill_chunk(tp, pcache, np.zeros((1, 4), np.int64), 0,
                         np.ones((1, 4), bool),
                         block_table=torch.ones((1, 2), dtype=torch.int32))


def test_cli_serves_danube(capsys):
    cli.main(["--arch", ARCH, "--reduced", "--method", "kqsvd",
              "--requests", "4", "--prompt-len", "24",
              "--max-new-tokens", "5", "--decode-chunk", "4",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req ") == 4 and "capacity gain" in out
    assert "failed" not in out
