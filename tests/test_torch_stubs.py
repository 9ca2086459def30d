"""The audio and VLM stub frontends: the port against the reference on
reduced musicgen-large (frame embeddings in place of tokens) and
phi-3-vision-4.2b (4 patch embeddings ahead of the text), float32,
bridged weights.  ``LM._embed``'s three inputs reach training logits,
a train step (labels -100 over the patches), calibration (captures over
the patch positions, host and device Grams), prefill with an image
prefix and token decode after it (full and KQ-SVD), and the engines
serve both archs on token prompts as the reference's do, on dense slots
and on pages."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CompressionConfig as JaxCompression
from repro.config import ServeConfig as JaxServe
from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_config
from repro.core.calibration import GramAccumulator
from repro.models import build_model as jax_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.train.steps import make_loss_fn as jax_loss_fn
from repro_torch import bridge
from repro_torch.config import ServeConfig, TrainConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.core.calibration import (accumulator_from_grams,
                                          make_calibrate_step)
from repro_torch.data import stub_batch
from repro_torch.models import build_model as torch_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.train.steps import make_loss_fn, value_and_grad
from test_torch_train import close_grads


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["musicgen-large", "phi-3-vision-4.2b"]
TOL = dict(rtol=2e-4, atol=2e-4)
FN_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
          checkpoint_every=0)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def pair(arch):
    """Reference model, params (numpy) and projections calibrated on the
    stub frontend's batches, the port's twins."""
    jcfg, tcfg = jax_config(arch).reduced(), torch_config(arch).reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jm = jax_model(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    acc = GramAccumulator(len(jm.attn_layers))
    calibrate = jax.jit(jm.calibrate)
    for i in range(2):
        caps = calibrate(jp, _jnp(stub_batch(jcfg, 2, 32, seed=5 + i)))
        acc.update_from_captures([jax.tree.map(np.asarray, c)
                                  for c in caps])
    mp = acc.solve(JaxCompression(method="kqsvd", epsilon=0.1),
                   jm.group_output_weights(jp))
    tm = torch_model(tcfg, "cpu")
    return (jm, jp, mp, jm.projections_pytree(mp, jnp.float32), tm,
            bridge.params_from_jax(jp), bridge.projections_from_jax(mp))


def _close(t, j, tol=FN_TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def test_stub_batch_inputs():
    """The stub frontend's seeded batch: musicgen's frame embeddings in
    place of tokens, phi-3-vision's tokens with patch embeddings, at the
    0.1 scale; the same seed gives the same batch."""
    m = stub_batch(torch_config("musicgen-large").reduced(), 2, 8, seed=3)
    v = stub_batch(torch_config("phi-3-vision-4.2b").reduced(), 2, 8, seed=3)
    assert set(m) == {"embeds"} and m["embeds"].shape == (2, 8, 64)
    assert set(v) == {"tokens", "image_embeds"}
    assert v["tokens"].shape == (2, 8) and v["image_embeds"].shape == (2, 4,
                                                                       64)
    assert m["embeds"].dtype == v["image_embeds"].dtype == np.float32
    assert 0.05 < float(m["embeds"].std()) < 0.15
    np.testing.assert_array_equal(
        stub_batch(torch_config("musicgen-large").reduced(), 2, 8,
                   seed=3)["embeds"], m["embeds"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_reference(arch):
    """Training logits from ``embeds`` (musicgen) and from tokens behind
    ``image_embeds`` (phi-3-vision, (B, S + P, V)): finite and equal to
    the reference's at 1e-5."""
    jm, jp, _, _, tm, tp, _ = pair(arch)
    b = stub_batch(tm.cfg, 2, 32, seed=1)
    tl, _ = tm.train_logits(tp, b)
    jl, _ = jax.jit(jm.train_logits)(jp, _jnp(b))
    P = tm.cfg.num_patch_tokens
    assert tl.shape == (2, 32 + P, tm.cfg.vocab_size)
    assert torch.isfinite(tl).all()
    _close(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_with_patch_labels_matches_reference(arch):
    """A train step whose labels are -100 over the patches (ignored by
    the loss, as test_models_smoke.py sets them): the loss, its token
    count and every gradient leaf equal the reference's; the patch
    positions count no token."""
    jm, jp, _, _, tm, tp, _ = pair(arch)
    tc, jtc = TrainConfig(**TC), JaxTrainConfig(**TC)
    b = stub_batch(tm.cfg, 2, 32, seed=2)
    P = tm.cfg.num_patch_tokens
    labels = np.random.default_rng(4).integers(
        0, tm.cfg.vocab_size, (2, 32 + P)).astype(np.int32)
    labels[:, :P] = -100
    b["labels"] = labels
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        jax_loss_fn(jm, jtc), has_aux=True))(jp, _jnp(b))
    met, tg = value_and_grad(make_loss_fn(tm, tc), tp, b)
    np.testing.assert_allclose(float(met["loss"]), float(jloss),
                               rtol=LOSS_RTOL)
    assert float(met["tokens"]) == float(jmet["tokens"]) == 2 * 32
    close_grads(tg, jg)


@pytest.mark.parametrize("arch", ARCHS)
def test_calibrate_covers_the_patches(arch):
    """Calibration captures span every position of the batch (P + S for
    phi-3-vision) and equal the reference's; the device Grams
    (``make_calibrate_step`` on a stub batch) count those positions and
    equal the host path's."""
    jm, jp, _, _, tm, tp, _ = pair(arch)
    b = stub_batch(tm.cfg, 2, 16, seed=6)
    P = tm.cfg.num_patch_tokens
    caps = tm.calibrate(tp, b)
    jcaps = jax.jit(jm.calibrate)(jp, _jnp(b))
    assert len(caps) == len(jcaps) == tm.cfg.n_layers
    for c, jc in zip(caps, jcaps):
        for name in ("k", "q", "v"):
            assert c[name].shape[2] == P + 16
            np.testing.assert_allclose(c[name], np.asarray(jc[name]),
                                       **FN_TOL)
    init_grams, step = make_calibrate_step(tm)
    cfg = tm.cfg
    grams = step(tp, init_grams(cfg.d_head, cfg.d_head, cfg.n_kv_heads), b)
    assert float(grams["tokens"]) == 2 * (P + 16)
    host = GramAccumulator(len(caps))
    host.update_from_captures(caps)
    dev = accumulator_from_grams(grams)
    for a, h in zip(dev.layers, host.layers):
        assert a.tokens == h.tokens
        for name in ("g_k", "g_q", "g_v"):
            np.testing.assert_allclose(getattr(a, name), getattr(h, name),
                                       rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_prefill_then_decode_matches_reference(arch, compressed):
    """Prefill from the stub frontend's input (musicgen's embeddings,
    phi-3-vision's patches ahead of its text), then token decode after
    it: the cache covers the P + S positions and every logit equals the
    reference's at 1e-5, with the full and the KQ-SVD cache."""
    jm, jp, _, jproj, tm, tp, tmp = pair(arch)
    tproj = tm.projections_pytree(tmp)
    if not compressed:
        jproj = tproj = None
    B, S, extra = 2, 12, 4
    P = tm.cfg.num_patch_tokens
    T = P + S + extra
    b = stub_batch(tm.cfg, B, S, seed=7)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(jp, _jnp(b), T, jproj)
    tl, tc = tm.prefill(tp, b, T, proj=tproj)
    assert tl.shape == (B, 1, tm.cfg.vocab_size)
    _close(tl, jl)
    name = "kc" if compressed else "k"
    assert tc[0][name].shape[2] == T
    jdecode = jax.jit(jm.decode_step)
    toks = np.random.default_rng(8).integers(
        0, tm.cfg.vocab_size, (B, extra)).astype(np.int32)
    for t in range(extra):
        jl, jc = jdecode(jp, jc, toks[:, t:t + 1], jnp.int32(P + S + t),
                         jproj)
        tl, tc = tm.decode_step(tp, tc, toks[:, t:t + 1], P + S + t,
                                proj=tproj)
        _close(tl, jl)


DENSE = dict(max_seq_len=48, max_batch=3, temperature=0.0, decode_chunk=4)
PAGED = dict(max_seq_len=64, max_batch=3, temperature=0.0, decode_chunk=4,
             paged=True, page_size=4, n_pages=24, chunked_prefill=True,
             prefill_chunk=8)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch, layout):
    """Both stubs served on token prompts with KQ-SVD, as the reference
    engine serves them: 5 requests on 3 slots, dense (slots refilled) or
    on pages with chunked prefill (the pool whole after the drain), give
    the reference engine's greedy tokens."""
    _, jp, mp, _, tm, tp, tmp = pair(arch)
    sc = DENSE if layout == "dense" else PAGED
    prompts = [np.random.default_rng(11 + i).integers(
        0, tm.cfg.vocab_size, L).astype(np.int32)
        for i, L in enumerate([9, 17, 4, 12, 25])]
    jeng = JaxEngine(jax_config(arch).reduced(), jp, JaxServe(**sc),
                     projections=mp)
    teng = ServingEngine(tm.cfg, tp, ServeConfig(**sc), projections=tmp,
                         device="cpu")
    jr = [JaxRequest(rid=i, prompt=p, max_new_tokens=8)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p, max_new_tokens=8)
          for i, p in enumerate(prompts)]
    jeng.generate(jr)
    teng.generate(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and not r.failed and len(r.out_tokens) == 8
               for r in tr)
    if layout == "paged":
        assert teng.peak_used_pages == jeng.peak_used_pages
        assert teng.pool.free_count == teng.pool.n_pages
