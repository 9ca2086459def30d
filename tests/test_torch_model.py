"""The port's LM against the reference's on bridged weights: prefill and
decode logits with the full and the KQ-SVD-compressed cache, lock-step
and with per-sequence positions, within 2e-4 (the bar of
test_models_smoke.py and test_compression_e2e.py); query-head padding,
parameter counts, one train step per carried arch, and the device-side
calibration step against the host path."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CompressionConfig
from repro.configs import get_config as jax_config
from repro.core.calibration import GramAccumulator
from repro.models import build_model as jax_model
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.models import build_model as torch_model


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-4, atol=2e-4)
# reduced: m=2, m=1, m=2 with tied embeddings, m=2 at deepseek's shape;
# the hybrid (SSM layers around two attention layers, MoE) and the two
# stubs served on tokens (m=1)
ARCHS = ["tinyllama-1.1b", "paper-llama2-7b", "smollm-360m", "deepseek-67b",
         "jamba-1.5-large-398b", "musicgen-large", "phi-3-vision-4.2b"]


@functools.lru_cache(maxsize=None)
def pair(arch):
    """Reference model + params + projections, and the port's twins."""
    jcfg = jax_config(arch).reduced()
    tcfg = torch_config(arch).reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    acc = GramAccumulator(len(jm.attn_layers))
    rng = np.random.default_rng(5)
    for _ in range(2):
        toks = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
        acc.update_from_captures([jax.tree.map(np.asarray, c)
                                  for c in jm.calibrate(jp, toks)])
    mp = acc.solve(CompressionConfig(method="kqsvd", epsilon=0.1),
                   jm.group_output_weights(jp))
    tm = torch_model(tcfg, "cpu")
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return (jm, jp, jm.projections_pytree(mp, jnp.float32),
            tm, tp, tm.projections_pytree(bridge.projections_from_jax(mp)),
            mp)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match(arch, compressed):
    jm, jp, jproj, tm, tp, tproj, _ = pair(arch)
    if not compressed:
        jproj = tproj = None
    B, S, extra = 2, 16, 4
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (B, S + extra)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": toks[:, :S]}, S + extra, proj=jproj)
    tl, tc = tm.prefill(tp, {"tokens": toks[:, :S]}, S + extra, proj=tproj)
    assert tl.dtype == torch.float32 and tl.shape == (B, 1, jm.cfg.vocab_size)
    _close(tl, jl)
    for t in range(extra):
        tok = toks[:, S + t: S + t + 1]
        jl, jc = jm.decode_step(jp, jc, tok, jnp.int32(S + t), proj=jproj)
        tl, tc = tm.decode_step(tp, tc, tok, S + t, proj=tproj)
        _close(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_varlen_compressed_decode_matches(arch):
    """Per-sequence positions over one batched compressed cache (slots
    prefilled one by one, as the engine inserts them)."""
    from test_attention import merge_slot_caches
    jm, jp, jproj, tm, tp, tproj, _ = pair(arch)
    lens, extra = (6, 13, 9), 3
    B, T = len(lens), max(lens) + extra + 2
    toks = np.random.default_rng(2).integers(
        0, jm.cfg.vocab_size, (B, max(lens) + extra)).astype(np.int32)
    jcs, tcs = [], []
    for b, L in enumerate(lens):
        jcs.append(jm.prefill(jp, {"tokens": toks[b: b + 1, :L]}, T,
                              proj=jproj)[1])
        tcs.append(tm.prefill(tp, toks[b: b + 1, :L], T, proj=tproj)[1])
    jc = merge_slot_caches(jcs)
    tc = [{k: torch.cat([c[i][k] for c in tcs]) for k in tcs[0][i]}
          for i in range(len(tcs[0]))]
    pos = np.asarray(lens, np.int32)
    for t in range(extra):
        feed = np.stack([toks[b, lens[b] + t] for b in range(B)])[:, None]
        jl, jc = jm.decode_step(jp, jc, feed, jnp.asarray(pos + t),
                                proj=jproj)
        tl, tc = tm.decode_step(tp, tc, feed, pos + t, proj=tproj)
        _close(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_group_output_weights_match(arch):
    jm, jp, _, tm, tp, _, _ = pair(arch)
    for a, b in zip(tm.group_output_weights(tp), jm.group_output_weights(jp)):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)


def test_entry_point_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_model(torch_config("tinyllama-1.1b").reduced())


def test_unported_families_raise():
    """Every family builds now; what the reference refuses the port
    refuses too: a hybrid stack (SSM layers beside its attention layers)
    refuses the paged cache, and a sliding window (served on dense slots
    since its ring cache was ported) still raises for the paged cache,
    as in the reference."""
    hyb = torch_model(torch_config("jamba-1.5-large-398b").reduced(), "cpu")
    with pytest.raises(NotImplementedError, match="plain attention"):
        hyb.init_paged_cache(4, 4)
    cfg = torch_config("tinyllama-1.1b").reduced()
    m = torch_model(dataclasses.replace(cfg, sliding_window=8), "cpu")
    assert m.init_cache(1, 16)[0]["slot_pos"].shape == (1, 8)
    with pytest.raises(NotImplementedError):
        m.init_paged_cache(4, 4)


def test_compressed_cache_ops_match_reference():
    """compress_kv / compress_queries / cache_footprint of the port ==
    the reference's ``repro.core.compressed``."""
    from repro.core import compressed as jc
    from repro_torch.core import compressed as tc
    rng = np.random.default_rng(3)
    k, v = (rng.normal(size=(2, 2, 5, 8)).astype(np.float32)
            for _ in range(2))
    q = rng.normal(size=(2, 4, 5, 8)).astype(np.float32)
    a_k, a_v, b_q = (rng.normal(size=(2, 8, r)).astype(np.float32)
                     for r in (3, 4, 3))
    for got, want in zip(
            tc.compress_kv(*map(torch.as_tensor, (k, v, a_k, a_v))),
            jc.compress_kv(*map(jnp.asarray, (k, v, a_k, a_v)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tc.compress_queries(torch.as_tensor(q), torch.as_tensor(b_q)).numpy(),
        np.asarray(jc.compress_queries(jnp.asarray(q), jnp.asarray(b_q))),
        **TOL)
    mine, ref = tc.cache_footprint(4, 64, 50, 42), jc.cache_footprint(
        4, 64, 50, 42)
    assert (mine.full_bytes, mine.compressed_bytes, mine.ratio) == (
        ref.full_bytes, ref.compressed_bytes, ref.ratio)


def test_qhead_padding_exact():
    """qhead_pad: the padded model == the unpadded one (same weights, pad
    query heads zero), in the training logits, and the pad heads'
    weights get zero gradients (reference test_attention.py:71)."""
    from repro_torch.train.steps import value_and_grad
    cfg = torch_config("tinyllama-1.1b").reduced()     # H=4, Hkv=2, m=2
    cfg_p = dataclasses.replace(cfg, qhead_pad=8)      # m_p = 4
    m0, mp = torch_model(cfg, "cpu"), torch_model(cfg_p, "cpu")
    p0 = m0.init(torch.Generator().manual_seed(0))
    pp = mp.init(torch.Generator().manual_seed(1))
    Hkv, m, m_p = cfg.n_kv_heads, 2, 4
    for lp, l0 in zip(pp["layers"], p0["layers"]):
        a, a0 = lp["attn"], l0["attn"]
        a["wq"] = torch.zeros_like(a["wq"])
        a["wo"] = torch.zeros_like(a["wo"])
        for g in range(Hkv):
            for j in range(m):
                a["wq"][:, g * m_p + j] = a0["wq"][:, g * m + j]
                a["wo"][g * m_p + j] = a0["wo"][g * m + j]
        a["wk"], a["wv"] = a0["wk"], a0["wv"]
        for k in ("ln1", "ln2", "ffn"):
            lp[k] = l0[k]
    for k in ("embed", "final_norm", "lm_head"):
        if k in p0:
            pp[k] = p0[k]
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))
    l0_, _ = m0.train_logits(p0, {"tokens": toks})
    lp_, _ = mp.train_logits(pp, {"tokens": toks})
    np.testing.assert_allclose(lp_.detach().numpy(), l0_.detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    from repro_torch.config import TrainConfig
    from repro_torch.train.steps import make_loss_fn
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    _, g = value_and_grad(make_loss_fn(mp, TrainConfig()), pp, batch)
    pad = torch.as_tensor([h % m_p >= m for h in range(Hkv * m_p)])
    for lg in g["layers"]:
        assert not lg["attn"]["wq"][:, pad].any()
        assert not lg["attn"]["wo"][pad].any()


def test_param_counts_match_assignment():
    """Every carried arch: the port's config count equals the
    reference's, within 15% of the assignment's size, and equals the
    elements of the port's init at full width (shapes only, under
    FakeTensorMode), but for the SSM layers of mamba2-2.7b and
    jamba-1.5-large-398b, where the config's formula leaves out the D
    skip (and counts a second norm gain that a pure SSM layer without an
    FFN lacks), and for arctic-480b, where it counts the 56 real query
    heads and the init holds the 64 padded ones.  The port's registry is
    the reference's plus paper-llama2-7b."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import list_archs
    from repro_torch.tree import leaves
    from repro.configs import list_archs as jax_list_archs
    expected = {"mamba2-2.7b": 2.7e9, "deepseek-67b": 67e9,
                "tinyllama-1.1b": 1.1e9, "smollm-360m": 0.36e9,
                "h2o-danube-1.8b": 1.8e9, "paper-llama2-7b": 6.7e9,
                "deepseek-v2-lite-16b": 16e9, "arctic-480b": 480e9,
                "jamba-1.5-large-398b": 398e9, "musicgen-large": 3.3e9,
                "phi-3-vision-4.2b": 4.2e9}
    assert set(list_archs()) == set(expected) \
        == set(jax_list_archs()) | {"paper-llama2-7b"}
    for arch, target in expected.items():
        cfg = torch_config(arch)
        n = cfg.param_count()
        assert n == jax_config(arch).param_count(), arch
        assert abs(n - target) / target < 0.15, (arch, n, target)
        with FakeTensorMode():
            p = torch_model(cfg, "cpu").init(torch.Generator())
            n_init = sum(x.numel() for _, x in leaves(p))
        if cfg.ssm is not None:
            n_ssm = cfg.layer_kinds().count("ssm")
            n_init -= n_ssm * cfg.ssm.n_heads(cfg.d_model)    # D skip
            if cfg.d_ff == 0 and cfg.moe is None:           # no 2nd norm
                n_init += n_ssm * cfg.d_model
        if cfg.qhead_pad:       # zero pad heads' wq and wo
            n_init -= cfg.n_layers * 2 * cfg.d_model * cfg.d_head * (
                cfg.qhead_pad - cfg.n_heads)
        assert n_init == n, (arch, n_init, n)


@pytest.mark.parametrize("arch", ARCHS + ["h2o-danube-1.8b", "mamba2-2.7b",
                                  "deepseek-v2-lite-16b", "arctic-480b"])
def test_one_train_step(arch):
    """One train step per carried arch (reference
    test_models_smoke.py::test_one_train_step): finite loss and gradient
    norm, and the params moved."""
    from repro_torch import optim
    from repro_torch.config import TrainConfig
    from repro_torch.train.steps import make_train_step
    cfg = torch_config(arch).reduced()
    model = torch_model(cfg, "cpu")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                     checkpoint_every=0)
    params = model.init(torch.Generator().manual_seed(0))
    B, S = 2, 32
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    batch = {"tokens": toks, "labels": np.zeros((B, S), np.int32)}
    params2, _, metrics = make_train_step(model, tc)(
        params, optim.init_state(params, tc), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    from repro_torch.tree import leaves
    delta = sum(float((a.float() - b.float()).abs().max())
                for (_, a), (_, b) in zip(leaves(params), leaves(params2)))
    assert delta > 0


def test_device_calibrate_step_matches_host():
    """make_calibrate_step's float32 Grams summed from captures that stay
    on the device == the host GramAccumulator path (float64), at the
    reference test's tolerances (tests/test_calibration.py:72)."""
    from repro_torch.core.calibration import GramAccumulator as Acc
    from repro_torch.core.calibration import (accumulator_from_grams,
                                              make_calibrate_step)
    cfg = torch_config("tinyllama-1.1b").reduced()
    model = torch_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    init_grams, step = make_calibrate_step(model)
    grams = init_grams(cfg.d_head, cfg.d_head, cfg.n_kv_heads)
    host = Acc(len(model.attn_layers))
    rng = np.random.default_rng(40)
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (2, 32))
        grams = step(params, grams, toks)
        host.update_from_captures(model.calibrate(params, toks))
    assert grams["g_k"].dtype == torch.float32
    dev = accumulator_from_grams(grams)
    for l in range(len(model.attn_layers)):
        for name in ("g_k", "g_q", "g_v"):
            np.testing.assert_allclose(getattr(dev.layers[l], name),
                                       getattr(host.layers[l], name),
                                       rtol=2e-4, atol=2e-3)
    assert dev.layers[0].tokens == host.layers[0].tokens == 3 * 2 * 32


@pytest.mark.parametrize("causal,window,block", [
    (True, 0, 8), (True, 5, 8), (False, 0, 16), (False, 7, 8),
    (True, 0, 12)])                   # 12 does not divide S: one block
def test_reference_and_blockwise_attention_match(causal, window, block):
    """The port's plain ``reference_attention`` and ``blockwise_attention``
    against the reference's on the same arrays (GQA m = 3), and against
    each other."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(block + window)
    q = rng.normal(size=(2, 6, 32, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 32, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    ref = tattn.reference_attention(*map(torch.as_tensor, (q, k, v)), **kw)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jattn.reference_attention(q, k, v, **kw)),
        **TOL)
    blk = tattn.blockwise_attention(*map(torch.as_tensor, (q, k, v)),
                                    block_q=block, **kw)
    jblk = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                     block_q=block, block_k=block, **kw)
    np.testing.assert_allclose(blk.numpy(), np.asarray(jblk), **TOL)
    np.testing.assert_allclose(blk.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
