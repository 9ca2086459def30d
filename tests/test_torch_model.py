"""The port's LM against the reference's on bridged weights: prefill and
decode logits with the full and the KQ-SVD-compressed cache, lock-step
and with per-sequence positions, within 2e-4 (the bar of
test_models_smoke.py and test_compression_e2e.py)."""
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

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["tinyllama-1.1b", "paper-llama2-7b"]     # reduced: m=2 and m=1


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
    """Families the port does not carry raise at construction; a sliding
    window (served on dense slots since its ring cache was ported) still
    raises for the paged cache, as in the reference."""
    cfg = torch_config("tinyllama-1.1b").reduced()
    with pytest.raises(NotImplementedError):
        torch_model(dataclasses.replace(cfg, family="moe"), "cpu")
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
