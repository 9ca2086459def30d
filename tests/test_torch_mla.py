"""The port's MLA (``repro_torch.models.mla``) against the reference's
``repro.models.mla`` on reduced deepseek-v2-lite-16b (float32, bridged
weights, the KQ-SVD projections the reference solved): ``mla_train``,
``mla_calibrate``, ``mla_prefill`` and ``mla_decode`` (per-sequence
positions, three steps, with and without projections), outputs and
cache leaves within 2e-4, the absorbed output weights within 1e-12; and the
counterpart of test_attention.py::test_varlen_decode_mla."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dropless
from repro.config import CompressionConfig
from repro.configs import get_config as jax_config
from repro.core.calibration import GramAccumulator
from repro.models import build_model as jax_model
from repro.models import mla as jmla
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.models import build_model as torch_model
from repro_torch.models import mla as tmla


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
ARCH = "deepseek-v2-lite-16b"


@functools.lru_cache(maxsize=None)
def pair():
    """Reference model, params and per-layer projections, the port's
    twins, and the config (reduced: 3 layers, kv_lora 32, nope 16, rope
    8, v 16, 4 heads)."""
    jcfg = jax_config(ARCH).reduced()
    tcfg = torch_config(ARCH).reduced()
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
    jproj = jm.projections_pytree(mp, jnp.float32)
    tproj = tm.projections_pytree(bridge.projections_from_jax(mp))
    return jcfg, jm, jp, jproj, tm, tp, tproj, mp


def _layer(layer=1):
    """Layer ``layer``'s MLA params in both packages and its projections
    (layer 0 is the dense prefix layer, 1 the first scan step)."""
    jcfg, jm, jp, jproj, tm, tp, tproj, _ = pair()
    ja = jm._layer_params(jp, layer)["attn"]
    jpj = (jproj["prefix"][0] if layer == 0 else
           jax.tree.map(lambda a: a[layer - 1], jproj["steps"]))
    return jcfg, ja, jpj, tp["layers"][layer]["attn"], tproj[layer]


def _h(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("layer", [0, 1])
def test_mla_train_matches(layer):
    cfg, ja, _, ta, _ = _layer(layer)
    h = _h((2, 12, cfg.d_model))
    _close(tmla.mla_train(ta, torch.as_tensor(h), cfg),
           jmla.mla_train(ja, jnp.asarray(h), cfg))


def test_mla_calibrate_matches():
    cfg, ja, _, ta, _ = _layer()
    h = _h((2, 12, cfg.d_model))
    ty, tcap = tmla.mla_calibrate(ta, torch.as_tensor(h), cfg)
    jy, jcap = jmla.mla_calibrate(ja, jnp.asarray(h), cfg)
    _close(ty, jy)
    assert set(tcap) == set(jcap)
    for k in jcap:
        assert tuple(tcap[k].shape) == jcap[k].shape
        _close(tcap[k], jcap[k])
    # the Hkv = 1 GQA form: m = H query heads over the latent
    assert tcap["k"].shape[1] == 1
    assert tcap["q"].shape[1] == cfg.n_heads


@pytest.mark.parametrize("compressed", [False, True])
def test_mla_prefill_and_decode_match(compressed):
    """Prefill, then three decode steps at per-sequence positions (two
    sequences prefilled to 10 tokens, decoding from 10 and 7), outputs
    and every cache leaf."""
    cfg, ja, jpj, ta, tpj = _layer()
    if not compressed:
        jpj = tpj = None
    B, S, T = 2, 10, 16
    h = _h((B, S, cfg.d_model))
    jy, jc = jmla.mla_prefill(ja, jnp.asarray(h), cfg, T, jpj)
    ty, tc = tmla.mla_prefill(ta, torch.as_tensor(h), cfg, T, tpj)
    _close(ty, jy)
    assert set(tc) == set(jc) == ({"cc", "ccv", "kr"} if compressed
                                  else {"c", "kr"})
    for k in jc:
        _close(tc[k], jc[k])
    pos = np.array([10, 7], np.int32)
    for t in range(3):
        x = _h((B, 1, cfg.d_model), seed=10 + t)
        jy, jc = jmla.mla_decode(ja, jnp.asarray(x), jc, jnp.asarray(pos + t),
                                 cfg, jpj)
        ty, tc = tmla.mla_decode(ta, torch.as_tensor(x), tc, pos + t, cfg,
                                 tpj)
        _close(ty, jy)
        for k in jc:
            _close(tc[k], jc[k])


def test_group_output_weights_match():
    """``mla_group_output_weights`` == the reference's, layer by layer and
    through ``LM.group_output_weights``: float64 products of float32
    weights, summed in another order (a batched matrix product against
    numpy's einsum), so within 1e-12 of the largest entry."""
    cfg, ja, _, ta, _ = _layer()
    a = tmla.mla_group_output_weights(ta, cfg)
    b = jmla.mla_group_output_weights(ja, cfg)
    assert a.dtype == np.float64 and a.shape == (1, 32, cfg.n_heads
                                                  * cfg.d_model)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(b).max())
    _, jm, jp, _, tm, tp, _, _ = pair()
    for x, y in zip(tm.group_output_weights(tp), jm.group_output_weights(jp)):
        assert x.shape == y.shape and x.dtype == np.float64
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=1e-12 * np.abs(y).max())


def test_varlen_decode_mla():
    """Counterpart of test_attention.py::test_varlen_decode_mla: batched
    decode at per-sequence positions over slots prefilled one by one (the
    engine's insert) == each sequence decoded alone, in the port (rtol
    1e-4), and == the reference's batched decode (2e-4); dropless MoE."""
    jcfg = dropless(jax_config(ARCH).reduced())
    tcfg = dropless(torch_config(ARCH).reduced())
    _, _, jp, _, _, tp, _, _ = pair()
    jm, tm = jax_model(jcfg), torch_model(tcfg, "cpu")
    lens, extra = (7, 13), 3
    B, T = len(lens), max(lens) + extra + 2
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, max(lens) + extra)).astype(np.int32)
    singles = [tm.prefill(tp, toks[b: b + 1, :L], T)[1]
               for b, L in enumerate(lens)]
    cache = [{k: torch.cat([s[i][k] for s in singles]) for k in singles[0][i]}
             for i in range(tcfg.n_layers)]
    singles = [[{k: v.clone() for k, v in layer.items()} for layer in s]
               for s in singles]
    from test_attention import merge_slot_caches
    jc = merge_slot_caches([jm.prefill(jp, {"tokens": toks[b: b + 1, :L]},
                                       T)[1] for b, L in enumerate(lens)])
    pos = np.asarray(lens, np.int32)
    for t in range(extra):
        feed = np.stack([toks[b, lens[b] + t] for b in range(B)])[:, None]
        lg, cache = tm.decode_step(tp, cache, feed, pos + t)
        jl, jc = jm.decode_step(jp, jc, feed, jnp.asarray(pos + t))
        _close(lg, jl)
        for b, L in enumerate(lens):
            lg1, singles[b] = tm.decode_step(tp, singles[b],
                                             feed[b: b + 1], L + t)
            np.testing.assert_allclose(lg[b].numpy(), lg1[0].numpy(),
                                       rtol=1e-4, atol=1e-4)
