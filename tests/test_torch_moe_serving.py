"""The port's engines against the reference's on the MoE and MLA families
(greedy, float32, bridged weights and projections): identical
out_tokens on reduced deepseek-v2-lite-16b (MLA + MoE) on dense slots,
with the config's own capacity and dropless, with the full latent cache
and KQ-SVD; and on reduced arctic-480b (MoE beside a dense residual) on
pages: fp pages with chunked prefill, int8 pages with per-chunk dynamic
splits, and the token budget, whose truncated chunks reach MoE routing
as a count of real tokens.  The decode's live-slot mask and a chunk's
real tokens keep dead slots and padding out of expert capacity in both.

The reference engine runs with ``use_pallas=True`` on int8 pages (its
Pallas kernels in interpret mode), the route whose arithmetic the port's
K5 follows (ROADMAP.md queue 3)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from conftest import dropless
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


# a router whose capacity binds in decode at reduced width: 32 experts,
# top 2, so C = ceil(2 * 3 * 4 / 32) = 1 slot an expert for 3 slots


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BINDING = (("n_experts", 32), ("top_k", 2))


def _moe(cfg, moe_kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, **dict(moe_kw))) if moe_kw else cfg


@functools.lru_cache(maxsize=None)
def models(arch, moe_kw=()):
    """(reference config, params, projections; port config, params,
    projections) on the reduced config, its MoE fields set from
    ``moe_kw``."""
    jcfg = _moe(jax_config(arch).reduced(), moe_kw)
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
    return (jcfg, jp, mp, _moe(torch_config(arch).reduced(), moe_kw), tp,
            bridge.projections_from_jax(mp))


def _prompts(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, L).astype(np.int32) for L in lens]


def serve_both(arch, sc_kw, prompts, max_new, compressed=True,
               drop_free=False, use_pallas=False, moe_kw=()):
    """Serve the same requests on both engines: (reference engine, its
    requests, port engine, its requests)."""
    jcfg, jp, jmp, tcfg, tp, tmp = models(arch, moe_kw)
    if drop_free:
        jcfg, tcfg = dropless(jcfg), dropless(tcfg)
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    jeng = JaxEngine(jcfg, jp, JaxServe(**sc_kw),
                     projections=jmp if compressed else None)
    teng = ServingEngine(tcfg, tp, ServeConfig(**sc_kw),
                         projections=tmp if compressed else None,
                         device="cpu")
    jr = [JaxRequest(rid=i, prompt=p, max_new_tokens=max_new)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p, max_new_tokens=max_new)
          for i, p in enumerate(prompts)]
    jeng.generate(jr)
    teng.generate(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert [r.truncated for r in tr] == [r.truncated for r in jr]
    assert all(r.done and not r.failed for r in tr)
    return jeng, jr, teng, tr


DENSE = dict(max_seq_len=48, max_batch=3, temperature=0.0, decode_chunk=4)


@pytest.mark.parametrize("capacity", ["config", "dropless", "binding"])
@pytest.mark.parametrize("compressed", [False, True])
def test_deepseek_v2_lite_dense_slots_match_reference(compressed, capacity):
    """MLA caches on dense slots (inserted, freed and refilled: 5 requests
    on 3 slots), the latent full or KQ-SVD-compressed; MoE with the
    config's own capacity (decode C = min(ceil(2 * 3 * 4 / 4), 3) = 3 for
    3 slots: nothing drops), dropless, and with a router whose capacity
    binds (``BINDING``), where a finished slot left in the routing would
    take a live one's expert slot."""
    prompts = _prompts(3, [9, 17, 4, 12, 25])
    jeng, _, teng, tr = serve_both(
        "deepseek-v2-lite-16b", DENSE, prompts, 8, compressed,
        capacity == "dropless",
        moe_kw=BINDING if capacity == "binding" else ())
    assert all(len(r.out_tokens) == 8 for r in tr)
    assert teng.capacity_gain() == jeng.capacity_gain()
    layer = teng._cache[1]
    assert set(layer) == ({"cc", "ccv", "kr"} if compressed else {"c", "kr"})
    assert layer["kr"].shape == (3, 48, teng.cfg.mla.qk_rope_dim)


PAGED = dict(max_seq_len=64, max_batch=3, temperature=0.0, decode_chunk=4,
             paged=True, page_size=4, n_pages=24, chunked_prefill=True,
             prefill_chunk=8)


@pytest.mark.parametrize("kind,sc_kw", [
    ("fp", PAGED),
    ("int8-dynamic-splits", dict(PAGED, cache_quant="int8",
                                 decode_splits=0)),
    ("budget", dict(PAGED, max_num_batched_tokens=6)),
    ("budget-binding", dict(PAGED, max_num_batched_tokens=6)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_arctic_pages_match_reference(kind, sc_kw):
    """arctic on pages (page size 4, chunks of 8): identical tokens, peak
    pages and the whole pool back after the drain; the budget engine
    truncates chunks and fuses them with the decode chunk, as the
    reference does (``budget-binding``: with ``BINDING``'s router, so
    the padding of a truncated chunk would take expert slots if its
    count did not mask it)."""
    prompts = _prompts(23, [9, 40, 1, 17, 30])
    jeng, _, teng, _ = serve_both(
        "arctic-480b", sc_kw, prompts, 10, use_pallas=kind.startswith("int8"),
        moe_kw=BINDING if kind.endswith("binding") else ())
    assert teng.peak_used_pages == jeng.peak_used_pages
    for eng in (jeng, teng):
        assert eng.pool.free_count == eng.pool.n_pages
    if kind.startswith("budget"):
        assert teng.n_truncated_chunks == jeng.n_truncated_chunks > 0
        assert teng.n_fused_steps == jeng.n_fused_steps > 0
        assert teng.budget_log == jeng.budget_log


def test_mla_stack_refuses_pages():
    """MLA caches live on dense slots only: the paged engine refuses the
    stack at construction, as the reference does."""
    _, _, _, tcfg, tp, tmp = models("deepseek-v2-lite-16b")
    with pytest.raises(NotImplementedError, match="plain attention"):
        ServingEngine(tcfg, tp, ServeConfig(**PAGED), projections=tmp,
                      device="cpu")
