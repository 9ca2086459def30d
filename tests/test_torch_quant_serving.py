"""The port's engine with split-KV decode and quantized caches against the
reference's (greedy, reduced tinyllama-1.1b, float32, bridged weights and
projections, reserve admission): the same out_tokens, ``capacity_x`` and
physical pool size on paged int8 pages (chunked with per-chunk dynamic
splits, and exact-length), SVDq pages with 3 splits, fp pages with 3
splits and the dense int8 cache; the split counts that dynamic mode
derives; ``ServeConfig``'s refusals; and the CLI with both flags.

The reference engine runs with ``use_pallas=True`` (its Pallas kernels in
interpret mode), the route whose arithmetic the port's kernels follow:
over int8 pages its lax twin instead rounds the value product to bf16,
which flips a near-tie greedy token of the int8 engine with dynamic
splits (ROADMAP.md queue 3)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest

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
from repro_torch.launch import serve as cli
from repro_torch.serving import Request, ServingEngine


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


def _prompts(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, L).astype(np.int32) for L in lens]


PAGED = dict(max_seq_len=64, max_batch=3, temperature=0.0, decode_chunk=4,
             paged=True, page_size=4, n_pages=24)
CHUNKED = dict(PAGED, chunked_prefill=True, prefill_chunk=8)
ENGINES = {
    "int8-chunked-dynamic": (dict(CHUNKED, cache_quant="int8",
                                  decode_splits=0), {}),
    "int8-exact": (dict(PAGED, cache_quant="int8"), {}),
    "svdq-splits3": (dict(CHUNKED, cache_quant="svdq", decode_splits=3), {}),
    "fp-splits3": (dict(CHUNKED, decode_splits=3), {}),
    "dense-int8": (dict(max_seq_len=64, max_batch=3, temperature=0.0,
                        decode_chunk=4), {"cache_quant": "int8"}),
}


@pytest.mark.parametrize("kind", list(ENGINES))
def test_engine_matches_reference(kind):
    """Identical greedy tokens, truncation, capacity multiplier, physical
    pool and peak pages; every drain returns the whole pool.  Prompts of
    1..40 tokens over 5 requests for 3 slots refill slots, cross pages,
    and (to 40 + 12 tokens, 13 pages) make dynamic mode pick 2 splits."""
    sc_kw, cfg_kw = ENGINES[kind]
    jcfg, jp, tcfg, tp, jmp, tmp = models()
    jcfg = dataclasses.replace(jcfg, use_pallas=True, **cfg_kw)
    tcfg = dataclasses.replace(tcfg, **cfg_kw)
    jeng = JaxEngine(jcfg, jp, JaxServe(**sc_kw), projections=jmp)
    teng = ServingEngine(tcfg, tp, ServeConfig(**sc_kw), projections=tmp,
                         device="cpu")
    prompts = _prompts(23, [9, 40, 1, 17, 30])
    jr = [JaxRequest(rid=i, prompt=p, max_new_tokens=12)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p, max_new_tokens=12)
          for i, p in enumerate(prompts)]
    jeng.generate(jr)
    teng.generate(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert [r.truncated for r in tr] == [r.truncated for r in jr]
    assert all(r.done and not r.failed for r in tr)
    assert teng.capacity_x == jeng.capacity_x
    assert teng.cfg.cache_quant == jeng.cfg.cache_quant
    if teng.pool is not None:
        assert teng.pool.n_pages == jeng.pool.n_pages
        assert teng.peak_used_pages == jeng.peak_used_pages
        for eng in (jeng, teng):
            assert eng.pool.free_count == eng.pool.n_pages
    quant = sc_kw.get("cache_quant", "none")
    assert (teng.capacity_x > 1.0) == (quant != "none")


def test_dynamic_splits_match_reference():
    """``decode_splits=0`` derives the same split count as the reference
    at every live length, snapped to {1, 2, 4, 8} and monotone."""
    jcfg, jp, tcfg, tp, _, _ = models()
    kw = dict(max_seq_len=512, max_batch=2, paged=True, page_size=4,
              chunked_prefill=True, prefill_chunk=8, decode_splits=0)
    jeng = JaxEngine(jcfg, jp, JaxServe(**kw))
    teng = ServingEngine(tcfg, tp, ServeConfig(**kw), device="cpu")
    seen = [teng._splits_for_step(n) for n in range(1, 600, 7)]
    assert seen == [jeng._splits_for_step(n) for n in range(1, 600, 7)]
    assert set(seen) == {1, 2, 4, 8} and seen == sorted(seen)


@pytest.mark.parametrize("kw", [
    dict(decode_splits=-1), dict(decode_splits=2),
    dict(cache_quant="fp8"), dict(cache_quant="int8"),
    dict(paged=True, cache_quant="svdq"),
], ids=["negative-splits", "splits-unpaged", "unknown-quant",
        "quant-unpaged", "svdq-exact"])
def test_serve_config_refuses_like_reference(kw):
    with pytest.raises(ValueError) as want:
        JaxServe(**kw)
    with pytest.raises(ValueError) as got:
        ServeConfig(**kw)
    assert str(got.value) == str(want.value)


def test_paged_engine_refuses_model_config_quant_alone():
    _, _, tcfg, tp, _, tmp = models()
    with pytest.raises(NotImplementedError, match="ServeConfig.cache_quant"):
        ServingEngine(dataclasses.replace(tcfg, cache_quant="int8"), tp,
                      ServeConfig(**PAGED), projections=tmp, device="cpu")


def test_cli_serves_int8_pages_with_dynamic_splits(capsys):
    cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--paged",
              "--prefill-chunk", "8", "--cache-quant", "int8",
              "--decode-splits", "0", "--requests", "3",
              "--max-new-tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "free after the drain" in out
    assert "cache quant int8:" in out and "resident capacity" in out


def test_cli_refuses_svdq_without_chunked_prefill(capsys):
    with pytest.raises(SystemExit):
        cli.parse_args(["--arch", "tinyllama-1.1b", "--cache-quant", "svdq"])
    assert "packs sub-byte ranks at page-write time" in \
        capsys.readouterr().err


def test_cli_quant_and_splits_turn_on_paging():
    for flags in (["--cache-quant", "int8"], ["--decode-splits", "3"]):
        args = cli.parse_args(["--arch", "tinyllama-1.1b", *flags])
        assert args.paged
