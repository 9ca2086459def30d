"""The port's page layouts against the reference's on the same numpy
inputs: ``quantize_int8``, the nibble and crumb packers and every
layout's ``encode`` byte for byte (bf16 scales by their bits), ``decode``
value for value, the round-trip bound of tests/test_page_layouts.py, the
SVDq bit allocations, and the hardware-independent page bytes of
BENCH_decode.json.  On int8 pages the engine's copy-on-write fork copies
every leaf, scale pools too, byte for byte, and prefix sharing and swap
give the tokens of the engine without them and of the reference's; a
swap buffer corrupted in its data or its scale leaves fails its one crc
and the victim recomputes, with the same tokens."""
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
from repro.models import build_model as jax_model
from repro.serving import FaultInjector as JaxInjector
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import page_layouts as jl
from repro_torch import bridge
from repro_torch.config import ServeConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.serving import (FaultInjector, Request, ServingEngine,
                                 checksum)
from repro_torch.serving import page_layouts as tl


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    """Host bytes of a jax or torch array (bf16 as its uint16 bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a


def _inputs(seed, shape, amp=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * amp).astype(np.float32)
    v = x.reshape(-1, shape[-1])        # a view: the vectors quantized
    v[0] = 0.0                          # all zero: scale 1e-8 / 127
    v[1, :4] = [0.5, -1.5, 2.5, 127.0]  # scale 1: halfway codes, to even
    return x


@pytest.mark.parametrize("seed,amp", [(0, 1.0), (1, 1e-3), (2, 37.5),
                                      (3, 1e3)])
def test_quantize_int8_is_byte_identical(seed, amp):
    x = _inputs(seed, (3, 5, 11), amp)
    qj, sj = jl.quantize_int8(jnp.asarray(x))
    qt, st = tl.quantize_int8(torch.as_tensor(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(qt), _np(qj))
    np.testing.assert_array_equal(_np(st), _np(sj))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
@pytest.mark.parametrize("kind", ["nibbles", "crumbs"])
def test_packers_match_reference(kind, n):
    top = 15 if kind == "nibbles" else 3
    u = np.random.default_rng(n).integers(0, top + 1, (4, 3, n)).astype(
        np.uint8)
    pack_j, unpack_j = (getattr(jl, f"pack_{kind}"),
                        getattr(jl, f"unpack_{kind}"))
    pack_t, unpack_t = (getattr(tl, f"pack_{kind}"),
                        getattr(tl, f"unpack_{kind}"))
    bj = pack_j(jnp.asarray(u))
    bt = pack_t(torch.as_tensor(u))
    np.testing.assert_array_equal(_np(bt), _np(bj))
    np.testing.assert_array_equal(_np(unpack_t(bt, n)), u)
    np.testing.assert_array_equal(_np(unpack_t(bt, n)),
                                  _np(unpack_j(bj, n)))


LAYOUTS = [("fp", lambda m: m.FpLayout()),
           ("int8", lambda m: m.Int8Layout()),
           ("svdq", lambda m: m.SvdqLayout()),
           ("svdq-bits", lambda m: m.SvdqLayout((8, 8, 8, 4, 4, 4, 4, 4,
                                                 2, 2, 2)))]


@pytest.mark.parametrize("seed,amp", [(0, 1.0), (1, 1e-3), (2, 37.5)])
@pytest.mark.parametrize("name,make", LAYOUTS, ids=[n for n, _ in LAYOUTS])
def test_layout_encode_bytes_and_decode_match_reference(name, make, seed,
                                                        amp):
    R = 11
    x = _inputs(seed, (3, 2, 5, R), amp)
    jlay, tlay = make(jl), make(tl)
    for side in ("k", "v"):
        assert [(n, w) for n, w, _ in tlay.leaves(side, R)] == \
            [(n, w) for n, w, _ in jlay.leaves(side, R)]
        encj = jlay.encode(side, jnp.asarray(x))
        enct = tlay.encode(side, torch.as_tensor(x))
        assert sorted(enct) == sorted(encj)
        for leaf, _, ldt in tlay.leaves(side, R):
            assert ldt is None or enct[leaf].dtype == ldt
            np.testing.assert_array_equal(_np(enct[leaf]), _np(encj[leaf]))
        np.testing.assert_array_equal(
            _np(tlay.decode(side, enct, R)),
            np.asarray(jlay.decode(side, encj, R), np.float32))
        assert tlay.token_bytes(side, R) == jlay.token_bytes(side, R)


@pytest.mark.parametrize("seed,amp", [(0, 1.0), (1, 1e-3), (2, 37.5),
                                      (3, 1e3)])
@pytest.mark.parametrize("layout", [tl.Int8Layout(), tl.SvdqLayout()],
                         ids=["int8", "svdq"])
def test_roundtrip_error_bound(layout, seed, amp):
    """Every element decodes within ``1.0 * s * w_b`` of the input
    (tests/test_page_layouts.py:65), ``w_b = 127 / (2^(b-1) - 1)``."""
    R = 8
    x = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(3, 2, 5, R)).astype(np.float32) * amp)
    for side in ("k", "v"):
        enc = layout.encode(side, x)
        dec = layout.decode(side, enc, R)
        bits = (layout.resolve_bits(R) if side == "k"
                and isinstance(layout, tl.SvdqLayout) else (8,) * R)
        w = torch.tensor([127.0 / (2 ** (b - 1) - 1) for b in bits])
        bound = enc[side + "scale"].float() * w
        assert bool(((dec - x).abs() <= bound + 1e-7).all()), side


@pytest.mark.parametrize("rank", [1, 2, 3, 4, 7, 8, 12, 32, 50, 64])
def test_default_svdq_bits_match_reference(rank):
    assert tl.default_svdq_bits(rank) == jl.default_svdq_bits(rank)
    bits = tl.default_svdq_bits(rank)
    assert tl.packed_width(bits) == jl.packed_width(bits)


@pytest.mark.parametrize("seed", range(4))
def test_svdq_bits_from_spectrum_match_reference(seed):
    rng = np.random.default_rng(seed)
    sigma = np.sort(rng.gamma(0.5, size=24))[::-1]
    for rank in (None, 1, 5, 24):
        for th in ((0.85, 0.98), (0.5, 0.9), (0.0, 0.0)):
            assert tl.svdq_bits_from_spectrum(sigma, rank, th) == \
                jl.svdq_bits_from_spectrum(sigma, rank, th)
    assert tl.svdq_bits_from_spectrum(np.zeros(3)) == (8, 8, 8)


def test_page_bytes_match_bench_figures():
    """Page bytes at R = 32, Hkv 2 and pages of 64 tokens: 16384 fp,
    8704 int8 and 6912 svdq, i.e. BENCH_decode.json's resident_x 1.88
    and 2.37."""
    R, Hkv, ps = 32, 2, 64

    def page(lay):
        return ps * Hkv * (lay.token_bytes("k", R) + lay.token_bytes("v", R))

    fp, i8, sv = (page(tl.FpLayout()), page(tl.Int8Layout()),
                  page(tl.SvdqLayout()))
    assert (fp, i8, sv) == (16384, 8704, 6912)
    assert (round(fp / i8, 2), round(fp / sv, 2)) == (1.88, 2.37)


@pytest.mark.parametrize("quant,bits,kind", [
    ("none", (), tl.FpLayout), ("int8", (), tl.Int8Layout),
    ("svdq", (), tl.SvdqLayout), ("svdq", (8, 4, 2), tl.SvdqLayout)])
def test_get_layout_matches_reference(quant, bits, kind):
    class Cfg:
        cache_quant = quant
        svdq_bits = bits

    lay = tl.get_layout(Cfg)
    assert isinstance(lay, kind)
    assert lay.name == jl.get_layout(Cfg).name
    assert lay.kernel == jl.get_layout(Cfg).kernel
    if quant == "svdq":
        assert lay.resolve_bits(3 if bits else 8) == \
            jl.get_layout(Cfg).resolve_bits(3 if bits else 8)


@functools.lru_cache(maxsize=None)
def models():
    """Reduced tinyllama-1.1b and full-rank KQ-SVD projections solved by
    the reference (tests/test_page_layouts.py's ``setup``), bridged."""
    jcfg = jax_config("tinyllama-1.1b").reduced()
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    acc = GramAccumulator(len(jm.attn_layers))
    for i in range(2):
        toks = jax.random.randint(jax.random.PRNGKey(5 + i), (2, 32), 0,
                                  jcfg.vocab_size)
        acc.update_from_captures([jax.tree.map(np.asarray, c)
                                  for c in jm.calibrate(jp, toks)])
    mp = acc.solve(JaxCompression(method="kqsvd", rank_k=jcfg.d_head,
                                  rank_v=jcfg.d_head),
                   jm.group_output_weights(jp))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    return (jcfg, jp, torch_config("tinyllama-1.1b").reduced(), tp, mp,
            bridge.projections_from_jax(mp))


QUANT_SC = dict(max_seq_len=32, max_batch=2, temperature=0.0,
                decode_chunk=4, paged=True, page_size=4,
                chunked_prefill=True, prefill_chunk=8, cache_quant="int8")


def _reqs(cls, lens, seed=5, max_new=4, common=0):
    vocab = models()[2].vocab_size
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, common).astype(np.int32)
    return [cls(rid=i, prompt=np.concatenate(
                [pre, rng.integers(0, vocab, n).astype(np.int32)]),
                max_new_tokens=max_new)
            for i, n in enumerate(lens)]


def _port(sc_kw, reqs):
    _, _, tcfg, tp, _, tmp = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(**sc_kw), projections=tmp,
                        device="cpu")
    eng.generate(reqs)
    return eng


def test_cow_fork_copies_scale_pools_byte_exact():
    """The engine's fork moves every leaf of every layer, the int8 data
    pages and their bf16 scale pools, so the forked page is byte-identical
    to its source; the row then points at the copy."""
    eng = _port(QUANT_SC, _reqs(Request, [9, 7]))
    (src,) = eng.pool.alloc(1)                  # a page the drain wrote
    eng._btabs.assign(0, [src])
    eng.pool.share([src])                       # shared: a fork is due
    assert any(bool((layer[name][src] != 0).any())
               for layer in eng._cache for name in layer)
    eng._cow_fork(0, 0)
    dst = int(eng._btabs.rows[0, 0])
    assert dst != src and eng.pool.ref(src) == 1 and eng.n_cow_forks == 1
    names = set()
    for layer in eng._cache:
        for name, pool in layer.items():
            names.add(name)
            assert pool.dtype in (torch.int8, torch.bfloat16, torch.float32)
            assert torch.equal(pool[dst].view(torch.uint8),
                               pool[src].view(torch.uint8)), name
    assert {n for n in names if n.endswith("scale")}   # int8 took effect


def test_shared_prefix_int8_matches_unshared():
    """Prefix sharing and copy-on-write over int8 pages: the unshared
    int8 engine's tokens, with pages shared, and the reference's tokens
    (its Pallas route, the arithmetic of the port's K5)."""
    lens, common = [3, 4, 2, 3], 12
    r0 = _reqs(Request, lens, common=common)
    _port(QUANT_SC, r0)
    r1 = _reqs(Request, lens, common=common)
    eng = _port(dict(QUANT_SC, share_prefix=True), r1)
    assert [r.out_tokens for r in r1] == [r.out_tokens for r in r0]
    assert eng.n_shared_pages > 0
    jcfg, jp, _, _, jmp, _ = models()
    jeng = JaxEngine(dataclasses.replace(jcfg, use_pallas=True), jp,
                     JaxServe(**QUANT_SC, share_prefix=True),
                     projections=jmp)
    jr = _reqs(JaxRequest, lens, common=common)
    jeng.generate(jr)
    assert [r.out_tokens for r in r1] == [r.out_tokens for r in jr]
    assert eng.n_shared_pages == jeng.n_shared_pages
    assert eng.n_cow_forks == jeng.n_cow_forks


def test_swap_int8_pages_matches_reserve():
    """Swap preemption over int8 pages carries the scale pools with the
    codes: the same tokens as the unpressured int8 engine (10 physical
    pages from 6 fp-page units, three 14-token requests)."""
    sc_kw = dict(QUANT_SC, n_pages=6, admission="optimistic",
                 preempt_mode="swap", watermark_low=0.1)
    r0 = _reqs(Request, [14, 13, 14], max_new=8)
    _port(QUANT_SC, r0)
    r1 = _reqs(Request, [14, 13, 14], max_new=8)
    eng = _port(sc_kw, r1)
    assert eng.pool.n_pages == 10
    assert eng.n_swapped_out >= 1 and eng.n_swapped_in == eng.n_swapped_out
    assert [r.out_tokens for r in r1] == [r.out_tokens for r in r0]
    assert eng.pool.free_count == eng.pool.n_pages


def test_corrupted_swap_scale_bytes_degrade_to_recompute():
    """int8 data and scale leaves ride one crc: a byte flipped in either
    fails swap-in verification.  Under a ``swap_corrupt`` fault the victim
    recomputes, with the tokens of the unfaulted run, and the firings,
    fallbacks and tokens equal the reference's (its Pallas route)."""
    sc_kw = dict(QUANT_SC, n_pages=6, admission="optimistic",
                 preempt_mode="swap", watermark_low=0.1, audit=True)
    r0 = _reqs(Request, [14, 13, 14], max_new=8)
    base = _port(sc_kw, r0)
    assert base.n_swapped_out > 0          # the pool does oversubscribe
    _, _, tcfg, tp, _, tmp = models()
    eng = ServingEngine(tcfg, tp, ServeConfig(**sc_kw), projections=tmp,
                        device="cpu",
                        faults=FaultInjector(0).add("swap_corrupt", nth=1))
    r1 = _reqs(Request, [14, 13, 14], max_new=8)
    eng.generate(r1)
    assert eng.faults.points_fired() == ("swap_corrupt",)
    assert eng.n_swap_fallbacks > 0        # the crc caught the flip
    assert [r.out_tokens for r in r1] == [r.out_tokens for r in r0]
    assert eng.pool.free_count == eng.pool.n_pages
    jcfg, jp, _, _, jmp, _ = models()
    jeng = JaxEngine(dataclasses.replace(jcfg, use_pallas=True), jp,
                     JaxServe(**sc_kw), projections=jmp,
                     faults=JaxInjector(0).add("swap_corrupt", nth=1))
    jr = _reqs(JaxRequest, [14, 13, 14], max_new=8)
    jeng.generate(jr)
    assert [r.out_tokens for r in r1] == [r.out_tokens for r in jr]
    assert eng.faults.fired_log == jeng.faults.fired_log
    assert (eng.n_swap_fallbacks, eng.n_swapped_out, eng.n_swapped_in) == \
        (jeng.n_swap_fallbacks, jeng.n_swapped_out, jeng.n_swapped_in)
    # one slot's swap buffers: a flipped byte in a data leaf or in a
    # scale leaf each breaks the crc
    eng.start(_reqs(Request, [14], max_new=8))
    while eng._prefilled[0] is not None or eng._slot_req[0] is None:
        eng.step()
    st = eng._swap_out_slot(0, int(eng._pos[0]))
    assert set(st["bufs"][0]) == {"kc", "kscale", "vc", "vscale"}
    assert checksum(st["bufs"]) == st["crc"]
    for name in ("kc", "vscale"):
        bufs = [dict(layer) for layer in st["bufs"]]
        bufs[1][name] = FaultInjector(7).corrupt("swap_corrupt",
                                                 bufs[1][name])
        assert checksum(bufs) != st["crc"], name
