"""The port's page layouts against the reference's on the same numpy
inputs: ``quantize_int8``, the nibble and crumb packers and every
layout's ``encode`` byte for byte (bf16 scales by their bits), ``decode``
value for value, the round-trip bound of tests/test_page_layouts.py, the
SVDq bit allocations, and the hardware-independent page bytes of
BENCH_decode.json."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import page_layouts as jl
from repro_torch.serving import page_layouts as tl


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
