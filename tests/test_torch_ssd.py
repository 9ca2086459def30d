"""K7's plain versions, the route of the port's ``ssd_chunk_scan`` on CPU
tensors, against the reference: its Pallas SSD kernel in interpret mode
on the sweep of tests/test_kernels.py (float32 at 2e-5, bfloat16 inputs
at the sweep's 5e-2), the float64 recurrences (the port's and the
reference's) at ragged lengths with an initial and a final state (1e-4),
and the reference's lax ``_ssd_chunked`` at every length it takes (1e-4,
tests/test_ssm.py's bar), and at the lengths it rejects the recurrence.
Inputs come from numpy with fixed seeds, by the sweep's laws; the kernel
itself is held to the plain version on the card
(tests/test_torch_cuda.py).  The bf16 kernel's arithmetic (a split over
chunks with float32 operands in bf16 parts) is emulated here and held to
the plain version at the card's bars."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_chunk_scan_op
from repro.kernels.ssd import ssd_chunk_scan_ref as jax_recurrence
from repro.models.ssm import _ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd import (ssd_chunk_scan, ssd_chunk_scan_plain,
                                     ssd_chunk_scan_ref)
from repro_torch.models.ssm import _ssd_chunked


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": 2e-5, "bfloat16": 5e-2}      # tests/test_kernels.py
RTOL = dict(rtol=1e-4, atol=1e-4)              # tests/test_ssm.py


def _softplus(v):
    return np.logaddexp(v, 0.0)


def _inputs(seed, B, nh, G, S, hd, n):
    """Kernel layout, the sweep's laws: x, B, C normal, dt = softplus of a
    normal, A = -exp(normal / 2), a = dt * A; float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, nh, S, hd)).astype(np.float32)
    dt = _softplus(rng.normal(size=(B, nh, S))).astype(np.float32)
    A = -np.exp(rng.normal(size=(nh,)) * 0.5).astype(np.float32)
    a = (dt * A[None, :, None]).astype(np.float32)
    Bm = rng.normal(size=(B, G, S, n)).astype(np.float32)
    Cm = rng.normal(size=(B, G, S, n)).astype(np.float32)
    return x, a, dt, Bm, Cm


def _t(arrays, dtype="float32"):
    return [torch.as_tensor(v).to(getattr(torch, dtype)) for v in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nh,G,S,hd,n,ck", [
    (2, 4, 2, 64, 8, 16, 16),
    (1, 2, 1, 128, 16, 8, 32),
    (2, 2, 2, 64, 8, 8, 64),
])
def test_plain_matches_reference_kernel(B, nh, G, S, hd, n, ck, dtype):
    """The shapes of test_kernels.py::test_ssd_kernel_sweep; x, B and C
    in ``dtype``, a and dt float32, y in x's type from both."""
    x, a, dt, Bm, Cm = _inputs(3, B, nh, G, S, hd, n)
    xt, Bt, Ct = _t((x, Bm, Cm), dtype)
    before = ssd_chunk_scan.launches
    y, h = ssd_chunk_scan(xt, torch.as_tensor(a), torch.as_tensor(dt), Bt,
                          Ct, chunk=ck)
    assert ssd_chunk_scan.launches == before          # CPU: no kernel
    assert y.dtype == xt.dtype and y.shape == (B, nh, S, hd)
    assert h.dtype == torch.float32 and h.shape == (B, nh, n, hd)
    jd = getattr(jnp, dtype)
    ref = ssd_chunk_scan_op(jnp.asarray(x).astype(jd), jnp.asarray(a),
                            jnp.asarray(dt), jnp.asarray(Bm).astype(jd),
                            jnp.asarray(Cm).astype(jd), chunk=ck,
                            interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("S", [1, 17, 41, 65])
def test_plain_matches_recurrence_at_ragged_lengths(S, chunk, with_h0):
    """Any S, a short last chunk: y and the final state equal the float64
    recurrence's, the port's copy, which without h0 equals the
    reference's (repro/kernels/ssd/ref.py) to float64 rounding."""
    B, nh, G, hd, n = 2, 4, 2, 8, 16
    x, a, dt, Bm, Cm = _inputs(S, B, nh, G, S, hd, n)
    h0 = (np.random.default_rng(7).normal(size=(B, nh, n, hd))
          .astype(np.float32) if with_h0 else None)
    args = _t((x, a, dt, Bm, Cm))
    h0t = None if h0 is None else torch.as_tensor(h0)
    y, h = ssd_chunk_scan_plain(*args, chunk=chunk, h0=h0t)
    y64, h64 = ssd_chunk_scan_ref(*args, h0=h0t)
    assert y64.dtype == h64.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), y64.numpy(), **RTOL)
    np.testing.assert_allclose(h.numpy(), h64.numpy(), **RTOL)
    if h0 is None:
        ref = jax_recurrence(x, a, dt, Bm, Cm)
        np.testing.assert_allclose(y64.numpy(), np.asarray(ref, np.float64),
                                   rtol=1e-6, atol=1e-6)


def _model_layout(seed, B, S, nh, G, hd, n):
    """The model's layout: xh (B,S,nh,hd), dt (B,S,nh), A (nh,), Bm/Cm
    (B,S,G,n), test_ssm.py's laws."""
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, S, nh, hd)).astype(np.float32)
    dt = _softplus(rng.normal(size=(B, S, nh))).astype(np.float32)
    A = -np.exp(rng.normal(size=(nh,)) * 0.5).astype(np.float32)
    Bm = rng.normal(size=(B, S, G, n)).astype(np.float32)
    Cm = rng.normal(size=(B, S, G, n)).astype(np.float32)
    return xh, dt, A, Bm, Cm


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("S,chunk", [(1, 16), (8, 16), (40, 16), (64, 16),
                                     (96, 32), (70, 32)])
def test_ssd_chunked_matches_reference(S, chunk, with_h0):
    """Lengths the reference's lax path takes (S divisible by its
    S // chunk chunks): it cuts S = 40 at chunk 16 into 2 x 20, the port
    into 16 + 16 + 8; y and the final state agree at test_ssm.py's 1e-4."""
    B, nh, G, hd, n = 2, 4, 2, 8, 16
    arrays = _model_layout(S, B, S, nh, G, hd, n)
    h0 = (np.random.default_rng(1).normal(size=(B, nh, n, hd))
          .astype(np.float32) if with_h0 else None)
    y, h = _ssd_chunked(*_t(arrays), chunk,
                        h0=None if h0 is None else torch.as_tensor(h0))
    jy, jh = jax_ssd_chunked(*(jnp.asarray(v) for v in arrays), chunk,
                             h0=None if h0 is None else jnp.asarray(h0))
    assert y.shape == (B, S, nh, hd) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **RTOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **RTOL)


@pytest.mark.parametrize("S", [41, 65, 97])
def test_ssd_chunked_takes_lengths_the_reference_rejects(S):
    """The reference cuts S into S // 16 equal chunks and fails where they
    do not divide S (ROADMAP.md queue 3); the port masks a short last
    chunk and matches the float64 recurrence there."""
    B, nh, G, hd, n = 1, 4, 2, 8, 16
    arrays = _model_layout(S, B, S, nh, G, hd, n)
    with pytest.raises(TypeError):
        jax_ssd_chunked(*(jnp.asarray(v) for v in arrays), 16)
    xh, dt, A, Bm, Cm = _t(arrays)
    y, h = _ssd_chunked(xh, dt, A, Bm, Cm, 16)
    a = (dt * A).transpose(1, 2)
    y64, h64 = ssd_chunk_scan_ref(xh.transpose(1, 2), a, dt.transpose(1, 2),
                                  Bm.transpose(1, 2), Cm.transpose(1, 2))
    np.testing.assert_allclose(y.numpy(), y64.transpose(1, 2).numpy(),
                               **RTOL)
    np.testing.assert_allclose(h.numpy(), h64.numpy(), **RTOL)


@pytest.mark.cuda
def test_wrapper_raises_for_unbuilt_shapes_on_the_card():
    """On a CUDA tensor the wrapper launches K7 or raises: a (head_dim,
    d_state) it was not built for, or a chunk past 256, is a
    ``ValueError``, and the plain version is never taken."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    for hd, n, chunk in ((32, 16, 16), (16, 32, 16), (16, 16, 512)):
        x, a, dt, Bm, Cm = (t.to(dev) for t in
                            _t(_inputs(0, 1, 2, 1, 8, hd, n)))
        before = ssd_chunk_scan.launches
        with pytest.raises(ValueError):
            ssd_chunk_scan(x, a, dt, Bm, Cm, chunk=chunk)
        assert ssd_chunk_scan.launches == before


# -- the bf16 body's arithmetic (csrc/ssd_tc.cuh), emulated in float32 --------

def _parts(v, n):
    """v (float32) as n bfloat16 parts, each the remainder so far rounded
    to bf16 (the remainders are exact in f32)."""
    out = []
    for _ in range(n):
        out.append(v.to(torch.bfloat16).float())
        v = v - out[-1]
    return out


def _split_product(a, b, n_a=None, n_b=None):
    """a @ b with a in n_a and b in n_b bf16 parts (None: bf16-exact as it
    is): the sum of the parts' products, each exact in f32 and summed in
    f32, as wgmma does."""
    pa = [a] if n_a is None else _parts(a, n_a)
    pb = [b] if n_b is None else _parts(b, n_b)
    return sum(u @ w for u in pa for w in pb)


def _emulate_tc(x, a, dt, B, C, chunk, h0=None, parts=(3, 3, 3)):
    """The chunk-parallel body on bf16-exact x, B, C (float32 tensors):
    each chunk's cum (f64 sum rounded to f32); its local state
    S_c = (B o wj)^T x; the pass over chunks h_in[c] = h,
    h = h exp(cum_last) + S_c; and y = W x + exp(cum_i) (C . h_in) with
    W = (C.B^T) exp(cum_i - cum_j) dt_j, masked before exp.  ``parts``:
    the bf16 parts of W, of B o wj and of h_in."""
    w_parts, bw_parts, h_parts = parts
    Bsz, nh, S, hd = x.shape
    rep = nh // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1)
    Ch = C.repeat_interleave(rep, dim=1)
    n = B.shape[-1]
    cuts = [(c0, min(S, c0 + chunk)) for c0 in range(0, S, chunk)]
    cums, states = [], []
    for c0, c1 in cuts:                          # 1. chunk-local states
        cum = torch.cumsum(a[:, :, c0:c1].double(), dim=-1).float()
        wj = torch.exp(cum[..., -1:] - cum) * dt[:, :, c0:c1]
        Bw = (Bh[:, :, c0:c1] * wj[..., None]).transpose(-1, -2)
        states.append(_split_product(Bw, x[:, :, c0:c1], n_a=bw_parts))
        cums.append(cum)
    h = (torch.zeros((Bsz, nh, n, hd)) if h0 is None else h0.clone())
    h_in = []
    for cum, s_c in zip(cums, states):           # 2. the pass
        h_in.append(h)
        h = h * torch.exp(cum[..., -1])[..., None, None] + s_c
    ys = []
    for (c0, c1), cum, hc in zip(cuts, cums, h_in):   # 3. the scan
        L = c1 - c0
        Cc, Bc = Ch[:, :, c0:c1], Bh[:, :, c0:c1]
        causal = torch.ones((L, L), dtype=torch.bool).tril()
        diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal,
                                                                   -1e30)
        W = (Cc @ Bc.transpose(-1, -2)) * torch.exp(diff) \
            * dt[:, :, None, c0:c1]
        carried = _split_product(Cc, hc, n_b=h_parts)
        ys.append(_split_product(W, x[:, :, c0:c1], n_a=w_parts)
                  + torch.exp(cum)[..., None] * carried)
    y = torch.cat(ys, dim=2) if ys else torch.zeros_like(x)
    return y, h


def _model_law(seed, nh, G, S, hd, n, with_h0):
    """chip_smoke.py's law for K7 at the model's heads: x, B, C normal and
    rounded to bf16, dt the softplus of a normal plus the init's dt bias
    (1e-3 .. 0.1 over the heads), A = -(1 .. 16); h0 normal."""
    rng = np.random.default_rng(seed)
    bf = lambda v: torch.as_tensor(v.astype(np.float32)).to(  # noqa: E731
        torch.bfloat16).float()
    x = bf(rng.normal(size=(1, nh, S, hd)))
    Bm, Cm = bf(rng.normal(size=(1, G, S, n))), bf(rng.normal(
        size=(1, G, S, n)))
    dt0 = np.exp(np.linspace(np.log(1e-3), np.log(0.1), nh))
    dt = _softplus(rng.normal(size=(1, S, nh)) + np.log(np.expm1(dt0)))
    A = -np.linspace(1.0, 16.0, nh)
    a = torch.as_tensor((dt * A).transpose(0, 2, 1).astype(np.float32))
    dt = torch.as_tensor(dt.transpose(0, 2, 1).astype(np.float32))
    h0 = (torch.as_tensor(rng.normal(size=(1, nh, n, hd)).astype(np.float32))
          if with_h0 else None)
    return x, a, dt, Bm, Cm, h0


def _sweep_law(seed, nh, G, S, hd, n, with_h0):
    """The reference kernel sweep's law (``_inputs``: dt the softplus of a
    normal, up to some 3, A = -exp(normal / 2)) with x, B, C rounded to
    bf16, and h0 normal: the card tests' data."""
    x, a, dt, Bm, Cm = _inputs(seed, 1, nh, G, S, hd, n)
    bf = lambda v: torch.as_tensor(v).to(torch.bfloat16).float()  # noqa: E731
    h0 = (torch.as_tensor(np.random.default_rng(seed + 1).normal(
        size=(1, nh, n, hd)).astype(np.float32)) if with_h0 else None)
    return bf(x), torch.as_tensor(a), torch.as_tensor(dt), bf(Bm), bf(Cm), h0


def _worst_over_bar(out, ref):
    """max |out - ref| / (1e-4 + 1e-4 |ref|): check_ssd's bar for a
    float32 y and the state (chip_smoke.py) is 1."""
    return float(((out - ref).abs() / (1e-4 + 1e-4 * ref.abs())).max())


@pytest.mark.parametrize("law", [_model_law, _sweep_law],
                         ids=["model", "sweep"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("nh,G,S,hd,n,ck", [
    (4, 1, 1, 64, 128, 256), (4, 1, 255, 64, 128, 256),
    (4, 1, 257, 64, 128, 256), (4, 1, 1024, 64, 128, 256),
    (4, 2, 70, 8, 8, 16), (4, 2, 45, 8, 16, 17), (2, 1, 33, 16, 8, 1),
    (8, 2, 100, 16, 16, 32), (2, 1, 300, 128, 64, 100),
])
def test_tensor_core_arithmetic_holds_check_ssds_bars(nh, G, S, hd, n, ck,
                                                      with_h0, law):
    """The bf16 body's split over chunks, with W, B o wj and h_in each in
    three bf16 parts, stays within check_ssd's bars (1e-4 + 1e-4 |ref|,
    for a float32 y and the state) of the plain version at mamba2-2.7b's
    head, at its law and the reference sweep's, and on the small shapes
    with ragged chunks; with a margin of at least 2 for the card's order
    of accumulation."""
    x, a, dt, Bm, Cm, h0 = law(S + ck, nh, G, S, hd, n, with_h0)
    y, h = _emulate_tc(x, a, dt, Bm, Cm, ck, h0)
    y_ref, h_ref = ssd_chunk_scan_plain(x, a, dt, Bm, Cm, chunk=ck, h0=h0)
    assert y.shape == y_ref.shape and h.shape == h_ref.shape
    assert _worst_over_bar(y, y_ref) < 0.5
    assert _worst_over_bar(h, h_ref) < 0.5


def test_one_bf16_part_for_h_in_misses_the_bar():
    """Why h_in is split: with h_in rounded to one bf16 part the carried
    term alone moves y past check_ssd's bar at mamba2's head and law with
    a random initial state (some 500 times), and two parts still reach
    it; three parts hold it."""
    x, a, dt, Bm, Cm, h0 = _model_law(5, 4, 1, 512, 64, 128, True)
    y_ref, _ = ssd_chunk_scan_plain(x, a, dt, Bm, Cm, chunk=256, h0=h0)
    worst = {k: _worst_over_bar(_emulate_tc(x, a, dt, Bm, Cm, 256, h0,
                                            parts=(3, 3, k))[0], y_ref)
             for k in (1, 2, 3)}
    assert worst[1] > 100 and worst[2] > 0.5 and worst[3] < 0.5, worst


def test_two_bf16_parts_for_w_and_b_wj_miss_the_bar():
    """Why W and B o wj take three parts too: at the reference sweep's law
    (dt up to some 3) hi + lo for either moves y past check_ssd's bar at
    mamba2's head (B o wj through the states the later chunks carry)."""
    x, a, dt, Bm, Cm, h0 = _sweep_law(0, 16, 1, 1000, 64, 128, True)
    y_ref, _ = ssd_chunk_scan_plain(x, a, dt, Bm, Cm, chunk=256, h0=h0)
    worst = {p: _worst_over_bar(_emulate_tc(x, a, dt, Bm, Cm, 256, h0,
                                            parts=p)[0], y_ref)
             for p in ((2, 3, 3), (3, 2, 3), (3, 3, 3))}
    assert worst[(2, 3, 3)] > 1 and worst[(3, 2, 3)] > 0.5, worst
    assert worst[(3, 3, 3)] < 0.5, worst


def test_wrapper_shapes_match_the_cuda_instantiations():
    """``SHAPES`` in the wrapper and the dispatch tables of both bodies in
    the CUDA source (the float32 body's ``launch<T, hd, n>`` in
    ``ssd.cu``, the bf16 body's ``run<hd, n>`` in ``ssd_tc.cuh``) name the
    same (head_dim, d_state) pairs, read as text."""
    from repro_torch.kernels.ssd import ssd as ssd_mod
    csrc = Path(ssd_mod.__file__).resolve().parents[1] / "csrc"
    f32 = re.search(r"int dispatch\(.*?\n}\n", (csrc / "ssd.cu").read_text(),
                    re.S).group(0)
    tc = re.search(r"inline int dispatch\(.*?\n}\n",
                   (csrc / "ssd_tc.cuh").read_text(), re.S).group(0)
    for body, pat in ((f32, r"launch<T, (\d+), (\d+)>"),
                      (tc, r"run<(\d+), (\d+)>")):
        pairs = [(int(h), int(n)) for h, n in re.findall(pat, body)]
        assert len(pairs) == len(set(pairs))
        assert set(pairs) == set(ssd_mod.SHAPES)
        for h, n in pairs:
            assert f"hd == {h} && n == {n}" in body


def test_library_hash_covers_the_bf16_body(tmp_path, monkeypatch):
    """``ssd.cu`` includes the bf16 body, so the library's name hashes
    ``ssd_tc.cuh`` too: an edited body never loads a stale library."""
    from repro_torch.kernels import build
    assert sorted(p.name for p in build.sources("ssd")) == \
        ["ssd.cu", "ssd_tc.cuh"]
    for path in build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("ssd")
    with open(tmp_path / "ssd_tc.cuh", "a") as f:
        f.write("// edited\n")
    assert build.library_path("ssd") != before


def test_both_bodies_take_the_wrappers_longest_chunk():
    """``MAX_CHUNK`` in the wrapper is ``kMaxChunk`` of both CUDA bodies
    (read as text): the entry points refuse a longer chunk, and the bf16
    body's blocks hold one chunk."""
    from repro_torch.kernels.ssd import ssd as ssd_mod
    csrc = Path(ssd_mod.__file__).resolve().parents[1] / "csrc"
    for name in ("ssd.cu", "ssd_tc.cuh"):
        m = re.search(r"constexpr int kMaxChunk = (\d+);",
                      (csrc / name).read_text())
        assert int(m.group(1)) == ssd_mod.MAX_CHUNK, name
