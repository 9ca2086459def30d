"""K3 in the port: its plain PyTorch version against the reference's
Pallas kernel (interpret mode) and jnp oracle, on the reference kernel
sweep (varlen lengths, non-divisible tails); the wrapper's CPU routing;
and a lazy build (the module imports where there is no nvcc)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kq_decode import (kq_decode_attention_op,
                                     kq_decode_attention_ref)
from repro_torch.kernels import build
from repro_torch.kernels.kq_decode import kq_decode as k3_mod
from repro_torch.kernels.kq_decode import (kq_decode_attention,
                                           kq_decode_attention_ref as
                                           torch_ref)

# the reference kernel tests' tolerances (tests/test_kernels.py:15-17)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, B, H, Hkv, T, Rk, Rv):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Rk)).astype(np.float32),
            rng.normal(size=(B, Hkv, T, Rk)).astype(np.float32),
            rng.normal(size=(B, Hkv, T, Rv)).astype(np.float32))


def _both(arrays, dtype):
    """The same values as jnp and torch arrays of ``dtype`` (both round
    float32 to bfloat16 to nearest even)."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,Rk,Rv,bt,lengths", [
    (1, 4, 2, 64, 16, 16, 16, (64,)),
    (2, 8, 2, 128, 32, 16, 32, (101, 7)),        # mixed lengths, GQA m=4
    (1, 4, 1, 256, 8, 8, 64, (6,)),
    (2, 4, 4, 64, 16, 32, 16, (32, 64)),
    (3, 4, 2, 100, 16, 16, 16, (100, 37, 1)),    # T % bt != 0 tail block
    (2, 2, 2, 80, 8, 8, 32, (80, 50)),           # tail block + varlen
    (2, 12, 4, 70, 37, 45, 32, (70, 33)),        # odd ranks, m=3
])
def test_plain_k3_matches_reference_kernel(B, H, Hkv, T, Rk, Rv, bt,
                                           lengths, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(1, B, H, Hkv, T, Rk, Rv), dtype)
    lens = np.asarray(lengths, np.int32)
    want = kq_decode_attention_op(jq, jk, jv, jnp.asarray(lens),
                                  block_t=bt, scale=0.25)
    oracle = kq_decode_attention_ref(jq, jk, jv, jnp.asarray(lens),
                                     scale=0.25)
    got = kq_decode_attention(tq, tk, tv, torch.as_tensor(lens),
                              scale=0.25)
    assert got.dtype == tq.dtype and got.shape == (B, H, Rv)
    for ref in (want, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   **TOL[dtype])


def test_zero_length_gives_zero_like_the_kernel():
    """lengths == 0: the port follows the kernel (acc / max(l, 1e-30) =
    0), not the jnp oracle, which averages the masked cache uniformly."""
    arrays = _inputs(2, 2, 4, 2, 16, 8, 8)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    lens = np.asarray([0, 5], np.int32)
    got = kq_decode_attention(tq, tk, tv, torch.as_tensor(lens)).numpy()
    kern = np.asarray(kq_decode_attention_op(jq, jk, jv, jnp.asarray(lens),
                                             block_t=8))
    oracle = np.asarray(kq_decode_attention_ref(jq, jk, jv,
                                                jnp.asarray(lens)))
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got, kern, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(oracle[0], arrays[2][0].mean(axis=1)
                               .repeat(2, axis=0), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[1], oracle[1], rtol=2e-5, atol=2e-5)


def test_dead_rows_do_not_leak_nan():
    """Cache rows at or past the length may hold anything (NaN too)."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(3, 1, 2, 1, 12, 4, 4))
    lens = torch.tensor([5], dtype=torch.int32)
    clean = kq_decode_attention(q, k, v, lens)
    k[:, :, 5:] = float("nan")
    v[:, :, 5:] = float("nan")
    dirty = kq_decode_attention(q, k, v, lens)
    np.testing.assert_array_equal(dirty.numpy(), clean.numpy())


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    """On a CPU tensor the wrapper runs the plain version: nothing is
    built or launched."""
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return torch_ref(*a, **kw)

    def no_build(name):
        raise AssertionError(f"built {name} for a CPU call")

    monkeypatch.setattr(k3_mod, "kq_decode_attention_ref", spy)
    monkeypatch.setattr(build, "load", no_build)
    before = kq_decode_attention.launches
    q, k, v = (torch.as_tensor(a) for a in _inputs(4, 2, 4, 2, 16, 8, 8))
    kq_decode_attention(q, k, v, torch.tensor([3, 16], dtype=torch.int32))
    assert calls == [1]
    assert kq_decode_attention.launches == before


def test_module_imports_without_nvcc(tmp_path):
    """Importing the kernel module and running it on CPU tensors needs
    no compiler: the build is lazy (here with an empty PATH)."""
    code = (
        "import torch\n"
        "from repro_torch.kernels import build\n"
        "from repro_torch.kernels.kq_decode import kq_decode_attention\n"
        "q = torch.randn(1, 2, 4); k = torch.randn(1, 1, 8, 4)\n"
        "out = kq_decode_attention(q, k, k, torch.tensor([8], "
        "dtype=torch.int32))\n"
        "assert out.shape == (1, 2, 4) and not build._loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path),
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"



# ---------------------------------------------------------------------------
# bf16 decode's tensor-core arithmetic (csrc/kq_decode_tc.cuh), emulated
# ---------------------------------------------------------------------------

def _cluster_size(tokens):
    """The body's cluster size: about 128 tokens a CTA, 1 to 8 CTAs."""
    return min(8, max(1, -(-tokens // 128)))


def _bf16_hi_lo(p):
    """p as bf16 hi (truncated) + lo (p - hi, rounded), as the body feeds
    it to the tensor cores."""
    hi = (p.view(torch.int32) & -65536).view(torch.float32)
    return hi, (p - hi).to(torch.bfloat16).float()


def _emulate_tc_decode(qc, kc, vc, lengths, scale, ks=None, vs=None,
                       span=None, n_splits=1):
    """The body's arithmetic on a gathered cache: qc (B,H,Rk) bf16; kc, vc
    (B,Hkv,T,R) bf16 values or int8 codes; ks, vs (B,Hkv,T) f32 scales of
    int8 codes or None.  Per (b, g, span) a cluster of C CTAs takes equal
    runs of 16-token tiles below the length, each CTA's four warps the
    tiles w, w + 4, ...; a warp scores its tiles with f32 accumulation of
    bf16 operands (16 query rows, zero-padded), in log2 units with the K
    scale on the score column, keeps its running (max, sum, acc) and adds
    p (times the V scale) as bf16 hi + lo; warps merge, then CTAs.
    Returns the output (B,H,Rv) in bf16, or with ``span`` the f32
    partials (B,Hkv,n,m,Rv) and lse (B,Hkv,n,m)."""
    B, H, Rk = qc.shape
    Hkv, T, Rv = kc.shape[1], kc.shape[2], vc.shape[-1]
    m = H // Hkv
    split = span is not None
    span = span if split else T
    C = _cluster_size(span)
    sl2 = scale * 1.4426950408889634
    neg = -1e30
    out = torch.zeros(B, Hkv, n_splits, m, Rv)
    lse = torch.zeros(B, Hkv, n_splits, m)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), T)
        for g in range(Hkv):
            q16 = torch.zeros(16, Rk)
            q16[:m] = qc[b, g * m:(g + 1) * m].float()
            for sp in range(n_splits):
                lo = sp * span
                hi = min(n, lo + span)
                n_t = -(-(hi - lo) // 16) if hi > lo else 0
                per = -(-n_t // C)
                ctas = []
                for r in range(C):
                    j0, j1 = min(n_t, r * per), min(n_t, (r + 1) * per)
                    warps = []
                    for w in range(4):
                        m_run = torch.full((16,), neg)
                        l_run = torch.zeros(16)
                        acc = torch.zeros(16, Rv)
                        for j in range(j0 + w, j1, 4):
                            t0 = lo + 16 * j
                            t1 = min(hi, t0 + 16)
                            K = torch.zeros(16, Rk)
                            V = torch.zeros(16, Rv)
                            K[:t1 - t0] = kc[b, g, t0:t1].float()
                            V[:t1 - t0] = vc[b, g, t0:t1].float()
                            x = (q16 @ K.T) * sl2
                            if ks is not None:
                                sk = torch.zeros(16)
                                sk[:t1 - t0] = ks[b, g, t0:t1]
                                x = x * sk[None, :]
                            x[:, t1 - t0:] = -float("inf")
                            m_new = torch.maximum(m_run, x.amax(dim=1))
                            corr = torch.exp2(m_run - m_new)
                            m_run = m_new
                            p = torch.exp2(x - m_new[:, None])
                            l_run = l_run * corr + p.sum(dim=1)
                            if vs is not None:
                                sv = torch.zeros(16)
                                sv[:t1 - t0] = vs[b, g, t0:t1]
                                p = p * sv[None, :]
                            p_hi, p_lo = _bf16_hi_lo(p)
                            acc = acc * corr[:, None] + p_hi @ V + p_lo @ V
                        warps.append((m_run, l_run, acc))
                    ctas.append(_merge(warps))
                mc, lc, ac = _merge(ctas)
                den = lc.clamp_min(1e-30)
                out[b, g, sp] = (ac / den[:, None])[:m]
                lse[b, g, sp] = (torch.where(
                    mc == neg, mc, mc * 0.6931471805599453)
                    + torch.log(den))[:m]
    if split:
        return out, lse
    return out[:, :, 0].reshape(B, H, Rv).to(torch.bfloat16)


def _merge(parts):
    """(max, sum, acc) partials rescaled to their common max (log2)."""
    mx = torch.stack([p[0] for p in parts]).amax(dim=0)
    f = [torch.exp2(p[0] - mx) for p in parts]
    return (mx, sum(p[1] * fi for p, fi in zip(parts, f)),
            sum(p[2] * fi[:, None] for p, fi in zip(parts, f)))


def _held_to_card_bars(got, ref):
    """The card's bars: 2e-2, and two bf16 ulps of the plain output."""
    err = (got.float() - ref.float()).abs()
    assert bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all()), \
        float(err.max())
    assert bool((err <= 1e-4 + 8e-3 * ref.float().abs()).all()), \
        float(err.max())


def _tc_case(seed, B, H, Hkv, ps, n_pages, Rk, Rv):
    """bf16 queries and pools (1 + B n_pages pages), a shuffled table."""
    rng = np.random.default_rng(seed)
    P = 1 + B * n_pages
    t = [torch.as_tensor(rng.normal(size=s).astype(np.float32))
         .to(torch.bfloat16)
         for s in ((B, H, Rk), (P, Hkv, ps, Rk), (P, Hkv, ps, Rv))]
    btab = torch.as_tensor(rng.permutation(np.arange(1, P, dtype=np.int32))
                           .reshape(B, n_pages))
    return (*t, btab)


# phase 4's shape (B 8, H 32, Hkv 4, pages of 16, 64 a slot, Rk 50, Rv 42),
# groups m 3 and 16, ranks 1, 5, 255 and 256, pages of 4 and 16; lengths
# at the cluster's run edges, 0 and the capacity
TC_CASES = [   # B, H, Hkv, ps, n_pages, Rk, Rv, lengths
    (8, 32, 4, 16, 64, 50, 42, (1, 31, 32, 33, 500, 777, 1023, 1024)),
    (3, 12, 4, 4, 64, 5, 5, (0, 129, 256)),                     # m 3
    (2, 64, 4, 16, 8, 256, 255, (128, 17)),                     # m 16
    (3, 8, 4, 4, 40, 255, 1, (160, 15, 16)),
    (2, 16, 2, 16, 16, 1, 256, (127, 256)),
]


@pytest.mark.parametrize("case,int8", [
    (c, i8) for c in range(len(TC_CASES)) for i8 in (False, True)
    if not (i8 and TC_CASES[c][1] // TC_CASES[c][2] > 8)])
def test_tc_decode_arithmetic_matches_plain_version(case, int8):
    """K1 (and K5 on int8 pages, which take groups m <= 8) by the body's
    arithmetic, held to the plain versions at the card's bars."""
    from repro_torch.kernels.kq_decode import (
        kq_decode_paged_attention_int8_ref, kq_decode_paged_attention_ref)
    from repro_torch.serving import gather_pages
    from repro_torch.serving.page_layouts import quantize_int8
    B, H, Hkv, ps, n_pages, Rk, Rv, lengths = TC_CASES[case]
    qc, kp, vp, btab = _tc_case(case, B, H, Hkv, ps, n_pages, Rk, Rv)
    lens = torch.tensor(lengths, dtype=torch.int32)
    if not int8:
        want = kq_decode_paged_attention_ref(qc, kp, vp, lens, btab,
                                             scale=0.3)
        got = _emulate_tc_decode(qc, gather_pages(kp, btab),
                                 gather_pages(vp, btab), lens, 0.3)
    else:
        (k8, ks), (v8, vs) = quantize_int8(kp), quantize_int8(vp)
        ks, vs = ks[..., None], vs[..., None]
        want = kq_decode_paged_attention_int8_ref(qc, k8, v8, ks, vs, lens,
                                                  btab, scale=0.3)
        got = _emulate_tc_decode(
            qc, gather_pages(k8, btab), gather_pages(v8, btab), lens, 0.3,
            ks=gather_pages(ks, btab)[..., 0].float(),
            vs=gather_pages(vs, btab)[..., 0].float())
    assert got.shape == want.shape
    _held_to_card_bars(got, want)
    assert not got[lens == 0].any()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n_splits", [2, 8])
@pytest.mark.parametrize("case", [0, 1, 3])
def test_tc_split_partials_match_plain_version(case, n_splits, int8):
    """K4 and K5 split by the body's arithmetic: each span's f32 partial
    output and lse (an empty span: 0 and -1e30 + log(1e-30)) against the
    plain partials, and merged against the plain unsplit output."""
    from repro_torch.kernels.kq_decode import (
        combine_split_partials, kq_decode_paged_attention_ref,
        kq_decode_paged_partials_ref, resolve_splits)
    from repro_torch.serving import gather_pages
    from repro_torch.serving.page_layouts import quantize_int8
    B, H, Hkv, ps, n_pages, Rk, Rv, lengths = TC_CASES[case]
    qc, kp, vp, btab = _tc_case(10 + case, B, H, Hkv, ps, n_pages, Rk, Rv)
    lens = torch.tensor(lengths, dtype=torch.int32)
    n, span = resolve_splits(n_splits, n_pages)
    scales = {}
    if int8:
        (kp, ks), (vp, vs) = quantize_int8(kp), quantize_int8(vp)
        scales = dict(kscale=ks[..., None], vscale=vs[..., None])
    o_ref, lse_ref = kq_decode_paged_partials_ref(
        qc, kp, vp, lens, btab, span=span, n_splits=n, scale=0.3, **scales)
    T = n_pages * ps
    kg, vg = (torch.nn.functional.pad(gather_pages(x, btab).float(),
                                      (0, 0, 0, n * span * ps - T))
              for x in (kp, vp))
    sc = {k[0] + "s": torch.nn.functional.pad(
        gather_pages(v, btab)[..., 0].float(), (0, n * span * ps - T))
        for k, v in scales.items()}
    o, lse = _emulate_tc_decode(qc, kg, vg, lens.clamp(0, T), 0.3,
                                span=span * ps, n_splits=n, **sc)
    _held_to_card_bars(o, o_ref)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    merged = combine_split_partials(o, lse).reshape(B, H, Rv)
    if not int8:
        _held_to_card_bars(merged.to(torch.bfloat16),
                           kq_decode_paged_attention_ref(
                               qc, kp, vp, lens, btab, scale=0.3))


@pytest.mark.parametrize("lengths", [(1, 15, 16, 17, 127, 128, 129, 1024),
                                     (0, 0, 1024, 33, 500, 777, 1023, 8)])
def test_tc_dense_decode_arithmetic_matches_plain_version(lengths):
    """K3 by the body's arithmetic at the dense main path's shape (T 1024:
    a cluster of 8 CTAs a group), lengths at its run edges and 0."""
    rng = np.random.default_rng(7)
    qc, kc, vc = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
                  .to(torch.bfloat16)
                  for s in ((8, 32, 50), (8, 4, 1024, 50), (8, 4, 1024, 42)))
    lens = torch.tensor(lengths, dtype=torch.int32)
    assert _cluster_size(1024) == 8
    _held_to_card_bars(_emulate_tc_decode(qc, kc, vc, lens, 0.25),
                       torch_ref(qc, kc, vc, lens, scale=0.25))


def test_decode_wrapper_table_matches_the_cuda_instantiations():
    """bf16 decode's p.v widths (``KQ_DECODE_PV_WIDTHS`` in
    ``csrc/kq_decode_tc.cuh``, read as text) are multiples of 16 whose
    largest is ``MAX_RANK``, so no Rv in 1..MAX_RANK is refused; the
    body's rank and group limits and its cluster rule are the wrappers'
    and this file's."""
    import re

    from repro_torch.kernels.kq_decode.kq_decode import MAX_GROUP, MAX_RANK
    from repro_torch.kernels.kq_decode.paged import MAX_GROUP_INT8
    src = (build.CSRC / "kq_decode_tc.cuh").read_text()
    body = re.search(r"#define KQ_DECODE_PV_WIDTHS\(X\)((?:[^\n]*\\\n)*"
                     r"[^\n]*)", src).group(1)
    widths = [int(w) for w in re.findall(r"X\((\d+)\)", body)]
    assert widths == sorted(set(widths))
    assert all(w % 16 == 0 and 16 <= w <= 256 for w in widths)
    assert widths[-1] == MAX_RANK
    consts = dict(re.findall(r"constexpr \w+ (k\w+) = ([^;]+);", src))
    assert int(consts["kMaxR"]) == MAX_RANK
    assert int(consts["kMaxGroup"]) == MAX_GROUP
    assert int(consts["kMaxGroupInt8"]) == MAX_GROUP_INT8
    assert (int(consts["kRunTokens"]), int(consts["kMaxCluster"])) == \
        (128, 8)
    assert [_cluster_size(t) for t in (1, 128, 129, 1024, 8192)] == \
        [1, 1, 2, 8, 8]
