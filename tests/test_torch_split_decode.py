"""Split-KV decode (K4) and int8 pages (K5) in the port: their plain
PyTorch versions against the reference's jnp oracles and its Pallas
kernels in interpret mode, on seeded numpy inputs (scrambled block
tables, page-boundary lengths, splits 1, 2, 3 and 8 with empty trailing
splits); the split merge against the reference's; the split heuristic;
the Python side of bf16 split decode's in-launch merge (its arrival
counters, what one launch is handed); and the reference's lax twins for
split and int8 decode."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kq_decode import (combine_split_partials as j_combine,
                                     default_decode_splits as j_splits,
                                     kq_decode_paged_attention_int8_ref as
                                     j_int8_ref,
                                     kq_decode_paged_attention_op,
                                     kq_decode_paged_attention_split_ref as
                                     j_split_ref)
from repro.models import attention as jattn
from repro.serving.page_layouts import quantize_int8 as j_quantize
from repro_torch.kernels.kq_decode import (combine_split_partials,
                                           default_decode_splits,
                                           kq_combine_splits,
                                           kq_decode_paged_attention,
                                           kq_decode_paged_attention_split_ref,
                                           resolve_splits)
from repro_torch.kernels.kq_decode import paged
from repro_torch.models import attention as tattn

TOL = dict(rtol=2e-5, atol=2e-5)          # tests/test_kernels.py, float32


def _case(seed, B, Hkv, m, n_pages, ps, Rk, Rv, quant=False):
    """Queries, pools of ``1 + B * n_pages`` pages and a scrambled block
    table; int8: codes and bf16 scales encoded by the reference's
    quantizer.  Returns numpy arrays (scales as float32 holding bf16
    values)."""
    rng = np.random.default_rng(seed)
    P = 1 + B * n_pages
    qc = rng.normal(size=(B, Hkv * m, Rk)).astype(np.float32)
    kp = rng.normal(size=(P, Hkv, ps, Rk)).astype(np.float32)
    vp = rng.normal(size=(P, Hkv, ps, Rv)).astype(np.float32)
    btab = rng.permutation(np.arange(1, P, dtype=np.int32)).reshape(
        B, n_pages)
    if not quant:
        return qc, kp, vp, btab, None, None
    (k8, ks), (v8, vs) = j_quantize(jnp.asarray(kp)), j_quantize(
        jnp.asarray(vp))
    return (qc, np.array(k8), np.array(v8), btab,
            np.array(ks.astype(jnp.float32))[..., None],
            np.array(vs.astype(jnp.float32))[..., None])


def _torch(qc, kp, vp, btab, ks, vs):
    t = [torch.as_tensor(a) for a in (qc, kp, vp, btab)]
    if ks is not None:
        t += [torch.as_tensor(ks).to(torch.bfloat16),
              torch.as_tensor(vs).to(torch.bfloat16)]
    return t


def _jax(qc, kp, vp, btab, ks, vs):
    j = [jnp.asarray(a) for a in (qc, kp, vp, btab)]
    if ks is not None:
        j += [jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16)]
    return j


@pytest.mark.parametrize("max_len,ps", [(1, 4), (64, 64), (7 * 64, 64),
                                        (8 * 64, 64), (1000, 16),
                                        (1 << 20, 64), (300, 4), (33, 8)])
def test_default_decode_splits_matches_reference(max_len, ps):
    for kw in ({}, {"max_splits": 16}, {"min_pages_per_split": 2}):
        assert default_decode_splits(max_len, ps, **kw) == \
            j_splits(max_len, ps, **kw)


@pytest.mark.parametrize("n_pages", [1, 2, 3, 4, 7, 8, 9, 64])
def test_split_resolution_matches_reference(n_pages):
    """The reference's wrapper resolution (paged.py:506-521) with the
    bound at the table width."""
    for want in (1, 2, 3, 4, 8, 100):
        n = max(1, min(want, n_pages))
        if n > 1:
            span = -(-n_pages // n)
            n = -(-n_pages // span)
        else:
            span = n_pages
        got_n, got_span = resolve_splits(want, n_pages)
        assert got_n == n and (n == 1 or got_span == span)
        assert (got_n - 1) * got_span < n_pages <= got_n * got_span


def test_combine_matches_reference():
    rng = np.random.default_rng(0)
    o = rng.normal(size=(2, 3, 5, 4, 7)).astype(np.float32)
    lse = (rng.normal(size=(2, 3, 5, 4)) * 30).astype(np.float32)
    lse[0, 0, 2:] = -1e30                     # empty trailing splits
    want = np.asarray(j_combine(jnp.asarray(o), jnp.asarray(lse)))
    got = combine_split_partials(torch.as_tensor(o), torch.as_tensor(lse))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    out = torch.empty(2, 3 * 4, 7)
    assert kq_combine_splits(torch.as_tensor(o), torch.as_tensor(lse),
                             out) is out
    np.testing.assert_array_equal(out.numpy(), got.reshape(2, 12, 7).numpy())


def test_combine_empty_split_is_neutral():
    m, Rv = 2, 4
    live = torch.full((m, Rv), 2.0)
    empty = torch.zeros(m, Rv)
    lse_empty = torch.full((m,), -1e30 + float(np.log(1e-30)))
    out = combine_split_partials(torch.stack([live, empty]),
                                 torch.stack([torch.zeros(m), lse_empty]))
    assert torch.equal(out, live)
    out0 = combine_split_partials(torch.stack([empty, empty]),
                                  torch.stack([lse_empty, lse_empty]))
    assert float(out0.abs().max()) == 0.0


def test_combine_extreme_scale_stability():
    o = torch.stack([torch.ones(1, 2, 4), torch.full((1, 2, 4), 5.0)], dim=1)
    lse = torch.stack([torch.full((1, 2), 400.0),
                       torch.full((1, 2), -400.0)], dim=1)
    out = combine_split_partials(o, lse)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), o[:, 0].numpy(), rtol=1e-6,
                               atol=1e-6)


# lengths at page boundaries of pages of 4 (0, 1, ps-1, ps, ps+1, full)
SPLIT_CASES = [
    (3, 2, 2, 8, 4, 8, 6, (0, 1, 32)),
    (3, 2, 2, 8, 4, 8, 6, (3, 4, 5)),
    (2, 1, 4, 9, 4, 5, 7, (36, 13)),
    (2, 2, 1, 3, 16, 12, 4, (17, 48)),
]


@pytest.mark.parametrize("num_splits", [1, 2, 3, 8])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_split_plain_matches_reference_oracle_and_pallas(case, num_splits):
    """The plain K4 equals the reference's independent split oracle and
    its Pallas split kernel; splits 1 dispatches K1's plain version,
    exactly.  Splits beyond a short sequence are empty."""
    B, Hkv, m, n_pages, ps, Rk, Rv, lengths = SPLIT_CASES[case]
    arrs = _case(case, B, Hkv, m, n_pages, ps, Rk, Rv)
    lens = np.asarray(lengths, np.int32)
    tq, tk, tv, tb = _torch(*arrs)
    jq, jk, jv, jb = _jax(*arrs)
    got = kq_decode_paged_attention(tq, tk, tv, torch.as_tensor(lens), tb,
                                    scale=0.3, num_splits=num_splits)
    oracle = j_split_ref(jq, jk, jv, jnp.asarray(lens), jb,
                         num_splits=num_splits, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    own = kq_decode_paged_attention_split_ref(
        tq, tk, tv, torch.as_tensor(lens), tb, num_splits=num_splits,
        scale=0.3)
    np.testing.assert_allclose(own.numpy(), np.asarray(oracle), **TOL)
    pallas = kq_decode_paged_attention_op(
        jq, jk, jv, jnp.asarray(lens), jb, scale=0.3, interpret=True,
        max_len=n_pages * ps, num_splits=num_splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    if num_splits == 1:
        unsplit = kq_decode_paged_attention(tq, tk, tv, torch.as_tensor(lens),
                                            tb, scale=0.3)
        assert torch.equal(got, unsplit)


@pytest.mark.parametrize("num_splits", [1, 2, 3, 8])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_int8_plain_matches_reference_oracle_and_pallas(case, num_splits):
    """The plain K5, unsplit and split, over int8 pools with bf16 scales
    equals the reference's int8 oracle and its Pallas kernel with
    ``kscale``/``vscale``."""
    B, Hkv, m, n_pages, ps, Rk, Rv, lengths = SPLIT_CASES[case]
    arrs = _case(10 + case, B, Hkv, m, n_pages, ps, Rk, Rv, quant=True)
    lens = np.asarray(lengths, np.int32)
    tq, tk, tv, tb, tks, tvs = _torch(*arrs)
    jq, jk, jv, jb, jks, jvs = _jax(*arrs)
    assert tk.dtype == torch.int8
    got = kq_decode_paged_attention(tq, tk, tv, torch.as_tensor(lens), tb,
                                    scale=0.3, num_splits=num_splits,
                                    kscale=tks, vscale=tvs)
    oracle = j_int8_ref(jq, jk, jv, jks, jvs, jnp.asarray(lens), jb,
                        scale=0.3)
    # the oracle averages the masked cache of a length-0 slot where the
    # kernels give 0 (ROADMAP.md queue 3): held to the kernel there
    live = lens > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(oracle)[live],
                               **TOL)
    assert not got[torch.as_tensor(~live)].any()
    pallas = kq_decode_paged_attention_op(
        jq, jk, jv, jnp.asarray(lens), jb, scale=0.3, interpret=True,
        max_len=n_pages * ps, num_splits=num_splits, kscale=jks,
        vscale=jvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_scales_must_come_together():
    tq, tk, tv, tb, tks, _ = _torch(*_case(0, 1, 1, 2, 2, 4, 4, 4,
                                           quant=True))
    with pytest.raises(ValueError):
        kq_decode_paged_attention(tq, tk, tv, torch.tensor([3]), tb,
                                  kscale=tks)


# ---------------------------------------------------------------------------
# bf16 split decode's in-launch merge: the Python side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 6, 32])
def test_arrival_counters_are_kept_per_device_and_stream(monkeypatch, n):
    """One zeroed int32 buffer per (device, stream), handed out again on
    the next call (the kernel leaves it zero), never shared between two
    streams."""
    monkeypatch.setattr(paged, "_ARRIVALS", {})
    cpu = torch.device("cpu")
    a = paged._arrivals(cpu, 11, n)
    assert a.dtype == torch.int32 and a.numel() == n and not bool(a.any())
    assert paged._arrivals(cpu, 11, n) is a
    assert paged._arrivals(cpu, 11, max(1, n // 2)) is a
    b = paged._arrivals(cpu, 12, n)
    assert b is not a and b.data_ptr() != a.data_ptr()
    assert set(paged._ARRIVALS) == {(cpu, 11), (cpu, 12)}


@pytest.mark.parametrize("first,then,want", [(4, 5, 8), (4, 20, 20),
                                             (8, 9, 16)])
def test_arrival_counters_grow_zeroed(monkeypatch, first, then, want):
    """A call that needs more counters than the buffer holds gets a new
    one, zeroed, of at least twice the size; later smaller calls reuse
    it."""
    monkeypatch.setattr(paged, "_ARRIVALS", {})
    cpu = torch.device("cpu")
    a = paged._arrivals(cpu, 0, first)
    a.fill_(3)                  # what a launch that died would leave
    b = paged._arrivals(cpu, 0, then)
    assert b is not a and b.numel() == want and not bool(b.any())
    assert paged._arrivals(cpu, 0, first) is b


@pytest.mark.parametrize("merge", [False, True])
def test_split_decode_launch_gets_output_partials_and_counters(monkeypatch,
                                                               merge):
    """What the split decode hands its one launch (a stand-in library
    records it): partials always; with ``merge`` also the output, which
    is returned, and a 128-byte line of zero counters a (slot, kv group)
    of this (device, stream);
    without, neither, and the partials are returned."""
    calls = []

    class Lib:
        def kq_decode_paged_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(paged, "_library", Lib)
    monkeypatch.setattr(paged, "_cuda_only", lambda name, qc: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=77))
    monkeypatch.setattr(paged, "_ARRIVALS", {})
    B, Hkv, m, n_pages, ps, Rk, Rv = 3, 2, 4, 6, 4, 8, 5
    qc, kp, vp, bt, _, _ = _case(0, B, Hkv, m, n_pages, ps, Rk, Rv)
    tq, tk, tv, tb = (t.to(torch.bfloat16) if t.is_floating_point() else t
                      for t in _torch(qc, kp, vp, bt, None, None))
    lens = torch.tensor([0, 5, 24], dtype=torch.int32)
    res = paged._decode("kq_decode_paged_split", tq, tk, tv, lens, tb, 0.5,
                        span=2, n_splits=3, merge=merge)
    (args,) = calls
    out_p, part_p, lse_p, count_p = args[7:11]
    assert part_p is not None and lse_p is not None
    assert args[11:14] == (B, Hkv * m, Hkv)
    assert args[14:20] == (ps, n_pages, Rk, Rv, 2, 3)   # span 2, 3 splits
    if merge:
        assert res.shape == (B, Hkv * m, Rv) and res.dtype == torch.bfloat16
        assert out_p == res.data_ptr()
        count = paged._ARRIVALS[(tq.device, 77)]
        assert count_p == count.data_ptr()
        assert count.numel() == B * Hkv * paged.ARRIVAL_STRIDE
        assert not bool(count.any())
    else:
        o_part, lse = res
        assert out_p is None and count_p is None
        assert o_part.shape == (B, Hkv, 3, m, Rv) and lse.shape == (B, Hkv,
                                                                    3, m)
        assert part_p == o_part.data_ptr() and lse_p == lse.data_ptr()
        assert not paged._ARRIVALS


# ---------------------------------------------------------------------------
# The reference's lax twins
# ---------------------------------------------------------------------------


def _dense(seed, B, Hkv, m, T, R, lengths):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hkv * m, 1, R)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, T, R)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, T, R)).astype(np.float32)
    valid = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, valid


@pytest.mark.parametrize("S", [1, 2, 3, 7, 21, 64])
def test_split_decode_attention_matches_reference(S):
    q, k, v, valid = _dense(4, 3, 4, 2, 21, 8, [21, 1, 13])
    want = jattn.split_decode_attention(*map(jnp.asarray, (q, k, v, valid)),
                                        0.25, S)
    got = tattn.split_decode_attention(
        *map(torch.as_tensor, (q, k, v, valid)), 0.25, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    unsplit = tattn.decode_attention(*map(torch.as_tensor, (q, k, v, valid)),
                                     0.25)
    np.testing.assert_allclose(got.numpy(), unsplit.numpy(), **TOL)


@pytest.mark.parametrize("S", [0, 1, 2, 3, 8])
def test_int8_decode_attention_matches_reference(S):
    """The dense int8 twins (S = 0: ``int8_decode_attention``, else the
    split one) on the reference's own quantized entries.  Their value
    product runs in bf16, so they agree to a bf16 ulp."""
    q, k, v, valid = _dense(5, 2, 2, 2, 13, 8, [13, 6])
    (k8, ks), (v8, vs) = j_quantize(jnp.asarray(k)), j_quantize(
        jnp.asarray(v))
    qg = q.reshape(2, 2, 2, 8)
    jargs = (jnp.asarray(qg), k8, v8, ks, vs, jnp.asarray(valid), 0.3)
    targs = (torch.as_tensor(qg), torch.as_tensor(np.array(k8)),
             torch.as_tensor(np.array(v8)),
             torch.as_tensor(np.array(ks.astype(jnp.float32))).bfloat16(),
             torch.as_tensor(np.array(vs.astype(jnp.float32))).bfloat16(),
             torch.as_tensor(valid), 0.3)
    if S:
        want = jattn.int8_split_decode_attention(*jargs, S)
        got = tattn.int8_split_decode_attention(*targs, S)
    else:
        want = jattn.int8_decode_attention(*jargs)
        got = tattn.int8_decode_attention(*targs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=8e-3, atol=1e-4)
