"""The port's op cost and collective count against the reference's HLO
walker: the counterpart of tests/test_hlo_cost.py.

``repro_torch.roofline.flop_count.OpCounter`` counts the aten operators
of an eager step where the reference's ``hlo_cost.analyze`` walks
compiled HLO, and ``roofline.analysis.count_collectives`` counts the
collectives a step issues where the reference's ``parse_collectives``
reads them from HLO text.  On tests/test_hlo_cost.py's functions:

* ``tanh(x @ w)`` unrolled 4 times at 64 x 64 float32: ``dot_flops`` and
  ``transcendentals`` equal the reference's; ``bytes`` is the eager
  program's own (each ``mm`` reads two 64 x 64 operands and writes one,
  each ``tanh`` reads one and writes one: 4 x 5 x 64 x 64 x 4 bytes),
  where XLA fuses the ``tanh`` into its consumer;
* the ``lax.scan`` of 7: the port's Python loop of 7 counts the scan's
  trip-corrected ``dot_flops`` (7 x 2 x 64^3);
* the batched einsum: 2 x 4 x 8 x 16 x 32;
* the collectives: on a fake 64-rank group, an all-reduce of 1024 f32 on
  the 16-rank model axis of a (4, 16) mesh (functional and in-place) and
  an all-gather to 2048 x 8 bf16 on the 8-rank axis of an (8, 8) mesh
  give the reference's wire bytes for the same ops;
* ``LivePeak``, the dry run's peak: the largest sum of live storages, a
  storage leaving it when freed, meta tensors left out, the same on fake
  tensors as on real ones.

And the kernels' booked work:

* K6's bytes a pass (a ``flash_attention`` call) in a dry run of reduced
  tinyllama (bfloat16) on a fake (4, 2) mesh equal the reference's
  ``kernel_pass`` at the same local shapes (read off its
  ``attn_substitution`` with one stand-in loop of no bytes);
* each ``*_work`` equals the arithmetic ``chip_smoke.py`` phase 4 bounds
  its kernel with (written out here) at one phase-4 shape;
* each wrapper's output on fake tensors has the shapes and types of its
  plain version's output on real CPU tensors, and K6's and K7's autograd
  functions run a fake forward and backward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.config import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.roofline import analysis as jax_analysis
from repro.roofline.analysis import parse_collectives
from repro.roofline.hlo_cost import analyze
from repro_torch.config import ShapeSpec
from repro_torch.configs import get_config
from repro_torch.kernels.flash import flash as flash_mod
from repro_torch.kernels.flash import flash_attention_train
from repro_torch.kernels.kq_decode import kq_decode as k3_mod
from repro_torch.kernels.kq_decode import paged as paged_mod
from repro_torch.kernels.ssd import ssd as ssd_mod
from repro_torch.kernels.ssd import ssd_chunk_scan_train
from repro_torch.launch.dryrun import run_cell
from repro_torch.roofline import LivePeak, count_collectives, count_flops


def _compile(f, *specs):
    return jax.jit(f).lower(*specs).compile()


def _ref_totals(f, *shapes):
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze(_compile(f, *specs).as_text())


def _live_peak_of_a_sequence() -> int:
    with LivePeak() as live:
        a = torch.ones(1024)               # 4 KiB live
        b = a * 2                          # 8 KiB
        del a                              # 4 KiB
        c = torch.ones(2048)               # 12 KiB: the peak
        torch.empty(1 << 20, device="meta")    # shapes only
        del b, c
    return live.peak


def test_live_peak_counts_live_storages():
    from torch._subclasses.fake_tensor import FakeTensorMode
    assert _live_peak_of_a_sequence() == 12 * 1024
    with FakeTensorMode():
        assert _live_peak_of_a_sequence() == 12 * 1024


# -- tests/test_hlo_cost.py's functions ---------------------------------------

def test_unrolled_tanh_matches_reference():
    def f(x, w):
        for _ in range(4):
            x = jnp.tanh(x @ w)
        return x

    def g(x, w):
        for _ in range(4):
            x = torch.tanh(x @ w)
        return x

    ref = _ref_totals(f, (64, 64), (64, 64))
    x, w = torch.zeros(64, 64), torch.zeros(64, 64)
    got = count_flops(lambda: g(x, w))
    assert got.dot_flops == ref.dot_flops == 4 * 2 * 64 ** 3
    assert got.transcendentals == ref.transcendentals == 4 * 64 * 64
    assert got.bytes == 4 * (3 + 2) * 64 * 64 * 4
    assert got.flops == got.dot_flops


def test_scan_trip_count_matches_python_loop():
    def scan_f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=7)[0]

    ref = _ref_totals(scan_f, (64, 64), (64, 64))
    x, w = torch.zeros(64, 64), torch.zeros(64, 64)

    def loop():
        y = x
        for _ in range(7):
            y = torch.tanh(y @ w)
    got = count_flops(loop)
    assert got.dot_flops == ref.dot_flops == 7 * 2 * 64 ** 3


def test_dot_flops_with_batch_dims_matches_reference():
    ref = _ref_totals(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                      (4, 8, 16), (4, 16, 32))
    a, b = torch.zeros(4, 8, 16), torch.zeros(4, 16, 32)
    got = count_flops(lambda: torch.einsum("bij,bjk->bik", a, b))
    assert got.dot_flops == ref.dot_flops == 2 * 4 * 8 * 16 * 32


def test_collectives_match_reference_cost_model():
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    hlo = """
HloModule m
ENTRY %main () -> f32[] {
  %ar = f32[1024]{0} all-reduce(%x), replica_groups=[4,16]<=[64]
  %ag = bf16[2048,8]{1,0} all-gather(%y), replica_groups=[8,8]<=[64]
}
"""
    ref = parse_collectives(hlo, 64)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=64)
    try:
        m416 = init_device_mesh("cpu", (4, 16), mesh_dim_names=("a", "b"))
        m88 = init_device_mesh("cpu", (8, 8), mesh_dim_names=("a", "b"))
        with count_collectives() as st:
            for out in (funcol.all_reduce(torch.zeros(1024), "sum",
                                          (m416, 1)),
                        funcol.all_gather_single(
                            torch.zeros(256, 8, dtype=torch.bfloat16), 0,
                            (m88, 1))):
                funcol.wait_tensor(out)
        with count_collectives() as inplace:
            dist.all_reduce(torch.zeros(1024), group=m416.get_group("b"))
    finally:
        dist.destroy_process_group()
    assert st.count == ref.count == 2
    assert st.wire_bytes == pytest.approx(ref.wire_bytes, rel=1e-12)
    assert st.raw_bytes == ref.raw_bytes
    assert st.by_op == pytest.approx(ref.by_op, rel=1e-12)
    assert st.count_by_op == {"all-reduce": 1, "all-gather": 1}
    assert [w for _, w in st.top] == sorted(ref.by_op.values(),
                                            reverse=True)
    assert inplace.by_op == pytest.approx(
        {"all-reduce": ref.by_op["all-reduce"]}, rel=1e-12)
    assert {f.name for f in dataclasses.fields(jax_analysis.CollectiveStats)
            } <= set(dataclasses.asdict(st))


# -- the kernels' booked work --------------------------------------------------

def test_k6_bytes_a_pass_equal_reference_kernel_pass(tmp_path):
    """Reduced tinyllama (2 layers, 4 / 2 heads of 16) trained one step
    on a fake (4, 2) mesh: 4 query heads and 2 kv heads over the 2-way
    model axis, 16 sequences over the 4-way data axis; every K6 call
    (forward and remat recompute) books the reference's ``kernel_pass``
    at those local shapes, and ``attn_loops_subbed`` is their count."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="bfloat16")
    jcfg = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                               dtype="bfloat16")
    sh = ShapeSpec("train_small", 64, 16, "train")
    rec = run_cell("tinyllama-1.1b", sh, False, "baseline", str(tmp_path),
                   mesh_shape=(4, 2), device_type="cpu", cfg=cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    k6 = rec["kernels"]["flash_attention"]
    P = jax_analysis.packed_pairs(sh.seq_len, jcfg.attn_block_q,
                                  jcfg.sliding_window)
    _, added, n = jax_analysis.attn_substitution(
        jcfg, dataclasses.replace(JAX_SHAPES["train_4k"], seq_len=64,
                                  global_batch=16),
        [{"trip": P, "mult": 1.0, "bytes": 0.0}], 1, 2, 4)
    assert n == 1
    assert k6["calls"] == 2 * cfg.n_layers            # remat recomputes
    assert k6["bytes"] / k6["calls"] == added / 1.75
    assert rec["collectives"]["attn_loops_subbed"] == k6["calls"]
    assert rec["hlo_bytes_kernel"] == rec["hlo_bytes"]


def test_work_functions_equal_phase_4_arithmetic():
    """Each ``*_work`` at one of ``chip_smoke.py`` phase 4's shapes
    (tinyllama's m 8 and solved-like ranks; K4 in 8 splits) against the
    arithmetic phase 4 wrote inline before the work functions."""
    B, H, Hkv, rk, rv, ps = 8, 32, 4, 29, 31, 16
    m = H // Hkv
    lengths = [1, 31, 32, 33, 500, 777, 1023, 1024]
    live = sum(lengths)
    pages = sum(-(-n // ps) for n in lengths)
    n_sp = 8
    for isz in (2, 4):
        bf16 = isz == 2
        qo = B * H * (rk + rv) * isz
        meta = B * 4 + pages * 4
        part = B * Hkv * n_sp * m * (rv + 1) * 4
        fp, i8 = live * Hkv * (rk + rv) * isz, live * Hkv * (rk + rv + 4)
        flops = 2 * live * H * (rk + rv)
        assert k3_mod.kq_decode_work(B, H, Hkv, rk, rv, isz, live) == (
            flops, fp + qo + B * 4)
        assert k3_mod.kq_decode_span_work(B, H, Hkv, rk, rv, isz, live) == (
            flops, fp + B * H * rk * isz + B * H * (rv + 1) * 4 + B * 4)
        dims = (B, H, Hkv, rk, rv, isz, live, pages)
        assert paged_mod.kq_decode_paged_work(*dims) == (flops,
                                                         fp + qo + meta)
        assert paged_mod.kq_decode_paged_int8_work(*dims) == (
            flops, i8 + qo + meta)
        comb = paged_mod.kq_combine_splits_work(B, Hkv, n_sp, m, rv, isz)
        assert comb == (B * H * n_sp * (2 * rv + 2),
                        part + B * H * rv * isz)
        for work, pool in ((paged_mod.kq_decode_paged_split_work, fp),
                           (paged_mod.kq_decode_paged_int8_split_work, i8)):
            f1, b1 = work(*dims, n_sp, merged=bf16)
            total = b1 + (0 if bf16 else comb[1])
            assert (f1, total) == (flops, pool + qo + meta
                                   + (0 if bf16 else 2 * part))
        # K2: the last chunk of a 1000-token prompt in a 256 bucket
        pos0, n_valid, S = 768, 232, 256
        plen = pos0 + n_valid
        seen = sum(min(pos0 + s + 1, plen) for s in range(S))
        assert paged_mod.kq_prefill_paged_work(
            H, Hkv, S, rk, rv, isz, ps, [plen], [pos0]) == (
            2 * seen * H * (rk + rv),
            plen * Hkv * (rk + rv) * isz + H * S * (rk + rv) * isz + 8
            + -(-plen // ps) * 4)
        # K6: danube's windowed prefill, and MLA's (192, 128)
        S, W = 4608, 4096
        band = W * (W + 1) // 2 + (S - W) * W
        assert flash_mod.flash_work(1, 32, 8, S, 80, 80, isz, W) == (
            4 * 80 * band * 1 * 32, 2 * 1 * (32 + 8) * S * 80 * isz)
        assert flash_mod.flash_work(4, 16, 16, 512, 192, 128, isz) == (
            2 * (192 + 128) * 512 * 513 // 2 * 4 * 16,
            4 * 16 * 512 * (2 * 192 + 2 * 128) * isz)
        # K7: mamba2's prefill at S 4096, chunk 256, y in float32
        pairs = 16 * 256 * 257 // 2
        assert ssd_mod.ssd_work(1, 80, 1, 4096, 64, 128, 256, isz, 4) == (
            80 * (2 * pairs * (128 + 64) + 4 * 4096 * 128 * 64),
            80 * 4096 * 64 * (isz + 4) + 2 * 4096 * 128 * isz
            + 2 * 80 * 4096 * 4 + 80 * 128 * 64 * 4)


def _fake(t):
    return torch.empty(t.shape, dtype=t.dtype).as_strided(t.shape,
                                                          t.stride())


def _sig(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(o.shape), o.dtype) for o in outs]


def _paged_args(g, B=3, H=8, Hkv=2, P=9, ps=4, Rk=6, Rv=5, S=None,
                int8=False):
    qc = torch.randn(B, H, *(() if S is None else (S,)), Rk, generator=g)
    if int8:
        kp = torch.randint(-127, 128, (P, Hkv, ps, Rk), generator=g,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, (P, Hkv, ps, Rv), generator=g,
                           dtype=torch.int8)
    else:
        kp, vp = (torch.randn(P, Hkv, ps, r, generator=g) for r in (Rk, Rv))
    btab = torch.arange(1, 1 + B * 2, dtype=torch.int32).reshape(B, 2)
    lengths = torch.tensor([1, 5, 8], dtype=torch.int32)
    return qc, kp, vp, lengths, btab


def _cases():
    g = torch.Generator()
    g.manual_seed(0)
    qc, kc, vc = (torch.randn(3, 8, 6, generator=g),
                  torch.randn(3, 2, 10, 6, generator=g),
                  torch.randn(3, 2, 10, 5, generator=g))
    lengths = torch.tensor([0, 4, 10], dtype=torch.int32)
    qp, kp, vp, pl, bt = _paged_args(g)
    _, k8, v8, _, _ = _paged_args(g, int8=True)
    ks = torch.rand(9, 2, 4, 1, generator=g).to(torch.bfloat16)
    vs = torch.rand(9, 2, 4, 1, generator=g).to(torch.bfloat16)
    qk2, _, _, _, _ = _paged_args(g, S=4)
    pos0 = torch.tensor([0, 1, 4], dtype=torch.int32)
    o_part = torch.randn(3, 2, 2, 4, 5, generator=g)
    lse = torch.randn(3, 2, 2, 4, generator=g)
    q6, k6, v6 = (torch.randn(2, h, 12, 16, generator=g) for h in (4, 2, 2))
    x = torch.randn(2, 4, 20, 8, generator=g)
    a = -torch.rand(2, 4, 20, generator=g)
    dt = torch.rand(2, 4, 20, generator=g)
    Bm, Cm = (torch.randn(2, 1, 20, 16, generator=g) for _ in range(2))
    return {
        "K3": (k3_mod.kq_decode_attention, (qc, kc, vc, lengths), {}),
        "K3 span": (k3_mod.kq_decode_attention_span, (qc, kc, vc, lengths),
                    {}),
        "K1": (paged_mod.kq_decode_paged_attention, (qp, kp, vp, pl, bt),
               {}),
        "K4 + merge": (paged_mod.kq_decode_paged_attention,
                       (qp, kp, vp, pl, bt), {"num_splits": 2}),
        "K4": (paged_mod.kq_decode_paged_split, (qp, kp, vp, pl, bt),
               {"span": 1, "n_splits": 2}),
        "K5": (paged_mod.kq_decode_paged_int8, (qp, k8, v8, ks, vs, pl, bt),
               {}),
        "K5 split": (paged_mod.kq_decode_paged_int8_split,
                     (qp, k8, v8, pl, bt),
                     {"span": 1, "n_splits": 2, "kscale": ks, "vscale": vs}),
        "merge": (paged_mod.kq_combine_splits,
                  (o_part, lse, torch.empty(3, 8, 5)), {}),
        "K2": (paged_mod.kq_prefill_paged_attention,
               (qk2, kp, vp, pos0 + 4, pos0, bt), {}),
        "K6": (flash_mod.flash_attention, (q6, k6, v6), {"window": 5}),
        "K7": (ssd_mod.ssd_chunk_scan, (x, a, dt, Bm, Cm),
               {"chunk": 8, "out_dtype": torch.float32}),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_fake_output_matches_plain_output(name):
    from torch._subclasses.fake_tensor import FakeTensorMode
    fn, args, kw = _cases()[name]
    want = _sig(fn(*args, **kw))
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(t) for t in args]
        fkw = {k: mode.from_tensor(v) if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
        got = fn(*fargs, **fkw)
    assert _sig(got) == want


def test_autograd_functions_run_fake_forward_and_backward():
    """K6's and K7's autograd functions on fake tensors: the forward saves
    what the plain backward reads, and the backward gives gradients of
    the inputs' shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q, k, v = (torch.empty(2, h, 12, 16).requires_grad_()
                   for h in (4, 2, 2))
        flash_attention_train(q, k, v).sum().backward()
        assert [t.grad.shape for t in (q, k, v)] == [q.shape, k.shape,
                                                     v.shape]
        x = torch.empty(2, 4, 20, 8).requires_grad_()
        a, dt = (torch.empty(2, 4, 20).requires_grad_() for _ in range(2))
        Bm, Cm = (torch.empty(2, 1, 20, 16).requires_grad_()
                  for _ in range(2))
        y, h = ssd_chunk_scan_train(x, a, dt, Bm, Cm, chunk=8)
        (y.sum() + h.sum()).backward()
        assert [t.grad.shape for t in (x, a, dt, Bm, Cm)] == [
            t.shape for t in (x, a, dt, Bm, Cm)]
