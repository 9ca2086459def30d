"""The port on the card: each CUDA kernel (K3, K1, K2, K4, K5, the
split combine, K6 and K7) against its plain PyTorch version, bf16 split
decode's in-launch merge against the two launches it replaces, and the
reduced model on the card against the CPU on the dense and the paged
chunked engines, also with int8 pages and split-KV decode, with the dense
int8 cache, with the sliding-window ring cache and with mamba2's SSM
state.  Marked
``cuda``; skips where there is no GPU.  Imports no JAX, so it also runs
on a machine without it (``--noconftest``: the repository's conftest
imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import CompressionConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.core.calibration import calibrate_model
from repro_torch.data import calibration_batches
from repro_torch.device import tree_to
from repro_torch.kernels.flash import flash_attention, flash_attention_ref
from repro_torch.kernels.flash.flash import HEAD_DIMS
from repro_torch.kernels.ssd import ssd_chunk_scan, ssd_chunk_scan_plain
from repro_torch.kernels.kq_decode import (
    combine_split_partials, kq_combine_splits, kq_decode_attention,
    kq_decode_attention_ref, kq_decode_paged_attention,
    kq_decode_paged_attention_int8_ref, kq_decode_paged_attention_ref,
    kq_decode_paged_attention_split_ref, kq_decode_paged_int8,
    kq_decode_paged_int8_split, kq_decode_paged_partials_ref,
    kq_decode_paged_split, kq_prefill_paged_attention,
    kq_prefill_paged_attention_ref, resolve_splits)
from repro_torch.kernels.kq_decode import paged as paged_mod
from repro_torch.serving.page_layouts import quantize_int8
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,T,Rk,Rv,lengths", [
    (2, 8, 2, 128, 32, 16, (101, 7)),
    (3, 4, 2, 100, 16, 16, (100, 37, 1)),
    (8, 32, 4, 1024, 37, 45, (1, 31, 32, 33, 500, 777, 1023, 1024)),
    (2, 32, 32, 300, 128, 128, (0, 299)),
    (2, 64, 4, 70, 256, 256, (70, 3)),              # m=16, widest ranks
    (3, 12, 4, 50, 5, 7, (50, 0, 9)),               # m=3
    # bf16 runs a cluster of 8 CTAs a group at T 1024, 8192: lengths at
    # the edges of its runs of 16-token tiles, and slots at T
    (8, 32, 4, 1024, 50, 42, (1, 15, 16, 17, 127, 128, 129, 1024)),
    (3, 32, 4, 8192, 50, 42, (8192, 129, 4000)),
    (2, 8, 2, 75, 5, 7, (75, 20)),     # 150-byte slots: copied bytewise
])
def test_k3_matches_plain_version(cuda, B, H, Hkv, T, Rk, Rv, lengths,
                                  dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    qc = torch.randn(B, H, Rk, generator=g, device=cuda).to(dtype)
    kc = torch.randn(B, Hkv, T, Rk, generator=g, device=cuda).to(dtype)
    vc = torch.randn(B, Hkv, T, Rv, generator=g, device=cuda).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = kq_decode_attention.launches
    out = kq_decode_attention(qc, kc, vc, lens, scale=0.25)
    torch.cuda.synchronize()
    assert kq_decode_attention.launches == before + 1
    _close_ulps(out, kq_decode_attention_ref(qc, kc, vc, lens, scale=0.25),
                dtype)


def _paged(dev, dtype, B, H, Hkv, ps, n_pages, Rk, Rv, S=None):
    """Pools, a block table of shuffled physical pages (never the garbage
    page 0) and queries: (B,H,Rk), or (B,H,S,Rk) for a chunk."""
    g = torch.Generator(device=dev).manual_seed(0)
    P = 1 + B * n_pages
    kp = torch.randn(P, Hkv, ps, Rk, generator=g, device=dev).to(dtype)
    vp = torch.randn(P, Hkv, ps, Rv, generator=g, device=dev).to(dtype)
    btab = (torch.randperm(P - 1, generator=g, device=dev) + 1).reshape(
        B, n_pages).to(torch.int32)
    shape = (B, H, Rk) if S is None else (B, H, S, Rk)
    return torch.randn(*shape, generator=g, device=dev).to(dtype), kp, vp, \
        btab


def _close(out, ref, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,ps,n_pages,Rk,Rv,lengths", [
    (5, 32, 4, 4, 256, 50, 42, (1, 3, 4, 5, 1023)),
    (6, 32, 4, 16, 64, 50, 42, (1, 15, 16, 17, 1023, 1024)),
    (5, 16, 2, 64, 16, 37, 45, (1, 63, 64, 65, 1023)),
    (2, 64, 4, 16, 8, 256, 256, (128, 3)),          # m=16, widest ranks
    (3, 12, 4, 4, 4, 5, 7, (16, 0, 9)),             # m=3, empty slot
    (2, 4, 4, 8, 4, 1, 1, (32, 17)),                # m=1, rank 1
    # lengths at the edges of bf16's cluster runs, a slot at t_cap, and
    # t_cap 8192 (512 pages of 16)
    (8, 32, 4, 16, 64, 50, 42, (1, 15, 16, 17, 127, 128, 129, 1024)),
    (3, 32, 4, 16, 512, 50, 42, (8192, 129, 4000)),
    (2, 8, 2, 1, 40, 3, 3, (40, 7)),   # pages of 1 row of 6 bytes
])
def test_k1_matches_plain_version(cuda, B, H, Hkv, ps, n_pages, Rk, Rv,
                                  lengths, dtype):
    qc, kp, vp, btab = _paged(cuda, dtype, B, H, Hkv, ps, n_pages, Rk, Rv)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = kq_decode_paged_attention.launches
    out = kq_decode_paged_attention(qc, kp, vp, lens, btab, scale=0.25)
    torch.cuda.synchronize()
    assert kq_decode_paged_attention.launches == before + 1
    _close_ulps(out, kq_decode_paged_attention_ref(qc, kp, vp, lens, btab,
                                                   scale=0.25), dtype)


# K2: float32 runs the shared CUDA-core body, bfloat16 the tensor-core one
# (csrc/kq_prefill.cuh: 64-row blocks, 64-key tiles split between two
# warpgroups, p.v widths 16..256, copy granules of 16, 8, 4 or 2 bytes by
# the ranks' alignment); every table is shuffled
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,ps,n_pages,Rk,Rv,pos0,n_valid", [
    (1, 32, 4, 256, 16, 64, 50, 42, (0,), (256,)),  # first full chunk
    (2, 32, 4, 64, 16, 64, 50, 42, (520, 8), (40, 64)),   # mid-page, padded
    (2, 8, 2, 8, 4, 16, 16, 16, (5, 13), (8, 5)),
    (2, 8, 2, 32, 64, 4, 16, 8, (0, 65), (32, 20)),
    (1, 64, 4, 4, 16, 4, 256, 256, (3,), (4,)),     # m=16, widest ranks
    (2, 12, 4, 5, 4, 8, 5, 7, (0, 7), (5, 2)),      # m=3: 15-row tiles
    (1, 8, 2, 16, 16, 64, 32, 32, (1008,), (15,)),  # ends at 1023
    # the main path's last chunk: 32 blocks of 64 rows a group, keys to
    # 1000 over 16 tiles of 64
    (1, 32, 4, 256, 16, 64, 50, 42, (768,), (232,)),
    # odd ranks (2-byte pool rows) at pages of 4; the second slot's chunk
    # is padding past its length in every row
    (2, 16, 2, 100, 4, 64, 37, 45, (60, 130), (100, 0)),
    (2, 12, 4, 90, 16, 16, 5, 7, (10, 0), (90, 33)),   # m=3, 270 rows
    (2, 4, 4, 70, 64, 4, 1, 1, (0, 3), (70, 9)),       # m=1, rank 1
    (1, 64, 4, 256, 16, 64, 256, 256, (3,), (256,)),   # m=16, 256 at S 256
    (1, 16, 1, 40, 4, 32, 40, 200, (11,), (33,)),      # m=16, Rv 200
])
def test_k2_matches_plain_version(cuda, B, H, Hkv, S, ps, n_pages, Rk, Rv,
                                  pos0, n_valid, dtype):
    qc, kp, vp, btab = _paged(cuda, dtype, B, H, Hkv, ps, n_pages, Rk, Rv,
                              S=S)
    p0 = torch.tensor(pos0, dtype=torch.int32, device=cuda)
    lens = p0 + torch.tensor(n_valid, dtype=torch.int32, device=cuda)
    before = kq_prefill_paged_attention.launches
    out = kq_prefill_paged_attention(qc, kp, vp, lens, p0, btab, scale=0.3)
    torch.cuda.synchronize()
    assert kq_prefill_paged_attention.launches == before + 1
    assert out.shape == (B, H, S, Rv) and out.dtype == dtype
    _close_ulps(out, kq_prefill_paged_attention_ref(qc, kp, vp, lens, p0,
                                                    btab, scale=0.3), dtype)


def _int8_pools(kp, vp):
    """int8 codes and (P,Hkv,ps,1) bf16 scales of fp pools."""
    (k8, ks), (v8, vs) = quantize_int8(kp), quantize_int8(vp)
    return k8, v8, ks[..., None].contiguous(), vs[..., None].contiguous()


SPLIT_CASES = [   # B, H, Hkv, ps, n_pages, Rk, Rv, lengths
    (5, 32, 4, 4, 256, 50, 42, (0, 3, 4, 5, 1023)),
    (6, 32, 4, 16, 64, 50, 42, (1, 15, 16, 17, 300, 1024)),
    (5, 16, 2, 64, 16, 37, 45, (1, 63, 64, 65, 1023)),
    (3, 12, 4, 4, 4, 5, 7, (16, 0, 9)),                 # m=3, empty slot
    (2, 4, 4, 8, 4, 1, 1, (32, 17)),                    # m=1, rank 1
    # lengths at the edges of bf16's cluster runs, a slot at t_cap, and
    # t_cap 8192 (512 pages of 16)
    (8, 32, 4, 16, 64, 50, 42, (1, 15, 16, 17, 127, 128, 129, 1024)),
    (3, 32, 4, 16, 512, 50, 42, (8192, 129, 4000)),
    # pages of 2: int8 pages of 10 bytes, copied bytewise
    (3, 8, 2, 2, 16, 5, 7, (0, 17, 32)),
]


@pytest.mark.parametrize("num_splits", [2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_k4_and_combine_match_plain_versions(cuda, case, dtype, num_splits):
    """K4's partials against their plain version, the combine against
    ``combine_split_partials``, and the split decode end to end against
    the plain split and the independent split oracle; short slots leave
    trailing splits empty."""
    B, H, Hkv, ps, n_pages, Rk, Rv, lengths = SPLIT_CASES[case]
    qc, kp, vp, btab = _paged(cuda, dtype, B, H, Hkv, ps, n_pages, Rk, Rv)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n, span = resolve_splits(num_splits, n_pages)
    before = (kq_decode_paged_split.launches, kq_combine_splits.launches)
    o, lse = kq_decode_paged_split(qc, kp, vp, lens, btab, span=span,
                                   n_splits=n, scale=0.25)
    o_ref, lse_ref = kq_decode_paged_partials_ref(
        qc, kp, vp, lens, btab, span=span, n_splits=n, scale=0.25)
    torch.cuda.synchronize()
    _close(o, o_ref, dtype)
    _close(lse, lse_ref, dtype)
    out = kq_combine_splits(o, lse, torch.empty(B, H, Rv, dtype=dtype,
                                                device=cuda))
    _close(out, combine_split_partials(o, lse).reshape(B, H, Rv), dtype)
    full = kq_decode_paged_attention(qc, kp, vp, lens, btab, scale=0.25,
                                     num_splits=num_splits)
    torch.cuda.synchronize()
    # bfloat16 merges its spans inside K4's launch, float32 launches the
    # merge after it
    assert (kq_decode_paged_split.launches,
            kq_combine_splits.launches) == (
                before[0] + 1 + (n > 1),
                before[1] + 1 + (n > 1 and dtype == torch.float32))
    _close(full, kq_decode_paged_attention_split_ref(
        qc, kp, vp, lens, btab, num_splits=num_splits, scale=0.25), dtype)
    _close(full, kq_decode_paged_attention_ref(qc, kp, vp, lens, btab,
                                               scale=0.25), dtype)


@pytest.mark.parametrize("num_splits", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_k5_matches_plain_version(cuda, case, dtype, num_splits):
    """K5, unsplit and split, over int8 pools (codes of 50 and 42 bytes
    a token are not 4-byte aligned) against the dequantize-first plain
    version."""
    B, H, Hkv, ps, n_pages, Rk, Rv, lengths = SPLIT_CASES[case]
    qc, kp, vp, btab = _paged(cuda, dtype, B, H, Hkv, ps, n_pages, Rk, Rv)
    k8, v8, ks, vs = _int8_pools(kp.float(), vp.float())
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    counter = kq_decode_paged_int8 if resolve_splits(
        num_splits, n_pages)[0] == 1 else kq_decode_paged_int8_split
    before = counter.launches
    out = kq_decode_paged_attention(qc, k8, v8, lens, btab, scale=0.25,
                                    num_splits=num_splits, kscale=ks,
                                    vscale=vs)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    _close_ulps(out, kq_decode_paged_attention_int8_ref(
        qc, k8, v8, ks, vs, lens, btab, scale=0.25), dtype)


def _arrivals_zero(dev):
    """Every arrival counter buffer of bf16 split decode on ``dev``
    reads back zero (the kernel's last CTA of each group resets its
    own)."""
    torch.cuda.synchronize()
    bufs = [b for (d, _), b in paged_mod._ARRIVALS.items() if d == dev]
    assert bufs and all(not bool(b.any()) for b in bufs)


def _two_launches(qc, kp, vp, lens, btab, num_splits, kw):
    """bf16 split decode the old way: the partials entry, then
    ``kq_combine_splits``."""
    n, span = resolve_splits(num_splits, btab.shape[1])
    split = kq_decode_paged_int8_split if kw else kq_decode_paged_split
    o, lse = split(qc, kp, vp, lens, btab, span=span, n_splits=n,
                   scale=0.25, **kw)
    return kq_combine_splits(o, lse, torch.empty(
        qc.shape[0], qc.shape[1], vp.shape[-1], dtype=qc.dtype,
        device=qc.device))


@pytest.mark.parametrize("num_splits", [2, 3, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["K4", "K5split"])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_fused_split_merge_equals_two_launches(cuda, case, quant,
                                               num_splits):
    """bf16 K4 and K5 split merge their spans in their own launch (the
    last CTA of each (slot, kv group) to arrive): one launch and no merge
    launch; the output is the two launches' (partials, then
    ``kq_combine_splits``) bit for bit, within 2e-2 and two bf16 ulps of
    the plain version; the arrival counters read back zero.  The cases
    cover empty trailing spans, length 0, the cluster-run edges, pages
    of 2, 4, 16 and 64 and t_cap 8192 (spans of 1,024 tokens: clusters
    of 8, 64 arrivals a group)."""
    dt = torch.bfloat16
    B, H, Hkv, ps, n_pages, Rk, Rv, lengths = SPLIT_CASES[case]
    qc, kp, vp, btab = _paged(cuda, dt, B, H, Hkv, ps, n_pages, Rk, Rv)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kw = {}
    if quant:
        kp, vp, ks, vs = _int8_pools(kp.float(), vp.float())
        kw = dict(kscale=ks, vscale=vs)
    assert resolve_splits(num_splits, n_pages)[0] > 1
    split = kq_decode_paged_int8_split if quant else kq_decode_paged_split
    before = (split.launches, kq_combine_splits.launches)
    fused = kq_decode_paged_attention(qc, kp, vp, lens, btab, scale=0.25,
                                      num_splits=num_splits, **kw)
    assert (split.launches, kq_combine_splits.launches) == \
        (before[0] + 1, before[1])
    _arrivals_zero(cuda)
    assert torch.equal(fused, _two_launches(qc, kp, vp, lens, btab,
                                            num_splits, kw))
    ref = (kq_decode_paged_attention_int8_ref(qc, kp, vp, ks, vs, lens,
                                              btab, scale=0.25) if quant
           else kq_decode_paged_attention_ref(qc, kp, vp, lens, btab,
                                              scale=0.25))
    _close_ulps(fused, ref, dt)


@pytest.mark.parametrize("quant", [False, True], ids=["K4", "K5split"])
@pytest.mark.parametrize("shape", ["main", "t_cap 8192"])
def test_fused_split_merge_is_repeatable(cuda, shape, quant):
    """200 calls of the fused bf16 split decode give the same bits
    whichever CTA arrives last, and leave the counters zero: at phase
    4's shape (8 slots of 64 pages of 16, 8 splits, a CTA a span) and at
    t_cap 8192 (8 CTAs a span)."""
    dt = torch.bfloat16
    B, n_pages, lengths = (
        (8, 64, (1, 31, 32, 33, 500, 777, 1023, 1024)) if shape == "main"
        else (3, 512, (8192, 129, 4000)))
    qc, kp, vp, btab = _paged(cuda, dt, B, 32, 4, 16, n_pages, 50, 42)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kw = {}
    if quant:
        kp, vp, ks, vs = _int8_pools(kp.float(), vp.float())
        kw = dict(kscale=ks, vscale=vs)
    outs = [kq_decode_paged_attention(qc, kp, vp, lens, btab, scale=0.25,
                                      num_splits=8, **kw)
            for _ in range(200)]
    _arrivals_zero(cuda)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.equal(outs[0], _two_launches(qc, kp, vp, lens, btab, 8,
                                              kw))


@pytest.mark.parametrize("quant", [False, True], ids=["K4", "K5split"])
def test_fused_split_merge_on_a_side_stream(cuda, quant):
    """On a side stream the fused split decode takes counters of its
    own (one buffer per (device, stream)) and gives the default
    stream's answer; both streams' counters read back zero."""
    dt = torch.bfloat16
    qc, kp, vp, btab = _paged(cuda, dt, 6, 32, 4, 16, 64, 50, 42)
    lens = torch.tensor((0, 1, 17, 300, 1023, 1024), dtype=torch.int32,
                        device=cuda)
    kw = {}
    if quant:
        kp, vp, ks, vs = _int8_pools(kp.float(), vp.float())
        kw = dict(kscale=ks, vscale=vs)
    main = kq_decode_paged_attention(qc, kp, vp, lens, btab, scale=0.25,
                                     num_splits=8, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = kq_decode_paged_attention(qc, kp, vp, lens, btab,
                                          scale=0.25, num_splits=8, **kw)
    torch.cuda.current_stream().wait_stream(side)
    assert (cuda, side.cuda_stream) in paged_mod._ARRIVALS
    assert (paged_mod._ARRIVALS[(cuda, side.cuda_stream)].data_ptr()
            != paged_mod._ARRIVALS[
                (cuda, torch.cuda.current_stream().cuda_stream)].data_ptr())
    _arrivals_zero(cuda)
    assert torch.equal(main, other)


@pytest.mark.parametrize("kernel", ["K1", "K3", "K4", "K5", "K5 split"])
def test_decode_ignores_rows_it_must_not_read(cuda, kernel):
    """bf16 decode over caches whose rows past each length, page 0 (the
    garbage page) and pages outside the table hold NaN: the output is
    finite and equals the plain version's on the same caches with those
    rows set to 0.  Lengths end mid-page and mid-tile (a 16-token tile
    runs past them), and one slot is empty."""
    dt = torch.bfloat16
    B, H, Hkv, ps, n_pages, Rk, Rv = 4, 32, 4, 16, 64, 50, 42
    lens = torch.tensor([0, 17, 500, 1023], dtype=torch.int32, device=cuda)
    qc, kp, vp, btab = _paged(cuda, dt, B, H, Hkv, ps, n_pages, Rk, Rv)
    if kernel == "K3":            # the dense cache: (B, Hkv, T, R)
        from repro_torch.serving import gather_pages
        kp, vp = gather_pages(kp, btab).contiguous(), \
            gather_pages(vp, btab).contiguous()
        dead = (torch.arange(kp.shape[2], device=cuda)[None, :]
                >= lens[:, None].long())[:, None, :, None]
    else:
        # pad the pools with pages no table names, then mark each pool
        # row dead unless it holds a live token of some slot
        spare = torch.randn(3, Hkv, ps, Rk + Rv, device=cuda).to(dt)
        kp = torch.cat([kp, spare[..., :Rk]]).contiguous()
        vp = torch.cat([vp, spare[..., Rk:]]).contiguous()
        live = torch.zeros(kp.shape[0], ps, dtype=torch.bool)
        for b, n in enumerate(lens.tolist()):
            t = torch.arange(n)
            live[btab[b].cpu()[t // ps], t % ps] = True
        dead = ~live.to(cuda)[:, None, :, None]
    kn, vn = (x.masked_fill(dead, float("nan")) for x in (kp, vp))
    kz, vz = (x.masked_fill(dead, 0.0) for x in (kp, vp))
    if kernel == "K3":
        out = kq_decode_attention(qc, kn, vn, lens, scale=0.25)
        ref = kq_decode_attention_ref(qc, kz, vz, lens, scale=0.25)
    elif kernel in ("K1", "K4"):
        ns = 1 if kernel == "K1" else 8
        out = kq_decode_paged_attention(qc, kn, vn, lens, btab, scale=0.25,
                                        num_splits=ns)
        ref = kq_decode_paged_attention_ref(qc, kz, vz, lens, btab,
                                            scale=0.25)
        if ns > 1:          # the fused merge, bit for bit the two launches
            assert torch.equal(out, _two_launches(qc, kn, vn, lens, btab,
                                                  ns, {}))
    else:
        # int8 codes and scales of the clean pools; the dead rows' scales
        # are NaN (their codes have no NaN)
        k8, v8, ks, vs = _int8_pools(kz.float(), vz.float())
        ksn, vsn = (x.masked_fill(dead, float("nan")) for x in (ks, vs))
        ns = 1 if kernel == "K5" else 8
        out = kq_decode_paged_attention(qc, k8, v8, lens, btab, scale=0.25,
                                        num_splits=ns, kscale=ksn,
                                        vscale=vsn)
        ref = kq_decode_paged_attention_int8_ref(qc, k8, v8, ks, vs, lens,
                                                 btab, scale=0.25)
        if ns > 1:
            assert torch.equal(out, _two_launches(
                qc, k8, v8, lens, btab, ns, dict(kscale=ksn, vscale=vsn)))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    _close_ulps(out, ref, dt)


def test_k5_raises_on_groups_past_eight(cuda):
    qc, kp, vp, btab = _paged(cuda, torch.float32, 1, 16, 1, 4, 2, 8, 8)
    k8, v8, ks, vs = _int8_pools(kp, vp)
    with pytest.raises(ValueError):
        kq_decode_paged_int8(qc, k8, v8, ks, vs,
                             torch.tensor([5], dtype=torch.int32,
                                          device=cuda), btab)


def test_paged_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    qc, kp, vp, btab = _paged(cuda, torch.float32, 2, 8, 2, 4, 4, 8, 8)
    lens = torch.tensor([3, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kq_decode_paged_attention(qc, kp, vp, lens.long(), btab)
    with pytest.raises(ValueError):
        kq_decode_paged_attention(qc, kp, vp, lens, btab.cpu())
    with pytest.raises(ValueError):
        kq_prefill_paged_attention(qc[:, :, None].expand(2, 8, 3, 8), kp,
                                   vp, lens, lens - 1, btab)
    # bf16 K2 (its own body) refuses what its shared checks refuse
    qb, kb, vb = (t.to(torch.bfloat16) for t in (qc, kp, vp))
    q4 = qb[:, :, None].expand(2, 8, 3, 8).contiguous()
    kq_prefill_paged_attention(q4, kb, vb, lens, lens - 1, btab)   # runs
    with pytest.raises(TypeError):                  # int64 pos0
        kq_prefill_paged_attention(q4, kb, vb, lens, (lens - 1).long(), btab)
    with pytest.raises(TypeError):                  # float32 pools
        kq_prefill_paged_attention(q4, kp, vp, lens, lens - 1, btab)
    with pytest.raises(ValueError):                 # group 32 > MAX_GROUP
        kq_prefill_paged_attention(
            qb.repeat(1, 8, 1)[:, :, None].expand(2, 64, 3, 8)
            .contiguous(), kb, vb, lens, lens - 1, btab)
    with pytest.raises(ValueError):                 # rank 257 > MAX_RANK
        kq_prefill_paged_attention(
            torch.zeros(2, 8, 3, 257, dtype=torch.bfloat16, device=cuda),
            torch.zeros(9, 2, 4, 257, dtype=torch.bfloat16, device=cuda),
            vb, lens, lens - 1, btab)


@pytest.mark.parametrize("extra,cfg_kw", [
    ({}, {}),
    (dict(cache_quant="int8", decode_splits=0, max_seq_len=64), {}),
    (dict(cache_quant="svdq", decode_splits=3), {}),
    (dict(paged=False, chunked_prefill=False), {"cache_quant": "int8"}),
], ids=["fp", "int8-dynamic-splits", "svdq-splits3", "dense-int8"])
def test_reduced_paged_engine_card_matches_cpu(cuda, extra, cfg_kw):
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              **cfg_kw)
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, cuda)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = tree_to(p_cpu, cuda)
    mp = calibrate_model(cpu, p_cpu,
                         calibration_batches(cfg.vocab_size, 8, 32, batch=4),
                         CompressionConfig(method="kqsvd", epsilon=0.1))
    prompts = [np.random.default_rng(i).integers(
        0, cfg.vocab_size, L).astype(np.int32)
        for i, L in enumerate((5, 19, 9))]
    served = []
    for m, p in ((cpu, p_cpu), (gpu, p_gpu)):
        eng = ServingEngine(cfg, p, ServeConfig(**{
            **dict(max_seq_len=32, max_batch=2, decode_chunk=4, paged=True,
                   page_size=4, chunked_prefill=True, prefill_chunk=8),
            **extra}), projections=mp, device=m.device)
        rs = [Request(rid=i, prompt=q, max_new_tokens=6)
              for i, q in enumerate(prompts)]
        eng.generate(rs)
        if eng.pool is not None:
            assert eng.pool.free_count == eng.pool.n_pages
        served.append([r.out_tokens for r in rs])
    assert served[0] == served[1]


def test_reduced_model_card_matches_cpu(cuda):
    cfg = get_config("tinyllama-1.1b").reduced()
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, cuda)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = tree_to(p_cpu, cuda)
    mp = calibrate_model(cpu, p_cpu,
                         calibration_batches(cfg.vocab_size, 8, 32, batch=4),
                         CompressionConfig(method="kqsvd", epsilon=0.1))
    prompts = [np.random.default_rng(i).integers(
        0, cfg.vocab_size, L).astype(np.int32) for i, L in enumerate((5, 9))]
    served = []
    for m, p in ((cpu, p_cpu), (gpu, p_gpu)):
        eng = ServingEngine(cfg, p, ServeConfig(max_seq_len=32, max_batch=2,
                                                decode_chunk=4),
                            projections=mp, device=m.device)
        rs = [Request(rid=i, prompt=q, max_new_tokens=6)
              for i, q in enumerate(prompts)]
        eng.generate(rs)
        served.append([r.out_tokens for r in rs])
    assert served[0] == served[1]


# K6: S in {1, 63, 64, 65, 1000} against every window edge (none, 1, 16,
# S-1, S, 2S); the cases cycle through every (dh, dv) pair the kernel
# takes and, independently, the groups m in {1, 2, 3, 4, 8} (m 3:
# smollm-360m's group, whose rows do not tile a block in whole positions)
FLASH_CASES = [(S, w) for S in (1, 63, 64, 65, 1000)
               for w in sorted({0, 1, 16, max(S - 1, 0), S, 2 * S})]
FLASH_GROUPS = [((1, 2, 3, 4, 8)[i % 5],) + HEAD_DIMS[i % len(HEAD_DIMS)]
                for i in range(len(FLASH_CASES))]


def _flash_inputs(dev, dtype, B, H, Hkv, S, dh, dv=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, h, S, d, generator=g, device=dev).to(dtype)
            for h, d in ((H, dh), (Hkv, dh), (Hkv, dv or dh))]


def _close_ulps(out, ref, dtype):
    """The reference tolerance and, in bf16, two ulps of the plain
    version's output (both accumulate in f32)."""
    _close(out, ref, dtype)
    if dtype == torch.bfloat16:
        err = (out.float() - ref.float()).abs()
        assert bool((err <= 1e-4 + 8e-3 * ref.float().abs()).all()), \
            float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(FLASH_CASES)))
def test_k6_matches_plain_version(cuda, case, dtype):
    S, window = FLASH_CASES[case]
    m, dh, dv = FLASH_GROUPS[case]
    B, Hkv = (1, 2) if S > 100 else (2, 2)
    q, k, v = _flash_inputs(cuda, dtype, B, Hkv * m, Hkv, S, dh, dv,
                            seed=case)
    before = flash_attention.launches
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == (B, Hkv * m, S, dv) and out.dtype == dtype
    _close_ulps(out, flash_attention_ref(q, k, v, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(False, 0), (False, 24)])
def test_k6_without_causal_mask(cuda, causal, window, dtype):
    q, k, v = _flash_inputs(cuda, dtype, 2, 8, 2, 97, 64)
    out = flash_attention(q, k, v, causal=causal, window=window, scale=0.2)
    _close_ulps(out, flash_attention_ref(q, k, v, causal=causal,
                                         window=window, scale=0.2), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,dv", [(80, 80), (24, 16)])
def test_k6_reads_strided_views(cuda, dh, dv, dtype):
    """q/k/v as the model's projections leave them, (B,S,H,d) memory
    seen as (B,H,S,d): the kernel reads them through their strides."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 77, h, d, generator=g, device=cuda)
               .to(dtype).transpose(1, 2)
               for h, d in ((16, dh), (4, dh), (4, dv)))
    assert not q.is_contiguous()
    out = flash_attention(q, k, v, window=30)
    _close_ulps(out, flash_attention_ref(q, k, v, window=30), dtype)


def test_k6_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v = _flash_inputs(cuda, torch.float32, 1, 4, 2, 16, 64)
    with pytest.raises(TypeError):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="head dims"):   # (12, 12)
        flash_attention(*_flash_inputs(cuda, torch.float32, 1, 4, 2, 16, 12))
    with pytest.raises(ValueError):                 # non-contiguous last dim
        flash_attention(q.transpose(2, 3)[:, :, :16, :16].contiguous()
                        .transpose(2, 3), k[..., :16], v[..., :16])
    with pytest.raises(ValueError):                 # 3 query heads on 2
        flash_attention(q[:, :3], k, v)
    # a bfloat16 view whose base is 8 bytes past a 16-byte boundary
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    shifted = torch.empty(qb.numel() + 4, dtype=torch.bfloat16,
                          device=cuda)[4:].view(qb.shape)
    shifted.copy_(qb)
    assert shifted.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(shifted, kb, vb)
    flash_attention(qb, kb, vb)                     # the aligned twin runs


@pytest.mark.parametrize("method,cache_quant", [
    ("none", "none"), ("kqsvd", "none"), ("kqsvd", "int8")],
    ids=["full", "kqsvd", "kqsvd-dense-int8"])
def test_reduced_window_engine_card_matches_cpu(cuda, method, cache_quant):
    """Reduced h2o-danube-1.8b (window 16) on dense slots: prompts past
    and inside the window, decode wrapping the ring; K6's window branch
    under prefill and calibration on the card."""
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b").reduced(),
                              cache_quant=cache_quant)
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, cuda)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = tree_to(p_cpu, cuda)
    mp = (calibrate_model(cpu, p_cpu,
                          calibration_batches(cfg.vocab_size, 8, 32, batch=4),
                          CompressionConfig(method="kqsvd", epsilon=0.1))
          if method != "none" else None)
    prompts = [np.random.default_rng(i).integers(
        0, cfg.vocab_size, L).astype(np.int32)
        for i, L in enumerate((9, 40, 17))]
    before = flash_attention.launches
    served = []
    for m, p in ((cpu, p_cpu), (gpu, p_gpu)):
        eng = ServingEngine(cfg, p, ServeConfig(max_seq_len=64, max_batch=2,
                                                decode_chunk=4),
                            projections=mp, device=m.device)
        rs = [Request(rid=i, prompt=q, max_new_tokens=10)
              for i, q in enumerate(prompts)]
        eng.generate(rs)
        served.append([r.out_tokens for r in rs])
    assert flash_attention.launches == before + cfg.n_layers * len(prompts)
    assert served[0] == served[1]


# K7: the reference sweep's shapes (B, nh, G, S, hd, n, chunk), reduced
# mamba2 with a ragged last chunk, mamba2's full head at a ragged length
# and jamba's head, each with and without an initial state
SSD_CASES = [(2, 4, 2, 64, 8, 16, 16), (1, 2, 1, 128, 16, 8, 32),
             (2, 2, 2, 64, 8, 8, 64), (2, 8, 1, 70, 16, 16, 32),
             (1, 4, 1, 300, 64, 128, 256), (1, 2, 1, 130, 128, 64, 256),
             (3, 4, 2, 1, 16, 16, 32),
             (1, 80, 1, 4097, 64, 128, 256),    # mamba2's head, ragged
             (2, 8, 2, 200, 64, 128, 64),       # G 2, 4 heads a group
             (1, 4, 1, 50, 16, 8, 1),           # chunks of 1 token
             (2, 4, 2, 123, 64, 128, 17),       # chunks of no tile multiple
             (1, 2, 1, 333, 128, 64, 100),
             (2, 4, 1, 0, 16, 16, 32)]          # S 0: the state passes
# cases that ask y in float32, as the model does (models/ssm.py): held at
# 1e-4 + 1e-4 |ref| whatever the input type
SSD_Y_F32 = {7}


def _ssd_inputs(dev, dtype, B, nh, G, S, hd, n, seed=0):
    """The sweep's laws: x, B, C normal in ``dtype``; dt = softplus of a
    normal, A = -exp(normal / 2), a = dt * A, float32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, nh, S, hd, generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, nh, S, generator=g, device=dev))
    A = -torch.exp(torch.randn(nh, generator=g, device=dev) * 0.5)
    Bm, Cm = (torch.randn(B, G, S, n, generator=g, device=dev).to(dtype)
              for _ in range(2))
    return x, dt * A[None, :, None], dt, Bm, Cm


def _close_ssd(y, h, y_ref, h_ref, dtype):
    """y: 1e-4 + 1e-4 |ref| in float32 (``dtype``, y's type), two bf16
    ulps in bfloat16; the
    f32 state at 1e-4 + 1e-4 |ref| (kernel and plain version add in other
    orders: block prefix sum against torch.cumsum, tiles against
    matmuls)."""
    if dtype == torch.bfloat16:
        _close_ulps(y, y_ref, dtype)
    else:
        err = (y - y_ref).abs()
        assert bool((err <= 1e-4 + 1e-4 * y_ref.abs()).all()), \
            float(err.max())
    err = (h - h_ref).abs()
    assert bool((err <= 1e-4 + 1e-4 * h_ref.abs()).all()), float(err.max())


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(SSD_CASES)))
def test_k7_matches_plain_version(cuda, case, dtype, with_h0):
    """bfloat16 runs the chunk-parallel tensor-core body (three kernels,
    one count), float32 the f32 body; y in x's type, or in float32 for the
    cases of ``SSD_Y_F32``."""
    B, nh, G, S, hd, n, ck = SSD_CASES[case]
    x, a, dt, Bm, Cm = _ssd_inputs(cuda, dtype, B, nh, G, S, hd, n, case)
    h0 = (torch.randn(B, nh, n, hd, device=cuda) if with_h0 else None)
    out_dtype = torch.float32 if case in SSD_Y_F32 else None
    before = ssd_chunk_scan.launches
    y, h = ssd_chunk_scan(x, a, dt, Bm, Cm, chunk=ck, h0=h0,
                          out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ssd_chunk_scan.launches == before + 1
    assert y.shape == x.shape and y.dtype == (out_dtype or dtype)
    assert h.shape == (B, nh, n, hd) and h.dtype == torch.float32
    y_ref, h_ref = ssd_chunk_scan_plain(x, a, dt, Bm, Cm, chunk=ck, h0=h0,
                                        out_dtype=out_dtype)
    _close_ssd(y, h, y_ref, h_ref, y.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_reads_model_views(cuda, dtype):
    """x, B and C as slices of the conv output (B, S, conv_dim), a and dt
    as (B, S, nh) seen through transposes, y asked for in float32: the
    model's call."""
    B, S, nh, hd, G, n = 2, 77, 8, 16, 1, 16
    g = torch.Generator(device=cuda).manual_seed(5)
    xbc = torch.randn(B, S, nh * hd + 2 * G * n, generator=g,
                      device=cuda).to(dtype)
    x = xbc[..., :nh * hd].reshape(B, S, nh, hd).transpose(1, 2)
    Bm = xbc[..., nh * hd:nh * hd + G * n].reshape(B, S, G, n).transpose(1, 2)
    Cm = xbc[..., nh * hd + G * n:].reshape(B, S, G, n).transpose(1, 2)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, nh, generator=g, device=cuda))
    a = dt * -torch.exp(torch.randn(nh, generator=g, device=cuda))
    args = (x, a.transpose(1, 2), dt.transpose(1, 2), Bm, Cm)
    assert not x.is_contiguous()
    y, h = ssd_chunk_scan(*args, chunk=32, out_dtype=torch.float32)
    assert y.dtype == torch.float32 and y.transpose(1, 2).is_contiguous()
    y_ref, h_ref = ssd_chunk_scan_plain(*args, chunk=32,
                                        out_dtype=torch.float32)
    _close_ssd(y, h, y_ref, h_ref, torch.float32)


def test_k7_raises_on_what_the_kernel_does_not_take(cuda):
    x, a, dt, Bm, Cm = _ssd_inputs(cuda, torch.float32, 1, 4, 2, 16, 16, 16)
    before = ssd_chunk_scan.launches
    with pytest.raises(TypeError):                  # mixed input types
        ssd_chunk_scan(x, a, dt, Bm.to(torch.bfloat16), Cm)
    with pytest.raises(TypeError):                  # a in bfloat16
        ssd_chunk_scan(x, a.to(torch.bfloat16), dt, Bm, Cm)
    with pytest.raises(ValueError):                 # (hd, n) = (32, 16)
        ssd_chunk_scan(*_ssd_inputs(cuda, torch.float32, 1, 4, 2, 16, 32,
                                    16))
    with pytest.raises(ValueError):                 # chunk past 256
        ssd_chunk_scan(x, a, dt, Bm, Cm, chunk=512)
    with pytest.raises(ValueError):                 # 3 heads on 2 groups
        ssd_chunk_scan(x[:, :3], a[:, :3], dt[:, :3], Bm, Cm)
    assert ssd_chunk_scan.launches == before


def test_reduced_mamba2_engine_card_matches_cpu(cuda):
    """Reduced mamba2-2.7b on dense slots: prompts of 1..70 tokens, ragged
    at chunk 32; K7 once per layer per prefill on the card, the same
    greedy tokens as the CPU."""
    cfg = get_config("mamba2-2.7b").reduced()
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, cuda)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = tree_to(p_cpu, cuda)
    prompts = [np.random.default_rng(i).integers(
        0, cfg.vocab_size, L).astype(np.int32)
        for i, L in enumerate((1, 31, 33, 70))]
    before = ssd_chunk_scan.launches
    served = []
    for m, p in ((cpu, p_cpu), (gpu, p_gpu)):
        eng = ServingEngine(cfg, p, ServeConfig(max_seq_len=96, max_batch=2,
                                                decode_chunk=4),
                            device=m.device)
        rs = [Request(rid=i, prompt=q, max_new_tokens=8)
              for i, q in enumerate(prompts)]
        eng.generate(rs)
        served.append([r.out_tokens for r in rs])
    assert ssd_chunk_scan.launches == before + cfg.n_layers * len(prompts)
    assert served[0] == served[1]
