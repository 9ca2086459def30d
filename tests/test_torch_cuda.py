"""The port on the card: each CUDA kernel (K3, K1, K2, K4, K5, the
split combine, K6 and K7) against its plain PyTorch version, bf16 split
decode's in-launch merge against the two launches it replaces, and the
reduced model on the card against the CPU on the dense and the paged
chunked engines, also with int8 pages and split-KV decode, with the dense
int8 cache, under optimistic admission (recompute and swap), with int8
prefix sharing under swap, under fault injection, under the token
budget, with the sliding-window ring cache and with mamba2's SSM state;
MoE dispatch at deepseek-v2-lite's and arctic's expert counts (keep
masks equal where capacity binds) and reduced deepseek-v2-lite's MLA
prefill, decode and dense-slot engine on the card against the CPU;
reduced jamba's prefill, decode and engine and reduced phi-3-vision's
image-prefix prefill and decode on the card against the CPU;
a copy-on-write fork on the card copying every leaf byte for byte, a
budget step's fused chunk launching K2 before the decode chunk's K1 with
one host sync, and the NaN quarantine of a device logit row; the
sharded engine with a shard on every card against the CPU; K6 and K7
under autograd (the kernel forward, the plain backward) against autograd
through their plain versions, a bfloat16 checkpoint of card tensors, a
trainer whose kernel build fails raising at once, and training on a
(2, 2) mesh of four cards against one card.  Marked
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
from repro_torch.kernels.flash import (flash_attention,
                                       flash_attention_backward,
                                       flash_attention_ref,
                                       flash_attention_train)
from repro_torch.kernels.flash.flash import HEAD_DIMS
from repro_torch.kernels.ssd import (ssd_chunk_scan, ssd_chunk_scan_backward,
                                     ssd_chunk_scan_plain,
                                     ssd_chunk_scan_train)
from repro_torch.kernels.kq_decode import (
    combine_split_partials, kq_combine_splits, kq_decode_attention,
    kq_decode_attention_ref, kq_decode_attention_span,
    kq_decode_attention_span_ref, kq_decode_paged_attention,
    kq_decode_paged_attention_int8_ref, kq_decode_paged_attention_ref,
    kq_decode_paged_attention_split_ref, kq_decode_paged_int8,
    kq_decode_paged_int8_split, kq_decode_paged_partials_ref,
    kq_decode_paged_split, kq_prefill_paged_attention,
    kq_prefill_paged_attention_ref, resolve_splits)
from repro_torch.kernels.kq_decode import paged as paged_mod
from repro_torch.serving.page_layouts import quantize_int8
from repro_torch.models import build_model
from repro_torch.models import attention as attention_mod
from repro_torch.serving import (RECOVERABLE_POINTS, FaultInjector, Request,
                                 ServingEngine, checksum)

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,T,Rk,Rv,lengths", [
    (8, 32, 4, 256, 50, 42, (0, 0, 1, 31, 200, 256, 256, 256)),
    (8, 32, 4, 1024, 50, 42, (544,) * 8),
    (3, 15, 5, 128, 32, 32, (0, 128, 77)),          # smollm's m = 3
    (2, 64, 4, 70, 256, 256, (70, 0)),              # m = 16, widest ranks
])
def test_k3_span_matches_plain_version(cuda, B, H, Hkv, T, Rk, Rv, lengths,
                                       dtype):
    """K3's span output (rows and LSE, float32) against its plain version,
    an empty span (length 0) giving a zero row and an LSE of -1e30 +
    log(1e-30); one launch counted on the span wrapper, none on K3's."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qc = torch.randn(B, H, Rk, generator=g, device=cuda).to(dtype)
    kc = torch.randn(B, Hkv, T, Rk, generator=g, device=cuda).to(dtype)
    vc = torch.randn(B, Hkv, T, Rv, generator=g, device=cuda).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = (kq_decode_attention_span.launches, kq_decode_attention.launches)
    out, lse = kq_decode_attention_span(qc, kc, vc, lens, scale=0.25)
    torch.cuda.synchronize()
    assert (kq_decode_attention_span.launches,
            kq_decode_attention.launches) == (before[0] + 1, before[1])
    assert out.dtype == lse.dtype == torch.float32
    ref_out, ref_lse = kq_decode_attention_span_ref(qc, kc, vc, lens,
                                                    scale=0.25)
    _close_ulps(out, ref_out, dtype)
    live = lens > 0
    np.testing.assert_allclose(lse[live].cpu().numpy(),
                               ref_lse[live].cpu().numpy(), rtol=1e-5,
                               atol=1e-4 if dtype == torch.float32 else 2e-2)
    assert bool((out[~live] == 0).all())
    assert bool((lse[~live] <= -1e29).all())
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_half_spans_merge_to_one_whole_call(cuda, dtype):
    """Two half spans of a cache, each through K3's span output, merged by
    their LSE (``combine_split_partials``) give one whole-cache K3 call's
    output: rows whose length ends in the first half (the second half
    empty), straddles the cut, or fills both."""
    g = torch.Generator(device=cuda).manual_seed(1)
    B, H, Hkv, T, Rk, Rv = 8, 32, 4, 1024, 50, 42
    qc = torch.randn(B, H, Rk, generator=g, device=cuda).to(dtype)
    kc = torch.randn(B, Hkv, T, Rk, generator=g, device=cuda).to(dtype)
    vc = torch.randn(B, Hkv, T, Rv, generator=g, device=cuda).to(dtype)
    lens = torch.tensor([1, 31, 511, 512, 513, 777, 1023, 1024],
                        dtype=torch.int32, device=cuda)
    whole = kq_decode_attention(qc, kc, vc, lens, scale=0.125)
    parts = [kq_decode_attention_span(
        qc, kc[:, :, t0:t0 + T // 2].contiguous(),
        vc[:, :, t0:t0 + T // 2].contiguous(),
        (lens - t0).clamp(0, T // 2).to(torch.int32), scale=0.125)
        for t0 in (0, T // 2)]
    merged = combine_split_partials(torch.stack([o for o, _ in parts], -3),
                                    torch.stack([s for _, s in parts], -2))
    torch.cuda.synchronize()
    _close_ulps(merged.to(dtype), whole, dtype)


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


OPTIMISTIC = dict(n_pages=8, admission="optimistic", watermark_low=0.1)
INT8_SHARE = dict(cache_quant="int8", share_prefix=True,
                  admission="optimistic", preempt_mode="swap",
                  watermark_low=0.1)


@pytest.mark.parametrize("extra,cfg_kw,counts", [
    ({}, {}, {}),
    (dict(cache_quant="int8", decode_splits=0, max_seq_len=64), {}, {}),
    (dict(cache_quant="svdq", decode_splits=3), {}, {}),
    (dict(paged=False, chunked_prefill=False), {"cache_quant": "int8"}, {}),
    (dict(OPTIMISTIC, preempt_mode="recompute"), {}, {"n_preempted": 2}),
    (dict(OPTIMISTIC, preempt_mode="swap"), {},
     {"n_preempted": 2, "n_swapped_out": 2, "n_swapped_in": 2}),
    (dict(INT8_SHARE, n_pages=4), {},
     {"n_shared_pages": 7, "n_preempted": 2, "n_swapped_in": 2}),
    (dict(INT8_SHARE, n_pages=6), {},
     {"n_shared_pages": 11, "n_cow_forks": 1, "n_full_hits": 1}),
], ids=["fp", "int8-dynamic-splits", "svdq-splits3", "dense-int8",
        "optimistic-recompute", "optimistic-swap", "int8-share-swap",
        "int8-share-cow"])
def test_reduced_paged_engine_card_matches_cpu(cuda, extra, cfg_kw, counts):
    """The card's tokens equal the CPU's on each engine; under
    preemption (8 pages of 4 for worst cases of up to 7) and int8 prefix
    sharing with swap (prompts sharing a 13-token prefix, the last a
    duplicate) they also equal the engine's without pressure or sharing,
    and both sides count the same preemptions, swaps, shares and forks
    (the CPU's counts, pinned)."""
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
    if extra.get("share_prefix"):
        pre = prompts[1][:13]
        prompts = [np.concatenate([pre, t]) for t in (
            prompts[0][:3], prompts[2][:5], prompts[0][:1], prompts[2][:5])]
    base = dict(max_seq_len=32, max_batch=2, decode_chunk=4, paged=True,
                page_size=4, chunked_prefill=True, prefill_chunk=8)
    served = []
    runs = [(cpu, p_cpu, extra), (gpu, p_gpu, extra)]
    if counts:                          # the same requests, no pressure
        runs.append((cpu, p_cpu, {k: v for k, v in extra.items()
                                  if k == "cache_quant"}))
    for m, p, kw in runs:
        eng = ServingEngine(cfg, p, ServeConfig(**{**base, **kw}),
                            projections=mp, device=m.device)
        rs = [Request(rid=i, prompt=q, max_new_tokens=6)
              for i, q in enumerate(prompts)]
        eng.generate(rs)
        if eng.pool is not None:
            pinned = eng._pindex.n_pinned if eng._pindex else 0
            assert eng.pool.free_count + pinned == eng.pool.n_pages
        if kw is extra:
            for name, n in counts.items():
                assert getattr(eng, name) == n, (m.device, name)
        served.append([r.out_tokens for r in rs])
    assert served[0] == served[1]
    assert all(s == served[0] for s in served[2:])


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_sharded_engine_on_every_card_matches_cpu(cuda, quant):
    """The sharded engine with one shard a card (every card the machine
    has; two shards on the one card of a one-card machine), fp pages or
    int8 pages with dynamic splits: each worker's cache, params and
    projections on its own card (one copy a card), every shard's K1 and
    K2 (K5) launched under its own device, and the greedy tokens equal
    the CPU's one-shard engine's on 12 requests over 8 slots."""
    n = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(n)] if n > 1
               else [cuda, cuda])
    S = len(devices)
    cfg = get_config("tinyllama-1.1b").reduced()
    cpu = build_model(cfg, "cpu")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    mp = calibrate_model(cpu, p_cpu,
                         calibration_batches(cfg.vocab_size, 8, 32, batch=4),
                         CompressionConfig(method="kqsvd", epsilon=0.1))
    prompts = [np.random.default_rng(20 + i).integers(
        0, cfg.vocab_size, L).astype(np.int32)
        for i, L in enumerate((3, 30, 5, 26, 4, 22, 6, 18, 5, 7, 9, 11))]
    kw = dict(max_seq_len=64, max_batch=8, decode_chunk=4, paged=True,
              page_size=4, n_pages=64, chunked_prefill=True,
              prefill_chunk=8)
    if quant == "int8":
        kw.update(cache_quant="int8", decode_splits=0)
    served = []
    for shards, place in ((1, {"device": "cpu"}), (S, {"devices": devices})):
        eng = ServingEngine(cfg, tree_to(p_cpu, devices[0]) if shards > 1
                            else p_cpu, ServeConfig(**kw, shards=shards),
                            projections=mp, **place)
        if shards > 1:
            seen = {}
            for w in eng.workers:
                assert w.device == devices[w._shard]
                assert w.params["embed"].device == w.device
                assert all(t.device == w.device for layer in w.proj
                           for t in layer.values())
                seen.setdefault(w.device, (w.params, w.proj))
                assert seen[w.device][0] is w.params \
                    and seen[w.device][1] is w.proj
        rs = [Request(rid=i, prompt=q, max_new_tokens=6)
              for i, q in enumerate(prompts)]
        for w in (kq_decode_paged_attention, kq_prefill_paged_attention,
                  kq_decode_paged_int8, kq_decode_paged_int8_split):
            w.launches = 0
        eng.generate(rs)
        assert eng.pool.free_count == eng.pool.n_pages
        served.append([r.out_tokens for r in rs])
    decode = (kq_decode_paged_attention.launches if quant == "none" else
              kq_decode_paged_int8.launches
              + kq_decode_paged_int8_split.launches)
    assert decode == cfg.n_layers * eng.n_decode_steps
    if quant == "none":
        assert kq_prefill_paged_attention.launches == \
            cfg.n_layers * eng.n_prefill_chunks
    assert all(w.n_completed > 0 for w in eng.workers)
    assert served[0] == served[1]


def test_cow_fork_on_card_copies_every_leaf(cuda):
    """On the card a copy-on-write fork copies every leaf of every layer,
    int8 codes and bf16 scale pools alike, byte for byte."""
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    mp = calibrate_model(model, params,
                         calibration_batches(cfg.vocab_size, 8, 32, batch=4),
                         CompressionConfig(method="kqsvd", epsilon=0.1))
    eng = ServingEngine(cfg, params, ServeConfig(
        max_seq_len=32, max_batch=2, decode_chunk=4, paged=True,
        page_size=4, chunked_prefill=True, prefill_chunk=8,
        cache_quant="int8"), projections=mp)
    eng.generate([Request(rid=i, prompt=np.arange(9 + i, dtype=np.int32),
                          max_new_tokens=4) for i in range(2)])
    (src,) = eng.pool.alloc(1)
    eng._btabs.assign(0, [src])
    eng.pool.share([src])
    before = eng._btabs.device()
    eng._cow_fork(0, 0)
    dst = int(eng._btabs.rows[0, 0])
    assert dst != src and eng._btabs.device() is not before
    assert int(eng._btabs.device()[0, 0]) == dst
    torch.cuda.synchronize()
    names = set()
    for layer in eng._cache:
        for name, pool in layer.items():
            names.add(name)
            assert pool.device.type == "cuda"
            assert torch.equal(pool[dst].view(torch.uint8),
                               pool[src].view(torch.uint8)), name
    assert names == {"kc", "kscale", "vc", "vscale"}


def _shared_prompts(vocab):
    """Four prompts behind a common 13-token prefix (as the int8 sharing
    cases above), and two fresh ones."""
    rng = np.random.default_rng(3)
    pre = rng.integers(0, vocab, 13)
    return [np.concatenate([pre, rng.integers(0, vocab, k)]).astype(
        np.int32) for k in (3, 5, 1, 5)] + [
        rng.integers(0, vocab, k).astype(np.int32) for k in (11, 14)]


def _card_and_cpu(cuda, quant=False):
    cfg = get_config("tinyllama-1.1b").reduced()
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, cuda)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    mp = calibrate_model(cpu, p_cpu,
                         calibration_batches(cfg.vocab_size, 8, 32, batch=4),
                         CompressionConfig(method="kqsvd", epsilon=0.1))
    return cfg, ((cpu, p_cpu), (gpu, tree_to(p_cpu, cuda))), mp


CHAOS_SC = dict(max_seq_len=32, max_batch=4, decode_chunk=4, paged=True,
                page_size=4, chunked_prefill=True, prefill_chunk=8,
                n_pages=9, admission="optimistic", preempt_mode="swap",
                watermark_low=0.1, share_prefix=True, audit=True)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_chaos_on_card_matches_cpu(cuda, quant):
    """Every recoverable point armed on its first hits, on CUDA tensors:
    the card fires what the CPU fires, hit for hit, recovers the same way
    (swap buffers corrupted in host memory fail their crc and recompute)
    and gives the CPU's tokens, which are the unfaulted engine's."""
    cfg, sides, mp = _card_and_cpu(cuda)
    prompts = _shared_prompts(cfg.vocab_size)
    # int8 pages: 5 fp-page units buy 8 physical pages, as tight
    sc = dict(CHAOS_SC, cache_quant=quant,
              n_pages=5 if quant == "int8" else CHAOS_SC["n_pages"])
    out = []
    for (m, p), faults in ((sides[0], True), (sides[1], True),
                           (sides[0], False)):
        inj = None
        if faults:
            inj = FaultInjector(0)
            for i, point in enumerate(RECOVERABLE_POINTS):
                inj.add(point, nth=1 + i % 2)
        eng = ServingEngine(cfg, p, ServeConfig(**sc), projections=mp,
                            device=m.device, faults=inj)
        rs = [Request(rid=i, prompt=q, max_new_tokens=6)
              for i, q in enumerate(prompts)]
        eng.generate(rs)
        assert all(r.done and not r.failed for r in rs)
        assert eng.pool.free_count + eng._pindex.n_pinned == \
            eng.pool.n_pages
        out.append(([r.out_tokens for r in rs],
                     inj.fired_log if inj else None,
                     eng.n_swap_fallbacks, eng.n_audits, eng.n_preempted))
    assert out[0] == out[1]
    assert out[1][0] == out[2][0]
    assert out[1][1] and out[1][2] >= 1
    # a swap buffer in pinned host memory: one byte flipped, the crc
    # catches it
    buf = torch.arange(64, dtype=torch.float32).reshape(4, 16).pin_memory()
    bad = FaultInjector(2).corrupt("swap_corrupt", buf)
    assert bad.device.type == "cpu" and bad.shape == buf.shape
    assert int((bad.view(torch.uint8) != buf.view(torch.uint8)).sum()) == 1
    assert checksum([bad]) != checksum([buf])


def test_budget_fused_step_launches_k2_then_k1_with_one_sync(cuda):
    """Under the token budget a fused step launches its chunks' K2, then
    the decode chunk's K1, on one stream, and syncs the host once (its
    read-back); the budget log, fused steps and tokens equal the CPU's."""
    import warnings
    cfg, sides, mp = _card_and_cpu(cuda)
    prompts = _shared_prompts(cfg.vocab_size) + [np.arange(
        20, dtype=np.int32) % cfg.vocab_size]
    sc = dict(max_seq_len=32, max_batch=4, decode_chunk=4, paged=True,
              page_size=4, chunked_prefill=True, prefill_chunk=8,
              max_num_batched_tokens=8)
    results = []
    events = []
    k2, k1 = (attention_mod.kq_prefill_paged_attention,
              attention_mod.kq_decode_paged_attention)

    def logged(name, fn):
        def call(*a, **k):
            events.append(name)
            return fn(*a, **k)
        return call

    sync = torch.cuda.synchronize
    n_explicit = [0]

    def counted(*a, **k):
        n_explicit[0] += 1
        return sync(*a, **k)

    fused_seen = 0
    for m, p in sides:
        eng = ServingEngine(cfg, p, ServeConfig(**sc), projections=mp,
                            device=m.device)
        rs = [Request(rid=i, prompt=q, max_new_tokens=6)
              for i, q in enumerate(prompts)]
        eng.start(rs)
        on_card = m.device.type == "cuda"
        busy = True
        while busy:
            events.clear()
            n_explicit[0] = 0
            if on_card:
                attention_mod.kq_prefill_paged_attention = logged("K2", k2)
                attention_mod.kq_decode_paged_attention = logged("K1", k1)
                torch.cuda.synchronize = counted
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    busy = eng.step()
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(0)
                    torch.cuda.synchronize = sync
                    attention_mod.kq_prefill_paged_attention = k2
                    attention_mod.kq_decode_paged_attention = k1
            if on_card and eng.budget_log[-1]["fused"]:
                fused_seen += 1
                syncs = n_explicit[0] + sum(
                    "synchroniz" in str(x.message) for x in w)
                assert syncs == 1, (eng._step_count, syncs)
                n2 = events.count("K2")
                assert n2 and n2 % cfg.n_layers == 0, events
                assert events == ["K2"] * n2 + ["K1"] * (len(events) - n2)
        results.append(([r.out_tokens for r in rs], eng.budget_log,
                        eng.n_fused_steps, eng.n_truncated_chunks))
    assert fused_seen == results[1][2] > 0
    assert results[0] == results[1]


def test_nan_logits_quarantine_on_card(cuda):
    """A ``nan_logits`` fault poisons the lowest live slot's logit row on
    the device; the guard fails that request (``numerics``), its pages go
    back, and the other request gives the CPU's unfaulted tokens."""
    cfg, sides, mp = _card_and_cpu(cuda)
    prompts = _shared_prompts(cfg.vocab_size)[4:]
    sc = dict(max_seq_len=32, max_batch=2, decode_chunk=4, paged=True,
              page_size=4, chunked_prefill=True, prefill_chunk=8)
    out = []
    for (m, p), nan in ((sides[1], True), (sides[0], False)):
        eng = ServingEngine(cfg, p, ServeConfig(**sc), projections=mp,
                            device=m.device,
                            faults=FaultInjector(0).add("nan_logits", nth=1)
                            if nan else None)
        rs = [Request(rid=i, prompt=q, max_new_tokens=6)
              for i, q in enumerate(prompts)]
        eng.generate(rs)
        if nan:
            assert eng._logits.device.type == "cuda"
            assert rs[0].failed and rs[0].error.kind == "numerics"
            assert rs[0].out_tokens == [] and not rs[1].failed
            assert eng.pool.free_count == eng.pool.n_pages
        out.append(rs[1].out_tokens)
    assert out[0] == out[1]


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
# and jamba's head, short and at full width (128 heads of (128, 64), S
# 4096 and 4097), each with and without an initial state
SSD_CASES = [(2, 4, 2, 64, 8, 16, 16), (1, 2, 1, 128, 16, 8, 32),
             (2, 2, 2, 64, 8, 8, 64), (2, 8, 1, 70, 16, 16, 32),
             (1, 4, 1, 300, 64, 128, 256), (1, 2, 1, 130, 128, 64, 256),
             (3, 4, 2, 1, 16, 16, 32),
             (1, 80, 1, 4097, 64, 128, 256),    # mamba2's head, ragged
             (2, 8, 2, 200, 64, 128, 64),       # G 2, 4 heads a group
             (1, 4, 1, 50, 16, 8, 1),           # chunks of 1 token
             (2, 4, 2, 123, 64, 128, 17),       # chunks of no tile multiple
             (1, 2, 1, 333, 128, 64, 100),
             (2, 4, 1, 0, 16, 16, 32),          # S 0: the state passes
             (1, 128, 1, 4096, 128, 64, 256),   # jamba's full head
             (1, 128, 1, 4097, 128, 64, 256)]   # jamba's, ragged
# cases that ask y in float32, as the model does (models/ssm.py): held at
# 1e-4 + 1e-4 |ref| whatever the input type
SSD_Y_F32 = {7, 13, 14}


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


def _grads(fn, inputs, seed):
    """Gradients of a fixed random projection of ``fn``'s outputs (the
    same projection for every ``fn`` given the same seed)."""
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device=ins[0].device).manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g,
                                        device=o.device)).sum()
               for o in outs)
    return torch.autograd.grad(loss, ins)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_k6_autograd_matches_plain_version(cuda, m, window, dtype):
    """K6 under autograd: the kernel's forward (one launch), the plain
    blocked backward (one call, S 200 over blocks of 128 queries), against
    autograd through the plain version; gradients at the kernel tolerance
    and, in bf16, within two ulps (both are float32 arithmetic rounded
    once)."""
    B, Hkv, S, dh = 2, 2, 200, 64
    q, k, v = _flash_inputs(cuda, dtype, B, Hkv * m, Hkv, S, dh,
                            seed=m + window)
    f0, b0 = flash_attention.launches, flash_attention_backward.launches
    got = _grads(lambda *t: flash_attention_train(*t, window=window),
                 (q, k, v), 7)
    torch.cuda.synchronize()
    assert flash_attention.launches == f0 + 1
    assert flash_attention_backward.launches == b0 + 1
    want = _grads(lambda *t: flash_attention_ref(*t, window=window),
                  (q, k, v), 7)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _close_ulps(a, b, dtype)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_autograd_matches_plain_version(cuda, dtype, with_h0):
    """K7 under autograd: the kernel's forward (y in float32, as the model
    asks), the plain backward (one call), against autograd through the
    plain version: S 300 in chunks of 128, two groups of four heads."""
    B, nh, G, S, hd, n = 2, 8, 2, 300, 16, 16
    ins = list(_ssd_inputs(cuda, dtype, B, nh, G, S, hd, n, seed=3))
    if with_h0:
        ins.append(torch.randn(B, nh, n, hd, device=cuda))

    def run(fn):
        def f(*t):
            return fn(*t[:5], chunk=128, h0=t[5] if with_h0 else None,
                      out_dtype=torch.float32)
        return f
    f0, b0 = ssd_chunk_scan.launches, ssd_chunk_scan_backward.launches
    got = _grads(run(ssd_chunk_scan_train), ins, 9)
    torch.cuda.synchronize()
    assert ssd_chunk_scan.launches == f0 + 1
    assert ssd_chunk_scan_backward.launches == b0 + 1
    want = _grads(run(ssd_chunk_scan_plain), ins, 9)
    for a, b in zip(got, want):
        _close_ulps(a, b, a.dtype)


def test_bf16_checkpoint_of_card_tensors(cuda, tmp_path):
    """A tree of bfloat16, float32 and int32 tensors on the card: the
    async save copies them to the host before returning, and restore puts
    every leaf back on the card, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.tree import leaves
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn(64, 96, generator=g, device=cuda).to(
                torch.bfloat16),
            "layers": [{"m": torch.randn(7, generator=g, device=cuda)}],
            "step": torch.tensor(5, dtype=torch.int32)}
    want = {k: v for k, v in leaves(tree)}
    want = {k: v.clone() for k, v in want.items()}
    m = CheckpointManager(str(tmp_path), async_save=True)
    m.save(5, tree)
    tree["w"].add_(1.0)                     # after save: not in the file
    m.wait()
    out, meta = m.restore(tree)
    assert meta["step"] == 5
    for path, t in leaves(out):
        assert t.device == want[path].device and t.dtype == want[path].dtype
        assert torch.equal(t, want[path]), path


def test_trainer_does_not_retry_a_failed_kernel_build(cuda, tmp_path,
                                                      monkeypatch):
    """With a checkpoint to go back to, a kernel that no longer builds
    (an nvcc flag it refuses, a fresh build directory) raises
    ``KernelError`` out of ``Trainer.run`` on the first attempt."""
    from repro_torch.config import TrainConfig
    from repro_torch.data import DataConfig, batches
    from repro_torch.kernels import build
    from repro_torch.train import Trainer
    cfg = get_config("smollm-360m").reduced()
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                     checkpoint_every=1)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=2)
    ckpt = str(tmp_path / "ckpt")
    rep = Trainer(cfg, tc, ckpt_dir=ckpt, device=cuda).run(batches(dc), 2)
    assert rep.steps_done == 2
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "NVCC_FLAGS",
                        build.NVCC_FLAGS + ("--no-such-flag",))
    attempts = {"n": 0}

    def hook(step):
        attempts["n"] += 1

    tr = Trainer(cfg, tc, ckpt_dir=ckpt, device=cuda, failure_hook=hook)
    with pytest.raises(build.KernelError, match="kernel build failed"):
        tr.run(batches(dc), 5)
    assert attempts["n"] == 1


@pytest.mark.parametrize("E,K,masked", [(64, 6, False), (64, 6, True),
                                        (128, 2, False), (128, 2, True)])
def test_moe_dispatch_card_matches_cpu(cuda, E, K, masked):
    """``moe_ffn`` in decode mode at deepseek-v2-lite's (64 experts, top 6)
    and arctic's (128, top 2) routing, narrow widths, 8 slots whose
    tokens crowd the same experts, so capacity drops choices: the keep
    mask and the aux values equal the CPU's, the outputs within 1e-5
    (float32), with and without dead slots."""
    from repro_torch.config import MoEConfig
    from repro_torch.models import moe as moe_mod
    mo = MoEConfig(n_experts=E, top_k=K, expert_ff=32,
                   n_shared_experts=2 if K == 6 else 0,
                   dense_residual=K == 2, dense_residual_ff=32)
    p = moe_mod.init_moe(torch.Generator().manual_seed(3), 64, mo,
                         torch.float32, "cpu")
    g = torch.Generator().manual_seed(4)
    x = torch.randn(64, generator=g) + 0.3 * torch.randn(8, 1, 64,
                                                         generator=g)
    mask = None
    if masked:
        mask = torch.ones(8, 1, dtype=torch.bool)
        mask[[2, 5]] = False
    got = []
    for dev in ("cpu", cuda):
        pd = tree_to(p, dev)
        md = None if mask is None else mask.to(dev)
        y, aux = moe_mod.moe_ffn(pd, x.to(dev), mo, "decode", token_mask=md)
        keep = moe_mod.route(pd, x.to(dev), mo, "decode",
                             token_mask=md)["keep"]
        got.append((y.cpu(), keep.cpu(), {k: float(v)
                                          for k, v in aux.items()}))
    (yc, kc, ac), (yg, kg, ag) = got
    assert torch.equal(kc, kg)
    assert not kc.all()                       # capacity binds
    torch.testing.assert_close(yg, yc, rtol=1e-5, atol=1e-5)
    for k in ac:
        assert abs(ag[k] - ac[k]) <= 1e-5 * max(1.0, abs(ac[k])), k


def test_reduced_jamba_decode_card_matches_cpu(cuda):
    """Reduced jamba-1.5-large-398b (SSM layers around two attention
    layers, MoE, float32) with KQ-SVD: prefill (K7 in the six SSM layers,
    K6 in the two attention layers on the card) and a decode step (K3 in
    the attention layers): logits and every cache leaf within 2e-4 of the
    CPU's; then the dense-slot engine's greedy tokens equal."""
    cfg = get_config("jamba-1.5-large-398b").reduced()
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, cuda)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = tree_to(p_cpu, cuda)
    mp = calibrate_model(cpu, p_cpu, calibration_batches(
        cfg.vocab_size, 4, 32, batch=2),
        CompressionConfig(method="kqsvd", epsilon=0.1))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    counts = (ssd_chunk_scan.launches, flash_attention.launches,
              kq_decode_attention.launches)
    outs = []
    for m, p in ((cpu, p_cpu), (gpu, p_gpu)):
        proj = m.projections_pytree(mp)
        lg, cache = m.prefill(p, toks[:, :39], 48, proj=proj)
        lg2, cache = m.decode_step(p, cache, toks[:, 39:40],
                                   np.array([39, 39]), proj=proj)
        outs.append(([lg.cpu(), lg2.cpu()],
                     [{k: v.cpu() for k, v in c.items()} for c in cache]))
    assert (ssd_chunk_scan.launches - counts[0],
            flash_attention.launches - counts[1],
            kq_decode_attention.launches - counts[2]) == (6, 2, 2)
    for a, b in zip(outs[0][0], outs[1][0]):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)
    for ca, cb in zip(outs[0][1], outs[1][1]):
        for k in ca:
            torch.testing.assert_close(cb[k], ca[k], rtol=2e-4, atol=2e-4)
    served = []
    for m, p in ((cpu, p_cpu), (gpu, p_gpu)):
        eng = ServingEngine(cfg, p, ServeConfig(max_seq_len=64, max_batch=3,
                                                decode_chunk=4),
                            projections=mp, device=m.device)
        rs = [Request(rid=i, prompt=q, max_new_tokens=8) for i, q in
              enumerate(np.random.default_rng(2).integers(
                  0, cfg.vocab_size, (5, 11)).astype(np.int32))]
        eng.generate(rs)
        served.append([r.out_tokens for r in rs])
    assert served[0] == served[1]


def test_reduced_phi3_image_prefix_card_matches_cpu(cuda):
    """Reduced phi-3-vision-4.2b (float32) with KQ-SVD calibrated on stub
    batches (patch embeddings ahead of the text): a prefill of 4 patches
    and 12 tokens (K6 on the card), then decode steps after the P + S
    positions (K3): logits and the cache within 2e-4 of the CPU's."""
    from repro_torch.data import stub_batch
    cfg = get_config("phi-3-vision-4.2b").reduced()
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, cuda)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = tree_to(p_cpu, cuda)
    mp = calibrate_model(cpu, p_cpu, [stub_batch(cfg, 2, 32, seed=i)
                                      for i in range(2)],
                         CompressionConfig(method="kqsvd", epsilon=0.1))
    batch = stub_batch(cfg, 2, 12, seed=5)
    P = cfg.num_patch_tokens
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 3))
    before = kq_decode_attention.launches
    outs = []
    for m, p in ((cpu, p_cpu), (gpu, p_gpu)):
        proj = m.projections_pytree(mp)
        lg, cache = m.prefill(p, batch, P + 16, proj=proj)
        seq = [lg]
        for i in range(3):
            lg, cache = m.decode_step(p, cache, toks[:, i:i + 1],
                                      P + 12 + i, proj=proj)
            seq.append(lg)
        outs.append(([t.cpu() for t in seq],
                     [{k: v.cpu() for k, v in c.items()} for c in cache]))
    assert kq_decode_attention.launches == before + 3 * cfg.n_layers
    assert outs[1][1][0]["kc"].shape[2] == P + 16
    for a, b in zip(outs[0][0], outs[1][0]):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)
    for ca, cb in zip(outs[0][1], outs[1][1]):
        for k in ca:
            torch.testing.assert_close(cb[k], ca[k], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("compressed", [False, True])
def test_mla_decode_card_matches_cpu(cuda, compressed):
    """Reduced deepseek-v2-lite (MLA + MoE, float32): prefill (K6 at
    (24, 16) on the card) and four decode steps at per-sequence
    positions, the latent full or KQ-SVD-compressed: logits within 2e-4
    of the CPU's, the caches' leaves too; then the dense-slot engine's
    greedy tokens equal."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, cuda)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = tree_to(p_cpu, cuda)
    mp = None
    if compressed:
        mp = calibrate_model(cpu, p_cpu, calibration_batches(
            cfg.vocab_size, 4, 32, batch=2),
            CompressionConfig(method="kqsvd", epsilon=0.1))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20))
    outs = []
    before = flash_attention.launches
    for m, p in ((cpu, p_cpu), (gpu, p_gpu)):
        proj = m.projections_pytree(mp) if mp is not None else None
        lg, cache = m.prefill(p, toks[:, :14], 24, proj=proj)
        seq = [lg]
        pos = np.array([14, 14])
        for i in range(4):
            lg, cache = m.decode_step(p, cache, toks[:, 14 + i:15 + i],
                                      pos + i, proj=proj,
                                      token_mask=np.array([True, i < 2]))
            seq.append(lg)
        outs.append(([t.cpu() for t in seq],
                     [{k: v.cpu() for k, v in c.items()} for c in cache]))
    assert flash_attention.launches == before + cfg.n_layers
    for a, b in zip(outs[0][0], outs[1][0]):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)
    for ca, cb in zip(outs[0][1], outs[1][1]):
        for k in ca:
            torch.testing.assert_close(cb[k], ca[k], rtol=2e-4, atol=2e-4)
    served = []
    for m, p in ((cpu, p_cpu), (gpu, p_gpu)):
        eng = ServingEngine(cfg, p, ServeConfig(max_seq_len=64, max_batch=3,
                                                decode_chunk=4),
                            projections=mp, device=m.device)
        rs = [Request(rid=i, prompt=q, max_new_tokens=8) for i, q in
              enumerate(np.random.default_rng(2).integers(
                  0, cfg.vocab_size, (5, 11)).astype(np.int32))]
        eng.generate(rs)
        served.append([r.out_tokens for r in rs])
    assert served[0] == served[1]


MESH_RANK = r"""
import dataclasses, datetime, gc, itertools, json, os, sys
import torch
import torch.distributed as dist

rank, tmp = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(rank)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group(
    "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 4), rank=rank,
    world_size=4, timeout=datetime.timedelta(seconds=180))
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import ShapeSpec, TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batches
from repro_torch.kernels.flash import flash as flash_mod
from repro_torch.kernels.flash import flash_attention
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.specs import abstract_params
from repro_torch.roofline.flop_count import OpCounter
from repro_torch.sharding.partition import params_shardings, use_mesh
from repro_torch.train import Trainer
from repro_torch.tree import leaves
from torch.distributed.tensor.debug import CommDebugMode

plain = {"n": 0}
ref = flash_mod.flash_attention_ref


def counted(*args, **kw):
    plain["n"] += 1
    return ref(*args, **kw)


flash_mod.flash_attention_ref = counted
cfg = get_config("tinyllama-1.1b")
tc = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=3,
                 checkpoint_every=0)
data = list(itertools.islice(batches(DataConfig(
    vocab_size=cfg.vocab_size, seq_len=512, batch_size=8)), 3))
mesh22 = make_local_mesh(2, 2)
tr = Trainer(cfg, tc, mesh=mesh22)
flash_attention.launches = 0
rep = tr.run(iter(data), 3, state=tr.init_state())
dev = torch.device("cuda", rank)
on_card = all(t.to_local().device == dev for tree in (tr.state["params"],
              tr.state["opt"]["m"], tr.state["opt"]["v"])
              for _, t in leaves(tree))
k6 = flash_attention.launches
# save on (2, 2), restore onto (4, 1)
ck = CheckpointManager(os.path.join(tmp, "ckpt"), keep=1, async_save=False)
ck.save(3, {"params": tr.state["params"]})
ck.wait()                       # every rank meets rank 0's committed write
saved = {p: t.full_tensor() for p, t in leaves(tr.state["params"])}
mesh41 = make_local_mesh(4, 1)
template = {"params": abstract_params(tr.model)}
out, _ = ck.restore(template, shardings={"params": params_shardings(
    template["params"], mesh41, fsdp=tc.fsdp)})
equal = all(torch.equal(t.full_tensor(), saved[p])
            for p, t in leaves(out["params"]))
on_card41 = all(t.to_local().device == dev for _, t in leaves(out["params"]))
# one step at grad_accum 1 and 2 on inputs placed as the dry run places
# them, each with its own peak (as chip_smoke.py phase 3s (b) measures
# it), op count, K6 launches and NCCL collectives
KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
         "allreduce_": "all-reduce", "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all", "_allgather_base_": "all-gather",
         "allgather_": "all-gather", "_reduce_scatter_base_": "reduce-scatter"}
del tr, out
steps = {}
for accum in (1, 2):
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with use_mesh(mesh22):
        step, args = dryrun._trace_cell(
            cfg, ShapeSpec("train_four_cards", 512, 8, "train"), mesh22,
            "baseline", dev, dataclasses.replace(tc, grad_accum=accum))
        flash_attention.launches = 0
        with CommDebugMode() as cdm, OpCounter() as oc:
            step(*args)
        torch.cuda.synchronize()
    comm = {}
    for op, n in cdm.get_comm_counts().items():
        name = str(op).split(".")[-1]
        comm[KINDS.get(name, name)] = comm.get(KINDS.get(name, name), 0) + n
    t = oc.totals()
    steps[accum] = {"peak": torch.cuda.max_memory_allocated() - base,
                    "flops": t.flops, "launched": flash_attention.launches,
                    "booked": {k: v["calls"] for k, v in t.kernels.items()},
                    "comm": comm}
    del step, args
with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
    json.dump({"losses": rep.losses, "k6": k6, "plain": plain["n"],
               "on_card": on_card, "equal": equal, "on_card41": on_card41,
               "retries": rep.retries, "steps": steps,
               "ms": sorted(rep.step_times)[1] * 1e3}, f)
dist.destroy_process_group()
"""


def test_mesh_training_on_four_cards_matches_one_card(cuda, tmp_path):
    """tinyllama-1.1b at full width and depth on a (2, 2) NCCL mesh, one
    rank a card, 3 AdamW steps: every loss within 1e-2 relative of the
    one-card Trainer's on the same init and batches; each rank's params,
    AdamW moments and K6 launches on its own card (K6 22 x 2 a step,
    the plain forward never); the params saved on (2, 2) and restored
    onto (4, 1) bit for bit.  Then one step at ``grad_accum`` 1 and one at
    2 on each rank, on inputs placed as the dry run places them: each
    rank's peak (``max_memory_allocated`` over the step, its inputs
    included) within 0.5-2.0 of the dry run's on a fake (2, 2) group
    (``mem_args + mem_out + mem_temp``); at ``grad_accum`` 2, where the
    dry run traces one microbatch and counts it twice, also the FLOPs
    within 1e-6 relative, the K6 calls booked = launched on every rank,
    and the collectives by kind = ``CommDebugMode``'s on NCCL."""
    import itertools
    import json
    import os
    import subprocess
    import sys
    import time
    from repro_torch.config import TrainConfig
    from repro_torch.data import DataConfig, batches
    from repro_torch.kernels import build
    from repro_torch.train import Trainer
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 NVIDIA GPUs (one rank a card)")
    build.load("flash")                       # the ranks find it built
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    procs = [subprocess.Popen([sys.executable, "-c", MESH_RANK, str(r),
                               str(tmp_path)], env=env) for r in range(4)]
    try:                # a rank that fails leaves the others in a collective
        while any(p.poll() is None for p in procs):
            assert all(p.returncode in (None, 0) for p in procs), \
                [p.returncode for p in procs]
            time.sleep(0.5)
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * 4
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(4)]
    cfg = get_config("tinyllama-1.1b")
    tc = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=3,
                     checkpoint_every=0)
    data = list(itertools.islice(batches(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=512, batch_size=8)), 3))
    tr = Trainer(cfg, tc, device=cuda)
    rep = tr.run(iter(data), 3, state=tr.init_state())
    one = rep.losses
    for r in ranks:
        assert r["retries"] == 0 and len(r["losses"]) == 3
        np.testing.assert_allclose(r["losses"], one, rtol=1e-2)
        assert r["losses"] == ranks[0]["losses"]
        assert r["k6"] == cfg.n_layers * 2 * 3 and r["plain"] == 0
        assert r["on_card"] and r["on_card41"] and r["equal"]
    print(f"four-card (2, 2) mesh losses {ranks[0]['losses']}, ms a step "
          f"p50 {ranks[0]['ms']:.2f}; one card {one}, "
          f"{sorted(rep.step_times)[1] * 1e3:.2f}")
    # the dry run of the same steps on a fake (2, 2) group
    from repro_torch.config import ShapeSpec
    from repro_torch.launch.dryrun import run_cell
    for accum in (1, 2):
        rec = run_cell("tinyllama-1.1b", ShapeSpec("train_four_cards", 512,
                                                   8, "train"), False,
                       "baseline", str(tmp_path / "dryrun" / str(accum)),
                       mesh_shape=(2, 2), device_type="cuda", cfg=cfg,
                       tc=dataclasses.replace(tc, grad_accum=accum))
        assert rec["status"] == "ok", rec.get("traceback")
        assert (rec["grad_accum"], rec["microbatches_traced"]) == (accum, 1)
        est = rec["mem_args"] + rec["mem_out"] + rec["mem_temp"]
        booked = {k: v["calls"] for k, v in rec["kernels"].items()}
        real = [r["steps"][str(accum)] for r in ranks]
        ratios = [est / x["peak"] for x in real]
        print(f"four-card (2, 2) train step, grad_accum {accum}: dry-run "
              f"peak {est / 2**30:.3f} GiB; each rank's measured "
              f"{[round(x['peak'] / 2**30, 3) for x in real]} GiB, ratios "
              f"{[round(x, 3) for x in ratios]}; FLOPs a device dry run "
              f"{rec['hlo_flops'] / 4:.6e}, ranks "
              f"{[x['flops'] for x in real]}; K6 booked {booked}, launched "
              f"{[x['launched'] for x in real]}; collectives dry run "
              f"{rec['collectives']['count_by_op']}, NCCL {real[0]['comm']}")
        assert all(0.5 <= x <= 2.0 for x in ratios), ratios
        if accum == 1:
            continue
        for x in real:
            rel = abs(rec["hlo_flops"] / 4 - x["flops"]) / x["flops"]
            assert rel <= 1e-6, (rec["hlo_flops"] / 4, x["flops"])
            assert booked == x["booked"] == {
                "flash_attention": x["launched"]}, (booked, x)
            assert rec["collectives"]["count_by_op"] == x["comm"], (
                rec["collectives"]["count_by_op"], x["comm"])


MESH_DECODE_RANK = r"""
import dataclasses, datetime, gc, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank, tmp = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(rank)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group(
    "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 4), rank=rank,
    world_size=4, timeout=datetime.timedelta(seconds=180))
from repro_torch.config import ShapeSpec
from repro_torch.configs import get_config
from repro_torch.kernels.kq_decode import (kq_decode_attention,
                                           kq_decode_attention_span)
from repro_torch.kernels.kq_decode import kq_decode as k3_mod
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.sharding.partition import (cut_axes, is_dtensor,
                                            merge_spans, params_shardings,
                                            place_tree, use_mesh)
from repro_torch.train.steps import make_decode_step, make_prefill_step
from repro_torch.tree import tree_map
from torch.distributed.tensor.debug import CommDebugMode

# CommDebugMode's collectives by the reference's HLO names
KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
         "allreduce_": "all-reduce", "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all", "_allgather_base_": "all-gather",
         "allgather_": "all-gather", "_reduce_scatter_base_": "reduce-scatter"}
plain = {"n": 0}
ref = k3_mod.kq_decode_attention_span_ref


def counted(*args, **kw):
    plain["n"] += 1
    return ref(*args, **kw)


k3_mod.kq_decode_attention_span_ref = counted
inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
cfg = dataclasses.replace(get_config("smollm-360m"), dtype="float32")
model = build_model(cfg)
dev = model.device
params = model.init(torch.Generator(device=dev).manual_seed(0))
mesh = make_local_mesh(1, 4)
full = lambda t: t.full_tensor() if is_dtensor(t) else t
with use_mesh(mesh):
    p = place_tree(params, params_shardings(params, mesh, fsdp=True))
    proj = tree_map(lambda t: t.to(dev), inp["proj"])
    proj = place_tree(proj, specs.projection_shardings(proj, mesh))
    tok = {"tokens": torch.as_tensor(inp["prompts"], device=dev)}
    tok = place_tree(tok, specs.batch_shardings(tok, mesh))
    kq_decode_attention.launches = kq_decode_attention_span.launches = 0
    merges = merge_spans.calls
    logits, cache = make_prefill_step(model, inp["max_len"], True)(p, proj,
                                                                  tok)
    seq = [list(cut_axes(cache[0]["kc"], d)) for d in range(4)]
    local_t = cache[0]["kc"].to_local().shape[2]
    decode = make_decode_step(model, True)
    toks, walls, comm = [], [], {}
    for i in range(inp["steps"]):
        nxt = full(logits)[:, -1].argmax(-1)[:, None].to(torch.int32)
        toks.append(nxt[:, 0].tolist())
        nxt = place_tree({"tokens": nxt}, specs.batch_shardings(
            {"tokens": nxt}, mesh))["tokens"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:          # the first step's collectives, as NCCL runs them
            with CommDebugMode() as cdm:
                logits, cache = decode(p, proj, cache, nxt,
                                       inp["prompt_len"] + i)
            for op, n in cdm.get_comm_counts().items():
                kind = KINDS[str(op).split(".")[-1]]
                comm[kind] = comm.get(kind, 0) + n
        else:
            logits, cache = decode(p, proj, cache, nxt,
                                   inp["prompt_len"] + i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
span, k3 = kq_decode_attention_span.launches, kq_decode_attention.launches
merges = merge_spans.calls - merges
# one compressed decode step at the cache's last position on inputs placed
# as the dry run places them, its peak measured as chip_smoke.py phase 3s
# (b) measures it (its inputs included)
del logits, cache, p, proj
gc.collect()
torch.cuda.empty_cache()
torch.cuda.synchronize()
base = torch.cuda.memory_allocated()
torch.cuda.reset_peak_memory_stats()
with use_mesh(mesh):
    step, args = dryrun._trace_cell(
        cfg, ShapeSpec("decode_four_cards", inp["max_len"], 4, "decode"),
        mesh, "kqsvd", dev)
    step(*args)
    torch.cuda.synchronize()
peak = torch.cuda.max_memory_allocated() - base
with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
    json.dump({"tokens": toks, "span": span, "k3": k3, "plain": plain["n"],
               "merges": merges, "placements": seq,
               "local_t": local_t, "comm": comm, "peak": peak,
               "ms": float(np.median(walls[1:]) * 1e3)}, f)
dist.destroy_process_group()
"""


def test_mesh_decode_on_four_cards_matches_one_card(cuda, tmp_path):
    """smollm-360m at full width and depth (float32) on a (1, 4) NCCL mesh,
    one rank a card: its 5 kv heads do not divide 4, so the cache's
    sequence is cut over the four cards (``cache_shardings``); compressed
    prefill of 4 prompts of 256 into a cache of 512 and 8 greedy decode
    steps give one card's tokens; each rank launches K3's span output 32
    layers x 8 steps times, K3 never, the plain version never, and merges
    its span's rows with the others' once a layer a step; the dry run of
    the decode step on a fake (1, 4) group counts the collectives by kind
    that ``CommDebugMode`` saw NCCL run in the first step, and its peak
    (``mem_args + mem_out + mem_temp``) is within 0.5-2.0 of each rank's
    measured peak of one decode step on inputs placed as the dry run
    places them (its inputs included).  float32: the
    model axis's partial sums (the FFN, the vocabulary) reduce in another
    order than one card sums, and the point is the span decode, not a
    near-tie token under bf16 rounding."""
    import json
    import os
    import subprocess
    import sys
    import time
    from repro_torch.kernels import build
    from repro_torch.launch import specs
    from repro_torch.train.steps import make_decode_step, make_prefill_step
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 NVIDIA GPUs (one rank a card)")
    for name in ("flash", "kq_decode"):        # the ranks find them built
        build.load(name)
    cfg = dataclasses.replace(get_config("smollm-360m"), dtype="float32")
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator().manual_seed(3)
    proj = [{k: torch.randn(t.shape, generator=g) * 0.2 for k, t in d.items()}
            for d in specs.abstract_projections(model,
                                                specs.default_ranks(cfg))]
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 256)).astype(np.int32)
    steps, max_len = 8, 512
    torch.save({"proj": proj, "prompts": prompts, "steps": steps,
                "max_len": max_len, "prompt_len": 256},
               tmp_path / "inputs.pt")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    procs = [subprocess.Popen([sys.executable, "-c", MESH_DECODE_RANK,
                               str(r), str(tmp_path)], env=env)
             for r in range(4)]
    # one card, meanwhile: the same steps with no mesh
    pj = [{k: t.to(cuda) for k, t in d.items()} for d in proj]
    logits, cache = make_prefill_step(model, max_len, True)(
        params, pj, {"tokens": torch.as_tensor(prompts, device=cuda)})
    decode = make_decode_step(model, True)
    one = []
    for i in range(steps):
        nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        one.append(nxt[:, 0].tolist())
        logits, cache = decode(params, pj, cache, nxt, 256 + i)
    try:                # a rank that fails leaves the others in a collective
        while any(p.poll() is None for p in procs):
            assert all(p.returncode in (None, 0) for p in procs), \
                [p.returncode for p in procs]
            time.sleep(0.5)
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * 4
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(4)]
    for r in ranks:
        assert r["placements"] == [[], [], ["model"], []]
        assert r["local_t"] == max_len // 4
        assert r["tokens"] == one, (r["tokens"], one)
        assert r["span"] == cfg.n_layers * steps and r["k3"] == 0
        assert r["plain"] == 0 and r["merges"] == cfg.n_layers * steps
    # the dry run of the same step on a fake (1, 4) group counts the
    # collectives by kind that CommDebugMode saw NCCL run
    from repro_torch.config import ShapeSpec
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell("smollm-360m", ShapeSpec("decode_four_cards", max_len, 4,
                                            "decode"), False, "kqsvd",
                   str(tmp_path / "dryrun"), mesh_shape=(1, 4),
                   device_type="cuda", cfg=cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    for r in ranks:
        assert rec["collectives"]["count_by_op"] == r["comm"], (
            rec["collectives"]["count_by_op"], r["comm"])
    assert {k: v["calls"] for k, v in rec["kernels"].items()} == {
        "kq_decode_attention_span": cfg.n_layers}
    est = rec["mem_args"] + rec["mem_out"] + rec["mem_temp"]
    ratios = [est / r["peak"] for r in ranks]
    print(f"four-card (1, 4) decode step: dry-run peak {est / 2**30:.3f} "
          f"GiB; each rank's measured "
          f"{[round(r['peak'] / 2**30, 3) for r in ranks]} GiB, ratios "
          f"{[round(x, 3) for x in ratios]}")
    assert all(0.5 <= x <= 2.0 for x in ratios), ratios
    print(f"four-card (1, 4) mesh decode: tokens {ranks[0]['tokens']} equal "
          f"one card's; ms a decode step p50 {ranks[0]['ms']:.2f}; K3 span "
          f"{ranks[0]['span']} a rank; collectives a step {ranks[0]['comm']}"
          f" (NCCL) = the dry run's")
