#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1.  device   the card's name and power limit; TF32 is switched off for
             float32 matrix products and convolutions (full float32, so
             the card agrees with the CPU to float32 rounding);
2.  build    every CUDA kernel source of the port, one ``nvcc`` each, all
             started together, with each instantiation's registers and
             spills (bf16 decode's tensor-core body as ``bf16/decode/N``
             and ``bf16/decode int8/N``, N its p.v width; bf16 K2's as
             ``bf16/K2/N``; bf16 K7's three kernels as
             ``bf16/K7 state/hd/n``, ``bf16/K7 pass`` and
             ``bf16/K7 scan/hd/n``);
3.  serve    the dense main path at full width: tinyllama-1.1b (22 layers,
             bf16, seeded random weights), KQ-SVD calibration (16 x 512
             tokens in batches of 4) and closed-form solve, then the
             dense-slot ``ServingEngine`` serving 16 requests of 32..512
             prompt tokens and 32 new tokens each on 8 slots.  The
             kernels' launch counts are zeroed just before the calibration
             and read just after the drain: K6 must have run once per
             layer per calibration batch and per prefill, K3 once per layer
             per decode step, and the plain attention and K3's plain
             version never;
3b. profile  one dense decode step (8 slots at position 512);
3c. paged    the paged main path at full width, same model and
             projections: the paged ``ServingEngine`` with chunked prefill
             (pages of 16 tokens, a pool of 256 pages, half of 8 x 1024,
             chunks of 256) serving 16 requests of 32..1000 prompt tokens
             and 32 new tokens each.  Counts zeroed just before and read
             just after: K1 once per layer per decode step, K2 once per
             layer per prefill chunk, K3 never, K1's and K2's plain
             versions and the model's plain chunk attention never; every
             request done and
             the pool whole again.  The tokens' agreement with the dense
             engine on the same requests is printed, not asserted: chunked
             prefill attends over the compressed cache, exact prefill over
             the full one;
3d. profile  one paged decode step (8 slots at position 512);
3e. int8     the paged main path with int8 pages and per-chunk dynamic
             split-KV (``cache_quant="int8"``, ``decode_splits=0``), same
             model, projections, pool (256 fp-page units, so
             ``int(256 * capacity_x)`` physical pages) and requests as 3c.
             Counts zeroed just before and read just after: K5 split and
             K5 each launched, together once per layer per decode step, the
             merge kernel never (bf16 K5 split merges its spans in its own
             launch), K1, K2, K4 and the plain versions of K5 and K5 split
             never; every request done and the pool whole again;
3f. profile  one paged decode step (8 slots at position 512) with fp pages
             in 8 splits (K4) and int8 pages in 8 splits (K5 split), beside
             3d's fp unsplit step (K1) in this one process, with each
             wrapper's launches per step (22 of K4 or K5 split, no merge);
3g. window   h2o-danube-1.8b at full width (24 layers, d_head 80, window
             4096, bf16, seeded random weights), KQ-SVD calibrated on
             16 x 512 tokens in batches of 4, on dense slots
             (``ServeConfig(max_batch=4, max_seq_len=8192,
             decode_chunk=8)``, a ring of 4096 slots per sequence): 8
             requests of 4095, 4096, 4097, 6000 and four of 256..3000
             prompt tokens, 16 new tokens each, so prompts straddle the
             window, decode wraps the ring and the 6000-token prefill runs
             K6's window skip.  Counts zeroed before the calibration and
             read after the drain: K6 once per layer per calibration batch
             and per prefill, K1-K5 and the merge never, the plain
             attention never; then one profiled decode step of this model
             (4 slots at position 6000);
3h. ssm      mamba2-2.7b at full width (64 layers, d_model 2560, 80 SSM
             heads of 64, d_state 128, chunk 256, bf16, seeded random
             weights, no compression: nothing to compress) on dense slots
             (``ServeConfig(max_batch=4, max_seq_len=4608,
             decode_chunk=8)``): 8 requests of 1, 255, 256, 257, 513,
             1000, 2049 and 4096 prompt tokens (ragged last chunks), 16
             new tokens each.  Counts zeroed before and read after: K7
             once per layer per prefill (64 x 8), K1-K6 never, K7's plain
             version never;
3i. profile  one mamba2 decode step (4 slots at position 4096): the
             recurrent update has no kernel of the reference's, so this is
             where its time goes; and one 4096-token prefill, with K7's
             share of its device time (all of its kernels, and each one's
             device ms);
4.  kernels  each kernel against its plain PyTorch version on the card at
             the main paths' shapes (the calibrated ranks; K2 at the last
             chunk of a 1000-token prompt and at a first chunk; K6 at
             tinyllama's calibration batch, at danube's windowed
             prefill, the plain one there at 4608 tokens, and at
             paper-llama2-7b's calibration batch, MHA at d_head 128) and
             on edge cases: for K1, K2, K4 and K5 page sizes 4, 16, 64;
             lengths 0, 1, ps-1, ps, ps+1, 1023; splits 1, 2, 3, 8 with
             empty trailing splits; shuffled block tables; chunks at
             position 0, mid-page and with bucket padding; for K1 and
             K3-K5 lengths at the edges of bf16 decode's cluster runs
             (1, 15, 16, 17, 127, 128, 129, 1024), a slot at t_cap 8192,
             and caches whose rows past each length, page 0 and pages
             outside the table hold NaN; the decode rows print the
             cluster size they ran with; for K2 also
             odd ranks (37/45, 5/7: pool rows 2-byte aligned), ranks 1
             and 256, groups m 1, 3 and 16 and a chunk of padding rows
             only; for K6 S in
             {1, 63, 64, 65, 1000}, windows {0, 1, 16, S-1, S, 2S},
             groups m in {1, 2, 3, 4, 8} and every (d_head, d_v) pair it
             takes: (8, 8), (16, 16), (32, 32), (64, 64), (80, 80),
             (96, 96), (128, 128), (24, 16), (192, 128); K7 at
             mamba2's full-width prefill (S 4096, and a ragged 4097, also
             against the float64 recurrence; each of bf16 K7's three
             kernels' share of a call from ``torch.profiler``) and on the
             reduced and the reference sweep's shapes with and without an
             initial state, two groups of four heads, chunks of 1, 17 and
             100 tokens and S 0;
             in bf16 and
             float32, at the reference kernel tests' tolerances and within
             two bf16 ulps; its time (CUDA events, L2 flushed before every
             launch) beside the plain version's, one PyTorch library
             call's for the same function and the bound the card's bytes
             or flops allow.  bf16 K4 and K5 split merge their spans in
             their own launch: each such output, at the main shape and in
             every edge case, equals the two launches it replaces (the
             partials entry, then the merge kernel) bit for bit, the
             arrival counters read back zero after it, and the rows print
             the two launches' time beside the one launch's;
5.  parity   the port on the card against the port on the CPU (plain
             versions) at reduced size in float32, same seeded weights:
             dense, paged chunked, int8 pages with dynamic splits, SVDq
             pages with 3 splits and the dense int8 cache of tinyllama,
             and reduced h2o-danube-1.8b (window 16) on dense slots with
             the full cache, KQ-SVD and the dense int8 cache, and reduced
             mamba2-2.7b (chunk 32, prompts of 1..70 tokens) on dense
             slots, give identical greedy tokens; prefill,
             ``LM.prefill_chunk`` and dense and paged ``decode_step``
             logits agree within 2e-4, and danube's prefill and ring
             decode logits and mamba2's prefill and decode logits too.

The last two lines of standard output are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX or of
the reference package, and exits non-zero where CUDA is not available.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # CUDA cores, no TF32
TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # tests/test_kernels.py:15-17
# kernel and plain version read the same inputs and both accumulate in
# float32, so in bfloat16 they also agree to two ulps of the output
ULPS_BF16 = 8e-3
SOURCES = ("kq_decode", "kq_paged", "flash", "ssd")
# K7's kernels by name: bf16's three (csrc/ssd_tc.cuh), float32's one
K7_KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_scan_kernel",
              "ssd_kernel<")


@contextlib.contextmanager
def phase(name: str):
    """Print a phase's start and outcome; a failure propagates."""
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"== {name}: FAILED after {time.perf_counter() - t0:.1f} s",
              flush=True)
        raise
    print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def cuda_time_ms(fn, flush, reps: int = 100) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around each launch,
    L2 flushed before each (a decode step finds its cache cold).  A spin
    of about 1 ms queued ahead of the start event keeps the host ahead of
    the card, so the wrapper's host time stays outside the window."""
    import torch
    for _ in range(5):
        fn()
    pairs = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(2_000_000)        # clock cycles
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def check_close(label: str, dt_name: str, out, ref) -> float:
    """Hold a kernel's output to its plain version's: the reference
    tolerance, and in bf16 two ulps.  Returns the max abs error."""
    import torch
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    tol = TOL[dt_name]
    worst = float(err.max())
    assert bool((err <= tol + tol * ref.float().abs()).all()), \
        f"{label} {dt_name} disagrees: max |err| {worst}"
    if dt_name == "bfloat16":
        assert bool((err <= 1e-4 + ULPS_BF16 * ref.float().abs()).all()), \
            f"{label} bfloat16 beyond two ulps of the plain version: " \
            f"max |err| {worst}"
    return worst


def check_ssd(label: str, dt_name: str, out, ref) -> float:
    """Hold K7's (y, final state) to its plain version's: a float32 y and
    the f32 state within 1e-4 + 1e-4 |ref| (the block's prefix sum and
    tiles add in another order than torch.cumsum and the matmuls), a
    bfloat16 y within two ulps.  Returns the max abs error of y."""
    import torch
    torch.cuda.synchronize()
    (y, h), (y_ref, h_ref) = out, ref
    rel_y = ULPS_BF16 if y.dtype == torch.bfloat16 else 1e-4
    for name, o, r, rel in (("y", y, y_ref, rel_y), ("state", h, h_ref, 1e-4)):
        err = (o.float() - r.float()).abs()
        assert bool((err <= 1e-4 + rel * r.float().abs()).all()), \
            f"{label} {dt_name} {name} disagrees: max |err| {float(err.max())}"
    if not y.numel():
        return 0.0
    return float((y.float() - y_ref.float()).abs().max())


def measure(row: dict, label: str, dt_name: str, kernel, plain, library,
            flush, nbytes: int, flops: int, reps: int = 100,
            check=check_close) -> None:
    """Check ``kernel()`` against ``plain()`` with ``check`` (and the
    library call, where there is one, against ``plain()``, at ten times
    the tolerance), time them (``reps`` launches each) and write the
    numbers into ``row``: bf16, the main paths' type, under the plain
    keys, float32 with a ``_float32`` suffix."""
    ref = plain()
    err = check(label, dt_name, kernel(), ref)
    if library is not None:
        lib_err = float((library().float() - ref.float()).abs().max())
        assert lib_err <= 10 * TOL[dt_name], \
            f"{label} library yardstick disagrees: {lib_err}"
    del ref
    times = {"ms": cuda_time_ms(kernel, flush, reps),
             "plain_ms": cuda_time_ms(plain, flush, reps),
             "library_ms": (cuda_time_ms(library, flush, reps)
                            if library is not None else None)}
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / PEAK_FLOPS[dt_name]
    bound = {"bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    lib = times["library_ms"]
    bar = f"tol {TOL[dt_name]}" if check is check_close else check.__name__
    print(f"{label} {dt_name}: max |err| {err:.3g} ({bar}); "
          f"kernel {times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, "
          f"library {'none' if lib is None else f'{lib:.4f} ms'}, bound "
          f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}: {nbytes} "
          f"bytes, {flops} flops)")
    if dt_name == "bfloat16":
        row.update(times, **bound, max_abs_err=err)
    else:
        row.update({f"{k}_float32": v for k, v in times.items()},
                   bound_ms_float32=bound["bound_ms"],
                   max_abs_err_float32=err)


def paged_inputs(g, dev, dt, B, H, Hkv, ps, n_pages, Rk, Rv, S=None):
    """Random pools of ``1 + B * n_pages`` pages, a block table of
    shuffled physical pages (page 0, the garbage page, never used) and
    queries, (B,H,Rk) for decode or (B,H,S,Rk) for a chunk."""
    import torch
    P = 1 + B * n_pages
    kp = torch.randn(P, Hkv, ps, Rk, generator=g, device=dev).to(dt)
    vp = torch.randn(P, Hkv, ps, Rv, generator=g, device=dev).to(dt)
    btab = (torch.randperm(P - 1, generator=g, device=dev) + 1).reshape(
        B, n_pages).to(torch.int32)
    shape = (B, H, Rk) if S is None else (B, H, S, Rk)
    q = torch.randn(*shape, generator=g, device=dev).to(dt)
    return q, kp, vp, btab


def int8_pools(kp, vp):
    """int8 codes and (P, Hkv, ps, 1) bf16 per-token scales of fp pools,
    by the port's page-layout quantizer."""
    from repro_torch.serving.page_layouts import quantize_int8
    (k8, ks), (v8, vs) = quantize_int8(kp), quantize_int8(vp)
    return k8, v8, ks[..., None].contiguous(), vs[..., None].contiguous()


def poisoned_decode(kind, g, dev, dt, H, Hkv, Rk, Rv, scale):
    """(kernel output, plain output) of ``kind`` (K1, K3, K4, K5 or K5
    split) on caches whose rows past each length, page 0 (the garbage
    page) and three pages outside the table hold NaN (int8 pools: their
    scales), the plain version run on the same caches with those rows
    zeroed.  Four slots of 64 pages of 16, lengths 0, 17, 500, 1023.  A
    bf16 split's output is also held to the two launches bit for bit
    (``check_fused``)."""
    import torch
    from repro_torch.kernels.kq_decode import (
        kq_decode_attention, kq_decode_attention_ref,
        kq_decode_paged_attention)
    from repro_torch.serving import gather_pages
    B, ps, n_pages = 4, 16, 64
    lens = torch.tensor([0, 17, 500, 1023], dtype=torch.int32, device=dev)
    qc, kp, vp, btab = paged_inputs(g, dev, dt, B, H, Hkv, ps, n_pages, Rk,
                                    Rv)
    if kind == "K3":
        kp, vp = gather_pages(kp, btab), gather_pages(vp, btab)
        dead = (torch.arange(kp.shape[2], device=dev)[None, :]
                >= lens[:, None].long())[:, None, :, None]
    else:
        spare = torch.randn(3, Hkv, ps, Rk + Rv, generator=g,
                            device=dev).to(dt)
        kp = torch.cat([kp, spare[..., :Rk]]).contiguous()
        vp = torch.cat([vp, spare[..., Rk:]]).contiguous()
        live = torch.zeros(kp.shape[0], ps, dtype=torch.bool)
        for b, n in enumerate(lens.tolist()):
            t = torch.arange(n)
            live[btab[b].cpu()[t // ps], t % ps] = True
        dead = ~live.to(dev)[:, None, :, None]
    kz, vz = (x.masked_fill(dead, 0.0) for x in (kp, vp))
    if kind == "K3":
        kn, vn = (x.masked_fill(dead, float("nan")) for x in (kp, vp))
        return (kq_decode_attention(qc, kn, vn, lens, scale=scale),
                kq_decode_attention_ref(qc, kz, vz, lens, scale=scale))
    ns = 8 if kind in ("K4", "K5 split") else 1
    if kind in ("K1", "K4"):
        kn, vn = (x.masked_fill(dead, float("nan")) for x in (kp, vp))
        out = kq_decode_paged_attention(qc, kn, vn, lens, btab, scale=scale,
                                        num_splits=ns)
        check_fused(f"{kind} NaN-poisoned", out, qc, kn, vn, lens, btab,
                    scale, ns)
        return out, plain_decode(qc, kz, vz, lens, btab, scale, 1)
    k8, v8, ks, vs = int8_pools(kz.float(), vz.float())
    ksn, vsn = (x.masked_fill(dead, float("nan")) for x in (ks, vs))
    out = kq_decode_paged_attention(qc, k8, v8, lens, btab, scale=scale,
                                    num_splits=ns, kscale=ksn, vscale=vsn)
    check_fused(f"{kind} NaN-poisoned", out, qc, k8, v8, lens, btab, scale,
                ns, ksn, vsn)
    return out, plain_decode(qc, k8, v8, lens, btab, scale, 1, ks, vs)


def plain_decode(qc, kp, vp, lengths, btab, scale, num_splits, ks=None,
                 vs=None):
    """The plain version of the paged decode the wrapper dispatches: K1's
    or K5's, or with more than one span K4's (K5 split's) partials merged
    by ``combine_split_partials``."""
    from repro_torch.kernels.ssd import ssd as ssd_mod
    from repro_torch.kernels.ssd import (ssd_chunk_scan, ssd_chunk_scan_plain,
                                         ssd_chunk_scan_ref)
    from repro_torch.kernels.kq_decode import (
        combine_split_partials, kq_decode_paged_attention_int8_ref,
        kq_decode_paged_attention_ref, kq_decode_paged_partials_ref,
        resolve_splits)
    n, span = resolve_splits(num_splits, btab.shape[1])
    if n > 1:
        o, lse = kq_decode_paged_partials_ref(
            qc, kp, vp, lengths, btab, span=span, n_splits=n, scale=scale,
            kscale=ks, vscale=vs)
        return combine_split_partials(o, lse).reshape(
            qc.shape[0], qc.shape[1], -1).to(qc.dtype)
    if ks is not None:
        return kq_decode_paged_attention_int8_ref(qc, kp, vp, ks, vs,
                                                  lengths, btab, scale=scale)
    return kq_decode_paged_attention_ref(qc, kp, vp, lengths, btab,
                                         scale=scale)


def split_two_launches(qc, kp, vp, lengths, btab, scale, num_splits,
                       ks=None, vs=None):
    """bf16 split decode as the two launches the fused one replaces: the
    partials entry (K4, or K5 split with scales), then
    ``kq_combine_splits``."""
    import torch
    from repro_torch.kernels.kq_decode import (kq_combine_splits,
                                               kq_decode_paged_int8_split,
                                               kq_decode_paged_split,
                                               resolve_splits)
    n, span = resolve_splits(num_splits, btab.shape[1])
    if ks is None:
        o, lse = kq_decode_paged_split(qc, kp, vp, lengths, btab, span=span,
                                       n_splits=n, scale=scale)
    else:
        o, lse = kq_decode_paged_int8_split(qc, kp, vp, lengths, btab,
                                            span=span, n_splits=n,
                                            kscale=ks, vscale=vs,
                                            scale=scale)
    return kq_combine_splits(o, lse, torch.empty(
        qc.shape[0], qc.shape[1], vp.shape[-1], dtype=qc.dtype,
        device=qc.device))


def check_fused(label, out, qc, kp, vp, lengths, btab, scale, num_splits,
                ks=None, vs=None) -> bool:
    """Hold a bf16 split decode's one-launch output to the two launches'
    bit for bit, and every arrival counter to zero after it.  Returns
    whether the call was a fused one (bf16, more than one span)."""
    import torch
    from repro_torch.kernels.kq_decode import paged, resolve_splits
    if qc.dtype != torch.bfloat16 \
            or resolve_splits(num_splits, btab.shape[1])[0] == 1:
        return False
    torch.cuda.synchronize()
    assert not any(bool(b.any()) for b in paged._ARRIVALS.values()), \
        f"{label}: arrival counters not zero after the fused launch"
    two = split_two_launches(qc, kp, vp, lengths, btab, scale, num_splits,
                             ks, vs)
    assert torch.equal(out, two), \
        f"{label}: the fused merge differs from the two launches: max " \
        f"|diff| {float((out.float() - two.float()).abs().max())}"
    return True


def profile_decode(label: str, model, params, proj, ranks, dev, paged: bool,
                   num_splits: int = 1, steps: int = 5, B: int = 8,
                   T: int = 1024, at: int = 512) -> dict:
    """Where a full-width decode step's time goes: host wall per step
    (synced), device busy time per step from ``torch.profiler`` (sum of
    kernel times), the idle share, launches per step, the attention
    kernels' share of the busy time (``attend_kernel``, and the split
    merge ``combine_kernel``; bf16 decode is ``decode_tc_kernel``), and
    the kernels that take the most.  B
    slots of T tokens (a sliding window makes it a ring) decode at
    position ``at``.  Paged: the slots' tokens in pages of 16 at shuffled
    physical ids, in the page layout of ``model.cfg.cache_quant``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ps = 16
    btab = None
    if paged:
        cache = model.init_paged_cache(1 + B * T // ps, ps, ranks)
        btab = (torch.randperm(B * T // ps, device=dev) + 1).reshape(
            B, T // ps).to(torch.int32)
    else:
        cache = model.init_cache(B, T, ranks)
    toks = torch.randint(0, model.cfg.vocab_size, (B, 1), device=dev)
    pos = torch.full((B,), at, dtype=torch.int64, device=dev)

    def step():
        model.decode_step(params, cache, toks, pos, proj=proj,
                          block_table=btab, num_splits=num_splits)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages() if e.device_time_total > 0
            and getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    attn = sum(r[1] for r in rows if any(
        k in r[0] for k in ("attend_kernel", "decode_tc_kernel",
                            "combine_kernel")))
    launches = sum(r[2] for r in rows)
    if not busy:
        print(f"{label} decode step, synced host wall: {wall:.3f} ms; the "
              f"profiler saw no device time")
        return {"wall_ms": wall, "steps": 3 + 2 * steps}
    print(f"{label} decode step, synced host wall: {wall:.3f} ms; device "
          f"busy {busy:.3f} ms ({len(rows)} kernel kinds, {launches} "
          f"launches); idle share {1 - busy / wall:.3f}; attention kernels "
          f"{attn:.4f} ms ({attn / busy:.3f} of busy)")
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {ms:8.4f} ms/step  {n:5d} launches/step  {name[:80]}"
              f"  ({ms / busy:.3f} of busy)")
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall,
            "launches": launches, "attn_ms": attn, "steps": 3 + 2 * steps}


def profile_prefill(label: str, model, params, tokens,
                    kernels: tuple) -> None:
    """Where one exact-length prefill's time goes: synced host wall,
    device busy time from ``torch.profiler``, the idle share, launches,
    the share of the kernels whose names hold one of ``kernels`` (and
    each such kernel's device ms), and the largest device entries; after
    one warm-up prefill."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    T = tokens.shape[1]
    model.prefill(params, tokens, T)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill(params, tokens, T)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    if not busy:
        print(f"{label} prefill of {T} tokens: the profiler saw no device "
              f"time")
        return
    mine = [r for r in rows if any(k in r[0] for k in kernels)]
    ms = sum(r[1] for r in mine)
    print(f"{label} prefill of {T} tokens, profiled host wall: {wall:.3f} "
          f"ms; device busy {busy:.3f} ms ({sum(r[2] for r in rows)} "
          f"launches); idle share {max(0.0, 1 - busy / wall):.3f}; "
          f"{' + '.join(kernels)} {ms:.3f} ms ({ms / busy:.3f} of busy)")
    for name, t, n in mine:
        print(f"  {t:8.4f} ms  {n:5d} launches  {name[:80]}  "
              f"({t / busy:.3f} of busy)")
    print("  largest:")
    for name, t, n in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"  {t:8.4f} ms  {n:5d} launches  {name[:80]}"
              f"  ({t / busy:.3f} of busy)")


def ptxas_summary(log: str) -> list:
    """``nvcc -Xptxas -v`` condensed: registers and spilled bytes for each
    instantiation of the kernels, as ``f32[/int8]/rows/cols: regs+spill``
    for the float32 compressed-cache body (int8: int8 pages),
    ``bf16/decode[ int8]/N: regs+spill`` for bf16 decode's tensor-core
    body (N its p.v width), ``bf16/K2/N:
    regs+spill`` for bf16 K2's tensor-core body (N its p.v width),
    ``type/d_head/d_v: regs+spill`` for K6, ``f32/head_dim/d_state:
    regs+spill`` for float32 K7 and ``bf16/K7 state|scan/head_dim/d_state``
    and ``bf16/K7 pass`` for bf16 K7's three kernels."""
    import re
    out, key = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry.*attend_kernelI(f|13__nv_bfloat16)"
                      r"(f|a|S1_)Li(\d+)ELi(\d+)E", line)
        f = re.search(r"Compiling entry.*flash_(bf16|f32)_kernelI"
                      r"Li(\d+)ELi(\d+)E", line)
        s7 = re.search(r"Compiling entry.*ssd_kernelI(f|13__nv_bfloat16)"
                       r"Li(\d+)ELi(\d+)E", line)
        t7 = re.search(r"Compiling entry.*ssd_(state|pass|scan)_kernel"
                       r"(?:ILi(\d+)ELi(\d+)E)?", line)
        k2 = re.search(r"Compiling entry.*prefill_kernelILi(\d+)E", line)
        dc = re.search(r"Compiling entry.*decode_tc_kernelI"
                       r"(13__nv_bfloat16|a)Li(\d+)E", line)
        if m:
            key = ("f32" if m.group(1) == "f" else "bf16") + \
                ("/int8" if m.group(2) == "a" else "") + \
                f"/{m.group(3)}/{m.group(4)}"
        elif f:
            key = f"{f.group(1)}/{f.group(2)}/{f.group(3)}"
        elif s7:
            key = ("f32" if s7.group(1) == "f" else "bf16") + \
                f"/{s7.group(2)}/{s7.group(3)}"
        elif t7:
            key = f"bf16/K7 {t7.group(1)}" + (
                f"/{t7.group(2)}/{t7.group(3)}" if t7.group(2) else "")
        elif k2:
            key = f"bf16/K2/{k2.group(1)}"
        elif dc:
            key = ("bf16/decode int8/" if dc.group(1) == "a"
                   else "bf16/decode/") + dc.group(2)
        elif key and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif key and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{key}: {regs}+{spill}")
            key = None
    return out


def serve_report(label: str, eng, reqs, wall: float) -> None:
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"{label}: served {len(reqs)} requests (prompts "
          f"{min(len(r.prompt) for r in reqs)}.."
          f"{max(len(r.prompt) for r in reqs)}), {n_tok} tokens in "
          f"{wall:.3f} s: {n_tok / wall:.1f} tokens/s; prefill "
          f"{eng.prefill_seconds:.3f} s ({eng.n_prefill_tokens} tokens), "
          f"decode {eng.decode_seconds:.3f} s over {eng.n_decode_steps} "
          f"steps ({1e3 * eng.decode_seconds / eng.n_decode_steps:.2f} "
          f"ms/step)")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2

    from repro_torch.config import CompressionConfig, ServeConfig
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import calibrate_model
    from repro_torch.data import calibration_batches
    from repro_torch.device import tree_to
    from repro_torch.kernels import build
    from repro_torch.kernels.flash import flash as flash_mod
    from repro_torch.kernels.flash import flash_attention, flash_attention_ref
    from repro_torch.kernels.ssd import ssd as ssd_mod
    from repro_torch.kernels.ssd import (ssd_chunk_scan, ssd_chunk_scan_plain,
                                         ssd_chunk_scan_ref)
    from repro_torch.kernels.kq_decode import kq_decode as k3_mod
    from repro_torch.kernels.kq_decode import paged as paged_mod
    from repro_torch.models import attention as attention_mod
    from repro_torch.kernels.kq_decode import (
        combine_split_partials, kq_combine_splits, kq_decode_attention,
        kq_decode_attention_ref, kq_decode_paged_attention,
        kq_decode_paged_attention_ref, kq_decode_paged_int8,
        kq_decode_paged_int8_split,
        kq_decode_paged_split, kq_prefill_paged_attention,
        kq_prefill_paged_attention_ref, resolve_splits)
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine, gather_pages

    sdpa = torch.nn.functional.scaled_dot_product_attention
    wrappers = (kq_decode_attention, kq_decode_paged_attention,
                kq_prefill_paged_attention, kq_decode_paged_split,
                kq_decode_paged_int8, kq_decode_paged_int8_split,
                kq_combine_splits, flash_attention, ssd_chunk_scan)

    # calls of the kernels' plain versions from their wrappers (CPU tensors
    # only) and of the model's plain chunk attention (the route of non-fp
    # page layouts): the card's decode, prefill and calibration must make
    # none where a kernel serves them
    plain_calls = {"flash_attention_ref": 0, "ssd_chunk_scan_plain": 0,
                   "kq_prefill_paged_attention_ref": 0,
                   "chunk_decode_attention": 0,
                   "kq_decode_attention_ref": 0,
                   "kq_decode_paged_attention_ref": 0,
                   "kq_decode_paged_attention_int8_ref": 0,
                   "kq_decode_paged_partials_ref": 0}

    def counted(name, fn):
        def call(*args, **kw):
            plain_calls[name] += 1
            return fn(*args, **kw)
        return call

    flash_mod.flash_attention_ref = counted("flash_attention_ref",
                                            flash_attention_ref)
    ssd_mod.ssd_chunk_scan_plain = counted("ssd_chunk_scan_plain",
                                           ssd_chunk_scan_plain)
    paged_mod.kq_prefill_paged_attention_ref = counted(
        "kq_prefill_paged_attention_ref", kq_prefill_paged_attention_ref)
    for name in ("kq_decode_paged_attention_ref",
                 "kq_decode_paged_attention_int8_ref",
                 "kq_decode_paged_partials_ref"):
        setattr(paged_mod, name, counted(name, getattr(paged_mod, name)))
    k3_mod.kq_decode_attention_ref = counted("kq_decode_attention_ref",
                                             kq_decode_attention_ref)
    attention_mod.chunk_decode_attention = counted(
        "chunk_decode_attention", attention_mod.chunk_decode_attention)

    def zero_counts():
        for w in wrappers:
            w.launches = 0
        for name in plain_calls:
            plain_calls[name] = 0

    with phase("1 device"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(smi)
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
              f"TF32 off for float32 matmul and cuDNN")
        dev = torch.device("cuda", torch.cuda.current_device())

    with phase("2 build"):
        t0 = time.perf_counter()
        logs = build.build_all(SOURCES)
        print(f"built {', '.join(SOURCES)} in parallel in "
              f"{time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}")
        for name, log in logs.items():      # registers / spills per kernel
            print(f"  {name}: " + "; ".join(ptxas_summary(log)))

    # -- 3: the dense main path ---------------------------------------------
    with phase("3 serve tinyllama-1.1b, full width, KQ-SVD, dense slots"):
        cfg = get_config("tinyllama-1.1b")
        model = build_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init(gen)
        zero_counts()
        t0 = time.perf_counter()
        calib = calibration_batches(cfg.vocab_size, 16, 512, batch=4)
        mp = calibrate_model(model, params, calib,
                             CompressionConfig(method="kqsvd", epsilon=0.1))
        calib_s = time.perf_counter() - t0
        print(f"calibrated on {len(calib)} x {calib[0].shape} tokens in "
              f"{calib_s:.1f} s; ranks k={mp.ranks_k} v={mp.ranks_v} "
              f"(padded Rk={mp.rank_k} Rv={mp.rank_v})")
        sc = ServeConfig(max_seq_len=1024, max_batch=8, decode_chunk=8)
        eng = ServingEngine(cfg, params, sc, projections=mp)
        rng = np.random.default_rng(0)
        lens = np.concatenate([[32, 512], rng.integers(32, 513, 14)])
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(L))
                        .astype(np.int32), max_new_tokens=32)
                for i, L in enumerate(lens)]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3_launches = kq_decode_attention.launches
        k6_launches = {"phase 3": flash_attention.launches}
        bad = [r.rid for r in reqs if r.failed or r.truncated or not r.done
               or len(r.out_tokens) != 32]
        assert not bad, f"requests not served in full: {bad}"
        assert eng.n_decode_steps > 0
        assert k3_launches == cfg.n_layers * eng.n_decode_steps, (
            k3_launches, eng.n_decode_steps)
        # one exact-length prefill per request, one calibration pass per
        # batch, each through K6 once per layer; the plain version never
        assert k6_launches["phase 3"] == cfg.n_layers * (
            len(reqs) + len(calib)), (k6_launches, len(reqs), len(calib))
        assert plain_calls["flash_attention_ref"] == 0 \
            and plain_calls["kq_decode_attention_ref"] == 0, plain_calls
        assert kq_decode_paged_attention.launches == 0
        assert kq_prefill_paged_attention.launches == 0
        probe, _ = model.prefill(params, reqs[0].prompt[None], 64,
                                 proj=eng.proj)
        assert probe.shape == (1, 1, cfg.vocab_size)
        assert bool(torch.isfinite(probe).all()), "non-finite logits"
        serve_report("dense", eng, reqs, wall)
        print(f"capacity gain {eng.capacity_gain():.2f}x; K3 launches "
              f"{k3_launches} = {cfg.n_layers} x {eng.n_decode_steps}; K6 "
              f"launches {k6_launches['phase 3']} = {cfg.n_layers} x "
              f"({len(reqs)} prefills + {len(calib)} calibration batches); "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(f"req 0 tokens: {reqs[0].out_tokens}")
        rk, rv = mp.rank_k, mp.rank_v
        proj = eng.proj

    with phase("3b profile one dense decode step (8 slots at position 512)"):
        profile_decode("dense", model, params, proj, (rk, rv), dev,
                       paged=False)

    # -- 3c: the paged main path --------------------------------------------
    with phase("3c serve tinyllama-1.1b, full width, KQ-SVD, paged + "
               "chunked prefill"):
        psc = ServeConfig(max_seq_len=1024, max_batch=8, paged=True,
                          page_size=16, n_pages=256, chunked_prefill=True,
                          prefill_chunk=256, decode_chunk=8)
        peng = ServingEngine(cfg, params, psc, projections=mp)
        rng = np.random.default_rng(1)
        plens = np.concatenate([[32, 1000], rng.integers(32, 1001, 14)])
        prompts = [rng.integers(0, cfg.vocab_size, int(L)).astype(np.int32)
                   for L in plens]
        preqs = [Request(rid=i, prompt=p, max_new_tokens=32)
                 for i, p in enumerate(prompts)]
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        peng.generate(preqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1_launches = kq_decode_paged_attention.launches
        k2_launches = kq_prefill_paged_attention.launches
        k3_paged = kq_decode_attention.launches
        assert flash_attention.launches == 0, "chunked prefill ran K6"
        assert plain_calls["kq_prefill_paged_attention_ref"] == 0 \
            and plain_calls["chunk_decode_attention"] == 0 \
            and plain_calls["kq_decode_paged_attention_ref"] == 0, plain_calls
        bad = [r.rid for r in preqs if r.failed or not r.done
               or len(r.out_tokens) != min(32, 1024 - len(r.prompt) + 1)]
        assert not bad, f"requests not served in full: {bad}"
        assert peng.pool.free_count == peng.pool.n_pages, \
            (peng.pool.free_count, peng.pool.n_pages)
        assert peng.peak_used_pages <= 256, peng.peak_used_pages
        assert k1_launches == cfg.n_layers * peng.n_decode_steps, (
            k1_launches, peng.n_decode_steps)
        assert k2_launches == cfg.n_layers * peng.n_prefill_chunks, (
            k2_launches, peng.n_prefill_chunks)
        assert k3_paged == 0, k3_paged
        assert peng.prefill_chunk_shapes <= set(psc.buckets)
        serve_report("paged", peng, preqs, wall)
        print(f"pool {psc.total_pages} pages of {psc.page_size}: peak "
              f"{peng.peak_used_pages} used, {peng.pool.free_count} free "
              f"after the drain; {peng.n_prefill_chunks} prefill chunks at "
              f"buckets {sorted(peng.prefill_chunk_shapes)}; K1 launches "
              f"{k1_launches} = {cfg.n_layers} x {peng.n_decode_steps}, K2 "
              f"{k2_launches} = {cfg.n_layers} x {peng.n_prefill_chunks}, "
              f"K3 {k3_paged}, K1's and K2's plain versions and the plain "
              f"chunk attention "
              f"{plain_calls['kq_decode_paged_attention_ref']}, "
              f"{plain_calls['kq_prefill_paged_attention_ref']} "
              f"and {plain_calls['chunk_decode_attention']}; truncated "
              f"{[r.rid for r in preqs if r.truncated]}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        # the same requests through the dense engine (exact prefill over
        # the full cache): printed, not asserted
        dreqs = [Request(rid=i, prompt=p, max_new_tokens=32)
                 for i, p in enumerate(prompts)]
        ServingEngine(cfg, params, sc, projections=mp).generate(dreqs)
        same = sum(a == b for r, d in zip(preqs, dreqs)
                   for a, b in zip(r.out_tokens, d.out_tokens))
        total = sum(len(r.out_tokens) for r in preqs)
        first = sum(r.out_tokens[:1] == d.out_tokens[:1]
                    for r, d in zip(preqs, dreqs))
        print(f"agreement with the dense engine on the same requests: "
              f"{same}/{total} tokens at equal places, first token "
              f"{first}/{len(preqs)} (they differ by design at calibrated "
              f"ranks)")

    with phase("3d profile one paged decode step (8 slots at position "
               "512)"):
        prof = {"K1": profile_decode("paged", model, params, proj,
                                     (rk, rv), dev, paged=True)}

    # -- 3e: int8 pages and dynamic split-KV ------------------------------
    with phase("3e serve tinyllama-1.1b, full width, KQ-SVD, int8 pages + "
               "dynamic split-KV"):
        qsc = dataclasses.replace(psc, cache_quant="int8", decode_splits=0)
        qeng = ServingEngine(cfg, params, qsc, projections=mp)
        qreqs = [Request(rid=i, prompt=p, max_new_tokens=32)
                 for i, p in enumerate(prompts)]
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        qeng.generate(qreqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        q_launch = {"K5 split": kq_decode_paged_int8_split.launches,
                    "K5": kq_decode_paged_int8.launches,
                    "combine": kq_combine_splits.launches,
                    "K1": kq_decode_paged_attention.launches,
                    "K4": kq_decode_paged_split.launches,
                    "K2": kq_prefill_paged_attention.launches,
                    "K3": kq_decode_attention.launches}
        bad = [r.rid for r in qreqs if r.failed or not r.done
               or len(r.out_tokens) != min(32, 1024 - len(r.prompt) + 1)]
        assert not bad, f"requests not served in full: {bad}"
        assert qeng.pool.free_count == qeng.pool.n_pages, \
            (qeng.pool.free_count, qeng.pool.n_pages)
        assert qeng.pool.n_pages == int(256 * qeng.capacity_x) > 256
        for k in ("K5 split", "K5"):
            assert q_launch[k] > 0, f"{k} did not run: {q_launch}"
        assert q_launch["K5 split"] + q_launch["K5"] == \
            cfg.n_layers * qeng.n_decode_steps, q_launch
        # bf16 K5 split merges its spans in its own launch
        assert q_launch["combine"] == 0, q_launch
        assert q_launch["K1"] == q_launch["K4"] == q_launch["K2"] == \
            q_launch["K3"] == 0, q_launch
        assert plain_calls["kq_decode_paged_attention_int8_ref"] == 0 \
            and plain_calls["kq_decode_paged_partials_ref"] == 0, plain_calls
        serve_report("int8 + dynamic splits", qeng, qreqs, wall)
        print(f"capacity_x {qeng.capacity_x:.4f}: pool {qeng.pool.n_pages} "
              f"physical pages of {qsc.page_size} for {qsc.total_pages} "
              f"fp-page units; peak {qeng.peak_used_pages} used, "
              f"{qeng.pool.free_count} free after the drain; launches "
              f"{q_launch} (K5 split + K5 = {cfg.n_layers} x "
              f"{qeng.n_decode_steps} steps); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        same = sum(a == b for r, d in zip(qreqs, preqs)
                   for a, b in zip(r.out_tokens, d.out_tokens))
        print(f"agreement with the fp paged engine on the same requests: "
              f"{same}/{sum(len(r.out_tokens) for r in qreqs)} tokens at "
              f"equal places (int8 pages round the cache)")
        qmodel = qeng.model
        del qeng

    with phase("3f profile one paged decode step (8 slots at position "
               "512): fp 8 splits (K4) and int8 8 splits (K5 split), beside "
               "3d's fp unsplit step (K1)"):
        for label, m_, n_ in (("K4", model, 8), ("K5 split", qmodel, 8)):
            zero_counts()
            prof[label] = profile_decode(
                f"paged {m_.cfg.cache_quant} pages, {n_} split(s)", m_,
                params, proj, (rk, rv), dev, paged=True, num_splits=n_)
            counts = {w.__name__: w.launches for w in wrappers
                      if w.launches}
            prof[label]["counts"] = counts
            n_steps = prof[label]["steps"]
            print(f"  launches over the {n_steps} steps: {counts}; per "
                  f"step: " + ", ".join(f"{k} {v / n_steps:g}"
                                        for k, v in counts.items()))
            # one launch a layer and step, the merge inside it
            assert "kq_combine_splits" not in counts, counts
        k4_launches = prof["K4"]["counts"].get("kq_decode_paged_split", 0)
        assert k4_launches == cfg.n_layers * prof["K4"]["steps"], \
            prof["K4"]["counts"]
        assert prof["K5 split"]["counts"].get(
            "kq_decode_paged_int8_split", 0) == \
            cfg.n_layers * prof["K5 split"]["steps"], \
            prof["K5 split"]["counts"]
        print("decode step, 8 slots at 512: " + "; ".join(
            f"{k} busy {v['busy_ms']:.3f} ms, idle {v['idle']:.3f}, "
            f"{v['launches']} launches, attention {v['attn_ms']:.4f} ms"
            for k, v in prof.items() if "busy_ms" in v))
        del eng, peng, params, model, qmodel

    # -- 3g: the sliding-window ring cache -----------------------------------
    with phase("3g serve h2o-danube-1.8b, full width, KQ-SVD, dense slots, "
               "window 4096"):
        wcfg = get_config("h2o-danube-1.8b")
        wmodel = build_model(wcfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        wparams = wmodel.init(gen)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        wcalib = calibration_batches(wcfg.vocab_size, 16, 512, batch=4)
        wmp = calibrate_model(wmodel, wparams, wcalib,
                              CompressionConfig(method="kqsvd", epsilon=0.1))
        calib_s = time.perf_counter() - t0
        print(f"calibrated on {len(wcalib)} x {wcalib[0].shape} tokens in "
              f"{calib_s:.1f} s; ranks k={wmp.ranks_k} v={wmp.ranks_v} "
              f"(padded Rk={wmp.rank_k} Rv={wmp.rank_v})")
        wsc = ServeConfig(max_batch=4, max_seq_len=8192, decode_chunk=8)
        weng = ServingEngine(wcfg, wparams, wsc, projections=wmp)
        rng = np.random.default_rng(3)
        wlens = [4095, 4096, 4097, 6000] + [int(x) for x in
                                            rng.integers(256, 3001, 4)]
        wreqs = [Request(rid=i, prompt=rng.integers(0, wcfg.vocab_size, L)
                         .astype(np.int32), max_new_tokens=16)
                 for i, L in enumerate(wlens)]
        t0 = time.perf_counter()
        weng.generate(wreqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        w_launch = {w.__name__: w.launches for w in wrappers}
        k6_launches["phase 3g"] = w_launch.pop("flash_attention")
        bad = [r.rid for r in wreqs if r.failed or r.truncated or not r.done
               or len(r.out_tokens) != 16]
        assert not bad, f"requests not served in full: {bad}"
        assert k6_launches["phase 3g"] == wcfg.n_layers * (
            len(wreqs) + len(wcalib)), (k6_launches, len(wreqs), len(wcalib))
        assert not any(w_launch.values()), f"K1-K5 ran: {w_launch}"
        assert plain_calls["flash_attention_ref"] == 0, plain_calls
        ring = weng._cache[0]["kc"].shape[2]
        assert ring == wcfg.sliding_window == 4096, ring
        assert tuple(weng._cache[0]["slot_pos"].shape) == (4, 4096)
        serve_report("danube dense ring", weng, wreqs, wall)
        print(f"ring T = {ring} slots per sequence for max_seq_len "
              f"{wsc.max_seq_len} (window {wcfg.sliding_window}); capacity "
              f"gain {weng.capacity_gain():.2f}x; K6 launches "
              f"{k6_launches['phase 3g']} = {wcfg.n_layers} x "
              f"({len(wreqs)} prefills + {len(wcalib)} calibration "
              f"batches); K1-K5 and the merge {sum(w_launch.values())}; "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(f"req 3 (prompt 6000) tokens: {wreqs[3].out_tokens}")
        prof["danube"] = profile_decode(
            "danube dense ring, 4 slots at position 6000", wmodel, wparams,
            weng.proj, (wmp.rank_k, wmp.rank_v), dev, paged=False, B=4,
            T=8192, at=6000)
        del weng, wparams, wmodel

    # -- 3h: the SSM family --------------------------------------------------
    with phase("3h serve mamba2-2.7b, full width, dense slots, SSM state"):
        mcfg = get_config("mamba2-2.7b")
        mmodel = build_model(mcfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        mparams = mmodel.init(gen)
        msc = ServeConfig(max_batch=4, max_seq_len=4608, decode_chunk=8)
        meng = ServingEngine(mcfg, mparams, msc)
        rng = np.random.default_rng(4)
        mlens = (1, 255, 256, 257, 513, 1000, 2049, 4096)
        mreqs = [Request(rid=i, prompt=rng.integers(0, mcfg.vocab_size, L)
                         .astype(np.int32), max_new_tokens=16)
                 for i, L in enumerate(mlens)]
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        meng.generate(mreqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m_launch = {w.__name__: w.launches for w in wrappers}
        k7_launches = m_launch.pop("ssd_chunk_scan")
        bad = [r.rid for r in mreqs if r.failed or r.truncated or not r.done
               or len(r.out_tokens) != 16]
        assert not bad, f"requests not served in full: {bad}"
        assert k7_launches == mcfg.n_layers * len(mreqs) == 512, k7_launches
        assert not any(m_launch.values()), f"K1-K6 ran: {m_launch}"
        assert plain_calls["ssd_chunk_scan_plain"] == 0, plain_calls
        assert meng.n_decode_steps > 0
        state_bytes = sum(t[0].numel() * t.element_size()
                          for layer in meng._cache for t in layer.values())
        probe, _ = mmodel.prefill(mparams, mreqs[0].prompt[None], 16)
        assert probe.shape == (1, 1, mcfg.vocab_size)
        assert bool(torch.isfinite(probe).all()), "non-finite logits"
        serve_report("mamba2 dense slots", meng, mreqs, wall)
        print(f"K7 launches {k7_launches} = {mcfg.n_layers} x "
              f"{len(mreqs)} prefills; K1-K6 {sum(m_launch.values())}; "
              f"decode state {state_bytes} bytes per slot "
              f"({state_bytes / 2**20:.1f} MiB: conv tails and f32 SSM "
              f"state of {mcfg.n_layers} layers); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(f"req 7 (prompt 4096) tokens: {mreqs[7].out_tokens}")
        del meng

    with phase("3i profile one mamba2 decode step (4 slots at position "
               "4096) and one 4096-token prefill"):
        prof["mamba2"] = profile_decode(
            "mamba2 dense slots, 4 slots at position 4096", mmodel, mparams,
            None, (0, 0), dev, paged=False, B=4, T=4608, at=4096)
        profile_prefill("mamba2", mmodel, mparams, mreqs[7].prompt[None],
                        K7_KERNELS)
        del mparams, mmodel

    # -- 4: each kernel against its plain version ------------------------
    with phase("4 kernels against their plain versions"):
        H, Hkv, m = cfg.n_heads, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        scale = 1.0 / cfg.d_head ** 0.5
        flush_buf = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)
        flush = flush_buf.zero_
        g = torch.Generator(device=dev)
        g.manual_seed(1)

        # K3 at the dense main path's shapes
        B, T = 8, 1024
        lengths = torch.tensor([1, 31, 32, 33, 500, 777, 1023, 1024],
                               dtype=torch.int32, device=dev)
        cluster = paged_mod._library().kq_decode_cluster_size
        k3 = {"name": "kq_decode (K3)", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/kq_decode.cu "
                        "(bf16 body: csrc/kq_decode_tc.cuh; float32: "
                        "csrc/kq_attend.cuh)",
              "replaces": "src/repro/kernels/kq_decode/kq_decode.py:53",
              "launches": k3_launches, "cluster_size": cluster(T),
              "shape": {"B": B, "H": H, "Hkv": Hkv, "T": T, "Rk": rk,
                        "Rv": rv, "lengths": lengths.tolist()}}
        live = int(lengths.sum())
        mask = (torch.arange(T, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            qc = torch.randn(B, H, rk, generator=g, device=dev).to(dt)
            kc = torch.randn(B, Hkv, T, rk, generator=g, device=dev).to(dt)
            vc = torch.randn(B, Hkv, T, rv, generator=g, device=dev).to(dt)
            kx = kc.repeat_interleave(m, dim=1)
            vx = vc.repeat_interleave(m, dim=1)
            isz = qc.element_size()
            measure(k3, "K3", dt_name,
                    lambda: kq_decode_attention(qc, kc, vc, lengths,
                                                scale=scale),
                    lambda: kq_decode_attention_ref(qc, kc, vc, lengths,
                                                    scale=scale),
                    lambda: sdpa(qc[:, :, None], kx, vx, attn_mask=mask,
                                 scale=scale)[:, :, 0],
                    flush,
                    live * Hkv * (rk + rv) * isz + B * H * (rk + rv) * isz
                    + B * 4, 2 * live * H * (rk + rv))

        # K1 at the paged main path's decode shapes: pages of 16
        ps, n_pages = 16, T // 16
        k1 = {"name": "kq_decode_paged (K1)", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/kq_paged.cu "
                        "(bf16 body: csrc/kq_decode_tc.cuh; float32: "
                        "csrc/kq_attend.cuh)",
              "replaces": "src/repro/kernels/kq_decode/paged.py:63",
              "launches": k1_launches, "cluster_size": cluster(ps * n_pages),
              "shape": {"B": B, "H": H, "Hkv": Hkv, "page_size": ps,
                        "n_pages": n_pages, "Rk": rk, "Rv": rv,
                        "lengths": lengths.tolist()}}
        pages_used = int(((lengths + ps - 1) // ps).sum())
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            qc, kp, vp, btab = paged_inputs(g, dev, dt, B, H, Hkv, ps,
                                            n_pages, rk, rv)
            kx = gather_pages(kp, btab).repeat_interleave(m, dim=1)
            vx = gather_pages(vp, btab).repeat_interleave(m, dim=1)
            isz = qc.element_size()
            measure(k1, "K1", dt_name,
                    lambda: kq_decode_paged_attention(qc, kp, vp, lengths,
                                                      btab, scale=scale),
                    lambda: kq_decode_paged_attention_ref(
                        qc, kp, vp, lengths, btab, scale=scale),
                    lambda: sdpa(qc[:, :, None], kx, vx, attn_mask=mask,
                                 scale=scale)[:, :, 0],
                    flush,
                    live * Hkv * (rk + rv) * isz + B * H * (rk + rv) * isz
                    + B * 4 + pages_used * 4, 2 * live * H * (rk + rv))

        # K2 at the paged main path's prefill shapes: the last chunk of a
        # 1000-token prompt, 232 real tokens in a 256 bucket, and a first
        # chunk (pos0 0, 256 real), as every request's first of phase 3c's
        # chunks is
        k2_src = {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/kq_paged.cu "
                            "(bf16 body: csrc/kq_prefill.cuh; float32: "
                            "csrc/kq_attend.cuh)",
                  "replaces": "src/repro/kernels/kq_decode/paged.py:292",
                  "launches": k2_launches, "launches_from": "phase 3c"}
        k2_shape = {"B": 1, "H": H, "Hkv": Hkv, "S": 256, "page_size": ps,
                    "n_pages": n_pages, "Rk": rk, "Rv": rv}
        k2 = dict(k2_src, name="kq_prefill_paged (K2)",
                  shape=dict(k2_shape, pos0=768, n_valid=232))
        k2f = dict(k2_src, name="kq_prefill_paged (K2), first chunk",
                   shape=dict(k2_shape, pos0=0, n_valid=256))
        for row in (k2, k2f):
            S, pos0_v = row["shape"]["S"], row["shape"]["pos0"]
            n_valid = row["shape"]["n_valid"]
            plen = torch.tensor([pos0_v + n_valid], dtype=torch.int32,
                                device=dev)
            pos0 = torch.tensor([pos0_v], dtype=torch.int32, device=dev)
            qpos = pos0_v + torch.arange(S, device=dev)
            t = torch.arange(T, device=dev)
            cmask = ((t[None, :] <= qpos[:, None])
                     & (t[None, :] < int(plen)))[None, None]   # (1,1,S,T)
            seen = torch.minimum(qpos + 1, plen.long())        # keys per row
            for dt_name in ("bfloat16", "float32"):
                dt = getattr(torch, dt_name)
                qc, kp, vp, btab = paged_inputs(g, dev, dt, 1, H, Hkv, ps,
                                                n_pages, rk, rv, S=S)
                kx = gather_pages(kp, btab).repeat_interleave(m, dim=1)
                vx = gather_pages(vp, btab).repeat_interleave(m, dim=1)
                isz = qc.element_size()
                measure(row, f"K2 pos0={pos0_v} n_valid={n_valid}",
                        dt_name,
                        lambda: kq_prefill_paged_attention(
                            qc, kp, vp, plen, pos0, btab, scale=scale),
                        lambda: kq_prefill_paged_attention_ref(
                            qc, kp, vp, plen, pos0, btab, scale=scale),
                        lambda: sdpa(qc, kx, vx, attn_mask=cmask,
                                     scale=scale),
                        flush,
                        int(plen) * Hkv * (rk + rv) * isz
                        + H * S * (rk + rv) * isz + 8
                        + -(-int(plen) // ps) * 4,
                        2 * int(seen.sum()) * H * (rk + rv))

        # K4, K5 (unsplit and split) and the split merge at the paged
        # main path's decode shapes (pages of 16), 8 splits of 8 pages.
        # bf16 K4 and K5 split merge their spans in their own launch, so
        # their bound counts what the function reads and writes (as K1's
        # and K5's); the f32 partials, written and read back through L2
        # inside the launch, are counted only in ``bound_ms_with_partials``
        # (and in float32, which still merges in a second launch)
        n_sp, span = resolve_splits(8, n_pages)
        part_bytes = B * Hkv * n_sp * m * (rv + 1) * 4     # f32 partials
        meta_bytes = B * 4 + pages_used * 4                 # lengths, table
        shape = {"B": B, "H": H, "Hkv": Hkv, "page_size": ps,
                 "n_pages": n_pages, "Rk": rk, "Rv": rv,
                 "lengths": lengths.tolist()}
        k4 = {"name": "kq_decode_paged_split (K4), spans merged in the "
                      "launch",
              "route": "cuda",
              "source": k1["source"],
              "replaces": "src/repro/kernels/kq_decode/paged.py:120",
              "launches": k4_launches, "launches_from": "phase 3f",
              "cluster_size": cluster(span * ps),
              "shape": dict(shape, splits=n_sp, span_pages=span)}
        k5 = {"name": "kq_decode_paged_int8 (K5)", "route": "cuda",
              "source": k4["source"],
              "replaces": "src/repro/kernels/kq_decode/paged.py:63 "
                          "(quant=True)",
              "launches": q_launch["K5"], "launches_from": "phase 3e",
              "cluster_size": k1["cluster_size"], "shape": shape}
        k5s = {"name": "kq_decode_paged_int8_split (K5 split), spans "
                       "merged in the launch", "route": "cuda",
               "source": k4["source"],
               "replaces": "src/repro/kernels/kq_decode/paged.py:120 "
                           "(quant=True)",
               "launches": q_launch["K5 split"],
               "launches_from": "phase 3e",
               "cluster_size": k4["cluster_size"], "shape": k4["shape"]}
        # the merge kernel: float32 split decode's second launch (bf16
        # merges in K4's and K5 split's own); its launches are phase 5's
        # float32 engines' (set there)
        kcomb = {"name": "kq_combine_splits (split merge)", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/kq_paged.cu "
                           "(row merge kq_tc::merge_row, "
                           "csrc/kq_decode_tc.cuh)",
                 "replaces": "src/repro/kernels/kq_decode/paged.py:196 "
                             "(combine_split_partials, jnp beside K4)",
                 "launches": None,
                 "launches_from": "phase 5 (float32 engines; bf16 K4 and "
                                  "K5 split merge in their own launch: "
                                  f"{q_launch['combine']} in phase 3e)",
                 "shape": {"B": B, "Hkv": Hkv, "splits": n_sp, "m": m,
                           "Rv": rv}}
        flops = 2 * live * H * (rk + rv)
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            qc, kp, vp, btab = paged_inputs(g, dev, dt, B, H, Hkv, ps,
                                            n_pages, rk, rv)
            k8, v8, ks8, vs8 = int8_pools(kp.float(), vp.float())
            kx = gather_pages(kp, btab).repeat_interleave(m, dim=1)
            vx = gather_pages(vp, btab).repeat_interleave(m, dim=1)
            kdx = (gather_pages(k8, btab).float()
                   * gather_pages(ks8, btab).float()).to(dt) \
                .repeat_interleave(m, dim=1)
            vdx = (gather_pages(v8, btab).float()
                   * gather_pages(vs8, btab).float()).to(dt) \
                .repeat_interleave(m, dim=1)
            isz = qc.element_size()
            qo_bytes = B * H * (rk + rv) * isz
            fp_bytes = live * Hkv * (rk + rv) * isz
            i8_bytes = live * Hkv * (rk + rv + 2 * 2)      # codes + scales
            bf16 = dt_name == "bfloat16"
            measure(k4, "K4", dt_name,
                    lambda: kq_decode_paged_attention(
                        qc, kp, vp, lengths, btab, scale=scale,
                        num_splits=8),
                    lambda: plain_decode(qc, kp, vp, lengths, btab, scale, 8),
                    lambda: sdpa(qc[:, :, None], kx, vx, attn_mask=mask,
                                 scale=scale)[:, :, 0],
                    flush, fp_bytes + qo_bytes + meta_bytes
                    + (0 if bf16 else 2 * part_bytes), flops)
            measure(k5, "K5", dt_name,
                    lambda: kq_decode_paged_int8(
                        qc, k8, v8, ks8, vs8, lengths, btab, scale=scale),
                    lambda: plain_decode(qc, k8, v8, lengths, btab, scale, 1,
                                         ks8, vs8),
                    lambda: sdpa(qc[:, :, None], kdx, vdx, attn_mask=mask,
                                 scale=scale)[:, :, 0],
                    flush, i8_bytes + qo_bytes + meta_bytes, flops)
            measure(k5s, "K5 split", dt_name,
                    lambda: kq_decode_paged_attention(
                        qc, k8, v8, lengths, btab, scale=scale, num_splits=8,
                        kscale=ks8, vscale=vs8),
                    lambda: plain_decode(qc, k8, v8, lengths, btab, scale, 8,
                                         ks8, vs8),
                    lambda: sdpa(qc[:, :, None], kdx, vdx, attn_mask=mask,
                                 scale=scale)[:, :, 0],
                    flush, i8_bytes + qo_bytes + meta_bytes
                    + (0 if bf16 else 2 * part_bytes), flops)
            if bf16:
                # the one launch against the two it replaces: the same
                # bits, counters zero, and both times
                for row, label, args in (
                        (k4, "K4", (qc, kp, vp)),
                        (k5s, "K5 split", (qc, k8, v8, ks8, vs8))):
                    kw = ({} if len(args) == 3
                          else dict(kscale=args[3], vscale=args[4]))
                    out = kq_decode_paged_attention(
                        *args[:3], lengths, btab, scale=scale,
                        num_splits=8, **kw)
                    check_fused(label, out, *args[:3], lengths, btab,
                                scale, 8, *args[3:])
                    nbytes = (fp_bytes if label == "K4" else i8_bytes) \
                        + qo_bytes + meta_bytes + 2 * part_bytes
                    row["bound_ms_with_partials"] = 1e3 * nbytes \
                        / HBM_BYTES_PER_S
                    row["two_launch_ms"] = cuda_time_ms(
                        lambda args=args: split_two_launches(
                            *args[:3], lengths, btab, scale, 8, *args[3:]),
                        flush)
                    print(f"{label} bfloat16: one launch {row['ms']:.4f} "
                          f"ms, the two launches it replaces (partials, "
                          f"then the merge kernel) "
                          f"{row['two_launch_ms']:.4f} ms; outputs equal "
                          f"bit for bit, counters zero; bound with the "
                          f"partials {row['bound_ms_with_partials']:.6f} ms")
            o_p, lse_p = kq_decode_paged_split(qc, kp, vp, lengths, btab,
                                               span=span, n_splits=n_sp,
                                               scale=scale)
            out_c = torch.empty(B, H, rv, dtype=dt, device=dev)
            measure(kcomb, "combine", dt_name,
                    lambda: kq_combine_splits(o_p, lse_p, out_c),
                    lambda: combine_split_partials(o_p, lse_p).reshape(
                        B, H, rv).to(dt), None, flush,
                    part_bytes + B * H * rv * isz,
                    B * H * n_sp * (2 * rv + 2))

        # K1 and K2 edge cases: page sizes, page-boundary lengths, chunk
        # starts at 0 and mid-page, bucket padding; both types
        n_cases = 0
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            for eps in (4, 16, 64):
                npg = T // eps
                el = torch.tensor([1, eps - 1, eps, eps + 1, 1023],
                                  dtype=torch.int32, device=dev)
                qc, kp, vp, btab = paged_inputs(g, dev, dt, 5, H, Hkv, eps,
                                                npg, rk, rv)
                check_close(f"K1 ps={eps}", dt_name,
                            kq_decode_paged_attention(qc, kp, vp, el, btab,
                                                      scale=scale),
                            kq_decode_paged_attention_ref(
                                qc, kp, vp, el, btab, scale=scale))
                # chunks of 64: at 0, mid-page with 24 padding rows, and
                # one ending at 1023 with one padding row
                p0 = torch.tensor([0, 3 * eps + eps // 2, 960],
                                  dtype=torch.int32, device=dev)
                nv = torch.tensor([64, 40, 63], dtype=torch.int32,
                                  device=dev)
                qc, kp, vp, btab = paged_inputs(g, dev, dt, 3, H, Hkv, eps,
                                                npg, rk, rv, S=64)
                check_close(f"K2 ps={eps}", dt_name,
                            kq_prefill_paged_attention(
                                qc, kp, vp, p0 + nv, p0, btab, scale=scale),
                            kq_prefill_paged_attention_ref(
                                qc, kp, vp, p0 + nv, p0, btab, scale=scale))
                n_cases += 2
        # K2 beyond the calibrated ranks and tinyllama's group: odd ranks
        # (2-byte pool rows), ranks 1 and 256, groups m 1, 3 and 16, and a
        # chunk whose every row is padding past its slot's length; chunks
        # that cross 64-row blocks and 64-key tiles
        k2_edge = [  # B, H, Hkv, S, ps, n_pages, Rk, Rv, pos0, n_valid
            (2, 32, 4, 100, 4, 256, 37, 45, (60, 130), (100, 0)),
            (2, 12, 4, 90, 16, 64, 5, 7, (10, 0), (90, 33)),
            (1, 64, 4, 256, 16, 64, 256, 256, (3,), (256,)),
            (2, 4, 4, 70, 64, 16, 1, 1, (0, 3), (70, 9)),
        ]
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            for B_, H_, Hkv_, S_, ps_, np_, rk_, rv_, p0_, nv_ in k2_edge:
                p0 = torch.tensor(p0_, dtype=torch.int32, device=dev)
                ln = p0 + torch.tensor(nv_, dtype=torch.int32, device=dev)
                qc, kp, vp, btab = paged_inputs(g, dev, dt, B_, H_, Hkv_,
                                                ps_, np_, rk_, rv_, S=S_)
                check_close(f"K2 m={H_ // Hkv_} Rk={rk_} Rv={rv_} ps={ps_}",
                            dt_name,
                            kq_prefill_paged_attention(
                                qc, kp, vp, ln, p0, btab, scale=scale),
                            kq_prefill_paged_attention_ref(
                                qc, kp, vp, ln, p0, btab, scale=scale))
                n_cases += 1
        print(f"K1 and K2 edge cases: {n_cases} held to tolerance and two "
              f"bf16 ulps (page sizes 4, 16, 64; lengths 1, ps-1, ps, "
              f"ps+1, 1023; chunks at 0, mid-page, padded, all padding; "
              f"K2 at ranks 37/45, 5/7, 256/256, 1/1 and groups 8, 3, 16, "
              f"1)")
        # K4 and K5 (with the merge) edge cases: page sizes, lengths 0 and
        # at page boundaries, splits 1, 2, 3, 8 (short slots leave the
        # trailing splits empty), shuffled tables; both types; each bf16
        # split also against the two launches (``check_fused``)
        n_cases = n_fused = 0
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            for eps in (4, 16, 64):
                npg = T // eps
                el = torch.tensor([0, 1, eps - 1, eps, eps + 1, 1023],
                                  dtype=torch.int32, device=dev)
                qc, kp, vp, btab = paged_inputs(g, dev, dt, 6, H, Hkv, eps,
                                                npg, rk, rv)
                k8, v8, ks8, vs8 = int8_pools(kp.float(), vp.float())
                for ns in (1, 2, 3, 8):
                    out = kq_decode_paged_attention(
                        qc, kp, vp, el, btab, scale=scale, num_splits=ns)
                    check_close(f"K4 ps={eps} splits={ns}", dt_name, out,
                                plain_decode(qc, kp, vp, el, btab, scale,
                                             ns))
                    n_fused += check_fused(f"K4 ps={eps} splits={ns}", out,
                                           qc, kp, vp, el, btab, scale, ns)
                    out = kq_decode_paged_attention(
                        qc, k8, v8, el, btab, scale=scale, num_splits=ns,
                        kscale=ks8, vscale=vs8)
                    check_close(f"K5 ps={eps} splits={ns}", dt_name, out,
                                plain_decode(qc, k8, v8, el, btab, scale, ns,
                                             ks8, vs8))
                    n_fused += check_fused(f"K5 ps={eps} splits={ns}", out,
                                           qc, k8, v8, el, btab, scale, ns,
                                           ks8, vs8)
                    n_cases += 2
        print(f"K4 and K5 edge cases: {n_cases} held to tolerance and two "
              f"bf16 ulps (page sizes 4, 16, 64; lengths 0, 1, ps-1, ps, "
              f"ps+1, 1023; splits 1, 2, 3, 8); {n_fused} bf16 splits' one "
              f"launch equal to the two launches bit for bit, counters zero")
        print("bf16 decode's cluster size per row: " + "; ".join(
            f"{r['name']} {r['cluster_size']}" for r in (k1, k3, k4, k5,
                                                         k5s)))
        # K1 and K3-K5 at the edges of bf16 decode's cluster runs (16-token
        # tiles, C 8 at 1024 tokens) and at t_cap 8192 with a slot full;
        # then on caches poisoned with NaN where no row may be read
        n_cases = 0
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            for np_, el_ in ((64, (1, 15, 16, 17, 127, 128, 129, 1024)),
                             (512, (8192, 129, 4000))):
                el = torch.tensor(el_, dtype=torch.int32, device=dev)
                qc, kp, vp, btab = paged_inputs(g, dev, dt, len(el_), H, Hkv,
                                                16, np_, rk, rv)
                k8, v8, ks8, vs8 = int8_pools(kp.float(), vp.float())
                kd, vd = gather_pages(kp, btab), gather_pages(vp, btab)
                check_close(f"K3 T={16 * np_}", dt_name,
                            kq_decode_attention(qc, kd, vd, el, scale=scale),
                            kq_decode_attention_ref(qc, kd, vd, el,
                                                    scale=scale))
                for ns in (1, 8):
                    label = f"K{1 if ns == 1 else 4} t_cap={16 * np_}"
                    out = kq_decode_paged_attention(
                        qc, kp, vp, el, btab, scale=scale, num_splits=ns)
                    check_close(label, dt_name, out,
                                plain_decode(qc, kp, vp, el, btab, scale,
                                             ns))
                    n_fused += check_fused(label, out, qc, kp, vp, el, btab,
                                           scale, ns)
                    label = f"K5 t_cap={16 * np_} splits={ns}"
                    out = kq_decode_paged_attention(
                        qc, k8, v8, el, btab, scale=scale, num_splits=ns,
                        kscale=ks8, vscale=vs8)
                    check_close(label, dt_name, out,
                                plain_decode(qc, k8, v8, el, btab, scale, ns,
                                             ks8, vs8))
                    n_fused += check_fused(label, out, qc, k8, v8, el, btab,
                                           scale, ns, ks8, vs8)
                    n_cases += 2
                n_cases += 1
            for kind in ("K1", "K3", "K4", "K5", "K5 split"):
                out, ref = poisoned_decode(kind, g, dev, dt, H, Hkv, rk, rv,
                                           scale)
                assert bool(torch.isfinite(out).all()), \
                    f"{kind} on NaN-poisoned caches is not finite"
                check_close(f"{kind} NaN-poisoned", dt_name, out, ref)
                n_cases += 1
                n_fused += kind in ("K4", "K5 split") and dt_name == \
                    "bfloat16"
        print(f"K1, K3-K5 run-edge and NaN-poisoned cases: {n_cases} held "
              f"to tolerance and two bf16 ulps (lengths 1, 15, 16, 17, 127, "
              f"128, 129, 1024; t_cap 8192 with lengths 8192, 129, 4000; "
              f"splits 1, 8; NaN past each length, in page 0 and in pages "
              f"outside the table); bf16 splits equal to the two launches "
              f"bit for bit with counters zero, all edge cases: {n_fused}")

        # K6 at tinyllama's calibration batch (causal), at danube's
        # windowed prefill (6000 tokens for the kernel and the library
        # call, the plain version's comparison at 4608: its f32 scores
        # would hold 4.6 GB at 6000) and at paper-llama2-7b's calibration
        # batch (MHA, d_head 128).  Bound: 4 d_head flops per (query, key)
        # pair of the band per head, against q, k, v and out moved once.
        def band_pairs(S, W):
            if not W or W >= S:
                return S * (S + 1) // 2
            return W * (W + 1) // 2 + (S - W) * W

        def band_mask(S, W):
            t = torch.arange(S, device=dev)
            keep = t[None, :] <= t[:, None]
            return keep & (t[:, None] - t[None, :] < W) if W else keep

        k6_src = {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/flash.cu",
                  "replaces": "src/repro/kernels/flash/flash.py:29",
                  "launches": k6_launches["phase 3"]
                  + k6_launches["phase 3g"],
                  "launches_from": "phases 3 and 3g"}
        k6c = dict(k6_src, name="flash (K6), tinyllama-1.1b calibration "
                                "batch",
                   shape={"B": 4, "H": 32, "Hkv": 4, "S": 512, "dh": 64,
                          "window": 0})
        k6w = dict(k6_src, name="flash (K6), h2o-danube-1.8b windowed "
                                "prefill",
                   shape={"B": 1, "H": 32, "Hkv": 8, "S": 4608, "dh": 80,
                          "window": 4096})
        k6l = dict(k6_src, name="flash (K6), paper-llama2-7b calibration "
                                "batch",
                   shape={"B": 4, "H": 32, "Hkv": 32, "S": 512, "dh": 128,
                          "window": 0})
        for row, S_long in ((k6c, None), (k6w, 6000), (k6l, None)):
            sh = row["shape"]
            B_, H_, Hkv_, S_, dh_, W_ = (sh[k] for k in
                                         ("B", "H", "Hkv", "S", "dh",
                                          "window"))
            for dt_name in ("bfloat16", "float32"):
                dt = getattr(torch, dt_name)
                isz = torch.finfo(dt).bits // 8
                fscale = dh_ ** -0.5
                for S in ((S_,) if S_long is None else (S_, S_long)):
                    q, k, v = (torch.randn(B_, h, S, dh_, generator=g,
                                           device=dev).to(dt)
                               for h in (H_, Hkv_, Hkv_))
                    mask = band_mask(S, W_) if W_ else None
                    lib = (lambda q=q, k=k, v=v, mask=mask: sdpa(
                        q, k, v, attn_mask=mask, is_causal=mask is None,
                        scale=fscale, enable_gqa=True))
                    nbytes = 2 * B_ * (H_ + Hkv_) * S * dh_ * isz
                    flops = 4 * dh_ * band_pairs(S, W_) * B_ * H_
                    reps = 100 if S <= 512 else 20
                    if S == S_:
                        measure(row, f"K6 S={S} window={W_}", dt_name,
                                lambda q=q, k=k, v=v: flash_attention(
                                    q, k, v, window=W_),
                                lambda q=q, k=k, v=v: flash_attention_ref(
                                    q, k, v, window=W_),
                                lib, flush, nbytes, flops, reps)
                        continue
                    # the longest prompt: held to the library call at ten
                    # times the tolerance, and timed beside it
                    out = flash_attention(q, k, v, window=W_)
                    lib_err = float((out.float() - lib().float()).abs()
                                    .max())
                    assert lib_err <= 10 * TOL[dt_name], lib_err
                    del out
                    t_k = cuda_time_ms(lambda: flash_attention(
                        q, k, v, window=W_), flush, reps)
                    t_l = cuda_time_ms(lib, flush, reps)
                    bound = max(1e3 * nbytes / HBM_BYTES_PER_S,
                                1e3 * flops / PEAK_FLOPS[dt_name])
                    sfx = "" if dt_name == "bfloat16" else "_float32"
                    row[f"at_S{S}{sfx}"] = {"ms": t_k, "library_ms": t_l,
                                            "bound_ms": bound,
                                            "max_abs_err_vs_library":
                                            lib_err}
                    print(f"K6 S={S} window={W_} {dt_name}: kernel "
                          f"{t_k:.4f} ms, library {t_l:.4f} ms, bound "
                          f"{bound:.6f} ms (operations: {flops} flops); "
                          f"max |kernel - library| {lib_err:.3g}")
                    del q, k, v, mask
        # K6 edge cases: sequence lengths around a tile, every window
        # edge, groups m (3: rows that do not tile a block in whole
        # positions) and every (d_head, d_v) pair the kernel takes
        n_cases = 0
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            for S in (1, 63, 64, 65, 1000):
                for W in sorted({0, 1, 16, max(S - 1, 0), S, 2 * S}):
                    for m_ in (1, 2, 3, 4, 8):
                        for dh_, dv_ in flash_mod.HEAD_DIMS:
                            q, k, v = (torch.randn(1, 2 * h, S, d,
                                                   generator=g, device=dev)
                                       .to(dt) for h, d in ((m_, dh_),
                                                            (1, dh_),
                                                            (1, dv_)))
                            check_close(
                                f"K6 S={S} window={W} m={m_} "
                                f"dh={dh_} dv={dv_}", dt_name,
                                flash_attention(q, k, v, window=W),
                                flash_attention_ref(q, k, v, window=W))
                            n_cases += 1
        print(f"K6 edge cases: {n_cases} held to tolerance and two bf16 "
              f"ulps (S 1, 63, 64, 65, 1000; windows 0, 1, 16, S-1, S, "
              f"2S; m 1, 2, 3, 4, 8; (d_head, d_v) "
              f"{', '.join(map(str, flash_mod.HEAD_DIMS))})")

        # K7 at mamba2-2.7b's prefill: B 1, 80 heads of 64, one group of
        # d_state 128, chunk 256, S 4096 (3h's longest prompt) and a
        # ragged 4097, on the model's layout (x, B, C slices of the conv
        # output (B, S, conv_dim), a and dt (B, S, nh) read through
        # transposes, y asked for in float32) and its data's law: dt the
        # softplus of a normal plus the init's dt bias (dt from 1e-3 to
        # 0.1), A = -(1..16), so some heads carry their state across
        # every chunk.  Bound: the causal pairs of each chunk times
        # 2 (d_state + head_dim) flops, plus 4 L d_state head_dim per
        # chunk for the carried term and the state update, against x, B,
        # C, a, dt, y and the final state moved once.
        def ssd_views(dt_name, B_, nh_, G_, S, hd_, n_, model_law, seed):
            dt_ = getattr(torch, dt_name)
            gg = torch.Generator(device=dev)
            gg.manual_seed(seed)
            width = nh_ * hd_ + 2 * G_ * n_
            xbc = torch.randn(B_, S, width, generator=gg, device=dev).to(dt_)
            x = xbc[..., :nh_ * hd_].reshape(B_, S, nh_, hd_).transpose(1, 2)
            Bm, Cm = (xbc[..., nh_ * hd_ + i * G_ * n_:
                          nh_ * hd_ + (i + 1) * G_ * n_]
                      .reshape(B_, S, G_, n_).transpose(1, 2)
                      for i in range(2))
            z = torch.randn(B_, S, nh_, generator=gg, device=dev)
            if model_law:
                dt0 = torch.exp(torch.linspace(np.log(1e-3), np.log(0.1), nh_,
                                               device=dev))
                dtv = torch.nn.functional.softplus(z + torch.log(
                    torch.expm1(dt0)))
                A = -torch.linspace(1.0, 16.0, nh_, device=dev)
            else:
                dtv = torch.nn.functional.softplus(z)
                A = -torch.exp(torch.randn(nh_, generator=gg, device=dev)
                               * 0.5)
            return (x, (dtv * A).transpose(1, 2), dtv.transpose(1, 2), Bm,
                    Cm)

        def ssd_work(B_, nh_, G_, S, hd_, n_, ck, isz, ysz):
            lens = [min(ck, S - c0) for c0 in range(0, S, ck)]
            pairs = sum(L * (L + 1) // 2 for L in lens)
            flops = B_ * nh_ * (2 * pairs * (n_ + hd_) + 4 * S * n_ * hd_)
            nbytes = (B_ * nh_ * S * hd_ * (isz + ysz)
                      + 2 * B_ * G_ * S * n_ * isz + 2 * B_ * nh_ * S * 4
                      + B_ * nh_ * n_ * hd_ * 4)
            return nbytes, flops

        def check_recurrence(label, dt_name, out, args, h0=None):
            y64, h64 = ssd_chunk_scan_ref(*args, h0=h0)
            tol = 5e-2 if dt_name == "bfloat16" else 2e-3  # test_kernels.py
            for name, o, r in (("y", out[0], y64), ("state", out[1], h64)):
                err = (o.double() - r).abs()
                assert bool((err <= tol + tol * r.abs()).all()), \
                    f"{label} {dt_name} {name} vs float64 recurrence: " \
                    f"{float(err.max())}"
            return (float((out[0].double() - y64).abs().max())
                    if y64.numel() else 0.0)

        def k7_shares(args, calls=10):
            """Each of K7's kernels' device ms per launch (its recorded
            time over its recorded launches) and share of a call, from
            torch.profiler over ``calls`` calls (L2 flushed before
            each)."""
            from torch.profiler import ProfilerActivity, profile
            ssd_chunk_scan(*args, chunk=256, out_dtype=f32)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    flush()
                    ssd_chunk_scan(*args, chunk=256, out_dtype=f32)
                torch.cuda.synchronize()
            per = {e.key: (e.device_time_total / 1e3 / e.count, e.count)
                   for e in prof.key_averages()
                   if any(k in e.key for k in K7_KERNELS) and e.count}
            total = sum(t for t, _ in per.values())
            assert total > 0, "the profiler saw no K7 kernel"
            print(f"K7 S=4096 bfloat16 under torch.profiler: "
                  f"{total:.4f} ms of kernels a call")
            for name, (t, n) in sorted(per.items(), key=lambda kv: -kv[1][0]):
                print(f"  {t:.4f} ms ({t / total:.3f} of the call; {n} of "
                      f"{calls} launches recorded)  {name[:70]}")

        msh = {"B": 1, "nh": 80, "G": 1, "S": 4096, "hd": 64, "n": 128,
               "chunk": 256}
        k7 = {"name": "ssd_chunk_scan (K7), mamba2-2.7b prefill",
              "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/ssd.cu (bf16 body: "
                        "csrc/ssd_tc.cuh)",
              "replaces": "src/repro/kernels/ssd/ssd.py:26",
              "launches": k7_launches, "launches_from": "phase 3h",
              "shape": dict(msh, y="float32", layout="model views")}
        f32 = torch.float32
        for dt_name in ("bfloat16", "float32"):
            isz = torch.finfo(getattr(torch, dt_name)).bits // 8
            for S in (4096, 4097):
                args = ssd_views(dt_name, 1, 80, 1, S, 64, 128, True, S)
                if S == 4096:
                    nbytes, flops = ssd_work(1, 80, 1, S, 64, 128, 256, isz,
                                             4)
                    measure(k7, f"K7 S={S}", dt_name,
                            lambda args=args: ssd_chunk_scan(
                                *args, chunk=256, out_dtype=f32),
                            lambda args=args: ssd_chunk_scan_plain(
                                *args, chunk=256, out_dtype=f32),
                            None, flush, nbytes, flops, 20, check=check_ssd)
                out = ssd_chunk_scan(*args, chunk=256, out_dtype=f32)
                err = check_ssd(f"K7 S={S}", dt_name, out,
                                ssd_chunk_scan_plain(*args, chunk=256,
                                                     out_dtype=f32))
                err64 = check_recurrence(f"K7 S={S}", dt_name, out, args)
                sfx = "" if dt_name == "bfloat16" else "_float32"
                k7[f"max_abs_err_vs_float64_S{S}{sfx}"] = err64
                print(f"K7 S={S} {dt_name}: max |kernel - plain| {err:.3g}, "
                      f"|kernel - float64 recurrence| {err64:.3g}")
                if S == 4096 and dt_name == "bfloat16":
                    k7_shares(args)
                del args, out
        # K7 edge cases: the reference sweep's shapes, reduced mamba2 at
        # lengths around its chunk of 32, the full width's head at short
        # and ragged lengths and at 4097, two groups of four heads,
        # chunks of 1, 17 and 100 tokens (no multiple of a 64-token
        # tile), S 0; with and without an initial state, y in x's type
        # and in float32; a fifth of them also against the float64
        # recurrence
        ssd_cases = ([(2, 4, 2, 64, 8, 16, 16), (1, 2, 1, 128, 16, 8, 32),
                      (2, 2, 2, 64, 8, 8, 64)]
                     + [(2, 8, 1, S, 16, 16, 32) for S in (1, 31, 32, 33, 70)]
                     + [(1, 80, 1, S, 64, 128, 256)
                        for S in (1, 255, 257, 4097)]
                     + [(1, 4, 1, 300, 128, 64, 256),
                        (2, 8, 2, 200, 64, 128, 64),
                        (1, 4, 1, 50, 16, 8, 1), (2, 4, 2, 123, 64, 128, 17),
                        (1, 2, 1, 333, 128, 64, 100),
                        (2, 4, 1, 0, 16, 16, 32)])
        n_cases = 0
        for dt_name in ("bfloat16", "float32"):
            for ci, (B_, nh_, G_, S, hd_, n_, ck) in enumerate(ssd_cases):
                args = ssd_views(dt_name, B_, nh_, G_, S, hd_, n_, hd_ == 64,
                                 ci)
                for with_h0 in (False, True):
                    h0 = (torch.randn(B_, nh_, n_, hd_, generator=g,
                                      device=dev) if with_h0 else None)
                    for od in (None, f32):
                        label = (f"K7 {(B_, nh_, G_, S, hd_, n_, ck)} "
                                 f"h0={with_h0} y={od or dt_name}")
                        out = ssd_chunk_scan(*args, chunk=ck, h0=h0,
                                             out_dtype=od)
                        check_ssd(label, dt_name, out, ssd_chunk_scan_plain(
                            *args, chunk=ck, h0=h0, out_dtype=od))
                        if n_cases % 5 == 0:
                            check_recurrence(label, dt_name, out, args, h0)
                        n_cases += 1
        print(f"K7 edge cases: {n_cases} held to their bars against the "
              f"plain version, every fifth also against the float64 "
              f"recurrence (the reference sweep's shapes; reduced mamba2 "
              f"at S 1, 31, 32, 33, 70; the full width's head at S 1, "
              f"255, 257, 4097; jamba's head at S 300 and 333 (chunk "
              f"100); G 2 of 4 heads; chunks of 1 and 17; S 0; h0 zero "
              f"and random; y in x's type and float32)")
        kernels = [k1, k2, k2f, k3, k4, k5, k5s, kcomb, k6c, k6w, k6l,
                   k7]

    # -- 5: the port on the card against the port on the CPU ---------------
    with phase("5 card against CPU, reduced tinyllama-1.1b, "
               "h2o-danube-1.8b and mamba2-2.7b, float32"):
        rcfg = get_config("tinyllama-1.1b").reduced()
        cpu_model = build_model(rcfg, "cpu")
        gpu_model = build_model(rcfg, dev)
        p_cpu = cpu_model.init(torch.Generator().manual_seed(0))
        p_gpu = tree_to(p_cpu, dev)
        rmp = calibrate_model(
            cpu_model, p_cpu,
            calibration_batches(rcfg.vocab_size, 8, 32, batch=4),
            CompressionConfig(method="kqsvd", epsilon=0.1))
        zero_counts()
        toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (2, 20))
        rps, rpages = 4, 8
        btab_np = np.random.default_rng(2).permutation(
            np.arange(1, 1 + 2 * rpages)).reshape(2, rpages).astype(np.int32)
        outs = []
        for m_, p_ in ((cpu_model, p_cpu), (gpu_model, p_gpu)):
            rproj = m_.projections_pytree(rmp)
            lg, cache = m_.prefill(p_, toks[:, :16], 24, proj=rproj)
            seq = [lg]
            for i in range(4):
                lg, cache = m_.decode_step(p_, cache, toks[:, 16 + i:17 + i],
                                           16 + i, proj=rproj)
                seq.append(lg)
            # paged: two chunks of 8 (the second padded to 8 from 6),
            # then paged decode steps
            bt = torch.as_tensor(btab_np, device=m_.device)
            pcache = m_.init_paged_cache(1 + 2 * rpages, rps,
                                         (rmp.rank_k, rmp.rank_v))
            for c0, nv in ((0, 8), (8, 6)):
                chunk = np.zeros((2, 8), np.int64)
                chunk[:, :nv] = toks[:, c0:c0 + nv]
                lg, pcache = m_.prefill_chunk(
                    p_, pcache, chunk, c0,
                    torch.full((2,), nv, dtype=torch.int32,
                               device=m_.device), proj=rproj,
                    block_table=bt)
                seq.append(lg[:, :nv])
            for i in range(4):
                lg, pcache = m_.decode_step(p_, pcache,
                                            toks[:, 14 + i:15 + i], 14 + i,
                                            proj=rproj, block_table=bt)
                seq.append(lg)
            outs.append([x.cpu() for x in seq])
        worst = 0.0
        for a, b in zip(*outs):
            worst = max(worst, float((a - b).abs().max()))
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4,
                                       atol=2e-4)
        assert kq_decode_attention.launches > 0, "K3 did not run"
        assert kq_decode_paged_attention.launches > 0, "K1 did not run"
        assert kq_prefill_paged_attention.launches > 0, "K2 did not run"
        prompts = [np.random.default_rng(7 + i).integers(
            0, rcfg.vocab_size, L).astype(np.int32)
            for i, L in enumerate((3, 9, 6, 12, 5, 8, 17, 1, 30))]
        served = {}
        chunked = dict(paged=True, page_size=4, n_pages=24,
                       chunked_prefill=True, prefill_chunk=8)
        layouts = {"dense": ({}, {}),
                   "paged chunked": (chunked, {}),
                   "int8 pages, dynamic splits": (dict(
                       chunked, cache_quant="int8", decode_splits=0), {}),
                   "svdq pages, 3 splits": (dict(
                       chunked, cache_quant="svdq", decode_splits=3), {}),
                   "dense int8": ({}, {"cache_quant": "int8"})}
        zero_counts()
        for kind, (kw, cfg_kw) in layouts.items():
            for m_, p_ in ((cpu_model, p_cpu), (gpu_model, p_gpu)):
                e = ServingEngine(dataclasses.replace(rcfg, **cfg_kw), p_,
                                  ServeConfig(max_seq_len=64, max_batch=4,
                                              decode_chunk=4, **kw),
                                  projections=rmp, device=m_.device)
                rs = [Request(rid=i, prompt=p, max_new_tokens=8)
                      for i, p in enumerate(prompts)]
                e.generate(rs)
                if e.pool is not None:
                    assert e.pool.free_count == e.pool.n_pages
                served.setdefault(kind, []).append(
                    [r.out_tokens for r in rs])
            assert served[kind][0] == served[kind][1], (kind, served[kind])
        # the 30-token prompt reaches 11 pages of 4: dynamic mode splits,
        # and float32 split decode merges in the merge kernel
        assert kq_decode_paged_int8_split.launches > 0
        assert kq_decode_paged_int8.launches > 0
        assert kq_combine_splits.launches > 0
        kcomb["launches"] = kq_combine_splits.launches
        print(f"logits max |card - cpu| {worst:.3g} (tol 2e-4) over prefill"
              f" + 4 dense decode steps and 2 prefill chunks + 4 paged "
              f"decode steps; {len(prompts)} requests' greedy tokens "
              f"identical on card and CPU in the engines: "
              f"{', '.join(layouts)}; merge kernel launches "
              f"{kq_combine_splits.launches} (float32 splits)")

        # reduced h2o-danube-1.8b, window 16: prefill of 20 tokens and 8
        # decode steps that wrap the ring, full cache and KQ-SVD; then the
        # dense-slot engine with the full cache, KQ-SVD and the dense int8
        # cache on prompts of 9..40 tokens
        wr = get_config("h2o-danube-1.8b").reduced()
        assert wr.sliding_window == 16
        wcpu, wgpu = build_model(wr, "cpu"), build_model(wr, dev)
        wp_cpu = wcpu.init(torch.Generator().manual_seed(0))
        wp_gpu = tree_to(wp_cpu, dev)
        wrmp = calibrate_model(
            wcpu, wp_cpu, calibration_batches(wr.vocab_size, 8, 32, batch=4),
            CompressionConfig(method="kqsvd", epsilon=0.1))
        zero_counts()
        wtoks = np.random.default_rng(5).integers(0, wr.vocab_size, (2, 28))
        outs = []
        for m_, p_ in ((wcpu, wp_cpu), (wgpu, wp_gpu)):
            seq = []
            for proj_ in (None, m_.projections_pytree(wrmp)):
                lg, cache = m_.prefill(p_, wtoks[:, :20], 40, proj=proj_)
                seq.append(lg)
                for i in range(8):
                    lg, cache = m_.decode_step(p_, cache,
                                               wtoks[:, 20 + i:21 + i],
                                               20 + i, proj=proj_)
                    seq.append(lg)
            outs.append([x.cpu() for x in seq])
        wworst = 0.0
        for a, b in zip(*outs):
            wworst = max(wworst, float((a - b).abs().max()))
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4,
                                       atol=2e-4)
        assert flash_attention.launches > 0, "K6 did not run"
        wprompts = [np.random.default_rng(20 + i).integers(
            0, wr.vocab_size, L).astype(np.int32)
            for i, L in enumerate((9, 40, 16, 17, 25))]
        wkinds = {"full cache": ("none", None), "kqsvd": ("none", wrmp),
                  "kqsvd dense int8": ("int8", wrmp)}
        for kind, (cq, mp_) in wkinds.items():
            got = []
            for m_, p_ in ((wcpu, wp_cpu), (wgpu, wp_gpu)):
                e = ServingEngine(dataclasses.replace(wr, cache_quant=cq), p_,
                                  ServeConfig(max_seq_len=64, max_batch=3,
                                              decode_chunk=4),
                                  projections=mp_, device=m_.device)
                rs = [Request(rid=i, prompt=p, max_new_tokens=12)
                      for i, p in enumerate(wprompts)]
                e.generate(rs)
                assert all(r.done and len(r.out_tokens) == 12 for r in rs)
                got.append([r.out_tokens for r in rs])
            assert got[0] == got[1], (kind, got)
        print(f"danube (window 16) logits max |card - cpu| {wworst:.3g} "
              f"(tol 2e-4) over prefill + 8 ring decode steps, full cache "
              f"and KQ-SVD; {len(wprompts)} requests' greedy tokens "
              f"identical on card and CPU in the dense-slot engines: "
              f"{', '.join(wkinds)}")

        # reduced mamba2-2.7b (chunk 32): prompts of 1..70 tokens, ragged
        # at the chunk, prefill and 8 decode steps each; then the
        # dense-slot engine on the same prompts
        mr = get_config("mamba2-2.7b").reduced()
        mcpu, mgpu = build_model(mr, "cpu"), build_model(mr, dev)
        mp_cpu = mcpu.init(torch.Generator().manual_seed(0))
        mp_gpu = tree_to(mp_cpu, dev)
        zero_counts()
        mprompts = [np.random.default_rng(30 + i).integers(
            0, mr.vocab_size, L + 8).astype(np.int32)
            for i, L in enumerate((1, 31, 32, 33, 64, 70))]
        outs = []
        for m_, p_ in ((mcpu, mp_cpu), (mgpu, mp_gpu)):
            seq = []
            for q in mprompts:
                L = len(q) - 8
                lg, cache = m_.prefill(p_, q[None, :L], len(q))
                seq.append(lg)
                for i in range(8):
                    lg, cache = m_.decode_step(p_, cache, q[None, L + i:
                                                            L + i + 1],
                                               L + i)
                    seq.append(lg)
            outs.append([x.cpu() for x in seq])
        mworst = 0.0
        for a_, b_ in zip(*outs):
            mworst = max(mworst, float((a_ - b_).abs().max()))
            np.testing.assert_allclose(b_.numpy(), a_.numpy(), rtol=2e-4,
                                       atol=2e-4)
        assert ssd_chunk_scan.launches == mr.n_layers * len(mprompts), \
            ssd_chunk_scan.launches
        got = []
        for m_, p_ in ((mcpu, mp_cpu), (mgpu, mp_gpu)):
            e = ServingEngine(mr, p_, ServeConfig(max_seq_len=96, max_batch=3,
                                                  decode_chunk=4),
                              device=m_.device)
            rs = [Request(rid=i, prompt=q[:len(q) - 8], max_new_tokens=12)
                  for i, q in enumerate(mprompts)]
            e.generate(rs)
            assert all(r.done and len(r.out_tokens) == 12 for r in rs)
            got.append([r.out_tokens for r in rs])
        assert got[0] == got[1], got
        print(f"mamba2 (chunk 32) logits max |card - cpu| {mworst:.3g} "
              f"(tol 2e-4) over prefill + 8 decode steps of {len(mprompts)} "
              f"prompts of 1..70 tokens; their greedy tokens identical on "
              f"card and CPU in the dense-slot engine")

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
