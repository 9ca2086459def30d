#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. device   the card's name and power limit; TF32 is switched off for
            float32 matrix products and convolutions (full float32, so
            the card agrees with the CPU to float32 rounding);
2. build    every CUDA kernel source of the port, one ``nvcc`` each;
3. serve    the main path at full width: tinyllama-1.1b (22 layers, bf16,
            seeded random weights), KQ-SVD calibration and closed-form
            solve, then the dense-slot ``ServingEngine`` serving 16
            requests of 32..512 prompt tokens and 32 new tokens each on 8
            slots.  The kernels' launch counts are zeroed just before and
            read just after: K3 must have run once per layer per decode
            step;
4. kernels  each kernel against its plain PyTorch version on the card at
            the main path's shapes (the calibrated ranks), in bf16 and
            float32, at the reference kernel tests' tolerances; its time
            (CUDA events, L2 flushed before every launch) beside the
            plain version's, one PyTorch library call's for the same
            function and the bound the card's bytes or flops allow;
5. parity   the port on the card against the port on the CPU (plain
            versions) at reduced size in float32, same seeded weights:
            identical greedy tokens, logits within 2e-4.

The last two lines of standard output are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX or of
the reference package, and exits non-zero where CUDA is not available.
"""
from __future__ import annotations

import contextlib
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


def profile_decode(model, params, proj, ranks, dev, steps: int = 5):
    """Where a full-width decode step's time goes: host wall per step
    (synced), device busy time per step from ``torch.profiler`` (sum of
    kernel times), the idle share, and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    B, T = 8, 1024
    cache = model.init_cache(B, T, ranks)
    toks = torch.randint(0, model.cfg.vocab_size, (B, 1), device=dev)
    pos = torch.full((B,), 512, dtype=torch.int64, device=dev)
    for _ in range(3):
        model.decode_step(params, cache, toks, pos, proj=proj)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        model.decode_step(params, cache, toks, pos, proj=proj)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model.decode_step(params, cache, toks, pos, proj=proj)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages() if e.device_time_total > 0
            and getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    print(f"decode step, synced host wall: {wall:.3f} ms; device busy "
          f"{busy:.3f} ms ({len(rows)} kernel kinds, "
          f"{sum(r[2] for r in rows)} launches); idle share "
          f"{1 - busy / wall:.3f}" if busy else
          f"decode step, synced host wall: {wall:.3f} ms; the profiler "
          f"saw no device time")
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {ms:8.4f} ms/step  {n:5d} launches/step  {name[:90]}")


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
    from repro_torch.kernels.kq_decode import (kq_decode_attention,
                                               kq_decode_attention_ref)
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine

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
        log = build.build("kq_decode")
        print(f"built kq_decode in {time.perf_counter() - t0:.1f} s into "
              f"{build.BUILD_DIR}")
        for line in log.splitlines():       # registers / spills per kernel
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"  {line.split(':', 1)[-1].strip()}")

    # -- 3: the main path ---------------------------------------------------
    with phase("3 serve tinyllama-1.1b, full width, KQ-SVD"):
        cfg = get_config("tinyllama-1.1b")
        kq_decode_attention.launches = 0
        model = build_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init(gen)
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
        launches = kq_decode_attention.launches
        n_tok = sum(len(r.out_tokens) for r in reqs)
        bad = [r.rid for r in reqs if r.failed or r.truncated or not r.done
               or len(r.out_tokens) != 32]
        assert not bad, f"requests not served in full: {bad}"
        assert eng.n_decode_steps > 0
        assert launches == cfg.n_layers * eng.n_decode_steps, (
            launches, eng.n_decode_steps)
        probe, _ = model.prefill(params, reqs[0].prompt[None], 64,
                                 proj=eng.proj)
        assert probe.shape == (1, 1, cfg.vocab_size)
        assert bool(torch.isfinite(probe).all()), "non-finite logits"
        print(f"served {len(reqs)} requests (prompts {int(lens.min())}.."
              f"{int(lens.max())}), {n_tok} tokens in {wall:.3f} s: "
              f"{n_tok / wall:.1f} tokens/s; prefill {eng.prefill_seconds:.3f}"
              f" s ({eng.n_prefill_tokens} tokens), decode "
              f"{eng.decode_seconds:.3f} s over {eng.n_decode_steps} steps "
              f"({1e3 * eng.decode_seconds / eng.n_decode_steps:.2f} ms/step)"
              f"; capacity gain {eng.capacity_gain():.2f}x; K3 launches "
              f"{launches} = {cfg.n_layers} x {eng.n_decode_steps}; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB")
        print(f"req 0 tokens: {reqs[0].out_tokens}")
        rk, rv = mp.rank_k, mp.rank_v

    with phase("3b profile one decode step (8 slots at position 512)"):
        profile_decode(model, params, eng.proj, (rk, rv), dev)
        del eng, params, model

    # -- 4: each kernel against its plain version ------------------------
    with phase("4 kernels against their plain versions"):
        B, H, Hkv, T = 8, cfg.n_heads, cfg.n_kv_heads, 1024
        lengths = torch.tensor([1, 31, 32, 33, 500, 777, 1023, 1024],
                               dtype=torch.int32, device=dev)
        scale = 1.0 / cfg.d_head ** 0.5
        flush_buf = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)
        flush = flush_buf.zero_
        row = {"name": "kq_decode (K3)", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/kq_decode.cu",
               "replaces": "src/repro/kernels/kq_decode/kq_decode.py:53",
               "launches": launches,
               "shape": {"B": B, "H": H, "Hkv": Hkv, "T": T, "Rk": rk,
                         "Rv": rv, "lengths": lengths.tolist()}}
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            qc = torch.randn(B, H, rk, generator=g, device=dev).to(dt)
            kc = torch.randn(B, Hkv, T, rk, generator=g, device=dev).to(dt)
            vc = torch.randn(B, Hkv, T, rv, generator=g, device=dev).to(dt)
            out = kq_decode_attention(qc, kc, vc, lengths, scale=scale)
            ref = kq_decode_attention_ref(qc, kc, vc, lengths, scale=scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            tol = TOL[dt_name]
            ok = bool((err <= tol + tol * ref.float().abs()).all())
            row[f"max_abs_err_{dt_name}"] = float(err.max())
            assert ok, f"K3 {dt_name} disagrees: max |err| {float(err.max())}"
            if dt_name == "bfloat16":
                assert bool((err <= 1e-4 + ULPS_BF16 * ref.float().abs())
                            .all()), f"K3 bfloat16 beyond two ulps of the " \
                    f"plain version: max |err| {float(err.max())}"
            # the yardstick: one library call over the expanded groups
            m = H // Hkv
            kx = kc.repeat_interleave(m, dim=1)
            vx = vc.repeat_interleave(m, dim=1)
            mask = (torch.arange(T, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            q4 = qc[:, :, None, :]
            lib = torch.nn.functional.scaled_dot_product_attention(
                q4, kx, vx, attn_mask=mask, scale=scale)[:, :, 0]
            assert float((lib.float() - ref.float()).abs().max()) <= \
                10 * tol, "library yardstick disagrees"
            times = {
                "ms": cuda_time_ms(lambda: kq_decode_attention(
                    qc, kc, vc, lengths, scale=scale), flush),
                "plain_ms": cuda_time_ms(lambda: kq_decode_attention_ref(
                    qc, kc, vc, lengths, scale=scale), flush),
                "library_ms": cuda_time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q4, kx, vx, attn_mask=mask, scale=scale), flush)}
            live = int(lengths.sum())
            isz = qc.element_size()
            nbytes = (live * Hkv * (rk + rv) * isz + B * H * (rk + rv) * isz
                      + B * 4)
            flops = 2 * live * H * (rk + rv)
            t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
            t_ops = 1e3 * flops / PEAK_FLOPS[dt_name]
            bound = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
            print(f"K3 {dt_name}: max |err| {float(err.max()):.3g} (tol "
                  f"{tol}); kernel {times['ms']:.4f} ms, plain "
                  f"{times['plain_ms']:.4f} ms, library "
                  f"{times['library_ms']:.4f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
                  f"{nbytes} bytes, {flops} flops)")
            if dt_name == "bfloat16":         # the main path's type
                row.update(times, kernel_ms=times["ms"], **bound,
                           max_abs_err=float(err.max()))
            else:
                row.update({f"{k}_float32": v for k, v in times.items()},
                           bound_ms_float32=bound["bound_ms"])
        kernels = [row]

    # -- 5: the port on the card against the port on the CPU ---------------
    with phase("5 card against CPU, reduced tinyllama-1.1b, float32"):
        rcfg = get_config("tinyllama-1.1b").reduced()
        cpu_model = build_model(rcfg, "cpu")
        gpu_model = build_model(rcfg, dev)
        p_cpu = cpu_model.init(torch.Generator().manual_seed(0))
        p_gpu = tree_to(p_cpu, dev)
        rmp = calibrate_model(
            cpu_model, p_cpu,
            calibration_batches(rcfg.vocab_size, 8, 32, batch=4),
            CompressionConfig(method="kqsvd", epsilon=0.1))
        before = kq_decode_attention.launches
        toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (2, 20))
        worst = 0.0
        outs = []
        for m_, p_ in ((cpu_model, p_cpu), (gpu_model, p_gpu)):
            proj = m_.projections_pytree(rmp)
            lg, cache = m_.prefill(p_, toks[:, :16], 24, proj=proj)
            seq = [lg]
            for t in range(4):
                lg, cache = m_.decode_step(p_, cache, toks[:, 16 + t:17 + t],
                                           16 + t, proj=proj)
                seq.append(lg)
            outs.append([x.cpu() for x in seq])
        for a, b in zip(*outs):
            worst = max(worst, float((a - b).abs().max()))
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4,
                                       atol=2e-4)
        assert kq_decode_attention.launches > before, "K3 did not run"
        prompts = [np.random.default_rng(7 + i).integers(
            0, rcfg.vocab_size, L).astype(np.int32)
            for i, L in enumerate((3, 9, 6, 12, 5, 8))]
        served = []
        for m_, p_ in ((cpu_model, p_cpu), (gpu_model, p_gpu)):
            e = ServingEngine(rcfg, p_, ServeConfig(
                max_seq_len=64, max_batch=4, decode_chunk=4),
                projections=rmp, device=m_.device)
            rs = [Request(rid=i, prompt=p, max_new_tokens=8)
                  for i, p in enumerate(prompts)]
            e.generate(rs)
            served.append([r.out_tokens for r in rs])
        assert served[0] == served[1], served
        print(f"logits max |card - cpu| {worst:.3g} (tol 2e-4) over prefill"
              f" + 4 decode steps; {len(prompts)} requests' greedy tokens "
              f"identical on card and CPU")

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
