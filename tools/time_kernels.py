#!/usr/bin/env python3
"""Time the port's attention kernels at ``chip_smoke.py`` phase 4's
shapes, bf16, and print them on one line, so that two checkouts can be
compared on one card in one call (run this from each checkout's root, in
turns: parent, change, change, parent).

    python3 tools/time_kernels.py LABEL

Decode at 8 slots of tinyllama (H 32, Hkv 4, Rk 50, Rv 42, pages of 16,
lengths 1..1024): K1, K3, K4 and K5 split with the merge (through
``kq_decode_paged_attention(num_splits=8)``, whichever way the checkout
merges), K5, the merge kernel alone on K4's partials; K2 at the last
chunk of a 1000-token prompt and at a first chunk; K6 at tinyllama's and
llama2-7b's calibration batches.  Device ms per call by
``chip_smoke.cuda_time_ms`` (CUDA events, L2 flushed before each of 100
launches).  Needs the card; builds the kernels of the checkout it runs
from.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path.cwd()
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(label: str) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.kq_decode import (kq_combine_splits,
                                               kq_decode_attention,
                                               kq_decode_paged_attention,
                                               kq_decode_paged_int8,
                                               kq_decode_paged_split,
                                               kq_prefill_paged_attention)
    from repro_torch.serving import gather_pages

    if not torch.cuda.is_available():
        print("time_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    flush = torch.empty(64 * 2**20, dtype=torch.int8, device=dev).zero_
    dt = torch.bfloat16
    H, Hkv, rk, rv, B, T, ps, scale = 32, 4, 50, 42, 8, 1024, 16, 0.125
    lens = torch.tensor([1, 31, 32, 33, 500, 777, 1023, 1024],
                        dtype=torch.int32, device=dev)
    qc, kp, vp, bt = cs.paged_inputs(g, dev, dt, B, H, Hkv, ps, T // ps, rk,
                                     rv)
    k8, v8, ks, vs = cs.int8_pools(kp.float(), vp.float())
    kd, vd = gather_pages(kp, bt), gather_pages(vp, bt)
    o_p, lse_p = kq_decode_paged_split(qc, kp, vp, lens, bt, span=8,
                                       n_splits=8, scale=scale)
    out_c = torch.empty(B, H, rv, dtype=dt, device=dev)
    q2, kp2, vp2, bt2 = cs.paged_inputs(g, dev, dt, 1, H, Hkv, ps, T // ps,
                                        rk, rv, S=256)
    p0 = torch.tensor([768], dtype=torch.int32, device=dev)
    z0 = torch.zeros(1, dtype=torch.int32, device=dev)
    q6, k6, v6 = (torch.randn(4, h, 512, 64, generator=g, device=dev).to(dt)
                  for h in (32, 4, 4))
    q7, k7, v7 = (torch.randn(4, 32, 512, 128, generator=g, device=dev)
                  .to(dt) for _ in range(3))
    cases = {
        "K1": lambda: kq_decode_paged_attention(qc, kp, vp, lens, bt,
                                                scale=scale),
        "K3": lambda: kq_decode_attention(qc, kd, vd, lens, scale=scale),
        "K4+merge": lambda: kq_decode_paged_attention(
            qc, kp, vp, lens, bt, scale=scale, num_splits=8),
        "K5": lambda: kq_decode_paged_int8(qc, k8, v8, ks, vs, lens, bt,
                                           scale=scale),
        "K5split+merge": lambda: kq_decode_paged_attention(
            qc, k8, v8, lens, bt, scale=scale, num_splits=8, kscale=ks,
            vscale=vs),
        "merge": lambda: kq_combine_splits(o_p, lse_p, out_c),
        "K2last": lambda: kq_prefill_paged_attention(
            q2, kp2, vp2, p0 + 232, p0, bt2, scale=scale),
        "K2first": lambda: kq_prefill_paged_attention(
            q2, kp2, vp2, z0 + 256, z0, bt2, scale=scale),
        "K6tinyllama": lambda: flash_attention(q6, k6, v6),
        "K6llama2": lambda: flash_attention(q7, k7, v7),
    }
    print(label, " ".join(f"{name}={cs.cuda_time_ms(fn, flush, 100):.4f}"
                          for name, fn in cases.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "this"))
