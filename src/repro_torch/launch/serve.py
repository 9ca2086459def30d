"""Serving CLI of the port: calibrate, compress with KQ-SVD, serve requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --method kqsvd --requests 8

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --method kqsvd --requests 8 --paged --prefill-chunk 256 \\
      --cache-quant int8 --decode-splits 0

The flags are the reference CLI's (``python -m repro.launch.serve``).
``--arch`` takes tinyllama-1.1b, paper-llama2-7b, h2o-danube-1.8b
(sliding window: a ring cache on dense slots; its paged store is refused,
as in the reference) and mamba2-2.7b (attention-free: no calibration,
whatever ``--method`` says, as in the reference; SSM state on dense
slots, K7 under every prefill).  The port serves the dense-slot cache
and the paged store (``--paged``, ``--page-size``, ``--n-pages``), with
exact-length or chunked prefill (``--prefill-chunk``, which turns on
paging, and ``--prefill-buckets``), quantized pages (``--cache-quant``)
and split-KV decode (``--decode-splits``), both of which turn on paging
too; a flag that asks for a path it does not have yet (token budget, shards,
optimistic admission and preemption with its priorities, prefix sharing,
audits, chaos) stops the run with an error naming it.  Runs on the CUDA
device unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import CompressionConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.core.calibration import calibrate_model
from repro_torch.core.compressed import cache_footprint
from repro_torch.data import calibration_batches
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.page_layouts import FpLayout, get_layout

# flags of the reference CLI whose paths later slices bring (priority
# only orders preemption there); refused when given
_NOT_PORTED = (
    "shards", "max-batched-tokens", "admission", "preempt-mode",
    "watermark-high", "watermark-low", "admit-window", "share-prefix",
    "prefix-index-capacity", "priority", "audit", "chaos-seed",
    "chaos-rate",
)


def parse_args(argv=None) -> argparse.Namespace:
    """The reference CLI's flags plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--method", default="kqsvd",
                    choices=["none", "ksvd", "eigen", "kqsvd"])
    ap.add_argument("--epsilon", type=float, default=0.1)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="max prompt length; requests draw mixed lengths "
                         "in [4, prompt-len] (continuous batching)")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="tokens per fused decode chunk (one host sync)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: page pool + block tables")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per page (with --paged)")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="pool size; 0 derives full capacity, smaller "
                         "oversubscribes with admission backpressure")
    ap.add_argument("--cache-quant", default="none",
                    choices=["none", "int8", "svdq"],
                    help="paged page layout: int8 = int8 pages + per-token "
                         "scale pools, dequantized in the decode kernel; "
                         "svdq = per-rank key bits packed sub-byte.  "
                         "Implies --paged (svdq needs --prefill-chunk); "
                         "needs a compressed --method to take effect.")
    ap.add_argument("--decode-splits", type=int, default=1,
                    help="split-KV decode fan-out: >1 fixed, 0 derived per "
                         "decode chunk from the live max length (snapped "
                         "to {1,2,4,8}), 1 unsplit.  Implies --paged.")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill straight into pages: chunk size "
                         "in tokens; 0 keeps exact-length prefill.  "
                         "Implies --paged.")
    ap.add_argument("--prefill-buckets", default="",
                    help="comma-separated padded chunk lengths (largest "
                         "must equal --prefill-chunk); empty derives by "
                         "doubling")
    ap.add_argument("--calib-seqs", type=int, default=8)
    ap.add_argument("--calib-len", type=int, default=64)
    ap.add_argument("--shared-frac", type=float, default=0.0,
                    help="fraction of each prompt drawn from one common "
                         "prefix")
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="per-request total step budget; 0 = unbounded")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    for flag in _NOT_PORTED:
        ap.add_argument("--" + flag, nargs="?", const=True, default=None,
                        help="not ported yet")
    args = ap.parse_args(argv)
    asked = ["--" + f for f in _NOT_PORTED
             if getattr(args, f.replace("-", "_")) is not None]
    if asked:
        ap.error(f"{', '.join(asked)}: not ported yet (this slice serves "
                 f"dense slots and the paged store with reserve "
                 f"admission; see ROADMAP.md queue 1)")
    if args.prefill_buckets and not args.prefill_chunk:
        ap.error("--prefill-buckets requires --prefill-chunk")
    if args.cache_quant == "svdq" and not args.prefill_chunk:
        ap.error("--cache-quant svdq packs sub-byte ranks at page-write "
                 "time and requires --prefill-chunk (the exact-length "
                 "prefill has no packed-page writer)")
    if args.cache_quant != "none" and not args.paged:
        print("--cache-quant selects a paged page layout: enabling "
              "--paged")
        args.paged = True
    if args.decode_splits != 1 and not args.paged:
        print("--decode-splits splits the paged page chain: enabling "
              "--paged")
        args.paged = True
    if args.prefill_chunk and not args.paged:
        print("--prefill-chunk writes straight into pages: enabling "
              "--paged")
        args.paged = True
    return args


def main(argv=None) -> None:
    """Calibrate + compress an arch, then drain a synthetic request batch
    through the serving engine and print the outcome."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, args.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    params = model.init(gen)

    proj = None
    if args.method != "none" and not cfg.attention_free:
        calib = calibration_batches(cfg.vocab_size, args.calib_seqs,
                                    args.calib_len, batch=4)
        ccfg = CompressionConfig(method=args.method, epsilon=args.epsilon)
        proj = calibrate_model(model, params, calib, ccfg)
        fp = cache_footprint(cfg.n_kv_heads, cfg.d_head, proj.rank_k,
                             proj.rank_v)
        print(f"calibrated {args.method}: ranks k={proj.ranks_k} "
              f"v={proj.ranks_v}; cache ratio {fp.ratio:.3f}")

    T = args.prompt_len + args.max_new_tokens + 8
    if args.paged:   # logical capacity must be whole pages
        T = -(-T // args.page_size) * args.page_size
    buckets = tuple(int(x) for x in args.prefill_buckets.split(",")
                    if x.strip())
    sc = ServeConfig(max_seq_len=T, max_batch=8,
                     decode_chunk=args.decode_chunk, paged=args.paged,
                     page_size=args.page_size, n_pages=args.n_pages,
                     chunked_prefill=bool(args.prefill_chunk),
                     prefill_chunk=args.prefill_chunk or 512,
                     prefill_buckets=buckets, cache_quant=args.cache_quant,
                     decode_splits=args.decode_splits)
    eng = ServingEngine(cfg, params, sc, projections=proj,
                        device=model.device)
    rng = np.random.default_rng(0)
    lens = rng.integers(min(4, args.prompt_len), args.prompt_len + 1,
                        args.requests)
    common = rng.integers(0, cfg.vocab_size,
                          max(int(lens.max()), 1)).astype(np.int32)

    def mk_prompt(i):
        n = int(lens[i])
        n_common = min(int(round(args.shared_frac * n)), n - 1)
        tail = rng.integers(0, cfg.vocab_size, n - n_common)
        return np.concatenate([common[:n_common], tail.astype(np.int32)])

    reqs = [Request(rid=i, prompt=mk_prompt(i),
                    max_new_tokens=args.max_new_tokens,
                    deadline_steps=args.deadline_steps or None)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    eng.generate(reqs)
    wall = time.perf_counter() - t0
    for r in reqs:
        note = "  [truncated]" if r.truncated else ""
        if r.failed:
            note = (f"  [failed: {r.error.kind} @ step {r.error.step}"
                    + (f" — {r.error.detail}" if r.error.detail else "")
                    + "]")
        print(f"req {r.rid} (prompt {len(r.prompt):3d}): "
              f"{r.out_tokens}{note}")
    print(f"capacity gain vs full cache: {eng.capacity_gain():.2f}x")
    if eng.pool is not None:
        print(f"page pool: {eng.pool.n_pages} pages of {sc.page_size} "
              f"tokens, peak {eng.peak_used_pages} used, "
              f"{eng.pool.free_count} free after the drain; "
              f"{eng.n_prefill_chunks} prefill chunks at buckets "
              f"{sorted(eng.prefill_chunk_shapes)}")
        if args.cache_quant != "none":
            # the page layout's capacity story: packed vs fp bytes per
            # cached token at the served ranks
            rk, rv = eng.ranks
            if eng.cfg.cache_quant == "none":
                print(f"cache quant {args.cache_quant}: inert (no "
                      f"compression projections; fp pages served)")
            else:
                lay, fp = get_layout(eng.cfg), FpLayout()
                packed = lay.token_bytes("k", rk) + lay.token_bytes("v", rv)
                full = fp.token_bytes("k", rk) + fp.token_bytes("v", rv)
                print(f"cache quant {args.cache_quant}: {packed} packed vs "
                      f"{full} fp byte(s)/token -> {full / packed:.2f}x "
                      f"resident capacity ({eng.pool.n_pages} physical "
                      f"pages for {sc.total_pages} fp-page units)")
    if eng.n_failed:
        kinds = ", ".join(f"{k}={n}" for k, n in eng.error_counts.items()
                          if n)
        print(f"failures: {eng.n_failed} ({kinds})")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"device {model.device}: {n_tok} tokens in {wall:.3f} s "
          f"(prefill {eng.prefill_seconds:.3f} s, decode "
          f"{eng.decode_seconds:.3f} s over {eng.n_decode_steps} steps)")


if __name__ == "__main__":
    main()
