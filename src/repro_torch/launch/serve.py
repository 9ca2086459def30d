"""Serving CLI of the port: calibrate, compress with KQ-SVD, serve requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --method kqsvd --requests 8

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --method kqsvd --requests 8 --paged --prefill-chunk 256 \\
      --cache-quant int8 --decode-splits 0

The flags are the reference CLI's (``python -m repro.launch.serve``).
``--arch`` takes tinyllama-1.1b, paper-llama2-7b, h2o-danube-1.8b
(sliding window: a ring cache on dense slots; its paged store is refused,
as in the reference), mamba2-2.7b (attention-free: no calibration,
whatever ``--method`` says, as in the reference; SSM state on dense
slots, K7 under every prefill), deepseek-v2-lite-16b (MLA and MoE: the
latent cache, compressed by KQ-SVD, on dense slots; its paged store is
refused, as in the reference), arctic-480b (MoE beside a dense
residual FFN, served on dense slots or pages), jamba-1.5-large-398b (the
hybrid: Mamba-2 SSD layers around one attention layer a period, its
attention layers' cache compressed, the SSM state beside it on dense
slots; its paged store is refused, as in the reference) and the stubs
musicgen-large and phi-3-vision-4.2b (served on token prompts, dense
slots or pages, as the reference engine serves them; their frontends'
embeddings enter through ``LM.prefill``).  Calibration is skipped only
for an attention-free stack.  The port serves the dense-slot cache
and the paged store (``--paged``, ``--page-size``, ``--n-pages``), with
exact-length or chunked prefill (``--prefill-chunk``, which turns on
paging, and ``--prefill-buckets``), quantized pages (``--cache-quant``)
and split-KV decode (``--decode-splits``), both of which turn on paging
too; optimistic admission with preempt-and-requeue (``--admission``,
``--preempt-mode``, ``--watermark-high``, ``--watermark-low``,
``--priority``; it turns on paging) and prefix sharing with copy-on-write
(``--share-prefix``, ``--prefix-index-capacity``; it turns on chunked
prefill), the token-budget scheduler with the fused prefill + decode
iteration (``--max-batched-tokens``; it turns on chunked prefill), fault
injection (``--chaos-seed``, ``--chaos-rate``) and invariant audits
(``--audit``) and data-axis shards (``--shards``: each shard an equal
slice of the slots and of the pool with its own scheduler; it turns on
chunked prefill).  Runs on the CUDA device unless ``--device`` says
otherwise; ``--shards N`` runs on the first N CUDA devices, or every
shard on ``--device`` when one is given.
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
from repro_torch.sharding.partition import serve_devices


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
    ap.add_argument("--shards", type=int, default=1,
                    help="data-axis shards for the serving engine: each "
                         "shard owns an equal slice of the slot axis with "
                         "its own page pool and scheduler, on its own "
                         "device (the first N CUDA devices, or --device "
                         "for all).  Implies --paged and chunked "
                         "prefill.  1 = unsharded parity oracle.")
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
    ap.add_argument("--max-batched-tokens", type=int, default=0,
                    help="global per-step token budget: each decoding "
                         "slot charges 1 token, prefill chunks fill the "
                         "remainder (the last chunk truncated to it) and "
                         "one chunk fuses with the decode chunk.  0 = "
                         "legacy per-request scheduling.  Implies chunked "
                         "prefill (and so --paged).")
    ap.add_argument("--admission", default="reserve",
                    choices=["reserve", "optimistic"],
                    help="paged admission policy: reserve = worst-case page "
                         "reservation; optimistic = admit on the prompt "
                         "footprint and preempt-and-requeue victims when "
                         "the pool runs dry.  Implies --paged.")
    ap.add_argument("--preempt-mode", default="recompute",
                    choices=["recompute", "swap"],
                    help="victim handling under --admission optimistic: "
                         "recompute the cache from the generated tokens, "
                         "or round-trip the pages through host memory")
    ap.add_argument("--watermark-high", type=float, default=1.0,
                    help="pool fraction optimistic admission may fill "
                         "(headroom held back for decode growth)")
    ap.add_argument("--watermark-low", type=float, default=0.0,
                    help="extra pool fraction a preemption pass frees "
                         "beyond the strict deficit (thrash guard)")
    ap.add_argument("--admit-window", type=int, default=4,
                    help="pending requests scanned for one that fits "
                         "(avoids head-of-line blocking; 1 = strict FIFO)")
    ap.add_argument("--share-prefix", action="store_true",
                    help="cross-request prefix sharing with copy-on-write: "
                         "admission maps cached prefix pages into the "
                         "block table by reference instead of prefilling "
                         "them again.  Implies --paged and chunked "
                         "prefill.")
    ap.add_argument("--prefix-index-capacity", type=int, default=512,
                    help="max live prefix-index entries (each pins one "
                         "page until reclaimed; LRU beyond this)")
    ap.add_argument("--priority", default="",
                    help="comma-separated Request.priority tiers, cycled "
                         "over the requests (empty = all tier 0); under "
                         "--admission optimistic, preemption evicts lower "
                         "tiers first")
    ap.add_argument("--calib-seqs", type=int, default=8)
    ap.add_argument("--calib-len", type=int, default=64)
    ap.add_argument("--shared-frac", type=float, default=0.0,
                    help="fraction of each prompt drawn from one common "
                         "prefix")
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="per-request total step budget; 0 = unbounded")
    ap.add_argument("--audit", action="store_true",
                    help="cross-check pool refcounts / free list / block "
                         "tables / page layouts after every engine step "
                         "(invariants.audit)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="arm a seeded chaos FaultInjector: every "
                         "recoverable fault point fires with probability "
                         "--chaos-rate per hit, reproducibly")
    ap.add_argument("--chaos-rate", type=float, default=0.05,
                    help="per-hit fault probability under --chaos-seed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.shards > 1 and not args.prefill_chunk:
        print("--shards shards the chunked-prefill dispatch: enabling "
              "chunked prefill (--prefill-chunk 8)")
        args.prefill_chunk = 8
    if args.shards > 1 and args.n_pages % args.shards:
        n = -(-args.n_pages // args.shards) * args.shards
        print(f"--shards needs equal per-shard pools: rounding "
              f"--n-pages {args.n_pages} up to {n}")
        args.n_pages = n
    if args.max_batched_tokens and not args.prefill_chunk:
        print("--max-batched-tokens schedules prefill at chunk "
              "granularity: enabling chunked prefill (--prefill-chunk 8)")
        args.prefill_chunk = 8
    if args.share_prefix and not args.prefill_chunk:
        print("--share-prefix prefills only the unshared tail: enabling "
              "chunked prefill (--prefill-chunk 8)")
        args.prefill_chunk = 8
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
    if args.admission == "optimistic" and not args.paged:
        print("--admission optimistic preempts pages: enabling --paged")
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
                     prefill_buckets=buckets,
                     admission=args.admission,
                     preempt_mode=args.preempt_mode,
                     watermark_high=args.watermark_high,
                     watermark_low=args.watermark_low,
                     admit_window=args.admit_window,
                     share_prefix=args.share_prefix,
                     prefix_index_capacity=args.prefix_index_capacity,
                     audit=args.audit,
                     chaos_seed=args.chaos_seed,
                     chaos_rate=args.chaos_rate,
                     max_num_batched_tokens=args.max_batched_tokens,
                     cache_quant=args.cache_quant,
                     decode_splits=args.decode_splits,
                     shards=args.shards)
    place = {"device": model.device}
    if args.shards > 1:
        place = {"devices": serve_devices(args.shards, args.device)}
    eng = ServingEngine(cfg, params, sc, projections=proj, **place)
    rng = np.random.default_rng(0)
    lens = rng.integers(min(4, args.prompt_len), args.prompt_len + 1,
                        args.requests)
    tiers = [int(x) for x in args.priority.split(",") if x.strip()] or [0]
    common = rng.integers(0, cfg.vocab_size,
                          max(int(lens.max()), 1)).astype(np.int32)

    def mk_prompt(i):
        n = int(lens[i])
        n_common = min(int(round(args.shared_frac * n)), n - 1)
        tail = rng.integers(0, cfg.vocab_size, n - n_common)
        return np.concatenate([common[:n_common], tail.astype(np.int32)])

    reqs = [Request(rid=i, prompt=mk_prompt(i),
                    max_new_tokens=args.max_new_tokens,
                    priority=tiers[i % len(tiers)],
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
    if args.chaos_seed is not None and eng.faults is not None:
        fired = eng.faults.points_fired()
        print(f"chaos(seed={args.chaos_seed}, rate={args.chaos_rate}): "
              f"{len(eng.faults.fired_log)} fault(s) fired at "
              f"{list(fired) or 'no points'}; "
              f"retries={eng.n_retried}, "
              f"swap fallbacks={eng.n_swap_fallbacks}")
    if args.audit:
        print(f"audits: {eng.n_audits} pass(es), every "
              f"{sc.audit_every} step(s), none failed")
    if eng.pool is not None:
        print(f"page pool: {eng.pool.n_pages} pages of {sc.page_size} "
              f"tokens, peak {eng.peak_used_pages} used, "
              f"{eng.pool.free_count} free after the drain; "
              f"{eng.n_prefill_chunks} prefill chunks at buckets "
              f"{sorted(eng.prefill_chunk_shapes)}")
        if args.shards > 1:
            # pooled capacity: shards x the per-shard physical pool
            # (already scaled by the page layout's capacity multiplier)
            print(f"sharded: {args.shards} shard(s) x "
                  f"{eng._local_phys} physical page(s) = "
                  f"{eng.pool.n_pages} pooled "
                  f"(x{eng.workers[0].capacity_x:.2f} resident "
                  f"capacity multiplier); per-shard occupancy: "
                  + ", ".join(f"s{w._shard}={w.pool.used_count}"
                              f"/{w.pool.n_pages}" for w in eng.workers)
                  + "; completed per shard: "
                  + ", ".join(f"s{w._shard}={w.n_completed}"
                              for w in eng.workers)
                  + "; devices: " + ", ".join(str(d) for d in eng.devices))
        print(f"admission={args.admission}: preemptions="
              f"{eng.n_preempted} (swap out/in {eng.n_swapped_out}/"
              f"{eng.n_swapped_in}), failed={eng.n_failed}")
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
        if args.share_prefix:
            print(f"prefix sharing: {eng.n_shared_pages} page(s) / "
                  f"{eng.n_shared_tokens} token(s) shared, "
                  f"{eng.n_full_hits} whole-prompt hit(s), "
                  f"{eng.n_cow_forks} COW fork(s), "
                  f"{eng.n_reclaimed} index entr(ies) reclaimed; "
                  f"peak pool occupancy {eng.peak_used_pages} page(s)")
    if eng.n_failed:
        kinds = ", ".join(f"{k}={n}" for k, n in eng.error_counts.items()
                          if n)
        print(f"failures: {eng.n_failed} ({kinds})")
    if args.max_batched_tokens:
        # how the per-step budget split between decode charges and
        # prefill fill, and how often a chunk fused with the decode chunk
        log = eng.budget_log
        dec = sum(e["n_decode"] for e in log)
        pf = sum(e["prefill_tokens"] for e in log)
        print(f"token budget {args.max_batched_tokens}/step over "
              f"{len(log)} step(s): {dec} decode + {pf} prefill "
              f"token(s) scheduled, {eng.n_fused_steps} fused "
              f"iteration(s), {eng.n_truncated_chunks} chunk(s) "
              f"truncated at the residual budget")
        for e in log[:12]:
            print(f"  step {e['step']:3d}: budget={e['budget']:3d} "
                  f"decode={e['n_decode']:2d} "
                  f"prefill={e['prefill_tokens']:3d} "
                  f"admitted={e['admitted']}"
                  + ("  [fused]" if e["fused"] else ""))
        if len(log) > 12:
            print(f"  ... {len(log) - 12} more step(s)")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"device {model.device}: {n_tok} tokens in {wall:.3f} s "
          f"(prefill {eng.prefill_seconds:.3f} s, decode "
          f"{eng.decode_seconds:.3f} s over {eng.n_decode_steps} steps)")


if __name__ == "__main__":
    main()
