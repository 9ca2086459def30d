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
3d. profile  one paged decode step (8 slots at position 512), and its
             roofline from ``repro_torch.roofline.analysis`` (the H100's
             datasheet rates): ``model_flops_for`` and ``useful_bytes_for``
             at 8 slots and position 512 under the reference's rank rule
             (``d_head // 2``, not the solved ranks), the memory term
             beside the profiled busy time, then the ``summarize`` line;
3p. sharded  (after 3d) 3c's paged engine with ``shards=2``, both shards on
             the one card (``devices=[dev, dev]``): each shard 4 slots and
             128 pages, 3c's model, projections and 16 requests.  Counts
             zeroed just before the drain and read just after, per shard:
             K1 once per layer per decode step of each shard, K2 once per
             layer per prefill chunk of each, nothing else and no plain
             version; every request served in full, both pools whole, the
             first tokens equal 3c's and the agreement with 3c's tokens
             printed (the top-2 margin where one differs); each shard's
             completed requests and the step wall p50 / max;
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
3j. preempt  (run after 3f, on phase 3's model and projections) the paged
             engine with optimistic admission and with prefix sharing at
             full width: ``ServeConfig(max_batch=8, max_seq_len=2048,
             page_size=16, prefill_chunk=256, decode_splits=1)``.  (a) 24
             requests of 128..768 prompt tokens and ``NEW_3J_A`` (96) new,
             priorities 0, 1 cycled, on a pool of ``POOL_3J`` pages
             (watermarks 0.9 / 0.05): reserve admission (the oracle),
             optimistic recompute and optimistic swap; each optimistic
             run preempts, swap
             restores as many as it saves, and the swap run's tokens equal
             the reserve run's; the recompute run's agreement is printed
             with the top-2 logit margin at each first differing token.
             (b) 24 requests on one 1000-token system prompt with private
             suffixes of 8..200 tokens, ``NEW_3J_B`` (16) new, the last
             four repeating
             the first four, with and without ``share_prefix``, on fp and
             on int8 pages: sharing shares pages, forks and hits whole
             prompts, and prefills fewer tokens (fp: fewer K2 launches).
             Every run: each request served in full, the pool whole but
             for index pins, K1 and K2 (fp) or K5 (int8) once per layer
             per decode step or chunk, and no plain version; peak pages,
             slots held a step, decode tokens/s, prefill seconds, the
             swapped bytes and the ms a swap-out and a swap-in take;
3k. chaos    (after 3j, same model and projections) fault injection,
             audits and the token budget at full width, one workload:
             32 requests (``prompts_3k``: a 48-token system prompt, 24..64
             private tokens, eight of them followed by their own leading
             whole pages) of 48 new tokens on ``POOL_3K`` pages of 16
             (watermarks 1.0 / ``WATERMARK_LOW_3K``), optimistic swap with
             prefix sharing, 8 slots of 2048, chunks of 256.  (a) the
             unfaulted oracle; (b) chaos at seed 0, rate 0.05, audits
             every 2nd step: all seven recoverable points fire, the audits
             number steps // 2, every request is served; (c) the token
             budget of 512: every step's budget held, fused steps and
             truncated chunks, each fused step that neither preempted nor
             swapped launches its chunks' K2 before the decode chunk's K1
             and syncs the host once (explicit syncs and torch's sync
             debug mode); (d) the budget on int8 pages with dynamic splits
             under chaos and audits: K5 and K5 split only; (e) a
             ``nan_logits`` fault on its 3rd hit: one ``numerics``
             failure.  K1 / K2 (or K5) launches per decode step or chunk,
             no plain version, the pool whole but for index pins.  A CPU
             run of the same scheduler (reduced tinyllama, float32) gives
             (b)'s firings and (c)'s budget log and every count of both.
             Printed: step walls (p50, max), decode ms/step and tokens/s,
             prefill seconds, swaps, forks, reclaims, the fired points,
             the ms an audit takes, (b)'s tokens against (a)'s;
3l. train    smollm-360m at full width (32 layers, d_model 960, 15 / 5
             heads of 64, m = 3, d_ff 2560, vocab 49152, tied
             embeddings, bf16, seeded random init): ``Trainer`` with
             AdamW (float32 moments), remat "nothing", 20 steps of 8 x 512
             Zipf tokens, a checkpoint every 10 steps in a temporary
             directory the phase removes, and a failure injected once at
             step 13 that the trainer retries from step 10: one retry, 20
             steps done, the loss falling, a fresh ``Trainer`` resuming at
             step 20; K6 32 x 2 launches a step executed (forward and
             remat recompute), its plain backward (``flash_attention_
             backward``) 32 calls a step, the plain forward never.
             Printed: ms a step (p50, max), training tokens/s, peak device
             memory, checkpoint bytes and the ms to save (the blocking
             host copy, the write on its thread) and to restore; one
             profiled step (busy, idle share, launches, K6's and the plain
             backward's shares of the busy time, the backward's device
             span).  Then ``make_calibrate_step`` on the trained
             params (16 x 512 tokens in batches of 4, K6 32 x 4), its
             Grams held to the host ``GramAccumulator`` path at rtol 2e-4,
             atol 2e-3, the KQ-SVD solve at epsilon 0.1, and the paged
             engine with chunked prefill (pages of 16, 256 of them, chunks
             of 256) serving 16 requests of 32..1000 prompt tokens and 32
             new: K1 32 x decode steps, K2 32 x chunks, no plain version,
             the pool whole (the first served model with m = 3);
3q. mesh     (after 3l) tinyllama-1.1b at full width and depth (22
             layers, bf16, seeded init) trained 4 steps of 8 x 512 Zipf
             tokens with AdamW (lr 3e-4) twice from the same init and
             batches: by ``Trainer(mesh=...)`` on a (1, 1) ("data",
             "model") mesh of a one-rank NCCL group (DTensor params and
             optimizer state placed by ``params_shardings``, the batch by
             ``batch_shardings``, K6 per shard through ``local_map``),
             and by the one-device ``Trainer``.  Each run: K6 22 x 2
             launches a step (forward and remat recompute), its plain
             backward 22 a step, its plain forward never; every mesh loss
             within 1e-2 relative of the one-device run's; the mesh's
             step-4 params saved (gathered, rank 0 writes) and restored
             with no mesh and onto the mesh, bit for bit the gathered
             params.  Printed: ms a step p50 on both paths (their
             difference is DTensor's host cost), peak device memory,
             checkpoint bytes, save and restore ms.  The group is
             destroyed before 3g;
3r. mesh     (after 3q) serving and every family's training on a (1, 1)
    serving  mesh of a one-rank NCCL group.  (a) tinyllama-1.1b at full
             width and depth, phase 3's seeded params and projections:
             ``make_prefill_step`` of 8 prompts of 512 into a cache of
             1024, then 32 greedy ``make_decode_step``s, three times:
             with no mesh; on the mesh (params by ``params_shardings``,
             projections by ``projection_shardings``, tokens by
             ``batch_shardings``, the cache as ``cache_shardings`` gives
             it); on the mesh with the cache's sequence placed on the
             model axis (``Shard(2)`` of a size-1 axis: K3's span output
             and the LSE merge on the main path).  Counts zeroed before
             and read after each run: K6 22, K3 22 x 32 (or K3 span 22 x
             32 and as many merges), plain versions none; tokens equal no
             mesh's, the logits' largest difference printed, ms a decode
             step p50 of each.  (b) deepseek-v2-lite-16b at full width, 3
             of 27 layers (``DEPTH_3R_DEEPSEEK``), and (c) mamba2-2.7b at
             full width, 16 of 64 layers (``DEPTH_3R_MAMBA``): 3 AdamW
             steps of 4 x 512 tokens through ``Trainer(mesh=...)`` and
             the one-device ``Trainer``: losses within 1e-2 relative, K6
             (MLA at (192, 128)) and K7 layers x 2 x 3 (forward and remat
             recompute, through ``local_map`` on the mesh), their plain
             forwards never; MoE's ``dropped_frac`` (G = 1 group a layer
             on (1, 1)), ms a step and peak memory printed;
3s. dry run  (after 3r) ``repro_torch.launch.dryrun.run_cell`` with
             ``device_type="cuda"`` (fake CUDA tensors: every wrapper on
             its kernel's route books its work and computes nothing), each
             cell in a child process of its own (a fake process group
             cannot share a process with an NCCL one), all started
             together when this phase begins: their host work runs
             beside (b)'s real steps only, and no earlier phase is timed
             under it.
             (a) ``SAMPLE_3S`` on the fake (16, 16) mesh: tinyllama
             ``train_4k``, ``prefill_32k kqsvd`` and ``decode_32k
             kqsvd_int8``, deepseek-v2-lite ``decode_32k kqsvd``, mamba2
             ``long_500k``, jamba ``long_500k kqsvd``, and tinyllama
             ``train_4k`` on the fake (2, 16, 16) mesh: each ``ok``, its
             ``summarize`` line, hbm a device, collectives by kind and the
             kernels booked printed.  (b) 3q's training step (tinyllama at
             full width, 8 x 512, AdamW) and 3r (a)'s compressed decode
             step (8 slots, a cache of 1024 at its last position), and
             3q's training step at ``grad_accum`` 2 (``ACCUM_3S``: the dry
             run traces one microbatch and counts it twice), dry run
             on a fake one-rank (1, 1) group, and the same steps run for
             real on the card (a one-rank NCCL (1, 1) mesh, inputs placed
             as the dry run places them; the accumulated step runs both
             microbatches) under the same op and collective
             counts: FLOPs equal within 1e-6 relative, the kernels booked
             equal to the launch counters, the dry run's peak within a
             factor 2 of ``torch.cuda.max_memory_allocated()`` of the real
             step (the ratio printed);
3g. window  h2o-danube-1.8b at full width (24 layers, d_head 80, window
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
3m. moe/mla  (after 3i) the MoE and MLA families at full width, seeded
             random bf16 weights, each model freed before the next is
             built.  (a) deepseek-v2-lite-16b at full width cut to 7 of
             its 27 layers (``DEPTH_3M``: the dense first layer of 10944
             and 6 MoE layers; d_model 2048, 16 heads, MLA kv_lora 512 +
             rope 64, 64 experts top 6 + 2 shared of 1408; 4.7 B
             parameters, 15.7 B at full depth): device calibration on 16 x 512 tokens in batches
             of 4 and the solve at epsilon 0.1 on the latent (Hkv 1, m 16,
             ``c_v`` 32768 wide), then the dense-slot engine (8 slots of
             1024) serving 16 requests of 32..512 prompt tokens and 32 new.
             Counts zeroed before the calibration and read after the
             drain: K6 = 7 x (4 + 16), at (192, 128) with H = Hkv = 16; no
             K1-K5, K7 or plain attention.  Printed: ranks, capacity gain
             against the raw latent + rope cache (576 a token), decode ms a
             step, prefill s, peak memory, the MoE ``dropped_frac`` of one
             profiled 512-token prefill, and a profiled decode step (8 slots
             at 512) with the MoE FFN's share of busy time.  (b) arctic-480b
             at full width cut to 2 of its 35 layers (128 experts of 4864
             top 2 beside a dense residual FFN, 56 query heads padded to 64
             over 8 kv heads: m 8; 27.7 B parameters): calibration on 16 x
             512 (K6 2 x 4 at d_head 128), then 3c's paged engine (pages of
             16, 256 of them, chunks of 256) serving 16 requests of 32..1000
             and 32 new on fp pages (K1 = 2 x decode steps, K2 = 2 x
             chunks, nothing else) and on int8 pages with dynamic splits
             (K5 + K5 split = 2 x decode steps, nothing else), every request
             done and the pool whole; a profiled fp decode step;
3n. hybrid   (after 3m) jamba-1.5-large-398b at full width cut to its
             first 5 of 72 layers (``DEPTH_3N``): 4 Mamba-2 SSD layers
             (d_inner 16384, 128 heads of (128, 64), d_conv 4) and the
             period's GQA attention layer (64 / 8 heads of 128), MoE of 16
             experts of 24576 top 2 on layers 0, 2, 4 and a SwiGLU of 24576
             on 1 and 3 (33.0 B parameters, 66.1 GB in bf16), seeded; device
             calibration on 16 x 512 tokens and the solve at epsilon 0.1 for
             the one attention layer; the dense-slot engine (4 slots of
             4608) serving 8 requests of 1, 255, 257, 1000, 2049, 3000, 4095
             and 4096 prompt tokens and 16 new.  Counts zeroed before the
             calibration and read after the drain: K7 = 4 x (prefills +
             calibration batches), K6 = 1 x the same, K3 = 1 x decode steps,
             K1, K2, K4, K5 and every plain version never.  Printed: ranks,
             peak memory, capacity gain, a slot's SSM state bytes beside its
             compressed and full cache bytes; then a profiled decode step
             (4 slots at 4096, the MoE FFN's share) and a profiled
             4096-token prefill (K7's share and each of its kernels' ms);
3o. stubs    (a) musicgen-large at full width, 24 of its 48 layers
             (``DEPTH_3O``; 32 MHA heads of 64, d_ff 8192, vocab 2048;
             3.23 B parameters at full depth): device
             calibration on 16 x 512 frame embeddings of the stub frontend
             (``data.stub_batch``: seeded, normal x 0.1; K6 24 x 4 at (64,
             64)); the solve in threads (as ``launch/serve.py`` runs it)
             timed, and on 4 layers against one layer after another
             (equal within 1e-12 of the largest entry);
             then 3c's paged engine (fp pages of 16, 256 of them,
             chunks of 256) serving 16 token requests of 32..1000 and 32
             new: K1 = 24 x decode steps, K2 = 24 x chunks, nothing else,
             the pool whole; a profiled decode step.  (b) phi-3-vision-4.2b
             at full width and depth (32 layers, 32 MHA heads of 96, d_ff
             8192; 3.82 B parameters): device calibration on 16 x (576
             patch embeddings ahead of 512 text tokens), K6 32 x 4 at S
             1088; the dense-slot engine (8 slots of 2048) serving 16 text
             requests of 32..1000 and 32 new (K6 32 x prefills, K3 32 x
             decode steps, nothing else); then one image-prefix request at
             model level, ``LM.prefill`` of 576 patches and 300 tokens and
             16 greedy ``decode_step`` calls: the cache covers P + S + 16
             positions, K6 32 and K3 32 x 16;
4.  kernels  each kernel against its plain PyTorch version on the card at
             the main paths' shapes (the calibrated ranks; K2 at the last
             chunk of a 1000-token prompt, at a first chunk and at a chunk
             the token budget truncated, 248 tokens from position 504; K6 at
             tinyllama's, jamba's (m 8, d_head 128), phi-3-vision's
             (576 patches + 512 tokens, d_head 96) and musicgen's (m 1,
             d_head 64) calibration batches,
             at danube's windowed
             prefill, the plain one there at 4608 tokens, at
             paper-llama2-7b's calibration batch, MHA at d_head 128, and
             at deepseek-v2-lite's, MLA's (192, 128) with H = Hkv = 16; K1,
             K5 and K2's last chunk at arctic's m 8 and ranks; K1 and K2's
             last chunk at musicgen's m 1; K3 at jamba's m 8, d_head 128
             and 4608-token slots and at phi-3-vision's m 1) and
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
             kernels' share of a call from ``torch.profiler``), at jamba's
             full-width prefill (128 heads of (128, 64), S 4096, with the
             registers and spills phase 2 printed for its instantiations
             and each kernel's share of a call) and on the
             reduced and the reference sweep's shapes with and without an
             initial state, two groups of four heads, chunks of 1, 17 and
             100 tokens and S 0; K3's span output (rows and LSE) at 3r's
             shape and at a quarter span of 256 whose rows lie before,
             across and past it (empty rows: zero and LSE -1e30), timed
             beside SDPA over the span, and two half spans merged by their
             LSE against one whole-cache K3 call;
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
             pages with 3 splits, the dense int8 cache and the sharded
             engine (2 shards on the card, fp pages and int8 pages with
             dynamic splits; its agreement with 1 shard printed) of
             tinyllama,
             and reduced h2o-danube-1.8b (window 16) on dense slots with
             the full cache, KQ-SVD and the dense int8 cache, and reduced
             mamba2-2.7b (chunk 32, prompts of 1..70 tokens) on dense
             slots, give identical greedy tokens; so do optimistic
             recompute and swap on 11 pages, and int8 pages shared under
             swap (prompts behind a common 13-token prefix), which also
             equal the reserve engine's tokens and count the same
             preemptions, swaps, shared pages and forks on both; so do
             chaos with audits, the token budget on fp pages and the
             budget on int8 pages under chaos, with the same firings and
             budget logs on both and the legacy engine's tokens; prefill,
             ``LM.prefill_chunk`` and dense and paged ``decode_step``
             logits agree within 2e-4, and danube's prefill and ring
             decode logits and mamba2's prefill and decode logits too; a
             float32 train step of reduced tinyllama (K6 and its plain
             backward on the card) gives the CPU's loss (rtol 1e-5),
             gradients (within 1e-4 of each leaf's max-abs) and params
             after one AdamW step (elements whose |g| is below 1e-6 of
             their leaf's max left out and counted); reduced smollm-360m
             (tied embeddings) gives the same greedy tokens on the dense
             and the paged chunked KQ-SVD engines; so do reduced
             deepseek-v2-lite on dense slots (full and KQ-SVD) and reduced
             arctic on fp pages and int8 pages with dynamic splits; a
             float32 deepseek-v2-lite train step gives the CPU's loss, MoE
             aux losses and gradients; and ``moe_ffn`` in decode mode at
             64 experts top 6 and 128 top 2 (narrow widths, 8 slots, two
             dead) gives the CPU's keep mask and outputs where capacity
             binds; reduced jamba-1.5-large-398b, musicgen-large and
             phi-3-vision-4.2b with KQ-SVD calibrated on the stub frontend's
             batches: a prefill from each one's input (tokens, frame
             embeddings, patches ahead of text) and 4 decode steps give
             logits within 2e-4 of the CPU's, and jamba's dense-slot and
             musicgen's paged chunked engines the same greedy tokens.

Every phase's seconds are printed as it ends and together before the
result.  The last two lines of standard output are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX or of
the reference package, and exits non-zero where CUDA is not available.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM's datasheet rates (700 W), from the port's roofline module
from repro_torch.roofline.analysis import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS as PEAK_BF16, PEAK_FLOPS_F32)
PEAK_FLOPS = {"bfloat16": PEAK_BF16,   # dense tensor-core rate
              "float32": PEAK_FLOPS_F32}   # CUDA cores, no TF32
TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # tests/test_kernels.py:15-17
# kernel and plain version read the same inputs and both accumulate in
# float32, so in bfloat16 they also agree to two ulps of the output
ULPS_BF16 = 8e-3
# phase 3j (a): a pool tight enough that reserve admission holds slots
# back and optimistic admission preempts (sized on the CPU with the same
# scheduler: 2 preemptions in either mode)
POOL_3J = 176
# phase 3j (a): new tokens a request (128 until the phase 4 rows at phase
# 3l's shapes came in; 96 still preempts twice in either optimistic mode
# on the CPU sizing run, and saves some 400 decode steps of the three)
NEW_3J_A = 96
# phase 3j (b): new tokens a request (64 until phase 3l came in; 16 keeps
# the script inside its time, and the sharing counts are the prompts')
NEW_3J_B = 16
# phase 3k: 32 requests behind a 48-token system prompt on a pool of 40
# pages that victims thrash through (watermarks 1.0 / 0.5), sized on the
# CPU with the same scheduler so that chaos at seed 0, rate 0.05 reaches
# every recoverable point (swap_in first fires on its 176th hit)
POOL_3K, WATERMARK_LOW_3K, NEW_3K = 40, 0.5, 48
# phase 3n: jamba-1.5-large-398b's depth, cut from 72 to the first 5
# layers, 4 Mamba-2 SSD layers and the period's attention layer (66 GB in
# bf16; a whole period of 8 would be 90 GB)
DEPTH_3N = 5
# phase 3m (a): deepseek-v2-lite's depth, cut from 27 to its dense first
# layer and 6 MoE layers (27 until jamba's and the stubs' phases came in:
# the host solve of its 27 latent layers took 115 s of the script)
DEPTH_3M = 7
# phase 3r (b): deepseek-v2-lite's depth for three AdamW steps on a mesh
# beside one device, cut from 27 to its dense first layer and two MoE
# layers (about 1.7 B params: 33 GB of bf16 weights and gradients, f32
# moments and the update's copy); (c): mamba2-2.7b's, 16 of 64 layers
DEPTH_3R_DEEPSEEK = 3
# phase 3o (a): musicgen-large's depth, cut from 48 to 24 layers, and the
# solve timed in threads against the serial loop on its first 4 layers
# (48 and 16 until phase 3s came in: at those depths 3o (a) took 107.6 s
# and 37.4 s at these, on an H100 at 700 W, and the script's phases
# without the cut would come to about 1000 s of its 1200 s)
DEPTH_3O, SOLVE_LAYERS_3O = 24, 4
DEPTH_3R_MAMBA = 16
# phase 3s (a): the dry run's sample cells, (arch, shape, variant, on the
# (2, 16, 16) mesh); (b): 3q's training step and 3r (a)'s decode step
SAMPLE_3S = (("tinyllama-1.1b", "train_4k", "baseline", False),
             ("tinyllama-1.1b", "prefill_32k", "kqsvd", False),
             ("tinyllama-1.1b", "decode_32k", "kqsvd_int8", False),
             ("deepseek-v2-lite-16b", "decode_32k", "kqsvd", False),
             ("mamba2-2.7b", "long_500k", "baseline", False),
             ("jamba-1.5-large-398b", "long_500k", "kqsvd", False),
             ("tinyllama-1.1b", "train_4k", "baseline", True))
SHAPE_3S_TRAIN = ("train_3q", 512, 8, "train")
SHAPE_3S_DECODE = ("decode_3r", 1024, 8, "decode")
# phase 3s (b): the grad_accum of its third real step (3q's shape)
ACCUM_3S = 2
# one dry-run cell in a process of its own: argv[1] the JSON of (arch,
# shape name or ShapeSpec fields, variant, multi_pod, mesh shape or None,
# grad_accum or None (``train_config_for``'s), output directory); prints
# the record, with its summary line, last
DRYRUN_CHILD = r"""
import json, sys
from repro_torch.config import ShapeSpec, TrainConfig
from repro_torch.launch.dryrun import run_cell
from repro_torch.roofline.analysis import Roofline, summarize
arch, shape, variant, multi, mesh, accum, out = json.loads(sys.argv[1])
shape = ShapeSpec(*shape) if isinstance(shape, list) else shape
rec = run_cell(arch, shape, multi, variant, out,
               mesh_shape=tuple(mesh) if mesh else None, device_type="cuda",
               tc=TrainConfig(grad_accum=accum) if accum else None)
if rec["status"] == "ok":
    rec["summary"] = summarize(Roofline(**{
        k: rec[k] for k in Roofline.__dataclass_fields__}))
print(json.dumps(rec))
"""
SOURCES = ("kq_decode", "kq_paged", "flash", "ssd")
# K7's kernels by name: bf16's three (csrc/ssd_tc.cuh), float32's one
K7_KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_scan_kernel",
              "ssd_kernel<")


# seconds of each phase that ended, in order (printed before the result)
PHASE_SECONDS: dict = {}


@contextlib.contextmanager
def phase(name: str):
    """Print a phase's start and outcome and keep its seconds; a failure
    propagates."""
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"== {name}: FAILED after {time.perf_counter() - t0:.1f} s",
              flush=True)
        raise
    key = " ".join(name.split(" ")[:2])        # "3n serve", "3o (a)"
    PHASE_SECONDS[key] = time.perf_counter() - t0
    print(f"== {name}: ok ({PHASE_SECONDS[key]:.1f} s)", flush=True)


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


def start_dryrun_children():
    """Phase 3s's dry-run cells, each ``DRYRUN_CHILD`` in a process of its
    own (a fake process group cannot share a process with an NCCL one),
    all started together: the sample cells, then 3q's and 3r's steps and
    3q's at ``ACCUM_3S`` on a (1, 1) mesh.  Returns (jobs, processes,
    output directory)."""
    jobs = [(arch, shape, variant, multi, None, None)
            for arch, shape, variant, multi in SAMPLE_3S]
    jobs += [("tinyllama-1.1b", list(sh), variant, False, (1, 1), accum)
             for sh, variant, accum in ((SHAPE_3S_TRAIN, "baseline", None),
                                        (SHAPE_3S_DECODE, "kqsvd", None),
                                        (SHAPE_3S_TRAIN, "baseline",
                                         ACCUM_3S))]
    out = tempfile.mkdtemp(prefix="chip_smoke_3s_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CHILD, json.dumps(list(job) + [out])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for job in jobs]
    CHILDREN.extend(procs)
    return jobs, procs, out


def stop_children(procs) -> None:
    """Kill and reap any of ``procs`` still running."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


# every child process the script starts, stopped at exit whatever happens
CHILDREN: list = []
atexit.register(lambda: stop_children(CHILDREN))


def work_bytes_flops(work) -> tuple:
    """A kernel's ``*_work`` ``(flops, bytes)`` in ``measure``'s order."""
    return work[1], work[0]


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
    events = prof.key_averages()
    cuda_t = torch.autograd.DeviceType.CUDA
    # the MoE FFN's profiler range: its device-side annotation is not a
    # kernel (out of the busy sum); its host range's device time is the
    # time of the kernels launched inside it
    rows = [(e.key, e.device_time_total / 1e3 / steps, e.count // steps)
            for e in events if e.device_time_total > 0
            and e.key != "moe_ffn"
            and getattr(e, "device_type", None) == cuda_t]
    busy = sum(r[1] for r in rows)
    attn = sum(r[1] for r in rows if any(
        k in r[0] for k in ("attend_kernel", "decode_tc_kernel",
                            "combine_kernel")))
    moe = sum(e.device_time_total for e in events if e.key == "moe_ffn"
              and getattr(e, "device_type", None) != cuda_t) / 1e3 / steps
    launches = sum(r[2] for r in rows)
    if not busy:
        print(f"{label} decode step, synced host wall: {wall:.3f} ms; the "
              f"profiler saw no device time")
        return {"wall_ms": wall, "steps": 3 + 2 * steps}
    print(f"{label} decode step, synced host wall: {wall:.3f} ms; device "
          f"busy {busy:.3f} ms ({len(rows)} kernel kinds, {launches} "
          f"launches); idle share {1 - busy / wall:.3f}; attention kernels "
          f"{attn:.4f} ms ({attn / busy:.3f} of busy)"
          + (f"; MoE FFN kernels {moe:.4f} ms ({moe / busy:.3f} of busy)"
             if moe else ""))
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {ms:8.4f} ms/step  {n:5d} launches/step  {name[:80]}"
              f"  ({ms / busy:.3f} of busy)")
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall,
            "launches": launches, "attn_ms": attn, "moe_ms": moe,
            "steps": 3 + 2 * steps}


def profile_prefill(label: str, model, params, tokens,
                    kernels: tuple) -> None:
    """Where one exact-length prefill's time goes: synced host wall,
    device busy time from ``torch.profiler``, the idle share, launches,
    the share of the kernels whose names hold one of ``kernels`` (and
    each such kernel's device ms), a MoE stack's FFN share (its
    ``moe_ffn`` range, as ``profile_decode`` reads it) and the largest
    device entries; after one warm-up prefill."""
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
    events = prof.key_averages()
    cuda_t = torch.autograd.DeviceType.CUDA
    # the MoE FFN's range is no kernel (out of the busy sum); its host
    # range's device time is that of the kernels launched inside it, as
    # in profile_decode
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in events if e.device_time_total > 0
            and e.key != "moe_ffn"
            and getattr(e, "device_type", None) == cuda_t]
    busy = sum(r[1] for r in rows)
    moe = sum(e.device_time_total for e in events if e.key == "moe_ffn"
              and getattr(e, "device_type", None) != cuda_t) / 1e3
    if not busy:
        print(f"{label} prefill of {T} tokens: the profiler saw no device "
              f"time")
        return
    mine = [r for r in rows if any(k in r[0] for k in kernels)]
    ms = sum(r[1] for r in mine)
    print(f"{label} prefill of {T} tokens, profiled host wall: {wall:.3f} "
          f"ms; device busy {busy:.3f} ms ({sum(r[2] for r in rows)} "
          f"launches); idle share {max(0.0, 1 - busy / wall):.3f}; "
          f"{' + '.join(kernels)} {ms:.3f} ms ({ms / busy:.3f} of busy)"
          + (f"; MoE FFN kernels {moe:.3f} ms ({moe / busy:.3f} of busy)"
             if moe else ""))
    for name, t, n in mine:
        print(f"  {t:8.4f} ms  {n:5d} launches  {name[:80]}  "
              f"({t / busy:.3f} of busy)")
    print("  largest:")
    for name, t, n in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"  {t:8.4f} ms  {n:5d} launches  {name[:80]}"
              f"  ({t / busy:.3f} of busy)")


def profile_train_step(label: str, trainer, state, batch) -> dict:
    """Where one training step's time goes (after two warm-up steps, from
    ``state``, which it leaves as it is): the profiled step's synced host
    wall (profiler overhead included) and its device busy time from
    ``torch.profiler`` (sum of kernel times), so the idle share reads
    both from one step; launches, K6's kernels' share of the busy time and the plain
    backward's (the kernels launched inside its ``flash_attention_backward``
    range), and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def step():
        out = trainer.train_step(state["params"], state["opt"], batch)
        float(out[2]["loss"])
        return out
    for _ in range(2):
        step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    cuda_t = torch.autograd.DeviceType.CUDA
    name = "flash_attention_backward"
    # the backward's range shows on the device timeline too (a user
    # annotation spanning its kernels and the gaps between them): not a
    # kernel, so out of the busy sum
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in events
            if e.device_time_total > 0 and e.key != name
            and getattr(e, "device_type", None) == cuda_t]
    busy = sum(r[1] for r in rows)
    if not busy:
        print(f"{label}, profiled host wall: {wall:.3f} ms; the profiler "
              f"saw no device time")
        return {"wall_ms": wall}
    k6 = [r for r in rows if "flash_" in r[0] and "_kernel" in r[0]]
    k6_ms, k6_n = sum(r[1] for r in k6), sum(r[2] for r in k6)
    # the backward's kernels: the device time of its host range (the
    # kernels its ops launched); its device-side annotation gives the span
    rng_ = [e for e in events if e.key == name]
    span = sum(e.device_time_total for e in rng_
               if getattr(e, "device_type", None) == cuda_t) / 1e3
    bwd_ms = sum(e.device_time_total for e in rng_
                 if getattr(e, "device_type", None) != cuda_t) / 1e3
    launches = sum(r[2] for r in rows)
    print(f"{label}, profiled host wall: {wall:.3f} ms; device busy "
          f"{busy:.3f} ms ({launches} launches); idle share "
          f"{max(0.0, 1 - busy / wall):.3f}; K6 {k6_ms:.3f} ms in {k6_n} "
          f"launches ({k6_ms / busy:.3f} of busy); plain backward "
          f"{bwd_ms:.3f} ms of kernels ({bwd_ms / busy:.3f} of busy) over "
          f"a device span of {span:.3f} ms")
    for name, t, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {t:8.4f} ms  {n:5d} launches  {name[:80]}"
              f"  ({t / busy:.3f} of busy)")
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall,
            "launches": launches, "k6_ms": k6_ms, "bwd_ms": bwd_ms,
            "bwd_span_ms": span}


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


def serve_driven(eng, reqs, sync) -> dict:
    """Drain ``reqs`` step by step, sampling the slots held after each
    step, with the swap-out (copy to host, crc) and swap-in (crc check,
    copy back) calls timed, each synced on both sides so a call's time is
    its own, and the swapped bytes summed.
    Returns the wall seconds, the mean slots held and the swap record."""
    sw = {"out_s": 0.0, "in_s": 0.0, "n_out": 0, "n_in": 0, "bytes": 0}
    out_fn, in_fn = eng._swap_out_slot, eng._swap_in_slot

    def swap_out(b, n):
        sync()
        t0 = time.perf_counter()
        st = out_fn(b, n)
        sw["out_s"] += time.perf_counter() - t0
        sw["n_out"] += 1
        sw["bytes"] += sum(t.numel() * t.element_size()
                           for layer in st["bufs"] for t in layer.values())
        return st

    def swap_in(b, st):
        sync()
        t0 = time.perf_counter()
        in_fn(b, st)
        sync()
        sw["in_s"] += time.perf_counter() - t0
        sw["n_in"] += 1

    eng._swap_out_slot, eng._swap_in_slot = swap_out, swap_in
    held = []
    t0 = time.perf_counter()
    eng.start(reqs)
    while eng.step():
        held.append(sum(r is not None for r in eng._slot_req))
    sync()
    return {"wall": time.perf_counter() - t0,
            "held": sum(held) / max(len(held), 1), "swap": sw}


def prompts_3k():
    """Phase 3k's 32 prompts (token ids below 256, valid in the reduced
    vocabulary too): a 48-token system prompt and 24..64 private tokens;
    the first of each of eight pairs is followed by its own leading whole
    pages past the system prompt, whose match then ends a page before its
    last token and copy-on-write forks the page it shares."""
    import numpy as np
    rng = np.random.default_rng(8)
    system = rng.integers(0, 256, 48)
    out = []
    for i in range(24):
        q = np.concatenate([system, rng.integers(0, 256, int(
            rng.integers(24, 65)))]).astype(np.int32)
        out.append(q)
        if i % 2 == 0 and i < 16:
            out.append(q[:16 * ((len(q) - 1) // 16)].copy())
    return out


def drive_3k(eng, reqs, events=None) -> list:
    """Drain ``reqs`` step by step.  Per step: its wall (a sync after the
    step, outside it), the host syncs inside it (explicit
    ``torch.cuda.synchronize`` calls, and the synchronizing copies that
    torch's sync debug mode reports), whether it preempted or swapped, and
    the attention launches in order (``events``, filled by the caller's
    wrappers)."""
    import warnings
    import torch
    sync = torch.cuda.synchronize
    n = {"explicit": 0}

    def counted(*a, **k):
        n["explicit"] += 1
        return sync(*a, **k)

    def moved(e):
        return (e.n_preempted, e.n_swapped_out, e.n_swapped_in,
                e.n_swap_fallbacks)

    steps = []
    eng.start(reqs)
    torch.cuda.synchronize = counted
    try:
        busy = True
        while busy:
            before, n["explicit"] = moved(eng), 0
            if events is not None:
                events.clear()
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                busy = eng.step()
            torch.cuda.set_sync_debug_mode(0)
            sync()
            warned = sum("synchroniz" in str(x.message) for x in w)
            steps.append({
                "wall": time.perf_counter() - t0,
                "syncs": n["explicit"] + warned,
                "moved": moved(eng) != before,
                "fused": bool(eng.budget_log and eng.budget_log[-1]["fused"]
                              and eng.budget_log[-1]["step"]
                              == eng._step_count),
                "events": list(events) if events is not None else None})
    finally:
        torch.cuda.synchronize = sync
        torch.cuda.set_sync_debug_mode(0)
    return steps


def chunked_margin(eng, ctx, chunk: int = 256) -> float:
    """Top-2 margin of the next-token logits after ``ctx``, prefilled in
    ``chunk``-token chunks into pages of the engine's layout (the route a
    recompute or an unshared prefill takes)."""
    import numpy as np
    import torch
    ps = eng.sc.page_size
    n = -(-len(ctx) // ps)
    cache = eng.model.init_paged_cache(n + 1, ps, eng.ranks)
    btab = torch.arange(1, n + 1, dtype=torch.int32,
                        device=eng.device)[None]
    for s0 in range(0, len(ctx), chunk):
        k = min(chunk, len(ctx) - s0)
        lg, cache = eng.model.prefill_chunk(
            eng.params, cache, np.asarray(ctx[s0:s0 + k])[None], s0,
            torch.full((1,), k, dtype=torch.int32, device=eng.device),
            proj=eng.proj, block_table=btab)
    top = torch.topk(lg[0, k - 1].float(), 2).values
    return float(top[0] - top[1])


def agreement(label: str, eng, reqs, oracle) -> int:
    """Print how many requests' tokens equal the oracle's and, at each
    other request's first differing token, the top-2 logit margin after
    the oracle's context; returns the count that agree."""
    import numpy as np
    same, margins = 0, []
    for r, o in zip(reqs, oracle):
        if r.out_tokens == o.out_tokens:
            same += 1
            continue
        j = next(i for i, (a, b) in enumerate(zip(r.out_tokens,
                                                  o.out_tokens)) if a != b)
        ctx = np.concatenate([np.asarray(o.prompt, np.int32),
                              np.asarray(o.out_tokens[:j], np.int32)])
        margins.append(f"rid {r.rid} @ {j}: {chunked_margin(eng, ctx):.4f}")
    print(f"  {label}: {same}/{len(reqs)} requests' tokens equal the "
          f"oracle's; top-2 logit margin at the first differing token: "
          f"{'; '.join(margins) or 'none differ'}")
    return same


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


def roofline_line(cfg, prof: dict, ranks) -> None:
    """3c's decode step (8 slots at position 512) against the card's
    roofline, from the reference's config arithmetic in the port's
    roofline module: ``model_flops_for`` and ``useful_bytes_for`` under
    its KQ-SVD rank rule (``d_head // 2`` for keys and values), which is
    not the solved padded ranks the step runs at.  First the memory term
    beside 3d's profiled busy time, then the ``summarize`` line."""
    from repro_torch.config import ShapeSpec
    from repro_torch.roofline.analysis import (Roofline, model_flops_for,
                                               summarize, useful_bytes_for)
    sh = ShapeSpec("decode_b8_t512", 512, 8, "decode")
    flops = model_flops_for(cfg, sh, "kqsvd")
    nbytes = useful_bytes_for(cfg, sh, "kqsvd")
    r = Roofline(arch=cfg.name, shape=sh.name, mesh="1 card",
                 variant="kqsvd", n_devices=1, hlo_flops=flops,
                 hlo_bytes=nbytes, model_flops=flops,
                 useful_bytes=nbytes).finalize()
    mem_ms = 1e3 * r.t_memory_projected
    busy = prof.get("busy_ms")
    print(f"roofline of 3c's decode step (8 slots at position 512; the "
          f"reference's rank rule d_head // 2 = {cfg.d_head // 2} for k "
          f"and v, not the solved padded Rk {ranks[0]} / Rv {ranks[1]}): "
          f"memory term {mem_ms:.4f} ms ({nbytes:.0f} bytes at "
          f"{HBM_BYTES_PER_S:.3g} B/s), compute term "
          f"{1e3 * r.t_compute:.4f} ms ({flops:.0f} flops); "
          + (f"3d's measured busy {busy:.3f} ms, {busy / mem_ms:.1f}x the "
             f"memory term" if busy else
             "busy not measured (the profiler saw no device time)"))
    print(summarize(r))


def serve_sharded(cfg, params, mp, psc, prompts, oracle, dev, zero_counts,
                  plain_calls) -> None:
    """Phase 3p: phase 3c's paged engine with ``shards=2``, both shards on
    the one card (``devices=[dev, dev]``), on 3c's 16 requests.  Counts
    zeroed just before the drain and read just after, per shard (each
    worker's chunk and decode launches wrapped): K1 once per layer per
    decode step of each shard, K2 once per layer per prefill chunk of
    each, nothing else and no plain version; every request served in
    full, both pools whole, the first tokens equal 3c's (the prefills are
    the same chunks) and the agreement with 3c printed with the top-2
    margin where a token differs; per shard the requests completed, and
    the step wall p50 / max."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.kq_decode import (
        kq_combine_splits, kq_decode_attention, kq_decode_paged_attention,
        kq_decode_paged_int8, kq_decode_paged_int8_split,
        kq_decode_paged_split, kq_prefill_paged_attention)
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.engine import ShardedServingEngine
    k1, k2 = kq_decode_paged_attention, kq_prefill_paged_attention
    eng = ServingEngine(cfg, params, dataclasses.replace(psc, shards=2),
                        projections=mp, devices=[dev, dev])
    assert isinstance(eng, ShardedServingEngine)
    assert all(w.params is params and w.proj is eng.proj
               for w in eng.workers), "params or projections copied"
    per = [{"K1": 0, "K2": 0} for _ in eng.workers]

    def counted(fn, s):
        def call(*args, **kw):
            before = k1.launches, k2.launches
            out = fn(*args, **kw)
            per[s]["K1"] += k1.launches - before[0]
            per[s]["K2"] += k2.launches - before[1]
            return out
        return call

    for s, w in enumerate(eng.workers):
        w._launch_decode = counted(w._launch_decode, s)
        w._launch_chunk = counted(w._launch_chunk, s)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    zero_counts()
    walls = []
    t0 = time.perf_counter()
    eng.start(reqs)
    busy = True
    while busy:
        t1 = time.perf_counter()
        busy = eng.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    others = {"K3": kq_decode_attention.launches,
              "K4": kq_decode_paged_split.launches,
              "K5": kq_decode_paged_int8.launches,
              "K5 split": kq_decode_paged_int8_split.launches,
              "merge": kq_combine_splits.launches,
              "K6": flash_attention.launches}
    assert not any(others.values()), others
    assert not any(plain_calls.values()), plain_calls
    assert k1.launches == sum(c["K1"] for c in per), (k1.launches, per)
    assert k2.launches == sum(c["K2"] for c in per), (k2.launches, per)
    for s, w in enumerate(eng.workers):
        assert w.n_completed > 0 and w.n_decode_steps > 0 \
            and w.n_prefill_chunks > 0, (s, w.n_completed)
        assert per[s]["K1"] == cfg.n_layers * w.n_decode_steps, (s, per)
        assert per[s]["K2"] == cfg.n_layers * w.n_prefill_chunks, (s, per)
        assert w.pool.free_count == w.pool.n_pages, \
            (s, w.pool.free_count, w.pool.n_pages)
    bad = [r.rid for r in reqs if r.failed or not r.done or len(
        r.out_tokens) != min(32, psc.max_seq_len - len(r.prompt) + 1)]
    assert not bad, f"requests not served in full: {bad}"
    assert eng.n_completed == len(reqs)
    first = [r.rid for r, o in zip(reqs, oracle)
             if r.out_tokens[:1] != o.out_tokens[:1]]
    assert not first, f"first tokens differ from 3c's: {first}"
    n_tok = sum(len(r.out_tokens) for r in reqs)
    w_ms = np.asarray(walls) * 1e3
    print(f"2 shards on {dev} ({torch.cuda.get_device_name(dev)}): "
          f"{len(reqs)} requests, {n_tok} tokens in {wall:.3f} s "
          f"({n_tok / wall:.1f} tokens/s) over {len(walls)} steps, step "
          f"wall p50 {np.percentile(w_ms, 50):.2f} ms, max "
          f"{w_ms.max():.2f} ms; prefill {eng.prefill_seconds:.3f} s, "
          f"decode {eng.decode_seconds:.3f} s (host, launches and "
          f"read-backs)")
    for s, w in enumerate(eng.workers):
        print(f"  shard {s} ({w.device}, slots {w._slots.start}.."
              f"{w._slots.stop - 1}, pool {w.pool.n_pages} pages): "
              f"completed {w.n_completed}, {w.n_decode_steps} decode steps"
              f", {w.n_prefill_chunks} prefill chunks, K1 {per[s]['K1']} = "
              f"{cfg.n_layers} x {w.n_decode_steps}, K2 {per[s]['K2']} = "
              f"{cfg.n_layers} x {w.n_prefill_chunks}, peak "
              f"{w.peak_used_pages} pages, {w.pool.free_count} free after "
              f"the drain")
    print(f"  plain versions {sum(plain_calls.values())}; other kernels "
          f"{others}")
    agreement("2 shards against 3c's one-shard engine", eng, reqs, oracle)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2

    from repro_torch.config import CompressionConfig, ServeConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.calibration import (GramAccumulator,
                                              accumulator_from_grams,
                                              calibrate_model,
                                              make_calibrate_step)
    from repro_torch.data import (DataConfig, batches, calibration_batches,
                                  stub_batch)
    from repro_torch.device import tree_to
    from repro_torch.kernels import build
    from repro_torch.kernels.flash import flash as flash_mod
    from repro_torch.kernels.flash import (flash_attention,
                                           flash_attention_backward,
                                           flash_attention_ref)
    from repro_torch import optim as optim_mod
    from repro_torch.train import Trainer
    from repro_torch.train.steps import (make_loss_fn, make_train_step,
                                         value_and_grad)
    from repro_torch.tree import leaves as tree_leaves
    from repro_torch.kernels.ssd import ssd as ssd_mod
    from repro_torch.kernels.ssd import (ssd_chunk_scan, ssd_chunk_scan_plain,
                                         ssd_chunk_scan_ref)
    from repro_torch.kernels.kq_decode import kq_decode as k3_mod
    from repro_torch.kernels.kq_decode import paged as paged_mod
    from repro_torch.models import attention as attention_mod
    from repro_torch.kernels.kq_decode import (
        combine_split_partials, kq_combine_splits, kq_decode_attention,
        kq_decode_attention_ref, kq_decode_attention_span,
        kq_decode_attention_span_ref, kq_decode_paged_attention,
        kq_decode_paged_attention_ref, kq_decode_paged_int8,
        kq_decode_paged_int8_split,
        kq_decode_paged_split, kq_prefill_paged_attention,
        kq_prefill_paged_attention_ref, resolve_splits)
    from repro_torch.models import build_model
    from repro_torch.serving import (RECOVERABLE_POINTS, FaultInjector,
                                     Request, ServingEngine, gather_pages)
    from repro_torch.serving import invariants as invariants_mod

    sdpa = torch.nn.functional.scaled_dot_product_attention
    wrappers = (kq_decode_attention, kq_decode_attention_span,
                kq_decode_paged_attention,
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
                   "kq_decode_attention_span_ref": 0,
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
    k3_mod.kq_decode_attention_span_ref = counted(
        "kq_decode_attention_span_ref", kq_decode_attention_span_ref)
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
        roofline_line(cfg, prof["K1"], (rk, rv))

    # -- 3p: the sharded engine, 2 shards on the one card -----------------
    with phase("3p serve tinyllama-1.1b, full width, KQ-SVD, paged + "
               "chunked prefill, 2 shards"):
        serve_sharded(cfg, params, mp, psc, prompts, preqs, dev,
                      zero_counts, plain_calls)

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
        del eng, peng, qmodel

    # -- 3j: optimistic admission with preemption, and prefix sharing -------
    with phase("3j serve tinyllama-1.1b, full width, KQ-SVD, paged: "
               "optimistic admission with preempt-and-requeue (recompute, "
               "swap), prefix sharing with copy-on-write"):
        jbase = dict(max_seq_len=2048, max_batch=8, paged=True, page_size=16,
                     chunked_prefill=True, prefill_chunk=256, decode_chunk=8,
                     decode_splits=1)
        j_launch = {"K1": 0, "K2": 0, "K5": 0}

        def serve_3j(label, sc, reqs, quant):
            """One drain: every request served in full, the pool whole (but
            for index pins), the launches K1 / K2 (fp) or K5 (int8) once
            per layer per decode step / chunk and no plain version."""
            e = ServingEngine(cfg, params, sc, projections=mp)
            zero_counts()
            run = serve_driven(e, reqs, torch.cuda.synchronize)
            got = {w.__name__: w.launches for w in wrappers if w.launches}
            run.update(eng=e, reqs=reqs, launches=got)
            bad = [r.rid for r in reqs if r.failed or not r.done
                   or len(r.out_tokens) != r.max_new_tokens]
            assert not bad, (label, bad)
            pinned = e._pindex.n_pinned if e._pindex is not None else 0
            assert e.pool.free_count + pinned == e.pool.n_pages, label
            steps, chunks = e.n_decode_steps, e.n_prefill_chunks
            if quant:
                want = {"kq_decode_paged_int8": cfg.n_layers * steps}
                assert plain_calls["kq_decode_paged_attention_int8_ref"] == 0
            else:
                want = {"kq_decode_paged_attention": cfg.n_layers * steps,
                        "kq_prefill_paged_attention": cfg.n_layers * chunks}
                assert plain_calls["chunk_decode_attention"] == 0
            assert got == want, (label, got, want)
            assert plain_calls["kq_decode_paged_attention_ref"] == 0 \
                and plain_calls["kq_prefill_paged_attention_ref"] == 0, \
                plain_calls
            j_launch["K1"] += got.get("kq_decode_paged_attention", 0)
            j_launch["K2"] += got.get("kq_prefill_paged_attention", 0)
            j_launch["K5"] += got.get("kq_decode_paged_int8", 0)
            n_tok = sum(len(r.out_tokens) for r in reqs)
            sw = run["swap"]
            print(f"  {label}: peak {e.peak_used_pages} of {e.pool.n_pages} "
                  f"pages, {run['held']:.2f} slots held a step; "
                  f"{n_tok} tokens in {run['wall']:.3f} s, decode "
                  f"{n_tok / e.decode_seconds:.1f} tokens/s over {steps} "
                  f"steps ({1e3 * e.decode_seconds / steps:.2f} ms/step), "
                  f"prefill {e.prefill_seconds:.3f} s ({e.n_prefill_tokens} "
                  f"tokens, {chunks} chunks); preempted {e.n_preempted} "
                  f"{e.preempted_rids}, swapped out/in {e.n_swapped_out}/"
                  f"{e.n_swapped_in}: {sw['bytes']} bytes, "
                  f"{1e3 * sw['out_s'] / max(sw['n_out'], 1):.2f} ms a "
                  f"swap-out, {1e3 * sw['in_s'] / max(sw['n_in'], 1):.2f} "
                  f"ms a swap-in; shared pages {e.n_shared_pages} "
                  f"({e.n_shared_tokens} tokens), full hits "
                  f"{e.n_full_hits}, COW forks {e.n_cow_forks}, reclaimed "
                  f"{e.n_reclaimed}; launches {got}", flush=True)
            return run

        # (a) oversubscription: worst cases sum far past the pool
        print(f"on {smi}:")
        rng = np.random.default_rng(3)
        alens = rng.integers(128, 769, 24)
        aprompts = [rng.integers(0, cfg.vocab_size, int(L)).astype(np.int32)
                    for L in alens]
        worst = sum(-(-(int(L) + NEW_3J_A) // 16) for L in alens)
        print(f"(a) pool {POOL_3J} pages of 16 for 24 requests of "
              f"{alens.min()}..{alens.max()} prompt tokens + {NEW_3J_A} "
              f"new, "
              f"priorities 0, 1 cycled (worst cases {worst} pages); "
              f"watermarks high 0.9, low 0.05")
        arun = {}
        for label, kw in (("reserve", {}),
                          ("optimistic recompute",
                           dict(admission="optimistic")),
                          ("optimistic swap",
                           dict(admission="optimistic",
                                preempt_mode="swap"))):
            sc = ServeConfig(**jbase, n_pages=POOL_3J, watermark_high=0.9,
                             watermark_low=0.05, **kw)
            arun[label] = serve_3j(label, sc, [
                Request(rid=i, prompt=q, max_new_tokens=NEW_3J_A,
                        priority=i % 2)
                for i, q in enumerate(aprompts)], quant=False)
        oracle = arun["reserve"]["reqs"]
        for label in ("optimistic recompute", "optimistic swap"):
            assert arun[label]["eng"].n_preempted >= 1, label
        sw_eng = arun["optimistic swap"]["eng"]
        assert sw_eng.n_swapped_in == sw_eng.n_swapped_out >= 1
        assert sw_eng.n_swap_fallbacks == 0
        assert arun["reserve"]["eng"].n_preempted == 0
        # swap restores the bytes: the reserve run's tokens exactly
        assert [r.out_tokens for r in arun["optimistic swap"]["reqs"]] == \
            [r.out_tokens for r in oracle]
        agreement("optimistic swap", sw_eng,
                  arun["optimistic swap"]["reqs"], oracle)
        agreement("optimistic recompute", arun["optimistic recompute"]["eng"],
                  arun["optimistic recompute"]["reqs"], oracle)

        # (b) prefix sharing: a 1000-token system prompt (62.5 pages),
        # private suffixes, four exact duplicates queued last
        srng = np.random.default_rng(4)
        system = srng.integers(0, cfg.vocab_size, 1000)
        bprompts = [np.concatenate([system, srng.integers(
            0, cfg.vocab_size, int(k))]).astype(np.int32)
            for k in srng.integers(8, 201, 20)]
        bprompts += [bprompts[i].copy() for i in range(4)]
        print(f"(b) 24 requests: a 1000-token system prompt + private "
              f"suffixes of {min(len(q) for q in bprompts) - 1000}.."
              f"{max(len(q) for q in bprompts) - 1000} tokens, {NEW_3J_B} "
              f"new; "
              f"requests 20..23 repeat 0..3; pool of {jbase['max_batch']} x "
              f"{jbase['max_seq_len'] // 16} fp pages")
        for quant in ("none", "int8"):
            brun = {}
            qname = "int8" if quant == "int8" else "fp"
            for share in (False, True):
                label = f"{qname} pages, sharing {'on' if share else 'off'}"
                sc = ServeConfig(**jbase, cache_quant=quant,
                                 share_prefix=share)
                brun[share] = serve_3j(label, sc, [
                    Request(rid=i, prompt=q, max_new_tokens=NEW_3J_B)
                    for i, q in enumerate(bprompts)], quant=quant == "int8")
            on, off = brun[True]["eng"], brun[False]["eng"]
            assert on.n_shared_pages > 0 and on.n_cow_forks >= 1 \
                and on.n_full_hits >= 1, quant
            assert on.n_prefill_tokens < off.n_prefill_tokens, quant
            assert on.n_prefill_chunks < off.n_prefill_chunks, quant
            k2 = [brun[x]["launches"].get("kq_prefill_paged_attention", 0)
                  for x in (True, False)]
            if quant == "none":
                assert k2[0] < k2[1], k2
            print(f"  {qname} pages: prefill tokens {on.n_prefill_tokens} "
                  f"shared vs {off.n_prefill_tokens} not; K2 launches "
                  f"{k2[0]} vs {k2[1]}; prefill {on.prefill_seconds:.3f} s "
                  f"vs {off.prefill_seconds:.3f} s; peak pages "
                  f"{on.peak_used_pages} vs {off.peak_used_pages}")
            agreement(f"{qname} pages, sharing on", on,
                      brun[True]["reqs"], brun[False]["reqs"])
        print(f"3j launches: {j_launch}")

    # -- 3k: fault injection, invariant audits, the token budget ------------
    with phase("3k serve tinyllama-1.1b, full width, KQ-SVD, paged: chaos "
               "with audits, the token budget with the fused prefill + "
               "decode iteration, a terminal fault"):
        kbase = dict(max_batch=8, max_seq_len=2048, page_size=16,
                     prefill_chunk=256, decode_chunk=8, paged=True,
                     chunked_prefill=True, n_pages=POOL_3K,
                     watermark_high=1.0, watermark_low=WATERMARK_LOW_3K,
                     admission="optimistic", preempt_mode="swap",
                     share_prefix=True)
        chaos = dict(chaos_seed=0, chaos_rate=0.05, audit=True,
                     audit_every=2)
        kprompts = prompts_3k()
        print(f"on {smi}: {len(kprompts)} requests of "
              f"{min(map(len, kprompts))}..{max(map(len, kprompts))} prompt "
              f"tokens behind a 48-token system prompt, {NEW_3K} new; pool "
              f"{POOL_3K} pages of 16, watermarks 1.0 / {WATERMARK_LOW_3K}; "
              f"optimistic admission, swap, prefix sharing")
        k_runs = {
            "a": ("(a) oracle", kbase, None),
            "b": ("(b) chaos + audits", dict(kbase, **chaos), None),
            "c": ("(c) budget 512, fp pages",
                  dict(kbase, max_num_batched_tokens=512), None),
            "d": ("(d) budget 512, int8 pages, dynamic splits, chaos + "
                  "audits", dict(kbase, max_num_batched_tokens=512,
                                 cache_quant="int8", decode_splits=0,
                                 **chaos), None),
            "e": ("(e) nan_logits on its 3rd hit, audits",
                  dict(kbase, **chaos),
                  lambda: FaultInjector(0).add("nan_logits", nth=3))}
        audit_s = []
        audit_fn = invariants_mod.audit

        def timed_audit(e):
            t0 = time.perf_counter()
            audit_fn(e)
            audit_s.append(time.perf_counter() - t0)

        # the attention launches of a step, in order
        events: list = []
        k2_fn = attention_mod.kq_prefill_paged_attention
        k1_fn = attention_mod.kq_decode_paged_attention

        def logged(name, fn):
            def call(*a, **k):
                events.append(name)
                return fn(*a, **k)
            return call

        attention_mod.kq_prefill_paged_attention = logged("K2", k2_fn)
        attention_mod.kq_decode_paged_attention = logged("K1", k1_fn)
        invariants_mod.audit = timed_audit
        k_launch = {"K1": 0, "K2": 0, "K5": 0, "K5 split": 0}
        krun = {}
        try:
            for key, (label, kw, faults) in k_runs.items():
                e = ServingEngine(cfg, params, ServeConfig(**kw),
                                  projections=mp,
                                  faults=faults() if faults else None)
                reqs = [Request(rid=i, prompt=q, max_new_tokens=NEW_3K)
                        for i, q in enumerate(kprompts)]
                zero_counts()
                audit_s.clear()
                t0 = time.perf_counter()
                steps = drive_3k(e, reqs, events)
                wall = time.perf_counter() - t0
                got = {w.__name__: w.launches for w in wrappers
                       if w.launches}
                krun[key] = dict(eng=e, reqs=reqs, steps=steps,
                                 launches=got, audits=list(audit_s))
                # a prefill chunk over int8 pages takes the plain chunk
                # attention by design (K2 writes fp pages), as the
                # reference takes lax there; no other plain version runs
                chunk_plain = plain_calls.pop("chunk_decode_attention")
                assert not any(plain_calls.values()), (label, plain_calls)
                plain_calls["chunk_decode_attention"] = chunk_plain
                assert chunk_plain == (cfg.n_layers * e.n_prefill_chunks
                                       if key == "d" else 0), chunk_plain
                pinned = e._pindex.n_pinned if e._pindex else 0
                assert e.pool.free_count + pinned == e.pool.n_pages, label
                failed = [r for r in reqs if r.failed]
                if key == "e":
                    assert len(failed) == 1 and \
                        failed[0].error.kind == "numerics", failed
                    assert e.faults.fired_log == [("nan_logits", 3)]
                else:
                    assert not failed, (label, failed)
                assert all(r.done for r in reqs), label
                assert all(len(r.out_tokens) == NEW_3K for r in reqs
                           if not r.failed), label
                n_steps, n_chunks = e.n_decode_steps, e.n_prefill_chunks
                if key == "d":
                    assert got.get("kq_decode_paged_int8", 0) > 0 and \
                        got.get("kq_decode_paged_int8_split", 0) > 0, got
                    assert got.get("kq_decode_paged_int8", 0) + got.get(
                        "kq_decode_paged_int8_split", 0) == \
                        cfg.n_layers * n_steps, got
                    assert set(got) == {"kq_decode_paged_int8",
                                        "kq_decode_paged_int8_split"}, got
                else:
                    assert got == {
                        "kq_decode_paged_attention": cfg.n_layers * n_steps,
                        "kq_prefill_paged_attention":
                            cfg.n_layers * n_chunks}, (label, got)
                k_launch["K1"] += got.get("kq_decode_paged_attention", 0)
                k_launch["K2"] += got.get("kq_prefill_paged_attention", 0)
                k_launch["K5"] += got.get("kq_decode_paged_int8", 0)
                k_launch["K5 split"] += got.get(
                    "kq_decode_paged_int8_split", 0)
                walls = sorted(1e3 * x["wall"] for x in steps)
                n_tok = sum(len(r.out_tokens) for r in reqs)
                fired = e.faults.points_fired() if e.faults else ()
                aud = (f"{e.n_audits} audits, "
                       f"{1e3 * sum(audit_s) / max(len(audit_s), 1):.3f} "
                       f"ms each" if e.sc.audit else "no audits")
                print(f"  {label}: {e._step_count} steps, step wall p50 "
                      f"{walls[len(walls) // 2]:.1f} ms, max "
                      f"{walls[-1]:.1f} ms; decode "
                      f"{1e3 * e.decode_seconds / n_steps:.2f} ms/step over "
                      f"{n_steps} steps, {n_tok / e.decode_seconds:.1f} "
                      f"tokens/s; prefill {e.prefill_seconds:.3f} s "
                      f"({e.n_prefill_tokens} tokens, {n_chunks} chunks); "
                      f"preempted {e.n_preempted}, swapped out/in "
                      f"{e.n_swapped_out}/{e.n_swapped_in}, swap fallbacks "
                      f"{e.n_swap_fallbacks}, retries {e.n_retried}; shared "
                      f"pages {e.n_shared_pages}, COW forks "
                      f"{e.n_cow_forks}, reclaimed {e.n_reclaimed}; fired "
                      f"{len(e.faults.fired_log) if e.faults else 0} at "
                      f"{list(fired)}; {aud}; wall {wall:.1f} s; launches "
                      f"{got}", flush=True)
        finally:
            attention_mod.kq_prefill_paged_attention = k2_fn
            attention_mod.kq_decode_paged_attention = k1_fn
            invariants_mod.audit = audit_fn

        # (b): every recoverable point, audits on every second step
        b = krun["b"]["eng"]
        assert set(b.faults.points_fired()) == set(RECOVERABLE_POINTS), \
            b.faults.points_fired()
        assert b.n_audits == b._step_count // 2 > 0, b.n_audits
        agreement("(b) chaos + audits against (a)", b, krun["b"]["reqs"],
                  krun["a"]["reqs"])
        # (c): the budget's accounting, fused steps and truncated chunks;
        # a fused step launches its chunks' K2, then the decode chunk's K1,
        # and syncs once (steps that preempted or swapped copy to and from
        # the host besides)
        c = krun["c"]["eng"]
        for ent in c.budget_log:
            assert ent["n_decode"] <= 512 and \
                ent["prefill_tokens"] <= 512 - ent["n_decode"], ent
        assert c.n_fused_steps > 0 and c.n_truncated_chunks > 0
        fused = [x for x in krun["c"]["steps"] if x["fused"]]
        quiet = [x for x in fused if not x["moved"]]
        assert len(fused) == c.n_fused_steps and quiet
        for x in quiet:
            assert x["syncs"] == 1, x["syncs"]
            k2n = x["events"].count("K2")
            assert k2n and k2n % cfg.n_layers == 0, x["events"]
            assert x["events"] == ["K2"] * k2n + ["K1"] * (
                len(x["events"]) - k2n), x["events"]
        print(f"  (c): {c.n_fused_steps} fused steps, {len(quiet)} without "
              f"preemption or swap: each 1 host sync (syncs per fused "
              f"step {sorted({x['syncs'] for x in fused})}), K2 then K1; "
              f"{c.n_truncated_chunks} truncated chunks; budget log "
              f"n_decode <= 512, prefill tokens <= 512 - n_decode")
        # audited against unaudited decode ms per step (the audit runs
        # outside the decode chunk): (b) and (e) against (a)
        ms = {k: 1e3 * v["eng"].decode_seconds / v["eng"].n_decode_steps
              for k, v in krun.items()}
        print(f"  decode ms/step unaudited (a) {ms['a']:.2f}, audited (b) "
              f"{ms['b']:.2f}, (e) {ms['e']:.2f}; budget (c) {ms['c']:.2f} "
              f"(its fused chunks inside)")

        # the same scheduler on the CPU (reduced tinyllama, float32, no
        # projections: fp pages either way): the scheduling does not
        # depend on the weights (no EOS), so the firings, the budget log
        # and every count must be the card's
        t0 = time.perf_counter()
        ccfg = get_config("tinyllama-1.1b").reduced()
        cmodel = build_model(ccfg, "cpu")
        cparams = cmodel.init(torch.Generator().manual_seed(0))
        names = ("_step_count", "n_decode_steps", "n_prefill_chunks",
                 "n_preempted", "n_swapped_out", "n_swapped_in",
                 "n_swap_fallbacks", "n_retried", "n_shared_pages",
                 "n_cow_forks", "n_reclaimed", "n_audits", "n_fused_steps",
                 "n_truncated_chunks", "budget_log")
        for key in ("b", "c"):
            label, kw, _ = k_runs[key]
            ce = ServingEngine(ccfg, cparams, ServeConfig(**kw),
                               device="cpu")
            ce.generate([Request(rid=i, prompt=q, max_new_tokens=NEW_3K)
                         for i, q in enumerate(kprompts)])
            card = krun[key]["eng"]
            for name in names:
                assert getattr(card, name) == getattr(ce, name), (key, name)
            if ce.faults is not None:
                assert card.faults.fired_log == ce.faults.fired_log, key
        print(f"  CPU runs of (b) and (c) (reduced, float32, "
              f"{time.perf_counter() - t0:.1f} s): (b) fired_log "
              f"({len(b.faults.fired_log)} firings) and (c) budget log, "
              f"{c.n_fused_steps} fused steps, {c.n_truncated_chunks} "
              f"truncated chunks and every count equal the card's")
        print(f"3k launches: {k_launch}")
        del params, model, krun, b, c

    # -- 3l: train, then calibrate on the device and serve the trained model
    with phase("3l train smollm-360m, full width (20 steps, one retry from "
               "the checkpoint), calibrate on the device, serve paged"):
        scfg = get_config("smollm-360m")
        assert (scfg.n_layers, scfg.d_model, scfg.n_heads, scfg.n_kv_heads,
                scfg.d_head, scfg.d_ff, scfg.vocab_size, scfg.tie_embeddings,
                scfg.dtype, scfg.remat_policy) == (
            32, 960, 15, 5, 64, 2560, 49152, True, "bfloat16", "nothing")
        L = scfg.n_layers
        tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=20,
                         checkpoint_every=10)
        dc = DataConfig(vocab_size=scfg.vocab_size, seq_len=512,
                        batch_size=8)
        ckdir = tempfile.mkdtemp(prefix="chip_smoke_3l_")
        try:
            fired = []

            def failure_hook(step):
                if step == 13 and not fired:
                    fired.append(step)
                    raise RuntimeError("injected node failure at step 13")

            trainer = Trainer(scfg, tc, ckpt_dir=ckdir,
                              failure_hook=failure_hook)
            io = {"save": [], "write": []}
            save_fn, write_fn = trainer.ckpt.save, trainer.ckpt._write

            def timed(fn, key):
                def call(*args, **kw):
                    t0 = time.perf_counter()
                    fn(*args, **kw)
                    io[key].append(time.perf_counter() - t0)
                return call
            trainer.ckpt.save = timed(save_fn, "save")
            trainer.ckpt._write = timed(write_fn, "write")
            state = trainer.init_state()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            flash_attention_backward.launches = 0
            t0 = time.perf_counter()
            rep = trainer.run(batches(dc), 20, state=state)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            done = len(rep.step_times)       # executed steps, retry's too
            k6_train = flash_attention.launches
            bwd = flash_attention_backward.launches
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            assert rep.retries == 1 and rep.steps_done == 20, rep
            assert done == 23, done          # steps 10-12 run twice
            assert rep.losses[-1] < rep.losses[0], rep.losses
            # forward and remat recompute; the hook fires before the step
            assert k6_train == L * 2 * done, (k6_train, done)
            assert bwd == L * done, (bwd, done)
            assert plain_calls["flash_attention_ref"] == 0, plain_calls
            trainer.ckpt.wait()
            assert trainer.ckpt.list_steps() == [10, 20]
            step_dir = os.path.join(ckdir, "step_00000020")
            ck_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                           for f in os.listdir(step_dir))
            fresh = Trainer(scfg, tc, ckpt_dir=ckdir)
            restore_fn, restore_s = fresh.ckpt.restore, []

            def timed_restore(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = restore_fn(*args, **kw)
                torch.cuda.synchronize()
                restore_s.append(time.perf_counter() - t0)
                return out
            fresh.ckpt.restore = timed_restore
            assert fresh.resume_or_init()["step"] == 20
            restore_ms = restore_s[0] * 1e3
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        ms = np.asarray(rep.step_times) * 1e3
        tok = dc.batch_size * dc.seq_len
        print(f"trained {rep.steps_done} steps ({done} executed, "
              f"{rep.retries} retry from step 10 after the failure at step "
              f"13) in {train_s:.1f} s: loss {rep.losses[0]:.4f} -> "
              f"{rep.final_loss:.4f}; ms per step p50 "
              f"{np.percentile(ms, 50):.2f}, max {ms.max():.2f} (first "
              f"{ms[0]:.2f}); {tok / np.percentile(ms, 50) * 1e3:.0f} "
              f"training tokens/s at the p50; peak device memory "
              f"{peak_gib:.2f} GiB; stragglers {rep.straggler_steps}")
        print(f"launches: K6 {k6_train} = {L} x 2 x {done} executed steps "
              f"(forward and remat recompute), its plain backward {bwd} = "
              f"{L} x {done}, its plain forward "
              f"{plain_calls['flash_attention_ref']}")
        print(f"checkpoint: {ck_bytes} bytes a step (params bf16, AdamW "
              f"moments f32); save blocks {1e3 * np.mean(io['save']):.1f} "
              f"ms (host copy), writes {1e3 * np.mean(io['write']):.1f} ms "
              f"on its thread ({len(io['save'])} saves); restore "
              f"{restore_ms:.1f} ms; a fresh Trainer resumes at step 20")
        model, params = trainer.model, trainer.state["params"]
        prof["train"] = profile_train_step(
            "smollm-360m train step (8 x 512 tokens, remat nothing)",
            trainer, trainer.state, next(batches(dc, start=40)))

        # calibrate the trained params on the device, against the host
        zero_counts()
        calib = calibration_batches(scfg.vocab_size, 16, 512, batch=4)
        init_grams, cal_step = make_calibrate_step(model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grams = init_grams(scfg.d_head, scfg.d_head, scfg.n_kv_heads)
        for bt in calib:
            grams = cal_step(params, grams, bt)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        k6_cal = flash_attention.launches
        assert k6_cal == L * len(calib), k6_cal
        t0 = time.perf_counter()
        host = GramAccumulator(L)
        for bt in calib:
            host.update_from_captures(model.calibrate(params, bt))
        host_s = time.perf_counter() - t0
        acc = accumulator_from_grams(grams)
        worst = 0.0
        for li in range(L):
            for name in ("g_k", "g_q", "g_v"):
                a_, b_ = getattr(acc.layers[li], name), getattr(
                    host.layers[li], name)
                np.testing.assert_allclose(a_, b_, rtol=2e-4, atol=2e-3)
                worst = max(worst, float(np.abs(a_ - b_).max()))
        assert acc.layers[0].tokens == host.layers[0].tokens == 16 * 512
        t0 = time.perf_counter()
        smp = acc.solve(CompressionConfig(method="kqsvd", epsilon=0.1),
                        model.group_output_weights(params))
        solve_s = time.perf_counter() - t0
        print(f"calibrated on {len(calib)} x {calib[0].shape} tokens: "
              f"device Grams {dev_s:.2f} s (K6 {k6_cal} = {L} x "
              f"{len(calib)}), host path {host_s:.2f} s, max |device - "
              f"host| {worst:.3g} (rtol 2e-4, atol 2e-3); solve "
              f"{solve_s:.2f} s; ranks k={smp.ranks_k} v={smp.ranks_v} "
              f"(padded Rk={smp.rank_k} Rv={smp.rank_v})")

        # serve the trained, compressed model: paged, chunked prefill, m=3
        ssc = ServeConfig(max_seq_len=1024, max_batch=8, paged=True,
                          page_size=16, n_pages=256, chunked_prefill=True,
                          prefill_chunk=256, decode_chunk=8)
        seng = ServingEngine(scfg, params, ssc, projections=smp)
        rng = np.random.default_rng(6)
        slens = np.concatenate([[32, 1000], rng.integers(32, 1001, 14)])
        sreqs = [Request(rid=i, prompt=rng.integers(
            0, scfg.vocab_size, int(n)).astype(np.int32), max_new_tokens=32)
            for i, n in enumerate(slens)]
        zero_counts()
        t0 = time.perf_counter()
        seng.generate(sreqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bad = [r.rid for r in sreqs if r.failed or not r.done
               or len(r.out_tokens) != min(32, 1024 - len(r.prompt) + 1)]
        assert not bad, f"requests not served in full: {bad}"
        assert seng.pool.free_count == seng.pool.n_pages
        assert kq_decode_paged_attention.launches == \
            L * seng.n_decode_steps, kq_decode_paged_attention.launches
        assert kq_prefill_paged_attention.launches == \
            L * seng.n_prefill_chunks, kq_prefill_paged_attention.launches
        assert not any(plain_calls.values()), plain_calls
        assert flash_attention.launches == 0
        serve_report("smollm-360m paged (m = 3)", seng, sreqs, wall)
        print(f"capacity gain {seng.capacity_gain():.2f}x; K1 "
              f"{kq_decode_paged_attention.launches} = {L} x "
              f"{seng.n_decode_steps}, K2 "
              f"{kq_prefill_paged_attention.launches} = {L} x "
              f"{seng.n_prefill_chunks}; no plain version")
        k6_launches["phase 3l"] = k6_train + k6_cal
        # phase 4 holds K1, K2 and K6 at this phase's shapes: the solved
        # (padded) ranks, the first 8 requests' lengths at their last
        # decode step, and the launches counted here
        s3l = {"Rk": smp.rank_k, "Rv": smp.rank_v,
               "lengths": [min(int(n) + 31, ssc.max_seq_len)
                           for n in slens[:8]],
               "K1": kq_decode_paged_attention.launches,
               "K2": kq_prefill_paged_attention.launches}
        del seng, trainer, fresh, model, params, grams, host, acc, state

    # -- 3q: training on a (data, model) mesh --------------------------------
    with phase("3q train tinyllama-1.1b (full width and depth) on a (1, 1) "
               "(data, model) mesh beside the one-device Trainer"):
        import torch.distributed as dist
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.sharding.partition import (is_dtensor,
                                                    params_shardings)
        qcfg = get_config("tinyllama-1.1b")
        assert (qcfg.n_layers, qcfg.d_model, qcfg.n_heads, qcfg.n_kv_heads,
                qcfg.d_head, qcfg.d_ff, qcfg.vocab_size, qcfg.dtype,
                qcfg.remat_policy) == (22, 2048, 32, 4, 64, 5632, 32000,
                                       "bfloat16", "nothing")
        L, steps_3q = qcfg.n_layers, 4
        tc = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                         total_steps=steps_3q, checkpoint_every=0)
        dc = DataConfig(vocab_size=qcfg.vocab_size, seq_len=512,
                        batch_size=8)
        data_3q = [b for b, _ in zip(batches(dc), range(steps_3q))]
        ckdir = tempfile.mkdtemp(prefix="chip_smoke_3q_")
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        runs = {}
        try:
            mesh = make_local_mesh(1, 1)
            for label, m in (("mesh", mesh), ("one device", None)):
                trainer = Trainer(qcfg, tc, mesh=m)
                state = trainer.init_state()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_counts()
                flash_attention_backward.launches = 0
                rep = trainer.run(iter(data_3q), steps_3q, state=state)
                torch.cuda.synchronize()
                runs[label] = {
                    "losses": rep.losses, "k6": flash_attention.launches,
                    "bwd": flash_attention_backward.launches,
                    "plain": plain_calls["flash_attention_ref"],
                    "ms": np.percentile(np.asarray(rep.step_times) * 1e3, 50),
                    "peak": torch.cuda.max_memory_allocated() / 2**30}
                assert rep.steps_done == steps_3q and rep.retries == 0, rep
                # forward and remat recompute, the plain forward never
                assert runs[label]["k6"] == L * 2 * steps_3q, runs[label]
                assert runs[label]["bwd"] == L * steps_3q, runs[label]
                assert runs[label]["plain"] == 0, plain_calls
                if m is None:
                    break
                # the params at the last step, saved (every leaf gathered,
                # rank 0 writes) and restored with no mesh and onto it
                params = trainer.state["params"]
                assert all(is_dtensor(t) for _, t in tree_leaves(params))
                full = [t.full_tensor() for _, t in tree_leaves(params)]
                ck = CheckpointManager(ckdir, keep=1, async_save=False)
                t0 = time.perf_counter()
                ck.save(steps_3q, {"params": params})
                ck.wait()
                save_ms = (time.perf_counter() - t0) * 1e3
                step_dir = os.path.join(ckdir, f"step_{steps_3q:08d}")
                ck_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                               for f in os.listdir(step_dir))
                t0 = time.perf_counter()
                plain_tree, _ = ck.restore({"params": params})
                placed, _ = ck.restore({"params": params}, shardings={
                    "params": params_shardings(params, mesh,
                                               fsdp=tc.fsdp)})
                torch.cuda.synchronize()
                restore_ms = (time.perf_counter() - t0) * 1e3 / 2
                for (path, a), (_, b), g in zip(
                        tree_leaves(plain_tree["params"]),
                        tree_leaves(placed["params"]), full):
                    assert not is_dtensor(a) and a.device == dev, path
                    assert is_dtensor(b), path
                    assert torch.equal(a, g), path
                    assert torch.equal(b.full_tensor(), g), path
                del params, full, plain_tree, placed
        finally:
            trainer = state = None
            dist.destroy_process_group()
            shutil.rmtree(ckdir, ignore_errors=True)
        rel = [abs(a - b) / abs(b) for a, b in
               zip(runs["mesh"]["losses"], runs["one device"]["losses"])]
        assert max(rel) <= 1e-2, (runs["mesh"]["losses"],
                                  runs["one device"]["losses"])
        for label, r in runs.items():
            print(f"{label}: losses {[round(x, 4) for x in r['losses']]}; "
                  f"ms a step p50 {r['ms']:.2f}; peak device memory "
                  f"{r['peak']:.2f} GiB; K6 {r['k6']} = {L} x 2 x "
                  f"{steps_3q} (forward and remat recompute), its plain "
                  f"backward {r['bwd']}, its plain forward {r['plain']}")
        print(f"losses mesh / one device: max relative difference "
              f"{max(rel):.3g} (limit 1e-2); DTensor's host cost "
              f"{runs['mesh']['ms'] - runs['one device']['ms']:.2f} ms a "
              f"step at the p50")
        print(f"checkpoint of the step-{steps_3q} params: {ck_bytes} bytes "
              f"(bf16), save {save_ms:.1f} ms (gather, write, barrier), "
              f"restore {restore_ms:.1f} ms; restored with no mesh and onto "
              f"the mesh: bit for bit the gathered params")
        k6_launches["phase 3q"] = runs["mesh"]["k6"] + runs["one device"]["k6"]

    # -- 3r: serving and training on a (1, 1) mesh ---------------------------
    with phase("3r (a) prefill + 32 compressed decode steps of tinyllama-1.1b "
               "(full width and depth) on a (1, 1) mesh beside no mesh"):
        import torch.distributed as dist
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.launch import specs
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.sharding.partition import (
            is_dtensor, merge_spans, params_shardings, place_tree, use_mesh)
        from repro_torch.train.steps import make_decode_step, make_prefill_step
        t_3r = time.perf_counter()
        full = lambda t: t.full_tensor() if is_dtensor(t) else t
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        rmodel = build_model(cfg)
        rparams = rmodel.init(gen)              # phase 3's params again
        n_new_3r = 32
        prompts_3r = np.random.default_rng(31).integers(
            0, cfg.vocab_size, (8, 512)).astype(np.int32)
        prefill_3r = make_prefill_step(rmodel, 1024, compressed=True)
        decode_3r = make_decode_step(rmodel, compressed=True)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        s3r = {}
        try:
            mesh = make_local_mesh(1, 1)
            # no mesh; the mesh with the placements cache_shardings gives
            # (all Replicate on (1, 1)); the mesh with the cache's sequence
            # on the model axis (Shard(2) of a size-1 axis), the layout a
            # model axis wider than the kv heads gives: K3's span output
            # and the LSE merge on the main path
            for label, m, seq_cut in (("no mesh", None, False),
                                      ("mesh", mesh, False),
                                      ("mesh, sequence on model", mesh,
                                       True)):
                with use_mesh(m):
                    p, pj = rparams, proj
                    tok = {"tokens": torch.as_tensor(prompts_3r, device=dev)}
                    if m is not None:
                        p = place_tree(rparams, params_shardings(
                            rparams, m, fsdp=True))
                        pj = place_tree(proj, specs.projection_shardings(
                            proj, m))
                        tok = place_tree(tok, specs.batch_shardings(tok, m))
                    torch.cuda.synchronize()
                    zero_counts()
                    merges0 = merge_spans.calls
                    logits, cache = prefill_3r(p, pj, tok)
                    if seq_cut:
                        cache = [{k: (v.redistribute(m, (Replicate(),
                                                         Shard(2)))
                                      if k in ("kc", "vc") else v)
                                  for k, v in layer.items()}
                                 for layer in cache]
                    step_logits, toks, walls = [], [], []
                    for i in range(n_new_3r):
                        lg = full(logits)[:, -1].float()
                        step_logits.append(lg)
                        nxt = {"tokens": lg.argmax(-1)[:, None].to(
                            torch.int32)}
                        toks.append(nxt["tokens"][:, 0].cpu())
                        if m is not None:
                            nxt = place_tree(nxt, specs.batch_shardings(
                                nxt, m))
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        logits, cache = decode_3r(p, pj, cache,
                                                  nxt["tokens"], 512 + i)
                        torch.cuda.synchronize()
                        walls.append(time.perf_counter() - t0)
                    step_logits.append(full(logits)[:, -1].float())
                    s3r[label] = {
                        "logits": step_logits, "tokens": torch.stack(toks),
                        "K6": flash_attention.launches,
                        "K3": kq_decode_attention.launches,
                        "K3 span": kq_decode_attention_span.launches,
                        "merges": merge_spans.calls - merges0,
                        "plain": sum(plain_calls.values()),
                        "ms": float(np.median(walls[1:]) * 1e3)}
                    del p, pj, cache, logits
                L = cfg.n_layers
                r = s3r[label]
                assert r["K6"] == L and r["plain"] == 0, (label, r["K6"],
                                                          plain_calls)
                want = (0, L * n_new_3r) if seq_cut else (L * n_new_3r, 0)
                assert (r["K3"], r["K3 span"]) == want, (label, r["K3"],
                                                         r["K3 span"])
                assert r["merges"] == want[1], (label, r["merges"])
                assert all(bool(torch.isfinite(x).all())
                           for x in r["logits"]), label
        finally:
            dist.destroy_process_group()
        base = s3r["no mesh"]
        for label in ("mesh", "mesh, sequence on model"):
            r = s3r[label]
            diff = max(float((a - b).abs().max())
                       for a, b in zip(r["logits"], base["logits"]))
            same = bool(torch.equal(r["tokens"], base["tokens"]))
            r["max_diff"], r["tokens_equal"] = diff, same
            print(f"{label}: K6 {r['K6']} = {cfg.n_layers} x 1 prefill, K3 "
                  f"{r['K3']}, K3 span {r['K3 span']}, merges "
                  f"{r['merges']} ({cfg.n_layers} x {n_new_3r} steps), plain "
                  f"versions {r['plain']}; logits against no mesh: max "
                  f"|diff| {diff:.3g}; greedy tokens equal: {same}; ms a "
                  f"decode step p50 {r['ms']:.2f} (no mesh "
                  f"{base['ms']:.2f})")
            assert same, (label, r["tokens"][:, :8], base["tokens"][:, :8])
        print(f"req 0 tokens on the mesh: {base['tokens'][:, 0].tolist()}")
        del rparams, rmodel
        torch.cuda.empty_cache()

    with phase(f"3r (b) train deepseek-v2-lite-16b (full width, "
               f"{DEPTH_3R_DEEPSEEK} of 27 layers) and (c) mamba2-2.7b (full "
               f"width, {DEPTH_3R_MAMBA} of 64 layers) on a (1, 1) mesh "
               f"beside one device"):
        from repro_torch.sharding.partition import axis_size
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        t3r = {}
        try:
            mesh = make_local_mesh(1, 1)
            for arch, depth in (("deepseek-v2-lite-16b", DEPTH_3R_DEEPSEEK),
                                ("mamba2-2.7b", DEPTH_3R_MAMBA)):
                tcfg = dataclasses.replace(get_config(arch), n_layers=depth)
                steps_3r = 3
                tc = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                                 total_steps=steps_3r, checkpoint_every=0)
                data_3r = [b for b, _ in zip(batches(DataConfig(
                    vocab_size=tcfg.vocab_size, seq_len=512,
                    batch_size=4)), range(steps_3r))]
                for label, m in (("mesh", mesh), ("one device", None)):
                    trainer = Trainer(tcfg, tc, mesh=m)
                    state = trainer.init_state()
                    n_params = sum(t.numel() for _, t in
                                   tree_leaves(state["params"]))
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    zero_counts()
                    rep = trainer.run(iter(data_3r), steps_3r, state=state)
                    torch.cuda.synchronize()
                    counts = (flash_attention.launches,
                              ssd_chunk_scan.launches)
                    dropped = None
                    if tcfg.moe is not None:      # the last batch's drops
                        with torch.no_grad(), use_mesh(m):
                            _, aux = trainer.model.train_logits(
                                trainer.state["params"],
                                trainer.place_batch(data_3r[-1]))
                        dropped = float(full(aux["dropped_frac"])
                                        / full(aux["n_moe"]))
                    t3r[(arch, label)] = {
                        "losses": rep.losses, "params": n_params,
                        "K6": counts[0], "K7": counts[1],
                        "plain": plain_calls["flash_attention_ref"]
                        + plain_calls["ssd_chunk_scan_plain"],
                        "ms": float(np.median(rep.step_times[1:]) * 1e3),
                        "peak": torch.cuda.max_memory_allocated() / 2**30,
                        "dropped": dropped}
                    assert rep.steps_done == steps_3r and rep.retries == 0
                    del trainer, state
                    torch.cuda.empty_cache()
                kinds = tcfg.layer_kinds()
                n_attn = sum(k in ("attn", "mla") for k in kinds)
                n_ssm = kinds.count("ssm")
                want = 2 * steps_3r          # forward and remat recompute
                for label in ("mesh", "one device"):
                    r = t3r[(arch, label)]
                    assert r["K6"] == n_attn * want, (arch, label, r)
                    assert r["K7"] == n_ssm * want, (arch, label, r)
                    assert r["plain"] == 0, (arch, label, plain_calls)
                a, b = t3r[(arch, "mesh")], t3r[(arch, "one device")]
                rel = max(abs(x - y) / abs(y)
                          for x, y in zip(a["losses"], b["losses"]))
                for label, r in (("mesh", a), ("one device", b)):
                    print(f"{arch} ({depth} layers, {r['params'] / 1e9:.2f} "
                          f"B params) {label}: losses "
                          f"{[round(x, 4) for x in r['losses']]}; ms a step "
                          f"p50 {r['ms']:.1f}; peak device memory "
                          f"{r['peak']:.2f} GiB; K6 {r['K6']} = {n_attn} x 2 "
                          f"x {steps_3r}, K7 {r['K7']} = {n_ssm} x 2 x "
                          f"{steps_3r}; plain forwards {r['plain']}"
                          + ("" if r["dropped"] is None else
                             f"; MoE dropped_frac {r['dropped']:.4f}"))
                print(f"{arch}: losses mesh / one device max relative "
                      f"difference {rel:.3g} (limit 1e-2)")
                assert rel <= 1e-2, (a["losses"], b["losses"])
                if tcfg.moe is not None:
                    assert axis_size(("pod", "data"), mesh) == 1
                    print(f"{arch}: G = 1 dispatch group a MoE layer on "
                          f"(1, 1) (the data axes' size)")
        finally:
            dist.destroy_process_group()
        k6_launches["phase 3r"] = sum(r["K6"] for r in s3r.values())
        k6_launches["phase 3r deepseek"] = sum(
            r["K6"] for (arch, _), r in t3r.items()
            if arch == "deepseek-v2-lite-16b")
        print(f"phase 3r: {time.perf_counter() - t_3r:.1f} s")

    # -- 3s: the dry run, sample cells and against real steps ---------------
    with phase("3s dry run: sample cells on the fake (16, 16) and (2, 16, 16) "
               "meshes, and 3q's / 3r's steps against real ones"):
        import gc as gc_module
        import torch.distributed as dist
        from repro_torch.config import ShapeSpec, TrainConfig
        from repro_torch.launch import dryrun as dryrun_mod
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.roofline.analysis import count_collectives
        from repro_torch.roofline.flop_count import OpCounter
        from repro_torch.sharding.partition import use_mesh
        t_3s = time.perf_counter()
        # the dry-run cells trace in their children while the real steps
        # run here; no earlier phase is timed beside them
        jobs_3s, procs_3s, out_3s = start_dryrun_children()
        steps_3s = {"train": (ShapeSpec(*SHAPE_3S_TRAIN), "baseline", None),
                    "decode": (ShapeSpec(*SHAPE_3S_DECODE), "kqsvd", None),
                    f"train grad_accum {ACCUM_3S}": (
                        ShapeSpec(*SHAPE_3S_TRAIN), "baseline",
                        TrainConfig(grad_accum=ACCUM_3S))}
        try:
            # (b) the same steps counted for real on the card
            real_3s = {}
            dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                    world_size=1)
            try:
                mesh = make_local_mesh(1, 1)
                qcfg = get_config("tinyllama-1.1b")
                for label, (sh, variant, tc) in steps_3s.items():
                    # the step's own peak: what earlier work left behind
                    # (the previous step's autograd cycles) collected first
                    gc_module.collect()
                    torch.cuda.empty_cache()
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    with use_mesh(mesh):
                        step, args = dryrun_mod._trace_cell(
                            qcfg, sh, mesh, variant, dev, tc)
                        zero_counts()
                        with OpCounter() as oc, count_collectives() as coll:
                            out = step(*args)
                        torch.cuda.synchronize()
                    real_3s[label] = {
                        "totals": oc.totals(), "coll": coll.count_by_op,
                        "launches": {w.__name__: w.launches for w in wrappers
                                     if w.launches},
                        "peak": torch.cuda.max_memory_allocated() - base}
                    assert real_3s[label]["peak"] > 0, (label, base)
                    del step, args, out
            finally:
                dist.destroy_process_group()
            t_wait = time.perf_counter()
            recs = []
            for job, proc in zip(jobs_3s, procs_3s):
                text = proc.communicate(timeout=600)[0]
                assert proc.returncode == 0, (job, text[-3000:])
                recs.append(json.loads(text.strip().splitlines()[-1]))
            print(f"3s: the dry-run children ended "
                  f"{time.perf_counter() - t_wait:.1f} s after the real "
                  f"steps")
        finally:
            stop_children(procs_3s)
            shutil.rmtree(out_3s, ignore_errors=True)
        # (a) every sample cell traced to its end
        for rec in recs[:len(SAMPLE_3S)]:
            assert rec["status"] == "ok", (rec["arch"], rec["shape"],
                                           rec["variant"], rec["mesh"],
                                           rec.get("error"),
                                           rec.get("traceback"))
            print(f"3s (a) {rec['mesh']}: {rec['summary']}")
            print(f"    hbm/device {rec['hbm_per_device_gib']:.3f} GiB (args "
                  f"{rec['mem_args'] / 2**30:.3f}, out "
                  f"{rec['mem_out'] / 2**30:.3f}, temp "
                  f"{rec['mem_temp'] / 2**30:.3f}); collectives by kind "
                  f"{rec['collectives']['count_by_op']} (wire bytes "
                  f"{ {k: round(v) for k, v in rec['collectives']['by_op'].items()} }); "
                  f"kernels { {k: v['calls'] for k, v in rec['kernels'].items()} }; "
                  f"trace {rec['t_trace_s']:.1f} s")
        # (b) the dry run against the real steps
        for rec, (label, real) in zip(recs[len(SAMPLE_3S):],
                                      real_3s.items()):
            assert rec["status"] == "ok", (label, rec.get("error"),
                                           rec.get("traceback"))
            tc = steps_3s[label][2]
            assert (rec["grad_accum"], rec["microbatches_traced"]) == (
                tc.grad_accum if tc else 1, 1), label
            tot = real["totals"]
            rel = abs(rec["hlo_flops"] - tot.flops) / tot.flops
            booked = {k: v["calls"] for k, v in rec["kernels"].items()}
            real_booked = {k: v["calls"] for k, v in tot.kernels.items()}
            est = rec["mem_args"] + rec["mem_out"] + rec["mem_temp"]
            ratio = est / real["peak"]
            print(f"3s (b) {label} ({rec['shape']} {rec['variant']}, mesh "
                  f"(1, 1), grad_accum {rec['grad_accum']}, microbatches "
                  f"traced {rec['microbatches_traced']}): FLOPs dry run "
                  f"{rec['hlo_flops']:.6e}, real "
                  f"{tot.flops:.6e} (relative difference {rel:.3g}, limit "
                  f"1e-6); bytes dry run {rec['hlo_bytes']:.6e}, real "
                  f"{tot.bytes:.6e}; kernels booked {booked}, launched "
                  f"{real['launches']}; collectives dry run "
                  f"{rec['collectives']['count_by_op']}, real {real['coll']}; "
                  f"estimated peak {est / 2**30:.3f} GiB, measured "
                  f"{real['peak'] / 2**30:.3f} GiB (ratio {ratio:.3f})")
            assert rel <= 1e-6, (label, rec["hlo_flops"], tot.flops)
            assert booked == real["launches"] == real_booked, (
                label, booked, real["launches"], real_booked)
            assert 0.5 <= ratio <= 2.0, (label, est, real["peak"])
        print(f"phase 3s: {time.perf_counter() - t_3s:.1f} s")

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

    # -- 3m: the MoE and MLA families ---------------------------------------
    with phase(f"3m serve deepseek-v2-lite-16b (full width, {DEPTH_3M} of "
               f"27 layers, MLA + MoE, dense slots) and arctic-480b (full "
               f"width, 2 of 35 layers, MoE, pages)"):
        t_3m = time.perf_counter()
        # (a) deepseek-v2-lite-16b at full width, its depth cut to
        # DEPTH_3M layers: the dense first layer and MoE layers
        dfull = get_config("deepseek-v2-lite-16b")
        dcfg = dataclasses.replace(dfull, n_layers=DEPTH_3M)
        dmodel = build_model(dcfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dparams = dmodel.init(gen)
        n_dp = sum(t.numel() for _, t in tree_leaves(dparams))
        assert n_dp == dcfg.param_count(), (n_dp, dcfg.param_count())
        print(f"deepseek-v2-lite-16b cut to {dcfg.n_layers} of "
              f"{dfull.n_layers} layers at full width: {n_dp} parameters "
              f"({2 * n_dp / 1e9:.1f} GB in bf16; the full depth "
              f"{dfull.param_count()}), built in "
              f"{time.perf_counter() - t0:.1f} s")
        zero_counts()
        t0 = time.perf_counter()
        dcalib = calibration_batches(dcfg.vocab_size, 16, 512, batch=4)
        init_grams, cal_step = make_calibrate_step(dmodel)
        lora = dcfg.mla.kv_lora_rank
        grams = init_grams(lora, lora, 1)          # the latent, Hkv 1
        for bt in dcalib:
            grams = cal_step(dparams, grams, bt)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dmp = accumulator_from_grams(grams).solve(
            CompressionConfig(method="kqsvd", epsilon=0.1),
            dmodel.group_output_weights(dparams))
        solve_s = time.perf_counter() - t0
        del grams
        assert dmp.c_v.shape[-1] == dcfg.n_heads * dcfg.d_model  # 32768
        rope = dcfg.mla.qk_rope_dim
        latent_gain = (lora + rope) / (dmp.rank_k + dmp.rank_v + rope)
        print(f"calibrated on {len(dcalib)} x {dcalib[0].shape} tokens: "
              f"device Grams {dev_s:.2f} s, solve {solve_s:.2f} s; ranks "
              f"k={dmp.ranks_k} v={dmp.ranks_v} (padded Rk={dmp.rank_k} "
              f"Rv={dmp.rank_v}); capacity gain against the raw latent + "
              f"rope cache ({lora} + {rope} per token): {latent_gain:.3f}x")
        dsc = ServeConfig(max_seq_len=1024, max_batch=8, decode_chunk=8)
        deng = ServingEngine(dcfg, dparams, dsc, projections=dmp)
        rng = np.random.default_rng(7)
        dlens = np.concatenate([[32, 512], rng.integers(32, 513, 14)])
        dreqs = [Request(rid=i, prompt=rng.integers(
            0, dcfg.vocab_size, int(n)).astype(np.int32), max_new_tokens=32)
            for i, n in enumerate(dlens)]
        t0 = time.perf_counter()
        deng.generate(dreqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d_launch = {w.__name__: w.launches for w in wrappers}
        k6_launches["phase 3m deepseek"] = d_launch.pop("flash_attention")
        bad = [r.rid for r in dreqs if r.failed or r.truncated or not r.done
               or len(r.out_tokens) != 32]
        assert not bad, f"requests not served in full: {bad}"
        assert k6_launches["phase 3m deepseek"] == dcfg.n_layers * (
            len(dcalib) + len(dreqs)), (k6_launches, len(dreqs))
        assert not any(d_launch.values()), f"K1-K5 or K7 ran: {d_launch}"
        assert not any(plain_calls.values()), plain_calls
        assert set(deng._cache[1]) == {"cc", "ccv", "kr"}
        serve_report("deepseek-v2-lite dense slots", deng, dreqs, wall)
        d_peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"K6 launches {k6_launches['phase 3m deepseek']} = "
              f"{dcfg.n_layers} x ({len(dcalib)} calibration batches + "
              f"{len(dreqs)} prefills), at (192, 128) with H = Hkv = "
              f"{dcfg.n_heads}; K1-K5 and the plain attention never; the "
              f"engine's capacity_gain {deng.capacity_gain():.2f}x (the "
              f"reference's formula); peak device memory {d_peak:.2f} GiB")
        print(f"req 1 (prompt 512) tokens: {dreqs[1].out_tokens}")
        # one profiled 512-token prefill: the MoE layers' dropped share
        x = dparams["embed"][torch.as_tensor(dreqs[1].prompt[None],
                                             device=dev).long()]
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as dprof:
            _, _, _, paux = dmodel._run_stack(dparams, x, "prefill",
                                              proj=deng.proj, max_len=512)
            torch.cuda.synchronize()
        pev = dprof.key_averages()
        p_busy = sum(e.device_time_total for e in pev
                     if e.key != "moe_ffn" and getattr(e, "device_type", None)
                     == torch.autograd.DeviceType.CUDA) / 1e3
        p_moe = sum(e.device_time_total for e in pev if e.key == "moe_ffn"
                    and getattr(e, "device_type", None)
                    != torch.autograd.DeviceType.CUDA) / 1e3
        d_dropped = float(paux["dropped_frac"] / paux["n_moe"])
        print(f"profiled prefill of 512 tokens: MoE dropped_frac "
              f"{d_dropped:.4f} (mean of {int(paux['n_moe'])} MoE layers, "
              f"C = {math.ceil(6 * 512 * 2 / 64)} slots an expert); device "
              f"busy {p_busy:.3f} ms, MoE FFN kernels {p_moe:.3f} ms")
        prof["deepseek"] = profile_decode(
            "deepseek-v2-lite dense MLA, 8 slots at position 512", dmodel,
            dparams, deng.proj, (dmp.rank_k, dmp.rank_v), dev, paged=False)
        s3m = {"deepseek": {
            "ranks": (dmp.rank_k, dmp.rank_v), "latent_gain": latent_gain,
            "decode_ms": 1e3 * deng.decode_seconds / deng.n_decode_steps,
            "prefill_s": deng.prefill_seconds, "peak_gib": d_peak,
            "dropped": d_dropped}}
        del deng, dparams, dmodel, x, dprof, paux
        torch.cuda.empty_cache()

        # (b) arctic-480b at full width, its depth cut to 2 of 35 layers
        afull = get_config("arctic-480b")
        acfg = dataclasses.replace(afull, n_layers=2)
        amodel = build_model(acfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        aparams = amodel.init(gen)
        n_ap = sum(t.numel() for _, t in tree_leaves(aparams))
        print(f"arctic-480b cut to {acfg.n_layers} of {afull.n_layers} "
              f"layers at full width (d_model {acfg.d_model}, 128 experts "
              f"of {acfg.moe.expert_ff}, top 2, dense residual, 56 query "
              f"heads padded to 64 over 8 kv heads): {acfg.param_count()} "
              f"parameters by the config's count, {n_ap} held with the pad "
              f"heads ({2 * n_ap / 1e9:.1f} GB in bf16; the full depth "
              f"{afull.param_count()}), built in "
              f"{time.perf_counter() - t0:.1f} s; device memory "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        zero_counts()
        t0 = time.perf_counter()
        acalib = calibration_batches(acfg.vocab_size, 16, 512, batch=4)
        init_grams, cal_step = make_calibrate_step(amodel)
        grams = init_grams(acfg.d_head, acfg.d_head, acfg.n_kv_heads)
        for bt in acalib:
            grams = cal_step(aparams, grams, bt)
        torch.cuda.synchronize()
        amp = accumulator_from_grams(grams).solve(
            CompressionConfig(method="kqsvd", epsilon=0.1),
            amodel.group_output_weights(aparams))
        del grams
        assert flash_attention.launches == acfg.n_layers * len(acalib)
        k6_launches["phase 3m arctic"] = flash_attention.launches
        print(f"calibrated on {len(acalib)} x {acalib[0].shape} tokens in "
              f"{time.perf_counter() - t0:.1f} s (K6 "
              f"{flash_attention.launches} = {acfg.n_layers} x "
              f"{len(acalib)} at d_head 128, 64 padded heads); ranks "
              f"k={amp.ranks_k} v={amp.ranks_v} (padded Rk={amp.rank_k} "
              f"Rv={amp.rank_v})")
        apsc = ServeConfig(max_seq_len=1024, max_batch=8, paged=True,
                           page_size=16, n_pages=256, chunked_prefill=True,
                           prefill_chunk=256, decode_chunk=8)
        rng = np.random.default_rng(8)
        alens = np.concatenate([[32, 1000], rng.integers(32, 1001, 14)])
        aprompts = [rng.integers(0, acfg.vocab_size, int(n)).astype(np.int32)
                    for n in alens]
        a_launch = {}
        for label, sc_ in (("fp", apsc),
                           ("int8", dataclasses.replace(
                               apsc, cache_quant="int8", decode_splits=0))):
            aeng = ServingEngine(acfg, aparams, sc_, projections=amp)
            areqs = [Request(rid=i, prompt=p_, max_new_tokens=32)
                     for i, p_ in enumerate(aprompts)]
            zero_counts()
            t0 = time.perf_counter()
            aeng.generate(areqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {w.__name__: w.launches for w in wrappers}
            bad = [r.rid for r in areqs if r.failed or not r.done
                   or len(r.out_tokens) != min(32, 1024 - len(r.prompt) + 1)]
            assert not bad, f"{label}: requests not served in full: {bad}"
            assert aeng.pool.free_count == aeng.pool.n_pages, label
            L = acfg.n_layers
            steps_, chunks_ = aeng.n_decode_steps, aeng.n_prefill_chunks
            if label == "fp":
                assert got["kq_decode_paged_attention"] == L * steps_, got
                assert got["kq_prefill_paged_attention"] == L * chunks_, got
                assert sum(got.values()) == L * (steps_ + chunks_), got
                assert not any(plain_calls.values()), plain_calls
            else:
                k5 = (got["kq_decode_paged_int8"]
                      + got["kq_decode_paged_int8_split"])
                assert k5 == L * steps_, got
                assert got["kq_decode_paged_int8_split"] > 0, got
                assert k5 == sum(got.values()), got
                assert plain_calls["kq_decode_paged_attention_int8_ref"] \
                    == plain_calls["kq_decode_paged_partials_ref"] == 0, \
                    plain_calls
            a_launch[label] = dict(got, steps=steps_, chunks=chunks_)
            serve_report(f"arctic paged {label}", aeng, areqs, wall)
            print(f"  launches {({k: v for k, v in got.items() if v})} over "
                  f"{steps_} decode steps and {chunks_} chunks of "
                  f"{L} layers; pool {aeng.pool.n_pages} pages, peak "
                  f"{aeng.peak_used_pages}, whole after the drain; peak "
                  f"device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            s3m[f"arctic {label}"] = {
                "decode_ms": 1e3 * aeng.decode_seconds / steps_,
                "prefill_s": aeng.prefill_seconds,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            if label == "fp":
                aproj = aeng.proj
            del aeng
        prof["arctic"] = profile_decode(
            "arctic paged fp, 8 slots at position 512", amodel, aparams,
            aproj, (amp.rank_k, amp.rank_v), dev, paged=True)
        s3m["arctic"] = {"ranks": (amp.rank_k, amp.rank_v),
                         "lengths": [min(int(n) + 31, 1024)
                                     for n in alens[:8]],
                         "launches": a_launch}
        del aparams, amodel, aproj
        torch.cuda.empty_cache()
        print(f"phase 3m: {time.perf_counter() - t_3m:.1f} s; " + "; ".join(
            f"{k}: decode {d['decode_ms']:.2f} ms/step, prefill "
            f"{d['prefill_s']:.3f} s, peak {d['peak_gib']:.2f} GiB"
            for k, d in s3m.items() if "decode_ms" in d))

    # -- 3n: the hybrid family ---------------------------------------------
    with phase(f"3n serve jamba-1.5-large-398b (full width, {DEPTH_3N} of 72 "
               f"layers: 4 Mamba-2 SSD layers and the period's attention "
               f"layer, MoE), KQ-SVD, dense slots"):
        t_3n = time.perf_counter()
        jfull = get_config("jamba-1.5-large-398b")
        jcfg = dataclasses.replace(jfull, n_layers=DEPTH_3N)
        assert jcfg.layer_kinds() == ("ssm",) * 4 + ("attn",)
        assert [jcfg.ffn_kind(i) for i in range(DEPTH_3N)] == [
            "moe", "dense", "moe", "dense", "moe"]
        jmodel = build_model(jcfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        jparams = jmodel.init(gen)
        n_jp = sum(t.numel() for _, t in tree_leaves(jparams))
        n_ssm = jcfg.layer_kinds().count("ssm")
        nh_j = jcfg.ssm.n_heads(jcfg.d_model)
        # the config's count leaves out each SSM layer's D skip
        assert n_jp == jcfg.param_count() + n_ssm * nh_j, (
            n_jp, jcfg.param_count())
        print(f"jamba-1.5-large-398b cut to {jcfg.n_layers} of "
              f"{jfull.n_layers} layers at full width (d_model "
              f"{jcfg.d_model}; SSM: d_inner "
              f"{jcfg.ssm.d_inner(jcfg.d_model)}, {nh_j} heads of "
              f"({jcfg.ssm.head_dim}, {jcfg.ssm.d_state}); attention: "
              f"{jcfg.n_heads} / {jcfg.n_kv_heads} heads of {jcfg.d_head}; "
              f"MoE {jcfg.moe.n_experts} experts of {jcfg.moe.expert_ff} "
              f"top {jcfg.moe.top_k} on layers 0, 2, 4): {n_jp} parameters "
              f"({2 * n_jp / 1e9:.1f} GB in bf16; the full depth "
              f"{jfull.param_count()}), built in "
              f"{time.perf_counter() - t0:.1f} s; device memory "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        zero_counts()
        t0 = time.perf_counter()
        jcalib = calibration_batches(jcfg.vocab_size, 16, 512, batch=4)
        init_grams, cal_step = make_calibrate_step(jmodel)
        grams = init_grams(jcfg.d_head, jcfg.d_head, jcfg.n_kv_heads)
        for bt in jcalib:
            grams = cal_step(jparams, grams, bt)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        jmp = accumulator_from_grams(grams).solve(
            CompressionConfig(method="kqsvd", epsilon=0.1),
            jmodel.group_output_weights(jparams))
        solve_s = time.perf_counter() - t0
        del grams
        assert ssd_chunk_scan.launches == n_ssm * len(jcalib)
        assert flash_attention.launches == len(jcalib)
        print(f"calibrated on {len(jcalib)} x {jcalib[0].shape} tokens: "
              f"device Grams {dev_s:.2f} s (K7 {ssd_chunk_scan.launches}, "
              f"K6 {flash_attention.launches}), solve {solve_s:.2f} s; "
              f"ranks k={jmp.ranks_k} v={jmp.ranks_v} (padded "
              f"Rk={jmp.rank_k} Rv={jmp.rank_v})")
        jsc = ServeConfig(max_batch=4, max_seq_len=4608, decode_chunk=8)
        jeng = ServingEngine(jcfg, jparams, jsc, projections=jmp)
        rng = np.random.default_rng(9)
        jlens = (1, 255, 257, 1000, 2049, 3000, 4095, 4096)
        jreqs = [Request(rid=i, prompt=rng.integers(0, jcfg.vocab_size, L)
                         .astype(np.int32), max_new_tokens=16)
                 for i, L in enumerate(jlens)]
        t0 = time.perf_counter()
        jeng.generate(jreqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {w.__name__: w.launches for w in wrappers}
        bad = [r.rid for r in jreqs if r.failed or r.truncated or not r.done
               or len(r.out_tokens) != 16]
        assert not bad, f"requests not served in full: {bad}"
        n_pf = len(jreqs) + len(jcalib)
        steps_ = jeng.n_decode_steps
        assert steps_ > 0
        assert got.pop("ssd_chunk_scan") == n_ssm * n_pf, got
        assert got.pop("flash_attention") == n_pf, got
        assert got.pop("kq_decode_attention") == steps_, got
        assert not any(got.values()), f"K1, K2, K4 or K5 ran: {got}"
        assert not any(plain_calls.values()), plain_calls
        kinds_j = jcfg.layer_kinds()
        state_b = sum(t[0].numel() * t.element_size()
                      for layer, k in zip(jeng._cache, kinds_j) if k == "ssm"
                      for t in layer.values())
        kq_b = sum(t[0].numel() * t.element_size()
                   for layer, k in zip(jeng._cache, kinds_j) if k == "attn"
                   for t in layer.values())
        full_b = 2 * jcfg.n_kv_heads * jcfg.d_head * jsc.max_seq_len * 2
        j_peak = torch.cuda.max_memory_allocated() / 2**30
        serve_report("jamba dense slots", jeng, jreqs, wall)
        print(f"launches: K7 {n_ssm * n_pf} = {n_ssm} x ({len(jreqs)} "
              f"prefills + {len(jcalib)} calibration batches), K6 {n_pf}, "
              f"K3 {steps_} = 1 x {steps_} decode steps; K1, K2, K4, K5 "
              f"and every plain version never; capacity gain "
              f"{jeng.capacity_gain():.2f}x; a slot of {jsc.max_seq_len} "
              f"tokens holds {state_b} bytes of SSM state ({n_ssm} layers: "
              f"conv tails and f32 state) beside {kq_b} bytes of compressed "
              f"cache in its one attention layer ({full_b} uncompressed); "
              f"peak device memory {j_peak:.2f} GiB")
        print(f"req 7 (prompt 4096) tokens: {jreqs[7].out_tokens}")
        s3n = {"ranks": (jmp.rank_k, jmp.rank_v),
               "K7": n_ssm * n_pf, "K6": n_pf, "K3": steps_,
               "lengths": [L + 15 for L in jlens[4:]],
               "decode_ms": 1e3 * jeng.decode_seconds / steps_,
               "prefill_s": jeng.prefill_seconds, "peak_gib": j_peak,
               "state_bytes": state_b, "kq_bytes": kq_b,
               "full_bytes": full_b}
        jproj = jeng.proj
        del jeng

    with phase("3n profile one jamba decode step (4 slots at position "
               "4096) and one 4096-token prefill"):
        prof["jamba"] = profile_decode(
            "jamba dense slots, 4 slots at position 4096", jmodel, jparams,
            jproj, s3n["ranks"], dev, paged=False, B=4, T=4608, at=4096)
        profile_prefill("jamba", jmodel, jparams, jreqs[7].prompt[None],
                        K7_KERNELS)
        del jparams, jmodel, jproj
        torch.cuda.empty_cache()
        print(f"phase 3n: {time.perf_counter() - t_3n:.1f} s")

    # -- 3o: the audio and VLM stubs ----------------------------------------
    with phase(f"3o (a) serve musicgen-large (full width, {DEPTH_3O} of 48 "
               f"layers), KQ-SVD calibrated on the stub frontend's "
               f"embeddings, fp pages"):
        t_3o = time.perf_counter()
        ucfg = dataclasses.replace(get_config("musicgen-large"),
                                   n_layers=DEPTH_3O)
        umodel = build_model(ucfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        uparams = umodel.init(gen)
        n_up = sum(t.numel() for _, t in tree_leaves(uparams))
        assert n_up == ucfg.param_count(), (n_up, ucfg.param_count())
        zero_counts()
        t0 = time.perf_counter()
        ucalib = [stub_batch(ucfg, 4, 512, seed=i) for i in range(4)]
        assert set(ucalib[0]) == {"embeds"}
        init_grams, cal_step = make_calibrate_step(umodel)
        grams = init_grams(ucfg.d_head, ucfg.d_head, ucfg.n_kv_heads)
        for bt in ucalib:
            grams = cal_step(uparams, grams, bt)
        assert int(grams["tokens"]) == 16 * 512
        torch.cuda.synchronize()
        grams_s = time.perf_counter() - t0
        # the solve as launch/serve.py's calibrate_model calls it (its
        # layers in threads, one a core), then the first SOLVE_LAYERS_3O
        # layers in threads and one after another, numpy's BLAS as it is
        uacc = accumulator_from_grams(grams)
        ucc = CompressionConfig(method="kqsvd", epsilon=0.1)
        uw = umodel.group_output_weights(uparams)
        t0 = time.perf_counter()
        ump = uacc.solve(ucc, uw)
        solve_s = time.perf_counter() - t0
        uacc.layers = uacc.layers[:SOLVE_LAYERS_3O]
        t0 = time.perf_counter()
        uacc.solve(ucc, uw)
        threads16_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        serial = [uacc._solve_layer(l, ucc, uw)
                  for l in range(SOLVE_LAYERS_3O)]
        serial16_s = time.perf_counter() - t0
        for l, (rk, rv, keys, values) in enumerate(serial):
            assert (rk, rv) == (ump.ranks_k[l], ump.ranks_v[l])
            for h, (kp, vp) in enumerate(zip(keys, values)):
                for a, b in ((ump.a_k[l, h, :, :rk], kp.A),
                             (ump.b_q[l, h, :, :rk], kp.B),
                             (ump.a_v[l, h, :, :rv], vp.A),
                             (ump.c_v[l, h, :rv], vp.C)):
                    assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
        del grams, uacc, uw, serial
        assert flash_attention.launches == ucfg.n_layers * len(ucalib)
        print(f"musicgen-large: {n_up} parameters ({2 * n_up / 1e9:.2f} GB "
              f"in bf16), {ucfg.n_layers} layers, {ucfg.n_heads} MHA heads "
              f"of {ucfg.d_head}; calibrated on {len(ucalib)} x 4 x 512 "
              f"frame embeddings of the stub frontend: device Grams "
              f"{grams_s:.2f} s (K6 {flash_attention.launches}), solve "
              f"{solve_s:.2f} s in threads ({len(os.sched_getaffinity(0))} "
              f"usable cores, os.cpu_count {os.cpu_count()}); ranks "
              f"k={ump.ranks_k} v={ump.ranks_v} (padded Rk={ump.rank_k} "
              f"Rv={ump.rank_v})")
        print(f"solve of the first {SOLVE_LAYERS_3O} layers: in threads "
              f"{threads16_s:.2f} s, one after another {serial16_s:.2f} s "
              f"(projections equal within 1e-12 of the largest entry)")
        k6_musicgen = flash_attention.launches
        upsc = ServeConfig(max_seq_len=1024, max_batch=8, paged=True,
                           page_size=16, n_pages=256, chunked_prefill=True,
                           prefill_chunk=256, decode_chunk=8)
        rng = np.random.default_rng(10)
        ulens = np.concatenate([[32, 1000], rng.integers(32, 1001, 14)])
        ureqs = [Request(rid=i, prompt=rng.integers(
            0, ucfg.vocab_size, int(n)).astype(np.int32), max_new_tokens=32)
            for i, n in enumerate(ulens)]
        ueng = ServingEngine(ucfg, uparams, upsc, projections=ump)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        ueng.generate(ureqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {w.__name__: w.launches for w in wrappers}
        bad = [r.rid for r in ureqs if r.failed or not r.done
               or len(r.out_tokens) != min(32, 1024 - len(r.prompt) + 1)]
        assert not bad, f"requests not served in full: {bad}"
        assert ueng.pool.free_count == ueng.pool.n_pages
        L, steps_, chunks_ = (ucfg.n_layers, ueng.n_decode_steps,
                              ueng.n_prefill_chunks)
        assert got["kq_decode_paged_attention"] == L * steps_, got
        assert got["kq_prefill_paged_attention"] == L * chunks_, got
        assert sum(got.values()) == L * (steps_ + chunks_), got
        assert not any(plain_calls.values()), plain_calls
        serve_report("musicgen paged fp", ueng, ureqs, wall)
        print(f"launches: K1 {L * steps_} = {L} x {steps_} decode steps, "
              f"K2 {L * chunks_} = {L} x {chunks_} chunks, nothing else; "
              f"pool {ueng.pool.n_pages} pages, peak "
              f"{ueng.peak_used_pages}, whole after the drain; capacity "
              f"gain {ueng.capacity_gain():.2f}x; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        s3o = {"musicgen": {
            "ranks": (ump.rank_k, ump.rank_v), "K1": L * steps_,
            "K2": L * chunks_, "K6": k6_musicgen,
            "lengths": [min(int(n) + 31, 1024) for n in ulens[:8]],
            "decode_ms": 1e3 * ueng.decode_seconds / steps_,
            "prefill_s": ueng.prefill_seconds}}
        uproj = ueng.proj
        del ueng
        prof["musicgen"] = profile_decode(
            "musicgen paged fp, 8 slots at position 512", umodel, uparams,
            uproj, (ump.rank_k, ump.rank_v), dev, paged=True)
        del uparams, umodel, uproj
        torch.cuda.empty_cache()

    with phase("3o (b) serve phi-3-vision-4.2b (full width and depth), "
               "KQ-SVD calibrated on patch embeddings ahead of text, dense "
               "slots, and one image-prefix request at model level"):
        vcfg = get_config("phi-3-vision-4.2b")
        P_img = vcfg.num_patch_tokens
        vmodel = build_model(vcfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        vparams = vmodel.init(gen)
        n_vp = sum(t.numel() for _, t in tree_leaves(vparams))
        assert n_vp == vcfg.param_count(), (n_vp, vcfg.param_count())
        zero_counts()
        t0 = time.perf_counter()
        vcalib = [stub_batch(vcfg, 4, 512, seed=i) for i in range(4)]
        assert vcalib[0]["image_embeds"].shape == (4, P_img, vcfg.d_model)
        init_grams, cal_step = make_calibrate_step(vmodel)
        grams = init_grams(vcfg.d_head, vcfg.d_head, vcfg.n_kv_heads)
        for bt in vcalib:
            grams = cal_step(vparams, grams, bt)
        assert int(grams["tokens"]) == 16 * (P_img + 512)
        vmp = accumulator_from_grams(grams).solve(
            CompressionConfig(method="kqsvd", epsilon=0.1),
            vmodel.group_output_weights(vparams))
        del grams
        k6_calib = flash_attention.launches
        assert k6_calib == vcfg.n_layers * len(vcalib)
        print(f"phi-3-vision-4.2b: {n_vp} parameters "
              f"({2 * n_vp / 1e9:.2f} GB in bf16), {vcfg.n_layers} layers, "
              f"{vcfg.n_heads} MHA heads of {vcfg.d_head}; calibrated on "
              f"{len(vcalib)} x 4 x ({P_img} patches + 512 tokens) in "
              f"{time.perf_counter() - t0:.1f} s (K6 {k6_calib} at S "
              f"{P_img + 512}); ranks k={vmp.ranks_k} v={vmp.ranks_v} "
              f"(padded Rk={vmp.rank_k} Rv={vmp.rank_v})")
        vsc = ServeConfig(max_seq_len=2048, max_batch=8, decode_chunk=8)
        rng = np.random.default_rng(11)
        vlens = np.concatenate([[32, 1000], rng.integers(32, 1001, 14)])
        vreqs = [Request(rid=i, prompt=rng.integers(
            0, vcfg.vocab_size, int(n)).astype(np.int32), max_new_tokens=32)
            for i, n in enumerate(vlens)]
        veng = ServingEngine(vcfg, vparams, vsc, projections=vmp)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        veng.generate(vreqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {w.__name__: w.launches for w in wrappers}
        bad = [r.rid for r in vreqs if r.failed or r.truncated or not r.done
               or len(r.out_tokens) != 32]
        assert not bad, f"requests not served in full: {bad}"
        L, steps_ = vcfg.n_layers, veng.n_decode_steps
        assert got.pop("flash_attention") == L * len(vreqs), got
        assert got.pop("kq_decode_attention") == L * steps_, got
        assert not any(got.values()), f"K1, K2, K4, K5 or K7 ran: {got}"
        assert not any(plain_calls.values()), plain_calls
        serve_report("phi-3-vision dense slots (text)", veng, vreqs, wall)
        print(f"launches: K6 {L * len(vreqs)} = {L} x {len(vreqs)} "
              f"prefills, K3 {L * steps_} = {L} x {steps_} decode steps, "
              f"nothing else; capacity gain {veng.capacity_gain():.2f}x; "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        vproj = veng.proj
        s3o["phi-3-vision"] = {
            "ranks": (vmp.rank_k, vmp.rank_v), "K3": L * steps_,
            "K6": k6_calib + L * len(vreqs),
            "lengths": [int(n) + 31 for n in vlens[:8]],
            "decode_ms": 1e3 * veng.decode_seconds / steps_,
            "prefill_s": veng.prefill_seconds}
        del veng
        # one image-prefix request at model level: 576 patches of the stub
        # frontend ahead of 300 text tokens, then 16 greedy decode steps
        img = stub_batch(vcfg, 1, 300, seed=99)
        S_txt, n_new = 300, 16
        T_img = P_img + S_txt + n_new
        zero_counts()
        t0 = time.perf_counter()
        lg, vcache = vmodel.prefill(vparams, img, T_img, proj=vproj)
        vtoks = []
        for i in range(n_new):
            tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
            vtoks.append(int(tok))
            lg, vcache = vmodel.decode_step(vparams, vcache, tok,
                                            P_img + S_txt + i, proj=vproj)
        torch.cuda.synchronize()
        img_s = time.perf_counter() - t0
        assert bool(torch.isfinite(lg).all()), "non-finite logits"
        assert vcache[0]["kc"].shape == (1, vcfg.n_kv_heads, T_img,
                                         vmp.rank_k)
        assert flash_attention.launches == L
        assert kq_decode_attention.launches == L * n_new
        assert not any(plain_calls.values()), plain_calls
        s3o["phi-3-vision"]["K6"] += L
        s3o["phi-3-vision"]["K3"] += L * n_new
        print(f"image-prefix request: {P_img} patches + {S_txt} tokens "
              f"prefilled into a cache of {T_img} positions, {n_new} greedy "
              f"decode steps at positions {P_img + S_txt}.."
              f"{P_img + S_txt + n_new - 1} in {img_s:.3f} s (K6 {L}, K3 "
              f"{L} x {n_new}); tokens {vtoks}")
        del vparams, vmodel, vproj, vcache, lg
        torch.cuda.empty_cache()
        print(f"phase 3o: {time.perf_counter() - t_3o:.1f} s")


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

        def measure_k3(row, label, H_, Hkv_, rk_, rv_, el, T_, scale_):
            """K3 for slots of lengths ``el`` in (B, Hkv, T_, R) caches
            against its plain version, timed beside SDPA, in both
            types."""
            B_, m_ = len(el), H_ // Hkv_
            live_ = int(el.sum())
            emask = (torch.arange(T_, device=dev)[None, :]
                     < el[:, None])[:, None, None, :]
            for dt_name in ("bfloat16", "float32"):
                dt = getattr(torch, dt_name)
                qc = torch.randn(B_, H_, rk_, generator=g, device=dev).to(dt)
                kc = torch.randn(B_, Hkv_, T_, rk_, generator=g,
                                 device=dev).to(dt)
                vc = torch.randn(B_, Hkv_, T_, rv_, generator=g,
                                 device=dev).to(dt)
                kx = kc.repeat_interleave(m_, dim=1)
                vx = vc.repeat_interleave(m_, dim=1)
                isz = qc.element_size()
                measure(row, label, dt_name,
                        lambda: kq_decode_attention(qc, kc, vc, el,
                                                    scale=scale_),
                        lambda: kq_decode_attention_ref(qc, kc, vc, el,
                                                        scale=scale_),
                        lambda: sdpa(qc[:, :, None], kx, vx, attn_mask=emask,
                                     scale=scale_)[:, :, 0],
                        flush, *work_bytes_flops(k3_mod.kq_decode_work(
                            B_, H_, Hkv_, rk_, rv_, isz, live_)))
                del qc, kc, vc, kx, vx

        k3 = {"name": "kq_decode (K3)", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/kq_decode.cu "
                        "(bf16 body: csrc/kq_decode_tc.cuh; float32: "
                        "csrc/kq_attend.cuh)",
              "replaces": "src/repro/kernels/kq_decode/kq_decode.py:53",
              "launches": k3_launches, "cluster_size": cluster(T),
              "shape": {"B": B, "H": H, "Hkv": Hkv, "T": T, "Rk": rk,
                        "Rv": rv, "lengths": lengths.tolist()}}
        measure_k3(k3, "K3", H, Hkv, rk, rv, lengths, T, scale)
        live = int(lengths.sum())
        mask = (torch.arange(T, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        # K3 at phase 3n's jamba shapes (4 slots of 4608, 64 query heads
        # over 8 kv heads: m 8, d_head 128, its ranks, the longest four
        # requests' lengths at their last step) and at phase 3o's
        # phi-3-vision ones (8 slots of 2048, MHA: m 1, d_head 96)
        (jrk, jrv), jel = s3n["ranks"], s3n["lengths"]
        k3j = {"name": "kq_decode (K3), jamba-1.5-large-398b m = 8",
               "route": "cuda", "source": k3["source"],
               "replaces": k3["replaces"], "launches": s3n["K3"],
               "launches_from": "phase 3n", "cluster_size": cluster(4608),
               "shape": {"B": 4, "H": 64, "Hkv": 8, "T": 4608, "Rk": jrk,
                         "Rv": jrv, "lengths": jel}}
        measure_k3(k3j, "K3 jamba m=8", 64, 8, jrk, jrv,
                   torch.tensor(jel, dtype=torch.int32, device=dev), 4608,
                   128 ** -0.5)
        v3o = s3o["phi-3-vision"]
        (vrk, vrv), vel = v3o["ranks"], v3o["lengths"]
        k3p = {"name": "kq_decode (K3), phi-3-vision-4.2b m = 1",
               "route": "cuda", "source": k3["source"],
               "replaces": k3["replaces"], "launches": v3o["K3"],
               "launches_from": "phase 3o (b)",
               "cluster_size": cluster(2048),
               "shape": {"B": 8, "H": 32, "Hkv": 32, "T": 2048, "Rk": vrk,
                         "Rv": vrv, "lengths": vel}}
        measure_k3(k3p, "K3 phi-3-vision m=1", 32, 32, vrk, vrv,
                   torch.tensor(vel, dtype=torch.int32, device=dev), 2048,
                   96 ** -0.5)

        # K3's span output at phase 3r's shape (8 slots, the whole cache
        # of 1024 one span on (1, 1); lengths those of its last decode
        # step), and at a quarter span of 256 (a (1, 4) cut) whose rows
        # lie before, across and past it; held to its plain version (rows
        # and LSE), timed beside SDPA over the same span; then two half
        # spans merged by their LSE against one whole-cache K3 call
        def measure_span(row, label, T_, el):
            B_, live_ = len(el), int(el.sum())
            emask = (torch.arange(T_, device=dev)[None, :]
                     < el[:, None])[:, None, None, :]
            for dt_name in ("bfloat16", "float32"):
                dt = getattr(torch, dt_name)
                qc = torch.randn(B_, H, rk, generator=g, device=dev).to(dt)
                kc = torch.randn(B_, Hkv, T_, rk, generator=g,
                                 device=dev).to(dt)
                vc = torch.randn(B_, Hkv, T_, rv, generator=g,
                                 device=dev).to(dt)
                kx = kc.repeat_interleave(m, dim=1)
                vx = vc.repeat_interleave(m, dim=1)
                isz = qc.element_size()

                def both(fn):
                    out, lse = fn(qc, kc, vc, el, scale=scale)
                    return torch.cat([out, lse[..., None]], dim=-1)

                measure(row, label, dt_name,
                        lambda: both(kq_decode_attention_span),
                        lambda: both(kq_decode_attention_span_ref), None,
                        flush, *work_bytes_flops(k3_mod.kq_decode_span_work(
                            B_, H, Hkv, rk, rv, isz, live_)))
                out, lse = kq_decode_attention_span(qc, kc, vc, el,
                                                    scale=scale)
                dead = el == 0
                assert bool((out[dead] == 0).all()) and bool(
                    (lse[dead] <= -1e29).all()), f"{label}: empty span"
                sd = lambda: sdpa(qc[:, :, None], kx, vx, attn_mask=emask,
                                  scale=scale)[:, :, 0]
                live_rows = ~dead
                lib_err = float((sd()[live_rows].float()
                                 - out[live_rows]).abs().max())
                assert lib_err <= 10 * TOL[dt_name], (label, lib_err)
                key = "library_ms" if dt_name == "bfloat16" else \
                    "library_ms_float32"
                row[key] = cuda_time_ms(sd, flush)
                print(f"{label} {dt_name}: SDPA over the span "
                      f"{row[key]:.4f} ms (|diff| {lib_err:.3g} on live "
                      f"rows)")
                del qc, kc, vc, kx, vx

        el_3r = torch.full((8,), 512 + n_new_3r, dtype=torch.int32,
                           device=dev)
        k3s = {"name": "kq_decode span output (K3 with LSE)",
               "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/kq_decode.cu "
                         "(kq_decode_span_launch; bodies as K3's)",
               "replaces": k3["replaces"],
               "launches": s3r["mesh, sequence on model"]["K3 span"],
               "launches_from": "phase 3r (a), the cache's sequence on the "
                                "model axis",
               "cluster_size": cluster(1024),
               "shape": {"B": 8, "H": H, "Hkv": Hkv, "T": 1024, "Rk": rk,
                         "Rv": rv, "lengths": el_3r.tolist()}}
        measure_span(k3s, "K3 span", 1024, el_3r)
        el_q = torch.tensor([0, 0, 1, 31, 200, 256, 256, 256],
                            dtype=torch.int32, device=dev)
        k3q = {"quarter": True}
        measure_span(k3q, "K3 span, a quarter of 1024", 256, el_q)
        k3s["quarter_span"] = {k: k3q[k] for k in k3q
                               if k.startswith(("ms", "plain_ms",
                                                "library_ms", "bound",
                                                "max_abs"))}
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            qc = torch.randn(8, H, rk, generator=g, device=dev).to(dt)
            kc = torch.randn(8, Hkv, 1024, rk, generator=g, device=dev).to(dt)
            vc = torch.randn(8, Hkv, 1024, rv, generator=g, device=dev).to(dt)
            whole = kq_decode_attention(qc, kc, vc, lengths, scale=scale)
            parts = [kq_decode_attention_span(
                qc, kc[:, :, t0:t0 + 512].contiguous(),
                vc[:, :, t0:t0 + 512].contiguous(),
                (lengths - t0).clamp(0, 512).to(torch.int32), scale=scale)
                for t0 in (0, 512)]
            o = torch.stack([x for x, _ in parts], dim=-3)    # (B, 2, H, R)
            ls = torch.stack([y for _, y in parts], dim=-2)
            merged = combine_split_partials(o, ls).to(dt)
            err = check_close("K3 two half spans merged", dt_name, merged,
                              whole)
            print(f"K3 two half spans merged against one whole-cache K3 "
                  f"call, {dt_name}: max |err| {err:.3g} (lengths "
                  f"{lengths.tolist()})")
            del qc, kc, vc

        # K1 at the paged main path's decode shapes (pages of 16) and K2 at
        # its prefill shapes, each on random pools of its row's shape
        ps, n_pages = 16, T // 16

        def measure_k1(row, label, H_, Hkv_, rk_, rv_, el, scale_=None):
            """K1 for slots of lengths ``el`` against its plain version,
            timed beside SDPA, in both types (``scale_``: the model's
            softmax scale, tinyllama's by default)."""
            B_, m_ = len(el), H_ // Hkv_
            sc_ = scale if scale_ is None else scale_
            live_, used = int(el.sum()), int(((el + ps - 1) // ps).sum())
            emask = (torch.arange(T, device=dev)[None, :]
                     < el[:, None])[:, None, None, :]
            for dt_name in ("bfloat16", "float32"):
                dt = getattr(torch, dt_name)
                qc, kp, vp, btab = paged_inputs(g, dev, dt, B_, H_, Hkv_, ps,
                                                n_pages, rk_, rv_)
                kx = gather_pages(kp, btab).repeat_interleave(m_, dim=1)
                vx = gather_pages(vp, btab).repeat_interleave(m_, dim=1)
                isz = qc.element_size()
                measure(row, label, dt_name,
                        lambda: kq_decode_paged_attention(qc, kp, vp, el,
                                                          btab, scale=sc_),
                        lambda: kq_decode_paged_attention_ref(
                            qc, kp, vp, el, btab, scale=sc_),
                        lambda: sdpa(qc[:, :, None], kx, vx, attn_mask=emask,
                                     scale=sc_)[:, :, 0],
                        flush, *work_bytes_flops(
                            paged_mod.kq_decode_paged_work(
                                B_, H_, Hkv_, rk_, rv_, isz, live_, used)))

        def measure_k2(row, label, H_, Hkv_, rk_, rv_, scale_=None):
            """K2 for one chunk at ``row``'s (S, pos0, n_valid) against its
            plain version, timed beside SDPA, in both types (``scale_`` as
            in ``measure_k1``)."""
            m_ = H_ // Hkv_
            sc_ = scale if scale_ is None else scale_
            S, pos0_v = row["shape"]["S"], row["shape"]["pos0"]
            n_valid = row["shape"]["n_valid"]
            plen = torch.tensor([pos0_v + n_valid], dtype=torch.int32,
                                device=dev)
            pos0 = torch.tensor([pos0_v], dtype=torch.int32, device=dev)
            qpos = pos0_v + torch.arange(S, device=dev)
            t = torch.arange(T, device=dev)
            cmask = ((t[None, :] <= qpos[:, None])
                     & (t[None, :] < int(plen)))[None, None]   # (1,1,S,T)
            for dt_name in ("bfloat16", "float32"):
                dt = getattr(torch, dt_name)
                qc, kp, vp, btab = paged_inputs(g, dev, dt, 1, H_, Hkv_, ps,
                                                n_pages, rk_, rv_, S=S)
                kx = gather_pages(kp, btab).repeat_interleave(m_, dim=1)
                vx = gather_pages(vp, btab).repeat_interleave(m_, dim=1)
                isz = qc.element_size()
                measure(row, f"{label} pos0={pos0_v} n_valid={n_valid}",
                        dt_name,
                        lambda: kq_prefill_paged_attention(
                            qc, kp, vp, plen, pos0, btab, scale=sc_),
                        lambda: kq_prefill_paged_attention_ref(
                            qc, kp, vp, plen, pos0, btab, scale=sc_),
                        lambda: sdpa(qc, kx, vx, attn_mask=cmask,
                                     scale=sc_),
                        flush, *work_bytes_flops(
                            paged_mod.kq_prefill_paged_work(
                                H_, Hkv_, S, rk_, rv_, isz, ps, [int(plen)],
                                [pos0_v])))

        k1 = {"name": "kq_decode_paged (K1)", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/kq_paged.cu "
                        "(bf16 body: csrc/kq_decode_tc.cuh; float32: "
                        "csrc/kq_attend.cuh)",
              "replaces": "src/repro/kernels/kq_decode/paged.py:63",
              "launches": k1_launches, "cluster_size": cluster(ps * n_pages),
              "shape": {"B": B, "H": H, "Hkv": Hkv, "page_size": ps,
                        "n_pages": n_pages, "Rk": rk, "Rv": rv,
                        "lengths": lengths.tolist()}}
        measure_k1(k1, "K1", H, Hkv, rk, rv, lengths)
        pages_used = int(((lengths + ps - 1) // ps).sum())

        # K2: the last chunk of a 1000-token prompt, 232 real tokens in a
        # 256 bucket, a first chunk (pos0 0, 256 real), as every request's
        # first of phase 3c's chunks is, and a chunk the token budget
        # truncated (pos0 504, mid-page, 248 real tokens in a 256 bucket)
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
        k2t = dict(k2_src, name="kq_prefill_paged (K2), truncated chunk",
                   shape=dict(k2_shape, pos0=504, n_valid=248))
        for row in (k2, k2f, k2t):
            measure_k2(row, "K2", H, Hkv, rk, rv)

        # K1 and K2 at phase 3l's serving shapes: smollm-360m's 15 query
        # heads over 5 kv heads (m = 3, the first odd group on the decode
        # path), the ranks its KQ-SVD solved, its first 8 requests' lengths
        # at their last decode step, pages of 16; K2 at the last chunk of
        # its 1000-token prompt
        sH, sHkv = 15, 5
        s_shape = {"H": sH, "Hkv": sHkv, "page_size": ps,
                   "n_pages": n_pages, "Rk": s3l["Rk"], "Rv": s3l["Rv"]}
        k1s = {"name": "kq_decode_paged (K1), smollm-360m m = 3",
               "route": "cuda", "source": k1["source"],
               "replaces": k1["replaces"], "launches": s3l["K1"],
               "launches_from": "phase 3l",
               "cluster_size": cluster(ps * n_pages),
               "shape": dict(s_shape, B=8, lengths=s3l["lengths"])}
        measure_k1(k1s, "K1 smollm-360m m=3", sH, sHkv, s3l["Rk"],
                   s3l["Rv"], torch.tensor(s3l["lengths"], dtype=torch.int32,
                                           device=dev))
        k2s = dict(k2_src, name="kq_prefill_paged (K2), smollm-360m m = 3",
                   launches=s3l["K2"], launches_from="phase 3l",
                   shape=dict(s_shape, B=1, S=256, pos0=768, n_valid=232))
        measure_k2(k2s, "K2 smollm-360m m=3", sH, sHkv, s3l["Rk"],
                   s3l["Rv"])

        # K1, K5 and K2 at phase 3m's arctic-480b shapes: 56 query heads
        # padded to 64 over 8 kv heads (m 8, the int8 pages' group limit),
        # d_head 128 (scale 1/sqrt(128)), the ranks its KQ-SVD solved, its
        # first 8 requests' lengths at their last decode step, pages of 16;
        # K2 at the last chunk of its 1000-token prompt
        a3m = s3m["arctic"]
        aH, aHkv, arc_scale = 64, 8, 128 ** -0.5
        (ark, arv), alens_ = a3m["ranks"], a3m["lengths"]
        a_shape = {"H": aH, "Hkv": aHkv, "page_size": ps,
                   "n_pages": n_pages, "Rk": ark, "Rv": arv}
        ael = torch.tensor(alens_, dtype=torch.int32, device=dev)
        k1a = {"name": "kq_decode_paged (K1), arctic-480b m = 8",
               "route": "cuda", "source": k1["source"],
               "replaces": k1["replaces"],
               "launches": a3m["launches"]["fp"]["kq_decode_paged_attention"],
               "launches_from": "phase 3m (arctic, fp pages)",
               "cluster_size": cluster(ps * n_pages),
               "shape": dict(a_shape, B=8, lengths=alens_)}
        measure_k1(k1a, "K1 arctic m=8", aH, aHkv, ark, arv, ael, arc_scale)
        k2a = dict(k2_src, name="kq_prefill_paged (K2), arctic-480b m = 8",
                   launches=a3m["launches"]["fp"][
                       "kq_prefill_paged_attention"],
                   launches_from="phase 3m (arctic, fp pages)",
                   shape=dict(a_shape, B=1, S=256, pos0=768, n_valid=232))
        measure_k2(k2a, "K2 arctic m=8", aH, aHkv, ark, arv, arc_scale)
        k5a = {"name": "kq_decode_paged_int8 (K5), arctic-480b m = 8",
               "route": "cuda", "source": k1["source"],
               "replaces": "src/repro/kernels/kq_decode/paged.py:63 "
                           "(quant=True)",
               "launches": a3m["launches"]["int8"]["kq_decode_paged_int8"],
               "launches_split": a3m["launches"]["int8"][
                   "kq_decode_paged_int8_split"],
               "launches_from": "phase 3m (arctic, int8 pages, dynamic "
                                "splits: K5 and K5 split)",
               "cluster_size": cluster(ps * n_pages),
               "shape": dict(a_shape, B=8, lengths=alens_)}
        a_live = int(ael.sum())
        a_used = int(((ael + ps - 1) // ps).sum())
        a_mask = (torch.arange(T, device=dev)[None, :]
                  < ael[:, None])[:, None, None, :]
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            qc, kp, vp, btab = paged_inputs(g, dev, dt, 8, aH, aHkv, ps,
                                            n_pages, ark, arv)
            k8, v8, ks8, vs8 = int8_pools(kp.float(), vp.float())
            kdx = (gather_pages(k8, btab).float()
                   * gather_pages(ks8, btab).float()).to(dt) \
                .repeat_interleave(aH // aHkv, dim=1)
            vdx = (gather_pages(v8, btab).float()
                   * gather_pages(vs8, btab).float()).to(dt) \
                .repeat_interleave(aH // aHkv, dim=1)
            isz = qc.element_size()
            measure(k5a, "K5 arctic m=8", dt_name,
                    lambda: kq_decode_paged_int8(
                        qc, k8, v8, ks8, vs8, ael, btab, scale=arc_scale),
                    lambda: plain_decode(qc, k8, v8, ael, btab, arc_scale, 1,
                                         ks8, vs8),
                    lambda: sdpa(qc[:, :, None], kdx, vdx, attn_mask=a_mask,
                                 scale=arc_scale)[:, :, 0],
                    flush, *work_bytes_flops(
                        paged_mod.kq_decode_paged_int8_work(
                            8, aH, aHkv, ark, arv, isz, a_live, a_used)))
            del qc, kp, vp, btab, k8, v8, ks8, vs8, kdx, vdx

        # K1 and K2 at phase 3o's musicgen-large shapes: MHA (m 1, 32 heads
        # of 64), the ranks its KQ-SVD solved on the stub frontend's
        # embeddings, its first 8 requests' lengths at their last decode
        # step, pages of 16; K2 at the last chunk of its 1000-token prompt
        u3o = s3o["musicgen"]
        (urk, urv), ulens_ = u3o["ranks"], u3o["lengths"]
        u_shape = {"H": 32, "Hkv": 32, "page_size": ps, "n_pages": n_pages,
                   "Rk": urk, "Rv": urv}
        k1u = {"name": "kq_decode_paged (K1), musicgen-large m = 1",
               "route": "cuda", "source": k1["source"],
               "replaces": k1["replaces"], "launches": u3o["K1"],
               "launches_from": "phase 3o (a)",
               "cluster_size": cluster(ps * n_pages),
               "shape": dict(u_shape, B=8, lengths=ulens_)}
        measure_k1(k1u, "K1 musicgen m=1", 32, 32, urk, urv,
                   torch.tensor(ulens_, dtype=torch.int32, device=dev))
        k2u = dict(k2_src, name="kq_prefill_paged (K2), musicgen-large m = 1",
                   launches=u3o["K2"], launches_from="phase 3o (a)",
                   shape=dict(u_shape, B=1, S=256, pos0=768, n_valid=232))
        measure_k2(k2u, "K2 musicgen m=1", 32, 32, urk, urv)

        # K4, K5 (unsplit and split) and the split merge at the paged
        # main path's decode shapes (pages of 16), 8 splits of 8 pages.
        # bf16 K4 and K5 split merge their spans in their own launch, so
        # their bound counts what the function reads and writes (as K1's
        # and K5's); the f32 partials, written and read back through L2
        # inside the launch, are counted only in ``bound_ms_with_partials``
        # (and in float32, which still merges in a second launch)
        n_sp, span = resolve_splits(8, n_pages)
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
        # launches under phase 3j's runs (optimistic admission with
        # preemption, prefix sharing; fp pages K1 and K2, int8 pages K5)
        k1["launches_3j"] = j_launch["K1"]
        k5["launches_3j"] = j_launch["K5"]
        for row in (k2, k2f, k2t):
            row.update(launches_3j=j_launch["K2"], launches_3k=k_launch["K2"])
        # and under phase 3k's five runs (chaos, audits, the token budget:
        # fp pages K1 and K2, int8 pages K5 and K5 split)
        k1["launches_3k"] = k_launch["K1"]
        k5["launches_3k"] = k_launch["K5"]
        k5s["launches_3k"] = k_launch["K5 split"]
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
            bf16 = dt_name == "bfloat16"
            dims = (B, H, Hkv, rk, rv, isz, live, pages_used)
            comb = paged_mod.kq_combine_splits_work(B, Hkv, n_sp, m, rv, isz)
            # one launch in bf16 (its spans merged in it); in float32 the
            # partials, then the merge kernel: both launches' bytes
            k4w, k5sw = (
                (fl, nb + (0 if bf16 else comb[1])) for fl, nb in (
                    paged_mod.kq_decode_paged_split_work(
                        *dims, n_sp, merged=bf16),
                    paged_mod.kq_decode_paged_int8_split_work(
                        *dims, n_sp, merged=bf16)))
            measure(k4, "K4", dt_name,
                    lambda: kq_decode_paged_attention(
                        qc, kp, vp, lengths, btab, scale=scale,
                        num_splits=8),
                    lambda: plain_decode(qc, kp, vp, lengths, btab, scale, 8),
                    lambda: sdpa(qc[:, :, None], kx, vx, attn_mask=mask,
                                 scale=scale)[:, :, 0],
                    flush, *work_bytes_flops(k4w))
            measure(k5, "K5", dt_name,
                    lambda: kq_decode_paged_int8(
                        qc, k8, v8, ks8, vs8, lengths, btab, scale=scale),
                    lambda: plain_decode(qc, k8, v8, lengths, btab, scale, 1,
                                         ks8, vs8),
                    lambda: sdpa(qc[:, :, None], kdx, vdx, attn_mask=mask,
                                 scale=scale)[:, :, 0],
                    flush, *work_bytes_flops(
                        paged_mod.kq_decode_paged_int8_work(*dims)))
            measure(k5s, "K5 split", dt_name,
                    lambda: kq_decode_paged_attention(
                        qc, k8, v8, lengths, btab, scale=scale, num_splits=8,
                        kscale=ks8, vscale=vs8),
                    lambda: plain_decode(qc, k8, v8, lengths, btab, scale, 8,
                                         ks8, vs8),
                    lambda: sdpa(qc[:, :, None], kdx, vdx, attn_mask=mask,
                                 scale=scale)[:, :, 0],
                    flush, *work_bytes_flops(k5sw))
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
                    nbytes = (paged_mod.kq_decode_paged_split_work
                              if label == "K4" else
                              paged_mod.kq_decode_paged_int8_split_work)(
                        *dims, n_sp, merged=False)[1] + comb[1]
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
                    *work_bytes_flops(comb))

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
        # would hold 4.6 GB at 6000), at paper-llama2-7b's calibration
        # batch (MHA, d_head 128) and at smollm-360m's training batch
        # (phase 3l: m = 3).  Bound: 4 d_head flops per (query, key)
        # pair of the band per head, against q, k, v and out moved once.
        def band_mask(S, W):
            t = torch.arange(S, device=dev)
            keep = t[None, :] <= t[:, None]
            return keep & (t[:, None] - t[None, :] < W) if W else keep

        k6_src = {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/flash.cu",
                  "replaces": "src/repro/kernels/flash/flash.py:29",
                  "launches": k6_launches["phase 3"]
                  + k6_launches["phase 3g"] + k6_launches["phase 3l"]
                  + k6_launches["phase 3q"] + k6_launches["phase 3r"],
                  "launches_from": "phases 3, 3g, 3l, 3q and 3r (training: "
                                   "forward and remat recompute, 3q's on "
                                   "a mesh through local_map and on one "
                                   "device; 3r: a prefill a run, two of "
                                   "its three on a mesh; then "
                                   "calibration)"}
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
        k6t = dict(k6_src, name="flash (K6), smollm-360m training batch",
                   shape={"B": 8, "H": 15, "Hkv": 5, "S": 512, "dh": 64,
                          "window": 0})
        # and at phase 3n's and 3o's calibration batches: jamba's attention
        # layer (64 / 8 heads of 128: m 8) and phi-3-vision's MHA heads of
        # 96 over 576 patches and 512 text tokens
        k6j = dict(k6_src, name="flash (K6), jamba-1.5-large-398b "
                                "calibration batch",
                   launches=s3n["K6"], launches_from="phase 3n (1 attention "
                   "layer x (4 calibration batches + 8 prefills))",
                   shape={"B": 4, "H": 64, "Hkv": 8, "S": 512, "dh": 128,
                          "window": 0})
        k6p = dict(k6_src, name="flash (K6), phi-3-vision-4.2b calibration "
                                "batch (576 patches + 512 tokens)",
                   launches=s3o["phi-3-vision"]["K6"],
                   launches_from="phase 3o (b) (32 x (4 calibration "
                                 "batches + 16 prefills + 1 image-prefix "
                                 "prefill))",
                   shape={"B": 4, "H": 32, "Hkv": 32, "S": 1088, "dh": 96,
                          "window": 0})
        k6u = dict(k6_src, name="flash (K6), musicgen-large calibration "
                                "batch (frame embeddings)",
                   launches=s3o["musicgen"]["K6"],
                   launches_from=f"phase 3o (a) ({DEPTH_3O} x 4 calibration "
                                 "batches)",
                   shape={"B": 4, "H": 32, "Hkv": 32, "S": 512, "dh": 64,
                          "window": 0})
        for row, S_long in ((k6c, None), (k6w, 6000), (k6l, None),
                            (k6t, None), (k6j, None), (k6p, None),
                            (k6u, None)):
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
                    flops, nbytes = flash_mod.flash_work(
                        B_, H_, Hkv_, S, dh_, dh_, isz, W_)
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
        # K6 at deepseek-v2-lite's calibration batch: MLA's materialised
        # heads, q/k of width 192 (nope 128 + rope 64) and v of 128, H =
        # Hkv = 16, causal, scale 1/sqrt(192).  Bound: 2 (dh + dv) flops
        # per causal (query, key) pair per head, against q, k, v and out
        # moved once.
        k6m = dict(k6_src, name="flash (K6), deepseek-v2-lite-16b (MLA) "
                                "calibration batch",
                   launches=k6_launches["phase 3m deepseek"]
                   + k6_launches["phase 3r deepseek"],
                   launches_from=f"phase 3m (deepseek-v2-lite cut to "
                                 f"{DEPTH_3M} layers: {DEPTH_3M} x (4 "
                                 f"calibration batches + 16 prefills)) "
                                 f"and 3r (b) ({DEPTH_3R_DEEPSEEK} layers "
                                 f"x 2 x 3 steps, on the mesh and on one "
                                 f"device)",
                   shape={"B": 4, "H": 16, "Hkv": 16, "S": 512, "dh": 192,
                          "dv": 128, "window": 0})
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            isz = torch.finfo(dt).bits // 8
            q, k = (torch.randn(4, 16, 512, 192, generator=g, device=dev)
                    .to(dt) for _ in range(2))
            v = torch.randn(4, 16, 512, 128, generator=g, device=dev).to(dt)
            mscale = 192 ** -0.5
            measure(k6m, "K6 MLA (192, 128) S=512", dt_name,
                    lambda: flash_attention(q, k, v, scale=mscale),
                    lambda: flash_attention_ref(q, k, v, scale=mscale),
                    lambda: sdpa(q, k, v, is_causal=True, scale=mscale),
                    flush, *work_bytes_flops(flash_mod.flash_work(
                        4, 16, 16, 512, 192, 128, isz)))
            del q, k, v
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

        def k7_shares(label, args, calls=10, attempts=3):
            """Each of K7's kernels' device ms per launch (its recorded
            time over its recorded launches) and share of a call, from
            torch.profiler over ``calls`` calls (L2 flushed before each),
            with the CPU and CUDA activities the other profiles trace.  A
            trace that recorded none of K7's kernels (once in a card run
            whose K7 launches and outputs were right) is taken again, up
            to ``attempts`` traces."""
            from torch.profiler import ProfilerActivity, profile
            ssd_chunk_scan(*args, chunk=256, out_dtype=f32)
            torch.cuda.synchronize()
            for attempt in range(attempts):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(calls):
                        flush()
                        ssd_chunk_scan(*args, chunk=256, out_dtype=f32)
                    torch.cuda.synchronize()
                per = {e.key: (e.device_time_total / 1e3 / e.count, e.count)
                       for e in prof.key_averages()
                       if any(k in e.key for k in K7_KERNELS)
                       and e.device_time_total > 0}
                total = sum(t for t, _ in per.values())
                if total > 0:
                    break
                print(f"K7 profile {attempt + 1}: no K7 kernel recorded")
            assert total > 0, "the profiler saw no K7 kernel"
            print(f"{label} bfloat16 under torch.profiler: "
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
                    flops, nbytes = ssd_mod.ssd_work(1, 80, 1, S, 64, 128,
                                                     256, isz, 4)
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
                    k7_shares(f"K7 S={S}", args)
                del args, out
        # K7 at phase 3n's jamba prefill: B 1, 128 heads of 128, one group
        # of d_state 64, chunk 256, S 4096 (its longest prompt), the model's
        # views and law as above; the registers and spills phase 2 printed
        # for the (128, 64) instantiations beside it
        jsh = {"B": 1, "nh": 128, "G": 1, "S": 4096, "hd": 128, "n": 64,
               "chunk": 256}
        k7j = {"name": "ssd_chunk_scan (K7), jamba-1.5-large-398b prefill",
               "route": "cuda", "source": k7["source"],
               "replaces": k7["replaces"], "launches": s3n["K7"],
               "launches_from": "phase 3n",
               "shape": dict(jsh, y="float32", layout="model views"),
               "registers_spills": {
                   e.split(": ")[0]: e.split(": ")[1]
                   for e in ptxas_summary(logs["ssd"])
                   if "/128/64" in e or "K7 pass" in e}}
        print(f"K7 at jamba's head, registers+spilled bytes (phase 2): "
              f"{k7j['registers_spills']}")
        for dt_name in ("bfloat16", "float32"):
            isz = torch.finfo(getattr(torch, dt_name)).bits // 8
            args = ssd_views(dt_name, 1, 128, 1, 4096, 128, 64, True, 4096)
            flops, nbytes = ssd_mod.ssd_work(1, 128, 1, 4096, 128, 64, 256,
                                             isz, 4)
            measure(k7j, "K7 jamba S=4096", dt_name,
                    lambda args=args: ssd_chunk_scan(
                        *args, chunk=256, out_dtype=f32),
                    lambda args=args: ssd_chunk_scan_plain(
                        *args, chunk=256, out_dtype=f32),
                    None, flush, nbytes, flops, 20, check=check_ssd)
            out = ssd_chunk_scan(*args, chunk=256, out_dtype=f32)
            err64 = check_recurrence("K7 jamba S=4096", dt_name, out, args)
            sfx = "" if dt_name == "bfloat16" else "_float32"
            k7j[f"max_abs_err_vs_float64_S4096{sfx}"] = err64
            print(f"K7 jamba S=4096 {dt_name}: |kernel - float64 "
                  f"recurrence| {err64:.3g}")
            if dt_name == "bfloat16":
                k7_shares("K7 jamba S=4096", args)
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
        kernels = [k1, k1s, k1a, k1u, k2, k2f, k2t, k2s, k2a, k2u, k3, k3j,
                   k3p, k3s, k4, k5, k5a, k5s, kcomb, k6c, k6w, k6l, k6t, k6m,
                   k6j, k6p, k6u, k7, k7j]

    # -- 5: the port on the card against the port on the CPU ---------------
    with phase("5 card against CPU, reduced tinyllama-1.1b, "
               "h2o-danube-1.8b, mamba2-2.7b, smollm-360m, "
               "deepseek-v2-lite-16b, arctic-480b, jamba-1.5-large-398b, "
               "musicgen-large and phi-3-vision-4.2b, float32"):
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
                   "dense int8": ({}, {"cache_quant": "int8"}),
                   "paged chunked, 2 shards": (dict(chunked, shards=2), {}),
                   "int8 pages, dynamic splits, 2 shards": (dict(
                       chunked, cache_quant="int8", decode_splits=0,
                       shards=2), {})}
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
        for kind in ("paged chunked", "int8 pages, dynamic splits"):
            same = sum(a == b for a, b in zip(served[kind][1],
                                              served[kind + ", 2 shards"][1]))
            print(f"{kind}: 2 shards' tokens equal 1 shard's on {same}/"
                  f"{len(prompts)} requests (card)")
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

        # optimistic admission on 11 pages (worst cases up to 10): recompute
        # and swap; and int8 pages shared under swap on 10 fp-page units,
        # the prompts behind a common 13-token prefix, two of them repeated.
        # Card = CPU, and both = the reserve engine on the same pages
        sysp = np.random.default_rng(6).integers(
            0, rcfg.vocab_size, 13).astype(np.int32)
        sprompts = [np.concatenate([sysp, prompts[i]])
                    for i in (0, 1, 2, 3, 0, 1, 4, 5, 6, 7, 8)]
        opt = dict(chunked, n_pages=11, admission="optimistic",
                   watermark_low=0.1)
        more = {"optimistic recompute": (dict(opt), chunked, prompts),
                "optimistic swap": (dict(opt, preempt_mode="swap"), chunked,
                                    prompts),
                "int8 pages shared, swap": (
                    dict(chunked, n_pages=10, cache_quant="int8",
                         share_prefix=True, admission="optimistic",
                         preempt_mode="swap", watermark_low=0.1),
                    dict(chunked, cache_quant="int8"), sprompts)}
        names = ("n_preempted", "n_swapped_out", "n_swapped_in",
                 "n_shared_pages", "n_cow_forks", "n_full_hits")
        for kind, (kw, oracle_kw, ps_) in more.items():
            got, counts = [], []
            for m_, p_, kw_ in ((cpu_model, p_cpu, kw), (gpu_model, p_gpu, kw),
                                (cpu_model, p_cpu, oracle_kw)):
                e = ServingEngine(rcfg, p_, ServeConfig(
                    max_seq_len=64, max_batch=4, decode_chunk=4, **kw_),
                    projections=rmp, device=m_.device)
                rs = [Request(rid=i, prompt=p, max_new_tokens=8)
                      for i, p in enumerate(ps_)]
                e.generate(rs)
                pinned = e._pindex.n_pinned if e._pindex is not None else 0
                assert e.pool.free_count + pinned == e.pool.n_pages, kind
                assert all(r.done and not r.failed for r in rs), kind
                got.append([r.out_tokens for r in rs])
                counts.append({n: getattr(e, n) for n in names})
            assert got[0] == got[1] == got[2], (kind, got)
            assert counts[0] == counts[1], (kind, counts)
            assert counts[1]["n_preempted"] >= 1, (kind, counts)
            if kw.get("preempt_mode") == "swap":
                assert counts[1]["n_swapped_in"] == \
                    counts[1]["n_swapped_out"] >= 1, (kind, counts)
            if kw.get("share_prefix"):
                assert counts[1]["n_shared_pages"] > 0 \
                    and counts[1]["n_cow_forks"] >= 1, (kind, counts)
            print(f"{kind}: {len(ps_)} requests' greedy tokens identical on "
                  f"card and CPU and equal to the reserve engine's; card "
                  f"counts {counts[1]} (= CPU)")

        # chaos with sampled audits, and the token budget on fp pages and
        # on int8 pages under chaos (the reference's paged-chaos,
        # paged-budget and paged-quant legs): card = CPU in tokens, firings
        # and budget log, and both = the legacy engine on the same pages
        leg = dict(share_prefix=True, admission="optimistic",
                   preempt_mode="swap", watermark_low=0.1, chaos_seed=0,
                   chaos_rate=0.25, audit=True, audit_every=2)
        legs = {"chaos + audits": (dict(chunked, n_pages=13, **leg),
                                   chunked),
                "budget 6, fp pages": (dict(chunked,
                                            max_num_batched_tokens=6),
                                       chunked),
                "budget 6, int8 pages, dynamic splits, chaos + audits": (
                    dict(chunked, n_pages=10, cache_quant="int8",
                         decode_splits=0, max_num_batched_tokens=6, **leg),
                    dict(chunked, cache_quant="int8"))}
        for kind, (kw, oracle_kw) in legs.items():
            got = []
            for m_, p_, kw_ in ((cpu_model, p_cpu, kw), (gpu_model, p_gpu, kw),
                                (cpu_model, p_cpu, oracle_kw)):
                e = ServingEngine(rcfg, p_, ServeConfig(
                    max_seq_len=64, max_batch=4, decode_chunk=4, **kw_),
                    projections=rmp, device=m_.device)
                rs = [Request(rid=i, prompt=p, max_new_tokens=8)
                      for i, p in enumerate(sprompts)]
                e.generate(rs)
                pinned = e._pindex.n_pinned if e._pindex is not None else 0
                assert e.pool.free_count + pinned == e.pool.n_pages, kind
                assert all(r.done and not r.failed for r in rs), kind
                got.append(([r.out_tokens for r in rs],
                            e.faults.fired_log if e.faults else [],
                            e.budget_log, e.n_audits))
            assert got[0] == got[1], (kind, got[:2])
            assert got[1][0] == got[2][0], (kind, got)
            if kw.get("chaos_seed") is not None:
                assert got[1][1] and got[1][3] > 0, (kind, got[1])
            if kw.get("max_num_batched_tokens"):
                assert any(x["fused"] for x in got[1][2]), kind
            print(f"{kind}: {len(sprompts)} requests' greedy tokens "
                  f"identical on card and CPU and equal to the legacy "
                  f"engine's; fired_log ({len(got[1][1])} firings), budget "
                  f"log ({len(got[1][2])} steps) and {got[1][3]} audits "
                  f"equal on both")

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

        # reduced tinyllama, float32: one training step on the card
        # against the CPU (K6 forward and its plain backward on the card):
        # loss, every gradient leaf within 1e-4 of its max-abs, and the
        # params after one AdamW step; elements whose |g| is below 1e-6 of
        # their leaf's max are left out and counted (Adam's first update
        # is g / (|g| + 1e-8), about sign(g)); just above that cut the
        # update still moves with the 1e-8, so those are held within 5% of
        # lr, the ones at 1e-4 of the max or more within 1e-5 + 1e-6
        ttc = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                          total_steps=10, checkpoint_every=0)
        trng = np.random.default_rng(8)
        tb = {k: trng.integers(0, rcfg.vocab_size, (4, 32)).astype(np.int32)
              for k in ("tokens", "labels")}
        got = []
        for m_, p_ in ((cpu_model, p_cpu), (gpu_model, p_gpu)):
            zero_counts()
            flash_attention_backward.launches = 0
            met, g_ = value_and_grad(make_loss_fn(m_, ttc), p_, tb)
            p2, _, met2 = make_train_step(m_, ttc)(
                p_, optim_mod.init_state(p_, ttc), tb)
            got.append((float(met["loss"]), float(met2["loss"]),
                        tree_to(g_, "cpu"), tree_to(p2, "cpu"), met2["lr"]))
        # the card's two steps: K6 forward and remat recompute each, the
        # plain backward once a layer a step, the plain forward never
        assert flash_attention.launches == rcfg.n_layers * 2 * 2
        assert flash_attention_backward.launches == rcfg.n_layers * 2
        assert plain_calls["flash_attention_ref"] == 0
        (lc, lc2, gc, pc, lr), (lg, lg2, gg, pg, _) = got
        np.testing.assert_allclose([lg, lg2], [lc, lc2], rtol=1e-5)
        gworst, left_out = 0.0, 0
        for (path, a_), (_, b_), (_, c_), (_, d_) in zip(
                tree_leaves(gg), tree_leaves(gc), tree_leaves(pg),
                tree_leaves(pc)):
            scale = float(b_.abs().max())
            err = float((a_ - b_).abs().max())
            assert err <= 1e-4 * scale, (path, err, scale)
            gworst = max(gworst, err / max(scale, 1e-30))
            keep = b_.abs() >= 1e-6 * b_.abs().max()
            far = b_.abs() >= 1e-4 * b_.abs().max()
            left_out += int((~keep).sum())
            np.testing.assert_allclose(c_[keep].numpy(), d_[keep].numpy(),
                                       rtol=1e-5, atol=0.05 * lr)
            np.testing.assert_allclose(c_[far].numpy(), d_[far].numpy(),
                                       rtol=1e-5, atol=1e-6)
        print(f"train step (reduced tinyllama, float32): loss card {lg:.6f} "
              f"cpu {lc:.6f}; gradients within {gworst:.3g} of each leaf's "
              f"max-abs (tol 1e-4); params after one AdamW step equal, "
              f"{left_out} elements with |g| < 1e-6 x max left out; K6 "
              f"{flash_attention.launches} launches and its plain backward "
              f"{flash_attention_backward.launches} calls on the card for "
              f"two steps")

        # reduced smollm-360m (tied embeddings): the dense and the paged
        # chunked engines with KQ-SVD give the same greedy tokens on card
        # and CPU
        sr = get_config("smollm-360m").reduced()
        scpu, sgpu = build_model(sr, "cpu"), build_model(sr, dev)
        sp_cpu = scpu.init(torch.Generator().manual_seed(0))
        sp_gpu = tree_to(sp_cpu, dev)
        assert "lm_head" not in sp_cpu
        srmp = calibrate_model(
            scpu, sp_cpu, calibration_batches(sr.vocab_size, 8, 32, batch=4),
            CompressionConfig(method="kqsvd", epsilon=0.1))
        sprompts_r = [np.random.default_rng(40 + i).integers(
            0, sr.vocab_size, L).astype(np.int32)
            for i, L in enumerate((5, 17, 30, 9))]
        for kind, kw in (("dense", {}), ("paged chunked", chunked)):
            out = []
            for m_, p_ in ((scpu, sp_cpu), (sgpu, sp_gpu)):
                e = ServingEngine(sr, p_, ServeConfig(
                    max_seq_len=64, max_batch=3, decode_chunk=4, **kw),
                    projections=srmp, device=m_.device)
                rs = [Request(rid=i, prompt=p, max_new_tokens=10)
                      for i, p in enumerate(sprompts_r)]
                e.generate(rs)
                assert all(r.done and len(r.out_tokens) == 10 for r in rs)
                out.append([r.out_tokens for r in rs])
            assert out[0] == out[1], (kind, out)
        print(f"smollm-360m (reduced, tied embeddings): {len(sprompts_r)} "
              f"requests' greedy tokens identical on card and CPU in the "
              f"dense and the paged chunked KQ-SVD engines")

        # the MoE and MLA families, reduced, float32: deepseek-v2-lite on
        # dense slots (the latent full and KQ-SVD), arctic on fp pages and
        # on int8 pages with dynamic splits, each card = CPU token for token
        mprompts_r = [np.random.default_rng(50 + i).integers(
            0, 256, L).astype(np.int32) for i, L in enumerate((5, 17, 30, 9,
                                                              22))]
        fam = {}
        for arch, kinds in (("deepseek-v2-lite-16b",
                             (("dense full", {}, False),
                              ("dense KQ-SVD", {}, True))),
                            ("arctic-480b",
                             (("fp pages", chunked, True),
                              ("int8 pages, dynamic splits", dict(
                                  chunked, cache_quant="int8",
                                  decode_splits=0), True)))):
            fcfg = get_config(arch).reduced()
            fcpu, fgpu = build_model(fcfg, "cpu"), build_model(fcfg, dev)
            fp_cpu = fcpu.init(torch.Generator().manual_seed(0))
            fp_gpu = tree_to(fp_cpu, dev)
            fmp = calibrate_model(
                fcpu, fp_cpu,
                calibration_batches(fcfg.vocab_size, 8, 32, batch=4),
                CompressionConfig(method="kqsvd", epsilon=0.1))
            for kind, kw, comp in kinds:
                out = []
                for m_, p_ in ((fcpu, fp_cpu), (fgpu, fp_gpu)):
                    zero_counts()
                    e = ServingEngine(fcfg, p_, ServeConfig(
                        max_seq_len=64, max_batch=3, decode_chunk=4, **kw),
                        projections=fmp if comp else None,
                        device=m_.device)
                    rs = [Request(rid=i, prompt=p, max_new_tokens=8)
                          for i, p in enumerate(mprompts_r)]
                    e.generate(rs)
                    assert all(r.done and len(r.out_tokens) == 8 for r in rs)
                    if e.pool is not None:
                        assert e.pool.free_count == e.pool.n_pages
                    out.append([r.out_tokens for r in rs])
                assert out[0] == out[1], (arch, kind, out)
                fam[f"{arch} {kind}"] = sum(len(t) for t in out[1])
            if arch == "deepseek-v2-lite-16b":
                # one float32 train step (MLA under K6 and its plain
                # backward, the MoE router's aux losses in the loss):
                # loss and gradients card = CPU
                ttc = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                                  total_steps=10, checkpoint_every=0)
                tb = {k: np.random.default_rng(9).integers(
                    0, fcfg.vocab_size, (2, 32)).astype(np.int32)
                    for k in ("tokens", "labels")}
                mets, grads = [], []
                for m_, p_ in ((fcpu, fp_cpu), (fgpu, fp_gpu)):
                    met, g_ = value_and_grad(make_loss_fn(m_, ttc), p_, tb)
                    mets.append({k: float(v) for k, v in met.items()})
                    grads.append(tree_to(g_, "cpu"))
                for k in ("loss", "moe_lb", "moe_rz", "moe_dropped"):
                    np.testing.assert_allclose(mets[1][k], mets[0][k],
                                               rtol=1e-5, atol=1e-6)
                mg_worst = 0.0
                for (path, a_), (_, b_) in zip(tree_leaves(grads[1]),
                                               tree_leaves(grads[0])):
                    sc_ = float(b_.abs().max())
                    err = float((a_ - b_).abs().max())
                    assert err <= 1e-4 * sc_, (path, err, sc_)
                    mg_worst = max(mg_worst, err / max(sc_, 1e-30))
            del fcpu, fgpu, fp_cpu, fp_gpu
        print(f"reduced deepseek-v2-lite (dense slots, full and KQ-SVD) and "
              f"arctic (fp pages, int8 pages with dynamic splits): greedy "
              f"tokens identical on card and CPU ({fam}); a float32 "
              f"deepseek-v2-lite train step: loss and MoE aux losses within "
              f"1e-5, gradients within {mg_worst:.3g} of each leaf's "
              f"max-abs (tol 1e-4)")

        # the hybrid and the stubs, reduced, float32, KQ-SVD calibrated on
        # the stub frontend's batches: a prefill from each arch's input
        # (jamba's tokens, musicgen's frame embeddings, phi-3-vision's
        # patches ahead of its text) and 4 token decode steps after it,
        # logits card = CPU within 2e-4; jamba's dense-slot engine and
        # musicgen's paged chunked engine, greedy tokens card = CPU
        hyb = {}
        for arch, kw in (("jamba-1.5-large-398b", {}),
                         ("musicgen-large", chunked),
                         ("phi-3-vision-4.2b", None)):
            fcfg = get_config(arch).reduced()
            fcpu, fgpu = build_model(fcfg, "cpu"), build_model(fcfg, dev)
            fp_cpu = fcpu.init(torch.Generator().manual_seed(0))
            fp_gpu = tree_to(fp_cpu, dev)
            fmp = calibrate_model(
                fcpu, fp_cpu, [stub_batch(fcfg, 4, 32, seed=i)
                               for i in range(2)],
                CompressionConfig(method="kqsvd", epsilon=0.1))
            b5 = stub_batch(fcfg, 2, 16, seed=20)
            P5 = fcfg.num_patch_tokens
            t5 = np.random.default_rng(21).integers(0, fcfg.vocab_size,
                                                    (2, 4))
            zero_counts()
            outs = []
            for m_, p_ in ((fcpu, fp_cpu), (fgpu, fp_gpu)):
                rproj = m_.projections_pytree(fmp)
                lg, c5 = m_.prefill(p_, b5, P5 + 24, proj=rproj)
                seq = [lg]
                for i in range(4):
                    lg, c5 = m_.decode_step(p_, c5, t5[:, i:i + 1],
                                            P5 + 16 + i, proj=rproj)
                    seq.append(lg)
                outs.append([x.cpu() for x in seq])
            assert flash_attention.launches == len(fcpu.attn_layers)
            assert kq_decode_attention.launches == 4 * len(fcpu.attn_layers)
            assert ssd_chunk_scan.launches == fcfg.layer_kinds().count("ssm")
            worst5 = 0.0
            for a, b in zip(*outs):
                worst5 = max(worst5, float((a - b).abs().max()))
                np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4,
                                           atol=2e-4)
            hyb[arch] = f"logits within {worst5:.3g}"
            if kw is None:
                continue
            out = []
            for m_, p_ in ((fcpu, fp_cpu), (fgpu, fp_gpu)):
                e = ServingEngine(fcfg, p_, ServeConfig(
                    max_seq_len=64, max_batch=3, decode_chunk=4, **kw),
                    projections=fmp, device=m_.device)
                rs = [Request(rid=i, prompt=p, max_new_tokens=8)
                      for i, p in enumerate(mprompts_r)]
                e.generate(rs)
                assert all(r.done and len(r.out_tokens) == 8 for r in rs)
                if e.pool is not None:
                    assert e.pool.free_count == e.pool.n_pages
                out.append([r.out_tokens for r in rs])
            assert out[0] == out[1], (arch, out)
            hyb[arch] += (f", {'paged chunked' if kw else 'dense'} engine "
                          f"tokens equal ({sum(len(t) for t in out[1])})")
            del fcpu, fgpu, fp_cpu, fp_gpu
        print(f"reduced jamba, musicgen and phi-3-vision (float32, KQ-SVD "
              f"on stub batches) card = CPU: " + "; ".join(
                  f"{k}: {v}" for k, v in hyb.items()))

        # at the full configs' expert counts and top-k, narrow widths:
        # moe_ffn's keep mask and outputs in decode mode (8 slots, two of
        # them dead) on the card equal the CPU's, where capacity binds
        from repro_torch.config import MoEConfig
        from repro_torch.models import moe as moe_mod
        for label, mo in (("deepseek-v2-lite E 64 top 6", MoEConfig(
                n_experts=64, top_k=6, expert_ff=32, n_shared_experts=2)),
                          ("arctic E 128 top 2", MoEConfig(
                              n_experts=128, top_k=2, expert_ff=32,
                              dense_residual=True, dense_residual_ff=32))):
            mp_cpu = moe_mod.init_moe(torch.Generator().manual_seed(3), 64,
                                      mo, torch.float32, "cpu")
            mp_gpu = tree_to(mp_cpu, dev)
            g5 = torch.Generator().manual_seed(4)
            xm = (torch.randn(64, generator=g5)
                  + 0.3 * torch.randn(8, 1, 64, generator=g5))
            live = torch.ones(8, 1, dtype=torch.bool)
            live[[2, 5]] = False
            res = []
            for p_, dv_ in ((mp_cpu, "cpu"), (mp_gpu, dev)):
                x_ = xm.to(dv_)
                y_, aux_ = moe_mod.moe_ffn(p_, x_, mo, "decode",
                                           token_mask=live.to(dv_))
                keep_ = moe_mod.route(p_, x_, mo, "decode",
                                      token_mask=live.to(dv_))["keep"]
                res.append((y_.cpu(), keep_.cpu(),
                            float(aux_["dropped_frac"])))
            (yc, kc, dc), (yg, kg, dg) = res
            assert torch.equal(kc, kg), f"{label}: keep masks differ"
            np.testing.assert_allclose(yg.numpy(), yc.numpy(), rtol=1e-5,
                                       atol=1e-5)
            assert dc == dg and dc > 0, (label, dc, dg)
            print(f"moe_ffn {label}, decode, 8 slots (2 dead): C = "
                  f"{moe_mod._capacity(8, mo, 'decode')}, dropped_frac "
                  f"{dg:.4f}; keep masks equal on card and CPU, outputs "
                  f"within {float((yg - yc).abs().max()):.3g} (tol 1e-5)")

    print("phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items())
        + f"; total {sum(PHASE_SECONDS.values()):.1f}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
