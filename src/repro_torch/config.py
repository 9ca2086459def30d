"""Configuration dataclasses of the PyTorch port.

The port's own copy of the reference package's model, compression and
serving configs: the same fields, defaults and validation, so one config
value means the same thing in both packages.  Every architecture is a
``ModelConfig`` produced by a module in ``repro_torch.configs``; reduced
(smoke-test) variants come from ``ModelConfig.reduced()``.

Knobs that only steer the reference's XLA/TPU lowering (``use_pallas``,
``scan_layers``, ``attn_block_*``, ``causal_block_skip``) are kept for
parity of the dataclass but do not change what the port computes: on a
CUDA device the hand-written kernels always run.  ``remat_policy`` maps
to ``torch.utils.checkpoint`` per layer in ``LM.train_logits``.  Serving
features this port does not have yet are rejected when
``repro_torch.serving.ServingEngine`` is constructed.  ``TrainConfig``'s
``fsdp`` selects ZeRO-3 placement of params and optimizer state under
``Trainer(mesh=...)`` (``params_shardings(..., fsdp=tc.fsdp)``) and routes
nothing on one device; ``grad_reduce_dtype`` routes nothing anywhere, as
in the reference, which reads it nowhere.  ``MeshConfig`` describes a
device mesh's shape and axis names, as in the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (GShard-style dispatch)."""

    n_experts: int
    top_k: int
    expert_ff: int                      # hidden dim of each expert
    n_shared_experts: int = 0           # DeepSeek-style always-on experts
    dense_residual: bool = False        # Arctic-style parallel dense FFN
    dense_residual_ff: int = 0
    every_n_layers: int = 1             # MoE layer period (Jamba: 2)
    first_k_dense: int = 0              # leading dense layers (DeepSeek-V2: 1)
    first_dense_ff: int = 0             # d_ff of those leading dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3

    def is_moe_layer(self, layer_idx: int) -> bool:
        if layer_idx < self.first_k_dense:
            return False
        return (layer_idx - self.first_k_dense) % self.every_n_layers == 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0                # 0 => direct q projection (V2-Lite)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """Jamba-style attention/Mamba interleave.

    A stack of ``period`` layers repeats; layer ``attn_offset`` within each
    period is attention, all others are Mamba.
    """

    period: int = 8
    attn_offset: int = 4


# ---------------------------------------------------------------------------
# Compression (the paper's technique)
# ---------------------------------------------------------------------------

METHODS = ("none", "ksvd", "eigen", "kqsvd")


@dataclass(frozen=True)
class CompressionConfig:
    """KV-cache low-rank compression settings (KQ-SVD & baselines)."""

    method: str = "kqsvd"               # none | ksvd | eigen | kqsvd
    epsilon: float = 0.1                # spectral-energy budget for rank pick
    rank_k: int = 0                     # 0 => select by epsilon
    rank_v: int = 0
    compress_values: bool = True        # App. B value-output path
    calib_sequences: int = 128          # paper: 128 x 2048 tokens
    calib_seq_len: int = 2048
    use_gram: bool = True               # streaming Gram calibration (ours)

    def __post_init__(self) -> None:
        if self.method not in METHODS:
            raise ValueError(f"unknown compression method {self.method!r}")


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "mla", "ssm", "hybrid", "audio", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int                         # query heads (0 for pure SSM)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                      # 0 => d_model // n_heads
    qhead_pad: int = 0                   # padded query heads (TP layout;
                                         # zero-weight heads, masked — see
                                         # models/attention.py)
    sliding_window: int = 0              # 0 => full attention
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    inputs_embeds: bool = False          # stub modality frontend (audio/vlm)
    num_patch_tokens: int = 0            # vlm: image patch tokens per example
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    compression: CompressionConfig = field(default_factory=CompressionConfig)
    # runtime knobs
    dtype: str = "bfloat16"
    cache_quant: str = "none"            # none | int8 | svdq (compressed
                                         # cache; serving/page_layouts.py)
    svdq_bits: Tuple[int, ...] = ()      # per-rank key bits for svdq,
                                         # non-increasing {8,4,2}; () =>
                                         # default_svdq_bits at the rank
    use_pallas: bool = False             # reference's TPU switch; the
                                         # port's CUDA path ignores it
    scan_layers: bool = True             # reference's lax.scan layout
    remat_policy: str = "nothing"        # nothing | dots | full
    attn_block_q: int = 512              # blockwise-attention tiles
    attn_block_k: int = 512
    causal_block_skip: bool = True       # triangular block packing (perf opt)
    source: str = ""                     # provenance tag

    # -- derived ----------------------------------------------------------
    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.qhead_pad:
            assert self.qhead_pad >= self.n_heads
            assert self.qhead_pad % max(1, self.n_kv_heads) == 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the 500k-token long-context decode shape."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window > 0
        )

    def is_attn_layer(self, layer_idx: int) -> bool:
        if self.family == "ssm":
            return False
        if self.hybrid is not None:
            return layer_idx % self.hybrid.period == self.hybrid.attn_offset
        return True

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind: 'attn' | 'mla' | 'ssm'."""
        kinds = []
        for i in range(self.n_layers):
            if not self.is_attn_layer(i):
                kinds.append("ssm")
            elif self.mla is not None:
                kinds.append("mla")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def ffn_kind(self, layer_idx: int) -> str:
        if self.moe is not None and self.moe.is_moe_layer(layer_idx):
            return "moe"
        return "dense"

    # -- parameter accounting (for 6ND roofline) --------------------------
    def param_count(self) -> int:
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        return _count_params(self, active_only=True)

    # -- reduced smoke variant --------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = {}
        n_layers = 2
        if self.hybrid is not None:
            period = 4
            kw["hybrid"] = dataclasses.replace(
                self.hybrid, period=period, attn_offset=1)
            n_layers = period * 2
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(2, self.moe.top_k),
                expert_ff=64,
                n_shared_experts=min(1, self.moe.n_shared_experts),
                dense_residual_ff=64 if self.moe.dense_residual else 0,
                first_dense_ff=64 if self.moe.first_k_dense else 0,
                first_k_dense=min(1, self.moe.first_k_dense),
                every_n_layers=self.moe.every_n_layers)
            n_layers = max(n_layers, self.moe.first_k_dense + 2
                           * self.moe.every_n_layers)
        if self.mla is not None:
            kw["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=32, q_lora_rank=0,
                qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk_size=32)
        n_heads = 0 if self.n_heads == 0 else 4
        n_kv = 0 if self.n_kv_heads == 0 else (2 if self.n_kv_heads
                                               < self.n_heads else 4)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=16 if n_heads else 0,
            qhead_pad=0,
            d_ff=128,
            vocab_size=256,
            sliding_window=16 if self.sliding_window else 0,
            num_patch_tokens=4 if self.num_patch_tokens else 0,
            dtype="float32",
            scan_layers=self.scan_layers,
            attn_block_q=8,
            attn_block_k=8,
            **kw,
        )


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    """Parameter count from the config (embedding + blocks + head)."""
    D = cfg.d_model
    total = cfg.vocab_size * D                      # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * D                 # lm head
    for i in range(cfg.n_layers):
        total += 2 * D                              # two RMSNorm gains
        kind = cfg.layer_kinds()[i]
        if kind == "attn":
            dh = cfg.d_head
            total += D * cfg.n_heads * dh           # Wq
            total += 2 * D * cfg.n_kv_heads * dh    # Wk, Wv
            total += cfg.n_heads * dh * D           # Wo
        elif kind == "mla":
            m = cfg.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            total += D * cfg.n_heads * qk           # Wq (direct)
            total += D * (m.kv_lora_rank + m.qk_rope_dim)   # down proj
            total += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim
                                                     + m.v_head_dim)
            total += cfg.n_heads * m.v_head_dim * D  # Wo
        elif kind == "ssm":
            s = cfg.ssm
            d_in = s.d_inner(D)
            nh = s.n_heads(D)
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            total += D * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
            total += conv_dim * s.d_conv            # conv1d
            total += 2 * nh                         # A_log, dt_bias
            total += d_in                           # norm gain
            total += d_in * D                       # out proj
        # ffn
        fk = cfg.ffn_kind(i)
        if fk == "dense":
            ff = cfg.d_ff
            if cfg.moe is not None and i < cfg.moe.first_k_dense:
                ff = cfg.moe.first_dense_ff or cfg.d_ff
            total += 3 * D * ff                     # SwiGLU
        else:
            mo = cfg.moe
            per_expert = 3 * D * mo.expert_ff
            n_used = mo.top_k if active_only else mo.n_experts
            total += n_used * per_expert
            total += mo.n_shared_experts * per_expert
            total += D * mo.n_experts               # router
            if mo.dense_residual:
                total += 3 * D * (mo.dense_residual_ff or cfg.d_ff)
    total += D                                      # final norm
    return total


# ---------------------------------------------------------------------------
# Mesh / run configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """A device mesh's shape and axis names (the reference's
    ``MeshConfig``); the partition rules take it where no process group
    exists (``sharding.partition.mesh_axes``)."""

    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        """The number of devices: the product of the shape."""
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes that carry batch / data parallelism."""
        return tuple(a for a in self.axis_names if a in ("pod", "data"))

    @property
    def model_axis(self) -> str:
        """The axis that carries TP and EP."""
        return "model"


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule, loss and checkpoint settings of a training
    run (the reference's ``TrainConfig``, field for field)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    optimizer: str = "adamw"            # adamw | adafactor
    adam_dtype: str = "float32"         # moment dtype ("bfloat16" to shrink)
    grad_accum: int = 1                 # microbatch steps per update
    grad_reduce_dtype: str = "bfloat16" # read nowhere, as in the reference
    z_loss: float = 1e-4
    seed: int = 0
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    fsdp: bool = True                   # ZeRO-3 placement under a mesh


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServeConfig:
    max_seq_len: int = 4096
    max_batch: int = 8
    temperature: float = 0.0
    prefill_chunk: int = 512
    decode_chunk: int = 8           # tokens per fused on-device decode scan
    eos_token: Optional[int] = None  # stop generation on this token id
    seed: int = 0
    # paged KV cache (DESIGN.md §paged-cache): fixed-size pages + a
    # per-slot block table instead of dense (max_batch, max_seq_len)
    # slots.  n_pages = 0 derives full capacity (no oversubscription);
    # smaller values oversubscribe HBM and rely on admission
    # backpressure + freed-page reuse.
    paged: bool = False
    page_size: int = 64             # tokens per page (kernel time block)
    n_pages: int = 0                # allocatable pages; 0 => derive
    # chunked prefill (DESIGN.md §prefill): admission splits prompts
    # into prefill_chunk-sized chunks, pads each to a bucket length
    # (bounding XLA compiles to len(buckets)) and writes the compressed
    # cache straight into pages, interleaved with decode iterations.
    # Requires paged=True; the exact-length dense-staging path
    # (chunked_prefill=False) stays as the parity oracle.
    chunked_prefill: bool = False
    prefill_buckets: Tuple[int, ...] = ()  # () => derive by doubling
    # prefill chunks advanced per engine step(), round-robin, at most
    # one per mid-prefill slot — bounds the latency a decode iteration
    # pays for concurrent prompt admission
    prefill_chunks_per_step: int = 1
    # global per-step token budget (DESIGN.md §scheduler, vLLM /
    # sarathi style): 0 keeps the legacy per-request scheduling.  When
    # positive, every step() builds one budget of this many tokens:
    # each decoding slot charges 1 token first, prefill chunks fill the
    # remainder (the last chunk truncates to the residual budget
    # instead of skipping the step), admission stops once occupied
    # slots reach the budget, and one prefill chunk fuses into the
    # decode dispatch (a single device call per step).  Per-step cost
    # is then bounded by max_num_batched_tokens regardless of the
    # prefill:decode mix.  Requires chunked_prefill (budget truncation
    # needs chunk-granular prefill; the exact-length and legacy chunked
    # paths stay the parity oracles).
    max_num_batched_tokens: int = 0
    # admission policy for the paged pool (DESIGN.md §preemption):
    # "reserve" (the parity oracle) admits only when a request's
    # *worst-case* page footprint fits the unreserved pool; "optimistic"
    # admits on the prompt footprint alone and preempts-and-requeues
    # LIFO victims when decode growth would exhaust the pool.
    admission: str = "reserve"          # reserve | optimistic
    # what happens to a preemption victim: "recompute" requeues it with
    # its generated tokens carried as prompt suffix, so prefill rebuilds
    # the (cheap, compressed) cache; "swap" round-trips the victim's
    # pages through a host-RAM buffer instead of recomputing
    preempt_mode: str = "recompute"     # recompute | swap
    # pool watermarks, as fractions of the pool (DESIGN.md §preemption):
    # optimistic admission stops once occupancy would cross the high
    # watermark (headroom held back for decode growth); a preemption
    # pass frees watermark_low extra slack beyond the strict deficit so
    # the very next chunk boundary does not immediately preempt again
    # (thrash guard)
    watermark_high: float = 1.0
    watermark_low: float = 0.0
    # head-of-line window: how many pending requests _admit scans for
    # one that fits before giving up this step (1 = strict FIFO)
    admit_window: int = 4
    # cross-request prefix sharing (DESIGN.md §prefix-sharing): pages
    # are refcounted and a host-side prefix index maps page-aligned
    # token chunks (hash-chained over the whole prefix) to physical
    # pages, so admission maps a cached prefix into the block table by
    # reference instead of recomputing prefill; writes into shared
    # pages copy-on-write fork them.  Requires chunked_prefill (the
    # shared/unshared boundary must be a chunk start; the exact-length
    # path always recomputes the whole prompt and stays the parity
    # oracle).
    share_prefix: bool = False
    # bound on live prefix-index entries (each pins one page until
    # reclaimed); LRU-evicted beyond this
    prefix_index_capacity: int = 512
    # -- robustness (DESIGN.md §robustness) -------------------------------
    # cross-check PagePool refcounts / free list / block tables against
    # the scheduler after every step (invariants.audit); chaos tests
    # run with this on, and decode_audit_on in BENCH_decode.json gates
    # its overhead
    audit: bool = False
    # quarantine slots whose next-token logits go non-finite (fail just
    # that request with error.kind == "numerics", keep the batch); off
    # = legacy behavior (garbage tokens propagate silently)
    guard_numerics: bool = True
    # no-progress watchdog: consecutive step()s with no new prefill
    # ground, no emitted tokens and no terminal outcomes before
    # EngineStalledError is raised (0 disables)
    stall_steps: int = 200
    # transient admission allocation failures retried with exponential
    # backoff (1, 2, 4, ... steps, capped at 32) before the request
    # fails terminally with error.kind == "pool_exhausted"
    admission_retries: int = 8
    # a swap-in that fails (or fails checksum verification) degrades to
    # recomputing the victim's cache from its effective prompt; False =
    # fail the request terminally with error.kind == "swap_failed"
    swap_fallback: bool = True
    # run the invariants.audit pass every Nth step() (1 = every step,
    # the parity default).  The audit walks every page/slot structure,
    # so its cost scales with pool size; sampling keeps chaos-leg
    # coverage while bounding per-step overhead.  Only meaningful with
    # audit=True.
    audit_every: int = 1
    # chaos mode: build FaultInjector.chaos(chaos_seed, chaos_rate) at
    # every start() — all recoverable fault points armed with an
    # unlimited per-hit Bernoulli at chaos_rate.  None = no injection.
    # An injector passed to the engine constructor wins over this.
    chaos_seed: Optional[int] = None
    chaos_rate: float = 0.05
    # split-KV flash-decoding fan-out for the paged decode attention
    # read (DESIGN.md §split-kv): 1 = the unsplit kernel (parity
    # oracle); >1 cuts each slot's KV range into that many spans with
    # a log-sum-exp combine; 0 = dynamic — the engine re-derives the
    # count *per step* from the live maximum sequence length
    # (kernels.kq_decode.default_decode_splits), snapped down to
    # {1, 2, 4, 8} so the decode dispatch compiles at most four split
    # variants.  Requires paged=True.
    decode_splits: int = 1
    # data-axis shards for the serving engine (DESIGN.md
    # §sharded-engine): 1 runs the single-device engine untouched (the
    # bitwise parity oracle); >1 partitions the slot axis into that
    # many contiguous shards, each owning its own page pool, block
    # tables, prefix index and sampling key on its own device of a
    # ("data",) mesh, with decode/prefill dispatched as one shard_map
    # computation and a thin global router feeding per-shard
    # schedulers.  Requires paged chunked prefill on the legacy
    # scheduler (max_num_batched_tokens == 0), max_batch divisible by
    # shards, and total_pages divisible by shards.  CPU CI forces
    # devices via XLA_FLAGS=--xla_force_host_platform_device_count=N.
    shards: int = 1
    # page byte format (DESIGN.md §page-layouts): "none" keeps fp pages
    # (serving/page_layouts.FpLayout, the bitwise parity oracle);
    # "int8" stores int8 data pages plus per-token bf16 scale pools;
    # "svdq" adds per-rank bit allocation on the key side (8/4/2 bits
    # packed into one uint8 stride).  Quantized layouts require
    # paged=True and compression projections; "svdq" additionally
    # requires chunked_prefill=True (the exact-length dense staging
    # path has no packed-page writer).
    cache_quant: str = "none"

    def __post_init__(self) -> None:
        if self.admission not in ("reserve", "optimistic"):
            raise ValueError(f"unknown admission policy {self.admission!r}")
        if self.preempt_mode not in ("recompute", "swap"):
            raise ValueError(f"unknown preempt_mode {self.preempt_mode!r}")
        if self.admission == "optimistic" and not self.paged:
            raise ValueError(
                "optimistic admission preempts pages and requires "
                "paged=True (the dense layout has no pool to run dry)")
        if not 0.0 < self.watermark_high <= 1.0:
            raise ValueError("watermark_high must be in (0, 1]")
        if not 0.0 <= self.watermark_low < 1.0:
            raise ValueError("watermark_low must be in [0, 1)")
        if self.admit_window < 1:
            raise ValueError("admit_window must be at least 1")
        if self.stall_steps < 0:
            raise ValueError("stall_steps must be >= 0 (0 disables)")
        if self.admission_retries < 0:
            raise ValueError("admission_retries must be >= 0")
        if not 0.0 <= self.chaos_rate <= 1.0:
            raise ValueError("chaos_rate must be in [0, 1]")
        if self.share_prefix:
            if not self.chunked_prefill:
                raise ValueError(
                    "share_prefix maps cached prefix pages into the "
                    "block table and prefills only the unshared tail, "
                    "which needs chunked_prefill=True (the exact-length "
                    "path recomputes whole prompts and stays the parity "
                    "oracle)")
            if self.prefix_index_capacity < 1:
                raise ValueError("prefix_index_capacity must be positive")
        if self.paged:
            if self.page_size <= 0:
                raise ValueError("page_size must be positive")
            if self.max_seq_len % self.page_size:
                raise ValueError(
                    f"max_seq_len {self.max_seq_len} must be a multiple of"
                    f" page_size {self.page_size}")
        if self.chunked_prefill:
            if not self.paged:
                raise ValueError(
                    "chunked_prefill writes straight into pages and "
                    "requires paged=True (the dense exact-length path is "
                    "the parity oracle)")
            if self.prefill_chunk <= 0:
                raise ValueError("prefill_chunk must be positive")
            if self.prefill_chunks_per_step <= 0:
                raise ValueError("prefill_chunks_per_step must be positive")
            b = self.buckets
            if b[-1] != self.prefill_chunk:
                raise ValueError(
                    f"largest prefill bucket {b[-1]} must equal "
                    f"prefill_chunk {self.prefill_chunk} (full chunks "
                    f"compile at that shape)")
            if b[0] <= 0:
                raise ValueError("prefill buckets must be positive")
        if self.max_num_batched_tokens < 0:
            raise ValueError(
                "max_num_batched_tokens must be >= 0 (0 disables the "
                "token-budget scheduler)")
        if self.max_num_batched_tokens and not self.chunked_prefill:
            raise ValueError(
                "max_num_batched_tokens schedules prefill at chunk "
                "granularity (truncating the last chunk to the residual "
                "budget) and requires chunked_prefill=True")
        if self.audit_every < 1:
            raise ValueError(
                "audit_every must be >= 1 (1 audits every step)")
        if self.decode_splits < 0:
            raise ValueError(
                "decode_splits must be >= 0 (0 derives the heuristic, "
                "1 is the unsplit kernel)")
        if self.decode_splits != 1 and not self.paged:
            raise ValueError(
                "decode_splits splits the paged decode kernel's page "
                "chain and requires paged=True (the dense path has no "
                "page chain to split)")
        if self.cache_quant not in ("none", "int8", "svdq"):
            raise ValueError(
                f"unknown cache_quant {self.cache_quant!r} "
                f"(none | int8 | svdq)")
        if self.cache_quant != "none" and not self.paged:
            raise ValueError(
                "cache_quant selects a paged page layout "
                "(DESIGN.md §page-layouts) and requires paged=True; "
                "dense int8 is selected on the ModelConfig instead")
        if self.cache_quant == "svdq" and not self.chunked_prefill:
            raise ValueError(
                "cache_quant='svdq' packs sub-byte ranks at page-write "
                "time and requires chunked_prefill=True (the "
                "exact-length dense staging path has no packed-page "
                "writer)")
        if self.shards < 1:
            raise ValueError("shards must be >= 1 (1 = unsharded oracle)")
        if self.shards > 1:
            if not (self.paged and self.chunked_prefill):
                raise ValueError(
                    "shards > 1 partitions the paged slot/page axes over "
                    "a data mesh and requires paged=True and "
                    "chunked_prefill=True (the dense and exact-length "
                    "paths stay single-device parity oracles)")
            if self.max_num_batched_tokens:
                raise ValueError(
                    "shards > 1 runs the legacy per-request scheduler "
                    "per shard; the token-budget scheduler "
                    "(max_num_batched_tokens > 0) is not sharded yet — "
                    "see ROADMAP.md")
            if self.max_batch % self.shards:
                raise ValueError(
                    f"max_batch {self.max_batch} must be divisible by "
                    f"shards {self.shards} (each shard owns an equal "
                    f"contiguous slice of the slot axis)")
            if self.total_pages % self.shards:
                raise ValueError(
                    f"total_pages {self.total_pages} must be divisible "
                    f"by shards {self.shards} (each shard owns an equal "
                    f"device-local page pool)")

    @property
    def buckets(self) -> Tuple[int, ...]:
        """Padded chunk lengths, ascending.  Every prefill chunk is
        padded up to the smallest bucket that holds it, so the engine
        compiles at most ``len(buckets)`` prefill shapes regardless of
        the prompt-length distribution."""
        if self.prefill_buckets:
            return tuple(sorted(set(self.prefill_buckets)))
        out, b = [], self.prefill_chunk
        while b >= 8:
            out.append(b)
            b //= 2
        if not out:                       # tiny prefill_chunk: one bucket
            out = [self.prefill_chunk]
        return tuple(sorted(out))

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding an ``n``-token chunk.

        A chunk longer than the largest bucket would silently trace a
        fresh XLA shape and break the ``len(buckets)`` compile bound,
        so out-of-range lengths raise instead of clamping."""
        if not 0 < n <= self.prefill_chunk:
            raise ValueError(
                f"chunk length {n} outside (0, {self.prefill_chunk}]: "
                f"chunks beyond the largest bucket would trace a new "
                f"prefill shape past the len(buckets) compile bound")
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    @property
    def pages_per_seq(self) -> int:
        """Block-table width: logical pages spanning max_seq_len."""
        return self.max_seq_len // self.page_size

    @property
    def total_pages(self) -> int:
        """Allocatable pages in the pool (excludes the garbage page)."""
        return self.n_pages or self.max_batch * self.pages_per_seq


# ---------------------------------------------------------------------------
# Shapes of the (arch x shape) grid, for the roofline arithmetic
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    """One cell of the assigned (arch x shape) grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                            # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs, and why not if it doesn't."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skip: long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (see DESIGN.md)")
    return True, ""
