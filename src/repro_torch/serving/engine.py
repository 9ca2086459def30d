"""Continuous-batching serving engine over dense slots or the paged store.

Torch counterpart of ``repro.serving.engine`` for one CUDA device, on
two cache layouts:

* **dense slots** (``ServeConfig.paged=False``): the batched cache is
  allocated once, one ``max_seq_len`` lane per slot; each admitted
  request is prefilled alone at its exact prompt length and copied into
  its slot;
* **paged** (``paged=True``): every layer's cache is a pool of
  ``page_size``-token pages and one block table maps each slot's logical
  pages to physical ones (``serving.paged_cache``).  Pages are allocated
  for the prompt at admission and grown before each decode chunk, and
  freed when the request ends.  The prompt goes in either at its exact
  length (dense staging repaged into the pool) or, with
  ``chunked_prefill``, in ``prefill_chunk``-token chunks padded to a
  bucket and written straight into the pages, ``prefill_chunks_per_step``
  chunks per step round-robin over the slots, while the other slots
  decode.

Two paged admission policies (``ServeConfig.admission``), as in the
reference:

* **reserve** (the parity oracle): a request is admitted only when its
  worst case (prompt + ``max_new_tokens``, capped at ``max_seq_len``)
  fits what the pool has left after every admitted slot's own
  outstanding growth, so no allocation can fail mid-serve;
* **optimistic**: admission charges only the pages the prompt occupies
  now, under the pool's high watermark.  When a decode chunk's growth
  would run the pool dry, victims are preempted, lowest
  ``Request.priority`` first and youngest admission within a tier (the
  best-ranked slot never), until ``watermark_low`` slack is free too;
  they requeue at the head of the pending queue and either *recompute*
  their cache from their prompt plus the tokens they generated
  (``preempt_mode="recompute"``) or *swap* it: their pages go to host
  memory with a crc32 (``serving.faults.checksum``) and come back byte
  for byte through a fresh block-table row, verified first.

In either policy a request whose worst case exceeds the whole pool fails
with ``oversize``, and admission scans an ``admit_window`` of the pending
queue so a small request is not blocked behind a big one.

Cross-request prefix sharing (``share_prefix``, with chunked prefill):
pages are refcounted and a ``PrefixIndex`` maps chained digests of
page-aligned token chunks to the pages that hold their cache entries.
Admission maps the longest cached prefix into the slot's block table by
reference, charging only the private tail, and prefill starts past it;
an exact-duplicate prompt whose terminal logits are stored skips prefill
altogether; chunks a sibling indexes after admission are matched late,
at the chunk boundary.  A write into a page still shared (a decode chunk
or a prefill chunk starting mid-page) copy-on-write forks it first, over
every leaf of every layer.  A finished request's pages stay pinned by the
index until reclaimed, least recently used first, under pool pressure,
before anyone is preempted.

``step()`` admits pending requests into free slots, advances chunked
prefills, runs one fused decode chunk over the slots that are fully
prefilled, harvests finished ones and refills the freed slots in the
same step.  A decode chunk is ``decode_chunk`` iterations of sampling,
EOS / ``max_new_tokens`` / truncation masking and per-slot positions, all
on the device; the host syncs once per chunk, when it reads back the
sampled tokens, the masks and a finiteness flag per slot, and knows from
the same read-back how many of the chunk's iterations can still have a
live slot, running the model only for those (the reference's
``lax.cond`` skip, decided without a sync).  In the paged layout the
block-table rows of slots outside the chunk (free, mid-prefill) go to
the device as the garbage page, so their masked writes cannot touch a
page a prefill is filling; the table is uploaded only when it changed.
With KQ-SVD projections the decode attention runs in K3 over dense slots
and in K1 over pages, and a prefill chunk's attention in K2.

Every decode step passes the slots still active as its token mask and a
prefill chunk its count of real tokens, so MoE routing gives no expert
capacity to a finished or empty slot or to a chunk's padding.  An MLA
stack (its (B, T, R) latent caches) serves on dense slots only, and so
does an SSM or hybrid stack, whose slots hold each SSM layer's state
beside the attention layers' caches.  Prompts are tokens: the audio and
VLM stubs serve them through their token embeddings, as in the
reference.

``decode_splits`` > 1 splits each slot's page chain across blocks in the
paged decode (split-KV: K4, and K5 over int8 pages); 0 derives the split
count for each decode chunk from the live slots' deepest host position,
snapped to {1, 2, 4, 8}, with no device read.  ``cache_quant`` selects
the page layout of the compressed pages (``serving.page_layouts``): int8
pages with bf16 scale pools (decode in K5) or SVDq (plain decode, as in
the reference).  Narrower pages hold more tokens in the same memory:
``n_pages`` counts fp-page units, and the pool, its watermarks and the
worst-case reservation are sized from ``int(total_pages * capacity_x)``
physical pages.  ``ModelConfig.cache_quant = "int8"`` without pages is
the dense int8 cache.

Token-budget scheduling (``ServeConfig.max_num_batched_tokens > 0``), as
in the reference: every ``step()`` spends one token budget, decode charges
first (one token per decoding slot), then admission while occupied slots
stay within the budget, then prefill chunks round-robin into the residual,
the last one truncated to it.  One staged chunk fuses with the decode
chunk: its K2 launches, then the decode chunk's K1 / K5 launches, on one
stream with no host sync between them; the step's one sync is the decode
chunk's read-back.  A slot whose prompt completes between the step's
live-mask snapshot and its decode chunk is armed after the chunk (its
logits queued on the device), so it joins decode the next step.

Failure semantics follow the reference: a request fails with a
structured ``RequestError`` (oversize, deadlines, ``cancel``, non-finite
logits, ``pool_exhausted`` once ``admission_retries`` backed-off retries
of a failed admission allocation are spent, ``swap_failed`` when a swap
fails and ``swap_fallback`` is off) and the rest of the batch keeps
serving; a ``stall_steps`` watchdog raises ``EngineStalledError`` instead
of spinning (re-prefilling after a preemption is not progress).  A
``FaultInjector`` (``faults=``, or ``ServeConfig.chaos_seed``) forces the
rare paths at the reference's eight fault points, and
``ServeConfig.audit`` runs ``invariants.audit`` every ``audit_every``-th
step.

Data-axis sharding (``ServeConfig.shards > 1``, as in the reference):
constructing a ``ServingEngine`` builds a ``ShardedServingEngine``, which
cuts the slot axis and the page pool into ``shards`` equal slices, each
served by a ``_ShardWorker``: a whole ``ServingEngine`` over its slots,
with its own pool, block tables, prefix index, swap store, faults and
tensors on its own device (``devices=``, default
``sharding.partition.serve_devices``).  A thin router sends each pending
request, in queue order, to the shard ``pick_shard`` picks; each step
then runs one prefill round per staged chunk and one decode chunk per
shard, launched one shard after another from this thread with no sync
between them, and syncs once per shard for the harvest.  Greedy decoding
does not depend on the batch a slot shares, so ``shards = N`` gives the
``shards = 1`` tokens.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, ServeConfig
from repro_torch.core.calibration import ModelProjections
from repro_torch.core.compressed import cache_footprint
from repro_torch.device import (DeviceLike, device_context, resolve_device,
                                to_device, tree_to)
from repro_torch.kernels.kq_decode.ops import default_decode_splits
from repro_torch.models.model import build_model
from repro_torch.serving import invariants
from repro_torch.serving.faults import FaultInjector, SwapFailed, checksum
from repro_torch.serving.page_layouts import FpLayout, get_layout
from repro_torch.serving.paged_cache import (BlockTables, PagePool,
                                             PagePoolExhausted, PrefixIndex,
                                             copy_page, pages_needed,
                                             swap_in, swap_out)
from repro_torch.sharding.partition import serve_devices, slot_slices

# the structured failure taxonomy: every terminal non-success outcome of
# a request is exactly one of these
ERROR_KINDS = ("oversize", "deadline", "pool_exhausted", "swap_failed",
               "numerics", "cancelled")


@dataclasses.dataclass
class RequestError:
    """Why a request terminally failed (``Request.error``); ``kind`` is
    one of ``ERROR_KINDS``."""
    kind: str
    detail: str = ""
    step: int = -1                     # engine step of the failure

    def __post_init__(self) -> None:
        if self.kind not in ERROR_KINDS:
            raise ValueError(f"unknown error kind {self.kind!r} "
                             f"(known: {ERROR_KINDS})")


class EngineStalledError(RuntimeError):
    """``step()`` made no scheduling progress for ``stall_steps``
    consecutive iterations; carries a scheduler-state dump."""

    def __init__(self, n_steps: int, dump: str):
        self.n_steps = n_steps
        self.dump = dump
        super().__init__(
            f"engine made no scheduling progress for {n_steps} "
            f"consecutive steps (no new tokens, no completions)\n{dump}")


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request, mutated in place as it is served:
    ``out_tokens`` accumulates generated ids; afterwards ``done`` holds
    (optionally ``truncated``), or ``failed`` with ``error`` set."""
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    priority: int = 0                  # preemption evicts lower tiers first
    deadline_steps: Optional[int] = None
    ttft_deadline_steps: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False            # hit max_seq_len before max_new_tokens
    error: Optional[RequestError] = None

    @property
    def failed(self) -> bool:
        """Terminal failure of any kind (``error`` holds the cause)."""
        return self.error is not None


def sample_token(logits: torch.Tensor, temperature: float,
                 gen: Optional[torch.Generator]) -> torch.Tensor:
    """Next-token ids (B,) from (B, V) logits: greedy argmax at
    ``temperature <= 0``, else a temperature-scaled categorical draw from
    ``gen``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


class ServingEngine:
    """Continuous-batching serving engine over dense slots or pages (see
    the module docstring).

    ``start(requests)`` allocates the cache and slot state, ``step()``
    advances one scheduling iteration, ``generate`` is the
    start-and-drain loop and ``cancel(rid)`` unwinds one request.
    Counters: ``n_completed``, ``n_failed``, ``error_counts``,
    ``n_decode_steps`` (model decode steps run), ``n_prefill_tokens``,
    ``n_prefill_chunks`` and ``prefill_chunk_shapes`` (the buckets
    chunks ran at, over the engine's life), the paged ``pool`` and
    ``peak_used_pages``, the wall seconds spent in prefill
    (``prefill_seconds``, which ends each admission or prefill pass with
    a device sync) and in decode chunks (``decode_seconds``); preemption's
    ``n_preempted``, ``preempted_rids``, ``n_swapped_out``,
    ``n_swapped_in``, ``n_swap_fallbacks`` and ``n_retried``; sharing's
    ``n_shared_pages``, ``n_shared_tokens``, ``n_full_hits``,
    ``n_cow_forks`` and ``n_reclaimed``; the audits run, ``n_audits``;
    the token budget's ``budget_log`` (one entry a step), ``n_fused_steps``
    and ``n_truncated_chunks``.  Under the token budget a step with a
    decode chunk syncs only at its read-back: its chunk dispatches count
    in ``prefill_seconds`` as host time, and the fused chunk's device time
    in ``decode_seconds``.

    ``faults``: a ``FaultInjector`` kept across drains (the caller owns
    its schedule); without one, ``ServeConfig.chaos_seed`` builds
    ``FaultInjector.chaos(chaos_seed, chaos_rate)`` afresh at every
    ``start()``, so each drain reproduces from the config."""

    def __new__(cls, cfg=None, params=None, sc=None, *args, **kwargs):
        """Route construction to the sharded engine when the config asks
        for more than one shard; ``shards == 1``, and any subclass, takes
        the ordinary path, so no sharded class is ever built then."""
        sc = kwargs.get("sc", sc)
        if cls is ServingEngine and sc is not None and sc.shards > 1:
            return super().__new__(ShardedServingEngine)
        return super().__new__(cls)

    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig,
                 projections: Optional[ModelProjections] = None,
                 device: DeviceLike = None,
                 faults: Optional[FaultInjector] = None):
        # the serve config owns the paged page layout: folded into the
        # model config so prefill, chunks and decode resolve the same
        # one; a full cache (no projections) has no compressed entries
        # to quantize and keeps fp pages
        if sc.cache_quant != "none" and projections is not None:
            cfg = dataclasses.replace(cfg, cache_quant=sc.cache_quant)
        self.cfg = cfg
        self.sc = sc
        self.model = build_model(cfg, device)
        self.device = self.model.device
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.params = params
        self.proj = (self._projection_tree(projections)
                     if projections is not None else None)
        self.ranks = ((projections.rank_k, projections.rank_v)
                      if projections is not None else (0, 0))
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(sc.seed)
        # physical pages per fp page of memory under the page layout
        self.capacity_x = self._capacity_multiplier()
        if sc.paged:
            self._validate_paged()
        # split-KV: a fixed count, or 0 for one derived per decode chunk
        self._dynamic_splits = sc.paged and sc.decode_splits == 0
        self._decode_splits = sc.decode_splits if sc.paged else 1
        self.prefill_chunk_shapes: set = set()
        self._faults_arg = faults
        self.faults: Optional[FaultInjector] = None
        self._started = False

    def _projection_tree(self, projections: ModelProjections):
        """The runtime projections on the engine's device."""
        return self.model.projections_pytree(projections)

    def _capacity_multiplier(self) -> float:
        """Physical pages per fp page of memory under the page layout:
        fp token bytes over the layout's at the engine's ranks; 1.0 for
        fp pages or without projections."""
        if not self.sc.paged or self.ranks[0] == 0 \
                or self.sc.cache_quant == "none":
            return 1.0
        layout, fp = get_layout(self.cfg), FpLayout()
        rk, rv = self.ranks
        return ((fp.token_bytes("k", rk) + fp.token_bytes("v", rv))
                / (layout.token_bytes("k", rk) + layout.token_bytes("v", rv)))

    def _pool_pages(self) -> int:
        """Allocatable physical pages: the fp-unit budget
        (``ServeConfig.total_pages``) times ``capacity_x``."""
        return max(1, int(self.sc.total_pages * self.capacity_x))

    def _validate_paged(self) -> None:
        """Fail at construction, not mid-serve."""
        kinds = set(self.cfg.layer_kinds())
        if kinds != {"attn"}:
            raise NotImplementedError(
                f"paged serving supports plain attention stacks only "
                f"(layer kinds: {sorted(kinds)})")
        if self.cfg.sliding_window:
            raise NotImplementedError(
                "paged serving: sliding window not supported")
        if self.cfg.cache_quant != "none" and self.sc.cache_quant == "none":
            raise NotImplementedError(
                "paged serving selects its page layout via "
                "ServeConfig.cache_quant (DESIGN.md §page-layouts); "
                "ModelConfig.cache_quant alone configures the *dense* "
                "int8 cache only")

    def _splits_for_step(self, live_max: int) -> int:
        """Split count for one decode chunk: the fixed ``decode_splits``,
        or (``decode_splits == 0``) the heuristic at the live maximum
        length snapped down to {1, 2, 4, 8}."""
        if not self._dynamic_splits:
            return self._decode_splits
        raw = default_decode_splits(
            max(1, min(live_max, self.sc.max_seq_len)), self.sc.page_size)
        return next(s for s in (8, 4, 2, 1) if raw >= s)

    def _live_splits(self, live: np.ndarray) -> int:
        """Split count for the chunk about to run: the live slots'
        deepest host position plus the chunk's growth is the most cache
        it can touch (no device read)."""
        if not self._dynamic_splits:
            return self._decode_splits
        live_max = int(self._pos[live].max()) if live.any() else 1
        return self._splits_for_step(live_max + self.sc.decode_chunk)

    # -- capacity accounting --------------------------------------------------

    def capacity_gain(self) -> float:
        """How many x more sequences fit in the same cache memory."""
        if self.ranks[0] == 0:
            return 1.0
        fp = cache_footprint(self.cfg.n_kv_heads, self.cfg.d_head,
                             *self.ranks)
        return 1.0 / fp.ratio

    # -- serving ------------------------------------------------------------

    def start(self, requests: List[Request]) -> None:
        """Allocate the (dense or paged) cache and per-slot state for
        ``requests``; ``step()`` then serves them."""
        sc = self.sc
        B, T = sc.max_batch, sc.max_seq_len
        # the token budget fails an overlong prompt at admission instead
        # (kind oversize): one request cannot abort the batch
        if not sc.max_num_batched_tokens:
            for r in requests:
                if len(r.prompt) > T:
                    raise ValueError(
                        f"request {r.rid}: prompt length {len(r.prompt)} "
                        f"exceeds max_seq_len {T}")
        self._pending: List[Request] = list(requests)
        self._all_requests: List[Request] = list(requests)
        if self._faults_arg is not None:
            self.faults = self._faults_arg
        elif sc.chaos_seed is not None:
            self.faults = FaultInjector.chaos(sc.chaos_seed, sc.chaos_rate)
        else:
            self.faults = None
        # paged bookkeeping per slot: the logical pages it may ever hold
        # (its worst case, the growth cap), the pages it may newly
        # allocate (its private tail: a shared prefix page exists once and
        # is charged to nobody) and the pages it holds privately
        self._reserved = [0] * B
        self._charged = [0] * B
        self._private = [0] * B
        self.pool: Optional[PagePool] = None
        self._btabs: Optional[BlockTables] = None
        self._pindex: Optional[PrefixIndex] = None
        if sc.paged:
            # sized in physical pages: the fp-unit budget times the page
            # layout's capacity multiplier
            n_phys = self._pool_pages()
            self.pool = PagePool(n_phys, sc.watermark_high, sc.watermark_low)
            self.pool.faults = self.faults
            self._btabs = BlockTables(B, sc.pages_per_seq, self.device)
            self._cache = self.model.init_paged_cache(
                n_phys + 1, sc.page_size, self.ranks)
            if sc.share_prefix:
                # reset with the pool: its entries pin pool pages
                self._pindex = PrefixIndex(sc.prefix_index_capacity)
        else:
            self._cache = self.model.init_cache(B, T, self.ranks)
        # preemption: each slot's admission stamp (the youngest goes first
        # within a priority tier) and the swapped-out requests' host
        # buffers, crc and next-token logits, keyed by id(request)
        self._stamp = [0] * B
        self._admit_seq = 0
        self._swapped: Dict[int, dict] = {}
        # id(request) -> (failed admission allocations, step of the next
        # try); id(request) -> prefill high watermark, since re-prefilling
        # after a preemption is thrash, not progress, for the watchdog
        self._retry: Dict[int, tuple] = {}
        self._pf_best: Dict[int, int] = {}
        # prefix sharing per slot: the chain digest at token _indexed_upto
        # (its pages up to there are in the index), and its prompt's
        # next-token logits, on the device, indexed when it finishes
        self._chain_key = [PrefixIndex.ROOT] * B
        self._indexed_upto = [0] * B
        self._prompt_logits: List[Optional[torch.Tensor]] = [None] * B
        self.n_prefill_chunks = 0
        self.peak_used_pages = 0
        # chunked prefill: prompt tokens already written per slot (None =
        # slot empty or fully prefilled), and the round-robin cursor
        self._prefilled: List[Optional[int]] = [None] * B
        self._pf_next = 0
        self._step_count = 0
        self._no_progress = 0
        self._progress = False
        self.n_completed = 0
        self.n_failed = 0
        self.error_counts: Dict[str, int] = {k: 0 for k in ERROR_KINDS}
        self.n_decode_steps = 0
        self.n_prefill_tokens = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.n_preempted = 0
        self.preempted_rids: List[int] = []
        self.n_swapped_out = 0
        self.n_swapped_in = 0
        self.n_swap_fallbacks = 0
        self.n_retried = 0
        self.n_shared_pages = 0
        self.n_shared_tokens = 0
        self.n_full_hits = 0
        self.n_cow_forks = 0
        self.n_reclaimed = 0
        self.n_audits = 0
        self.budget_log: List[dict] = []
        self.n_fused_steps = 0
        self.n_truncated_chunks = 0
        # token budget only: while a list, _activate queues (slot,
        # request, device logits) instead of arming the slot, so a slot
        # completing after the step's live-mask snapshot is not decoded
        # through its garbage row by this step's decode chunk
        self._activation_queue: Optional[list] = None
        # per-slot decode state: host arrays between chunks, device
        # tensors inside one; next-token logits stay on the device
        self._logits = torch.zeros((B, self.cfg.vocab_size),
                                   dtype=torch.float32, device=self.device)
        self._pos = np.zeros(B, np.int64)
        self._emitted = np.zeros(B, np.int64)
        self._max_new = np.zeros(B, np.int64)
        self._done = np.ones(B, bool)
        self._trunc = np.zeros(B, bool)
        self._slot_req: List[Optional[Request]] = [None] * B
        # the prompt a slot serves: the request's, plus the tokens a
        # recompute victim generated before its preemption
        self._slot_prompt: List[Optional[np.ndarray]] = [None] * B
        self._started = True

    def _busy(self) -> bool:
        return bool(self._pending
                    or any(r is not None for r in self._slot_req))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _occupied(self) -> int:
        return sum(q is not None for q in self._slot_req)

    def _decodable(self) -> np.ndarray:
        """Slots admitted and fully prefilled; mid-prefill slots hold their
        pages and join decode when their last chunk lands."""
        return np.array([r is not None and pf is None for r, pf in
                         zip(self._slot_req, self._prefilled)])

    # -- failure semantics --------------------------------------------------

    def _fires(self, point: str) -> bool:
        """One hit at a fault point (never fires without an injector)."""
        return self.faults is not None and self.faults.fires(point)

    def _fail_request(self, r: Request, kind: str, detail: str = "") -> None:
        """Terminally fail ``r`` and unwind it from the pending queue, its
        slot or the swap store; the rest of the batch is untouched."""
        r.error = RequestError(kind=kind, detail=detail,
                               step=self._step_count)
        r.done = True
        self.n_failed += 1
        self.error_counts[kind] += 1
        self._progress = True
        self._retry.pop(id(r), None)
        self._pf_best.pop(id(r), None)
        self._swapped.pop(id(r), None)
        self._pending = [p for p in self._pending if p is not r]
        for b in range(self.sc.max_batch):
            if self._slot_req[b] is r:
                self._release(b)
                self._done[b] = True
                break

    def cancel(self, rid: int, detail: str = "cancelled by caller") -> bool:
        """Cancel request ``rid`` whether pending, prefilling, decoding or
        swapped out.  Returns whether a live request was cancelled."""
        if not self._started:
            raise RuntimeError("call start(requests) first")
        for r in self._all_requests:
            if r.rid == rid and not r.done:
                self._fail_request(r, "cancelled", detail)
                return True
        return False

    def _check_deadlines(self) -> None:
        """Fail requests whose step budget ran out (TTFT: no first token
        yet; total: not done), counted in engine steps since start()."""
        now = self._step_count
        for r in self._all_requests:
            if r.done:
                continue
            ttft = r.ttft_deadline_steps
            if ttft is not None and not r.out_tokens and now > ttft:
                self._fail_request(
                    r, "deadline",
                    f"no first token after {ttft} steps (TTFT budget)")
            elif r.deadline_steps is not None and now > r.deadline_steps:
                self._fail_request(
                    r, "deadline",
                    f"incomplete after {r.deadline_steps} steps "
                    f"({len(r.out_tokens)}/{r.max_new_tokens} tokens)")

    # -- admission ------------------------------------------------------------

    def _worst_case_pages(self, r: Request) -> int:
        """Pages the request can ever occupy (truncation caps the sequence
        at ``max_seq_len``); unchanged by a preemption, since a recompute
        victim's prompt grows by what its remaining budget shrinks."""
        sc = self.sc
        return pages_needed(min(len(r.prompt) + max(r.max_new_tokens, 0),
                                sc.max_seq_len), sc.page_size)

    @staticmethod
    def _effective_prompt(r: Request) -> np.ndarray:
        """What a (re)admission prefills: the prompt, plus the tokens
        generated before a preemption."""
        return np.concatenate([np.asarray(r.prompt, np.int32),
                               np.asarray(r.out_tokens, np.int32)])

    def _fits_now(self, r: Request, worst_private: int,
                  shared: tuple) -> bool:
        """Whether ``r`` can be admitted now.  ``worst_private`` and
        ``shared = (n_pages, n_tokens, fork, self_pinned)`` count only its
        private tail; index pins the request would take over itself
        (``self_pinned``) are not reclaimable headroom.  Reserve: the
        private worst case must fit what is left after the live pages
        (less reclaimable pins) and every admitted slot's outstanding
        growth (``charged - private``).  Optimistic: the pages the
        effective prompt needs now, plus a possible fork, must be free and
        keep the pool under its high watermark (an idle pool admits any
        request that fits)."""
        s_pages, _, s_fork, s_pin = shared
        reclaimable = (self._pindex.reclaimable(self.pool) - s_pin
                       if self._pindex is not None else 0)
        if self.sc.admission == "reserve":
            outstanding = sum(c - p for c, p in zip(self._charged,
                                                    self._private))
            headroom = (self.pool.n_pages
                        - (self.pool.used_count - reclaimable)
                        - outstanding)
            return worst_private <= headroom
        need = (pages_needed(len(r.prompt) + len(r.out_tokens),
                             self.sc.page_size) - s_pages + s_fork)
        avail = self.pool.free_count + reclaimable
        eff_used = self.pool.used_count - reclaimable
        if eff_used == 0:
            return need <= avail
        return need <= avail and eff_used + need <= self.pool.high_pages

    def _next_admissible(self) -> Optional[Request]:
        """Pop the first admissible pending request within the
        ``admit_window`` scan, so a small request is not blocked behind a
        big one whose worst case does not fit yet.  Requests backing off
        after a failed allocation are passed over until their retry step;
        requests with no tokens to generate are resolved (done) on the
        way; a request whose worst case exceeds the whole pool, or (under
        the token budget) whose prompt exceeds ``max_seq_len``, fails
        (``oversize``)."""
        sc = self.sc
        i = scanned = 0
        while i < len(self._pending) and scanned < sc.admit_window:
            r = self._pending[i]
            rt = self._retry.get(id(r))
            if rt is not None and self._step_count < rt[1]:
                i += 1
                scanned += 1
                continue
            if r.max_new_tokens - len(r.out_tokens) <= 0:
                r.done = True
                self._pending.pop(i)
                continue
            if sc.max_num_batched_tokens and len(r.prompt) > sc.max_seq_len:
                # the worst case is capped at max_seq_len, so the pool
                # check below cannot catch an overlong prompt
                self._fail_request(
                    r, "oversize", f"prompt length {len(r.prompt)} exceeds "
                    f"max_seq_len {sc.max_seq_len}")
                continue
            if sc.paged:
                worst = self._worst_case_pages(r)
                if worst > self.pool.n_pages:
                    self._fail_request(
                        r, "oversize", f"worst case {worst} pages exceeds "
                        f"the {self.pool.n_pages}-page pool")
                    continue
                shared = self._probe_share(r)
                if not self._fits_now(r, worst - shared[0] + shared[2],
                                      shared):
                    i += 1
                    scanned += 1
                    continue
            return self._pending.pop(i)
        return None

    def _admit(self, limit: Optional[int] = None) -> int:
        """Fill free slots from the pending queue; returns how many
        requests were admitted, at most ``limit`` (the token budget's cap
        on occupied slots; None = every free slot).  Paged: map the
        longest cached prefix into the block table by reference, allocate
        the private tail (on a failed allocation roll back and retry with
        backoff, or fail with ``pool_exhausted`` once
        ``admission_retries`` are spent) and charge the private worst
        case; a swap victim skips the match and has its pages restored,
        verified by checksum (a ``swap_in`` fault fails the restore).
        Chunked prefill:
        queue the slot for ``_prefill_step`` from the first unshared token
        (a whole-prompt match with stored logits activates it at once).
        Otherwise prefill the effective prompt at its exact length and
        copy its cache into the slot (dense) or its pages (paged)."""
        sc = self.sc
        t0 = time.perf_counter()
        occupied0 = self._occupied()
        ran = False
        for b in range(sc.max_batch):
            if limit is not None and self._occupied() - occupied0 >= limit:
                break
            if self._slot_req[b] is not None:
                continue
            r = self._next_admissible()
            if r is None:
                break
            prompt = self._effective_prompt(r)
            self._slot_req[b] = r
            self._slot_prompt[b] = prompt
            self._stamp[b] = self._admit_seq
            self._admit_seq += 1
            slog = None
            shared_tokens = 0
            if sc.paged:
                ps = sc.page_size
                shared: List[int] = []
                full_tokens = fork = 0
                chain = PrefixIndex.ROOT
                if self._pindex is not None and id(r) not in self._swapped:
                    hits, chain, full_tokens, slog = self._pindex.walk(
                        prompt, ps)
                    # the probe's rule, so the charge is what was checked
                    kept, shared_tokens, fork, slog = self._cap_share(
                        len(prompt), hits, slog)
                    shared = [p for _, p, _ in kept]
                    if shared:
                        self._pindex.touch([k for k, _, _ in kept])
                        self.pool.share(shared)
                self._reserved[b] = self._worst_case_pages(r)
                self._charged[b] = self._reserved[b] - len(shared) + fork
                n_priv = pages_needed(len(prompt), ps) - len(shared)
                try:
                    phys = self._alloc(n_priv)
                except PagePoolExhausted:
                    # the accounting said it fits, the pool disagrees:
                    # roll back, retry after 1, 2, 4, ... steps (at most
                    # 32), and fail once the retries are spent
                    if shared:
                        self.pool.free(shared)
                    self._slot_req[b] = self._slot_prompt[b] = None
                    self._reserved[b] = self._charged[b] = 0
                    n_tries, _ = self._retry.get(id(r), (0, 0))
                    if n_tries >= sc.admission_retries:
                        self._fail_request(
                            r, "pool_exhausted",
                            f"admission allocation failed {n_tries + 1} "
                            f"times (backoff spent)")
                        continue
                    self._retry[id(r)] = (
                        n_tries + 1,
                        self._step_count + min(1 << n_tries, 32))
                    self.n_retried += 1
                    self._pending.insert(0, r)
                    break
                self._retry.pop(id(r), None)
                self.n_shared_pages += len(shared)
                self.n_shared_tokens += shared_tokens
                self._private[b] = n_priv
                self._btabs.assign(b, shared + phys)
                self._chain_key[b] = chain
                self._indexed_upto[b] = full_tokens
                st = self._swapped.pop(id(r), None)
                if st is not None:
                    try:
                        if self._fires("swap_in"):
                            raise SwapFailed("injected swap_in fault")
                        self._swap_in_slot(b, st)
                    except SwapFailed as e:
                        if not sc.swap_fallback:
                            self._release(b)
                            self._fail_request(r, "swap_failed", str(e))
                            continue
                        # recompute: the pages just assigned cover the
                        # effective prompt, which carries the generated
                        # tokens
                        self.n_swap_fallbacks += 1
                    else:
                        self._activate(b, r, st["logits"])
                        self.n_swapped_in += 1
                        continue
            if sc.chunked_prefill:
                if slog is not None:
                    # the whole prompt and its next-token logits came from
                    # the index: no prefill chunk at all
                    self.n_full_hits += 1
                    self._activate(b, r, slog)
                else:
                    self._prefilled[b] = shared_tokens
                continue
            max_len = (len(self._btabs.slot_pages[b]) * sc.page_size
                       if sc.paged else sc.max_seq_len)
            plogits, slot_cache = self.model.prefill(
                self.params, prompt[None], max_len, proj=self.proj)
            if sc.paged:
                self._paged_insert(b, slot_cache)
            else:
                for layer, small in zip(self._cache, slot_cache):
                    for name, t in small.items():
                        layer[name][b].copy_(t[0])
            self._activate(b, r, plogits[0, -1])
            self.n_prefill_tokens += len(prompt)
            ran = True
        if ran:
            self._sync()
            self.prefill_seconds += time.perf_counter() - t0
        return self._occupied() - occupied0

    def _paged_insert(self, b: int, slot_cache) -> None:
        """Cut a prefilled one-sequence cache, leaves (1, Hkv, n*ps, R),
        into its n pages and write them at slot ``b``'s physical pages;
        the int8 cache's (1, Hkv, n*ps) scale planes go to the
        (P, Hkv, ps, 1) scale pools the same way."""
        ps = self.sc.page_size
        phys = to_device(np.asarray(self._btabs.slot_pages[b], np.int64),
                         self.device)
        for layer, small in zip(self._cache, slot_cache):
            for name, t in small.items():
                t = t[0] if t.ndim == 4 else t[0, ..., None]
                hkv, tl, r = t.shape
                layer[name][phys] = t.reshape(hkv, tl // ps, ps, r) \
                    .transpose(0, 1).to(layer[name].dtype)

    def _activate(self, b: int, r: Request, last_logits) -> None:
        """Arm slot ``b`` for decode once its prompt cache is in place.
        With sharing on, a device copy of the prompt's next-token logits
        is kept for the index (no host sync).  While the token budget's
        activation queue is open the call is deferred: a device clone of
        the logits is queued and the slot is armed after the step's
        decode chunk."""
        if self._activation_queue is not None:
            self._activation_queue.append((b, r, last_logits.clone()))
            return
        self._logits[b] = last_logits
        self._pos[b] = len(self._slot_prompt[b])
        self._emitted[b] = 0
        # a resumed victim already emitted part of its budget
        self._max_new[b] = r.max_new_tokens - len(r.out_tokens)
        self._done[b] = False
        self._trunc[b] = False
        if self._pindex is not None:
            self._prompt_logits[b] = self._logits[b].clone()

    def _release(self, b: int, finished: bool = False) -> None:
        """Free slot ``b``: a finished request first leaves its prompt's
        tail in the prefix index; its page references then drop (pages
        another slot or the index holds stay) and its row resets to the
        garbage page."""
        if finished and self._pindex is not None:
            self._index_terminal(b)
        self._slot_req[b] = None
        self._slot_prompt[b] = None
        self._prefilled[b] = None
        self._prompt_logits[b] = None
        self._chain_key[b] = PrefixIndex.ROOT
        self._indexed_upto[b] = 0
        if self.sc.paged:
            self._btabs.release(b, self.pool)
            self._reserved[b] = self._charged[b] = self._private[b] = 0

    # -- prefix sharing -------------------------------------------------------

    def _cap_share(self, L: int, hits, logits):
        """The one cap and fork rule of a prefix match, for the admission
        probe and the admission alike: the match stops at ``L - 1`` tokens
        unless stored logits serve the whole prompt, hit pages past the
        cap are dropped, and a match ending mid-page predicts the fork its
        first write needs.  Returns ``(kept, n_tokens, fork, logits)``."""
        ps = self.sc.page_size
        tokens = sum(n for _, _, n in hits)
        if tokens == L and logits is None:
            tokens = L - 1          # the last token recomputed for logits
        kept = [h for j, h in enumerate(hits) if j * ps < tokens]
        if tokens < L:
            logits = None
        fork = 1 if kept and tokens % ps else 0
        return kept, tokens, fork, logits

    def _probe_share(self, r: Request) -> tuple:
        """What admission would share for ``r``, read only:
        ``(n_pages, n_tokens, fork, self_pinned)``, ``self_pinned`` the
        matched pages only the index pins now."""
        if self._pindex is None or id(r) in self._swapped:
            return 0, 0, 0, 0
        prompt = self._effective_prompt(r)
        hits, _, _, logits = self._pindex.walk(prompt, self.sc.page_size)
        kept, tokens, fork, _ = self._cap_share(len(prompt), hits, logits)
        self_pin = sum(1 for _, p, _ in kept if self.pool.ref(p) == 1)
        return len(kept), tokens, fork, self_pin

    def _alloc(self, n: int) -> List[int]:
        """Pool allocation that first reclaims pages only the prefix index
        pins (LRU): cached prefixes are cheaper to drop than live
        sequences."""
        if n <= 0:
            return []
        if self._pindex is not None and n > self.pool.free_count:
            # a prefix_reclaim fault reclaims nothing this pass: the
            # caller's exhaustion handling (retry, preempt) takes over
            if not self._fires("prefix_reclaim"):
                self.n_reclaimed += self._pindex.reclaim(self.pool, n)
        return self.pool.alloc(n)

    def _fork_candidates(self, b: int, lo: int, hi: int) -> List[int]:
        """Logical pages of slot ``b`` that positions [lo, hi) write and
        that are still shared (refcount > 1): each must be forked first."""
        if self._pindex is None or hi <= lo:
            return []
        ps = self.sc.page_size
        rows = self._btabs.rows[b]
        last = min((hi - 1) // ps, len(self._btabs.slot_pages[b]) - 1)
        return [j for j in range(lo // ps, last + 1)
                if self.pool.ref(int(rows[j])) > 1]

    def _cow_fork(self, b: int, j: int) -> None:
        """Fork logical page ``j`` of slot ``b``: copy it into a fresh page
        in every leaf of every layer (data, int8 scale and packed pools),
        repoint the row (which drops the device export) and drop one
        reference on the original, which the other sharers keep."""
        old = int(self._btabs.rows[b, j])
        if self._fires("copy_page"):
            raise PagePoolExhausted("injected copy_page fault")
        new = self._alloc(1)[0]
        for layer in self._cache:
            for pool in layer.values():
                copy_page(pool, old, new)
        self._btabs.set_page(b, j, new)
        self.pool.free([old])
        self._private[b] += 1
        self.n_cow_forks += 1

    def _late_match(self, b: int) -> bool:
        """At a chunk boundary, map in whole-page prompt chunks a sibling
        has prefilled and indexed since this slot was admitted; the
        slot's unwritten private page for each goes back to the pool.
        Returns True when the match completed the prompt with stored
        logits (the slot is then activated and runs no chunk)."""
        if self._pindex is None:
            return False
        ps = self.sc.page_size
        prompt = self._slot_prompt[b]
        L = len(prompt)
        start = self._prefilled[b]
        while (start % ps == 0 and start == self._indexed_upto[b]
               and start + ps <= L):
            key = PrefixIndex.child_key(self._chain_key[b],
                                        prompt[start: start + ps])
            hit = self._pindex.get(key)
            if hit is None or hit[0] == int(self._btabs.rows[b, start // ps]):
                break
            page, _, logits = hit
            old = self._btabs.slot_pages[b][start // ps]
            self.pool.share([page])
            self._btabs.set_page(b, start // ps, page)
            self.pool.free([old])
            self._private[b] -= 1
            self.n_shared_pages += 1
            self.n_shared_tokens += ps
            self._chain_key[b] = key
            start += ps
            self._indexed_upto[b] = start
            if start == L:
                if logits is not None:
                    self._prefilled[b] = None
                    self.n_full_hits += 1
                    self._activate(b, self._slot_req[b], logits)
                    return True
                # no stored logits: recompute the last token (its write
                # forks the shared page)
                start -= 1
                break
        self._prefilled[b] = start
        return False

    def _index_terminal(self, b: int) -> None:
        """Leave a finished slot's prompt tail in the index before its
        references drop: the final partial-page chunk, if any, with the
        prompt's next-token logits (attached to the last full page's entry
        when the prompt ends on a page boundary)."""
        prompt = self._slot_prompt[b]
        if (self._prefilled[b] is not None or prompt is None
                or self._prompt_logits[b] is None):
            return                          # mid-prefill or never activated
        ps = self.sc.page_size
        k, rem = divmod(len(prompt), ps)
        if self._indexed_upto[b] != k * ps:
            return                          # full pages not all indexed
        if rem:
            key = PrefixIndex.child_key(self._chain_key[b], prompt[k * ps:])
            self._pindex.insert(key, int(self._btabs.rows[b, k]), rem,
                                self.pool, logits=self._prompt_logits[b])
        elif self._chain_key[b] != PrefixIndex.ROOT:
            self._pindex.attach_logits(self._chain_key[b],
                                       self._prompt_logits[b])

    # -- chunked prefill ------------------------------------------------------

    def _prep_chunk(self, b: int, cap: Optional[int] = None
                    ) -> Optional[tuple]:
        """Stage slot ``b``'s next prefill chunk on the host: late-bind
        shared chunks, size the chunk (``cap`` truncates it to the token
        budget's residual), fork any still-shared page it writes (a chunk
        may start mid-page, at the first unshared token) and pick its
        bucket.  Returns ``(b, request, start, n, bucket)``, or None when
        the slot runs no chunk: the late match completed its prompt, a
        ``prefill_delay`` fault held it back, the pool was dry at the fork
        (the slot was preempted) or no bucket holds the chunk (the request
        failed with ``oversize``)."""
        sc = self.sc
        if self._late_match(b):
            return None
        if self._fires("prefill_delay"):
            return None
        r = self._slot_req[b]
        start = self._prefilled[b]
        n = min(sc.prefill_chunk, len(self._slot_prompt[b]) - start)
        if cap is not None and n > cap:
            n = cap
            self.n_truncated_chunks += 1
        try:
            for j in self._fork_candidates(b, start, start + n):
                self._cow_fork(b, j)
        except PagePoolExhausted:
            self._preempt(b)
            return None
        try:
            bucket = sc.bucket_for(n)
        except ValueError as e:
            self._fail_request(r, "oversize", str(e))
            return None
        return b, r, start, n, bucket

    def _launch_chunk(self, prep: tuple) -> torch.Tensor:
        """Run a staged chunk, padded to its bucket, through the model: its
        tokens, position, real-token count and the slot's block-table row
        go to the device in one non-blocking copy.  Returns the logits of
        its last real token, on the device."""
        b, _, start, n, bucket = prep
        host = np.zeros(bucket + 2 + self.sc.pages_per_seq, np.int32)
        host[:n] = self._slot_prompt[b][start: start + n]
        host[bucket: bucket + 2] = start, n
        host[bucket + 2:] = self._btabs.rows[b]
        dev = to_device(host, self.device)
        logits, self._cache = self.model.prefill_chunk(
            self.params, self._cache, dev[None, :bucket],
            dev[bucket: bucket + 1], dev[bucket + 1: bucket + 2],
            proj=self.proj, block_table=dev[None, bucket + 2:])
        return logits[0, n - 1]

    def _finish_chunk(self, prep: tuple, last: torch.Tensor) -> None:
        """Host bookkeeping after a chunk's launch (standalone or fused):
        advance the slot's prefill, count watchdog progress, index the
        pages the chunk completed, and arm the slot for decode with
        ``last`` when its prompt is written."""
        b, r, start, n, bucket = prep
        prompt = self._slot_prompt[b]
        self.prefill_chunk_shapes.add(bucket)
        self.n_prefill_chunks += 1
        self.n_prefill_tokens += n
        self._prefilled[b] = start + n
        # watchdog progress is new ground only: a preempted request's
        # re-prefill is thrash
        if start + n > self._pf_best.get(id(r), 0):
            self._pf_best[id(r)] = start + n
            self._progress = True
        if self._pindex is not None:
            ps = self.sc.page_size
            while self._indexed_upto[b] + ps <= start + n:
                j = self._indexed_upto[b] // ps
                key = PrefixIndex.child_key(
                    self._chain_key[b], prompt[j * ps: (j + 1) * ps])
                self._pindex.insert(key, int(self._btabs.rows[b, j]), ps,
                                    self.pool)
                self._chain_key[b] = key
                self._indexed_upto[b] += ps
        if start + n == len(prompt):
            self._prefilled[b] = None            # complete: join decode
            self._activate(b, r, last)

    def _prefill_step(self, budget: Optional[int] = None) -> int:
        """Advance in-flight chunked prefills by up to ``budget`` (default
        ``prefill_chunks_per_step``) chunks, round-robin over the slots so
        a long prompt cannot starve another.  Returns the unspent budget,
        so the refill after the harvest shares one per-step bound."""
        sc = self.sc
        B = sc.max_batch
        if budget is None:
            budget = sc.prefill_chunks_per_step
        t0 = time.perf_counter()
        ran = False
        for off in range(B):
            if budget == 0:
                break
            b = (self._pf_next + off) % B
            if self._prefilled[b] is None:
                continue
            prep = self._prep_chunk(b)
            if prep is None:
                continue
            self._finish_chunk(prep, self._launch_chunk(prep))
            ran = True
            budget -= 1
        self._pf_next = (self._pf_next + 1) % B
        if ran:
            self._sync()
            self.prefill_seconds += time.perf_counter() - t0
        return budget

    def _stage_prefill(self) -> List[tuple]:
        """Stage, without launching, up to ``prefill_chunks_per_step``
        chunks in ``_prefill_step``'s round-robin order: the sharded
        engine launches every shard's r-th staged chunk in one round.
        Staging is safe because a pass stages at most one chunk a slot and
        a chunk writes only its own slot's pages."""
        B = self.sc.max_batch
        budget = self.sc.prefill_chunks_per_step
        preps: List[tuple] = []
        for off in range(B):
            if budget == 0:
                break
            b = (self._pf_next + off) % B
            if self._prefilled[b] is None:
                continue
            prep = self._prep_chunk(b)
            if prep is None:
                continue
            preps.append(prep)
            budget -= 1
        self._pf_next = (self._pf_next + 1) % B
        return preps

    # -- preemption -----------------------------------------------------------

    def _swap_out_slot(self, b: int, n_tokens: int) -> dict:
        """Slot ``b``'s first ``n_tokens`` cache entries of every leaf of
        every layer, copied to host memory (finished when this returns,
        before the pages are released), with their crc: ``{"bufs": one
        dict of CPU tensors per layer, "crc": int}``."""
        row = self._btabs.rows[b].copy()
        bufs = [{name: swap_out(pool, row, n_tokens)
                 for name, pool in layer.items()} for layer in self._cache]
        return {"bufs": bufs, "crc": checksum(bufs)}

    def _swap_in_slot(self, b: int, st: dict) -> None:
        """Restore a swapped-out cache through slot ``b``'s fresh row, byte
        for byte, after checking the buffers' crc; raises ``SwapFailed``
        when they do not match."""
        if checksum(st["bufs"]) != st["crc"]:
            raise SwapFailed("swap buffer failed checksum verification")
        row = self._btabs.rows[b].copy()
        for layer, bufs in zip(self._cache, st["bufs"]):
            for name, pool in layer.items():
                swap_in(pool, row, bufs[name])

    def _corrupt_swap(self, bufs: list) -> list:
        """The buffers with one byte of their first leaf (in ``checksum``'s
        order) flipped by the ``swap_corrupt`` stream, as the reference
        flips its first leaf."""
        first = sorted(bufs[0])[0]
        layer0 = dict(bufs[0])
        layer0[first] = self.faults.corrupt("swap_corrupt", layer0[first])
        return [layer0] + bufs[1:]

    def _preempt(self, b: int) -> None:
        """Evict slot ``b`` and requeue its request at the head of the
        pending queue.  Recompute (and any mid-prefill victim, which has
        no decode state) relies on the generated tokens riding as prompt
        suffix; swap first saves the slot's entries, their crc and its
        next-token logits (a device copy).  A failed swap-out (a
        ``swap_out`` fault) saves nothing and the victim recomputes; a
        ``swap_corrupt`` fault flips a byte after the crc was taken."""
        r = self._slot_req[b]
        if self.sc.preempt_mode == "swap" and self._prefilled[b] is None:
            try:
                if self._fires("swap_out"):
                    raise SwapFailed("injected swap_out fault")
                st = self._swap_out_slot(b, int(self._pos[b]))
                if self._fires("swap_corrupt"):
                    st["bufs"] = self._corrupt_swap(st["bufs"])
                st["logits"] = self._logits[b].clone()
                self._swapped[id(r)] = st
                self.n_swapped_out += 1
            except SwapFailed:
                self.n_swap_fallbacks += 1
        self._pending.insert(0, r)
        self._release(b)
        self._done[b] = True
        self.n_preempted += 1
        self.preempted_rids.append(r.rid)

    def _preempt_for_headroom(self, live: np.ndarray,
                              needs: Dict[int, int]) -> None:
        """Free pages for this chunk's growth, cheapest first: pages only
        the index pins are reclaimed (LRU), then victims are evicted by
        (priority, stamp), lowest tier and youngest admission first, any
        occupied slot but the best-ranked, which always runs: with the
        oversize check at admission that guarantees progress.  Eviction
        goes on until ``low_extra`` slack pages are free beyond the
        deficit (thrash guard).  ``needs``: extra pages per live slot."""
        deficit = sum(needs.values())
        if self._pindex is not None and deficit > self.pool.free_count:
            if not self._fires("prefix_reclaim"):
                self.n_reclaimed += self._pindex.reclaim(self.pool, deficit)
        if deficit <= self.pool.free_count:
            return
        cand = sorted((b for b in range(self.sc.max_batch)
                       if self._slot_req[b] is not None),
                      key=lambda b: (-self._slot_req[b].priority,
                                     self._stamp[b]))
        while len(cand) > 1 and (deficit + self.pool.low_extra
                                 > self.pool.free_count):
            b = cand.pop()
            deficit -= needs.pop(b, 0)
            self._preempt(b)
            live[b] = False

    def _ensure_chunk_headroom(self, live: np.ndarray) -> None:
        """Before a decode chunk: give every decoding slot the pages its
        next ``decode_chunk`` tokens need (capped at its worst case; the
        chunk itself never allocates) and fork every still-shared page
        they write into.  Reserve admission guarantees the pages (forks
        are part of the charge); optimistic admission reclaims index pins
        and preempts victims when the pool would run dry, and any
        allocation that still fails preempts the slot that asked.
        Mutates ``live``."""
        sc = self.sc
        needs: Dict[int, int] = {}
        grow: Dict[int, int] = {}
        forks: Dict[int, List[int]] = {}
        for b in np.nonzero(live)[0]:
            pos = int(self._pos[b])
            end = min(pos + sc.decode_chunk, sc.max_seq_len)
            need = min(pages_needed(end, sc.page_size), self._reserved[b])
            extra = need - len(self._btabs.slot_pages[b])
            nf = self._fork_candidates(b, pos, end)
            if extra > 0:
                grow[b] = extra
            if nf:
                forks[b] = nf
            if max(extra, 0) + len(nf):
                needs[b] = max(extra, 0) + len(nf)
        if sc.admission == "optimistic":
            self._preempt_for_headroom(live, needs)
        for b, pages in forks.items():
            if not live[b]:
                continue
            try:
                for j in pages:           # a sharer may have been evicted
                    if self.pool.ref(int(self._btabs.rows[b, j])) > 1:
                        self._cow_fork(b, j)
            except PagePoolExhausted:
                self._preempt(b)
                live[b] = False
        for b, extra in grow.items():
            if not live[b]:
                continue
            have = len(self._btabs.slot_pages[b])
            try:
                phys = self._alloc(extra)
            except PagePoolExhausted:
                self._preempt(b)
                live[b] = False
                continue
            self._btabs.assign(b, phys, start=have)
            self._private[b] += extra

    # -- decode ---------------------------------------------------------------

    def _decode_chunk(self, live: np.ndarray,
                      block_table: Optional[torch.Tensor] = None):
        """``decode_chunk`` iterations on the device; one read-back
        (``_launch_decode``, then ``_read_decode``).  ``block_table``: the
        paged cache's rows on the device, those of slots outside ``live``
        as the garbage page.

        Returns host arrays: tokens and emit masks (N, B) and a per-slot
        flag of finite next-token logits; positions, counts and the
        done/truncated masks are written back to the host state."""
        return self._read_decode(self._launch_decode(live, block_table))

    def _launch_decode(self, live: np.ndarray,
                       block_table: Optional[torch.Tensor] = None,
                       num_splits: Optional[int] = None) -> torch.Tensor:
        """Queue a decode chunk's work on the device, with no host sync:
        the state goes in by a non-blocking copy, so the chunk queues
        behind work already on the stream (a fused prefill chunk).
        ``num_splits``: the split count (default ``_live_splits(live)``;
        the sharded engine passes one for every shard).  A
        ``nan_logits`` fault poisons the lowest live slot's next-token
        logits on the device before the finiteness check, as the
        reference's harvest does.  Returns the chunk's tokens, emit
        masks, state and finiteness flags packed in one device tensor
        for ``_read_decode``."""
        sc = self.sc
        T, N, eos = sc.max_seq_len, sc.decode_chunk, sc.eos_token
        dev = self.device
        # iterations after which some slot is still active: a slot with
        # r tokens left at position p stays active after iteration i iff
        # i < min(r - 1, T - p) (EOS can only end it sooner)
        act = live & ~self._done
        n_model = int(np.minimum(self._max_new - self._emitted - 1,
                                 T - self._pos)[act].max(initial=0))
        n_model = max(0, min(N, n_model))
        n_splits = (self._live_splits(live) if num_splits is None
                    else num_splits)
        state = to_device(np.stack([
            self._pos, self._emitted, self._max_new, self._done,
            self._trunc]).astype(np.int64), dev)          # one copy in
        pos, emitted, max_new = state[0], state[1], state[2]
        done, trunc = state[3].bool(), state[4].bool()
        logits = self._logits
        toks, emits = [], []
        for i in range(N):
            nxt = sample_token(logits, sc.temperature, self.gen)      # (B,)
            emit = ~done
            toks.append(torch.where(emit, nxt, torch.zeros_like(nxt)))
            emits.append(emit)
            emitted = emitted + emit.long()
            done = done | (emitted >= max_new)
            if eos is not None:
                done = done | (emit & (nxt == eos))
            # the sampled token was emitted but there is no cache slot
            # left to decode from it: surface truncation, stop the slot
            full = ~done & (pos >= T)
            trunc = trunc | full
            done = done | full
            if i < n_model:
                # finished slots decode a harmless write into their own,
                # soon released, lane; MoE routing counts active ones only
                lg, self._cache = self.model.decode_step(
                    self.params, self._cache, nxt[:, None],
                    pos.clamp(max=T - 1), proj=self.proj,
                    block_table=block_table, token_mask=~done,
                    num_splits=n_splits)
                logits = lg[:, 0]
                self.n_decode_steps += 1
            pos = torch.where(done, pos, pos + 1)
        self._logits = logits
        if self._fires("nan_logits"):
            self._logits[int(np.nonzero(live)[0][0])] = float("nan")
        finite = torch.isfinite(self._logits).all(dim=-1)
        return torch.cat([torch.stack(toks).reshape(-1),
                          torch.stack(emits).reshape(-1).long(),
                          pos, emitted, done.long(), trunc.long(),
                          finite.long()])

    def _read_decode(self, packed: torch.Tensor):
        """Read a launched chunk back (the host sync) and write its
        positions, counts and done/truncated masks to the host state;
        returns ``_decode_chunk``'s host arrays."""
        N, B = self.sc.decode_chunk, self.sc.max_batch
        host = packed.cpu().numpy()
        nb = N * B
        toks_np = host[:nb].reshape(N, B)
        emits_np = host[nb:2 * nb].reshape(N, B).astype(bool)
        rest = host[2 * nb:].reshape(5, B)
        self._pos, self._emitted = rest[0].copy(), rest[1].copy()
        self._done, self._trunc = rest[2].astype(bool), rest[3].astype(bool)
        return toks_np, emits_np, rest[4].astype(bool)

    def _harvest(self, live: np.ndarray, toks_np: np.ndarray,
                 emits_np: np.ndarray, finite: np.ndarray) -> bool:
        """Append one chunk's emitted tokens to their requests,
        quarantine slots with non-finite logits, release finished slots.
        Returns whether any slot was freed."""
        if self.sc.guard_numerics:
            for b in np.nonzero(live & ~finite)[0]:
                emits_np[:, b] = False      # drawn from garbage: dropped
                self._fail_request(self._slot_req[b], "numerics",
                                   "non-finite next-token logits")
                live[b] = False
        if emits_np[:, live].any():
            self._progress = True
        freed = False
        for b in np.nonzero(live)[0]:
            r = self._slot_req[b]
            r.out_tokens.extend(int(t) for t, e in zip(toks_np[:, b],
                                                       emits_np[:, b]) if e)
            if self._done[b]:
                r.done = True
                r.truncated = bool(self._trunc[b])
                self._release(b, finished=True)
                self._retry.pop(id(r), None)
                self._pf_best.pop(id(r), None)
                self.n_completed += 1
                freed = True
        return freed

    def step(self) -> bool:
        """One scheduling iteration: admit, advance chunked prefills, one
        fused decode chunk over the fully prefilled slots, harvest, then
        refill freed slots in the same step (under the token budget,
        ``_step_inner_budget``).  Deadlines are checked first, the audit
        runs after every ``audit_every``-th step (``ServeConfig.audit``,
        counted in ``n_audits``) and the no-progress watchdog last.
        Returns whether work remains."""
        if not self._started:
            raise RuntimeError("call start(requests) first")
        self._step_count += 1
        self._progress = False
        self._check_deadlines()
        busy = self._step_inner()
        if self.sc.audit and self._step_count % self.sc.audit_every == 0:
            invariants.audit(self)
            self.n_audits += 1
        if busy and not self._progress:
            self._no_progress += 1
            if (self.sc.stall_steps
                    and self._no_progress >= self.sc.stall_steps):
                raise EngineStalledError(self._no_progress,
                                         invariants.scheduler_dump(self))
        else:
            self._no_progress = 0
        return busy

    def _step_inner(self) -> bool:
        sc = self.sc
        if sc.max_num_batched_tokens:
            return self._step_inner_budget()
        self._admit()
        self._note_pages()
        pf_budget = self._prefill_step() if sc.chunked_prefill else 0
        live = self._decodable()
        if not live.any():
            return self._busy()
        btab = None
        if sc.paged:
            # may preempt (optimistic admission): victims leave ``live``
            self._ensure_chunk_headroom(live)
            if not live.any():
                return self._busy()
            btab = self._btabs.device(live)
            self._note_pages()
        t0 = time.perf_counter()
        toks_np, emits_np, finite = self._decode_chunk(live, btab)
        self.decode_seconds += time.perf_counter() - t0
        if self._harvest(live, toks_np, emits_np, finite) and self._pending:
            # refill the freed slots now, within the step's remaining
            # prefill-chunk budget
            self._admit()
            if sc.chunked_prefill and pf_budget:
                self._prefill_step(pf_budget)
        return self._busy()

    def _step_inner_budget(self) -> bool:
        """One token-budget iteration (the reference's
        ``_step_inner_budget``).  The budget is spent in a fixed order:
        (1) one token per decodable slot, after ``_ensure_chunk_headroom``;
        (2) admission while occupied slots stay within the budget, each a
        future decode charge; (3) prefill chunks round-robin into the
        residual, the last truncated to it.  The first staged chunk fuses
        with the decode chunk (its K2 launches, then the decode chunk's,
        on one stream; the read-back is the step's one sync); the others,
        and every chunk of a step with nothing to decode, run standalone.
        Activations between the live-mask snapshot and the decode chunk
        are queued and armed after it, skipping slots unwound meanwhile.
        Each step appends ``{step, budget, n_decode, prefill_tokens,
        admitted, fused}`` to ``budget_log``."""
        sc = self.sc
        B = sc.max_batch
        budget = sc.max_num_batched_tokens
        live = self._decodable()
        if live.any():
            self._ensure_chunk_headroom(live)
        n_decode = int(live.sum())
        residual = max(budget - n_decode, 0)
        self._activation_queue = queue = []
        n_admitted = self._admit(limit=max(budget - self._occupied(), 0))
        self._note_pages()
        t0 = time.perf_counter()
        preps: List[tuple] = []
        spent = 0
        for off in range(B):
            if residual - spent <= 0:
                break
            b = (self._pf_next + off) % B
            if self._prefilled[b] is None:
                continue
            prep = self._prep_chunk(b, cap=residual - spent)
            if prep is None:
                continue
            preps.append(prep)
            spent += prep[3]
        self._pf_next = (self._pf_next + 1) % B
        fused = preps.pop(0) if live.any() and preps else None
        for prep in preps:
            self._finish_chunk(prep, self._launch_chunk(prep))
        freed = False
        if live.any():
            btab = self._btabs.device(live)
            self._note_pages()
            t1 = time.perf_counter()
            self.prefill_seconds += t1 - t0
            last = self._launch_chunk(fused) if fused is not None else None
            toks_np, emits_np, finite = self._decode_chunk(live, btab)
            self.decode_seconds += time.perf_counter() - t1
            if fused is not None:
                self._finish_chunk(fused, last)
                self.n_fused_steps += 1
            freed = self._harvest(live, toks_np, emits_np, finite)
        elif preps:
            self._sync()
            self.prefill_seconds += time.perf_counter() - t0
        # the armed slots join decode next step, charged there
        self._activation_queue = None
        for qb, qr, qlog in queue:
            if self._slot_req[qb] is qr:
                self._activate(qb, qr, qlog)
        self.budget_log.append({
            "step": self._step_count, "budget": budget,
            "n_decode": n_decode, "prefill_tokens": spent,
            "admitted": n_admitted, "fused": fused is not None})
        if freed and self._pending:
            # same-step refill under the same cap; its prefill starts next
            # step (this step's residual is spent)
            self._admit(limit=max(budget - self._occupied(), 0))
        return self._busy()

    def _note_pages(self) -> None:
        if self.pool is not None:
            self.peak_used_pages = max(self.peak_used_pages,
                                       self.pool.used_count)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve a list of requests to completion (continuous batching)."""
        self.start(requests)
        while self.step():
            pass
        return requests


# ---------------------------------------------------------------------------
# Data-axis sharded engine
# ---------------------------------------------------------------------------


class PooledPages:
    """Read-only aggregate view over the shards' page pools: the sharded
    engine's ``pool`` for introspection (tests, the serve CLI), its counts
    summed over every worker's pool.  Pages are owned and allocated per
    shard only, never through this view."""

    def __init__(self, workers):
        self._workers = workers

    @property
    def n_pages(self) -> int:
        """Allocatable physical pages over every shard."""
        return sum(w.pool.n_pages for w in self._workers)

    @property
    def free_count(self) -> int:
        """Free pages summed over the shard pools."""
        return sum(w.pool.free_count for w in self._workers)

    @property
    def used_count(self) -> int:
        """Allocated pages summed over the shard pools."""
        return sum(w.pool.used_count for w in self._workers)

    @property
    def high_pages(self) -> int:
        """Admission high-watermark budget summed over the shards."""
        return sum(w.pool.high_pages for w in self._workers)


def pick_shard(workers, capacity=None):
    """Route target for the next pending request, the reference's rule:
    among workers with routing capacity (free slots not already spoken for
    by their local backlog of preemption requeues), the one with the most
    admission headroom, free pages capped at the high-watermark budget (a
    pool past its watermark does not look attractive because another
    shard is fuller).  Ties go to the lower shard index.  ``capacity``
    threads the routing loop's residual capacities; by default it comes
    from each worker's slots and backlog.  None when no worker has
    capacity: the head request waits, which keeps the queue's order."""
    if capacity is None:
        capacity = [sum(q is None for q in w._slot_req) - len(w._pending)
                    for w in workers]
    best, best_score = None, -1
    for i, w in enumerate(workers):
        if capacity[i] <= 0:
            continue
        score = min(w.pool.free_count,
                    max(w.pool.high_pages - w.pool.used_count, 0))
        if score > best_score:
            best, best_score = w, score
    return best


class _ShardWorker(ServingEngine):
    """One shard's scheduler inside a ``ShardedServingEngine``: a whole
    ``ServingEngine`` over its slice of the slot axis (``sc`` is the
    shard's own config, ``shards=1``) that owns every piece of its state
    (pending queue of preemption requeues, page pool, block tables, prefix
    index, swap store, faults, counters) and its tensors, on its own
    device.  The parent drives it phase by phase and never lets it launch
    from ``step()``; its runtime projections are the parent's copy for
    its device."""

    def __init__(self, parent: "ShardedServingEngine", shard: int,
                 slots: slice, cfg, params, sc: ServeConfig, projections,
                 device, faults: Optional[FaultInjector]):
        self._parent = parent
        self._shard = shard
        self._slots = slots             # its slice of the global slot axis
        super().__init__(cfg, params, sc, projections=projections,
                         device=device, faults=faults)

    def _projection_tree(self, projections: ModelProjections):
        return self._parent._shared_projections(self.model, projections)


class ShardedServingEngine(ServingEngine):
    """Data-axis sharded serving engine (see the module docstring).

    ``ServingEngine(cfg, params, sc)`` builds one when
    ``sc.shards > 1``.  ``devices`` (one per shard; default
    ``serve_devices(sc.shards, device)``: the first ``shards`` CUDA
    devices, or ``device`` repeated when the caller names one) places
    the shards; the params and the runtime projections are copied once
    to each distinct device, and workers on one device share them.  Shard
    ``s`` samples from a generator seeded ``sc.seed + s`` and draws its
    chaos schedule from ``chaos_seed + s``.

    Each ``step()`` keeps the reference's order: per-shard deadlines, then
    the global queue's; routing in queue order (``pick_shard``);
    per-shard admission; one prefill round per staged chunk over the
    shards; per-shard headroom; one decode chunk per shard with live
    slots, all with one split count, from the deepest live position over
    every shard; per-shard harvest and a same-step refill; then the audits
    (``invariants.audit`` per worker, then ``invariants.audit_sharded``)
    and the watchdog over every shard.  Every launch for a worker runs
    under its device's context.  The shards' launches follow one another
    from this thread with no sync between them, so shards on distinct
    cards overlap; the one sync a step is the harvest's read-back.
    ``prefill_seconds`` and ``decode_seconds`` are the host time of the
    prefill rounds and of the decode chunks' launches and read-backs;
    ``_AGG_COUNTERS`` and ``n_failed``, ``error_counts`` and
    ``preempted_rids`` sum or join the workers'."""

    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig,
                 projections: Optional[ModelProjections] = None,
                 device: DeviceLike = None,
                 faults: Optional[FaultInjector] = None,
                 devices: Optional[List[DeviceLike]] = None):
        S = sc.shards
        if devices is None:
            devices = serve_devices(S, device)
        devices = [resolve_device(d) for d in devices]
        if len(devices) != S:
            raise ValueError(f"{len(devices)} devices for {S} shards")
        self.devices = devices
        # one copy of the params and of the runtime projections on each
        # distinct device (filled before the base init builds the latter)
        self._params_on: Dict[torch.device, dict] = {}
        self._proj_on: Dict[torch.device, list] = {}
        self._given_params = params
        super().__init__(cfg, self._params_for(devices[0]), sc,
                         projections=projections, device=devices[0],
                         faults=faults)

        def local_sc(s: int) -> ServeConfig:
            kw = dict(shards=1, max_batch=sc.max_batch // S,
                      n_pages=sc.total_pages // S, seed=sc.seed + s)
            if sc.chaos_seed is not None:
                # each shard draws its own fault sequence, reproducibly
                kw["chaos_seed"] = sc.chaos_seed + s
            return dataclasses.replace(sc, **kw)

        self.workers = [
            _ShardWorker(self, s, slots, cfg, self._params_for(d),
                         local_sc(s), projections, d, faults)
            for s, (d, slots) in enumerate(zip(
                devices, slot_slices(sc.max_batch, S)))]
        self._local_phys = self.workers[0]._pool_pages()

    def _params_for(self, device: torch.device) -> dict:
        """The params on ``device``: the caller's where they live there,
        else one copy a device."""
        if self._given_params["embed"].device == device:
            return self._given_params
        if device not in self._params_on:
            self._params_on[device] = tree_to(self._given_params, device)
        return self._params_on[device]

    def _shared_projections(self, model, projections: ModelProjections):
        """The runtime projections on ``model``'s device, built once a
        device."""
        if model.device not in self._proj_on:
            self._proj_on[model.device] = model.projections_pytree(
                projections)
        return self._proj_on[model.device]

    def _projection_tree(self, projections: ModelProjections):
        return self._shared_projections(self.model, projections)

    #: scheduler counters summed over the shard workers on read (each
    #: worker counts its own slots): the reference's, and the port's
    #: decode steps and prefill tokens
    _AGG_COUNTERS = (
        "n_completed", "n_preempted", "n_swapped_out", "n_swapped_in",
        "n_retried", "n_swap_fallbacks", "n_reclaimed", "n_cow_forks",
        "n_shared_pages", "n_shared_tokens", "n_full_hits",
        "n_prefill_chunks", "n_fused_steps", "n_truncated_chunks",
        "peak_used_pages", "n_decode_steps", "n_prefill_tokens")

    def __getattr__(self, name):
        """Aggregate the shards' scheduler counters on read: sums for
        ``_AGG_COUNTERS``, a merged dict for ``error_counts``, the
        concatenation for ``preempted_rids``; ``n_failed`` adds the
        failures of requests still in the global queue."""
        workers = self.__dict__.get("workers")
        if workers:
            if name in ShardedServingEngine._AGG_COUNTERS:
                return sum(getattr(w, name) for w in workers)
            if name == "preempted_rids":
                return [rid for w in workers for rid in w.preempted_rids]
            if name == "n_failed":
                return (self.__dict__.get("_n_failed_global", 0)
                        + sum(w.n_failed for w in workers))
            if name == "error_counts":
                out = dict(self.__dict__.get("_error_counts_global")
                           or {k: 0 for k in ERROR_KINDS})
                for w in workers:
                    for k, v in w.error_counts.items():
                        out[k] = out.get(k, 0) + v
                return out
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    def _each(self):
        """The workers in shard order, each yielded inside its device's
        context."""
        for w in self.workers:
            with device_context(w.device):
                yield w

    # -- lifecycle ------------------------------------------------------------

    def start(self, requests: List[Request]) -> None:
        """Start every shard empty: requests enter through the router at
        the first ``step()``."""
        T = self.sc.max_seq_len
        for r in requests:
            if len(r.prompt) > T:
                raise ValueError(
                    f"request {r.rid}: prompt length {len(r.prompt)} "
                    f"exceeds max_seq_len {T}")
        self._pending: List[Request] = list(requests)     # unrouted
        self._all_requests: List[Request] = list(requests)
        # for introspection only: the workers inject (an explicit injector
        # is shared, a chaos schedule is built per shard from its seed)
        if self._faults_arg is not None:
            self.faults = self._faults_arg
        elif self.sc.chaos_seed is not None:
            self.faults = FaultInjector.chaos(self.sc.chaos_seed,
                                              self.sc.chaos_rate)
        else:
            self.faults = None
        for w in self._each():
            w.start([])
        self.pool = PooledPages(self.workers)
        self._n_failed_global = 0
        self._error_counts_global = {k: 0 for k in ERROR_KINDS}
        self._progress_global = False
        self._step_count = 0
        self._no_progress = 0
        self.n_audits = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self._started = True

    def _busy(self) -> bool:
        return bool(self._pending) or any(w._busy() for w in self.workers)

    def _fail_global(self, r: Request, kind: str, detail: str = "") -> None:
        """Fail a request still in the global queue (never routed, so no
        shard state to unwind)."""
        r.error = RequestError(kind=kind, detail=detail,
                               step=self._step_count)
        r.done = True
        self._n_failed_global += 1
        self._error_counts_global[kind] += 1
        self._progress_global = True
        self._pending = [p for p in self._pending if p is not r]

    def _check_global_deadlines(self) -> None:
        """Deadlines of the requests not yet routed (the workers check
        their own)."""
        now = self._step_count
        for r in list(self._pending):
            ttft = r.ttft_deadline_steps
            if ttft is not None and not r.out_tokens and now > ttft:
                self._fail_global(
                    r, "deadline",
                    f"no first token after {ttft} steps (TTFT budget)")
            elif r.deadline_steps is not None and now > r.deadline_steps:
                self._fail_global(
                    r, "deadline",
                    f"incomplete after {r.deadline_steps} steps "
                    f"({len(r.out_tokens)}/{r.max_new_tokens} tokens)")

    def cancel(self, rid: int, detail: str = "cancelled by caller") -> bool:
        """Cancel request ``rid``: in the global queue it fails there;
        routed, its shard unwinds it."""
        if not self._started:
            raise RuntimeError("call start(requests) first")
        for r in list(self._pending):
            if r.rid == rid and not r.done:
                self._fail_global(r, "cancelled", detail)
                return True
        return any(w.cancel(rid, detail) for w in self._each())

    def _route(self) -> None:
        """Move pending requests, strictly in queue order, to the shard
        ``pick_shard`` picks; stop at the first head no shard can take, so
        the order holds.  A routed request's whole life stays on its
        shard."""
        cap = [sum(q is None for q in w._slot_req) - len(w._pending)
               for w in self.workers]
        while self._pending:
            w = pick_shard(self.workers, cap)
            if w is None:
                break
            cap[w._shard] -= 1
            r = self._pending.pop(0)
            w._pending.append(r)
            w._all_requests.append(r)

    def _run_prefill_rounds(self) -> None:
        """Each worker stages its round-robin chunks; round ``r`` launches
        every worker's r-th staged chunk, shard after shard, then does
        their host bookkeeping (no sync: the chunks' last logits stay on
        the devices)."""
        t0 = time.perf_counter()
        staged = [w._stage_prefill() for w in self._each()]
        for rnd in range(max((len(sp) for sp in staged), default=0)):
            launched = [(w, sp[rnd], w._launch_chunk(sp[rnd]))
                        for w, sp in zip(self._each(), staged)
                        if rnd < len(sp)]
            for w, prep, last in launched:
                with device_context(w.device):
                    w._finish_chunk(prep, last)
                self.prefill_chunk_shapes.add(prep[4])
        self.prefill_seconds += time.perf_counter() - t0

    def _dispatch_decode(self, lives: List[np.ndarray]) -> bool:
        """One decode chunk on every shard with live slots, one split
        count for all (from the deepest live host position over every
        shard), launched shard after shard; then each shard's read-back
        and harvest.  Returns whether any slot was freed."""
        sc = self.sc
        if self._dynamic_splits:
            deepest = [int(w._pos[live].max())
                       for w, live in zip(self.workers, lives) if live.any()]
            n_splits = self._splits_for_step(max(deepest, default=1)
                                             + sc.decode_chunk)
        else:
            n_splits = self._decode_splits
        t0 = time.perf_counter()
        launched = [(w, live, w._launch_decode(live, w._btabs.device(live),
                                               n_splits))
                    for w, live in zip(self._each(), lives) if live.any()]
        outs = []
        for w, live, packed in launched:
            with device_context(w.device):
                outs.append((w, live, w._read_decode(packed)))
        self.decode_seconds += time.perf_counter() - t0
        freed = False
        for w, live, (toks_np, emits_np, finite) in outs:
            with device_context(w.device):
                freed |= w._harvest(live, toks_np, emits_np, finite)
        return freed

    def step(self) -> bool:
        """One sharded scheduling iteration (the order is the class
        docstring's).  Returns whether work remains."""
        if not self._started:
            raise RuntimeError("call start(requests) first")
        sc = self.sc
        self._step_count += 1
        self._progress_global = False
        for w in self._each():
            # one scheduler clock: retry backoff, deadlines and chaos
            # schedules line up with the global step count
            w._step_count = self._step_count
            w._progress = False
            w._check_deadlines()
        self._check_global_deadlines()
        self._route()
        for w in self._each():
            w._admit()
            w._note_pages()
        self._run_prefill_rounds()
        lives = [w._decodable() for w in self.workers]
        for w, live in zip(self._each(), lives):
            if live.any():
                w._ensure_chunk_headroom(live)
                w._note_pages()
        if any(live.any() for live in lives) and self._dispatch_decode(lives):
            # refill the freed slots in the same step, routed globally
            self._route()
            for w in self._each():
                w._admit()
        busy = self._busy()
        if sc.audit and self._step_count % sc.audit_every == 0:
            for w in self.workers:
                invariants.audit(w)
            invariants.audit_sharded(self)
            self.n_audits += 1
        progress = (self._progress_global
                    or any(w._progress for w in self.workers))
        if busy and not progress:
            self._no_progress += 1
            if sc.stall_steps and self._no_progress >= sc.stall_steps:
                raise EngineStalledError(
                    self._no_progress,
                    "\n".join(f"[shard {s}] " + invariants.scheduler_dump(w)
                              for s, w in enumerate(self.workers)))
        else:
            self._no_progress = 0
        return busy
