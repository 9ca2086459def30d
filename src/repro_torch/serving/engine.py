"""Continuous-batching serving engine over dense slots or the paged store.

Torch counterpart of ``repro.serving.engine`` for one CUDA device, on
two cache layouts:

* **dense slots** (``ServeConfig.paged=False``): the batched cache is
  allocated once, one ``max_seq_len`` lane per slot; each admitted
  request is prefilled alone at its exact prompt length and copied into
  its slot;
* **paged** (``paged=True``): every layer's cache is a pool of
  ``page_size``-token pages and one block table maps each slot's logical
  pages to physical ones (``serving.paged_cache``).  Admission is the
  reference's *reserve* policy: a request is admitted only when its worst
  case (prompt + ``max_new_tokens``, capped at ``max_seq_len``) fits what
  the pool has left after every admitted slot's own outstanding growth,
  so no allocation can fail mid-serve; a request whose worst case
  exceeds the whole pool fails with ``oversize``.  Pages are allocated
  for the prompt at admission and grown before each decode chunk, and
  freed when the request ends.  The prompt goes in either at its exact
  length (dense staging repaged into the pool) or, with
  ``chunked_prefill``, in ``prefill_chunk``-token chunks padded to a
  bucket and written straight into the pages, ``prefill_chunks_per_step``
  chunks per step round-robin over the slots, while the other slots
  decode.

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

Failure semantics follow the reference: a request fails with a
structured ``RequestError`` (oversize, deadlines, ``cancel``, non-finite
logits) and the rest of the batch keeps serving; a ``stall_steps``
watchdog raises ``EngineStalledError`` instead of spinning.  Serving
features of later slices (optimistic admission and preemption, prefix
sharing, token budget, shards, audits, fault injection) raise
``NotImplementedError`` at construction.
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
from repro_torch.device import DeviceLike, to_device
from repro_torch.kernels.kq_decode.ops import default_decode_splits
from repro_torch.models.model import build_model
from repro_torch.serving.page_layouts import FpLayout, get_layout
from repro_torch.serving.paged_cache import (BlockTables, PagePool,
                                             pages_needed)

# the structured failure taxonomy: every terminal non-success outcome of
# a request is exactly one of these
ERROR_KINDS = ("oversize", "deadline", "pool_exhausted", "swap_failed",
               "numerics", "cancelled")

# ServeConfig features that belong to later slices of the port, with the
# ROADMAP.md queue-1 item that brings each
_LATER = (
    ("admission", lambda sc: sc.admission != "reserve",
     "item 6 (optimistic admission and preemption)"),
    ("share_prefix", lambda sc: sc.share_prefix, "item 6 (prefix sharing)"),
    ("max_num_batched_tokens", lambda sc: sc.max_num_batched_tokens > 0,
     "item 6 (token-budget scheduler)"),
    ("audit", lambda sc: sc.audit, "item 6 (invariant audits)"),
    ("chaos_seed", lambda sc: sc.chaos_seed is not None,
     "item 6 (fault injection)"),
    ("shards", lambda sc: sc.shards > 1, "item 12 (sharded engine)"),
)


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
    ``peak_used_pages``, and the wall seconds spent in prefill
    (``prefill_seconds``, which ends each admission or prefill pass with
    a device sync) and in decode chunks (``decode_seconds``)."""

    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig,
                 projections: Optional[ModelProjections] = None,
                 device: DeviceLike = None):
        later = [f"{name} (ROADMAP.md queue 1 {item})"
                 for name, asks, item in _LATER if asks(sc)]
        if later:
            raise NotImplementedError(
                "the port serves dense slots and the paged store under "
                "reserve admission; not yet ported: " + ", ".join(later))
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
        self.proj = (self.model.projections_pytree(projections)
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
        self._started = False

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
        for r in requests:
            if len(r.prompt) > T:
                raise ValueError(f"request {r.rid}: prompt length "
                                 f"{len(r.prompt)} exceeds max_seq_len {T}")
        self._pending: List[Request] = list(requests)
        self._all_requests: List[Request] = list(requests)
        # paged bookkeeping per slot: the pages it may ever hold (its
        # worst case, the growth cap) and the pages it holds
        self._reserved = [0] * B
        self._private = [0] * B
        self.pool: Optional[PagePool] = None
        self._btabs: Optional[BlockTables] = None
        if sc.paged:
            # sized in physical pages: the fp-unit budget times the page
            # layout's capacity multiplier
            n_phys = self._pool_pages()
            self.pool = PagePool(n_phys, sc.watermark_high, sc.watermark_low)
            self._btabs = BlockTables(B, sc.pages_per_seq, self.device)
            self._cache = self.model.init_paged_cache(
                n_phys + 1, sc.page_size, self.ranks)
        else:
            self._cache = self.model.init_cache(B, T, self.ranks)
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
        self._slot_prompt: List[Optional[np.ndarray]] = [None] * B
        self._started = True

    def _busy(self) -> bool:
        return bool(self._pending
                    or any(r is not None for r in self._slot_req))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- failure semantics --------------------------------------------------

    def _fail_request(self, r: Request, kind: str, detail: str = "") -> None:
        """Terminally fail ``r`` and unwind it from the pending queue or
        its slot; the rest of the batch is untouched."""
        r.error = RequestError(kind=kind, detail=detail,
                               step=self._step_count)
        r.done = True
        self.n_failed += 1
        self.error_counts[kind] += 1
        self._progress = True
        self._pending = [p for p in self._pending if p is not r]
        for b in range(self.sc.max_batch):
            if self._slot_req[b] is r:
                self._release(b)
                self._done[b] = True
                break

    def cancel(self, rid: int, detail: str = "cancelled by caller") -> bool:
        """Cancel request ``rid`` whether pending or decoding.  Returns
        whether a live request was cancelled."""
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

    def _dump(self) -> str:
        lines = [f"step={self._step_count} "
                 f"pending={[r.rid for r in self._pending]}"]
        for b, r in enumerate(self._slot_req):
            if r is not None:
                lines.append(f"slot {b}: rid={r.rid} pos={self._pos[b]} "
                             f"done={bool(self._done[b])} "
                             f"prefilled={self._prefilled[b]}")
        if self.pool is not None:
            lines.append(f"pool: {self.pool.used_count}/"
                         f"{self.pool.n_pages} pages used")
        return "\n".join("    " + ln for ln in lines)

    # -- admission ------------------------------------------------------------

    def _worst_case_pages(self, r: Request) -> int:
        """Pages the request can ever occupy (truncation caps the
        sequence at ``max_seq_len``)."""
        sc = self.sc
        return pages_needed(min(len(r.prompt) + max(r.max_new_tokens, 0),
                                sc.max_seq_len), sc.page_size)

    def _fits_now(self, worst: int) -> bool:
        """Reserve admission: every admitted slot may still grow by
        ``reserved - private`` pages; the request's worst case must fit
        what the pool has left after the live pages and that growth."""
        outstanding = sum(r - p for r, p in zip(self._reserved,
                                                self._private))
        headroom = self.pool.n_pages - self.pool.used_count - outstanding
        return worst <= headroom

    def _next_admissible(self) -> Optional[Request]:
        """Pop the first admissible pending request within the
        ``admit_window`` scan, so a small request is not blocked behind a
        big one whose worst case does not fit yet.  Requests with no
        tokens to generate are resolved (done) on the way; a request
        whose worst case exceeds the whole pool fails (``oversize``)."""
        sc = self.sc
        i = scanned = 0
        while i < len(self._pending) and scanned < sc.admit_window:
            r = self._pending[i]
            if r.max_new_tokens - len(r.out_tokens) <= 0:
                r.done = True
                self._pending.pop(i)
                continue
            if sc.paged:
                worst = self._worst_case_pages(r)
                if worst > self.pool.n_pages:
                    self._fail_request(
                        r, "oversize", f"worst case {worst} pages exceeds "
                        f"the {self.pool.n_pages}-page pool")
                    continue
                if not self._fits_now(worst):
                    i += 1
                    scanned += 1
                    continue
            return self._pending.pop(i)
        return None

    def _admit(self) -> int:
        """Fill free slots from the pending queue; returns how many
        requests were admitted.  Paged: allocate the prompt's pages and
        charge the worst case.  Chunked prefill: queue the slot for
        ``_prefill_step``.  Otherwise prefill the prompt alone at its
        exact length and copy its cache into the slot (dense) or its
        pages (paged)."""
        sc = self.sc
        t0 = time.perf_counter()
        n = 0
        for b in range(sc.max_batch):
            if self._slot_req[b] is not None:
                continue
            r = self._next_admissible()
            if r is None:
                break
            prompt = np.concatenate([np.asarray(r.prompt, np.int32),
                                     np.asarray(r.out_tokens, np.int32)])
            self._slot_req[b] = r
            self._slot_prompt[b] = prompt
            n += 1
            if sc.paged:
                # reserve admission checked that these fit: no failure
                self._reserved[b] = self._worst_case_pages(r)
                n_priv = pages_needed(len(prompt), sc.page_size)
                self._btabs.assign(b, self.pool.alloc(n_priv))
                self._private[b] = n_priv
            if sc.chunked_prefill:
                self._prefilled[b] = 0
                continue
            max_len = (self._private[b] * sc.page_size if sc.paged
                       else sc.max_seq_len)
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
        if n and not sc.chunked_prefill:
            self._sync()
            self.prefill_seconds += time.perf_counter() - t0
        return n

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
        """Arm slot ``b`` for decode once its prompt cache is in place."""
        self._logits[b] = last_logits
        self._pos[b] = len(self._slot_prompt[b])
        self._emitted[b] = 0
        self._max_new[b] = r.max_new_tokens - len(r.out_tokens)
        self._done[b] = False
        self._trunc[b] = False

    def _release(self, b: int) -> None:
        self._slot_req[b] = None
        self._slot_prompt[b] = None
        self._prefilled[b] = None
        if self.sc.paged:
            # the slot's pages go back to the pool; its row to garbage
            self._btabs.release(b, self.pool)
            self._reserved[b] = self._private[b] = 0

    # -- chunked prefill ------------------------------------------------------

    def _run_chunk(self, b: int) -> None:
        """Run slot ``b``'s next prefill chunk, padded to its bucket,
        through the model: its tokens, position, real-token count and the
        slot's block-table row go to the device in one non-blocking copy.
        The slot joins decode, with the logits of its last real token,
        when its prompt is written."""
        prompt = self._slot_prompt[b]
        start = self._prefilled[b]
        n = min(self.sc.prefill_chunk, len(prompt) - start)
        bucket = self.sc.bucket_for(n)
        host = np.zeros(bucket + 2 + self.sc.pages_per_seq, np.int32)
        host[:n] = prompt[start: start + n]
        host[bucket: bucket + 2] = start, n
        host[bucket + 2:] = self._btabs.rows[b]
        dev = to_device(host, self.device)
        logits, self._cache = self.model.prefill_chunk(
            self.params, self._cache, dev[None, :bucket],
            dev[bucket: bucket + 1], dev[bucket + 1: bucket + 2],
            proj=self.proj, block_table=dev[None, bucket + 2:])
        self.prefill_chunk_shapes.add(bucket)
        self.n_prefill_chunks += 1
        self.n_prefill_tokens += n
        self._prefilled[b] = start + n
        self._progress = True
        if start + n == len(prompt):
            self._prefilled[b] = None            # complete: join decode
            self._activate(b, self._slot_req[b], logits[0, n - 1])

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
            self._run_chunk(b)
            ran = True
            budget -= 1
        self._pf_next = (self._pf_next + 1) % B
        if ran:
            self._sync()
            self.prefill_seconds += time.perf_counter() - t0
        return budget

    def _ensure_chunk_headroom(self, live: np.ndarray) -> None:
        """Grow every decoding slot's pages to cover the next
        ``decode_chunk`` tokens (capped at its worst case) before the
        chunk runs: the decode chunk itself never allocates.  Reserve
        admission guarantees the pages are there."""
        sc = self.sc
        for b in np.nonzero(live)[0]:
            end = min(int(self._pos[b]) + sc.decode_chunk, sc.max_seq_len)
            need = min(pages_needed(end, sc.page_size), self._reserved[b])
            have = len(self._btabs.slot_pages[b])
            if need > have:
                self._btabs.assign(b, self.pool.alloc(need - have),
                                   start=have)
                self._private[b] += need - have

    # -- decode ---------------------------------------------------------------

    def _decode_chunk(self, live: np.ndarray,
                      block_table: Optional[torch.Tensor] = None):
        """``decode_chunk`` iterations on the device; one read-back.
        ``block_table``: the paged cache's rows on the device, those of
        slots outside ``live`` as the garbage page.

        Returns host arrays: tokens and emit masks (N, B) and a per-slot
        flag of finite next-token logits; positions, counts and the
        done/truncated masks are written back to the host state."""
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
        n_splits = self._live_splits(live)
        state = torch.as_tensor(np.stack([
            self._pos, self._emitted, self._max_new, self._done,
            self._trunc]).astype(np.int64), device=dev)   # one copy in
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
                # soon released, lane
                lg, self._cache = self.model.decode_step(
                    self.params, self._cache, nxt[:, None],
                    pos.clamp(max=T - 1), proj=self.proj,
                    block_table=block_table, num_splits=n_splits)
                logits = lg[:, 0]
                self.n_decode_steps += 1
            pos = torch.where(done, pos, pos + 1)
        self._logits = logits
        finite = torch.isfinite(logits).all(dim=-1)
        B = sc.max_batch
        host = torch.cat([torch.stack(toks).reshape(-1),
                          torch.stack(emits).reshape(-1).long(),
                          pos, emitted, done.long(), trunc.long(),
                          finite.long()]).cpu().numpy()
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
                self._release(b)
                self.n_completed += 1
                freed = True
        return freed

    def step(self) -> bool:
        """One scheduling iteration: admit, advance chunked prefills, one
        fused decode chunk over the fully prefilled slots, harvest, then
        refill freed slots in the same step.  Deadlines are
        checked first and the no-progress watchdog after.  Returns
        whether work remains."""
        if not self._started:
            raise RuntimeError("call start(requests) first")
        self._step_count += 1
        self._progress = False
        self._check_deadlines()
        busy = self._step_inner()
        if busy and not self._progress:
            self._no_progress += 1
            if (self.sc.stall_steps
                    and self._no_progress >= self.sc.stall_steps):
                raise EngineStalledError(self._no_progress, self._dump())
        else:
            self._no_progress = 0
        return busy

    def _step_inner(self) -> bool:
        sc = self.sc
        self._admit()
        self._note_pages()
        pf_budget = self._prefill_step() if sc.chunked_prefill else 0
        # decodable = admitted and fully prefilled; mid-prefill slots hold
        # their pages and join decode when their last chunk lands
        live = np.array([r is not None and pf is None for r, pf in
                         zip(self._slot_req, self._prefilled)])
        if not live.any():
            return self._busy()
        btab = None
        if sc.paged:
            self._ensure_chunk_headroom(live)
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
