"""Paged KV cache: refcounted page store, block tables, device primitives.

Torch counterpart of ``repro.serving.paged_cache`` (DESIGN.md
§paged-cache).  Each attention layer's cache is a pool of fixed-size
pages

    kc: (P, Hkv, page_size, R_k)    vc: (P, Hkv, page_size, R_v)

and one block table, shared by all layers, maps ``(slot, logical_page)``
to a physical page.  A sequence of length L owns ``ceil(L / page_size)``
pages, allocated on demand instead of ``max_seq_len`` per slot.

* physical page 0 is the **garbage page**: never allocated, never freed.
  Rows of free, mid-prefill and finished slots point at it, so their
  masked writes (and bucket padding) land there and never in a page a
  live sequence reads;
* pages are refcounted: ``alloc`` hands out pages at refcount 1,
  ``share`` pins one more reference, ``free`` drops one and recycles a
  page only at zero;
* allocation is host-side and happens only at chunk boundaries, so the
  fused decode chunk never allocates.

``PagePool``, ``PrefixIndex``, ``pages_needed`` and ``BlockTables`` are
host state (numpy); ``append_token``, ``append_chunk``, ``copy_page``,
``swap_in`` and ``gather_pages`` work on torch tensors and write the pools
in place (the reference returns new arrays); ``swap_out`` copies a slot's
entries to host memory.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import to_device

GARBAGE_PAGE = 0


class PagePoolExhausted(RuntimeError):
    """No free pages left for a required allocation."""


class PagePool:
    """Host-side refcounted allocator over ``n_pages`` physical pages.

    Physical ids run ``1 .. n_pages`` (0 is the garbage page); the pools
    are sized ``n_pages + 1``.  ``used_count`` counts distinct live
    pages.  Watermarks, as fractions of the pool: ``high_pages`` caps how
    full optimistic admission may pack the pool (``can_admit``);
    ``low_extra`` is the slack a preemption pass frees beyond the strict
    deficit.  ``faults``: an optional ``FaultInjector`` whose
    ``page_alloc`` point ``alloc`` hits (the engine attaches its own)."""

    def __init__(self, n_pages: int, high_watermark: float = 1.0,
                 low_watermark: float = 0.0):
        assert n_pages >= 1, "pool needs at least one allocatable page"
        assert 0.0 < high_watermark <= 1.0
        assert 0.0 <= low_watermark < 1.0
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages, 0, -1))  # pop() -> 1..
        self._refs = np.zeros(n_pages + 1, np.int32)
        self.high_pages = max(1, int(round(high_watermark * n_pages)))
        self.low_extra = int(round(low_watermark * n_pages))
        self.faults = None

    @property
    def free_count(self) -> int:
        """Pages currently on the free list."""
        return len(self._free)

    @property
    def used_count(self) -> int:
        """Pages currently allocated (shared pages once)."""
        return self.n_pages - len(self._free)

    def ref(self, page: int) -> int:
        """Current reference count of ``page``."""
        return int(self._refs[page])

    def can_admit(self, n: int) -> bool:
        """``n`` pages are free and the pool stays at or below the high
        watermark afterwards."""
        return n <= len(self._free) and self.used_count + n <= self.high_pages

    def alloc(self, n: int) -> List[int]:
        """Pop ``n`` pages at refcount 1; raises ``PagePoolExhausted``
        (allocating none) if fewer than ``n`` are free, or when a request
        for pages (``n > 0``) hits an armed ``page_alloc`` fault."""
        if n and self.faults is not None and self.faults.fires(
                "page_alloc"):
            raise PagePoolExhausted(
                f"injected page_alloc fault (need {n}, "
                f"{len(self._free)} free)")
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free"
                f" (pool of {self.n_pages})")
        pages = [self._free.pop() for _ in range(n)]
        self._refs[pages] = 1
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Pin one extra reference on each (live) page."""
        for p in pages:
            if p == GARBAGE_PAGE:
                raise ValueError("cannot share the garbage page")
            if not self._refs[p]:
                raise ValueError(f"share of unowned page {p}")
            self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; recycle at refcount zero."""
        for p in pages:
            if p == GARBAGE_PAGE:
                raise ValueError("cannot free the garbage page")
            if not self._refs[p]:
                raise ValueError(f"double free of page {p}")
            self._refs[p] -= 1
            if not self._refs[p]:
                self._free.append(p)


class PrefixIndex:
    """Host-side prefix index: token-chunk chains -> physical pages.

    Each entry maps ``child_key(parent, chunk_tokens)``, a digest chained
    over the page-aligned token chunks of a prompt, to the physical page
    whose cache entries were computed for exactly that token prefix.
    Entries pin their page with one pool reference, so a finished
    request's prefix pages survive ``release`` for reuse until ``reclaim``
    drops them under pool pressure (LRU; entries a live slot still shares
    are skipped: dropping them frees nothing).

    A *terminal* entry (the final, possibly partial, chunk of a served
    prompt) may also carry the prompt's next-token ``logits`` (the engine
    keeps them on the device), so an exact-duplicate prompt skips prefill
    entirely."""

    ROOT = b""

    def __init__(self, capacity: int):
        assert capacity >= 1
        self.capacity = capacity
        # key -> [page, n_tokens, logits]
        self._entries: "OrderedDict[bytes, List]" = OrderedDict()

    @staticmethod
    def child_key(parent: bytes, tokens) -> bytes:
        """Chained digest of one page-aligned token chunk: a function of
        the *whole* token prefix, since the cache entries at position t
        depend on every earlier token."""
        raw = np.ascontiguousarray(np.asarray(tokens, np.int32))
        return hashlib.sha1(parent + raw.tobytes()).digest()

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def n_pinned(self) -> int:
        """Pages currently pinned by index references (one per entry)."""
        return len(self._entries)

    def insert(self, key: bytes, page: int, n_tokens: int, pool: PagePool,
               logits: Any = None) -> bool:
        """Pin ``page`` under ``key``; when the key is already cached, only
        attach ``logits`` (if given) and bump it in the LRU order: the
        caller's duplicate page stays private to its slot.  Returns whether
        a new entry was created."""
        assert page != GARBAGE_PAGE
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            if logits is not None:
                hit[2] = logits
            return False
        pool.share([page])
        self._entries[key] = [page, n_tokens, logits]
        while len(self._entries) > self.capacity:
            _, (old_page, _, _) = self._entries.popitem(last=False)
            pool.free([old_page])
        return True

    def attach_logits(self, key: bytes, logits: Any) -> None:
        """Attach terminal next-token logits to an existing entry."""
        hit = self._entries.get(key)
        if hit is not None:
            hit[2] = logits

    def get(self, key: bytes) -> Optional[Tuple[int, int, Any]]:
        """Single-entry lookup with LRU bump (no reference taken):
        ``(page, n_tokens, logits)`` or None."""
        hit = self._entries.get(key)
        if hit is None:
            return None
        self._entries.move_to_end(key)
        return hit[0], hit[1], hit[2]

    def touch(self, keys) -> None:
        """LRU-bump entries a caller is about to share."""
        for k in keys:
            if k in self._entries:
                self._entries.move_to_end(k)

    def walk(self, prompt: np.ndarray, page_size: int
             ) -> Tuple[List[Tuple[bytes, int, int]], bytes, int, Any]:
        """Longest cached prefix of ``prompt`` (read-only; no references).

        Returns ``(hits, chain_key, full_tokens, logits)``: ``hits`` holds
        ``(key, page, n_tokens)`` per matched chunk (full ``page_size``
        chunks, then at most one shorter terminal chunk); ``chain_key`` and
        ``full_tokens`` describe the page-aligned part of the match (the
        parent for indexing the prompt's *next* full page); ``logits`` are
        the stored next-token logits when the match covers the whole
        prompt and its terminal entry carries them."""
        L = len(prompt)
        key = self.ROOT
        hits: List[Tuple[bytes, int, int]] = []
        logits = None
        i = 0
        while i + page_size <= L:
            k2 = self.child_key(key, prompt[i: i + page_size])
            e = self._entries.get(k2)
            if e is None:
                break
            hits.append((k2, e[0], page_size))
            key = k2
            i += page_size
            if i == L:
                logits = e[2]
        full_tokens = i
        if i < L:
            # terminal partial chunk, the longest stored prefix wins; the
            # chain cannot continue past it (children hash whole pages)
            for n in range(min(L - i, page_size - 1), 0, -1):
                k2 = self.child_key(key, prompt[i: i + n])
                e = self._entries.get(k2)
                if e is not None:
                    hits.append((k2, e[0], n))
                    i += n
                    if i == L:
                        logits = e[2]
                    break
        return hits, key, full_tokens, logits

    def match(self, prompt: np.ndarray, page_size: int, pool: PagePool
              ) -> Tuple[List[int], int, int, bytes, Any]:
        """``walk`` plus reference pinning and LRU bumps: returns
        ``(pages, n_tokens, full_tokens, chain_key, logits)`` with one pool
        reference taken per returned page (``free`` to unshare)."""
        hits, chain_key, full_tokens, logits = self.walk(prompt, page_size)
        pages = [p for _, p, _ in hits]
        for k, _, _ in hits:
            self._entries.move_to_end(k)
        if pages:
            pool.share(pages)
        return (pages, sum(n for _, _, n in hits), full_tokens, chain_key,
                logits)

    def reclaimable(self, pool: PagePool) -> int:
        """Pages a ``reclaim`` pass could free now: entries whose page only
        the index pins (refcount 1)."""
        return sum(1 for page, _, _ in self._entries.values()
                   if pool.ref(page) == 1)

    def reclaim(self, pool: PagePool, need_free: int) -> int:
        """Drop LRU entries whose page only the index pins until
        ``pool.free_count >= need_free`` or nothing reclaimable is left;
        entries a live slot shares are kept.  Returns the entries
        dropped."""
        dropped = 0
        for key in list(self._entries):
            if pool.free_count >= need_free:
                break
            page = self._entries[key][0]
            if pool.ref(page) == 1:
                del self._entries[key]
                pool.free([page])
                dropped += 1
        return dropped


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages required to hold ``n_tokens`` cache entries."""
    return -(-max(n_tokens, 0) // page_size)


class BlockTables:
    """Per-slot block tables: host numpy rows plus a cached device copy.

    ``rows[b, j]`` is the physical page holding logical page ``j`` of
    slot ``b``; unallocated entries point at the garbage page."""

    def __init__(self, n_slots: int, pages_per_seq: int,
                 device: torch.device):
        self.rows = np.zeros((n_slots, pages_per_seq), np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self.device_ = device
        # (live-mask key, tensor): the decode chunk re-exports the rows
        # every step; they change only on assign / set_page / release, so
        # the upload is skipped unless the rows or the mask moved
        self._dev_cache: Optional[Tuple[Optional[bytes], torch.Tensor]] = None

    def assign(self, slot: int, pages: Sequence[int], start: int = 0
               ) -> None:
        """Append ``pages`` to ``slot`` from logical page ``start`` (==
        pages already owned)."""
        assert start == len(self.slot_pages[slot])
        self.rows[slot, start: start + len(pages)] = pages
        self.slot_pages[slot].extend(pages)
        self._dev_cache = None

    def set_page(self, slot: int, logical: int, page: int) -> None:
        """Point logical page ``logical`` of ``slot`` at another physical
        page (a copy-on-write fork or a late prefix match rewrites the row
        entry); the device copy is dropped with it, so no kernel reads the
        old page through a stale table."""
        assert logical < len(self.slot_pages[slot])
        self.rows[slot, logical] = page
        self.slot_pages[slot][logical] = page
        self._dev_cache = None

    def release(self, slot: int, pool: PagePool) -> None:
        """Drop the slot's page references; its row resets to garbage."""
        pool.free(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.rows[slot, :] = GARBAGE_PAGE
        self._dev_cache = None

    def host(self, live=None) -> np.ndarray:
        """Copy of the rows, those of non-live slots as the garbage page."""
        if live is None:
            return self.rows.copy()
        return np.where(np.asarray(live, bool)[:, None], self.rows,
                        GARBAGE_PAGE).astype(np.int32)

    def device(self, live=None) -> torch.Tensor:
        """The rows on the device, cached until the rows or the mask
        change.  ``live``: optional (n_slots,) bool; rows of non-live
        slots (free, mid-prefill) export as the garbage page, so the
        decode chunk's masked writes cannot touch pages a chunked
        prefill is filling.  The upload is a non-blocking copy from
        pinned memory: it never waits for the stream."""
        key = None if live is None else np.asarray(live, bool).tobytes()
        if self._dev_cache is not None and self._dev_cache[0] == key:
            return self._dev_cache[1]
        out = to_device(self.host(live), self.device_)
        self._dev_cache = (key, out)
        return out


# ---------------------------------------------------------------------------
# Device-side paged primitives (in place)
# ---------------------------------------------------------------------------


def append_token(pool: torch.Tensor, block_table: torch.Tensor,
                 pos: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Write one new cache entry per sequence through the block table,
    in place.

    pool: (P, Hkv, ps, R); block_table: (B, n_pages) int32; pos: (B,)
    destination position of each sequence; val: (B, Hkv, R).  Rows of
    dead slots point at the garbage page, so their writes are harmless."""
    ps = pool.shape[2]
    b = torch.arange(pos.shape[0], device=pool.device)
    phys = block_table[b, pos // ps].long()                  # (B,)
    pool[phys, :, pos % ps] = val.to(pool.dtype)
    return pool


def append_chunk(pool: torch.Tensor, block_table: torch.Tensor,
                 pos0: torch.Tensor, vals: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Write a prefill chunk of cache entries through the block table, in
    place.

    pool: (P, Hkv, ps, R); block_table: (B, n_pages) int32; pos0: (B,)
    position of each sequence's first chunk token; vals: (B, Hkv, S, R);
    valid: (B, S) bool, or a (B,) count of leading real tokens per row.
    Bucket-padding entries go to the garbage page; positions past the
    table's capacity are clamped before the lookup (only padding reaches
    them)."""
    ps = pool.shape[2]
    B, Hkv, S, R = vals.shape
    ar = torch.arange(S, device=pool.device)
    if valid.ndim == 1:                 # per-row count -> prefix mask
        valid = ar[None, :] < valid[:, None]
    n_pages = block_table.shape[1]
    pos = pos0[:, None].long() + ar[None, :]                 # (B, S)
    logical = torch.clamp(pos // ps, max=n_pages - 1)
    b = torch.arange(B, device=pool.device)[:, None]
    phys = torch.where(valid, block_table[b, logical].long(),
                       torch.full_like(logical, GARBAGE_PAGE))
    flat_vals = vals.transpose(1, 2).reshape(B * S, Hkv, R)
    pool[phys.reshape(-1), :, (pos % ps).reshape(-1)] = \
        flat_vals.to(pool.dtype)
    return pool


def copy_page(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Copy physical page ``src`` to ``dst`` in place: the device half of a
    copy-on-write fork (the host half repoints the writer's row at
    ``dst``, so its appends land in the private copy while other sharers
    keep reading ``src``).  pool: (P, ...)."""
    pool[dst].copy_(pool[src])
    return pool


def swap_out(pool: torch.Tensor, row, n_tokens: int) -> torch.Tensor:
    """A slot's first ``n_tokens`` cache entries copied to host memory:
    only its occupied pages are gathered (``row``: the slot's block-table
    row), so the copy is ``n_tokens`` wide, not ``max_seq_len``.  Returns a
    CPU tensor (Hkv, n_tokens, R) in the pool's dtype; the copy has
    finished when it returns, so the slot's pages may then be freed."""
    ps = pool.shape[2]
    occupied = pages_needed(n_tokens, ps)
    idx = to_device(np.asarray(row[:occupied], np.int32), pool.device)
    seq = gather_pages(pool, idx[None])[0, :, :n_tokens]
    return seq.contiguous().to("cpu")


def swap_in(pool: torch.Tensor, row, vals: torch.Tensor) -> torch.Tensor:
    """Write a ``swap_out`` buffer back through a (fresh) block-table row,
    in place: positions ``[0, n_tokens)`` via ``append_chunk`` in its
    count form, a byte-exact restore.  vals: (Hkv, n_tokens, R)."""
    n = vals.shape[1]
    head = to_device(np.array([0, n], np.int32), pool.device)
    row_t = to_device(np.asarray(row, np.int32), pool.device)
    return append_chunk(pool, row_t[None], head[:1],
                        vals.to(pool.device)[None],
                        head[1:])


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor
                 ) -> torch.Tensor:
    """Each slot's logical cache materialised from its pages: pool
    (P, Hkv, ps, R), block_table (B, n_pages) -> (B, Hkv, n_pages * ps, R).
    The plain path; the kernels read the pages in place instead."""
    g = pool[block_table.long()]                             # (B,n,Hkv,ps,R)
    B, n, Hkv, ps, R = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, n * ps, R)
