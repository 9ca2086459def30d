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

``PagePool``, ``pages_needed`` and ``BlockTables`` are host state (numpy);
``append_token``, ``append_chunk`` and ``gather_pages`` work on torch
tensors and write the pools in place (the reference returns new arrays).
The prefix index and the page copy / swap primitives belong to prefix
sharing and preemption, which this slice of the port does not have yet.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
    deficit."""

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
        (allocating none) if fewer than ``n`` are free."""
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
        # every step; they change only on assign / release, so the
        # upload is skipped unless the rows or the mask moved
        self._dev_cache: Optional[Tuple[Optional[bytes], torch.Tensor]] = None

    def assign(self, slot: int, pages: Sequence[int], start: int = 0
               ) -> None:
        """Append ``pages`` to ``slot`` from logical page ``start`` (==
        pages already owned)."""
        assert start == len(self.slot_pages[slot])
        self.rows[slot, start: start + len(pages)] = pages
        self.slot_pages[slot].extend(pages)
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


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor
                 ) -> torch.Tensor:
    """Each slot's logical cache materialised from its pages: pool
    (P, Hkv, ps, R), block_table (B, n_pages) -> (B, Hkv, n_pages * ps, R).
    The plain path; the kernels read the pages in place instead."""
    g = pool[block_table.long()]                             # (B,n,Hkv,ps,R)
    B, n, Hkv, ps, R = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, n * ps, R)
