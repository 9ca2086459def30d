"""Serving-state invariant audits of the paged engine.

Torch counterpart of ``repro.serving.invariants``.  ``audit(engine)``
cross-checks the host bookkeeping the engine's correctness rests on:

* **refcounts**: every physical page's ``PagePool`` refcount equals its
  block-table references (over all slots) plus its prefix-index pins;
* **free list**: no duplicates, never the garbage page, disjoint from
  every referenced page and complete (free and referenced pages partition
  the pool, so ``used_count`` is truthful);
* **block tables**: each slot's row starts with its ``slot_pages`` and is
  garbage past them;
* **slots**: an empty slot holds no pages and no accounting; an occupied
  one owns at most its reserved worst case, a sane private count, and
  pages enough for its decode position or prefill progress;
* **page layout**: every leaf of every layer's paged cache has the pool's
  page axis (``pool.n_pages + 1``, the garbage page included) at 0 and
  the width and dtype the configured page layout declares, so int8 data
  pages and their scale pools cannot drift apart;
* **swap store**: every saved swap state belongs to a pending request.

A violation raises ``InvariantViolation`` with every failed check and a
scheduler dump.  The audit reads host state only (the engine keeps
positions and masks on the host between decode chunks), adds no
host-device sync and never mutates the engine.  ``ServeConfig.audit``
runs it inside ``step()`` every ``audit_every``-th step; the sharded
engine runs it on every worker, then ``audit_sharded`` for what no single
worker can see.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.serving.page_layouts import get_layout
from repro_torch.serving.paged_cache import GARBAGE_PAGE, pages_needed


class InvariantViolation(AssertionError):
    """Engine bookkeeping failed an ``audit`` cross-check."""

    def __init__(self, violations: List[str], dump: str = ""):
        self.violations = list(violations)
        msg = "engine invariant audit failed:\n  - " + "\n  - ".join(
            violations)
        if dump:
            msg += f"\n{dump}"
        super().__init__(msg)


def scheduler_dump(eng) -> str:
    """One-screen scheduler state (carried by every
    ``InvariantViolation`` and ``EngineStalledError``)."""
    lines = [f"step={getattr(eng, '_step_count', '?')} "
             f"pending={[r.rid for r in eng._pending]} "
             f"swapped={len(eng._swapped)}"]
    if eng.pool is not None:
        lines.append(
            f"pool: {eng.pool.used_count}/{eng.pool.n_pages} used, "
            f"{eng.pool.free_count} free"
            + (f", index pins={eng._pindex.n_pinned}"
               if eng._pindex is not None else ""))
    for b in range(eng.sc.max_batch):
        r = eng._slot_req[b]
        if r is None:
            continue
        owned = (len(eng._btabs.slot_pages[b]) if eng._btabs is not None
                 else "-")
        lines.append(
            f"slot {b}: rid={r.rid} pos={int(eng._pos[b])} "
            f"prefilled={eng._prefilled[b]} done={bool(eng._done[b])} "
            f"pages={owned} reserved={eng._reserved[b]} "
            f"charged={eng._charged[b]} private={eng._private[b]}")
    return "\n".join("    " + ln for ln in lines)


def _audit_pool(eng, bad: List[str]) -> None:
    pool, btabs = eng.pool, eng._btabs
    # expected refcounts: block-table ownership plus prefix-index pins
    expect = np.zeros(pool.n_pages + 1, np.int64)
    for b in range(eng.sc.max_batch):
        for p in btabs.slot_pages[b]:
            if p == GARBAGE_PAGE:
                bad.append(f"slot {b} owns the garbage page")
                continue
            if not 1 <= p <= pool.n_pages:
                bad.append(f"slot {b} owns out-of-range page {p}")
                continue
            expect[p] += 1
    if eng._pindex is not None:
        for key, (page, _, _) in eng._pindex._entries.items():
            if not 1 <= page <= pool.n_pages:
                bad.append(f"index entry {key.hex()[:8]} pins "
                           f"out-of-range page {page}")
                continue
            expect[page] += 1
    refs = pool._refs
    mism = np.nonzero(refs[1:] != expect[1:])[0] + 1
    for p in mism[:8]:
        bad.append(f"page {int(p)}: refcount {int(refs[p])} != "
                   f"{int(expect[p])} references "
                   f"(block tables + index pins)")
    if len(mism) > 8:
        bad.append(f"... and {len(mism) - 8} more refcount mismatches")
    free = pool._free
    if len(set(free)) != len(free):
        bad.append("free list contains duplicates")
    if GARBAGE_PAGE in free:
        bad.append("garbage page on the free list")
    freeset = set(free)
    live = {int(p) for p in np.nonzero(refs)[0]}
    overlap = freeset & live
    if overlap:
        bad.append(f"pages both free and referenced: "
                   f"{sorted(overlap)[:8]}")
    leaked = set(range(1, pool.n_pages + 1)) - freeset - live
    if leaked:
        bad.append(f"pages neither free nor referenced (leaked): "
                   f"{sorted(leaked)[:8]}")
    if pool.used_count != len(live):
        bad.append(f"used_count {pool.used_count} != "
                   f"{len(live)} distinct referenced pages")


def _audit_block_tables(eng, bad: List[str]) -> None:
    btabs = eng._btabs
    for b in range(eng.sc.max_batch):
        owned = btabs.slot_pages[b]
        row = btabs.rows[b]
        k = len(owned)
        if list(row[:k]) != list(owned):
            bad.append(f"slot {b}: rows[:{k}] {list(row[:k])} != "
                       f"slot_pages {owned}")
        if np.any(row[k:] != GARBAGE_PAGE):
            bad.append(f"slot {b}: stale row entries past its "
                       f"{k} owned pages")


def _audit_slots(eng, bad: List[str]) -> None:
    sc = eng.sc
    for b in range(sc.max_batch):
        r = eng._slot_req[b]
        owned = len(eng._btabs.slot_pages[b]) if eng._btabs else 0
        if r is None:
            if owned:
                bad.append(f"slot {b}: empty but owns {owned} pages")
            if eng._prefilled[b] is not None:
                bad.append(f"slot {b}: empty but mid-prefill")
            if sc.paged and (eng._reserved[b] or eng._charged[b]
                             or eng._private[b]):
                bad.append(f"slot {b}: empty but reserved/charged/"
                           f"private = {eng._reserved[b]}/"
                           f"{eng._charged[b]}/{eng._private[b]}")
            continue
        if r.done:
            bad.append(f"slot {b}: rid {r.rid} already done but "
                       f"still occupies the slot")
        if not sc.paged:
            continue
        if owned > eng._reserved[b]:
            bad.append(f"slot {b}: owns {owned} pages past its "
                       f"reserved cap {eng._reserved[b]}")
        if not 0 <= eng._private[b] <= owned:
            bad.append(f"slot {b}: private count {eng._private[b]} "
                       f"outside [0, {owned}]")
        pf = eng._prefilled[b]
        if pf is not None:
            if not 0 <= pf <= len(eng._slot_prompt[b]):
                bad.append(f"slot {b}: prefill progress {pf} outside "
                           f"prompt [0, {len(eng._slot_prompt[b])}]")
            if pages_needed(pf, sc.page_size) > owned:
                bad.append(f"slot {b}: prefilled {pf} tokens but owns "
                           f"only {owned} pages")
        elif not eng._done[b]:
            if pages_needed(int(eng._pos[b]), sc.page_size) > owned:
                bad.append(f"slot {b}: pos {int(eng._pos[b])} but owns "
                           f"only {owned} pages")


def _audit_layout(eng, bad: List[str]) -> None:
    """Every leaf of every layer's paged cache against the page layout's
    schema: the same leaf names, the pool's page axis at 0 (the garbage
    page included), the declared width and dtype (the model's cache dtype
    where the layout defers it), so a quantized data page cannot drift out
    of lockstep with its scale pool.  Full-cache pages (no projections)
    hold one fp ``k`` / ``v`` pair and have no layout to check."""
    rk, rv = eng.ranks
    if not rk:
        return
    layout = get_layout(eng.cfg)
    expect = {leaf: (width, dtype)
              for side, rank in (("k", rk), ("v", rv))
              for leaf, width, dtype in layout.leaves(side, rank)}
    n_rows = eng.pool.n_pages + 1
    for i, layer in enumerate(eng._cache):
        tag = f"layer {i}"
        if set(layer) != set(expect):
            bad.append(f"{tag}: cache leaves {sorted(layer)} != layout "
                       f"{layout.name!r} schema {sorted(expect)}")
            continue
        for leaf, t in layer.items():
            width, dtype = expect[leaf]
            dtype = dtype or eng.model.dtype
            if t.shape[0] != n_rows:
                bad.append(f"{tag}/{leaf}: page axis {t.shape[0]} "
                           f"!= pool size {n_rows}")
            if t.shape[-1] != width:
                bad.append(f"{tag}/{leaf}: width {t.shape[-1]} != "
                           f"layout width {width}")
            if t.dtype != dtype:
                bad.append(f"{tag}/{leaf}: dtype {t.dtype} != "
                           f"layout dtype {dtype}")


def _audit_swapped(eng, bad: List[str]) -> None:
    pending_ids = {id(r) for r in eng._pending}
    for key in eng._swapped:
        if key not in pending_ids:
            bad.append(f"swap state {key} has no pending request "
                       f"(leaked host buffer)")


def audit(eng) -> None:
    """Cross-check the engine's serving state; raise
    ``InvariantViolation`` (every failed check and a scheduler dump) on
    any inconsistency.  Safe after any ``step()``."""
    bad: List[str] = []
    if eng.sc.paged and eng.pool is not None:
        _audit_pool(eng, bad)
        _audit_block_tables(eng, bad)
        _audit_layout(eng, bad)
        _audit_swapped(eng, bad)
    _audit_slots(eng, bad)
    if bad:
        raise InvariantViolation(bad, scheduler_dump(eng))


def audit_sharded(eng) -> None:
    """Cross-shard accounting of the data-sharded engine (each worker's
    own state is ``audit``'s):

    * **exclusive ownership**: every live request is owned by exactly one
      shard, its slots and local pending queue disjoint from every other
      shard's;
    * **router/worker disjointness**: the global queue holds no request a
      shard owns (a routed request never reappears upstream);
    * **uniform partitioning**: every shard has the same slot-slice width
      and physical pool size;
    * **slot-axis cover**: the shards' slices tile ``max_batch`` in order;
    * **placement**: every leaf of a worker's cache lives on its device.
    """
    bad: List[str] = []
    owner: Dict[int, int] = {}
    for w in eng.workers:
        owned = [r for r in w._slot_req if r is not None]
        owned += list(w._pending)
        for r in owned:
            prev = owner.get(id(r))
            if prev is not None and prev != w._shard:
                bad.append(f"request rid={r.rid} owned by both shard "
                           f"{prev} and shard {w._shard}")
            owner[id(r)] = w._shard
    for r in eng._pending:
        if id(r) in owner:
            bad.append(f"request rid={r.rid} both in the global queue "
                       f"and owned by shard {owner[id(r)]}")
    widths = {w.sc.max_batch for w in eng.workers}
    if len(widths) != 1:
        bad.append(f"unequal shard slot widths: {sorted(widths)}")
    pools = {w.pool.n_pages for w in eng.workers}
    if len(pools) != 1:
        bad.append(f"unequal shard pool sizes: {sorted(pools)}")
    if sum(w.sc.max_batch for w in eng.workers) != eng.sc.max_batch:
        bad.append(
            f"shard slot slices cover "
            f"{sum(w.sc.max_batch for w in eng.workers)} slots != "
            f"max_batch {eng.sc.max_batch}")
    bases = [w._slots.start for w in eng.workers]
    if bases != sorted(set(bases)) or (bases and bases[0] != 0):
        bad.append(f"shard slot bases not a contiguous tiling: {bases}")
    for w in eng.workers:
        off = {str(t.device) for layer in w._cache for t in layer.values()
               if t.device != w.device}
        if off:
            bad.append(f"shard {w._shard} on {w.device} holds cache "
                       f"leaves on {sorted(off)}")
    if bad:
        dump = "\n".join(f"[shard {s}]\n" + scheduler_dump(w)
                         for s, w in enumerate(eng.workers))
        raise InvariantViolation(bad, dump)


def refcount_histogram(eng) -> Dict[int, int]:
    """refcount -> page count (for tests and the serve CLI)."""
    vals, counts = np.unique(eng.pool._refs[1:], return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}
