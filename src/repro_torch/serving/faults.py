"""Deterministic fault injection and swap verification for the paged
serving engine.

Torch counterpart of ``repro.serving.faults`` (numpy only, as there).  A
``FaultInjector`` owns a set of named fault points, places in the engine
and page store where rare production failures can be forced on demand:

=================  ======================================================
point              effect when it fires
=================  ======================================================
``page_alloc``     ``PagePool.alloc`` raises ``PagePoolExhausted`` though
                   pages are free (an exhaustion race)
``copy_page``      the copy-on-write fork in ``engine._cow_fork`` fails
                   its page allocation (pool dry at fork time)
``swap_out``       a swap-out raises ``SwapFailed`` (the host buffer
                   could not be written); the victim recomputes
``swap_in``        a swap-in raises ``SwapFailed`` (the host buffer
                   could not be read back)
``swap_corrupt``   the swapped host buffer is bit-flipped after its crc
                   was taken: swap-in detects the mismatch and degrades
                   to recompute
``prefix_reclaim`` ``PrefixIndex.reclaim`` reclaims nothing this pass
``prefill_delay``  a slot's prefill chunk is skipped this step
``nan_logits``     the lowest live slot's next-token logits are poisoned
                   with NaN after the decode chunk
=================  ======================================================

Every point but ``nan_logits`` is recoverable: the engine degrades (retry
with backoff, preempt-and-requeue, swap to recompute) and greedy tokens
do not change.  ``nan_logits`` is terminal for the poisoned request (the
numerics guard fails it with kind ``numerics``), so ``FaultInjector.chaos``
leaves it out.

Schedules are deterministic: each point has its own hit counter and its
own seeded stream, ``numpy.random.default_rng((seed, crc32(point)))``,
drawn once per hit, so the firings at one point do not depend on traffic
at another and equal the reference's for the same hits.  A trigger is
``nth`` (fire on that hit, 1-based) or ``prob`` (a Bernoulli draw per
hit); ``times`` caps a spec's firings (None = unlimited).

A swapped-out slot's host buffers carry a crc32 (``checksum``) taken when
they were written; swap-in checks it again before restoring, so a
corrupted buffer degrades to recompute (or fails the request, per
``ServeConfig.swap_fallback``) instead of resuming from garbage.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

FAULT_POINTS = (
    "page_alloc",
    "copy_page",
    "swap_out",
    "swap_in",
    "swap_corrupt",
    "prefix_reclaim",
    "prefill_delay",
    "nan_logits",
)

# the points the engine recovers from with unchanged greedy tokens
RECOVERABLE_POINTS = tuple(p for p in FAULT_POINTS if p != "nan_logits")


class SwapFailed(RuntimeError):
    """A host-RAM swap could not complete (or failed verification)."""


@dataclasses.dataclass
class FaultSpec:
    """One trigger rule at one fault point: exactly one of ``nth`` (fire
    on that hit, 1-based) or ``prob`` (a Bernoulli draw per hit);
    ``times`` caps its firings (None = unlimited)."""

    point: str
    nth: Optional[int] = None
    prob: Optional[float] = None
    times: Optional[int] = 1
    fired: int = 0

    def __post_init__(self) -> None:
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r} "
                f"(known: {FAULT_POINTS})")
        if (self.nth is None) == (self.prob is None):
            raise ValueError("set exactly one of nth= or prob=")
        if self.nth is not None and self.nth < 1:
            raise ValueError("nth is 1-based")
        if self.prob is not None and not 0.0 <= self.prob <= 1.0:
            raise ValueError("prob must be in [0, 1]")


class FaultInjector:
    """Seeded fault scheduler, deterministic per point.

    ``fires(point)`` registers one hit and says whether a spec triggers;
    ``fired_log`` records every firing as ``(point, hit)`` and
    ``points_fired()`` the distinct points that fired, in order."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._hits: Dict[str, int] = {}
        self._rng: Dict[str, np.random.Generator] = {}
        self.fired_log: List[Tuple[str, int]] = []

    def add(self, point: str, nth: Optional[int] = None,
            prob: Optional[float] = None,
            times: Optional[int] = 1) -> "FaultInjector":
        """Arm ``point`` on its ``nth`` hit or with per-hit probability
        ``prob``, at most ``times`` times.  Chainable."""
        spec = FaultSpec(point, nth=nth, prob=prob, times=times)
        self._specs.setdefault(spec.point, []).append(spec)
        return self

    @classmethod
    def chaos(cls, seed: int, rate: float = 0.05,
              points: Tuple[str, ...] = RECOVERABLE_POINTS
              ) -> "FaultInjector":
        """Every recoverable point armed with an unlimited per-hit
        probability ``rate``: what ``ServeConfig.chaos_seed`` builds."""
        inj = cls(seed)
        for p in points:
            inj.add(p, prob=rate, times=None)
        return inj

    def _stream(self, point: str) -> np.random.Generator:
        rng = self._rng.get(point)
        if rng is None:
            rng = np.random.default_rng((self.seed,
                                         zlib.crc32(point.encode())))
            self._rng[point] = rng
        return rng

    def hits(self, point: str) -> int:
        """How many times ``point`` has been reached so far."""
        return self._hits.get(point, 0)

    def fires(self, point: str) -> bool:
        """Register one hit at ``point``; True if any spec triggers.  The
        point's stream is drawn once per hit whenever a probabilistic spec
        is armed there, even one whose ``times`` is spent, so later draws
        stay aligned across schedules."""
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}")
        hit = self._hits.get(point, 0) + 1
        self._hits[point] = hit
        specs = self._specs.get(point, ())
        draw = None
        if any(s.prob is not None for s in specs):
            draw = float(self._stream(point).random())
        fired = False
        for s in specs:
            if s.times is not None and s.fired >= s.times:
                continue
            if s.nth is not None:
                if hit != s.nth:
                    continue
            elif draw is None or draw >= s.prob:
                continue
            s.fired += 1
            fired = True
        if fired:
            self.fired_log.append((point, hit))
        return fired

    def corrupt(self, point: str, buf):
        """A copy of ``buf`` (a numpy array or a CPU tensor) with one byte
        flipped, chosen by ``point``'s stream (the ``swap_corrupt`` fault,
        after the crc was taken)."""
        if isinstance(buf, torch.Tensor):
            flat = buf.contiguous().reshape(-1).view(torch.uint8).clone()
            idx = int(self._stream(point).integers(flat.numel()))
            flat[idx] ^= 0xFF
            return flat.view(buf.dtype).reshape(buf.shape)
        flat = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
        idx = int(self._stream(point).integers(flat.size))
        out = flat.copy()
        out[idx] ^= 0xFF
        return out.view(buf.dtype).reshape(buf.shape)

    def points_fired(self) -> Tuple[str, ...]:
        """Distinct points that fired at least once (coverage)."""
        seen: List[str] = []
        for p, _ in self.fired_log:
            if p not in seen:
                seen.append(p)
        return tuple(seen)


def _leaves(tree):
    """Leaves in a fixed order: lists and tuples in order, dicts by sorted
    key (the order ``jax.tree.leaves`` gives the reference's buffers)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def checksum(bufs) -> int:
    """crc32 over nested lists / dicts of host buffers (CPU tensors or
    numpy arrays), their bytes in a fixed leaf order."""
    crc = 0
    for leaf in _leaves(bufs):
        t = torch.as_tensor(leaf).contiguous().reshape(-1)
        crc = zlib.crc32(t.view(torch.uint8).numpy().tobytes(), crc)
    return crc
