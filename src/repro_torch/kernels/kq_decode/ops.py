"""Split-count heuristic of the split-KV paged decode (K4, K5), the
port's copy of ``repro.kernels.kq_decode.ops.default_decode_splits``."""
from __future__ import annotations


def default_decode_splits(max_len: int, page_size: int, *,
                          max_splits: int = 8,
                          min_pages_per_split: int = 4) -> int:
    """One split per ``min_pages_per_split`` pages of
    ``ceil(max_len / page_size)``, capped at ``max_splits``.

    Chains shorter than ``2 * min_pages_per_split`` pages get 1 (the
    unsplit kernel): the partials and their merge pay only when a span is
    long enough to keep a block busy.  Monotone in ``max_len``."""
    pages = -(-max(1, int(max_len)) // max(1, int(page_size)))
    return max(1, min(int(max_splits), pages // int(min_pages_per_split)))
