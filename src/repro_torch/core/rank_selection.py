"""Rank selection (paper §3.3): re-exported API.

The energy rule lives in ``svd.energy_rank`` and the per-layer choice in
``projections.select_rank``; this module is the stable public surface.
"""
from repro_torch.core.svd import energy_rank
from repro_torch.core.projections import select_rank

__all__ = ["energy_rank", "select_rank"]
