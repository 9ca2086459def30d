"""Roofline arithmetic of the port on the H100
(``repro_torch.roofline.analysis``, with the collectives a step issues)
and the op cost of its own steps (``repro_torch.roofline.flop_count``)."""
from repro_torch.roofline.analysis import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                           PEAK_FLOPS_F32, CollectiveStats,
                                           Roofline, attn_substitution,
                                           count_collectives,
                                           model_flops_for, packed_pairs,
                                           summarize, useful_bytes_for)
from repro_torch.roofline.flop_count import (CostTotals, LivePeak,
                                             OpCounter, count_flops,
                                             count_step_flops)

__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "PEAK_FLOPS_F32",
           "CollectiveStats", "Roofline", "attn_substitution",
           "count_collectives", "model_flops_for", "packed_pairs",
           "summarize", "useful_bytes_for", "CostTotals", "LivePeak", "OpCounter",
           "count_flops", "count_step_flops"]
