"""Compressed-cache attention kernels and their plain PyTorch versions:
K3 over the dense cache; over the paged cache K1 (decode), K4 (split-KV
decode) with the split merge, K5 (decode over int8 pages, unsplit and
split) and K2 (prefill-append)."""
from repro_torch.kernels.kq_decode.kq_decode import kq_decode_attention
from repro_torch.kernels.kq_decode.ops import default_decode_splits
from repro_torch.kernels.kq_decode.paged import (combine_split_partials,
                                                 kq_combine_splits,
                                                 kq_decode_paged_attention,
                                                 kq_decode_paged_int8,
                                                 kq_decode_paged_int8_split,
                                                 kq_decode_paged_split,
                                                 kq_prefill_paged_attention)
from repro_torch.kernels.kq_decode.ref import (
    kq_decode_attention_ref, kq_decode_paged_attention_int8_ref,
    kq_decode_paged_attention_ref, kq_decode_paged_attention_split_ref,
    kq_decode_paged_partials_ref, kq_prefill_paged_attention_ref,
    resolve_splits)

__all__ = ["combine_split_partials", "default_decode_splits",
           "kq_combine_splits", "kq_decode_attention",
           "kq_decode_attention_ref", "kq_decode_paged_attention",
           "kq_decode_paged_attention_int8_ref",
           "kq_decode_paged_attention_ref",
           "kq_decode_paged_attention_split_ref", "kq_decode_paged_int8",
           "kq_decode_paged_int8_split", "kq_decode_paged_partials_ref",
           "kq_decode_paged_split", "kq_prefill_paged_attention",
           "kq_prefill_paged_attention_ref", "resolve_splits"]
