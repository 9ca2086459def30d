"""Compressed-cache attention kernels and their plain PyTorch versions:
K3 over the dense cache, K1 (decode) and K2 (prefill-append) over the
paged cache."""
from repro_torch.kernels.kq_decode.kq_decode import kq_decode_attention
from repro_torch.kernels.kq_decode.paged import (kq_decode_paged_attention,
                                                 kq_prefill_paged_attention)
from repro_torch.kernels.kq_decode.ref import (kq_decode_attention_ref,
                                               kq_decode_paged_attention_ref,
                                               kq_prefill_paged_attention_ref)

__all__ = ["kq_decode_attention", "kq_decode_attention_ref",
           "kq_decode_paged_attention", "kq_decode_paged_attention_ref",
           "kq_prefill_paged_attention", "kq_prefill_paged_attention_ref"]
