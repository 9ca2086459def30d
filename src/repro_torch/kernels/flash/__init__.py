"""Flash attention (K6) and its plain PyTorch version: causal GQA
attention with an optional sliding window, under every exact-length
prefill and calibration batch of the port, and under autograd
(``flash_attention_train``, a plain-PyTorch backward) in every training
step."""
from repro_torch.kernels.flash.flash import (FlashAttention, flash_attention,
                                             flash_attention_backward,
                                             flash_attention_train)
from repro_torch.kernels.flash.ref import flash_attention_ref

__all__ = ["FlashAttention", "flash_attention", "flash_attention_backward",
           "flash_attention_ref", "flash_attention_train"]
