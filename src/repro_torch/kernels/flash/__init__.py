"""Flash attention (K6) and its plain PyTorch version: causal GQA
attention with an optional sliding window, under every exact-length
prefill and calibration batch of the port."""
from repro_torch.kernels.flash.flash import flash_attention
from repro_torch.kernels.flash.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref"]
