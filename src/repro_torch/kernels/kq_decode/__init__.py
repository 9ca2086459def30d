"""K3, compressed-cache decode attention: the kernel's wrapper and its
plain PyTorch version."""
from repro_torch.kernels.kq_decode.kq_decode import kq_decode_attention
from repro_torch.kernels.kq_decode.ref import kq_decode_attention_ref

__all__ = ["kq_decode_attention", "kq_decode_attention_ref"]
