"""The Mamba-2 SSD chunk scan (K7) and its plain PyTorch versions, under
every prefill of an SSM layer, and under autograd
(``ssd_chunk_scan_train``, a plain-PyTorch backward) in its training
forward.  The reference's jit wrapper ``ops.py`` has no counterpart:
PyTorch runs eagerly."""
from repro_torch.kernels.ssd.ref import (ssd_chunk_scan_plain,
                                         ssd_chunk_scan_ref)
from repro_torch.kernels.ssd.ssd import (SSDChunkScan, ssd_chunk_scan,
                                         ssd_chunk_scan_backward,
                                         ssd_chunk_scan_train)

__all__ = ["SSDChunkScan", "ssd_chunk_scan", "ssd_chunk_scan_backward",
           "ssd_chunk_scan_plain", "ssd_chunk_scan_ref",
           "ssd_chunk_scan_train"]
