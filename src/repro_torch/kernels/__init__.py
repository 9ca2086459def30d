"""Hand-written Hopper kernels of the port, each beside its plain version.

kq_decode/  compressed-cache attention, CUDA C++ over one kernel body
            (csrc/kq_attend.cuh):
            K3  decode over the dense cache (csrc/kq_decode.cu), the
                paper's runtime hot spot;
            K1  decode over the paged cache (csrc/kq_paged.cu);
            K4  split-KV decode over the paged cache, with the merge of
                its partials (csrc/kq_paged.cu);
            K5  K1 and K4 over int8 pages with per-token scales
                (csrc/kq_paged.cu);
            K2  chunked prefill-append over the paged cache
                (csrc/kq_paged.cu)
flash/      K6  causal GQA flash attention with an optional sliding
                window (csrc/flash.cu), under every exact-length prefill
                and calibration batch
ssd/        K7  the Mamba-2 SSD chunk scan with an initial and a final
                state (csrc/ssd.cu), under every prefill of an SSM layer

``build`` compiles the CUDA sources with ``nvcc`` at first use; importing
this package builds nothing.
"""
