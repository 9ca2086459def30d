"""Hand-written Hopper kernels of the port, each beside its plain version.

kq_decode/  K3: decode attention over the KQ-SVD-compressed dense cache
            (CUDA C++ in csrc/kq_decode.cu), the paper's runtime hot spot

``build`` compiles the CUDA sources with ``nvcc`` at first use; importing
this package builds nothing.
"""
