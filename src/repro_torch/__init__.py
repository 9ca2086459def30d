"""PyTorch/CUDA port of the KQ-SVD system, for one NVIDIA Hopper GPU.

A package of its own beside the JAX reference ``repro``: it imports
torch and numpy and nothing of ``repro`` or ``jax``, keeping its own
copies of the framework-free configs, data sampler and numpy solvers.
Entry points (``models.LM``, ``serving.ServingEngine``,
``python -m repro_torch.launch.serve``) run on ``torch.device("cuda")``
unless the caller passes a CPU device; the hand-written kernels under
``kernels/`` are built with ``nvcc`` at first use.
"""
