"""intentbev_torch: the PyTorch + CUDA port of intentbev for NVIDIA Hopper.

A second package beside the JAX reference ``intentbev``. It reuses
``intentbev.configs`` (pure dataclasses) and imports neither JAX nor any
other module of ``intentbev``. Its hand-written CUDA kernels
(``csrc/*.cu``) are built with nvcc for sm_90a at first CUDA use; every
kernel has a plain PyTorch version beside it, which CPU tensors take.

Slice ported so far: the flagship ViT serving path over the chunk
transport (``parallel.inference.StreamingInferencer``).
"""
