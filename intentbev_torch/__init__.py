"""intentbev_torch: the PyTorch + CUDA port of intentbev for NVIDIA Hopper.

A second package beside the JAX reference ``intentbev``. It imports neither
JAX nor any module of ``intentbev``: it carries its own copies of what it
needs, the config dataclasses (``configs``) included. Its hand-written CUDA
kernels (``csrc/*.cu``) are built with nvcc for sm_90a at first CUDA use;
every kernel has a plain PyTorch version beside it, which CPU tensors take.

Slices ported so far: the flagship ViT serving path over the chunk
transport (``parallel.inference.StreamingInferencer``), the ViT training
step (``train.make_train_step``), and the IntentNetCNN family: serving over
the chunk and the points transports, training over both train transports
(the chunk train transport for either family, ``data.pipeline``).
"""
