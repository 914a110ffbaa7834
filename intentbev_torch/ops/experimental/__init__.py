"""Library ops that the model does not call, each with a hand-written
Hopper kernel and its plain PyTorch version.

Counterpart of ``intentbev/ops/experimental/``, whose ops the JAX model
does not call either (its attention stays bf16 under ``serving_int8``; its
out-projection is a plain Dense, gate and residual):

- :func:`flash_attention_packed_int8` (``csrc/flash_int8.cu``): int8
  attention over packed [B, T, H*D] tensors, forward only, head dims 16 to
  128 in bf16 or f32. On an H100 80GB HBM3 (700 W) at [8, 4608, 384] with
  4501 real keys it takes ~1.15 ms at 6 heads of 64 against ~0.71 ms for
  the bf16 packed forward (safe form), and ~1.97 ms at 12 heads of 32
  against ~0.98: the per-score softmax work, not the integer products,
  bounds it.
- :func:`fused_dense_residual` (``csrc/fused_proj.cu``): ``gate * (x W +
  b) + residual`` and its backward. On the same card at [36864, 384] x
  [384, 384] the forward takes 0.080 ms against 0.103 ms for the unfused
  Linear, gate and residual (cuBLAS's ``addmm`` alone 0.068), and the
  backward 0.387 ms against 0.156 ms for the unfused path's kernels, most
  of it the split-K weight-gradient GEMM.

``chip_smoke.py`` (phase 13) measures these; ``PERF.md`` (section 6, rows
18 and 19) has them beside the bounds and the plain versions' times.
"""

from .flash_int8 import flash_attention_packed_int8, flash_attention_packed_int8_plain
from .fused_proj import (fused_dense_residual, fused_proj_bwd, fused_proj_bwd_plain,
                         fused_proj_fwd, fused_proj_fwd_plain)

__all__ = [
    "flash_attention_packed_int8", "flash_attention_packed_int8_plain",
    "fused_dense_residual", "fused_proj_fwd", "fused_proj_fwd_plain", "fused_proj_bwd",
    "fused_proj_bwd_plain",
]
