"""The W8A8 serving MLP (CUDA kernel ``csrc/fused_mlp_int8.cu``), forward
only.

Counterpart of ``intentbev/ops/fused_mlp_int8.py`` behind
``ViTBackboneConfig.serving_int8``: per-row int8 codes of the input, int8
products with the per-output-channel weight codes, f32 rescale, bias and
GELU, per-row int8 codes of the hidden activation, the second int8 product
and rescale, and the residual:

    y = residual + (q(GELU(q(x) W1q^T * xs * s1 + b1)) W2q^T * hs * s2 + b2)

The weight codes ``w1q`` [hidden, D] and ``w2q`` [D, hidden] (int8, rows of
PyTorch's [out, in] layout) and their f32 scales come from
:func:`intentbev_torch.ops.int8.quantize_linear` of the f32 parameters,
once, at load (the JAX wrapper quantizes the same parameters on every
call). The serving gate is 1 and is not an argument.
"""

from __future__ import annotations

import torch

from ._build import check_launch, kernels, require, stream_ptr
from .fused_ln_mlp import GELU_MODES, gelu
from .int8 import int_matmul, quantize_rows

VIT_B_WIDTHS = (768, 384, 192)  # the model widths the kernel is built for
HIDDEN_STEP = 128  # the hidden width is a multiple of two of its 64-wide tiles


def fused_mlp_int8_plain(x, w1q, s1, b1, w2q, s2, b2, residual, gelu_mode: str = "erf"):
    """Plain PyTorch version with the kernel's rounding points: the codes
    of :func:`quantize_rows` (x / scale, round half to even), exact integer
    products (float64), the rescale in the JAX order (acc * xs) * s1 + b1
    in f32, and y + residual in f32, rounded once to x's dtype."""
    dt, d = x.dtype, x.shape[-1]
    xq, xs = quantize_rows(x.reshape(-1, d))
    g = int_matmul(xq, w1q.t()) * xs * s1.float() + b1.float()
    hq, hs = quantize_rows(gelu(g, gelu_mode))
    y = int_matmul(hq, w2q.t()) * hs * s2.float() + b2.float()
    return (y + residual.reshape(-1, d).float()).to(dt).reshape(x.shape)


def fused_mlp_int8(x, w1q, s1, b1, w2q, s2, b2, residual, gelu_mode: str = "erf"):
    """W8A8 ``residual + mlp(x)`` of contiguous bf16 [..., D] CUDA tensors,
    D in :data:`VIT_B_WIDTHS` and the hidden width a multiple of ``HIDDEN_STEP`` (int8
    codes, f32 scales and biases). CPU tensors take
    :func:`fused_mlp_int8_plain`."""
    if gelu_mode not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu_mode!r} not in {GELU_MODES}")
    if x.device.type == "cpu":
        return fused_mlp_int8_plain(x, w1q, s1, b1, w2q, s2, b2, residual, gelu_mode)
    d, hidden = x.shape[-1], w1q.shape[0]
    require(x.is_cuda and x.dtype == torch.bfloat16 and x.is_contiguous(),
            f"fused_mlp_int8: want contiguous CUDA bf16 x, got {x.dtype} {x.device}")
    require(d in VIT_B_WIDTHS,
            f"fused_mlp_int8 kernel is built for D in {VIT_B_WIDTHS}, got {d}")
    require(hidden > 0 and hidden % HIDDEN_STEP == 0,
            f"fused_mlp_int8: hidden {hidden} not a multiple of {HIDDEN_STEP}")
    require(residual.shape == x.shape and residual.dtype == x.dtype
            and residual.is_contiguous() and residual.device == x.device,
            "fused_mlp_int8: residual must be contiguous bf16 like x")
    for name, w, shape in (("w1q", w1q, (hidden, d)), ("w2q", w2q, (d, hidden))):
        require(w.device == x.device and w.dtype == torch.int8
                and tuple(w.shape) == shape and w.is_contiguous(),
                f"fused_mlp_int8: {name} must be contiguous int8 {shape}")
    for name, p, n in (("s1", s1, hidden), ("b1", b1, hidden), ("s2", s2, d), ("b2", b2, d)):
        require(p.device == x.device and p.dtype == torch.float32
                and tuple(p.shape) == (n,) and p.is_contiguous(),
                f"fused_mlp_int8: {name} must be contiguous f32 [{n}]")
    require(all(t.data_ptr() % 16 == 0 for t in (x, residual, w1q, w2q, s1, b1, s2, b2)),
            "fused_mlp_int8: every tensor must be 16-byte aligned (TMA and bulk copies)")
    y = torch.empty_like(x)
    err = kernels().ibk_fused_mlp_int8(
        x.data_ptr(), w1q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
        s2.data_ptr(), b2.data_ptr(), residual.data_ptr(), y.data_ptr(), x.numel() // d, d,
        hidden, GELU_MODES.index(gelu_mode), stream_ptr(x))
    check_launch(err, "fused_mlp_int8")
    return y
