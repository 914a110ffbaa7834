"""The block MLP without LayerNorm (CUDA kernel ``ibk_fused_mlp`` in
``csrc/fused_ln_mlp.cu``), forward only.

Counterpart of ``intentbev/ops/fused_mlp.py::_fwd_kernel``, which serves the
block tail when ``use_fused_layernorm`` is off: the caller norms the rows
(plain PyTorch, as the JAX model's FastLayerNorm is XLA) and the kernel
computes

    y = residual + (GELU(h W1 + b1) W2 + b2)

with ``w1`` [hidden, D] and ``w2`` [D, hidden] in PyTorch's Linear layout.
The serving drop-path gate is 1 and is not an argument. Its backward
(``_bwd_kernel``) is not ported yet.
"""

from __future__ import annotations

import torch

from ._build import check_launch, kernels, require, stream_ptr
from .fused_ln_mlp import GELU_MODES, gelu


def fused_mlp_plain(h, w1, b1, w2, b2, residual, gelu_mode: str = "erf"):
    """Plain PyTorch version with the kernel's rounding points: f32 products
    of h and W1 (both in h's dtype), bias and GELU in f32, the hidden
    activation rounded to h's dtype for fc2, then . + b2 + residual in f32,
    rounded once."""
    dt, d = h.dtype, h.shape[-1]
    hf = h.reshape(-1, d).float()
    g = gelu(torch.matmul(hf, w1.to(dt).float().t()) + b1.float(), gelu_mode)
    m = torch.matmul(g.to(dt).float(), w2.to(dt).float().t()) + b2.float()
    return (m + residual.reshape(-1, d).float()).to(dt).reshape(h.shape)


def fused_mlp(h, w1, b1, w2, b2, residual, gelu_mode: str = "erf"):
    """``residual + mlp(h)`` of contiguous bf16 [..., 384] CUDA tensors (f32
    biases, bf16 weights). CPU tensors take :func:`fused_mlp_plain`."""
    if gelu_mode not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu_mode!r} not in {GELU_MODES}")
    if h.device.type == "cpu":
        return fused_mlp_plain(h, w1, b1, w2, b2, residual, gelu_mode)
    d, hidden = h.shape[-1], w1.shape[0]
    require(h.is_cuda and h.dtype == torch.bfloat16 and h.is_contiguous(),
            f"fused_mlp: want contiguous CUDA bf16 h, got {h.dtype} {h.device}")
    require(d == 384, f"fused_mlp kernel is built for D=384, got {d}")
    require(hidden % 64 == 0, f"fused_mlp: hidden {hidden} not a multiple of 64")
    require(residual.shape == h.shape and residual.dtype == h.dtype
            and residual.is_contiguous() and residual.device == h.device,
            "fused_mlp: residual must be contiguous bf16 like h")
    for name, w, shape in (("w1", w1, (hidden, d)), ("w2", w2, (d, hidden))):
        require(w.device == h.device and w.dtype == torch.bfloat16
                and tuple(w.shape) == shape and w.is_contiguous(),
                f"fused_mlp: {name} must be contiguous bf16 {shape}")
    for name, p, n in (("b1", b1, hidden), ("b2", b2, d)):
        require(p.device == h.device and p.dtype == torch.float32
                and tuple(p.shape) == (n,) and p.is_contiguous(),
                f"fused_mlp: {name} must be contiguous f32 [{n}]")
    y = torch.empty_like(h)
    err = kernels().ibk_fused_mlp(
        h.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        residual.data_ptr(), y.data_ptr(), h.numel() // d, hidden,
        GELU_MODES.index(gelu_mode), stream_ptr(h))
    check_launch(err, "fused_mlp")
    return y
