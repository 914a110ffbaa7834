"""Row LayerNorm for inference (CUDA kernel ``csrc/layernorm.cu``).

Counterpart of ``intentbev/ops/layernorm.py`` (``fused_layernorm`` on the
inference path): statistics in f32, output in the input's dtype. Any number
of rows; no padding.
"""

from __future__ import annotations

import torch

from ._build import check_launch, kernels, require, stream_ptr


def layernorm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: LN over the last axis with f32 statistics,
    y = (x - mean) * rsqrt(var + eps) * gamma + beta computed in f32 and
    rounded once to x's dtype (the JAX kernel's rounding points)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return (xc * inv * gamma.float() + beta.float()).to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of a contiguous [..., 384] bf16 tensor;
    gamma/beta f32 [384]. CPU tensors take :func:`layernorm_plain`."""
    if x.device.type == "cpu":
        return layernorm_plain(x, gamma, beta, eps)
    d = x.shape[-1]
    require(x.is_cuda and x.dtype == torch.bfloat16 and x.is_contiguous(),
            f"layernorm: want contiguous CUDA bf16, got {x.dtype} {x.device}")
    require(d == 384, f"layernorm kernel is built for D=384, got {d}")
    for p in (gamma, beta):
        require(p.device == x.device and p.dtype == torch.float32
                and p.shape == (d,) and p.is_contiguous(),
                "layernorm: gamma/beta must be contiguous f32 [D] on x's device")
    y = torch.empty_like(x)
    err = kernels().ibk_layernorm(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        x.numel() // d, float(eps), stream_ptr(x))
    check_launch(err, "layernorm")
    return y
