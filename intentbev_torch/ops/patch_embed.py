"""Patch embed of a dense NHWC BEV (CUDA kernel ``csrc/patch_embed.cu``),
forward only.

Counterpart of ``intentbev/ops/patch_embed.py::patch_embed_matmul``, behind
``ViTBackboneConfig.fuse_patch_embed`` for dense inputs of at least 128
channels: tokens = conv_PxP,sP(x) + bias over x [B, H, W, C] with the conv
kernel in the JAX layout [P, P, C, D], tokens [B, (H/P)*(W/P), D] in
row-major patch order, in x's dtype. The kernel is built for the model
widths D in ``layernorm.VIT_B_WIDTHS`` (768, 384 and 192).
"""

from __future__ import annotations

import torch

from ._build import check_launch, kernels, require, stream_ptr
from .layernorm import VIT_B_WIDTHS

MAX_TOKENS_PER_ROW = 96  # the kernel's TMA box of one patch row's tokens


def patch_embed_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                      patch: int) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points: patches as
    rows of P*P*C values (dy, dx, c), one f32 product with the kernel in
    x's dtype, the f32 bias, one rounding to x's dtype."""
    b, h, w, c = x.shape
    p, d = patch, kernel.shape[-1]
    xp = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    xp = xp.reshape(b, (h // p) * (w // p), p * p * c)
    y = torch.matmul(xp.float(), kernel.to(x.dtype).reshape(p * p * c, d).float())
    return (y + bias.float()).to(x.dtype)


def patch_embed(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                patch: int) -> torch.Tensor:
    """Tokens of a contiguous bf16 NHWC CUDA BEV (kernel bf16 [P, P, C, D],
    D in ``layernorm.VIT_B_WIDTHS``; bias f32 [D]; W/P <= 96 and P*C a multiple of
    8). CPU tensors take :func:`patch_embed_plain`."""
    if x.device.type == "cpu":
        return patch_embed_plain(x, kernel, bias, patch)
    b, h, w, c = x.shape
    p, d = patch, kernel.shape[-1]
    require(x.is_cuda and x.dtype == torch.bfloat16 and x.is_contiguous()
            and x.data_ptr() % 16 == 0,
            f"patch_embed: want contiguous 16-byte aligned CUDA bf16 x, got {x.dtype} {x.device}")
    require(h % p == 0 and w % p == 0, f"patch_embed: grid {h}x{w} not divisible by {p}")
    require(w // p <= MAX_TOKENS_PER_ROW,
            f"patch_embed: {w // p} tokens a patch row > {MAX_TOKENS_PER_ROW}")
    require((p * c) % 8 == 0, f"patch_embed: P*C = {p * c} not a multiple of 8")
    require(d in VIT_B_WIDTHS, f"patch_embed kernel is built for D in {VIT_B_WIDTHS}, got {d}")
    require(kernel.device == x.device and kernel.dtype == torch.bfloat16
            and tuple(kernel.shape) == (p, p, c, d) and kernel.is_contiguous(),
            f"patch_embed: kernel must be contiguous bf16 {(p, p, c, d)}")
    require(bias.device == x.device and bias.dtype == torch.float32
            and tuple(bias.shape) == (d,) and bias.is_contiguous(),
            f"patch_embed: bias must be contiguous f32 [{d}]")
    out = torch.empty(b, (h // p) * (w // p), d, dtype=x.dtype, device=x.device)
    err = kernels().ibk_patch_embed(
        x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w, c, d, p,
        stream_ptr(x))
    check_launch(err, "patch_embed")
    return out
