"""Fused LayerNorm + dense [+ GELU] (CUDA kernel ``csrc/fused_ln_dense.cu``),
forward only.

Counterpart of ``intentbev/ops/fused_ln_dense.py``'s forward, behind
``ViTBackboneConfig.fuse_ln_dense``: the qkv projection with norm1 folded
in, ``qkv = LN(x) Wqkv^T + b``, and the stream adapters, ``a = GELU(LN(x)
Wa^T + b)``. ``w`` is PyTorch's Linear layout [Dout, D]; ``gelu_mode`` is
None (no GELU), "erf" or the serving "sigmoid". Its backward
(``_bwd_kernel``) is not ported yet.
"""

from __future__ import annotations

import torch

from ._build import check_launch, kernels, require, stream_ptr
from .fused_ln_mlp import GELU_MODES, gelu
from .layernorm import layernorm_plain


def fused_ln_dense_plain(x, gamma, beta, w, bias, eps: float = 1e-6,
                         gelu_mode: str | None = None):
    """Plain PyTorch version with the kernel's rounding points: LN in f32,
    xn rounded to x's dtype, an f32 product with W in x's dtype, the f32
    bias and GELU, one rounding to x's dtype."""
    dt = x.dtype
    xn = layernorm_plain(x, gamma, beta, eps).float()
    y = torch.matmul(xn, w.to(dt).float().t()) + bias.float()
    if gelu_mode is not None:
        y = gelu(y, gelu_mode)
    return y.to(dt)


def fused_ln_dense(x, gamma, beta, w, bias, eps: float = 1e-6,
                   gelu_mode: str | None = None):
    """[GELU](LN(x) w^T + bias) of a contiguous bf16 [..., 384] CUDA tensor
    (gamma, beta, bias f32; w bf16 [Dout, 384], Dout a multiple of 64) ->
    bf16 [..., Dout]. CPU tensors take :func:`fused_ln_dense_plain`."""
    if gelu_mode is not None and gelu_mode not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu_mode!r} not in (None, *{GELU_MODES})")
    if x.device.type == "cpu":
        return fused_ln_dense_plain(x, gamma, beta, w, bias, eps, gelu_mode)
    d, dout = x.shape[-1], w.shape[0]
    require(x.is_cuda and x.dtype == torch.bfloat16 and x.is_contiguous(),
            f"fused_ln_dense: want contiguous CUDA bf16 x, got {x.dtype} {x.device}")
    require(d == 384, f"fused_ln_dense kernel is built for D=384, got {d}")
    require(dout % 64 == 0 and dout > 0, f"fused_ln_dense: Dout {dout} not a multiple of 64")
    require(w.device == x.device and w.dtype == torch.bfloat16
            and tuple(w.shape) == (dout, d) and w.is_contiguous(),
            f"fused_ln_dense: w must be contiguous bf16 {(dout, d)}")
    for name, p, n in (("gamma", gamma, d), ("beta", beta, d), ("bias", bias, dout)):
        require(p.device == x.device and p.dtype == torch.float32
                and tuple(p.shape) == (n,) and p.is_contiguous(),
                f"fused_ln_dense: {name} must be contiguous f32 [{n}]")
    y = torch.empty(x.shape[:-1] + (dout,), dtype=x.dtype, device=x.device)
    mode = -1 if gelu_mode is None else GELU_MODES.index(gelu_mode)
    err = kernels().ibk_fused_ln_dense(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), bias.data_ptr(),
        y.data_ptr(), x.numel() // d, dout, float(eps), mode, stream_ptr(x))
    check_launch(err, "fused_ln_dense")
    return y
