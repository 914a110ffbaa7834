"""Fused LayerNorm + MLP block tail with the serving LN epilogue
(CUDA kernel ``csrc/fused_ln_mlp.cu``).

Counterpart of ``intentbev/ops/fused_ln_mlp.py::fused_ln_mlp(...,
ln_out=...)``:

    y  = x + GELU(LN(x) * g + b) W1 + b1) W2 + b2
    yn = LN(y) * g_next + b_next        (from the f32 y)

Weights use PyTorch's Linear layout: ``w1`` [hidden, D], ``w2`` [D, hidden].
The serving drop-path gate is 1 and is not an argument. ``gelu`` is
``"erf"`` (exact; the JAX package's default) or ``"sigmoid"``
(x * sigmoid(1.702 x), the serving variant ``bench.py`` selects).
"""

from __future__ import annotations

import torch

from ._build import check_launch, kernels, require, stream_ptr
from .layernorm import layernorm_plain

GELU_MODES = ("erf", "sigmoid")


def gelu(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "erf":
        return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))
    if mode == "sigmoid":
        return x / (1.0 + torch.exp(-1.702 * x))
    raise ValueError(f"gelu mode {mode!r} not in {GELU_MODES}")


def fused_ln_mlp_plain(x, gamma, beta, w1, b1, w2, b2, gamma_next, beta_next,
                       eps: float = 1e-6, gelu_mode: str = "erf"):
    """Plain PyTorch version with the kernel's rounding points: LN in f32,
    xn rounded to x's dtype for fc1, f32 products and hidden + GELU, h
    rounded to x's dtype for fc2, f32 residual sum; y and LN_next(y) from
    the f32 y, each rounded once."""
    dt = x.dtype
    xf = x.float()
    xn = layernorm_plain(xf, gamma, beta, eps).to(dt).float()
    h = gelu(torch.matmul(xn, w1.to(dt).float().t()) + b1.float(), gelu_mode)
    y = torch.matmul(h.to(dt).float(), w2.to(dt).float().t()) + b2.float() + xf
    return y.to(dt), layernorm_plain(y, gamma_next, beta_next, eps).to(dt)


def fused_ln_mlp(x, gamma, beta, w1, b1, w2, b2, gamma_next, beta_next,
                 eps: float = 1e-6, gelu_mode: str = "erf"):
    """Returns ``(y, yn)`` for a contiguous bf16 [..., 384] CUDA tensor (f32
    LN params and biases, bf16 weights). CPU tensors take
    :func:`fused_ln_mlp_plain`."""
    if gelu_mode not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu_mode!r} not in {GELU_MODES}")
    if x.device.type == "cpu":
        return fused_ln_mlp_plain(x, gamma, beta, w1, b1, w2, b2, gamma_next,
                                  beta_next, eps, gelu_mode)
    d = x.shape[-1]
    hidden = w1.shape[0]
    require(x.is_cuda and x.dtype == torch.bfloat16 and x.is_contiguous(),
            f"fused_ln_mlp: want contiguous CUDA bf16 x, got {x.dtype} {x.device}")
    require(d == 384, f"fused_ln_mlp kernel is built for D=384, got {d}")
    require(hidden % 64 == 0, f"fused_ln_mlp: hidden {hidden} not a multiple of 64")
    for name, w, shape in (("w1", w1, (hidden, d)), ("w2", w2, (d, hidden))):
        require(w.device == x.device and w.dtype == torch.bfloat16
                and tuple(w.shape) == shape and w.is_contiguous(),
                f"fused_ln_mlp: {name} must be contiguous bf16 {shape}")
    for name, p, n in (("gamma", gamma, d), ("beta", beta, d), ("b1", b1, hidden),
                       ("b2", b2, d), ("gamma_next", gamma_next, d),
                       ("beta_next", beta_next, d)):
        require(p.device == x.device and p.dtype == torch.float32
                and tuple(p.shape) == (n,) and p.is_contiguous(),
                f"fused_ln_mlp: {name} must be contiguous f32 [{n}]")
    y = torch.empty_like(x)
    yn = torch.empty_like(x)
    err = kernels().ibk_fused_ln_mlp(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma_next.data_ptr(),
        beta_next.data_ptr(), y.data_ptr(), yn.data_ptr(), x.numel() // d,
        hidden, float(eps), GELU_MODES.index(gelu_mode), stream_ptr(x))
    check_launch(err, "fused_ln_mlp")
    return y, yn
