"""Row LayerNorm (CUDA kernels ``csrc/layernorm.cu``): inference, training
forward and backward.

Counterpart of ``intentbev/ops/layernorm.py``: statistics in f32, outputs
in the input's dtype. :func:`layernorm_fn` is the differentiable entry, the
dispatch of the JAX ``custom_vjp``: a call that needs no gradient takes the
inference kernel; otherwise the training forward (y, xhat, inv) runs and the
backward kernel gives dx and the dgamma/dbeta column sums. Any number of
rows; no padding. The kernels are built for the widths in :data:`WIDTHS`
(ViT-S 384, ViT-Ti 192); any other width raises on CUDA.
"""

from __future__ import annotations

import torch

from ._build import check_launch, kernels, require, stream_ptr

WIDTHS = (192, 384)  # widths the kernels are instantiated for


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


def layernorm_train_plain(x, gamma, beta, eps: float = 1e-6):
    """Plain training forward: ``(y, xhat, inv)``, y and xhat in x's dtype,
    inv f32 of shape x.shape[:-1]."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * inv
    y = xhat * gamma.float() + beta.float()
    return y.to(x.dtype), xhat.to(x.dtype), inv[..., 0]


def layernorm_bwd_plain(dy, xhat, inv, gamma):
    """Plain backward from the saved xhat and inv: ``(dx in dy's dtype,
    dgamma f32, dbeta f32)``,
    dx = inv * (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat))."""
    d = dy.shape[-1]
    dyf = dy.reshape(-1, d).float()
    xh = xhat.reshape(-1, d).float()
    dyg = dyf * gamma.float()
    m1 = dyg.mean(-1, keepdim=True)
    m2 = (dyg * xh).mean(-1, keepdim=True)
    dx = inv.reshape(-1, 1).float() * (dyg - m1 - xh * m2)
    return (dx.to(dy.dtype).reshape(dy.shape), (dyf * xh).sum(0), dyf.sum(0))


def _check_params(x, name, *params):
    for p in params:
        require(p.device == x.device and p.dtype == torch.float32
                and p.shape == (x.shape[-1],) and p.is_contiguous(),
                f"{name}: gamma/beta must be contiguous f32 [D] on x's device")


def _check_rows(x, name):
    require(x.is_cuda and x.dtype == torch.bfloat16 and x.is_contiguous(),
            f"{name}: want contiguous CUDA bf16, got {x.dtype} {x.device}")
    require(x.shape[-1] in WIDTHS,
            f"{name} kernel is built for D in {WIDTHS}, got {x.shape[-1]}")


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of a contiguous [..., D] bf16 tensor, D in
    :data:`WIDTHS`; gamma/beta f32 [D]. CPU tensors take
    :func:`layernorm_plain`."""
    if x.device.type == "cpu":
        return layernorm_plain(x, gamma, beta, eps)
    _check_rows(x, "layernorm")
    _check_params(x, "layernorm", gamma, beta)
    d = x.shape[-1]
    y = torch.empty_like(x)
    err = kernels().ibk_layernorm(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        x.numel() // d, d, float(eps), stream_ptr(x))
    check_launch(err, "layernorm")
    return y


def layernorm_train(x, gamma, beta, eps: float = 1e-6):
    """Training forward, ``(y, xhat, inv)``, of a contiguous [..., D] bf16
    CUDA tensor. CPU tensors take :func:`layernorm_train_plain`."""
    if x.device.type == "cpu":
        return layernorm_train_plain(x, gamma, beta, eps)
    _check_rows(x, "layernorm_train")
    _check_params(x, "layernorm_train", gamma, beta)
    y, xhat = torch.empty_like(x), torch.empty_like(x)
    inv = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    err = kernels().ibk_layernorm_train(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), xhat.data_ptr(),
        inv.data_ptr(), x.numel() // x.shape[-1], x.shape[-1], float(eps), stream_ptr(x))
    check_launch(err, "layernorm_train")
    return y, xhat, inv


def layernorm_bwd(dy, xhat, inv, gamma):
    """Backward kernel: ``(dx bf16, dgamma f32, dbeta f32)``. CPU tensors take
    :func:`layernorm_bwd_plain`."""
    if dy.device.type == "cpu":
        return layernorm_bwd_plain(dy, xhat, inv, gamma)
    _check_rows(dy, "layernorm_bwd")
    require(xhat.shape == dy.shape and xhat.dtype == torch.bfloat16
            and xhat.is_contiguous() and xhat.device == dy.device,
            "layernorm_bwd: xhat must be contiguous bf16 of dy's shape")
    d = dy.shape[-1]
    n = dy.numel() // d
    require(inv.dtype == torch.float32 and inv.numel() == n and inv.is_contiguous()
            and inv.device == dy.device, "layernorm_bwd: inv must be contiguous f32 [rows]")
    _check_params(dy, "layernorm_bwd", gamma)
    dx = torch.empty_like(dy)
    dgamma = torch.zeros(d, dtype=torch.float32, device=dy.device)
    dbeta = torch.zeros_like(dgamma)
    part = torch.empty(2 * ((n + 63) // 64) * d, dtype=torch.float32, device=dy.device)
    err = kernels().ibk_layernorm_bwd(
        dy.data_ptr(), xhat.data_ptr(), inv.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
        part.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), n, d, stream_ptr(dy))
    check_launch(err, "layernorm_bwd")
    return dx, dgamma, dbeta


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, plain):
        fwd = layernorm_train_plain if plain else layernorm_train
        y, xhat, inv = fwd(x, gamma, beta, eps)
        ctx.plain = plain
        ctx.save_for_backward(xhat, inv, gamma)
        return y

    @staticmethod
    def backward(ctx, dy):
        xhat, inv, gamma = ctx.saved_tensors
        bwd = layernorm_bwd_plain if ctx.plain else layernorm_bwd
        dx, dgamma, dbeta = bwd(dy.contiguous(), xhat, inv, gamma)
        return dx, dgamma, dbeta, None, None


def layernorm_fn(x, gamma, beta, eps: float = 1e-6, plain: bool = False):
    """Differentiable LayerNorm. Without a gradient to compute it is the
    inference kernel; with one, the training forward and the backward
    kernel. ``plain`` runs the plain versions (the on-card oracle)."""
    if not (torch.is_grad_enabled()
            and (x.requires_grad or gamma.requires_grad or beta.requires_grad)):
        return (layernorm_plain if plain else layernorm)(x, gamma, beta, eps)
    return _LayerNormFn.apply(x, gamma, beta, eps, plain)
