"""The residual projection ``y = gate * (x W + b) + residual`` (CUDA kernels
``csrc/fused_proj.cu``): forward and backward.

Counterpart of ``intentbev/ops/experimental/fused_proj.py`` (``_fwd_kernel``
and ``_bwd_kernel`` behind the ``custom_vjp`` of ``fused_dense_residual``),
a library op that the model does not call, as in JAX: the model's
out-projection is a plain Dense, then the gate, then the residual, each
rounded to bf16 (``models/vit.py``). ``w`` is [d_in, d_out], the JAX layout;
the gate is f32, 1 where it is None, else broadcast over the tokens.

- Forward: ``y = (f32(x W) + f32(b)) * gate + f32(residual)``, rounded once
  to x's dtype.
- Backward: ``dyg = f32(dy) * gate`` and ``dyg_c`` = dyg rounded to x's
  dtype; ``dx = dyg_c W^T`` (f32 sums, x's dtype), ``dW = x^T dyg_c`` (f32
  sums, then w's dtype), ``db = sum(dyg)`` from the unrounded dyg, d
  residual = dy, and d gate = 0: the JAX VJP returns zeros for the gate.

The kernels take bf16 x, w and residual with d_in and d_out in
:data:`WIDTHS`; other widths and dtypes raise on CUDA. CPU tensors take the
plain versions. JAX pads the rows to a multiple of 512; the kernels take any
row count.
"""

from __future__ import annotations

import torch

from .._build import check_launch, kernels, require, stream_ptr
from ..fused_ln_mlp import dw_splits, dw_tiles

WIDTHS = (192, 384)  # d_in and d_out the kernels are instantiated for


def fused_proj_fwd_plain(x2, w, b, r2, gate2):
    """Plain forward over rows (x2 [N, d_in], r2 [N, d_out], gate2 f32 [N,
    1]) with the kernel's rounding points: one rounding to x's dtype."""
    y = torch.matmul(x2.float(), w.float()) + b.float()
    return (y * gate2 + r2.float()).to(x2.dtype)


def fused_proj_bwd_plain(x2, w, dy2, gate2):
    """Plain backward over rows: ``(dx in x's dtype, dW f32, db f32)``."""
    dyg = dy2.float() * gate2
    dyg_c = dyg.to(x2.dtype).float()
    dx = torch.matmul(dyg_c, w.float().t()).to(x2.dtype)
    dw = torch.matmul(x2.float().t(), dyg_c)
    return dx, dw, dyg.sum(0)


def _check(x2, w, r2, gate2, name, r2_name):
    """-> (n, d_in, d_out) of bf16 CUDA x2 [n, d_in], w [d_in, d_out] and r2
    (the residual or dy) [n, d_out], contiguous and 16-byte aligned (the
    kernels read them by TMA), with an f32 gate of n rows."""
    n, d_in = x2.shape
    d_out = w.shape[1]
    require(x2.is_cuda and x2.dtype == torch.bfloat16 and x2.is_contiguous(),
            f"{name}: want contiguous CUDA bf16 x, got {x2.dtype} {x2.device}")
    require(d_in in WIDTHS and d_out in WIDTHS,
            f"{name}: the kernels are built for d_in and d_out in {WIDTHS}, got "
            f"{(d_in, d_out)}")
    require(w.device == x2.device and w.dtype == torch.bfloat16
            and tuple(w.shape) == (d_in, d_out) and w.is_contiguous(),
            f"{name}: w must be contiguous CUDA bf16 {(d_in, d_out)}, got {w.dtype} "
            f"{tuple(w.shape)}")
    require(gate2.device == x2.device and gate2.dtype == torch.float32
            and gate2.numel() == n and gate2.is_contiguous(),
            f"{name}: gate must be contiguous f32 [{n}, 1]")
    require(r2.device == x2.device and r2.dtype == torch.bfloat16
            and tuple(r2.shape) == (n, d_out) and r2.is_contiguous(),
            f"{name}: {r2_name} must be contiguous bf16 {(n, d_out)}, got {r2.dtype} "
            f"{tuple(r2.shape)}")
    require(all(t.data_ptr() % 16 == 0 for t in (x2, w, r2)),
            f"{name}: x, w and {r2_name} must be 16-byte aligned")
    return n, d_in, d_out


def fused_proj_fwd(x2, w, b, r2, gate2):
    """Forward kernel over rows; returns y [N, d_out] in x's dtype. b is
    read in f32, as the JAX kernel casts it. CPU tensors take
    :func:`fused_proj_fwd_plain`."""
    if x2.device.type == "cpu":
        return fused_proj_fwd_plain(x2, w, b, r2, gate2)
    n, d_in, d_out = _check(x2, w, r2, gate2, "fused_proj", "residual")
    require(b.device == x2.device and tuple(b.shape) == (d_out,) and b.is_floating_point(),
            f"fused_proj: b must be a CUDA float [{d_out}]")
    b32 = b.float().contiguous()
    y = torch.empty(n, d_out, dtype=x2.dtype, device=x2.device)
    err = kernels().ibk_fused_proj(x2.data_ptr(), w.data_ptr(), b32.data_ptr(), r2.data_ptr(),
                                   gate2.data_ptr(), y.data_ptr(), n, d_in, d_out,
                                   stream_ptr(x2))
    check_launch(err, "fused_proj")
    return y


def fused_proj_bwd(x2, w, dy2, gate2):
    """Backward kernels over rows; returns what :func:`fused_proj_bwd_plain`
    does. CPU tensors take the plain version."""
    if x2.device.type == "cpu":
        return fused_proj_bwd_plain(x2, w, dy2, gate2)
    n, d_in, d_out = _check(x2, w, dy2, gate2, "fused_proj_bwd", "dy")
    dev = x2.device
    splits = dw_splits(n, dw_tiles(d_in, d_out), dev)
    dx = torch.empty_like(x2)
    dw = torch.empty(d_in, d_out, dtype=torch.float32, device=dev)
    db = torch.empty(d_out, dtype=torch.float32, device=dev)
    dg_ws = torch.empty(n, d_out, dtype=torch.bfloat16, device=dev)
    # db's block partials (128-row blocks), then the dW product's split partials
    part = torch.empty(max(-(-n // 128) * d_out, splits * d_in * d_out), dtype=torch.float32,
                       device=dev)
    err = kernels().ibk_fused_proj_bwd(
        x2.data_ptr(), w.data_ptr(), dy2.data_ptr(), gate2.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), db.data_ptr(), dg_ws.data_ptr(), part.data_ptr(), n, d_in, d_out,
        splits, stream_ptr(x2))
    check_launch(err, "fused_proj_bwd")
    return dx, dw, db


class _FusedProjFn(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward kernel, then the backward kernel;
    dW cast to w's dtype, d residual = dy, d gate = 0."""

    @staticmethod
    def forward(ctx, x2, w, b, r2, gate2, plain):
        ctx.save_for_backward(x2, w, gate2)
        ctx.plain, ctx.b_dtype, ctx.r_dtype = plain, b.dtype, r2.dtype
        return (fused_proj_fwd_plain if plain else fused_proj_fwd)(x2, w, b, r2, gate2)

    @staticmethod
    def backward(ctx, dy):
        x2, w, gate2 = ctx.saved_tensors
        bwd = fused_proj_bwd_plain if ctx.plain else fused_proj_bwd
        dx, dw, db = bwd(x2, w, dy.contiguous(), gate2)
        return (dx, dw.to(w.dtype), db.to(ctx.b_dtype), dy.to(ctx.r_dtype),
                torch.zeros_like(gate2), None)


def fused_dense_residual(x, w, b, residual, gate=None, plain: bool = False):
    """y = gate * (x W + b) + residual over [..., d_in] activations, w [d_in,
    d_out]; differentiable (d gate = 0, as in JAX). ``gate`` is None or
    broadcast over the last axis of x's leading shape (a per-token or, as
    [B, 1], a per-sample gate). ``plain`` runs the plain versions (the
    on-card oracle); CPU tensors take them anyway."""
    shape, d_in, d_out = x.shape, x.shape[-1], w.shape[1]
    x2 = x.reshape(-1, d_in).contiguous()
    r2 = residual.reshape(-1, d_out).contiguous()
    n = x2.shape[0]
    if gate is None:
        gate2 = torch.ones(n, 1, dtype=torch.float32, device=x.device)
    else:
        gate2 = gate.float()[..., None].expand(shape[:-1] + (1,)).reshape(n, 1).contiguous()
    y = _FusedProjFn.apply(x2, w, b, r2, gate2, plain)
    return y.reshape(shape[:-1] + (d_out,))
