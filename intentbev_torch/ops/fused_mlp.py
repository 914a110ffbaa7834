"""The block MLP without LayerNorm (CUDA kernels ``ibk_fused_mlp`` and
``ibk_fused_mlp_bwd`` in ``csrc/fused_ln_mlp.cu``): serving, the training
forward with its drop-path gate, and the backward.

Counterpart of ``intentbev/ops/fused_mlp.py`` (``_fwd_kernel`` and
``_bwd_kernel``), which serves the block tail when ``use_fused_layernorm`` is
off: the caller norms the rows (plain PyTorch, as the JAX model's
FastLayerNorm is XLA) and the kernel computes

    y = residual + gate * (GELU(h W1 + b1) W2 + b2)

with ``w1`` [hidden, D] and ``w2`` [D, hidden] in PyTorch's Linear layout and
``gate`` a per-row f32 drop-path factor (None: 1). :func:`fused_mlp` is the
serving entry, :func:`fused_mlp_train` the training forward, and
:func:`fused_mlp_fn` the differentiable entry: its backward kernel gives dh,
dW1, db1, dW2 and db2, and the residual's gradient is dy itself, ungated, as
in the JAX ``custom_vjp`` (no gradient for the gate, a random mask).
Both are built for the widths of ``layernorm.VIT_B_WIDTHS``: at ViT-B's
768 the forward by ``ln_mlp_wide_kernel`` and the backward by two row
kernels (dh = dy_eff W2 into an f32 workspace, then the rest), each without
its LN; another width raises on CUDA.
"""

from __future__ import annotations

import torch

from ._build import check_launch, kernels, require, stream_ptr
from .fused_ln_mlp import (GELU_MODES, _gate_arg, _gate_rows, bwd_workspace, gelu,
                           gelu_erf_grad, ln_mlp_bwd_splits)
from .layernorm import VIT_B_WIDTHS


def fused_mlp_plain(h, w1, b1, w2, b2, residual, gelu_mode: str = "erf", gate=None):
    """Plain PyTorch version with the kernel's rounding points: f32 products
    of h and W1 (both in h's dtype), bias and GELU in f32, the hidden
    activation rounded to h's dtype for fc2, then (. + b2) * gate + residual
    in f32, rounded once. ``gate``: f32 of h.shape[:-1], or None for 1."""
    dt, d = h.dtype, h.shape[-1]
    hf = h.reshape(-1, d).float()
    g = gelu(torch.matmul(hf, w1.to(dt).float().t()) + b1.float(), gelu_mode)
    m = torch.matmul(g.to(dt).float(), w2.to(dt).float().t()) + b2.float()
    if gate is not None:
        m = m * _gate_rows(gate, h)
    return (m + residual.reshape(-1, d).float()).to(dt).reshape(h.shape)


def _check_args(h, w1, b1, w2, name, widths):
    d, hidden = h.shape[-1], w1.shape[0]
    require(h.is_cuda and h.dtype == torch.bfloat16 and h.is_contiguous(),
            f"{name}: want contiguous CUDA bf16 h, got {h.dtype} {h.device}")
    require(d in widths, f"{name} kernel is built for D in {widths}, got {d}")
    require(hidden % 64 == 0, f"{name}: hidden {hidden} not a multiple of 64")
    for wname, w, shape in (("w1", w1, (hidden, d)), ("w2", w2, (d, hidden))):
        require(w.device == h.device and w.dtype == torch.bfloat16
                and tuple(w.shape) == shape and w.is_contiguous(),
                f"{name}: {wname} must be contiguous bf16 {shape}")
    require(b1.device == h.device and b1.dtype == torch.float32
            and tuple(b1.shape) == (hidden,) and b1.is_contiguous(),
            f"{name}: b1 must be contiguous f32 [{hidden}]")


def _launch_fwd(h, w1, b1, w2, b2, residual, gelu_mode, gate, name):
    if gelu_mode not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu_mode!r} not in {GELU_MODES}")
    if h.device.type == "cpu":
        return fused_mlp_plain(h, w1, b1, w2, b2, residual, gelu_mode, gate)
    _check_args(h, w1, b1, w2, name, VIT_B_WIDTHS)
    d = h.shape[-1]
    require(residual.shape == h.shape and residual.dtype == h.dtype
            and residual.is_contiguous() and residual.device == h.device,
            f"{name}: residual must be contiguous bf16 like h")
    require(b2.device == h.device and b2.dtype == torch.float32
            and tuple(b2.shape) == (d,) and b2.is_contiguous(),
            f"{name}: b2 must be contiguous f32 [{d}]")
    g = _gate_arg(gate, h, name)
    y = torch.empty_like(h)
    err = kernels().ibk_fused_mlp(
        h.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        residual.data_ptr(), None if g is None else g.data_ptr(), y.data_ptr(),
        h.numel() // d, d, w1.shape[0], GELU_MODES.index(gelu_mode), stream_ptr(h))
    check_launch(err, name)
    return y


def fused_mlp(h, w1, b1, w2, b2, residual, gelu_mode: str = "erf", gate=None):
    """Serving: ``residual + gate * mlp(h)`` of contiguous bf16 [..., D]
    CUDA tensors, D in ``layernorm.VIT_B_WIDTHS`` (f32 biases, bf16 weights;
    ``gate`` f32 broadcastable to h.shape[:-1], or None for 1). CPU tensors
    take :func:`fused_mlp_plain`."""
    return _launch_fwd(h, w1, b1, w2, b2, residual, gelu_mode, gate, "fused_mlp")


def fused_mlp_train(h, w1, b1, w2, b2, residual, gate=None, gelu_mode: str = "erf"):
    """The training forward of :func:`fused_mlp_fn`: the same kernel,
    counted under its own name."""
    return _launch_fwd(h, w1, b1, w2, b2, residual, gelu_mode, gate, "fused_mlp_train")


def fused_mlp_bwd_plain(h, w1, b1, w2, gate, dy):
    """Plain backward with the JAX kernel's rounding points: dy_eff = dy *
    gate, the activation GELU(g) and dg are rounded to h's dtype before each
    product, the products and column sums are f32 (exact erf GELU). Returns
    ``(dh in h's dtype, dw1 [hidden, D], db1, dw2 [D, hidden], db2)``, the
    last four f32; the residual's gradient is dy."""
    dt, d = h.dtype, h.shape[-1]
    hf = h.reshape(-1, d).float()
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    g = torch.matmul(hf, w1f.t()) + b1.float()
    dye = dy.reshape(-1, d).float() * _gate_rows(gate, h)
    dye_lp = dye.to(dt).float()
    dg = torch.matmul(dye_lp, w2f) * gelu_erf_grad(g)
    dg_lp = dg.to(dt).float()
    act = gelu(g, "erf").to(dt).float()
    return (torch.matmul(dg_lp, w1f).to(dt).reshape(h.shape), torch.matmul(dg_lp.t(), hf),
            dg.sum(0), torch.matmul(dye_lp.t(), act), dye.sum(0))


def fused_mlp_bwd(h, w1, b1, w2, gate, dy):
    """Backward kernels; returns what :func:`fused_mlp_bwd_plain` does. CPU
    tensors take the plain version."""
    if h.device.type == "cpu":
        return fused_mlp_bwd_plain(h, w1, b1, w2, gate, dy)
    _check_args(h, w1, b1, w2, "fused_mlp_bwd", VIT_B_WIDTHS)
    require(dy.shape == h.shape and dy.dtype == torch.bfloat16 and dy.is_contiguous()
            and dy.device == h.device, "fused_mlp_bwd: dy must be contiguous bf16 like h")
    g = _gate_arg(gate, h, "fused_mlp_bwd")
    d, hidden = h.shape[-1], w1.shape[0]
    n = h.numel() // d
    require(n > 0, "fused_mlp_bwd: no rows")

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=h.device)

    dh = torch.empty_like(h)
    db1, db2, dw1, dw2 = f32(hidden), f32(d), f32(hidden, d), f32(d, hidden)
    splits = ln_mlp_bwd_splits(n, d, hidden, h.device)
    part = bwd_workspace(n, d, hidden, splits, h.device)
    dye_ws = torch.empty_like(h)
    act_ws = torch.empty(n, hidden, dtype=torch.bfloat16, device=h.device)
    dg_ws = torch.empty_like(act_ws)
    # D=768: the first row kernel's dh = dy_eff W2, kept in f32 for the second
    dh_ws = f32(n, hidden) if d == 768 else None
    err = kernels().ibk_fused_mlp_bwd(
        h.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        None if g is None else g.data_ptr(), dy.data_ptr(), dh.data_ptr(), dw1.data_ptr(),
        db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), dye_ws.data_ptr(), act_ws.data_ptr(),
        dg_ws.data_ptr(), None if dh_ws is None else dh_ws.data_ptr(), part.data_ptr(), n, d,
        hidden, splits, stream_ptr(h))
    check_launch(err, "fused_mlp_bwd")
    return dh, dw1, db1, dw2, db2


class _FusedMlpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w1, b1, w2, b2, residual, gate, plain):
        ctx.plain = plain
        ctx.save_for_backward(h, w1, b1, w2, gate)
        if plain:
            return fused_mlp_plain(h, w1, b1, w2, b2, residual, "erf", gate)
        return fused_mlp_train(h, w1, b1, w2, b2, residual, gate)

    @staticmethod
    def backward(ctx, dy):
        h, w1, b1, w2, gate = ctx.saved_tensors
        dy = dy.contiguous()
        bwd = fused_mlp_bwd_plain if ctx.plain else fused_mlp_bwd
        dh, dw1, db1, dw2, db2 = bwd(h, w1, b1, w2, gate, dy)
        return dh, dw1, db1, dw2, db2, dy, None, None


def fused_mlp_fn(h, w1, b1, w2, b2, residual, gate=None, plain: bool = False):
    """Differentiable training tail y = residual + gate * mlp(h), exact erf
    GELU. ``gate``: f32 of h.shape[:-1] (0 or 1/keep), or None. ``plain``
    runs the plain versions (the on-card oracle)."""
    return _FusedMlpFn.apply(h, w1, b1, w2, b2, residual, gate, plain)
