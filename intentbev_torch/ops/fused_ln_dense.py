"""Fused LayerNorm + dense [+ GELU] (CUDA kernels ``csrc/fused_ln_dense.cu``):
forward and the training backward.

Counterpart of ``intentbev/ops/fused_ln_dense.py`` (``_fwd_kernel`` and
``_bwd_kernel``), behind ``ViTBackboneConfig.fuse_ln_dense``: the qkv
projection with norm1 folded in, ``qkv = LN(x) Wqkv^T + b``, and the stream
adapters, ``a = GELU(LN(x) Wa^T + b)``. ``w`` is PyTorch's Linear layout
[Dout, D]; ``gelu_mode`` is None (no GELU), "erf" or the serving "sigmoid".
:func:`fused_ln_dense_fn` is the differentiable entry (the JAX
``custom_vjp``): the forward kernel, then the backward kernel, which gives
dx, dgamma, dbeta, dW and db. Training takes no GELU or the exact erf one.
Both are built for the widths of :data:`VIT_B_WIDTHS` (at ViT-B's 768 on
64-row blocks whose two consumers split the columns); another width raises
on CUDA.
"""

from __future__ import annotations

import torch

from ._build import check_launch, kernels, require, stream_ptr
from .fused_ln_mlp import GELU_MODES, dw_splits, dw_tiles, gelu, gelu_erf_grad
from .layernorm import VIT_B_WIDTHS, layernorm_plain

DOUT_STEP = 64       # Dout is a multiple of a TMA box's 64 columns
FWD_TILE = 192       # the forward kernel's column tile: it reads the bias a tile at a time


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


def _check_args(x, gamma, beta, w, bias, name, widths):
    d, dout = x.shape[-1], w.shape[0]
    require(x.is_cuda and x.dtype == torch.bfloat16 and x.is_contiguous(),
            f"{name}: want contiguous CUDA bf16 x, got {x.dtype} {x.device}")
    require(d in widths, f"{name} kernel is built for D in {widths}, got {d}")
    require(dout % DOUT_STEP == 0 and dout > 0,
            f"{name}: Dout {dout} not a multiple of {DOUT_STEP}")
    require(w.device == x.device and w.dtype == torch.bfloat16
            and tuple(w.shape) == (dout, d) and w.is_contiguous(),
            f"{name}: w must be contiguous bf16 {(dout, d)}")
    for pname, p, n in (("gamma", gamma, d), ("beta", beta, d), ("bias", bias, dout)):
        require(p.device == x.device and p.dtype == torch.float32
                and tuple(p.shape) == (n,) and p.is_contiguous(),
                f"{name}: {pname} must be contiguous f32 [{n}]")


def fused_ln_dense(x, gamma, beta, w, bias, eps: float = 1e-6,
                   gelu_mode: str | None = None):
    """[GELU](LN(x) w^T + bias) of a contiguous bf16 [..., D] CUDA tensor, D
    in :data:`VIT_B_WIDTHS` (gamma, beta, bias f32; w bf16 [Dout, D], Dout a
    multiple of 64) -> bf16 [..., Dout]. CPU tensors take
    :func:`fused_ln_dense_plain`."""
    if gelu_mode is not None and gelu_mode not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu_mode!r} not in (None, *{GELU_MODES})")
    if x.device.type == "cpu":
        return fused_ln_dense_plain(x, gamma, beta, w, bias, eps, gelu_mode)
    _check_args(x, gamma, beta, w, bias, "fused_ln_dense", VIT_B_WIDTHS)
    d, dout = x.shape[-1], w.shape[0]
    y = torch.empty(x.shape[:-1] + (dout,), dtype=x.dtype, device=x.device)
    mode = -1 if gelu_mode is None else GELU_MODES.index(gelu_mode)
    if dout % FWD_TILE:  # a last partial tile: the bias padded to whole tiles
        bias = torch.nn.functional.pad(bias, (0, -dout % FWD_TILE))
    err = kernels().ibk_fused_ln_dense(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), bias.data_ptr(),
        y.data_ptr(), x.numel() // d, d, dout, float(eps), mode, stream_ptr(x))
    check_launch(err, "fused_ln_dense")
    return y


def fused_ln_dense_bwd_plain(x, gamma, beta, w, bias, dy, eps: float = 1e-6,
                             gelu_mode: str | None = None):
    """Plain backward with the JAX kernel's rounding points: LN recomputed in
    f32, xn and dg (dy * GELU'(g) with the erf GELU, else dy) rounded to x's
    dtype before each product; products and column sums f32. Returns ``(dx
    in x's dtype, dgamma, dbeta, dw [Dout, D], db)``, the last four f32."""
    dt, d, dout = x.dtype, x.shape[-1], w.shape[0]
    xf = x.reshape(-1, d).float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * inv
    xn = (xhat * gamma.float() + beta.float()).to(dt).float()
    wf = w.to(dt).float()
    dg = dy.reshape(-1, dout).float()
    if gelu_mode is not None:
        dg = dg * gelu_erf_grad(torch.matmul(xn, wf.t()) + bias.float())
    dg_lp = dg.to(dt).float()
    dxn = torch.matmul(dg_lp, wf)
    dyg = dxn * gamma.float()
    m1 = dyg.mean(-1, keepdim=True)
    m2 = (dyg * xhat).mean(-1, keepdim=True)
    dx = inv * (dyg - m1 - xhat * m2)
    return (dx.to(dt).reshape(x.shape), (dxn * xhat).sum(0), dxn.sum(0),
            torch.matmul(dg_lp.t(), xn), dg.sum(0))


def _train_gelu(gelu_mode):
    """The backward pairs the forward with the exact-erf derivative, so a
    training pass takes no GELU or the erf one (the JAX
    ``_require_exact_gelu_for_grad``)."""
    if gelu_mode not in (None, "erf"):
        raise ValueError(f"fused_ln_dense: training takes no GELU or the erf one, "
                         f"not {gelu_mode!r}")


def fused_ln_dense_bwd(x, gamma, beta, w, bias, dy, eps: float = 1e-6,
                       gelu_mode: str | None = None):
    """Backward kernels; returns what :func:`fused_ln_dense_bwd_plain` does.
    CPU tensors take the plain version."""
    _train_gelu(gelu_mode)
    if x.device.type == "cpu":
        return fused_ln_dense_bwd_plain(x, gamma, beta, w, bias, dy, eps, gelu_mode)
    _check_args(x, gamma, beta, w, bias, "fused_ln_dense_bwd", VIT_B_WIDTHS)
    d, dout = x.shape[-1], w.shape[0]
    n = x.numel() // d
    require(n > 0, "fused_ln_dense_bwd: no rows")
    require(dy.shape == x.shape[:-1] + (dout,) and dy.dtype == torch.bfloat16
            and dy.is_contiguous() and dy.device == x.device,
            f"fused_ln_dense_bwd: dy must be contiguous bf16 [..., {dout}]")
    dev = x.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    # the dW product's row splits (dw_gemm_kernel), and the f32 partials:
    # its split partials, or (before it) the row kernel's db partials (one
    # for each 64 rows of a block: 64 rows at D=768, else 128) and per-block
    # dgamma and dbeta partials
    splits = dw_splits(n, dw_tiles(dout, d), dev)
    dx = torch.empty_like(x)
    dgamma, dbeta, dw, db = f32(d), f32(d), f32(dout, d), f32(dout)
    rows = 64 if d == 768 else 128
    part = f32(max(splits * dout * d, -(-n // rows) * (rows // 64 * dout + 2 * d)))
    xn_ws = torch.empty(n, d, dtype=torch.bfloat16, device=dev)
    dg_ws = torch.empty(n, dout, dtype=torch.bfloat16, device=dev) if gelu_mode else None
    err = kernels().ibk_fused_ln_dense_bwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), bias.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), dw.data_ptr(),
        db.data_ptr(), xn_ws.data_ptr(), None if dg_ws is None else dg_ws.data_ptr(),
        part.data_ptr(), n, d, dout, float(eps), -1 if gelu_mode is None else 0, splits,
        stream_ptr(x))
    check_launch(err, "fused_ln_dense_bwd")
    return dx, dgamma, dbeta, dw, db


class _FusedLnDenseFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, eps, gelu_mode, plain):
        ctx.eps, ctx.gelu_mode, ctx.plain = eps, gelu_mode, plain
        ctx.save_for_backward(x, gamma, beta, w, bias)
        fwd = fused_ln_dense_plain if plain else fused_ln_dense
        return fwd(x, gamma, beta, w, bias, eps, gelu_mode)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w, bias = ctx.saved_tensors
        bwd = fused_ln_dense_bwd_plain if ctx.plain else fused_ln_dense_bwd
        dx, dgamma, dbeta, dw, db = bwd(x, gamma, beta, w, bias, dy.contiguous(), ctx.eps,
                                        ctx.gelu_mode)
        return dx, dgamma, dbeta, dw, db, None, None, None


def fused_ln_dense_fn(x, gamma, beta, w, bias, eps: float = 1e-6,
                      gelu_mode: str | None = None, plain: bool = False):
    """Differentiable [GELU](LN(x) w^T + bias); ``gelu_mode`` None or "erf".
    ``plain`` runs the plain versions (the on-card oracle)."""
    _train_gelu(gelu_mode)
    return _FusedLnDenseFn.apply(x, gamma, beta, w, bias, eps, gelu_mode, plain)
