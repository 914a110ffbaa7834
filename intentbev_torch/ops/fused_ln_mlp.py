"""Fused LayerNorm + MLP block tail (CUDA kernels ``csrc/fused_ln_mlp.cu``).

Counterpart of ``intentbev/ops/fused_ln_mlp.py``. Serving, with the LN
epilogue of the serving LN chain (``fused_ln_mlp(..., ln_out=...)``):

    y  = x + GELU(LN(x) * g + b) W1 + b1) W2 + b2
    yn = LN(y) * g_next + b_next        (from the f32 y)

Training (:func:`fused_ln_mlp_fn`, the JAX ``custom_vjp``): the forward
``y = x + gate * mlp(LN(x))`` with a per-row f32 drop-path gate and the
backward kernel that recomputes the tail and gives dx, dgamma, dbeta, dW1,
db1, dW2 and db2 (no gradient for the gate, a random mask). The same
forward without a gate is the serving tail of the configurations that run
no LN chain (:func:`fused_ln_mlp_train` with either GELU).

Weights use PyTorch's Linear layout: ``w1`` [hidden, D], ``w2`` [D, hidden].
The serving chain's kernel and the training kernels take D in
``layernorm.VIT_B_WIDTHS`` (768, 384, 192; at 768 the backward runs as two
row kernels, dh = dy_eff W2 into an f32 workspace, then the rest); all take
any hidden width that is a multiple of 64. Another width raises on CUDA:
nothing falls back to a plain version.
The serving drop-path gate is 1 and is not an argument. ``gelu`` is
``"erf"`` (exact; the JAX package's default, and the only mode training
takes) or ``"sigmoid"`` (x * sigmoid(1.702 x), the serving variant
``bench.py`` selects).
"""

from __future__ import annotations

import torch

from ._build import check_launch, kernels, require, stream_ptr
from .layernorm import VIT_B_WIDTHS, layernorm_plain

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
    """Returns ``(y, yn)`` for a contiguous bf16 [..., D] CUDA tensor (f32
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
    require(d in VIT_B_WIDTHS,
            f"fused_ln_mlp kernel is built for D in {VIT_B_WIDTHS}, got {d}")
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
        beta_next.data_ptr(), y.data_ptr(), yn.data_ptr(), x.numel() // d, d,
        hidden, float(eps), GELU_MODES.index(gelu_mode), stream_ptr(x))
    check_launch(err, "fused_ln_mlp")
    return y, yn


def gelu_erf_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact GELU (``intentbev/ops/fused_mlp.py::_dgelu``)."""
    return (0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
            + x * 0.3989422804014327 * torch.exp(-0.5 * x * x))


def _gate_rows(gate, x):
    """Gate broadcastable to x.shape[:-1] (or None: 1) -> f32 [rows, 1]."""
    if gate is None:
        return torch.ones(x.numel() // x.shape[-1], 1, dtype=torch.float32,
                          device=x.device)
    return gate.float().expand(x.shape[:-1]).reshape(-1, 1)


def fused_ln_mlp_train_plain(x, gamma, beta, w1, b1, w2, b2, gate=None,
                             eps: float = 1e-6, gelu_mode: str = "erf"):
    """Plain training forward with the kernel's rounding points (those of
    :func:`fused_ln_mlp_plain`): y = (mlp + b2) * gate + x in f32, rounded
    once. ``gate``: f32 of x.shape[:-1], or None for 1."""
    dt, d = x.dtype, x.shape[-1]
    xf = x.reshape(-1, d).float()
    xn = layernorm_plain(xf, gamma, beta, eps).to(dt).float()
    h = gelu(torch.matmul(xn, w1.to(dt).float().t()) + b1.float(), gelu_mode)
    m = torch.matmul(h.to(dt).float(), w2.to(dt).float().t()) + b2.float()
    y = m * _gate_rows(gate, x) + xf
    return y.to(dt).reshape(x.shape)


def fused_ln_mlp_bwd_dh_plain(w2, gate, dy):
    """Plain version of the D=768 backward's first row kernel: ``(dh f32
    [rows, hidden], dy_eff in dy's dtype, db2 f32)``, dh = dy_eff W2 from the
    rounded dy_eff = dy * gate; db2 sums the f32 dy_eff."""
    dt, d = dy.dtype, dy.shape[-1]
    dye = dy.reshape(-1, d).float() * _gate_rows(gate, dy)
    dye_lp = dye.to(dt)
    return torch.matmul(dye_lp.float(), w2.to(dt).float()), dye_lp, dye.sum(0)


def fused_ln_mlp_bwd_rows_plain(x, gamma, beta, w1, b1, dh, dy, eps: float = 1e-6):
    """Plain version of the D=768 backward's second row kernel, from the
    first one's f32 dh: ``(dx in x's dtype, dgamma, dbeta, xn, h, dg (the
    last three in x's dtype), db1)``. With :func:`fused_ln_mlp_bwd_dh_plain`
    it computes what :func:`fused_ln_mlp_bwd_plain` does, bit for bit."""
    dt, d = x.dtype, x.shape[-1]
    xf = x.reshape(-1, d).float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * inv
    xn = (xhat * gamma.float() + beta.float()).to(dt).float()
    w1f = w1.to(dt).float()
    g = torch.matmul(xn, w1f.t()) + b1.float()
    dg = dh * gelu_erf_grad(g)
    dg_lp = dg.to(dt).float()
    dxn = torch.matmul(dg_lp, w1f)
    dyg = dxn * gamma.float()
    m1 = dyg.mean(-1, keepdim=True)
    m2 = (dyg * xhat).mean(-1, keepdim=True)
    dx = inv * (dyg - m1 - xhat * m2) + dy.reshape(-1, d).float()
    return (dx.to(dt).reshape(x.shape), (dxn * xhat).sum(0), dxn.sum(0), xn.to(dt),
            gelu(g, "erf").to(dt), dg_lp.to(dt), dg.sum(0))


def fused_ln_mlp_bwd_plain(x, gamma, beta, w1, b1, w2, gate, dy, eps: float = 1e-6):
    """Plain backward with the JAX kernel's rounding points: xn, dy_eff =
    dy * gate, h and dg are rounded to x's dtype before each product, the
    products and column sums are f32. Returns ``(dx in x's dtype, dgamma,
    dbeta, dw1 [hidden, D], db1, dw2 [D, hidden], db2)``, the last six f32."""
    dt, d = x.dtype, x.shape[-1]
    xf = x.reshape(-1, d).float()
    dyf = dy.reshape(-1, d).float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * inv
    xn = (xhat * gamma.float() + beta.float()).to(dt).float()
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    g = torch.matmul(xn, w1f.t()) + b1.float()
    dye = dyf * _gate_rows(gate, x)
    dye_lp = dye.to(dt).float()
    dg = torch.matmul(dye_lp, w2f) * gelu_erf_grad(g)
    dg_lp = dg.to(dt).float()
    dxn = torch.matmul(dg_lp, w1f)
    dyg = dxn * gamma.float()
    m1 = dyg.mean(-1, keepdim=True)
    m2 = (dyg * xhat).mean(-1, keepdim=True)
    dx = inv * (dyg - m1 - xhat * m2) + dyf
    h_lp = gelu(g, "erf").to(dt).float()
    return (dx.to(dt).reshape(x.shape), (dxn * xhat).sum(0), dxn.sum(0),
            torch.matmul(dg_lp.t(), xn), dg.sum(0), torch.matmul(dye_lp.t(), h_lp),
            dye.sum(0))


def _check_train_args(x, gamma, beta, w1, b1, w2, name):
    d, hidden = x.shape[-1], w1.shape[0]
    require(x.is_cuda and x.dtype == torch.bfloat16 and x.is_contiguous(),
            f"{name}: want contiguous CUDA bf16 x, got {x.dtype} {x.device}")
    require(d in VIT_B_WIDTHS, f"{name} kernel is built for D in {VIT_B_WIDTHS}, got {d}")
    require(hidden % 64 == 0, f"{name}: hidden {hidden} not a multiple of 64")
    for wname, w, shape in (("w1", w1, (hidden, d)), ("w2", w2, (d, hidden))):
        require(w.device == x.device and w.dtype == torch.bfloat16
                and tuple(w.shape) == shape and w.is_contiguous(),
                f"{name}: {wname} must be contiguous bf16 {shape}")
    for pname, p, n in (("gamma", gamma, d), ("beta", beta, d), ("b1", b1, hidden)):
        require(p.device == x.device and p.dtype == torch.float32
                and tuple(p.shape) == (n,) and p.is_contiguous(),
                f"{name}: {pname} must be contiguous f32 [{n}]")


def _gate_arg(gate, x, name):
    """The kernel's gate operand: f32 [rows] contiguous, or None (1)."""
    if gate is None:
        return None
    g = gate.float().expand(x.shape[:-1]).contiguous()
    require(g.device == x.device, f"{name}: gate on another device")
    return g


def fused_ln_mlp_train(x, gamma, beta, w1, b1, w2, b2, gate=None, eps: float = 1e-6,
                       gelu_mode: str = "erf"):
    """Forward y = x + gate * mlp(LN(x)) of a contiguous bf16 [..., D]
    CUDA tensor; ``gate`` f32 broadcastable to x.shape[:-1] or None.
    Training takes the exact erf GELU; the unchained serving tail either.
    CPU tensors take :func:`fused_ln_mlp_train_plain`."""
    if gelu_mode not in GELU_MODES:
        raise ValueError(f"gelu mode {gelu_mode!r} not in {GELU_MODES}")
    if x.device.type == "cpu":
        return fused_ln_mlp_train_plain(x, gamma, beta, w1, b1, w2, b2, gate, eps,
                                        gelu_mode)
    _check_train_args(x, gamma, beta, w1, b1, w2, "fused_ln_mlp_train")
    require(b2.dtype == torch.float32 and b2.shape == (x.shape[-1],)
            and b2.is_contiguous() and b2.device == x.device,
            "fused_ln_mlp_train: b2 must be contiguous f32 [D]")
    g = _gate_arg(gate, x, "fused_ln_mlp_train")
    y = torch.empty_like(x)
    err = kernels().ibk_fused_ln_mlp_train(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), None if g is None else g.data_ptr(), y.data_ptr(),
        x.numel() // x.shape[-1], x.shape[-1], w1.shape[0], float(eps),
        GELU_MODES.index(gelu_mode), stream_ptr(x))
    check_launch(err, "fused_ln_mlp_train")
    return y


DW_TILE = (128, 192)  # output tile (M, N) of the backward's dW products


def dw_tiles(m: int, n: int) -> int:
    """Output tiles of one dW product [m, n] (``dw_gemm_kernel``)."""
    tm, tn = DW_TILE
    return -(-m // tm) * -(-n // tn)


def dw_splits(n: int, tiles: int, device) -> int:
    """Row splits of the dW products over n rows (``dw_gemm_kernel``, one
    block an SM, ``tiles`` output tiles in all): the fewest waves of the
    card's SMs that tiles x splits fills to at least 90 %; each split writes
    an f32 partial."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    waves = 1
    while (waves * sms // tiles) * tiles < 0.9 * waves * sms and waves < 8:
        waves += 1
    return max(1, min(waves * sms // tiles, -(-n // 64)))


def ln_mlp_bwd_splits(n: int, d: int, hidden: int, device) -> int:
    """Row splits of the backward's dW products: dW1 [hidden, d] and dW2
    [d, hidden] in one launch."""
    return dw_splits(n, dw_tiles(hidden, d) + dw_tiles(d, hidden), device)


def bwd_workspace(n: int, d: int, hidden: int, splits: int, device):
    """The backward's f32 partials: the dW products' split partials, or
    (before them) the row kernel's 64-row block partials of db1, dgamma,
    dbeta and db2."""
    size = max(splits * 2 * hidden * d, -(-n // 64) * (hidden + 3 * d))
    return torch.empty(size, dtype=torch.float32, device=device)


def fused_ln_mlp_bwd(x, gamma, beta, w1, b1, w2, gate, dy, eps: float = 1e-6):
    """Backward kernels; returns what :func:`fused_ln_mlp_bwd_plain` does.
    CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return fused_ln_mlp_bwd_plain(x, gamma, beta, w1, b1, w2, gate, dy, eps)
    _check_train_args(x, gamma, beta, w1, b1, w2, "fused_ln_mlp_bwd")
    require(dy.shape == x.shape and dy.dtype == torch.bfloat16 and dy.is_contiguous()
            and dy.device == x.device, "fused_ln_mlp_bwd: dy must be contiguous bf16 like x")
    g = _gate_arg(gate, x, "fused_ln_mlp_bwd")
    d, hidden = x.shape[-1], w1.shape[0]
    n = x.numel() // d
    dev = x.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def bf(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev)

    dx = torch.empty_like(x)
    dgamma, dbeta, db2, db1 = f32(d), f32(d), f32(d), f32(hidden)
    dw1, dw2 = f32(hidden, d), f32(d, hidden)
    splits = ln_mlp_bwd_splits(n, d, hidden, dev)
    part = bwd_workspace(n, d, hidden, splits, dev)
    xn_ws, dye_ws, h_ws, dg_ws = bf(n, d), bf(n, d), bf(n, hidden), bf(n, hidden)
    # D=768: the first row kernel's dh = dy_eff W2, kept in f32 for the second
    dh_ws = f32(n, hidden) if d == 768 else None
    err = kernels().ibk_fused_ln_mlp_bwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), None if g is None else g.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dgamma.data_ptr(), dbeta.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), xn_ws.data_ptr(), dye_ws.data_ptr(),
        h_ws.data_ptr(), dg_ws.data_ptr(), None if dh_ws is None else dh_ws.data_ptr(),
        part.data_ptr(), n, d, hidden, float(eps), splits, stream_ptr(x))
    check_launch(err, "fused_ln_mlp_bwd")
    return dx, dgamma, dbeta, dw1, db1, dw2, db2


class _FusedLnMlpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, gate, eps, plain):
        fwd = fused_ln_mlp_train_plain if plain else fused_ln_mlp_train
        ctx.eps, ctx.plain = eps, plain
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, gate)
        return fwd(x, gamma, beta, w1, b1, w2, b2, gate, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w1, b1, w2, gate = ctx.saved_tensors
        bwd = fused_ln_mlp_bwd_plain if ctx.plain else fused_ln_mlp_bwd
        dx, dgamma, dbeta, dw1, db1, dw2, db2 = bwd(
            x, gamma, beta, w1, b1, w2, gate, dy.contiguous(), ctx.eps)
        return dx, dgamma, dbeta, dw1, db1, dw2, db2, None, None, None


def fused_ln_mlp_fn(x, gamma, beta, w1, b1, w2, b2, gate=None, eps: float = 1e-6,
                    plain: bool = False):
    """Differentiable training tail y = x + gate * mlp(LN(x)), exact erf
    GELU. ``gate``: f32 of x.shape[:-1] (0 or 1/keep), or None. ``plain``
    runs the plain versions (the on-card oracle)."""
    return _FusedLnMlpFn.apply(x, gamma, beta, w1, b1, w2, b2, gate, eps, plain)
