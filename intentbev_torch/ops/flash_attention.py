"""Attention over [B, H, T, D] tensors (CUDA kernels ``ibk_flash_attn_fwd``
and ``ibk_flash_attn_bwd`` in ``csrc/flash_packed.cu``: the packed layout's
kernels, templated on the head dim and read through strides).

Counterpart of ``intentbev/ops/flash_attention.py`` (``_fwd_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` behind ``flash_attention``), to
which the JAX ``flash_attention_packed`` falls back when the heads do not
pair into 128 lanes (``intentbev/ops/flash_packed.py:778``), as ViT-Ti's 3
heads of 64 do not. The rounding points are the JAX wrapper's: q is scaled
in its own dtype by the scale rounded to that dtype, and q's gradient is the
kernel's dq rounded to q's dtype, then multiplied by that scale in q's dtype
(the autodiff of the scaling). The scale is that of the head dim D, never of
the kernel instance that runs it. At head dims 16 and 64 the scales 1/4 and
1/8 are exact; at 32 the bf16 scale is 0.1767578125, not 32**-0.5, and at
48, 96 or 128 none is exact either.

Keys at or past ``seq_len`` are masked, so callers pad nothing (the JAX
wrapper pads T to its 512-row block; padded query rows add nothing to any
gradient). The kernels take bf16 CUDA views with unit stride along D and
batch, head and row strides that are multiples of 8, q, k and v sharing
theirs; so the packed qkv projection output passes as strided views with no
transposes (the JAX fallback transposes, which changes no value). CPU
tensors take the plain versions. :func:`flash_attention` is the
differentiable public entry over [B, H, T, D]; :func:`flash_attention_qkv`
the one over the model's qkv projection output.

Head dims: the kernels are instantiated for the widths :data:`HEAD_DIMS` (32,
64, 128) and take any head dim D from 8 to 128 in steps of 8 on the smallest
instance at least D (:func:`instance`): TMA reads the columns from D to the
instance's width as zeros, and the epilogues write only the first D. A head
dim off a multiple of 8 (a packed head row of 2*D bytes, which TMA cannot
stride) or above 128 raises on CUDA, as does every other refused shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._build import check_launch, kernels, require, stream_ptr

HEAD_DIMS = (32, 64, 128)  # the kernels' instance widths (csrc/flash_packed.cu Inst)
HEAD_DIM_STEP, HEAD_DIM_MAX = 8, 128  # the head dims they take: 8, 16, ..., 128
BOX_ROWS = 64  # rows of one TMA box of the flash kernels
BOX_COLS_MAX = 64  # columns of the widest box (128-byte rows, the widest swizzle)


def instance(d: int) -> int:
    """The kernel instance that runs head dim ``d``: the smallest of
    :data:`HEAD_DIMS` at least ``d``. Raises ValueError for a head dim the
    kernels do not take (under 8, above 128, or off a multiple of 8)."""
    if d % HEAD_DIM_STEP or not HEAD_DIM_STEP <= d <= HEAD_DIM_MAX:
        raise ValueError(f"head dim {d} has no flash kernel instance: the kernels take "
                         f"{HEAD_DIM_STEP} to {HEAD_DIM_MAX} in steps of {HEAD_DIM_STEP}")
    return next(w for w in HEAD_DIMS if w >= d)


def _scale(d: int, dtype: torch.dtype) -> torch.Tensor:
    """The JAX wrapper's scale: 1/sqrt(D) rounded to the compute dtype."""
    return torch.tensor(d ** -0.5, dtype=dtype)


def heads_view(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, H*D] with unit last stride -> its [B, H, T, D] view (no copy)."""
    return x.unflatten(-1, (num_heads, x.shape[-1] // num_heads)).transpose(1, 2)


def _into(out, t):
    """t written into the view ``out``, or t itself where there is none."""
    if out is None:
        return t
    out.copy_(t)
    return out


def flash_attention_fwd_plain(q, k, v, seq_len: int | None = None):
    """Plain forward with the JAX kernel's rounding points: q scaled in its
    dtype, f32 scores with keys at or past ``seq_len`` masked, p = exp(s - m)
    in f32, o = (p rounded to v's dtype) v / sum(p), lse = m + log(sum(p)).
    Returns ``(o [B, H, T, D] in q's dtype, lse f32 [B, H, T])``."""
    b, h, t, d = q.shape
    seq_len = t if seq_len is None else int(seq_len)
    dt = q.dtype
    qs = q * _scale(d, dt)
    o = torch.empty(b, h, t, d, dtype=dt, device=q.device)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    for i in range(b):  # one sample at a time bounds the [H, T, T] scores
        s = torch.matmul(qs[i].float(), k[i].float().transpose(-1, -2))
        if seq_len < t:
            s[..., seq_len:] = float("-inf")
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        den = p.sum(-1, keepdim=True)
        o[i] = (torch.matmul(p.to(dt).float(), v[i].float()) / den).to(dt)
        lse[i] = (m + torch.log(den))[..., 0]
    return o, lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, seq_len: int | None = None):
    """Plain backward with the JAX kernels' rounding points: qs = q * scale
    in q's dtype, p = exp(qs k^T - lse) in f32, delta = rowsum(dO * O), ds =
    p * (dO v^T - delta); ds and p rounded to q's dtype before the products
    dk = ds^T qs, dv = p^T dO and dq = ds k, dq rounded to q's dtype and then
    multiplied by the scale in q's dtype. Keys at or past ``seq_len`` get
    dk = dv = 0. Returns ``(dq, dk, dv)`` [B, H, T, D] in q's dtype."""
    b, h, t, d = q.shape
    seq_len = t if seq_len is None else int(seq_len)
    dt = q.dtype
    sc = _scale(d, dt)
    dq, dk, dv = (torch.empty(b, h, t, d, dtype=dt, device=q.device) for _ in range(3))
    for i in range(b):  # one sample at a time bounds the [H, T, T] scores
        qs = (q[i] * sc).float()
        kh, vh, doh = k[i].float(), v[i].float(), do[i].float()
        s = torch.matmul(qs, kh.transpose(-1, -2))
        if seq_len < t:
            s[..., seq_len:] = float("-inf")
        p = torch.exp(s - lse[i].float()[..., None])
        delta = (doh * o[i].float()).sum(-1, keepdim=True)
        ds = (p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta)).to(dt).float()
        dq[i] = torch.matmul(ds, kh).to(dt) * sc
        dk_i = torch.matmul(ds.transpose(-1, -2), qs)
        dv_i = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
        dk_i[:, seq_len:] = 0
        dv_i[:, seq_len:] = 0
        dk[i], dv[i] = dk_i.to(dt), dv_i.to(dt)
    return dq, dk, dv


class TmaGeometry(NamedTuple):
    """A TMA tensor map over a [B, H, T, D] view, innermost dimension first:
    ``dims`` (D, H, T, B), ``strides`` the byte strides of H, T and B,
    ``box`` (C, 1, BOX_ROWS, 1) with C the instance's columns (its width, or
    64 at 128, read as two boxes side by side) and ``swizzle`` the bytes of
    a box row."""

    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]
    box: tuple[int, int, int, int]
    swizzle: int


def tma_geometry(x: torch.Tensor, name: str = "x") -> TmaGeometry:
    """The tensor map through which the flash kernels read the [B, H, T, D]
    view ``x`` (``launch_fwd`` and ``launch_bwd`` in ``csrc/flash_packed.cu``
    encode the same from the element strides they are given): four
    dimensions (d, head, row, batch) with byte strides from the view's
    strides, the true head dim innermost, boxes of :data:`BOX_ROWS` rows of
    one head and the columns of D's :func:`instance` (32 up to D = 32, 64 up
    to 64, two boxes of 64 up to 128; columns at or past D land as zeros),
    swizzled at the box row's bytes (64 or 128). Raises ValueError on a view
    TMA cannot take: a head dim without an instance, a stride along D other
    than 1, or a base address or stride that is not a multiple of 16 bytes.
    Pure arithmetic on the view's shape, strides and address: any device."""
    # messages are formatted only on failure: every flash call runs this
    if x.dim() != 4:
        raise ValueError(f"tma_geometry: {name} must be [B, H, T, D], got {tuple(x.shape)}")
    b, h, t, d = x.shape
    size = x.element_size()
    try:
        cols = min(instance(d), BOX_COLS_MAX)
    except ValueError as e:
        raise ValueError(f"tma_geometry: {name} {e}") from None
    if x.stride(3) != 1:
        raise ValueError(f"tma_geometry: {name} stride along D is {x.stride(3)}, not 1")
    sb, sh, st, _ = x.stride()
    strides = (sh * size, st * size, sb * size)
    if x.data_ptr() % 16 or strides[0] % 16 or strides[1] % 16 or strides[2] % 16:
        raise ValueError(f"tma_geometry: {name} base address {x.data_ptr():#x} or byte "
                         f"strides {strides} not a multiple of 16")
    return TmaGeometry((d, h, t, b), strides, (cols, 1, BOX_ROWS, 1), cols * size)


def _check_view(name, x, shape, device):
    require(x.is_cuda and x.device == device and x.dtype == torch.bfloat16
            and tuple(x.shape) == shape,
            f"flash_attention: {name} must be CUDA bf16 {shape}, got {x.dtype} "
            f"{tuple(x.shape)} {x.device}")
    require(x.stride(-1) == 1 and all(s % 8 == 0 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0,
            f"flash_attention: {name} strides {x.stride()} are not 16-byte-aligned rows")


def _check_inputs(q, k, v, seq_len):
    require(q.dim() == 4, f"flash_attention: want [B, H, T, D], got {tuple(q.shape)}")
    b, h, t, d = q.shape
    try:
        instance(d)
    except ValueError as e:
        raise ValueError(f"flash_attention: {e}") from None
    seq_len = t if seq_len is None else int(seq_len)
    require(0 < seq_len <= t, f"flash_attention: seq_len {seq_len} outside (0, {t}]")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_view(name, x, (b, h, t, d), q.device)
        require(x.stride() == q.stride(), f"flash_attention: {name} strides {x.stride()} "
                f"differ from q's {q.stride()}")
    return b, h, t, d, seq_len


def flash_attention_fwd(q, k, v, seq_len: int | None = None, out=None):
    """Forward kernel over bf16 CUDA [B, H, T, D] views (D from 8 to 128 in
    steps of 8, :func:`instance`; q, k, v sharing strides). ``out``: a [B, H, T, D]
    bf16 view to write o into (any strides the kernel takes), or None for a
    new contiguous one. Returns ``(o, lse f32 [B, H, T])``. CPU tensors take
    :func:`flash_attention_fwd_plain`."""
    if q.device.type == "cpu":
        o, lse = flash_attention_fwd_plain(q, k, v, seq_len)
        return _into(out, o), lse
    b, h, t, d, seq_len = _check_inputs(q, k, v, seq_len)
    for name, x in (("q", q), ("k", k), ("v", v)):
        tma_geometry(x, name=name)
    o = torch.empty(b, h, t, d, dtype=q.dtype, device=q.device) if out is None else out
    _check_view("out", o, (b, h, t, d), q.device)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    err = kernels().ibk_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, t, seq_len, h, d, *q.stride()[:3], *o.stride()[:3], float(_scale(d, q.dtype)),
        stream_ptr(q))
    check_launch(err, "flash_attention")
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, seq_len: int | None = None, out=None):
    """Backward kernels (dk/dv over key tiles, dq over query tiles) over bf16
    CUDA views: q, k, v as in the forward, o and do [B, H, T, D] (any strides
    the kernel takes), lse f32 [B, H, T] contiguous. delta = rowsum(dO * O)
    is plain PyTorch here, as it is XLA in the JAX package. ``out``: (dq,
    dk, dv) bf16 views sharing strides to write into, or None for new
    contiguous ones. Returns ``(dq, dk, dv)``. CPU tensors take
    :func:`flash_attention_bwd_plain`."""
    if q.device.type == "cpu":
        grads = flash_attention_bwd_plain(q, k, v, o, lse, do, seq_len)
        return grads if out is None else tuple(_into(a, g) for a, g in zip(out, grads))
    b, h, t, d, seq_len = _check_inputs(q, k, v, seq_len)
    for name, x in (("o", o), ("do", do)):
        require(x.device == q.device and x.dtype == torch.bfloat16
                and tuple(x.shape) == (b, h, t, d),
                f"flash_attention bwd: {name} must be bf16 {(b, h, t, d)}")
    _check_view("do", do, (b, h, t, d), q.device)
    require(lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, t)
            and lse.is_contiguous() and lse.device == q.device,
            "flash_attention bwd: lse must be contiguous f32 [B, H, T]")
    if out is None:
        out = tuple(torch.empty(b, h, t, d, dtype=q.dtype, device=q.device) for _ in range(3))
    for name, x in zip(("dq", "dk", "dv"), out):
        _check_view(name, x, (b, h, t, d), q.device)
        require(x.stride() == out[0].stride(), "flash_attention bwd: dq, dk and dv must "
                "share strides")
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        tma_geometry(x, name=name)
    delta = (do.float() * o).sum(-1).contiguous()  # o enters the f32 product as it is
    err = kernels().ibk_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(x.data_ptr() for x in out), b, t, seq_len, h, d,
        *q.stride()[:3], *do.stride()[:3], *out[0].stride()[:3],
        float(_scale(d, q.dtype)), stream_ptr(q))
    check_launch(err, "flash_attention_bwd")
    return out


class _FlashAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seq_len, plain):
        fwd = flash_attention_fwd_plain if plain else flash_attention_fwd
        o, lse = fwd(q, k, v, seq_len)
        ctx.seq_len, ctx.plain = seq_len, plain
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), ctx.seq_len)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, seq_len: int | None = None, plain: bool = False):
    """softmax(q k^T / sqrt(D) + key mask) v over [B, H, T, D], the JAX
    ``flash_attention``; differentiable (the backward kernels give dq, dk
    and dv). ``plain`` runs the plain versions (the on-card oracle)."""
    return _FlashAttentionFn.apply(q, k, v, seq_len, plain)


def _split(x):
    d = x.shape[-1] // 3  # q, k, v are column slices: no split copies
    return x[..., :d], x[..., d:2 * d], x[..., 2 * d:]


def flash_attention_packed_layout(q, k, v, num_heads: int, seq_len: int | None = None,
                                  plain: bool = False):
    """The BHTD forward (kernel, or with ``plain`` the plain version) over
    packed [B, T, H*D] tensors, read as [B, H, T, D] views and o written in
    the packed layout: ``(o [B, T, H*D], lse f32 [B, H, T])``."""
    b, t, dm = q.shape
    o = torch.empty(b, t, dm, dtype=q.dtype, device=q.device)
    views = [heads_view(x, num_heads) for x in (q, k, v)]
    if plain:
        oh, lse = flash_attention_fwd_plain(*views, seq_len)
        heads_view(o, num_heads).copy_(oh)
    else:
        lse = flash_attention_fwd(*views, seq_len, out=heads_view(o, num_heads))[1]
    return o, lse


class _FlashQkvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, seq_len, plain):
        o, lse = flash_attention_packed_layout(*_split(qkv), num_heads, seq_len, plain)
        ctx.num_heads, ctx.seq_len, ctx.plain = num_heads, seq_len, plain
        ctx.save_for_backward(qkv, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        h = ctx.num_heads
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        args = [heads_view(x, h) for x in (*_split(qkv), o, do.contiguous())]
        out = tuple(heads_view(g, h) for g in _split(dqkv))
        if ctx.plain:
            for a, g in zip(out, flash_attention_bwd_plain(*args[:4], lse, args[4],
                                                           ctx.seq_len)):
                a.copy_(g)
        else:
            flash_attention_bwd(*args[:4], lse, args[4], ctx.seq_len, out=out)
        return dqkv, None, None, None


def flash_attention_qkv(qkv, num_heads: int, seq_len: int | None = None,
                        plain: bool = False):
    """Differentiable attention over the qkv projection output [B, T, 3*H*D]
    (q | k | v) through the BHTD kernels, by strides: o [B, T, H*D] and
    one gradient [B, T, 3*H*D]. ``plain`` runs the plain versions."""
    return _FlashQkvFn.apply(qkv, num_heads, seq_len, plain)
