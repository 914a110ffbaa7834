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

Head dims: every head dim D >= 1 (:func:`instance`). The kernels are
instantiated for the widths :data:`HEAD_DIMS` (32, 64, 128) and take D up to
128 on the smallest instance at least D: TMA reads the columns from D to the
instance's width as zeros, and the epilogues write only the first D. Above
128 the chunked kernels take it: each block owns :data:`CHUNK_COLS` columns
of its output and reduces the scores over the whole head, with q scaled
before the kernels as the JAX wrapper scales it. A head's row of 2*D bytes
is a stride TMA takes only where D is a multiple of 8: other heads are
copied into zero-filled rows of D rounded up to 8 columns, the kernels get
views of their first D columns (the true D and its scale, never the padded
width), write into padded rows and the d columns are copied back (layout
only, as JAX's fallback transposes).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import check_launch, kernels, require, stream_ptr

HEAD_DIMS = (32, 64, 128)  # the kernels' instance widths (csrc/flash_packed.cu Inst)
CHUNK_COLS = 128  # output columns a block of the chunked kernels owns (head dims above 128)
ROW_STEP = 8  # a head's row TMA can stride: a multiple of 8 bf16 columns (16 bytes)
BOX_ROWS = 64  # rows of one TMA box of the flash kernels
BOX_COLS_MAX = 64  # columns of the widest box (128-byte rows, the widest swizzle)
# f32 elements of one group of heads' [T, T] scores in the plain versions
# (1 GiB): 96 heads of a 4501-token sample would take 7.8 GB at once
PLAIN_SCORES = 1 << 28


class Plan(NamedTuple):
    """How the kernels run head dim D: ``inst`` the instance (its box
    columns), ``chunks`` the blocks over a head's output columns (1 up to
    128), ``padded`` the row a head needs for TMA (D rounded up to 8)."""

    inst: int
    chunks: int
    padded: int


def instance(d: int) -> Plan:
    """The plan of head dim ``d`` (``csrc/flash_packed.cu::plan_of`` mirrors
    it): the smallest of :data:`HEAD_DIMS` at least ``d`` (above 128, the
    chunked kernels on the 128 instance's layout), ceil(d / 128) output
    chunks, and ``d`` rounded up to :data:`ROW_STEP`. Raises ValueError for
    ``d`` < 1."""
    if d < 1:
        raise ValueError(f"head dim {d} has no flash kernel instance: the kernels take 1 and up")
    return Plan(next((w for w in HEAD_DIMS if w >= d), CHUNK_COLS), -(-d // CHUNK_COLS),
                -(-d // ROW_STEP) * ROW_STEP)


def kernel_plan(d: int) -> Plan:
    """The kernel library's own plan of head dim ``d``
    (``ibk_flash_plan``), which :func:`instance` mirrors; builds the
    library."""
    out = (ctypes.c_int * 3)()
    require(kernels().ibk_flash_plan(d, out) == 0,
            f"head dim {d} has no flash kernel instance in the library")
    return Plan(*out)


def head_groups(h: int, t: int):
    """Slices of ``h`` heads whose f32 [T, T] scores stay under
    :data:`PLAIN_SCORES` elements together (the plain versions' loop)."""
    g = max(1, PLAIN_SCORES // (t * t))
    return [slice(i, min(i + g, h)) for i in range(0, h, g)]


def padded_rows(x: torch.Tensor, padded: int) -> torch.Tensor:
    """``x`` [..., d] copied into zero-filled rows of ``padded`` columns; the
    view of their first d (rows TMA can stride; its columns past d are never
    read: the map's innermost dimension is d)."""
    buf = x.new_zeros(*x.shape[:-1], padded)
    buf[..., :x.shape[-1]] = x
    return buf[..., :x.shape[-1]]


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
    for i in range(b):  # a sample and a group of heads at a time bound the scores
        for g in head_groups(h, t):
            s = torch.matmul(qs[i, g].float(), k[i, g].float().transpose(-1, -2))
            if seq_len < t:
                s[..., seq_len:] = float("-inf")
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            den = p.sum(-1, keepdim=True)
            o[i, g] = (torch.matmul(p.to(dt).float(), v[i, g].float()) / den).to(dt)
            lse[i, g] = (m + torch.log(den))[..., 0]
            del s, p
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
    for i in range(b):  # a sample and a group of heads at a time bound the scores
        for g in head_groups(h, t):
            qs = (q[i, g] * sc).float()
            kh, vh, doh = k[i, g].float(), v[i, g].float(), do[i, g].float()
            s = torch.matmul(qs, kh.transpose(-1, -2))
            if seq_len < t:
                s[..., seq_len:] = float("-inf")
            p = torch.exp(s - lse[i, g].float()[..., None])
            del s
            delta = (doh * o[i, g].float()).sum(-1, keepdim=True)
            ds = (p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta)).to(dt).float()
            dq[i, g] = torch.matmul(ds, kh).to(dt) * sc
            dk_i = torch.matmul(ds.transpose(-1, -2), qs)
            dv_i = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
            dk_i[:, seq_len:] = 0
            dv_i[:, seq_len:] = 0
            dk[i, g], dv[i, g] = dk_i.to(dt), dv_i.to(dt)
            del p, ds
    return dq, dk, dv


class TmaGeometry(NamedTuple):
    """A TMA tensor map over a [B, H, T, D] view, innermost dimension first:
    ``dims`` (D, H, T, B), ``strides`` the byte strides of H, T and B,
    ``box`` (C, 1, BOX_ROWS, 1) with C the instance's columns (its width, or
    64 at 128 and above, read as boxes side by side) and ``swizzle`` the
    bytes of a box row."""

    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]
    box: tuple[int, int, int, int]
    swizzle: int


def tma_geometry(x: torch.Tensor, name: str = "x") -> TmaGeometry:
    """The tensor map through which the flash kernels read the [B, H, T, D]
    view ``x`` (``csrc/flash_packed.cu`` encodes the same from the element
    strides it is given): four dimensions (d, head, row, batch) with byte
    strides from the view's strides, the true head dim innermost, boxes of
    :data:`BOX_ROWS` rows of one head and the columns of D's
    :func:`instance` (32 up to D = 32, 64 above), swizzled at the box row's
    bytes (64 or 128). Raises ValueError on a view TMA cannot take: a stride
    along D other than 1, or a base address or stride that is not a
    multiple of 16 bytes (an unpadded head dim off a multiple of 8). Pure
    arithmetic on the view's shape, strides and address: any device."""
    # messages are formatted only on failure: every flash call runs this
    if x.dim() != 4:
        raise ValueError(f"tma_geometry: {name} must be [B, H, T, D], got {tuple(x.shape)}")
    b, h, t, d = x.shape
    size = x.element_size()
    try:
        plan = instance(d)
    except ValueError as e:
        raise ValueError(f"tma_geometry: {name} {e}") from None
    cols = min(plan.inst, BOX_COLS_MAX)
    if x.stride(3) != 1:
        raise ValueError(f"tma_geometry: {name} stride along D is {x.stride(3)}, not 1")
    sb, sh, st, _ = x.stride()
    strides = (sh * size, st * size, sb * size)
    if x.data_ptr() % 16 or strides[0] % 16 or strides[1] % 16 or strides[2] % 16:
        raise ValueError(f"tma_geometry: {name} base address {x.data_ptr():#x} or byte "
                         f"strides {strides} not 16-byte aligned (head dim {d}: rows of "
                         f"{plan.padded} columns)")
    return TmaGeometry((d, h, t, b), strides, (cols, 1, BOX_ROWS, 1), cols * size)


def _check_inputs(q, k, v, seq_len):
    """-> (b, h, t, d, seq_len, plan) of bf16 CUDA q, k, v of one shape."""
    require(q.dim() == 4, f"flash_attention: want [B, H, T, D], got {tuple(q.shape)}")
    b, h, t, d = q.shape
    try:
        plan = instance(d)
    except ValueError as e:
        raise ValueError(f"flash_attention: {e}") from None
    seq_len = t if seq_len is None else int(seq_len)
    require(0 < seq_len <= t, f"flash_attention: seq_len {seq_len} outside (0, {t}]")
    for name, x in (("q", q), ("k", k), ("v", v)):
        require(x.is_cuda and x.device == q.device and x.dtype == torch.bfloat16
                and tuple(x.shape) == (b, h, t, d),
                f"flash_attention: {name} must be CUDA bf16 {(b, h, t, d)}, got {x.dtype} "
                f"{tuple(x.shape)} {x.device}")
    return b, h, t, d, seq_len, plan


def _kernel_inputs(q, k, v, plan):
    """(q or qh, k, v) as the kernels read them: rows padded where D is off
    a multiple of 8; above 128, q as qh = q * scale in its dtype (the JAX
    wrapper's scaling, before its kernels). k and v share strides."""
    if plan.chunks > 1:
        q = q * _scale(q.shape[-1], q.dtype)
    if plan.padded != q.shape[-1]:
        q, k, v = (padded_rows(x, plan.padded) for x in (q, k, v))
    elif plan.chunks > 1:
        q = q.contiguous()
    require(k.stride() == v.stride() and (plan.chunks > 1 or q.stride() == k.stride()),
            f"flash_attention: q, k and v strides {q.stride()}, {k.stride()}, {v.stride()} "
            "differ")
    for name, x in (("q", q), ("k", k), ("v", v)):
        tma_geometry(x, name=name)
    return q, k, v


def _writable(x, plan):
    """A view the kernels can write ``x``'s values into: ``x`` itself, or
    padded rows where its D is off a multiple of 8 (or its strides are not
    16-byte rows)."""
    ok = (plan.padded == x.shape[-1] and x.stride(-1) == 1
          and all(s % 8 == 0 for s in x.stride()[:3]) and x.data_ptr() % 16 == 0)
    return x if ok else torch.empty(*x.shape[:-1], plan.padded, dtype=x.dtype,
                                    device=x.device)[..., :x.shape[-1]]


def flash_attention_fwd(q, k, v, seq_len: int | None = None, out=None):
    """Forward kernel over bf16 CUDA [B, H, T, D] views (any D >= 1,
    :func:`instance`; q, k, v of one shape). ``out``: a [B, H, T, D] bf16
    view to write o into, or None for a new one. Returns ``(o, lse f32 [B,
    H, T])``. CPU tensors take :func:`flash_attention_fwd_plain`."""
    if q.device.type == "cpu":
        o, lse = flash_attention_fwd_plain(q, k, v, seq_len)
        return _into(out, o), lse
    b, h, t, d, seq_len, plan = _check_inputs(q, k, v, seq_len)
    qk, kk, vk = _kernel_inputs(q, k, v, plan)
    o = torch.empty(b, h, t, d, dtype=q.dtype, device=q.device) if out is None else out
    require(o.is_cuda and o.device == q.device and o.dtype == torch.bfloat16
            and tuple(o.shape) == (b, h, t, d),
            f"flash_attention: out must be a CUDA bf16 {(b, h, t, d)} view")
    ok = _writable(o, plan)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    if plan.chunks > 1:
        err = kernels().ibk_flash_attn_wide_fwd(
            qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), ok.data_ptr(), lse.data_ptr(), b, t,
            seq_len, h, d, *qk.stride()[:3], *kk.stride()[:3], *ok.stride()[:3], stream_ptr(q))
    else:
        err = kernels().ibk_flash_attn_fwd(
            qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), ok.data_ptr(), lse.data_ptr(), b, t,
            seq_len, h, d, *kk.stride()[:3], *ok.stride()[:3], float(_scale(d, q.dtype)),
            stream_ptr(q))
    check_launch(err, "flash_attention")
    if ok is not o:
        o.copy_(ok)
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, seq_len: int | None = None, out=None):
    """Backward kernels (dk/dv over key tiles, dq over query tiles) over bf16
    CUDA views: q, k, v as in the forward, o and do [B, H, T, D], lse f32
    [B, H, T] contiguous. delta = rowsum(dO * O) is plain PyTorch here, as it
    is XLA in the JAX package. ``out``: (dq, dk, dv) bf16 views sharing
    strides to write into, or None for new contiguous ones. Returns ``(dq,
    dk, dv)``. CPU tensors take :func:`flash_attention_bwd_plain`."""
    if q.device.type == "cpu":
        grads = flash_attention_bwd_plain(q, k, v, o, lse, do, seq_len)
        return grads if out is None else tuple(_into(a, g) for a, g in zip(out, grads))
    b, h, t, d, seq_len, plan = _check_inputs(q, k, v, seq_len)
    for name, x in (("o", o), ("do", do)):
        require(x.device == q.device and x.dtype == torch.bfloat16
                and tuple(x.shape) == (b, h, t, d),
                f"flash_attention bwd: {name} must be bf16 {(b, h, t, d)}")
    require(lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, t)
            and lse.is_contiguous() and lse.device == q.device,
            "flash_attention bwd: lse must be contiguous f32 [B, H, T]")
    if out is None:
        out = tuple(torch.empty(b, h, t, d, dtype=q.dtype, device=q.device) for _ in range(3))
    for name, x in zip(("dq", "dk", "dv"), out):
        require(x.is_cuda and x.device == q.device and x.dtype == torch.bfloat16
                and tuple(x.shape) == (b, h, t, d) and x.stride() == out[0].stride(),
                f"flash_attention bwd: {name} must be a CUDA bf16 {(b, h, t, d)} view sharing "
                "dq's strides")
    delta = (do.float() * o).sum(-1).contiguous()  # o enters the f32 product as it is
    qk, kk, vk = _kernel_inputs(q, k, v, plan)
    dok = padded_rows(do, plan.padded) if plan.padded != d else do
    tma_geometry(dok, name="do")
    grads = out
    if _writable(out[0], plan) is not out[0]:  # into padded rows, copied after
        buf = torch.empty(3, b, h, t, plan.padded, dtype=q.dtype, device=q.device)[..., :d]
        grads = tuple(buf)
    if plan.chunks > 1:
        err = kernels().ibk_flash_attn_wide_bwd(
            qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), dok.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(x.data_ptr() for x in grads), b, t, seq_len, h, d,
            *qk.stride()[:3], *kk.stride()[:3], *dok.stride()[:3], *grads[0].stride()[:3],
            float(_scale(d, q.dtype)), stream_ptr(q))
    else:
        err = kernels().ibk_flash_attn_bwd(
            qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), dok.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(x.data_ptr() for x in grads), b, t, seq_len, h, d,
            *kk.stride()[:3], *dok.stride()[:3], *grads[0].stride()[:3],
            float(_scale(d, q.dtype)), stream_ptr(q))
    check_launch(err, "flash_attention_bwd")
    if grads is not out:
        for a, g in zip(out, grads):
            a.copy_(g)
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
