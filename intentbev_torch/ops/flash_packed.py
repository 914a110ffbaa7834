"""Attention over packed [B, T, H*D] tensors (CUDA kernels
``csrc/flash_packed.cu``): forward with O and lse, and the backward.

Counterpart of ``intentbev/ops/flash_packed.py`` (``_fwd``, ``_fwd_chunked``
and ``_bwd_fused``). Keys at or past ``seq_len`` are masked, so callers need
not pad: the kernels take any T. q, k and v may be column slices of one qkv
projection output (same strides, unit last stride); the backward writes
dq, dk and dv into one gradient of that output. :func:`flash_attention_fn`
is the differentiable entry over the qkv output. :func:`reference_attention`
is the dense attention the JAX model runs where ``use_flash_attention`` is
off, in plain PyTorch.

Dispatch as in JAX (``intentbev/ops/flash_packed.py:778``): a head layout
whose heads do not pair into 128 lanes (:func:`pairs_heads`, e.g. ViT-Ti's
3 heads of 64) goes to the BHTD kernels of :mod:`.flash_attention`, over
strided views of the same tensors, from :func:`flash_attention_packed`,
:func:`flash_attention_packed_plain` and :func:`flash_attention_fn`; JAX's
fallback ignores ``kv_chunk`` and ``unsafe_softmax``, which the port's
entries do not take.
"""

from __future__ import annotations

import torch

from ._build import check_launch, kernels, require, stream_ptr
from .flash_attention import flash_attention_packed_layout, flash_attention_qkv

LANE_BLOCK = 128  # the JAX packed kernels' lane block


def pairs_heads(head_dim: int, num_heads: int) -> bool:
    """Whether the heads pair into 128 lanes, the JAX packed kernels' layout
    (``intentbev/ops/flash_packed.py:778``); any other layout takes the BHTD
    kernels."""
    return LANE_BLOCK % head_dim == 0 and num_heads % (LANE_BLOCK // head_dim) == 0


def flash_attention_packed_plain(q, k, v, num_heads: int,
                                 seq_len: int | None = None):
    """Plain PyTorch version with the JAX kernel's rounding points: q scaled
    in its own dtype, f32 scores and softmax, P rounded to v's dtype before
    PV. Returns ``(o [B, T, H*D] in q's dtype, lse f32 [B, H, T])``. Heads
    that do not pair take the BHTD plain version."""
    b, t, dm = q.shape
    dh = dm // num_heads
    if not pairs_heads(dh, num_heads):
        return flash_attention_packed_layout(q, k, v, num_heads, seq_len, plain=True)
    seq_len = t if seq_len is None else int(seq_len)
    dt = q.dtype
    scale = dh ** -0.5

    def heads(x):  # one sample [T, H*D] -> [H, T, D]
        return x.reshape(t, num_heads, dh).transpose(0, 1)

    o = torch.empty(b, t, dm, dtype=dt, device=q.device)
    lse = torch.empty(b, num_heads, t, dtype=torch.float32, device=q.device)
    for i in range(b):  # one sample at a time bounds the [H, T, T] scores
        qh = (heads(q[i]).float() * scale).to(dt).float()
        kh = heads(k[i]).float()
        vh = heads(v[i]).float()
        s = torch.matmul(qh, kh.transpose(-1, -2))
        if seq_len < t:
            s[..., seq_len:] = float("-inf")
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        den = p.sum(-1, keepdim=True)
        oh = torch.matmul(p.to(dt).float(), vh) / den
        o[i] = oh.transpose(0, 1).reshape(t, dm).to(dt)
        lse[i] = (m + torch.log(den))[..., 0]
    return o, lse


def reference_attention(q, k, v, num_heads: int, kv_len: int | None = None):
    """Dense softmax(q k^T / sqrt(D)) v over packed [B, T, H*D] tensors, a
    copy of ``intentbev/ops/attention.py::reference_attention`` (which takes
    [B, H, T, D]) with its rounding points: f32 logits from q and k as they
    are, the scale and softmax in f32, the probabilities cast to v's dtype
    for the product with v. Keys at or past ``kv_len`` are masked (-1e30).
    Differentiable by autograd; on CUDA tensors it is cuBLAS, as the JAX
    path is XLA."""
    b, t, dm = q.shape
    dh = dm // num_heads

    def heads(x):  # [B, T, H*D] -> [B, H, T, D]
        return x.reshape(b, t, num_heads, dh).transpose(1, 2)

    logits = torch.matmul(heads(q).float(), heads(k).float().transpose(-1, -2))
    if kv_len is not None and kv_len < t:
        logits = logits.masked_fill(torch.arange(t, device=q.device) >= kv_len, -1e30)
    probs = torch.softmax(logits * (1.0 / dh ** 0.5), dim=-1)
    out = torch.matmul(probs.to(v.dtype), heads(v))
    return out.transpose(1, 2).reshape(b, t, dm)


def flash_attention_packed(q, k, v, num_heads: int, seq_len: int | None = None):
    """softmax(q k^T / sqrt(D) + key mask) v per head over [B, T, H*64]
    bf16 CUDA tensors; returns ``(o, lse)``. Heads that do not pair take the
    BHTD kernel (:mod:`.flash_attention`). CPU tensors take
    :func:`flash_attention_packed_plain`."""
    if not pairs_heads(q.shape[-1] // num_heads, num_heads):
        return flash_attention_packed_layout(q, k, v, num_heads, seq_len)
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, num_heads, seq_len)
    b, t, dm = q.shape
    seq_len = t if seq_len is None else int(seq_len)
    require(0 < seq_len <= t, f"flash: seq_len {seq_len} outside (0, {t}]")
    require(dm == num_heads * 64, f"flash kernel is built for head dim 64, got {dm}/{num_heads}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        require(x.is_cuda and x.device == q.device and x.dtype == torch.bfloat16
                and tuple(x.shape) == (b, t, dm),
                f"flash: {name} must be CUDA bf16 {(b, t, dm)}, got "
                f"{x.dtype} {tuple(x.shape)} {x.device}")
        require(x.stride() == q.stride() and x.stride(-1) == 1
                and x.stride(1) % 8 == 0 and x.stride(0) % 8 == 0
                and x.data_ptr() % 16 == 0,
                f"flash: {name} strides {x.stride()} not shared 16-byte-aligned rows")
    o = torch.empty(b, t, dm, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, num_heads, t, dtype=torch.float32, device=q.device)
    err = kernels().ibk_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, t, seq_len, num_heads, q.stride(1), q.stride(0), 64 ** -0.5,
        stream_ptr(q))
    check_launch(err, "flash_packed")
    return o, lse


def flash_attention_packed_bwd_plain(q, k, v, o, lse, do, num_heads: int,
                                     seq_len: int | None = None):
    """Plain backward with the JAX kernel's rounding points: qh = q * scale
    in q's dtype, p = exp(qh k^T - lse) in f32, delta = rowsum(dO * O) per
    head, t = p * (dO v^T - delta); p and t rounded to q's dtype before the
    products dv = p^T dO, dk = t^T qh and dq = scale * t k. Keys at or past
    ``seq_len`` get dk = dv = 0. Returns dqkv [B, T, 3*H*D] in q's dtype."""
    b, t, dm = q.shape
    dh = dm // num_heads
    seq_len = t if seq_len is None else int(seq_len)
    dt = q.dtype
    scale = dh ** -0.5

    def heads(x):  # one sample [T, H*D] -> [H, T, D] f32
        return x.reshape(t, num_heads, dh).transpose(0, 1).float()

    dqkv = torch.empty(b, t, 3 * dm, dtype=dt, device=q.device)
    for i in range(b):  # one sample at a time bounds the [H, T, T] scores
        qh = (heads(q[i]) * scale).to(dt).float()
        kh, vh, oh, doh = heads(k[i]), heads(v[i]), heads(o[i]), heads(do[i])
        s = torch.matmul(qh, kh.transpose(-1, -2))
        if seq_len < t:
            s[..., seq_len:] = float("-inf")
        p = torch.exp(s - lse[i].float()[..., None])
        delta = (doh * oh).sum(-1, keepdim=True)
        tt = (p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta)).to(dt).float()
        dv = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
        dk = torch.matmul(tt.transpose(-1, -2), qh)
        dq = torch.matmul(tt, kh) * scale
        dk[:, seq_len:] = 0
        dv[:, seq_len:] = 0
        for j, g in enumerate((dq, dk, dv)):
            dqkv[i, :, j * dm:(j + 1) * dm] = g.transpose(0, 1).reshape(t, dm).to(dt)
    return dqkv


def flash_attention_packed_bwd(q, k, v, o, lse, do, num_heads: int,
                               seq_len: int | None = None):
    """Backward kernels over bf16 CUDA tensors: q, k, v as in the forward
    (column slices allowed), o and do [B, T, H*64], lse f32 [B, H, T].
    delta = rowsum(dO * O) per head is plain PyTorch here, as it is XLA in
    the JAX package. Returns dqkv [B, T, 3*H*64] bf16. CPU tensors take
    :func:`flash_attention_packed_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_attention_packed_bwd_plain(q, k, v, o, lse, do, num_heads, seq_len)
    b, t, dm = q.shape
    seq_len = t if seq_len is None else int(seq_len)
    require(0 < seq_len <= t, f"flash bwd: seq_len {seq_len} outside (0, {t}]")
    require(dm == num_heads * 64, f"flash kernel is built for head dim 64, got {dm}/{num_heads}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        require(x.is_cuda and x.device == q.device and x.dtype == torch.bfloat16
                and tuple(x.shape) == (b, t, dm) and x.stride() == q.stride()
                and x.stride(-1) == 1 and x.stride(1) % 8 == 0 and x.stride(0) % 8 == 0
                and x.data_ptr() % 16 == 0,
                f"flash bwd: {name} must be CUDA bf16 {(b, t, dm)} with shared "
                f"16-byte-aligned rows, got {x.dtype} {tuple(x.shape)} {x.stride()}")
    do = do.contiguous()
    for name, x in (("o", o), ("do", do)):
        require(x.device == q.device and x.dtype == torch.bfloat16
                and tuple(x.shape) == (b, t, dm), f"flash bwd: {name} must be bf16 {(b, t, dm)}")
    require(lse.dtype == torch.float32 and tuple(lse.shape) == (b, num_heads, t)
            and lse.is_contiguous(), "flash bwd: lse must be contiguous f32 [B, H, T]")
    delta = (do.float() * o.float()).reshape(b, t, num_heads, dm // num_heads) \
        .sum(-1).transpose(1, 2).contiguous()
    dqkv = torch.empty(b, t, 3 * dm, dtype=q.dtype, device=q.device)
    err = kernels().ibk_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dqkv.data_ptr(), b, t, seq_len, num_heads, q.stride(1),
        q.stride(0), 64 ** -0.5, stream_ptr(q))
    check_launch(err, "flash_packed_bwd")
    return dqkv


class _FlashFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, seq_len, plain):
        d = qkv.shape[-1] // 3
        fwd = flash_attention_packed_plain if plain else flash_attention_packed
        o, lse = fwd(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], num_heads, seq_len)
        ctx.num_heads, ctx.seq_len, ctx.plain = num_heads, seq_len, plain
        ctx.save_for_backward(qkv, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        d = qkv.shape[-1] // 3
        bwd = flash_attention_packed_bwd_plain if ctx.plain else flash_attention_packed_bwd
        dqkv = bwd(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], o, lse, do,
                   ctx.num_heads, ctx.seq_len)
        return dqkv, None, None, None


def flash_attention_fn(qkv, num_heads: int, seq_len: int | None = None,
                       plain: bool = False):
    """Differentiable attention over the qkv projection output [B, T, 3*H*D]
    (q | k | v): the forward kernel saves O and lse, the backward kernels
    return the gradient of qkv. Heads that do not pair take the BHTD kernels
    (:func:`.flash_attention.flash_attention_qkv`). ``plain`` runs the plain
    versions."""
    if not pairs_heads(qkv.shape[-1] // 3 // num_heads, num_heads):
        return flash_attention_qkv(qkv, num_heads, seq_len, plain)
    return _FlashFn.apply(qkv, num_heads, seq_len, plain)
