"""Attention forward over packed [B, T, H*D] tensors, returning O and lse
(CUDA kernel ``csrc/flash_packed.cu``).

Counterpart of ``intentbev/ops/flash_packed.py`` (``_fwd`` and
``_fwd_chunked``; forward only). Keys at or past ``seq_len`` are masked,
so callers need not pad: the kernel takes any T. q, k and v may be column
slices of one qkv projection output (same strides, unit last stride).
"""

from __future__ import annotations

import torch

from ._build import check_launch, kernels, require, stream_ptr


def flash_attention_packed_plain(q, k, v, num_heads: int,
                                 seq_len: int | None = None):
    """Plain PyTorch version with the JAX kernel's rounding points: q scaled
    in its own dtype, f32 scores and softmax, P rounded to v's dtype before
    PV. Returns ``(o [B, T, H*D] in q's dtype, lse f32 [B, H, T])``."""
    b, t, dm = q.shape
    dh = dm // num_heads
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


def flash_attention_packed(q, k, v, num_heads: int, seq_len: int | None = None):
    """softmax(q k^T / sqrt(D) + key mask) v per head over [B, T, H*64]
    bf16 CUDA tensors; returns ``(o, lse)``. CPU tensors take
    :func:`flash_attention_packed_plain`."""
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
