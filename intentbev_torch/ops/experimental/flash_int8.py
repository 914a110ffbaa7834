"""Int8 attention over packed [B, T, H*D] tensors (CUDA kernels
``csrc/flash_int8.cu``), forward only.

Counterpart of ``intentbev/ops/experimental/flash_int8.py``
(``_fwd_kernel_int8`` behind ``flash_attention_packed_int8``), a library op
that the model does not call, as in JAX. Per batch and head:

- q and k: symmetric int8 codes per row over the head's D columns,
  ``s = max(absmax, 1e-8) / 127``, ``code = clip(round(x / s), +-127)``
  (round half to even, true division);
- v: one scale per (batch, head) panel, the absmax over every row of the
  tensor, those at or past ``seq_len`` included (JAX pads T to a multiple
  of 384 with zero rows, which add nothing to an absmax);
- scores ``(f32(qq kq^T) * (qs * scale)) * ks`` with the f32 scale
  1/sqrt(D) (not the scale rounded to bf16 that the bf16 packed kernels
  take), keys at or past ``seq_len`` masked;
- ``p = exp(s - m)`` with m the row's max over all its keys, ``denom`` the
  f32 sum of the unquantized p, P's codes ``round(p * 127)``;
- ``o = (f32(pq vq) * (sv / 127)) / denom`` in q's dtype.

The integer products are exact, so the kernel may sum the keys in any
order; only ``denom`` is an f32 sum whose order differs from JAX's.
:func:`flash_attention_packed_int8` takes bf16 or f32 CUDA tensors with head
dims :data:`HEAD_DIMS`, the head dims of JAX's op that divide 128 but 8 and
below, which raise. CPU tensors take
:func:`flash_attention_packed_int8_plain`.
"""

from __future__ import annotations

import torch

from .._build import check_launch, kernels, require, stream_ptr
from ..flash_packed import LANE_BLOCK, pad_len
from ..int8 import int_matmul

HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernels are instantiated for
DTYPES = (torch.bfloat16, torch.float32)  # input dtypes the kernels are instantiated for
NEG_INF = -1e30  # the JAX key bias past seq_len (intentbev/ops/flash_attention.py)
KEY_TILE = 128  # the kernels' key tile: their code buffers hold T rounded up to it
CONTROL_TILE = 64  # keys a tile of the faulty p_max="tile" variant


def _head_dim(dm: int, num_heads: int) -> int:
    """The head dim, where the heads pair into 128 lanes as the JAX op
    asserts (``_heads_per_block``)."""
    dh = dm // num_heads
    if dh * num_heads != dm or LANE_BLOCK % dh or num_heads % (LANE_BLOCK // dh):
        raise ValueError(f"flash_attention_packed_int8: {num_heads} heads over {dm} lanes do "
                         f"not pair into {LANE_BLOCK}-lane blocks")
    return dh


def _codes(x: torch.Tensor, absmax: torch.Tensor):
    """``(clip(round(x / s), +-127), s)`` with ``s = max(absmax, 1e-8) /
    127``, both divisions IEEE (a device tensor divisor: ``ops/int8.py``)."""
    s = absmax.clamp(min=1e-8) / torch.full((), 127.0, device=x.device)
    return torch.clamp(torch.round(x / s), -127, 127), s


def head_scores(qh, kh, scale, bias):
    """``s = (f32(qq kq^T) * (qs * scale)) * ks + bias`` of one sample's
    heads: qh, kh [H, T, D] f32 -> [H, T, T] f32."""
    qq, qs = _codes(qh, qh.abs().amax(-1, keepdim=True))
    kq, ks = _codes(kh, kh.abs().amax(-1, keepdim=True))
    return int_matmul(qq, kq.transpose(-1, -2)) * (qs * scale) * ks.transpose(-1, -2) + bias


def flash_attention_packed_int8_plain(q, k, v, num_heads: int, seq_len: int | None = None,
                                      p_max: str = "row"):
    """Plain PyTorch version with the JAX kernel's rounding points (module
    doc): codes and scales in f32, integer products exact (float64),
    returns o [B, T, H*D] in q's dtype. ``p_max="tile"`` is a faulty variant
    kept for the checks' control: P's codes rounded against a running max
    over :data:`CONTROL_TILE`-key tiles, as an online softmax would, with
    the accumulators rescaled."""
    b, t, dm = q.shape
    dh = _head_dim(dm, num_heads)
    seq_len = t if seq_len is None else int(seq_len)
    scale = torch.tensor(dh ** -0.5, dtype=torch.float32, device=q.device)
    c127 = torch.full((), 127.0, device=q.device)
    bias = torch.zeros(t, device=q.device)
    bias[seq_len:] = NEG_INF

    def heads(x):  # one sample [T, H*D] -> [H, T, D] f32
        return x.reshape(t, num_heads, dh).transpose(0, 1).float()

    o = torch.empty(b, t, dm, dtype=q.dtype, device=q.device)
    for i in range(b):  # one sample at a time bounds the [H, T, T] scores
        vh = heads(v[i])
        vq, sv = _codes(vh, vh.abs().amax((-2, -1), keepdim=True))
        s = head_scores(heads(q[i]), heads(k[i]), scale, bias)
        if p_max == "row":
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            denom = p.sum(-1, keepdim=True)
            o32 = int_matmul(torch.round(p * 127.0), vq)
        else:
            o32, denom, m = 0.0, 0.0, None
            for j in range(0, t, CONTROL_TILE):
                st = s[..., j:j + CONTROL_TILE]
                m_new = st.amax(-1, keepdim=True) if m is None else torch.maximum(
                    m, st.amax(-1, keepdim=True))
                alpha = 1.0 if m is None else torch.exp(m - m_new)
                p = torch.exp(st - m_new)
                o32 = o32 * alpha + int_matmul(torch.round(p * 127.0), vq[:, j:j + CONTROL_TILE])
                denom = denom * alpha + p.sum(-1, keepdim=True)
                m = m_new
        oh = o32 * (sv / c127) / denom
        o[i] = oh.transpose(0, 1).reshape(t, dm).to(q.dtype)
    return o


def _check_qkv(q, k, v, num_heads, seq_len):
    """-> (b, t, dm, head dim, seq_len) of CUDA q, k, v of one dtype of
    :data:`DTYPES` that share 16-byte-aligned rows (strided views of one qkv
    tensor pass). The head dim is checked first, on any device."""
    b, t, dm = q.shape
    dh = _head_dim(dm, num_heads)
    require(dh in HEAD_DIMS, f"flash_int8: the kernels are built for head dims {HEAD_DIMS}, "
                             f"got head dim {dh} ({dm} over {num_heads} heads)")
    seq_len = t if seq_len is None else int(seq_len)
    require(0 < seq_len <= t, f"flash_int8: seq_len {seq_len} outside (0, {t}]")
    require(q.dtype in DTYPES, f"flash_int8: the kernels take {DTYPES}, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        require(x.is_cuda and x.device == q.device and x.dtype == q.dtype
                and tuple(x.shape) == (b, t, dm),
                f"flash_int8: {name} must be {q.dtype} {(b, t, dm)} on {q.device}, got "
                f"{x.dtype} {tuple(x.shape)} {x.device}")
        require(x.stride() == q.stride() and x.stride(-1) == 1
                and x.stride(1) % 8 == 0 and x.stride(0) % 8 == 0 and x.data_ptr() % 16 == 0,
                f"flash_int8: {name} strides {x.stride()} not shared 16-byte-aligned rows")
    return b, t, dm, dh, seq_len


def flash_attention_packed_int8(q, k, v, num_heads: int, seq_len: int | None = None):
    """Int8 attention over bf16 or f32 CUDA [B, T, H*D] tensors (head dims
    :data:`HEAD_DIMS`, heads that pair into 128 lanes); o in q's dtype. A
    pre-pass quantizes k and v once (codes, row scales of k, the panel
    scale of v), then the attention kernel quantizes q and takes two passes
    over the key tiles. CPU tensors take
    :func:`flash_attention_packed_int8_plain`."""
    if q.device.type == "cpu":
        return flash_attention_packed_int8_plain(q, k, v, num_heads, seq_len)
    b, t, dm, dh, seq_len = _check_qkv(q, k, v, num_heads, seq_len)
    dev, tk = q.device, pad_len(t, KEY_TILE)
    kq = torch.empty(b, num_heads, tk, max(dh, 64), dtype=torch.int8, device=dev)
    vq = torch.empty(b, num_heads, dh, tk, dtype=torch.int8, device=dev)
    ks = torch.empty(b, num_heads, tk, dtype=torch.float32, device=dev)
    vmax = torch.empty(b, num_heads, tk // KEY_TILE, dtype=torch.float32, device=dev)
    sv = torch.empty(b, num_heads, dtype=torch.float32, device=dev)
    o = torch.empty(b, t, dm, dtype=q.dtype, device=dev)
    err = kernels().ibk_flash_int8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), kq.data_ptr(), vq.data_ptr(),
        ks.data_ptr(), vmax.data_ptr(), sv.data_ptr(), b, t, seq_len, num_heads, dh,
        int(q.dtype == torch.float32), q.stride(1), q.stride(0), dh ** -0.5, stream_ptr(q))
    check_launch(err, "flash_int8")
    return o
