"""Attention over packed [B, T, H*D] tensors (CUDA kernels
``csrc/flash_packed.cu``): forward with O and lse, and the backward.

Counterpart of ``intentbev/ops/flash_packed.py`` (``_fwd``, ``_fwd_chunked``
and ``_bwd``). Keys at or past ``seq_len`` are masked, so callers need
not pad: the kernels take any T. q, k and v may be column slices of one
qkv projection output (same strides, unit last stride); the backward writes
dq, dk and dv into one gradient of that output. :func:`flash_attention_fn`
is the differentiable entry over the qkv output. :func:`reference_attention`
is the dense attention the JAX model runs where ``use_flash_attention`` is
off, in plain PyTorch.

The packed kernels are built for head dims :data:`HEAD_DIMS` (32 and 64);
any other head dim whose heads pair raises on CUDA. As in JAX, q is scaled
in its own dtype by 1/sqrt(D) rounded to that dtype, and the epilogues of dq
(and of dk, where the scale comes last) multiply by the f32 scale.

The backward takes JAX's three forms (``_bwd``, ``:649-660``), chosen by
explicit arguments where JAX reads ``INTENTBEV_BWD_FUSED`` and
``INTENTBEV_BWD_KV_CHUNK`` at import: ``bwd_fused`` (default) runs the
fused kernel's rounding; ``bwd_fused=False`` the split kernels'
(``_bwd_dq_kernel``, ``_bwd_dkv_kernel``), or, where ``bwd_kv_chunk``
divides JAX's padded length, the chunked ones' (:func:`bwd_mode`). They
differ only in where the scale rounds (``csrc/flash_packed.cu``), so at head
dim 64 all three are one function up to the order of f32 sums.

The forward takes JAX's three softmax forms (``_fwd``, ``:303-306``), chosen
by explicit arguments where JAX reads ``INTENTBEV_FWD_KV_CHUNK`` and
``INTENTBEV_FWD_SOFTMAX`` at import (:func:`fwd_form`): ``unsafe_softmax``
runs the fixed max (P = exp(s), lse = log d; the serving configuration of
``bench.py``), ``kv_chunk`` dividing JAX's padded length the chunked safe
softmax (a running max updated once per ``kv_chunk`` keys), and otherwise
the monolithic safe one (the true row max). Each rounds P to bf16 against
its own max, so the three give other bf16 values; the kernel computes each
with JAX's rounding points (``csrc/flash_packed.cu``), counted apart
(:data:`FWD_COUNTERS`).

Dispatch as in JAX (``intentbev/ops/flash_packed.py:778``): a head layout
whose heads do not pair into 128 lanes (:func:`pairs_heads`, e.g. ViT-Ti's
3 heads of 64) goes to the BHTD kernels of :mod:`.flash_attention`, over
strided views of the same tensors, from :func:`flash_attention_packed`,
:func:`flash_attention_packed_plain` and :func:`flash_attention_fn`; JAX's
fallback ignores ``kv_chunk`` and ``unsafe_softmax``, and so do they there
(the BHTD kernel takes the true row max).
"""

from __future__ import annotations

import math
import warnings

import torch

from ._build import check_launch, kernels, require, stream_ptr
from .flash_attention import (HEAD_DIMS, flash_attention_packed_layout, flash_attention_qkv,
                              heads_view, tma_geometry)

LANE_BLOCK = 128  # the JAX packed kernels' lane block
# JAX pads T to a multiple of its forward and backward row blocks
# (BLOCK_Q_PK 384, BLOCK_BWD_PK 256; intentbev/ops/flash_packed.py:792); the
# chunked backward runs where the chunk divides that length (:659)
PAD_ROWS = math.lcm(384, 256)
# the JAX ViT first pads its tokens to the BHTD flash block (BLOCK_Q 512,
# intentbev/models/vit.py:578-583), so its packed entry sees that length
MODEL_PAD_ROWS = 512
BWD_MODES = ("fused", "split", "chunked")  # the C entry's mode numbers, in order
BWD_COUNTERS = {"fused": "flash_packed_bwd", "split": "flash_packed_bwd_split",
                "chunked": "flash_packed_bwd_chunked"}
FWD_FORMS = ("safe", "fixed", "chunked")  # the C entry's form numbers, in order
FWD_COUNTERS = {"safe": "flash_packed", "fixed": "flash_packed_fixed",
                "chunked": "flash_packed_chunked"}
KEY_TILE = 128  # keys of the forward kernel's tile: a chunk is a whole number of them


def pad_len(t: int, block: int) -> int:
    return -(-t // block) * block


def bwd_mode(t: int, bwd_fused: bool = True, bwd_kv_chunk: int = 0) -> str:
    """The backward JAX's ``_bwd`` runs over ``t`` rows (the length its packed
    entry is given): ``"fused"``, or with ``bwd_fused`` off ``"chunked"``
    where ``bwd_kv_chunk`` divides the padded length and ``"split"``
    otherwise. ``bwd_kv_chunk`` with ``bwd_fused`` on is ignored with a
    warning, as JAX warns (``intentbev/ops/flash_packed.py:85-93``)."""
    if bwd_fused:
        if bwd_kv_chunk:
            warnings.warn("bwd_kv_chunk is set but bwd_fused is on: the fused backward "
                          "runs; turn bwd_fused off to run the chunked kernels",
                          stacklevel=2)
        return "fused"
    if bwd_kv_chunk and pad_len(t, PAD_ROWS) % bwd_kv_chunk == 0:
        return "chunked"
    return "split"


def fwd_form(t: int, kv_chunk: int = 0, unsafe_softmax: bool = False) -> str:
    """The softmax form JAX's ``_fwd`` runs over ``t`` rows (the length its
    packed entry is given): ``"fixed"`` (m = 0) under ``unsafe_softmax``,
    whatever the chunk; else ``"chunked"`` (a running max per ``kv_chunk``
    keys) where ``kv_chunk`` divides the padded length; else ``"safe"`` (the
    true row max) (``intentbev/ops/flash_packed.py:303-306``)."""
    if unsafe_softmax:
        return "fixed"
    if kv_chunk and pad_len(t, PAD_ROWS) % kv_chunk == 0:
        return "chunked"
    return "safe"


def scales(head_dim: int, dtype: torch.dtype) -> tuple[float, float]:
    """(1/sqrt(D) rounded to ``dtype``, by which q or k is scaled before the
    score product; 1/sqrt(D) as a Python float, the epilogues' scale)."""
    scale = head_dim ** -0.5
    return float(torch.tensor(scale, dtype=dtype)), scale


def pairs_heads(head_dim: int, num_heads: int) -> bool:
    """Whether the heads pair into 128 lanes, the JAX packed kernels' layout
    (``intentbev/ops/flash_packed.py:778``); any other layout takes the BHTD
    kernels."""
    return LANE_BLOCK % head_dim == 0 and num_heads % (LANE_BLOCK // head_dim) == 0


def softmax_pv(s, vh, dt, form: str = "safe", kv_chunk: int = 0):
    """(o, lse) of scores ``s`` [..., T, K] (masked keys -inf) against ``vh``
    [..., K, D] in f32 with JAX's rounding points: P = exp(s - m) in f32, P
    rounded to ``dt`` before the product with v, o = (P v) / d, d the f32 sum
    of P, lse = m + log d. m is the row max (``"safe"``), 0 (``"fixed"``), or
    the running max of ``_fwd_kernel_chunked`` (``"chunked"``): per
    ``kv_chunk`` keys m_new = max(m, max s), corr = exp(m - m_new), d = d *
    corr + sum P, acc = acc * corr + P v (chunks wholly past the last real
    key add nothing: P = 0, corr = 1)."""
    if form == "chunked":
        m = torch.full(s.shape[:-1] + (1,), float("-inf"), device=s.device)
        den = torch.zeros_like(m)
        acc = torch.zeros(s.shape[:-1] + (vh.shape[-1],), device=s.device)
        for c0 in range(0, s.shape[-1], kv_chunk):
            sc = s[..., c0:c0 + kv_chunk]
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            den = den * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.matmul(p.to(dt).float(), vh[..., c0:c0 + kv_chunk, :])
            m = m_new
        return acc / den, (m + torch.log(den))[..., 0]
    m = s.amax(-1, keepdim=True) if form == "safe" else torch.zeros_like(s[..., :1])
    p = torch.exp(s - m)
    den = p.sum(-1, keepdim=True)
    return torch.matmul(p.to(dt).float(), vh) / den, (m + torch.log(den))[..., 0]


def flash_attention_packed_plain(q, k, v, num_heads: int, seq_len: int | None = None,
                                 kv_chunk: int = 0, unsafe_softmax: bool = False,
                                 padded_len: int | None = None):
    """Plain PyTorch version with the JAX kernels' rounding points: q scaled
    in its own dtype by the scale rounded to that dtype, f32 scores, then
    :func:`softmax_pv` in the form :func:`fwd_form` picks for ``padded_len``
    rows (default T). Returns ``(o [B, T, H*D] in q's dtype, lse f32 [B, H,
    T])``. Heads that do not pair take the BHTD plain version (the true row
    max, whatever the form)."""
    b, t, dm = q.shape
    dh = dm // num_heads
    if not pairs_heads(dh, num_heads):
        return flash_attention_packed_layout(q, k, v, num_heads, seq_len, plain=True)
    seq_len = t if seq_len is None else int(seq_len)
    form = fwd_form(t if padded_len is None else padded_len, kv_chunk, unsafe_softmax)
    dt = q.dtype
    scale = scales(dh, dt)[0]

    def heads(x):  # one sample [T, H*D] -> [H, T, D]
        return x.reshape(t, num_heads, dh).transpose(0, 1)

    o = torch.empty(b, t, dm, dtype=dt, device=q.device)
    lse = torch.empty(b, num_heads, t, dtype=torch.float32, device=q.device)
    for i in range(b):  # one sample at a time bounds the [H, T, T] scores
        qh = (heads(q[i]).float() * scale).to(dt).float()
        s = torch.matmul(qh, heads(k[i]).float().transpose(-1, -2))
        if seq_len < t:
            s[..., seq_len:] = float("-inf")
        oh, lse[i] = softmax_pv(s, heads(v[i]).float(), dt, form, kv_chunk)
        o[i] = oh.transpose(0, 1).reshape(t, dm).to(dt)
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


def _check_qkv(name, q, k, v, num_heads, seq_len):
    """-> (b, t, dm, head dim, seq_len) of packed bf16 CUDA q, k, v that
    share 16-byte-aligned rows."""
    b, t, dm = q.shape
    dh = dm // num_heads
    seq_len = t if seq_len is None else int(seq_len)
    require(0 < seq_len <= t, f"{name}: seq_len {seq_len} outside (0, {t}]")
    require(dh * num_heads == dm and dh in HEAD_DIMS,
            f"{name}: the packed kernels are built for head dims {HEAD_DIMS}, got head dim "
            f"{dm / num_heads:g} ({dm} over {num_heads} heads)")
    for x_name, x in (("q", q), ("k", k), ("v", v)):
        require(x.is_cuda and x.device == q.device and x.dtype == torch.bfloat16
                and tuple(x.shape) == (b, t, dm),
                f"{name}: {x_name} must be CUDA bf16 {(b, t, dm)}, got "
                f"{x.dtype} {tuple(x.shape)} {x.device}")
        require(x.stride() == q.stride() and x.stride(-1) == 1
                and x.stride(1) % 8 == 0 and x.stride(0) % 8 == 0
                and x.data_ptr() % 16 == 0,
                f"{name}: {x_name} strides {x.stride()} not shared 16-byte-aligned rows")
    return b, t, dm, dh, seq_len


def flash_attention_packed(q, k, v, num_heads: int, seq_len: int | None = None,
                           kv_chunk: int = 0, unsafe_softmax: bool = False,
                           padded_len: int | None = None):
    """softmax(q k^T / sqrt(D) + key mask) v per head over [B, T, H*D] bf16
    CUDA tensors (D in :data:`HEAD_DIMS`), in the softmax form
    :func:`fwd_form` picks for ``padded_len`` rows (default T; counted
    apart: :data:`FWD_COUNTERS`); returns ``(o, lse)``. The chunked form
    takes a ``kv_chunk`` that is a multiple of :data:`KEY_TILE`. Heads that
    do not pair take the BHTD kernel (:mod:`.flash_attention`). CPU tensors
    take :func:`flash_attention_packed_plain`."""
    if not pairs_heads(q.shape[-1] // num_heads, num_heads):
        return flash_attention_packed_layout(q, k, v, num_heads, seq_len)
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, num_heads, seq_len, kv_chunk,
                                            unsafe_softmax, padded_len)
    b, t, dm, dh, seq_len = _check_qkv("flash", q, k, v, num_heads, seq_len)
    form = fwd_form(t if padded_len is None else padded_len, kv_chunk, unsafe_softmax)
    require(form != "chunked" or kv_chunk % KEY_TILE == 0,
            f"flash: the chunked forward takes kv_chunk in multiples of {KEY_TILE} keys, "
            f"got kv_chunk {kv_chunk}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        tma_geometry(heads_view(x, num_heads), name=name)
    o = torch.empty(b, t, dm, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, num_heads, t, dtype=torch.float32, device=q.device)
    err = kernels().ibk_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, t, seq_len, num_heads, dh, q.stride(1), q.stride(0), scales(dh, q.dtype)[0],
        FWD_FORMS.index(form), kv_chunk if form == "chunked" else 0, stream_ptr(q))
    check_launch(err, FWD_COUNTERS[form])
    return o, lse


def flash_attention_packed_bwd_plain(q, k, v, o, lse, do, num_heads: int,
                                     seq_len: int | None = None, bwd_fused: bool = True,
                                     bwd_kv_chunk: int = 0, padded_len: int | None = None):
    """Plain backward with the rounding points of the JAX kernels that
    :func:`bwd_mode` picks for ``padded_len`` rows (default T): p =
    exp(s - lse) in f32, delta = rowsum(dO * O) per head, t = p * (dO v^T -
    delta); p and t rounded to q's dtype before the products dv = p^T dO and
    dq = bf16(f32(t k) * scale), with s = qh k^T, qh = q * sb in q's dtype
    (sb the scale rounded to it). dk is t^T qh (fused), bf16(f32(t^T q) *
    scale) (split), or that with the scores s^T = kh q^T, kh = k * sb in k's
    dtype (chunked; its dq takes split's scores). Keys at or past
    ``seq_len`` get dk = dv = 0. Returns dqkv [B, T, 3*H*D] in q's dtype."""
    b, t, dm = q.shape
    dh = dm // num_heads
    seq_len = t if seq_len is None else int(seq_len)
    mode = bwd_mode(t if padded_len is None else padded_len, bwd_fused, bwd_kv_chunk)
    dt = q.dtype
    sb, sf = scales(dh, dt)

    def heads(x):  # one sample [T, H*D] -> [H, T, D] f32
        return x.reshape(t, num_heads, dh).transpose(0, 1).float()

    def grad_s(s, doh, vh, delta, lse_i):
        """(p, t rounded to dt) of scores s [H, T, T] (query rows)."""
        if seq_len < t:
            s[..., seq_len:] = float("-inf")
        p = torch.exp(s - lse_i[..., None])
        return p, (p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta)).to(dt).float()

    dqkv = torch.empty(b, t, 3 * dm, dtype=dt, device=q.device)
    for i in range(b):  # one sample at a time bounds the [H, T, T] scores
        qf, kh, vh, oh, doh = heads(q[i]), heads(k[i]), heads(v[i]), heads(o[i]), heads(do[i])
        qh = (qf * sb).to(dt).float()
        lse_i = lse[i].float()
        delta = (doh * oh).sum(-1, keepdim=True)
        p, tt = grad_s(torch.matmul(qh, kh.transpose(-1, -2)), doh, vh, delta, lse_i)
        dq = torch.matmul(tt, kh) * sf
        if mode == "chunked":  # dk/dv from the scores kh q^T
            ks = (kh * sb).to(dt).float()
            p, tt = grad_s(torch.matmul(qf, ks.transpose(-1, -2)), doh, vh, delta, lse_i)
        dv = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
        if mode == "fused":
            dk = torch.matmul(tt.transpose(-1, -2), qh)
        else:
            dk = torch.matmul(tt.transpose(-1, -2), qf) * sf
        dk[:, seq_len:] = 0
        dv[:, seq_len:] = 0
        for j, g in enumerate((dq, dk, dv)):
            dqkv[i, :, j * dm:(j + 1) * dm] = g.transpose(0, 1).reshape(t, dm).to(dt)
    return dqkv


def flash_attention_packed_bwd(q, k, v, o, lse, do, num_heads: int,
                               seq_len: int | None = None, bwd_fused: bool = True,
                               bwd_kv_chunk: int = 0, padded_len: int | None = None):
    """Backward kernels over bf16 CUDA tensors: q, k, v as in the forward
    (column slices allowed), o and do [B, T, H*D], lse f32 [B, H, T]; the
    rounding mode that :func:`bwd_mode` picks (counted apart:
    :data:`BWD_COUNTERS`). delta = rowsum(dO * O) per head is plain PyTorch
    here, as it is XLA in the JAX package. Returns dqkv [B, T, 3*H*D] bf16.
    CPU tensors take :func:`flash_attention_packed_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_attention_packed_bwd_plain(q, k, v, o, lse, do, num_heads, seq_len,
                                                bwd_fused, bwd_kv_chunk, padded_len)
    b, t, dm, dh, seq_len = _check_qkv("flash bwd", q, k, v, num_heads, seq_len)
    mode = bwd_mode(t if padded_len is None else padded_len, bwd_fused, bwd_kv_chunk)
    do = do.contiguous()
    for name, x in (("o", o), ("do", do)):
        require(x.device == q.device and x.dtype == torch.bfloat16
                and tuple(x.shape) == (b, t, dm), f"flash bwd: {name} must be bf16 {(b, t, dm)}")
    require(lse.dtype == torch.float32 and tuple(lse.shape) == (b, num_heads, t)
            and lse.is_contiguous(), "flash bwd: lse must be contiguous f32 [B, H, T]")
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        tma_geometry(heads_view(x, num_heads), name=name)
    delta = (do.float() * o).reshape(b, t, num_heads, dh) \
        .sum(-1).transpose(1, 2).contiguous()
    dqkv = torch.empty(b, t, 3 * dm, dtype=q.dtype, device=q.device)
    err = kernels().ibk_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dqkv.data_ptr(), b, t, seq_len, num_heads, dh, q.stride(1),
        q.stride(0), *scales(dh, q.dtype), BWD_MODES.index(mode), stream_ptr(q))
    check_launch(err, BWD_COUNTERS[mode])
    return dqkv


class _FlashFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, seq_len, plain, fwd, bwd):
        d = qkv.shape[-1] // 3
        entry = flash_attention_packed_plain if plain else flash_attention_packed
        o, lse = entry(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], num_heads, seq_len,
                       *fwd)
        ctx.num_heads, ctx.seq_len, ctx.plain, ctx.bwd = num_heads, seq_len, plain, bwd
        ctx.save_for_backward(qkv, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        d = qkv.shape[-1] // 3
        bwd = flash_attention_packed_bwd_plain if ctx.plain else flash_attention_packed_bwd
        dqkv = bwd(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], o, lse, do,
                   ctx.num_heads, ctx.seq_len, *ctx.bwd)
        return dqkv, None, None, None, None, None


def flash_attention_fn(qkv, num_heads: int, seq_len: int | None = None,
                       plain: bool = False, bwd_fused: bool = True, bwd_kv_chunk: int = 0,
                       padded_len: int | None = None, kv_chunk: int = 0,
                       unsafe_softmax: bool = False):
    """Differentiable attention over the qkv projection output [B, T, 3*H*D]
    (q | k | v): the forward kernel, in the softmax form :func:`fwd_form`
    picks from ``kv_chunk`` and ``unsafe_softmax``, saves O and lse; the
    backward kernels return the gradient of qkv, in the form
    :func:`bwd_mode` picks from ``bwd_fused`` and ``bwd_kv_chunk``; both
    over ``padded_len`` rows (the row count JAX's packed entry would see;
    default T). The backward reads only lse, which every forward form
    returns alike (JAX's ``_fp_bwd``). Heads that do not pair take the BHTD
    kernels (:func:`.flash_attention.flash_attention_qkv`), which have one
    forward form and one backward, as JAX's fallback does. ``plain`` runs
    the plain versions."""
    if not pairs_heads(qkv.shape[-1] // 3 // num_heads, num_heads):
        return flash_attention_qkv(qkv, num_heads, seq_len, plain)
    return _FlashFn.apply(qkv, num_heads, seq_len, plain,
                          (kv_chunk, unsafe_softmax, padded_len),
                          (bwd_fused, bwd_kv_chunk, padded_len))
