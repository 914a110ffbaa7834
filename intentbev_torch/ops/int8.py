"""Int8 serving primitives: symmetric weight and activation quantization
and the plain W8A8 dense layer.

Counterpart of ``intentbev/ops/int8.py`` (the port's own copy; the CPU
tests hold it bit-identical to the JAX originals). The scheme is W8A8
dynamic: weights symmetric per output channel, activations symmetric per
row (token), int32 products, f32 rescale and bias. Codes are
``clip(round(x / scale), -127, 127)`` with ``scale = max(absmax, eps) /
127`` and round half to even, so they are the JAX codes bit for bit.

``int8_dense`` is plain XLA in the JAX package and stays plain PyTorch
here. Its integer product runs as a float64 matmul of the codes, which is
exact: |sum| <= K * 127**2 stays far below 2**53.

The scale divides by 127 as a tensor on the data's device: PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal, which is one
ulp off in some rows and moves codes (measured on an H100: 1668 of 36008
row scales, 1213 codes).
"""

from __future__ import annotations

import torch


def _codes(x: torch.Tensor, absmax: torch.Tensor, eps: float):
    a = absmax.float().clamp(min=eps)
    scale = a / torch.full((), 127.0, device=a.device)  # an IEEE division (module doc)
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8), scale


def quantize_rows(x: torch.Tensor, eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: ``(q, scale)`` with x ~= q * scale; the scale
    is f32 of shape x.shape[:-1] + (1,)."""
    return _codes(x, x.abs().amax(-1, keepdim=True), eps)


def quantize_cols(w: torch.Tensor, eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 for a [d_in, d_out] weight (the JAX
    layout): ``(q [d_in, d_out], scale f32 [1, d_out])``."""
    return _codes(w, w.abs().amax(0, keepdim=True), eps)


def int_matmul(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 product ``a_q @ b_q`` as f32 (the int32 sum,
    converted once with round to nearest even, as the kernels convert it)."""
    return torch.matmul(a_q.double(), b_q.double()).float()


def int8_dense(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y = x @ w (+ bias) through int8 codes: x [..., d_in] (any float
    dtype), w [d_in, d_out] float (the JAX layout). Output in ``out_dtype``
    (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    xq, xs = quantize_rows(x)
    wq, ws = quantize_cols(w)
    y = int_matmul(xq, wq) * xs * ws
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def quantize_linear(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel codes of a PyTorch ``Linear`` weight [out, in]:
    ``(q int8 [out, in] contiguous, scale f32 [out])``, the transpose of
    :func:`quantize_cols` on the JAX layout [in, out]."""
    q, scale = quantize_cols(weight.t())
    return q.t().contiguous(), scale[0].contiguous()
