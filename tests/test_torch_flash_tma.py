"""The tensor maps of the flash backward kernels, worked out by hand.

``tma_geometry`` (``intentbev_torch/ops/flash_attention.py``) gives the map
through which ``csrc/flash_packed.cu``'s backward kernels read a [B, H, T,
D] view with TMA: dimensions (D, H, T, B) innermost first, the byte strides
of H, T and B, boxes of 64 rows of one head, and a swizzle as wide as a box
row. The views are those the model hands the kernels, on the meta device
(no memory; an address is the view's byte offset), at the flagship's
[8, 4501] tokens. A view TMA cannot take raises before any launch.
"""

import pytest
import torch

from intentbev_torch.ops.flash_attention import TmaGeometry, heads_view, tma_geometry

B, T = 8, 4501


def _qkv(width):
    return torch.empty(B, T, 3 * width, dtype=torch.bfloat16, device="meta")


@pytest.mark.parametrize("heads,hd", [(6, 64), (12, 32)])
def test_packed_slices(heads, hd):
    """q, k and v as column slices of the [8, 4501, 3*384] qkv output: head
    stride D elements, row stride 3*384, batch stride 4501*3*384."""
    qkv = _qkv(384)
    row = 3 * 384 * 2  # 2304 bytes
    for i in range(3):
        x = heads_view(qkv[..., i * 384:(i + 1) * 384], heads)
        assert tma_geometry(x) == TmaGeometry(
            dims=(hd, heads, T, B), strides=(hd * 2, row, T * row), box=(hd, 1, 64, 1),
            swizzle=hd * 2)
    # dO, contiguous [8, 4501, 384]
    do = torch.empty(B, T, 384, dtype=torch.bfloat16, device="meta")
    assert tma_geometry(heads_view(do, heads)) == (
        (hd, heads, T, B), (hd * 2, 768, T * 768), (hd, 1, 64, 1), hd * 2)


def test_vit_ti_views():
    """ViT-Ti's 3 heads of 64 over its [8, 4501, 3*192] qkv output."""
    qkv = _qkv(192)
    g = tma_geometry(heads_view(qkv[..., 192:384], 3))
    assert g == ((64, 3, T, B), (128, 1152, T * 1152), (64, 1, 64, 1), 128)


def test_contiguous_bhtd():
    x = torch.empty(2, 3, 1000, 32, dtype=torch.bfloat16, device="meta")
    assert tma_geometry(x) == ((32, 3, 1000, 2), (64000, 64, 192000), (32, 1, 64, 1), 64)


def test_what_tma_cannot_take_raises():
    qkv = _qkv(384)
    with pytest.raises(ValueError, match="base address"):  # 2 bytes off
        tma_geometry(heads_view(qkv[..., 1:385], 6))
    odd = torch.empty(B, T, 3 * 384 + 4, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="byte strides"):  # rows of 2312 bytes
        tma_geometry(heads_view(odd[..., :384], 6))
    with pytest.raises(ValueError, match="swizzle"):  # rows of 256 bytes
        tma_geometry(heads_view(qkv[..., :384], 3))
    with pytest.raises(ValueError, match="stride along D"):
        tma_geometry(heads_view(qkv[..., :768:2], 6))  # every other column
