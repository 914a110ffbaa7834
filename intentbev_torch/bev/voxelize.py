"""Multi-sweep LiDAR BEV voxelization on the device (points transport).

Counterpart of ``intentbev/bev/voxelize.py`` (``quantize_points_cm`` on
the host, ``dequantize_points`` and ``voxelize_packed`` on the device): per
sweep, points are floored into the H x W grid,
z in [z_min, z_max) is binned into Z height slices, and each (sweep, slice)
channel takes the per-cell max intensity into a zero-initialised target,
so a cell holds max(0, intensity). Output is channels-last [B, H, W, S*Z]
with channel = sweep * Z + z_slice. The scatter-max is plain PyTorch
(``scatter_reduce_`` with ``amax``), as it is an XLA scatter in JAX; points
outside the grid or the z range, and invalid ones, are dropped by index.
"""

from __future__ import annotations

import numpy as np
import torch

_DEQUANT = (0.01, 0.01, 0.01, 1.0)  # i16 transport: xyz in cm, raw intensity
_QUANT = np.array([100.0, 100.0, 100.0, 1.0], np.float32)


def quantize_points_cm(points: np.ndarray) -> np.ndarray:
    """Host: f32[..., 4] (x, y, z, intensity) -> the i16 transport (xyz in
    cm, rounded and clipped to +-32767; intensity rounded, exact for the
    integral 0-255 LiDAR intensities)."""
    return np.clip(np.round(points * _QUANT), -32767, 32767).astype(np.int16)


def dequantize_points_np(points: np.ndarray) -> np.ndarray:
    """Host twin of :func:`dequantize_points` for the i16 transport: the same
    f32 products, so both transports see identical coordinates."""
    return points.astype(np.float32) * np.asarray(_DEQUANT, np.float32)


def dequantize_points(points: torch.Tensor) -> torch.Tensor:
    """i16 [..., 4] transport points (cm, raw intensity) -> f32 metres; f32
    passes through."""
    if points.dtype == torch.int16:
        return points.float() * torch.tensor(_DEQUANT, dtype=torch.float32,
                                             device=points.device)
    return points


def voxelize_packed(points: torch.Tensor, valid: torch.Tensor, grid,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """points f32[B, S, P, 4] (x, y, z, intensity), valid bool[B, S, P] ->
    BEV [B, H, W, S*Z] in ``out_dtype``. The divisions are true f32
    divisions by tensors, as XLA computes them, so cells match exactly."""
    if not points.is_floating_point():
        raise TypeError(f"voxelize_packed expects float points (metres), got "
                        f"{points.dtype}; decode i16 transport points first")
    b, s = points.shape[:2]
    h, w, zc = grid.height_px, grid.width_px, grid.lidar_height_channels
    c = s * zc
    dev = points.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    x, y, z, inten = points.unbind(-1)
    col = torch.floor(grid.pixel_offset_x + y / f32(grid.voxel_size_m)).long()
    row = torch.floor(grid.pixel_offset_y - x / f32(grid.voxel_size_m)).long()
    ok = (valid.bool() & (col >= 0) & (col < w) & (row >= 0) & (row < h)
          & (z >= grid.z_min) & (z < grid.z_max))
    zi = torch.floor((z - grid.z_min) / f32(grid.z_max - grid.z_min) * zc).long()
    zi = zi.clamp(0, zc - 1)
    sweep = torch.arange(s, device=dev)[:, None]
    sample = torch.arange(b, device=dev)[:, None, None]
    flat = sample * (h * w * c) + (row * w + col) * c + sweep * zc + zi
    total = b * h * w * c
    flat = torch.where(ok, flat, total)  # one spare cell takes the dropped points
    bev = torch.zeros(total + 1, dtype=out_dtype, device=dev)
    bev.scatter_reduce_(0, flat.reshape(-1), inten.reshape(-1).to(out_dtype), "amax")
    return bev[:total].view(b, h, w, c)
