"""Multi-sweep LiDAR BEV voxelization on the device (points transport).

Counterpart of ``intentbev/bev/voxelize.py`` (``quantize_points_cm`` and
``dedup_cells_host`` on the host, ``dequantize_points``, ``voxelize_packed``
and ``voxelize_cells`` on the device): per
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


def dedup_cells_host(points: np.ndarray, valid: np.ndarray, grid) -> tuple[np.ndarray, np.ndarray]:
    """Host per-cell max of one sample (the cell transport of ``bench.py
    --cells``): points f32[S, P, 4], valid bool[S, P] -> (cell ids i32[S*P],
    values f32[S*P]), the sorted unique flat cell indices of the in-range
    points with their max intensity, padded at the tail with ids ascending
    past H*W*C (dropped by :func:`voxelize_cells`). A copy of the JAX
    package's numpy function, operation for operation."""
    h, w = grid.height_px, grid.width_px
    z_ch = grid.lidar_height_channels
    s = points.shape[0]
    c = s * z_ch
    n_total = points.shape[0] * points.shape[1]

    x, y, z, inten = (points[..., i] for i in range(4))
    col = np.floor(grid.pixel_offset_x + y / grid.voxel_size_m).astype(np.int64)
    row = np.floor(grid.pixel_offset_y - x / grid.voxel_size_m).astype(np.int64)
    ok = (np.asarray(valid, bool)
          & (col >= 0) & (col < w) & (row >= 0) & (row < h)
          & (z >= grid.z_min) & (z < grid.z_max))
    zi = np.clip(np.floor((z - grid.z_min) / (grid.z_max - grid.z_min) * z_ch),
                 0, z_ch - 1).astype(np.int64)
    sweep_idx = np.arange(s, dtype=np.int64)[:, None]
    flat = ((row * w + col) * c + sweep_idx * z_ch + zi)[ok]
    vals = inten[ok].astype(np.float32)

    order = np.argsort(flat, kind="stable")
    flat, vals = flat[order], vals[order]
    boundaries = np.flatnonzero(np.diff(flat)) + 1
    starts = np.concatenate([[0], boundaries]) if len(flat) else np.zeros(0, np.int64)
    uniq_ids = flat[starts] if len(flat) else flat
    uniq_vals = np.maximum.reduceat(vals, starts) if len(flat) else vals

    out_ids = np.arange(n_total, dtype=np.int64) + (h * w * c)
    out_vals = np.zeros(n_total, dtype=np.float32)
    u = len(uniq_ids)
    out_ids[:u] = uniq_ids
    out_ids[u:] = h * w * c + np.arange(n_total - u, dtype=np.int64)
    out_vals[:u] = uniq_vals
    return out_ids.astype(np.int32), out_vals


def voxelize_cells(cell_ids: torch.Tensor, values: torch.Tensor, grid,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Device scatter of host-pre-reduced cells: ids i32[B, N] and values
    f32[B, N] of :func:`dedup_cells_host` -> BEV [B, H, W, S*Z] in
    ``out_dtype``, each listed cell max(0, value) (a zero-initialised max
    target, as JAX's), ids at or past H*W*C dropped. Plain PyTorch, as the
    JAX scatter is XLA."""
    b = cell_ids.shape[0]
    h, w = grid.height_px, grid.width_px
    c = grid.lidar_sweeps * grid.lidar_height_channels
    cells = h * w * c
    ids = cell_ids.long()
    flat = torch.where(ids < cells, ids, cells)  # one spare cell per sample
    flat = flat + torch.arange(b, device=ids.device)[:, None] * (cells + 1)
    bev = torch.zeros(b * (cells + 1), dtype=out_dtype, device=ids.device)
    bev.scatter_reduce_(0, flat.reshape(-1), values.reshape(-1).to(out_dtype), "amax")
    return bev.view(b, cells + 1)[:, :cells].reshape(b, h, w, c)
