"""Per-log city-frame map raster and its per-sample warp to the ego frame.

Counterpart of ``intentbev/bev/city_raster.py``: each log's map is drawn
once in the city frame (axis-aligned, at the grid's 0.2 m voxel, over the
map's bounds plus a margin) with the port's polygon fill and polyline
(``bev.rasterize``, native or numpy: the same bits), and each sample's
ego-centric 9-channel map is one bilinear resample of it:

- :func:`warp_city_to_ego` on the host (numpy, f64 coordinates), with the
  sample's ``aug_linear``; the loader's ``use_city_raster_cache`` path;
- :func:`warp_city_to_ego_device` on tensors of the caller's device, for a
  batch of B poses (the JAX function is vmapped over them; here the poses
  carry a leading batch dimension), in f32 as the JAX device twin computes.
  Each form keeps its own divisor: the host divides by the raster's
  ``voxel_size``, the device by the grid's ``voxel_size_m``.

Warping a pre-drawn raster is not drawing the rotated polygons: the fills
agree with the direct raster at ~0.87-0.95 channel IoU, and the 1-px
polylines, which peak at 0.25-0.5 after a half-pixel resample, are
binarized at half the fill threshold (:func:`_channel_thresholds`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..configs import GridConfig
from ..geometry import quat_to_yaw
from .augment import bilinear_sample
from .rasterize import _MARK_CHANNELS, MapElements, draw_polyline, fill_polygon


@dataclass
class CityRaster:
    raster: np.ndarray              # f32[Hc, Wc, 9], city frame, axis-aligned
    origin_xy: tuple[float, float]  # world coordinates of pixel (row 0, col 0)
    voxel_size: float
    # city pixel convention: col = (x - origin_x) / voxel, row = (y - origin_y) / voxel


_POLYLINE_CHANNELS = (1, 2, 6, 7, 8)


def _channel_thresholds(fill_threshold: float) -> np.ndarray:
    """f32[9] binarization thresholds: fills at ``fill_threshold``, the 1-px
    polyline channels at half of it (a 0.5 threshold erases a line that a
    half-pixel resample spreads to 0.25-0.5)."""
    t = np.full(9, fill_threshold, dtype=np.float32)
    t[list(_POLYLINE_CHANNELS)] = fill_threshold / 2.0
    return t


def build_city_raster(elements: MapElements, grid: GridConfig, margin_m: float = 20.0,
                      native: bool = True) -> CityRaster:
    """Rasterize a log's map once in the city frame. ``native``: the C++
    host library's primitives (the default) or their numpy forms."""
    pts = []
    for lane in elements.lanes:
        if len(lane.left_boundary):
            pts.append(lane.left_boundary)
        if len(lane.right_boundary):
            pts.append(lane.right_boundary)
    pts.extend(p for p in elements.crosswalks if len(p))
    if not pts:
        raster = np.zeros((8, 128, grid.map_channels), dtype=np.float32)
        return CityRaster(raster, (0.0, 0.0), grid.voxel_size_m)
    allp = np.concatenate(pts, axis=0)
    x0, y0 = allp.min(axis=0) - margin_m
    x1, y1 = allp.max(axis=0) + margin_m
    v = grid.voxel_size_m
    wc = int(np.ceil((x1 - x0) / v))
    hc = int(np.ceil((y1 - y0) / v))

    def to_px(world_xy: np.ndarray) -> np.ndarray:
        col = (world_xy[:, 0] - x0) / v
        row = (world_xy[:, 1] - y0) / v
        return np.round(np.stack([col, row], axis=1)).astype(np.int32)

    out = np.zeros((grid.map_channels, hc, wc), dtype=np.uint8)
    for lane in elements.lanes:
        lp = to_px(lane.left_boundary) if len(lane.left_boundary) else np.empty((0, 2), np.int32)
        rp = (to_px(lane.right_boundary) if len(lane.right_boundary)
              else np.empty((0, 2), np.int32))
        if len(lp) > 1 and len(rp) > 1:
            poly = np.vstack([lp, rp[::-1]])
            if poly.shape[0] >= 3:
                fill_polygon(out[0], poly, native)
                if lane.is_intersection:
                    fill_polygon(out[4], poly, native)
                if lane.lane_type == "BUS":
                    fill_polygon(out[5], poly, native)
        if len(lp) > 1:
            draw_polyline(out[1], lp, native)
        if len(rp) > 1:
            draw_polyline(out[2], rp, native)
        if lane.left_mark_type in _MARK_CHANNELS and len(lp) > 1:
            draw_polyline(out[_MARK_CHANNELS[lane.left_mark_type]], lp, native)
        if lane.right_mark_type in _MARK_CHANNELS and len(rp) > 1:
            draw_polyline(out[_MARK_CHANNELS[lane.right_mark_type]], rp, native)
    for cw in elements.crosswalks:
        px = to_px(cw)
        if len(px) >= 3:
            fill_polygon(out[3], px, native)

    return CityRaster(np.transpose(out, (1, 2, 0)).astype(np.float32), (float(x0), float(y0)),
                      v)


def warp_city_to_ego(city: CityRaster, ego_pose, grid: GridConfig,
                     binary_threshold: float = 0.5,
                     aug_linear: np.ndarray | None = None) -> np.ndarray:
    """Ego-centric f32[H, W, 9] map by one bilinear resample (host).

    ``aug_linear``: optional 2x2 ego-metric content transform
    (``bev.augment.aug_linear_matrix``); its inverse moves the sample
    coordinates, as ``rasterize_map_ego_centric`` composes it."""
    tx = float(ego_pose["tx_m"])
    ty = float(ego_pose["ty_m"])
    yaw = float(quat_to_yaw(ego_pose["qx"], ego_pose["qy"], ego_pose["qz"], ego_pose["qw"]))
    h, w = grid.height_px, grid.width_px
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    # output pixel -> ego metric, at integer pixel centres
    x_ego = (grid.pixel_offset_y - rows) * grid.voxel_size_m
    y_ego = (cols - grid.pixel_offset_x) * grid.voxel_size_m
    if aug_linear is not None:
        inv = np.linalg.inv(np.asarray(aug_linear, dtype=np.float64))
        x_ego, y_ego = (inv[0, 0] * x_ego + inv[0, 1] * y_ego,
                        inv[1, 0] * x_ego + inv[1, 1] * y_ego)
    # ego -> world -> city pixel
    c, s = np.cos(yaw), np.sin(yaw)
    x_w = c * x_ego - s * y_ego + tx
    y_w = s * x_ego + c * y_ego + ty
    src_col = (x_w - city.origin_xy[0]) / city.voxel_size
    src_row = (y_w - city.origin_xy[1]) / city.voxel_size

    hc, wc, _ = city.raster.shape
    r0 = np.floor(src_row).astype(np.int64)
    c0 = np.floor(src_col).astype(np.int64)
    dr = (src_row - r0)[..., None]
    dc = (src_col - c0)[..., None]

    def gather(ri, ci):
        ok = (ri >= 0) & (ri < hc) & (ci >= 0) & (ci < wc)
        vals = city.raster[np.clip(ri, 0, hc - 1), np.clip(ci, 0, wc - 1)]
        vals[~ok] = 0.0
        return vals

    out = (gather(r0, c0) * (1 - dr) * (1 - dc)
           + gather(r0, c0 + 1) * (1 - dr) * dc
           + gather(r0 + 1, c0) * dr * (1 - dc)
           + gather(r0 + 1, c0 + 1) * dr * dc)
    return (out >= _channel_thresholds(binary_threshold)).astype(np.float32)


def warp_city_to_ego_device(city_raster: torch.Tensor, origin_xy, ego_xy_yaw: torch.Tensor,
                            grid: GridConfig, binary_threshold: float = 0.5) -> torch.Tensor:
    """Device twin of :func:`warp_city_to_ego` for B poses at once.

    ``city_raster`` f32[Hc, Wc, 9] on the device; ``origin_xy`` its two
    world coordinates (floats or a tensor); ``ego_xy_yaw`` f32[B, 3] (tx,
    ty, yaw) on the same device, or f32[3] for one pose -> f32[B, H, W, 9]
    (or [H, W, 9]) of 0/1, in the f32 operations of the JAX function. The
    divisions are IEEE divisions by a device tensor (a CUDA division by a
    Python scalar multiplies by the reciprocal)."""
    dev = city_raster.device
    poses = ego_xy_yaw.to(device=dev, dtype=torch.float32)
    single = poses.dim() == 1
    poses = poses.reshape(-1, 3)
    h, w = grid.height_px, grid.width_px
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    x_ego = (grid.pixel_offset_y - rows) * grid.voxel_size_m
    y_ego = (cols - grid.pixel_offset_x) * grid.voxel_size_m
    tx, ty, yaw = (poses[:, i, None, None] for i in range(3))
    c, s = torch.cos(yaw), torch.sin(yaw)
    x_w = c * x_ego - s * y_ego + tx
    y_w = s * x_ego + c * y_ego + ty
    origin = torch.as_tensor(origin_xy, dtype=torch.float32, device=dev)
    voxel = torch.tensor(grid.voxel_size_m, dtype=torch.float32, device=dev)
    src_col = (x_w - origin[0]) / voxel
    src_row = (y_w - origin[1]) / voxel
    out = bilinear_sample(city_raster, src_row, src_col)
    thresh = torch.from_numpy(_channel_thresholds(binary_threshold)).to(dev)
    out = (out >= thresh).float()
    return out[0] if single else out
