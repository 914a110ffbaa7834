"""HD-map rasterization to the 9-channel BEV, and the map-stream transport.

Counterpart of ``intentbev/bev/rasterize.py``:

- the host half, a copy: the log map JSON parsed once into
  ``MapElements``; the ego-centric raster (even-odd scanline polygon fill
  and 1-px polylines, the C++ host library's or their numpy forms, which
  give the same bits) with the exact bbox cull;
- the transport: the host packs the 0/1 map channels 8 per byte
  (u8[..., ceil(C/8)], MSB first, like ``np.packbits``); the device
  unpacks them with elementwise shifts.

Channel semantics (reference utils.py:146-180):
  0 drivable lane-polygon fill          (left boundary + reversed right)
  1 left lane boundary polyline
  2 right lane boundary polyline
  3 pedestrian-crossing polygon fill
  4 intersection lane fill
  5 bus-lane fill
  6 DASHED_WHITE markings   7 SOLID_WHITE   8 SOLID_YELLOW

The city-frame raster cache (``bev/city_raster.py``) is not ported
(``ROADMAP.md`` §1).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs import GridConfig
from ..geometry import ego_centric_transform_matrix, quat_to_yaw

_MARK_CHANNELS = {"DASHED_WHITE": 6, "SOLID_WHITE": 7, "SOLID_YELLOW": 8}


@dataclass
class LaneSegment:
    left_boundary: np.ndarray   # f64[K, 2] world xy
    right_boundary: np.ndarray  # f64[K2, 2]
    is_intersection: bool = False
    lane_type: str = "VEHICLE"
    left_mark_type: str = ""
    right_mark_type: str = ""
    lane_id: int = -1
    successors: tuple = ()


@dataclass
class MapElements:
    lanes: list = field(default_factory=list)
    crosswalks: list = field(default_factory=list)  # each f64[K, 2] world xy


def _points_xy(raw) -> np.ndarray:
    if not raw:
        return np.empty((0, 2))
    pts = [(p["x"], p["y"]) for p in raw if isinstance(p, dict) and "x" in p and "y" in p]
    return np.asarray(pts, dtype=np.float64).reshape(-1, 2)


def parse_map_json(map_json_path: str) -> MapElements:
    """Parse an AV2 log_map_archive JSON once (reference re-parses per
    sample, utils.py:112-119)."""
    with open(map_json_path, "r") as f:
        data = json.load(f)
    elements = MapElements()
    lane_segments = data.get("lane_segments", {})
    for lane_id, lane in lane_segments.items():
        elements.lanes.append(
            LaneSegment(
                left_boundary=_points_xy(lane.get("left_lane_boundary", [])),
                right_boundary=_points_xy(lane.get("right_lane_boundary", [])),
                is_intersection=bool(lane.get("is_intersection", False)),
                lane_type=lane.get("lane_type", "VEHICLE"),
                left_mark_type=lane.get("left_lane_mark_type", "") or "",
                right_mark_type=lane.get("right_lane_mark_type", "") or "",
                lane_id=int(lane_id) if str(lane_id).lstrip("-").isdigit() else -1,
                successors=tuple(lane.get("successors", []) or ()),
            )
        )
    for _, cw in data.get("pedestrian_crossings", {}).items():
        poly = _points_xy(cw.get("polygon", []))
        if len(poly):
            elements.crosswalks.append(poly)
    return elements


# ---------------------------------------------------------------------------
# numpy raster primitives (replace cv2.fillPoly / cv2.polylines)
# ---------------------------------------------------------------------------

def fill_polygon(mask: np.ndarray, pts: np.ndarray, native: bool = True) -> None:
    """Even-odd scanline fill of integer-vertex polygon into bool/uint8 mask.

    ``pts`` is int[K, 2] as (col, row) like cv2.fillPoly point order.
    Matches cv2.fillPoly's convention (utils.py:155-180): interior pixels by
    even-odd scanline, PLUS the closed 1-px outline — cv2 always draws the
    boundary, which matters for thin polygons (a 12-px-wide crosswalk loses
    its bottom row, ~8% IoU, under a pure half-open scanline; see
    test_reference_pipeline_parity). ``native``: the C++ host library's
    fill (cpp/intentbev_host.cpp); else the numpy scanline below, its
    oracle.
    """
    if pts.shape[0] < 3:
        return
    draw_polyline(mask, np.vstack([pts, pts[:1]]), native)
    if native:
        from ..utils.native import fill_polygon_native

        fill_polygon_native(mask, pts)
        return
    h, w = mask.shape
    px = pts[:, 0].astype(np.float64)
    py = pts[:, 1].astype(np.float64)
    y_min = max(int(np.floor(py.min())), 0)
    y_max = min(int(np.ceil(py.max())), h - 1)
    if y_max < y_min:
        return
    x1 = px
    y1 = py
    x2 = np.roll(px, -1)
    y2 = np.roll(py, -1)
    for y in range(y_min, y_max + 1):
        # edges crossing the scanline at pixel-centre y
        yc = y + 0.0
        cond = ((y1 <= yc) & (y2 > yc)) | ((y2 <= yc) & (y1 > yc))
        if not cond.any():
            continue
        t = (yc - y1[cond]) / (y2[cond] - y1[cond])
        xs = np.sort(x1[cond] + t * (x2[cond] - x1[cond]))
        for i in range(0, len(xs) - 1, 2):
            a = max(int(np.ceil(xs[i] - 0.5)), 0)
            b = min(int(np.floor(xs[i + 1] + 0.5)), w - 1)
            if b >= a:
                mask[y, a : b + 1] = 1


def draw_polyline(mask: np.ndarray, pts: np.ndarray, native: bool = True) -> None:
    """1-px Bresenham polyline (cv2.polylines thickness=1 equivalent).

    ``pts`` is int[K, 2] as (col, row). ``native``: the C++ twin; else
    the numpy form below.
    """
    if native:
        from ..utils.native import draw_polyline_native

        draw_polyline_native(mask, pts)
        return
    h, w = mask.shape
    for i in range(len(pts) - 1):
        x0, y0 = int(pts[i, 0]), int(pts[i, 1])
        x1, y1 = int(pts[i + 1, 0]), int(pts[i + 1, 1])
        dx, dy = abs(x1 - x0), abs(y1 - y0)
        n = max(dx, dy)
        if n == 0:
            if 0 <= y0 < h and 0 <= x0 < w:
                mask[y0, x0] = 1
            continue
        # floor(v + 0.5) = round-half-up, matching the C++ twin exactly
        xs = np.floor(np.linspace(x0, x1, n + 1) + 0.5).astype(int)
        ys = np.floor(np.linspace(y0, y1, n + 1) + 0.5).astype(int)
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        mask[ys[ok], xs[ok]] = 1


# ---------------------------------------------------------------------------
# Ego-centric rasterization (parity path)
# ---------------------------------------------------------------------------

def _element_bboxes(arrays: list) -> np.ndarray:
    """[N, 4] (xmin, ymin, xmax, ymax) world-frame bbox per element."""
    out = np.empty((len(arrays), 4), dtype=np.float64)
    for i, a in enumerate(arrays):
        if len(a):
            out[i] = (a[:, 0].min(), a[:, 1].min(), a[:, 0].max(), a[:, 1].max())
        else:
            out[i] = (np.inf, np.inf, -np.inf, -np.inf)
    return out


def _visible_mask(bboxes: np.ndarray, tx: float, ty: float, radius: float) -> np.ndarray:
    """Which element bboxes intersect the disk of ``radius`` around the ego."""
    dx = np.maximum(0.0, np.maximum(bboxes[:, 0] - tx, tx - bboxes[:, 2]))
    dy = np.maximum(0.0, np.maximum(bboxes[:, 1] - ty, ty - bboxes[:, 3]))
    return dx * dx + dy * dy <= radius * radius


def _visibility_radius(grid: GridConfig, aug_linear: np.ndarray | None) -> float:
    """Conservative world-distance bound for any vertex that can land in
    the BEV. A vertex mapping to an in-bounds pixel has ego-metric norm
    <= the BEV corner radius; ``aug_linear`` scales ego coords, so divide
    by its smallest singular value. +1 m covers pixel rounding."""
    xs = (grid.pixel_offset_y - np.array([-0.5, grid.height_px - 0.5])) * grid.voxel_size_m
    ys = (np.array([-0.5, grid.width_px - 0.5]) - grid.pixel_offset_x) * grid.voxel_size_m
    r = float(np.hypot(np.abs(xs).max(), np.abs(ys).max()))
    if aug_linear is not None:
        smin = float(np.linalg.svd(np.asarray(aug_linear, np.float64), compute_uv=False)[-1])
        r /= max(smin, 1e-6)
    return r + 1.0


def _world_to_pixels(pts_world: np.ndarray, ego_tf: np.ndarray, grid: GridConfig) -> np.ndarray:
    """World xy -> rounded (col, row); in-bounds filtered (utils.py:131-144)."""
    if pts_world.shape[0] == 0:
        return np.empty((0, 2), dtype=int)
    ego = pts_world @ ego_tf[:2, :2].T + ego_tf[:2, 2]
    col = grid.pixel_offset_x + ego[:, 1] / grid.voxel_size_m
    row = grid.pixel_offset_y - ego[:, 0] / grid.voxel_size_m
    px = np.round(np.stack([col, row], axis=1)).astype(int)
    ok = (px[:, 0] >= 0) & (px[:, 0] < grid.width_px) & (px[:, 1] >= 0) & (px[:, 1] < grid.height_px)
    return px[ok]


def rasterize_map_ego_centric(
    elements: MapElements,
    ego_pose,
    grid: GridConfig,
    aug_linear: np.ndarray | None = None,
    out_dtype=np.float32,
    cull: bool = True,
    native: bool = True,
) -> np.ndarray:
    """9-channel ego-centric map raster, [H, W, 9] channels-last in
    ``out_dtype`` (f32 = reference parity, utils.py:182; uint8 is exact for
    these binary channels and is what the data pipeline ships to the device
    — 4x fewer host->device bytes for the [B, H, W, 9] batch, cast to the
    compute dtype inside the jitted step).

    ``ego_pose`` is anything exposing tx_m, ty_m, qx..qw (pandas Series or
    dict). Mirrors reference utils.py:108-182 including the in-bounds point
    filtering *before* polygon construction.

    ``aug_linear``: optional 2x2 ego-metric content transform (see
    bev.augment.aug_linear_matrix) composed into the world->ego transform —
    training augmentation DRAWS the map at the flipped/rotated/scaled pose
    instead of bilinearly warping the finished raster (exact geometry,
    zero device cost; replaces the reference's cv2.warpAffine of the
    raster, utils.py:417-480).

    ``cull``: skip lanes/crosswalks whose world bbox cannot reach the BEV
    (bbox vs visibility disk, per-log bboxes cached on ``elements``). An
    element with NO in-bounds vertex draws nothing (the in-bounds filter
    above runs before polygon construction, reference utils.py:131-144),
    so culling is EXACT — bitwise-identical output (tested) — while making
    the per-pose cost O(visible elements), which on a full AV2 city map is
    a small fraction of the log's lane set.

    ``native``: draw with the C++ host library's primitives (the default,
    as the JAX package does where the library is built); else with their
    numpy forms. Both give the same bits.
    """
    h, w = grid.height_px, grid.width_px
    out = np.zeros((grid.map_channels, h, w), dtype=np.uint8)

    tx = float(ego_pose["tx_m"])
    ty = float(ego_pose["ty_m"])
    yaw = float(
        quat_to_yaw(ego_pose["qx"], ego_pose["qy"], ego_pose["qz"], ego_pose["qw"])
    )
    ego_tf = ego_centric_transform_matrix(np.array([tx, ty]), yaw)
    if aug_linear is not None:
        aug_h = np.eye(3)
        aug_h[:2, :2] = aug_linear
        ego_tf = aug_h @ ego_tf

    lanes = elements.lanes
    crosswalks = elements.crosswalks
    if cull:
        lane_bb = getattr(elements, "_lane_bboxes", None)
        if lane_bb is None or len(lane_bb) != len(lanes):
            lane_bb = _element_bboxes(
                [np.concatenate([l.left_boundary.reshape(-1, 2),
                                 l.right_boundary.reshape(-1, 2)]) for l in lanes]
            )
            elements._lane_bboxes = lane_bb
        cw_bb = getattr(elements, "_crosswalk_bboxes", None)
        if cw_bb is None or len(cw_bb) != len(crosswalks):
            cw_bb = _element_bboxes(crosswalks)
            elements._crosswalk_bboxes = cw_bb
        radius = _visibility_radius(grid, aug_linear)
        if len(lanes):
            keep = _visible_mask(lane_bb, tx, ty, radius)
            lanes = [l for l, k in zip(lanes, keep) if k]
        if len(crosswalks):
            keep = _visible_mask(cw_bb, tx, ty, radius)
            crosswalks = [c for c, k in zip(crosswalks, keep) if k]

    for lane in lanes:
        left_px = _world_to_pixels(lane.left_boundary, ego_tf, grid)
        right_px = _world_to_pixels(lane.right_boundary, ego_tf, grid)

        if len(left_px) > 1 and len(right_px) > 1:
            poly = np.vstack([left_px, np.flipud(right_px)])
            if poly.shape[0] >= 3:
                fill_polygon(out[0], poly, native)
                if lane.is_intersection:
                    fill_polygon(out[4], poly, native)
                if lane.lane_type == "BUS":
                    fill_polygon(out[5], poly, native)
        if len(left_px) > 1:
            draw_polyline(out[1], left_px, native)
        if len(right_px) > 1:
            draw_polyline(out[2], right_px, native)
        if lane.left_mark_type in _MARK_CHANNELS and len(left_px) > 1:
            draw_polyline(out[_MARK_CHANNELS[lane.left_mark_type]], left_px, native)
        if lane.right_mark_type in _MARK_CHANNELS and len(right_px) > 1:
            draw_polyline(out[_MARK_CHANNELS[lane.right_mark_type]], right_px, native)

    for cw in crosswalks:
        px = _world_to_pixels(cw, ego_tf, grid)
        if len(px) >= 3:
            fill_polygon(out[3], px, native)

    return np.transpose(out, (1, 2, 0)).astype(out_dtype)



# ---------------------------------------------------------------------------
# Map transport bit-packing
# ---------------------------------------------------------------------------

def pack_map_channels(map_bev: np.ndarray) -> np.ndarray:
    """Binary u8/bool[..., C] -> u8[..., ceil(C/8)] (MSB first)."""
    return np.packbits(map_bev.astype(bool), axis=-1)


def unpack_map_channels(packed: torch.Tensor, num_channels: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`pack_map_channels` on a u8 tensor ->
    ``dtype``[..., num_channels]."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    bits = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)
    return bits[..., :num_channels].to(dtype)


def decode_map_transport(map_bev: torch.Tensor, num_channels: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """Any map transport encoding -> ``dtype``[..., C]: bit-packed u8
    (channel dim == ceil(C/8)), plain u8 0/1, or float."""
    if (map_bev.dtype == torch.uint8 and num_channels > 1
            and map_bev.shape[-1] == (num_channels + 7) // 8):
        return unpack_map_channels(map_bev, num_channels, dtype)
    return map_bev.to(dtype)
