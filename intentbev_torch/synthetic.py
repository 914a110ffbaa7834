"""Synthetic inputs, as the JAX package's benches draw them.

- :func:`serving_batch` (``bench.py`` ``run_sustained.random_batch``):
  uniform points over the grid's metric extent, u8-integral intensities,
  and a bit-packed binary map with 5 % of its cells set;
- :func:`train_batch` (``tools/bench_train.py``): uniform points and
  intensities, a dense 0/1 map, max_gt GT boxes per sample (2 x 4.5 m
  cars ahead of the ego), identity augmentation.
"""

from __future__ import annotations

import numpy as np

from .bev.augment import IDENTITY_AUG
from .bev.rasterize import pack_map_channels


def serving_batch(grid, batch: int, points_per_sweep: int, seed: int):
    """-> (points f32[B, S, P, 4], valid bool[B, S, P], map u8[B, H, W, 2])."""
    r = np.random.default_rng(seed)
    shape = (batch, grid.lidar_sweeps, points_per_sweep)
    pts = np.zeros(shape + (4,), np.float32)
    pts[..., 0] = r.uniform(grid.bev_x_min, grid.bev_x_max, shape)
    pts[..., 1] = r.uniform(grid.bev_y_min + 2, grid.bev_y_max - 2, shape)
    pts[..., 2] = r.uniform(grid.z_min, grid.z_max - 0.1, shape)
    pts[..., 3] = r.integers(0, 256, shape).astype(np.float32)
    mp = pack_map_channels(
        r.uniform(0, 1, (batch, grid.height_px, grid.width_px, grid.map_channels)) < 0.05)
    return pts, np.ones(shape, bool), mp


def train_batch(grid, batch: int, points_per_sweep: int, max_gt: int, seed: int) -> dict:
    """numpy batch of the points-transport train step: points f32[B, S, P,
    4], points_valid, map_bev f32[B, H, W, C], gt_boxes f32[B, G, 5],
    gt_intentions i32[B, G] (all KEEP_LANE), gt_valid, aug_params f32[B, 3]."""
    r = np.random.default_rng(seed)
    b, s, p, g = batch, grid.lidar_sweeps, points_per_sweep, max_gt
    pts = np.zeros((b, s, p, 4), np.float32)
    pts[..., 0] = r.uniform(-20, 60, (b, s, p))
    pts[..., 1] = r.uniform(-70, 70, (b, s, p))
    pts[..., 2] = r.uniform(-2, 3.7, (b, s, p))
    pts[..., 3] = r.uniform(0, 255, (b, s, p))
    gtb = np.zeros((b, g, 5), np.float32)
    gtb[..., 0] = r.uniform(0, 50, (b, g))
    gtb[..., 1] = r.uniform(-30, 30, (b, g))
    gtb[..., 2] = 2.0
    gtb[..., 3] = 4.5
    return {
        "points": pts,
        "points_valid": np.ones((b, s, p), bool),
        "map_bev": (r.uniform(0, 1, (b, grid.height_px, grid.width_px, grid.map_channels))
                    < 0.05).astype(np.float32),
        "gt_boxes": gtb,
        "gt_intentions": np.zeros((b, g), np.int32),
        "gt_valid": np.ones((b, g), bool),
        "aug_params": np.tile(IDENTITY_AUG, (b, 1)),
    }
