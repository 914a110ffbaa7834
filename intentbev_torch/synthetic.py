"""Synthetic serving inputs, as the JAX package's bench draws them
(``bench.py`` ``run_sustained.random_batch``): uniform points over the
grid's metric extent, u8-integral intensities, and a bit-packed binary
map with 5 % of its cells set."""

from __future__ import annotations

import numpy as np

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
