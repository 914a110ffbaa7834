"""Anchor grid generation (numpy, host).

Copy of ``intentbev/boxes/anchors.py::generate_anchors``; the JAX package's
``boxes`` package imports JAX, so the port carries its own. The flattened
anchor index is ``((h * Wf + w) * A + a)``, the order of the heads'
``[B, Hf, Wf, A, P] -> [B, Hf*Wf*A, P]`` reshape.
"""

from __future__ import annotations

import numpy as np


def generate_anchors(grid, anchor_cfg) -> np.ndarray:
    """f32[(Hf*Wf*A), 5] anchors (cx, cy, w, l, yaw) in ego metres,
    location-major, anchor-minor."""
    stride = anchor_cfg.stride
    fh = grid.height_px // stride
    fw = grid.width_px // stride
    gy, gx = np.meshgrid(np.arange(fh), np.arange(fw), indexing="ij")
    center_px_x = gx * stride + stride / 2.0  # column
    center_px_y = gy * stride + stride / 2.0  # row
    center_ego_y = (center_px_x - grid.pixel_offset_x) * grid.voxel_size_m
    center_ego_x = (grid.pixel_offset_y - center_px_y) * grid.voxel_size_m
    centers = np.stack([center_ego_x, center_ego_y], axis=-1).reshape(-1, 2)
    shapes = np.asarray(anchor_cfg.anchor_shapes, dtype=np.float32)
    n_loc, n_a = centers.shape[0], shapes.shape[0]
    anchors = np.concatenate(
        [np.broadcast_to(centers[:, None, :], (n_loc, n_a, 2)),
         np.broadcast_to(shapes[None, :, :], (n_loc, n_a, 3))],
        axis=-1,
    )
    return anchors.reshape(n_loc * n_a, 5).astype(np.float32)
