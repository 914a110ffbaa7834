"""A copy of ``intentbev/geometry.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_data.py`` holds the loader that uses it
against the original.

SE(3)/quaternion geometry and world<->BEV-pixel transforms.

Replaces the reference's scipy ``Rotation`` usage (reference dataset.py:293,
utils.py:124,209) with closed-form quaternion math, and its 2D ego transform
helpers (reference utils.py:35-60). Host-side variants operate on numpy; the
same formulas are pure enough to trace under jit when given jnp arrays.
"""

from __future__ import annotations

import numpy as np

from .configs import GridConfig


def quat_to_yaw(qx, qy, qz, qw):
    """Yaw (z euler angle, 'xyz' extrinsic convention) from a unit quaternion.

    Matches ``scipy.spatial.transform.Rotation.from_quat(q).as_euler('xyz')[2]``
    used throughout the reference (utils.py:124, utils.py:209,
    heuristic_labeling.py:48-49).
    """
    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = 1.0 - 2.0 * (qy * qy + qz * qz)
    return np.arctan2(siny_cosp, cosy_cosp)


def quat_to_rotation_matrix(q: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix from quaternion [qx, qy, qz, qw] (scalar-last).

    Matches scipy ``Rotation.from_quat(q).as_matrix()`` (reference
    dataset.py:293). Normalises the quaternion first; raises on zero norm the
    way scipy raises ValueError.
    """
    q = np.asarray(q, dtype=np.float64)
    n = np.linalg.norm(q)
    if n == 0.0 or not np.isfinite(n):
        raise ValueError("Invalid (zero/non-finite) quaternion")
    x, y, z, w = q / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def se3_from_quat_translation(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """4x4 homogeneous transform from quaternion + translation."""
    T = np.eye(4)
    T[:3, :3] = quat_to_rotation_matrix(q)
    T[:3, 3] = np.asarray(t, dtype=np.float64)
    return T


def se3_inverse(T: np.ndarray) -> np.ndarray:
    """Closed-form inverse of a rigid transform (cheaper + stabler than inv)."""
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = np.eye(4)
    Ti[:3, :3] = R.T
    Ti[:3, 3] = -R.T @ t
    return Ti


def transform_points(points: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to Nx3 points (reference utils.py:27-33)."""
    if points.shape[0] == 0:
        return np.empty((0, 3), dtype=points.dtype)
    return points[:, :3] @ T[:3, :3].T + T[:3, 3]


def ego_centric_transform_matrix(ego_translation_xy: np.ndarray, ego_yaw: float) -> np.ndarray:
    """3x3 2D homogeneous world->ego transform (reference utils.py:35-45)."""
    cos_yaw, sin_yaw = np.cos(-ego_yaw), np.sin(-ego_yaw)
    R = np.array([[cos_yaw, -sin_yaw], [sin_yaw, cos_yaw]])
    T = np.eye(3)
    T[:2, :2] = R
    T[:2, 2] = -R @ np.asarray(ego_translation_xy, dtype=np.float64)
    return T


def ego_xy_to_pixel(x_ego, y_ego, grid: GridConfig, floor: bool = True):
    """Ego-metric (x fwd, y left) -> (col, row) pixel indices.

    col = offset_x + y/voxel ; row = offset_y - x/voxel
    (reference utils.py:80-81 uses floor; utils.py:56-57 uses round).
    Returns float coords when ``floor`` is False.
    """
    col = grid.pixel_offset_x + np.asarray(y_ego) / grid.voxel_size_m
    row = grid.pixel_offset_y - np.asarray(x_ego) / grid.voxel_size_m
    if floor:
        return np.floor(col).astype(np.int32), np.floor(row).astype(np.int32)
    return col, row


def world_to_bev_pixel(points_world_xy: np.ndarray, ego_tf: np.ndarray, grid: GridConfig) -> np.ndarray:
    """World XY -> rounded (col, row) BEV pixels (reference utils.py:47-60)."""
    if points_world_xy.shape[0] == 0:
        return np.empty((0, 2), dtype=int)
    pts_ego = points_world_xy @ ego_tf[:2, :2].T + ego_tf[:2, 2]
    col = grid.pixel_offset_x + pts_ego[:, 1] / grid.voxel_size_m
    row = grid.pixel_offset_y - pts_ego[:, 0] / grid.voxel_size_m
    return np.round(np.stack([col, row], axis=1)).astype(int)


def wrap_angle(theta):
    """Wrap angles to (-pi, pi] matching atan2(sin, cos) semantics."""
    return np.arctan2(np.sin(theta), np.cos(theta))
