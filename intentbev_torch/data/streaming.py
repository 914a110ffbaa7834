"""Sweep rings on the device for streaming multi-sweep inference.

Counterpart of ``intentbev/data/streaming.py``. The batch loader moves all
S sweeps of a sample into the newest ego frame on the host, so each sweep
is transformed S times; in streaming each sweep arrives once. A
:class:`SweepRing` keeps the last S sweeps on one device, each in its own
capture frame with its world pose; per frame, :func:`voxelize_ring`
re-projects them into the current ego frame on the device (``rel =
inv(current) @ pose``, one [P, 3] x [3, 3] product a sweep) and bins them
with the device voxelizer (``bev.voxelize.voxelize_packed``, the jitted JAX
voxelizer's bins). One sweep a frame crosses to the device.

A ring's head and count are device scalars, so pushing and voxelizing
never wait for the device. :func:`push_sweep` writes the new sweep into the
ring's buffers in place (JAX returns new arrays; here the returned ring
shares the buffers of the one passed in) and returns the ring with its head
and count advanced. A fleet of B streams is one ring whose tensors carry a
leading batch dimension (:func:`stack_rings`);
:func:`batched_voxelize_rings` voxelizes it in one pass into [B, H, W, S*Z]
for ``parallel.StreamingInferencer``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bev.voxelize import voxelize_packed
from ..configs import GridConfig


class SweepRing(NamedTuple):
    points: torch.Tensor  # f32[(B,) S, P, 4] in each sweep's own ego frame
    valid: torch.Tensor   # bool[(B,) S, P]
    poses: torch.Tensor   # f32[(B,) S, 4, 4] world_SE3_sweep
    head: torch.Tensor    # i64[(B,)]: the next slot to overwrite (the oldest)
    count: torch.Tensor   # i64[(B,)]: sweeps pushed so far, at most S


def make_ring(num_sweeps: int, max_points: int, device="cuda") -> SweepRing:
    """An empty ring of ``num_sweeps`` slots of ``max_points`` points on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = torch.device(device)
    return SweepRing(
        points=torch.zeros(num_sweeps, max_points, 4, device=dev),
        valid=torch.zeros(num_sweeps, max_points, dtype=torch.bool, device=dev),
        poses=torch.eye(4, device=dev).repeat(num_sweeps, 1, 1),
        head=torch.zeros((), dtype=torch.long, device=dev),
        count=torch.zeros((), dtype=torch.long, device=dev),
    )


def push_sweep(ring: SweepRing, points: torch.Tensor, valid: torch.Tensor,
               world_se3: torch.Tensor) -> SweepRing:
    """Write the newest sweep over the oldest slot: points f32[(B,) P, 4]
    (x, y, z, intensity) in the sweep's frame, valid bool[(B,) P], world_se3
    f32[(B,) 4, 4] -> the ring with head and count advanced (its buffers
    updated in place)."""
    dev = ring.points.device
    s = ring.points.shape[-3]
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    vld = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    pose = torch.as_tensor(world_se3, dtype=torch.float32, device=dev)
    if ring.head.dim() == 0:
        slot = ring.head.view(1)
        ring.points.index_copy_(0, slot, pts[None])
        ring.valid.index_copy_(0, slot, vld[None])
        ring.poses.index_copy_(0, slot, pose[None])
    else:
        streams = torch.arange(ring.head.shape[0], device=dev)
        ring.points[streams, ring.head] = pts
        ring.valid[streams, ring.head] = vld
        ring.poses[streams, ring.head] = pose
    return ring._replace(head=(ring.head + 1) % s, count=(ring.count + 1).clamp(max=s))


def batched_voxelize_rings(rings: SweepRing, current_world_se3: torch.Tensor, grid: GridConfig,
                           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Voxelize B stream rings (leading batch dimension) at their current
    poses f32[B, 4, 4] -> [B, H, W, S*Z].

    The channels are the batch path's (sweep slot * Z + z slice, slot 0 the
    oldest buffered sweep), so a model trained on the loader's batches reads
    ring BEVs once the ring is warm; slots never written are masked until
    then."""
    b, s = rings.points.shape[:2]
    dev = rings.points.device
    age = torch.arange(s, device=dev)  # 0 = oldest
    order = (rings.head[:, None] + age) % s  # [B, S]: oldest first
    pts = torch.take_along_dim(rings.points, order[:, :, None, None], dim=1)
    valid = torch.take_along_dim(rings.valid, order[:, :, None], dim=1)
    poses = torch.take_along_dim(rings.poses, order[:, :, None, None], dim=1)
    warm = age[None, :] >= (s - rings.count[:, None])
    valid = valid & warm[:, :, None]

    # rel = inv(current) @ world_SE3_sweep, on the device in f32
    cur = current_world_se3.to(device=dev, dtype=torch.float32)
    rt = cur[:, :3, :3].transpose(1, 2)
    inv = torch.eye(4, device=dev).repeat(b, 1, 1)
    inv[:, :3, :3] = rt
    inv[:, :3, 3] = (-rt @ cur[:, :3, 3, None])[..., 0]
    rel = inv[:, None] @ poses  # [B, S, 4, 4]
    xyz = pts[..., :3] @ rel[:, :, :3, :3].transpose(-1, -2) + rel[:, :, None, :3, 3]
    return voxelize_packed(torch.cat([xyz, pts[..., 3:]], dim=-1), valid, grid,
                           out_dtype=out_dtype)


def voxelize_ring(ring: SweepRing, current_world_se3: torch.Tensor, grid: GridConfig,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Re-project one ring's sweeps into the ego frame of
    ``current_world_se3`` f32[4, 4] (the newest sweep's) and voxelize ->
    [H, W, S*Z] (:func:`batched_voxelize_rings` at B = 1)."""
    rings = SweepRing(*(t[None] for t in ring))
    cur = torch.as_tensor(current_world_se3, dtype=torch.float32, device=ring.points.device)
    return batched_voxelize_rings(rings, cur[None], grid, out_dtype)[0]


def stack_rings(rings: list[SweepRing]) -> SweepRing:
    """B single-stream rings -> one ring with a leading batch dimension."""
    return SweepRing(*(torch.stack(ts) for ts in zip(*rings)))


def se3_from_pose_row(pose) -> np.ndarray:
    """An AV2 pose row (tx_m .. qw) -> f32[4, 4] world_SE3_ego (host)."""
    from ..geometry import se3_from_quat_translation

    return se3_from_quat_translation(
        [pose["qx"], pose["qy"], pose["qz"], pose["qw"]],
        [pose["tx_m"], pose["ty_m"], pose["tz_m"]],
    ).astype(np.float32)
