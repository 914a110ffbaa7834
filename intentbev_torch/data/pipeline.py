"""Host batch stacking of the chunk train transport.

Counterpart of ``ChunkBatch`` and ``_stack_chunks`` in
``intentbev/data/pipeline.py``, over arrays rather than loader samples.
Per sample, the points make the i16-centimetre round trip of the points
transport first (so both transports voxelize identical coordinates), take
the drawn flip/rotate/scale on the host (``augment_points_np``), and go
through the C++ chunk build at the fixed ``chunk_capacity`` (overfull
bands drop their excess chunks); the chunks are stacked and packed. The
GT stays unaugmented: the train step applies ``augment_gt`` on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..bev.augment import augment_points_np
from ..bev.rasterize import pack_map_channels
from ..bev.voxelize import dequantize_points_np, quantize_points_cm
from ..ops.voxel_embed import (VoxelChunks, build_voxel_chunks, chunks_to_device,
                               pack_chunk_transport, stack_voxel_chunks)


class ChunkBatch(NamedTuple):
    chunks: VoxelChunks        # packed (u16 slot|channel, u8 values when integral)
    map_bev: np.ndarray        # u8[B, H, W, ceil(C/8)] bit-packed (binary u8 maps)
    gt_boxes: np.ndarray       # f32[B, G, 5], unaugmented
    gt_intentions: np.ndarray  # i32[B, G]
    gt_valid: np.ndarray       # bool[B, G]
    aug_params: np.ndarray     # f32[B, 3] = (flip_sign, theta, scale)


def _stack_map(maps: Sequence[np.ndarray]) -> np.ndarray:
    """Stack per-sample maps; binary u8 maps ship bit-packed (exact)."""
    map_bev = np.stack(maps)
    if map_bev.dtype == np.uint8 and map_bev.shape[-1] > 1:
        map_bev = pack_map_channels(map_bev)
    return map_bev


def stack_chunk_batch(points: Sequence[np.ndarray], points_valid: Sequence[np.ndarray],
                      map_bev: Sequence[np.ndarray], gt_boxes: Sequence[np.ndarray],
                      gt_intentions: Sequence[np.ndarray], gt_valid: Sequence[np.ndarray],
                      aug_params: Sequence[np.ndarray], grid, chunk_patch: int,
                      chunk_capacity: int) -> ChunkBatch:
    """Per-sample arrays (points f32[S, P, 4], valid bool[S, P], map [H, W,
    C], GT, aug params f32[3]) -> one :class:`ChunkBatch`."""
    chunks = []
    for pts, valid, aug in zip(points, points_valid, aug_params):
        pts = augment_points_np(dequantize_points_np(quantize_points_cm(pts)), aug)
        chunks.append(build_voxel_chunks(pts, valid, grid, chunk_patch, chunk_capacity,
                                         on_overflow="drop"))
    return ChunkBatch(
        chunks=pack_chunk_transport(stack_voxel_chunks(chunks)),
        map_bev=_stack_map(map_bev),
        gt_boxes=np.stack(gt_boxes),
        gt_intentions=np.stack(gt_intentions),
        gt_valid=np.stack(gt_valid),
        aug_params=np.stack(aug_params).astype(np.float32),
    )


def chunk_batch_to_device(batch: ChunkBatch, device) -> dict:
    """-> the train step's batch dict on ``device`` (``chunks`` still in the
    packed transport encoding; the step decodes it)."""
    out = {"chunks": chunks_to_device(batch.chunks, device)}
    for name in ChunkBatch._fields[1:]:
        out[name] = torch.from_numpy(np.ascontiguousarray(getattr(batch, name))).to(device)
    return out
