"""Streaming detection on one device over the chunk transport.

Counterpart of ``intentbev/parallel/inference.py::StreamingInferencer``
with ``transport="chunks"`` on one device: the host builds and packs
placement chunks (C++ ``ib_build_chunks``), the device decodes the compact
transport, runs IntentNetViT through the port's kernels, decodes boxes and
runs NMS, and returns fixed-size :class:`Detections`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..boxes.anchors import generate_anchors
from ..boxes.nms import Detections, batched_postprocess
from ..models.vit import IntentNetViT
from ..ops.voxel_embed import (VoxelChunks, build_voxel_chunks, chunks_to_device,
                               decode_chunk_transport, pack_chunk_transport,
                               stack_voxel_chunks)


def build_chunk_transport(points, points_valid, grid, patch: int,
                          num_chunks: int) -> VoxelChunks:
    """Host side of the transport: one C++ chunk build per sample (overfull
    bands drop their excess chunks), stacked and packed (u16 slot|channel,
    u8 values when the intensities are integral)."""
    return pack_chunk_transport(stack_voxel_chunks([
        build_voxel_chunks(p, v, grid, patch, num_chunks, on_overflow="drop")
        for p, v in zip(points, points_valid)
    ]))


class StreamingInferencer:
    """Load-once, feed-forever detector on one device.

    ``params``: a state dict for ``IntentNetViT(cfg.vit, cfg.heads)`` (from
    :func:`intentbev_torch.weights.from_flax` or
    :func:`intentbev_torch.models.init_params`). The compute dtype is bf16
    on CUDA and f32 on the CPU. ``gelu`` is the block MLP
    GELU ("erf" or the serving "sigmoid"). ``plain_ops`` runs every kernel's
    plain PyTorch version (the oracle on the card). ``num_chunks`` fixes the
    chunk capacity per band; overfull bands drop their excess chunks.
    """

    def __init__(self, cfg, params, device, transport: str = "chunks",
                 num_chunks: int = 512, gelu: str = "erf", plain_ops: bool = False):
        if transport != "chunks":
            raise ValueError(f"transport {transport!r}: the port serves 'chunks' only")
        self.cfg = cfg
        self.num_chunks = num_chunks
        self.device = torch.device(device)
        dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        model = IntentNetViT(cfg.vit, cfg.heads, dtype=dtype, gelu=gelu,
                             plain_ops=plain_ops)
        model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        self.anchors = torch.from_numpy(
            generate_anchors(cfg.grid, cfg.anchors)).to(self.device)

    def build_chunks(self, points, points_valid) -> VoxelChunks:
        """Host side of the transport (callable from loader threads); see
        :func:`build_chunk_transport`."""
        return build_chunk_transport(points, points_valid, self.cfg.grid,
                                     self.cfg.vit.patch_size, self.num_chunks)

    @torch.inference_mode()
    def logits(self, chunks, map_bev):
        """Packed host chunks + map (any transport encoding) -> the model's
        f32 (cls, box deltas, intent logits) on the device."""
        dev_chunks = decode_chunk_transport(chunks_to_device(chunks, self.device))
        m = torch.from_numpy(np.ascontiguousarray(map_bev)).to(self.device)
        return self.model(dev_chunks, m)

    @torch.inference_mode()
    def postprocess(self, cls, box, intent) -> Detections:
        """The model's logits -> fixed-size Detections on the device (box
        decode, exact top-k, fixpoint NMS, which waits for the device once
        per iteration)."""
        ev = self.cfg.eval
        return batched_postprocess(
            cls, box, intent, self.anchors,
            confidence_threshold=ev.confidence_threshold,
            nms_iou_threshold=ev.nms_iou_threshold,
            max_pre_nms=ev.max_pre_nms, max_detections=ev.max_detections)

    def infer_chunks(self, chunks, map_bev, blocking: bool = True) -> Detections:
        """Run pre-built chunks. ``blocking=False`` returns the Detections
        on the device, without the copy to the host; :meth:`fetch` them."""
        det = self.postprocess(*self.logits(chunks, map_bev))
        return self.fetch(det) if blocking else det

    @staticmethod
    def fetch(det: Detections) -> Detections:
        """Device Detections -> host numpy arrays."""
        return Detections(*(t.cpu().numpy() for t in det))

    def __call__(self, points, points_valid, map_bev) -> Detections:
        return self.infer_chunks(self.build_chunks(points, points_valid), map_bev)
