"""Streaming detection on one device, over the chunk or the points transport.

Counterpart of ``intentbev/parallel/inference.py::StreamingInferencer`` on
one device, for either model family (``cfg.model_family``):

- ``transport="points"`` (the default, as in JAX): the device decodes the
  points (i16 transport or f32), voxelizes them (scatter-max) and runs the
  model on the dense BEV.
- ``transport="chunks"``: the host builds and packs placement chunks (C++
  ``ib_build_chunks``) at the band geometry of ``train.chunk_patch_for``
  and the device decodes them. The ViT turns them into lidar tokens with
  the voxel-embed kernel; for the CNN the ``voxel_fill`` kernel writes the
  dense BEV (bf16 on CUDA), as ``bench.py``'s CNN chunk line does.

The model's logits then go through box decode and NMS on the device into
fixed-size :class:`Detections`. :data:`VIT_SERVING_VARIANTS` names the
ViT's serving configurations beyond the default, each with the transport it
serves on.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..bev.voxelize import dequantize_points, dequantize_points_np, voxelize_packed
from ..boxes.anchors import generate_anchors
from ..boxes.nms import Detections, batched_postprocess
from ..models import build_model
from ..ops.voxel_embed import (VoxelChunks, build_voxel_chunks, chunks_to_device,
                               decode_chunk_transport, pack_chunk_transport,
                               stack_voxel_chunks, voxel_fill_bev, voxel_fill_bev_plain)
from ..train import chunk_patch_for

# name -> (ViTBackboneConfig switches, transport)
VIT_SERVING_VARIANTS = {
    "int8": ({"serving_int8": True}, "points"),  # bench.py's --int8 line
    "ln_dense": ({"fuse_ln_dense": True}, "chunks"),
    "unfused_ln": ({"use_fused_layernorm": False}, "chunks"),
    "patch_embed": ({"fuse_patch_embed": True}, "points"),
}


def vit_serving_variant(cfg, name: str):
    """``cfg`` with the switches of serving variant ``name`` -> (config,
    transport)."""
    switches, transport = VIT_SERVING_VARIANTS[name]
    return dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, **switches)), transport


def build_chunk_transport(points, points_valid, grid, patch: int,
                          num_chunks: int) -> VoxelChunks:
    """Host side of the transport: one C++ chunk build per sample (overfull
    bands drop their excess chunks), stacked and packed (u16 slot|channel,
    u8 values when the intensities are integral). ``points`` are f32 metres
    or the i16 transport (cm, raw intensity), dequantized here first, as the
    JAX inferencer does."""
    pts = np.asarray(points)
    if pts.dtype == np.int16:
        pts = dequantize_points_np(pts)
    return pack_chunk_transport(stack_voxel_chunks([
        build_voxel_chunks(p, v, grid, patch, num_chunks, on_overflow="drop")
        for p, v in zip(pts, points_valid)
    ]))


class StreamingInferencer:
    """Load-once, feed-forever detector on one device.

    ``params``: a state dict for the configured family's model (from
    :func:`intentbev_torch.weights.from_flax` or
    :func:`intentbev_torch.models.init_params`). The compute dtype is bf16
    on CUDA and f32 on the CPU. ``gelu`` is the ViT block MLP GELU ("erf"
    or the serving "sigmoid"; the CNN has none). ``plain_ops`` runs every
    kernel's plain PyTorch version (the oracle on the card). ``num_chunks``
    fixes the chunk capacity per band; overfull bands drop their excess
    chunks.
    """

    def __init__(self, cfg, params, device, transport: str = "points",
                 num_chunks: int = 512, gelu: str = "erf", plain_ops: bool = False):
        if transport not in ("chunks", "points"):
            raise ValueError(f"transport {transport!r} not in ('chunks', 'points')")
        self.cfg = cfg
        self.transport = transport
        self.num_chunks = num_chunks
        self.chunk_patch = chunk_patch_for(cfg)
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        model = build_model(cfg, dtype=self.dtype, gelu=gelu, plain_ops=plain_ops)
        model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        self.anchors = torch.from_numpy(
            generate_anchors(cfg.grid, cfg.anchors)).to(self.device)

    def build_chunks(self, points, points_valid) -> VoxelChunks:
        """Host side of the transport (callable from loader threads); see
        :func:`build_chunk_transport`."""
        return build_chunk_transport(points, points_valid, self.cfg.grid,
                                     self.chunk_patch, self.num_chunks)

    def _to_device(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def logits(self, chunks, map_bev):
        """Packed chunks + map (any transport encoding), on the host or
        already copied to the device (``chunks_to_device``) -> the model's
        f32 (cls, box deltas, intent logits) on the device."""
        if not isinstance(chunks.wid, torch.Tensor):
            chunks = chunks_to_device(chunks, self.device)
        lidar = decode_chunk_transport(chunks)
        if self.cfg.model_family == "cnn":
            fill = voxel_fill_bev_plain if self.model.plain_ops else voxel_fill_bev
            g = self.cfg.grid
            lidar = fill(lidar, (g.height_px, g.width_px), g.lidar_total_channels,
                         self.chunk_patch, self.dtype)
        return self.model(lidar, self._to_device(map_bev))

    @torch.inference_mode()
    def logits_points(self, points, points_valid, map_bev):
        """Host points [B, S, P, 4] (f32 metres or the i16 transport), valid
        [B, S, P] and map -> the model's f32 logits on the device, through
        the device voxelizer."""
        lidar = voxelize_packed(dequantize_points(self._to_device(points)),
                                self._to_device(points_valid), self.cfg.grid,
                                out_dtype=self.dtype)
        return self.model(lidar, self._to_device(map_bev))

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

    def infer_points(self, points, points_valid, map_bev, blocking: bool = True) -> Detections:
        """Run host points over the points transport; ``blocking`` as in
        :meth:`infer_chunks`."""
        det = self.postprocess(*self.logits_points(points, points_valid, map_bev))
        return self.fetch(det) if blocking else det

    @staticmethod
    def fetch(det: Detections) -> Detections:
        """Device Detections -> host numpy arrays."""
        return Detections(*(t.cpu().numpy() for t in det))

    def __call__(self, points, points_valid, map_bev) -> Detections:
        if self.transport == "points":
            return self.infer_points(points, points_valid, map_bev)
        return self.infer_chunks(self.build_chunks(points, points_valid), map_bev)

    def stream(self, batches: Iterator) -> Iterator[Detections]:
        """Host Detections for each batch (a mapping with ``points``,
        ``points_valid`` and ``map_bev``), one after the other, as the JAX
        harness's ``stream``."""
        for batch in batches:
            yield self(batch["points"], batch["points_valid"], batch["map_bev"])
