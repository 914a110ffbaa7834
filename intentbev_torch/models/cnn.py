"""IntentNetCNN: two-stream residual CNN backbone, detection and intention
heads.

Counterpart of ``intentbev/models/cnn.py``: LiDAR stream 290 -> 160 (s2) ->
192 -> 224 (s2) and map stream 9 -> 32 (s2) -> 64 -> 96 (s2), each stage a
``ResidualStage`` of k=5 BasicBlocks; the streams concatenate at 4x
downsampling, and the fusion stage (k=3, s2) gives 512 channels at total
stride 8; the heads follow. Convolutions are plain ``F.conv2d`` (XLA
convolutions in the JAX package) over channels-last NCHW views of the NHWC
activations; logits come out in f32.

The lidar input is a dense BEV, NHWC or NCHW: the serving chunk transport
and the chunk train transport fill it from placement chunks with
``ops.voxel_embed.voxel_fill_bev`` in front of the model, the points
transport with the scatter-max voxelizer. Submodule names are the flax
names (``backbone.lidar_stage{i}``, ``backbone.map_stage{i}``,
``backbone.fusion``, ``det_head``, ``intention_head``), so
``weights.from_flax`` maps the JAX model's parameters with its usual rules.
"""

from __future__ import annotations

import torch
from torch import nn

from ..bev.rasterize import decode_map_transport
from ..utils.distributed import DataGroup
from .blocks import ResidualStage, ensure_nhwc, reset_conv_bn
from .heads import DetectionHead, IntentionHead, flatten_head_outputs


class CNNBackbone(nn.Module):
    """(lidar NHWC, map NHWC) -> fused features NHWC at total stride 8."""

    def __init__(self, cfg, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        for prefix, in_ch, planes in (("lidar", cfg.lidar_input_channels, cfg.lidar_planes),
                                      ("map", cfg.map_input_channels, cfg.map_planes)):
            for i, (p, s) in enumerate(zip(planes, cfg.stage_strides)):
                self.add_module(f"{prefix}_stage{i + 1}", ResidualStage(
                    in_ch, p, cfg.num_blocks_per_stage, s, cfg.stream_kernel_size, dtype))
                in_ch = p
        self.fusion = ResidualStage(cfg.lidar_planes[-1] + cfg.map_planes[-1],
                                    cfg.fusion_planes, cfg.fusion_layers, cfg.fusion_stride,
                                    cfg.fusion_kernel_size, dtype)

    def forward(self, lidar_nhwc: torch.Tensor, map_nhwc: torch.Tensor,
                group: DataGroup | None = None) -> torch.Tensor:
        def stream(x, prefix):
            for i in range(len(self.cfg.stage_strides)):
                x = getattr(self, f"{prefix}_stage{i + 1}")(x, group)
            return x

        return self.fusion(torch.cat([stream(lidar_nhwc, "lidar"), stream(map_nhwc, "map")],
                                     dim=-1), group)


class IntentNetCNN(nn.Module):
    """(lidar BEV [B, H, W, C] or [B, C, H, W]; map NHWC/NCHW, or bit-packed
    u8 [B, H, W, ceil(C/8)]) -> f32 (cls [B, N, 1], box deltas [B, N, 6],
    intent logits [B, N, C]), N = (H/8)*(W/8)*A.

    ``dtype`` is the compute dtype, ``param_dtype`` that of the conv weights
    (default: the compute dtype; training passes f32 master weights, cast
    at use); BN runs in f32 from its running statistics in eval mode and
    from the batch's in training mode. ``plain_ops=True`` makes the callers
    that fill the BEV from chunks (``StreamingInferencer``, the train step)
    take the fill's plain PyTorch version; the model itself has no kernel."""

    def __init__(self, cfg, head_cfg, dtype: torch.dtype = torch.float32,
                 plain_ops: bool = False, param_dtype: torch.dtype | None = None):
        super().__init__()
        pdt = dtype if param_dtype is None else param_dtype
        self.cfg = cfg
        self.dtype = dtype
        self.plain_ops = plain_ops
        self.backbone = CNNBackbone(cfg, pdt)
        self.det_head = DetectionHead(cfg.fusion_planes, head_cfg.num_anchors,
                                      head_cfg.num_box_params, pdt)
        self.intention_head = IntentionHead(cfg.fusion_planes, head_cfg.num_anchors,
                                            head_cfg.num_intention_classes, pdt)

    def forward(self, lidar_bev: torch.Tensor, map_bev: torch.Tensor, generator=None,
                group: DataGroup | None = None):
        """``generator`` is unused (the CNN draws nothing); the train step
        passes it to either family. ``group``: the data-parallel group whose
        global batch BatchNorm's training statistics cover."""
        cfg = self.cfg
        lidar = ensure_nhwc(lidar_bev, cfg.lidar_input_channels).to(self.dtype)
        m = ensure_nhwc(decode_map_transport(map_bev, cfg.map_input_channels, self.dtype),
                        cfg.map_input_channels)
        feats = self.backbone(lidar, m, group)
        cls_l, box = self.det_head(feats)
        intent = self.intention_head(feats)
        return tuple(t.float() for t in flatten_head_outputs(cls_l, box, intent))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random init: Kaiming normal (fan-out) for the backbone
        convs, LeCun normal and zero bias for the head convs, unit BN scales
        and running variances."""
        for mod in self.modules():
            reset_conv_bn(mod, generator)
