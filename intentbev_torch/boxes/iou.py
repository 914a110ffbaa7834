"""Axis-aligned pairwise IoU (the box overlap NMS uses).

Counterpart of ``intentbev/boxes/iou.py::axis_aligned_iou``: boxes are
(cx, cy, w, h, ...), extra columns ignored, heading ignored.
"""

from __future__ import annotations

import torch


def axis_aligned_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix [..., M, N] for boxes [..., M, >=4] and [..., N, >=4]."""
    x1a = boxes1[..., 0] - boxes1[..., 2] / 2
    y1a = boxes1[..., 1] - boxes1[..., 3] / 2
    x2a = boxes1[..., 0] + boxes1[..., 2] / 2
    y2a = boxes1[..., 1] + boxes1[..., 3] / 2
    x1b = boxes2[..., 0] - boxes2[..., 2] / 2
    y1b = boxes2[..., 1] - boxes2[..., 3] / 2
    x2b = boxes2[..., 0] + boxes2[..., 2] / 2
    y2b = boxes2[..., 1] + boxes2[..., 3] / 2
    iw = (torch.minimum(x2a[..., :, None], x2b[..., None, :])
          - torch.maximum(x1a[..., :, None], x1b[..., None, :])).clamp(min=0)
    ih = (torch.minimum(y2a[..., :, None], y2b[..., None, :])
          - torch.maximum(y1a[..., :, None], y1b[..., None, :])).clamp(min=0)
    inter = iw * ih
    area1 = boxes1[..., 2] * boxes1[..., 3]
    area2 = boxes2[..., 2] * boxes2[..., 3]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / (union + 1e-7)
