"""Detection and intention heads (3x3 convs), NHWC in.

Counterpart of ``intentbev/models/heads.py``. The flattened anchor index is
``((h * Wf + w) * A + a)``: the NCHW conv output is permuted to
[B, Hf, Wf, A*P] before the reshape to [B, Hf, Wf, A, P] (conv channel
``a * P + p``), so both frameworks read the same order.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import conv


def _conv_nhwc(mod: nn.Conv2d, x_nhwc: torch.Tensor, per_anchor: int):
    out = conv(mod, x_nhwc.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    b, hf, wf, _ = out.shape
    return out.reshape(b, hf, wf, -1, per_anchor)


class DetectionHead(nn.Module):
    """3x3 conv -> per anchor (objectness, box deltas)."""

    def __init__(self, in_ch: int, num_anchors: int = 5, num_box_params: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.per_anchor = 1 + num_box_params
        self.conv = nn.Conv2d(in_ch, num_anchors * self.per_anchor, 3, 1, 1,
                              dtype=dtype)

    def forward(self, x_nhwc: torch.Tensor):
        out = _conv_nhwc(self.conv, x_nhwc, self.per_anchor)
        return out[..., 0], out[..., 1:]


class IntentionHead(nn.Module):
    """3x3 conv -> per-anchor intention logits [B, Hf, Wf, A, C]."""

    def __init__(self, in_ch: int, num_anchors: int = 5, num_classes: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.conv = nn.Conv2d(in_ch, num_anchors * num_classes, 3, 1, 1,
                              dtype=dtype)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.conv, x_nhwc, self.num_classes)


def flatten_head_outputs(cls_logits, box_preds, intent_logits):
    """(B, Hf, Wf, A, .) -> (B, Hf*Wf*A, .)."""
    b = cls_logits.shape[0]
    return (cls_logits.reshape(b, -1, 1),
            box_preds.reshape(b, -1, box_preds.shape[-1]),
            intent_logits.reshape(b, -1, intent_logits.shape[-1]))
