"""Box delta codec (dx, dy, dw, dl, sin dh, cos dh) against anchors.

Counterpart of ``intentbev/boxes/codec.py``: centre deltas scale by anchor
width (x) and length (y), as in the JAX package.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def encode_boxes(gt_xywha: torch.Tensor, anchors_xywha: torch.Tensor) -> torch.Tensor:
    """GT boxes [..., 5] against anchors [..., 5] -> deltas [..., 6]."""
    gx, gy, gw, gl, gh = gt_xywha.unbind(-1)
    ax, ay, aw, al, ah = anchors_xywha.unbind(-1)
    return torch.stack([
        (gx - ax) / (aw + _EPS),
        (gy - ay) / (al + _EPS),
        torch.log(gw / (aw + _EPS) + _EPS),
        torch.log(gl / (al + _EPS) + _EPS),
        torch.sin(gh - ah),
        torch.cos(gh - ah),
    ], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors_xywha: torch.Tensor) -> torch.Tensor:
    """deltas [..., 6] against anchors [..., 5] -> boxes [..., 5]
    (cx, cy, w, l, yaw), yaw wrapped to (-pi, pi]."""
    dx, dy, dw, dl, d_sin, d_cos = deltas.unbind(-1)
    ax, ay, aw, al, ah = anchors_xywha.unbind(-1)
    h = ah + torch.atan2(d_sin, d_cos)
    return torch.stack([
        dx * aw + ax,
        dy * al + ay,
        torch.exp(dw) * aw,
        torch.exp(dl) * al,
        torch.atan2(torch.sin(h), torch.cos(h)),
    ], dim=-1)
