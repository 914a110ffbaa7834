"""Pairwise box IoU: axis-aligned (the box overlap NMS uses) and exact
rotated (convex polygon clip).

Counterpart of ``intentbev/boxes/iou.py``:

- ``axis_aligned_iou``: boxes are (cx, cy, w, h, ...), extra columns
  ignored, heading ignored;
- ``rotated_iou``: the Sutherland-Hodgman clip of one box's quad by the
  other's four edges, batched over every pair at once (a fixed buffer of
  ``MAX_CLIP_VERTS`` vertices a pair, the loop over a polygon's vertices
  masked where JAX's ``fori_loop`` stops), with the reference's guards.
  Corners: width along local x, length along local y, turned CCW by yaw.
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


MAX_CLIP_VERTS = 10  # a quad clipped by 4 half-planes has <= 8 vertices
PAIR_BLOCK = 1 << 20


def box_corners(box_xywha: torch.Tensor) -> torch.Tensor:
    """(..., 5) -> (..., 4, 2) CCW corners."""
    cx, cy, w, l, a = box_xywha.unbind(-1)
    hw, hl = w / 2.0, l / 2.0
    sx = torch.stack([-hw, hw, hw, -hw], dim=-1)
    sy = torch.stack([-hl, -hl, hl, hl], dim=-1)
    ca, sa = torch.cos(a)[..., None], torch.sin(a)[..., None]
    gx = sx * ca - sy * sa + cx[..., None]
    gy = sx * sa + sy * ca + cy[..., None]
    return torch.stack([gx, gy], dim=-1)


def _clip_by_halfplane(poly, n, p1, p2):
    """Clip polygons [P, V, 2] (their first ``n`` [P] vertices) by the left
    side of the edges p1 -> p2 [P, 2] -> (polygons, vertex counts)."""
    v = poly.shape[1]
    rows = torch.arange(poly.shape[0], device=poly.device)
    slots = torch.arange(v, device=poly.device)
    edge = p2 - p1

    def side(pt):
        d = pt - p1
        return edge[:, 0] * d[:, 1] - edge[:, 1] * d[:, 0]

    out = torch.zeros_like(poly)
    m = torch.zeros_like(n)
    for i in range(v):
        active = i < n
        cur = poly[:, i]
        nxt = poly[rows, torch.where(i + 1 >= n, 0, i + 1)]
        s_cur, s_nxt = side(cur), side(nxt)
        cur_in, nxt_in = s_cur >= 0.0, s_nxt >= 0.0
        denom = s_cur - s_nxt
        t = torch.where(denom.abs() > 1e-12,
                        s_cur / torch.where(denom == 0.0, torch.ones_like(denom), denom),
                        torch.zeros_like(denom))
        inter = cur + t[:, None] * (nxt - cur)
        for emit, pt in ((active & (cur_in != nxt_in), inter), (active & nxt_in, nxt)):
            at = (slots[None] == m[:, None]) & emit[:, None]  # a slot past V drops
            out = torch.where(at[..., None], pt[:, None], out)
            m = m + emit.to(m.dtype)
    return out, m


def _polygon_area(verts, n):
    """Shoelace area of the first ``n`` [P] vertices of [P, V, 2]."""
    v = verts.shape[1]
    idx = torch.arange(v, device=verts.device)[None]
    nxt = torch.where(idx + 1 >= n[:, None], 0, idx + 1)
    x, y = verts[..., 0], verts[..., 1]
    cross = x * torch.gather(y, 1, nxt) - torch.gather(x, 1, nxt) * y
    cross = torch.where(idx < n[:, None], cross, torch.zeros_like(cross))
    return 0.5 * cross.sum(-1).abs()


def _pair_intersection_area(c1, c2):
    """Intersection areas [P] of convex CCW quads c1, c2 [P, 4, 2]."""
    p = c1.shape[0]
    poly = torch.zeros((p, MAX_CLIP_VERTS, 2), dtype=c1.dtype, device=c1.device)
    poly[:, :4] = c1
    n = torch.full((p,), 4, dtype=torch.int64, device=c1.device)
    for k in range(4):
        poly2, n2 = _clip_by_halfplane(poly, n, c2[:, k], c2[:, (k + 1) % 4])
        poly, n = poly2, torch.where(n == 0, torch.zeros_like(n2), n2)
    return _polygon_area(poly, n)


def rotated_iou(boxes1_xywha: torch.Tensor, boxes2_xywha: torch.Tensor) -> torch.Tensor:
    """Exact rotated IoU matrix [..., M, N] for boxes [..., M, 5] and
    [..., N, 5] (leading dimensions broadcast). Zero-area boxes give 0,
    intersections <= 1e-7 give 0, unions <= 1e-6 give 0."""
    c1 = box_corners(boxes1_xywha)[..., :, None, :, :]  # [..., M, 1, 4, 2]
    c2 = box_corners(boxes2_xywha)[..., None, :, :, :]  # [..., 1, N, 4, 2]
    c1, c2 = torch.broadcast_tensors(c1, c2)
    shape = c1.shape[:-2]
    c1, c2 = c1.reshape(-1, 4, 2), c2.reshape(-1, 4, 2)
    # pairs in blocks: the clip's temporaries are ~100 bytes a pair
    inter = torch.cat([_pair_intersection_area(c1[i:i + PAIR_BLOCK], c2[i:i + PAIR_BLOCK])
                       for i in range(0, max(c1.shape[0], 1), PAIR_BLOCK)]).reshape(shape)
    a1 = (boxes1_xywha[..., 2] * boxes1_xywha[..., 3]).abs()[..., :, None]
    a2 = (boxes2_xywha[..., 2] * boxes2_xywha[..., 3]).abs()[..., None, :]
    union = a1 + a2 - inter
    ok = (inter > 1e-7) & (union > 1e-6) & (a1 >= 1e-6) & (a2 >= 1e-6)
    return torch.where(ok, inter / torch.where(union == 0.0, torch.ones_like(union), union),
                       torch.zeros_like(union))
