"""Fixed-shape detection post-processing: decode, confidence filter, exact
top-k, fixpoint greedy NMS, fixed-size output.

Counterpart of ``intentbev/boxes/nms.py`` (batched tensors instead of
vmap). ``torch.topk`` does not promise JAX's order among equal values; the
only ties the pipeline creates are the masked ``NEG_INF`` slots, which are
invalid and never reach the output.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .codec import decode_boxes
from .iou import axis_aligned_iou

NEG_INF = -1e9


class Detections(NamedTuple):
    """Fixed-size detections per sample, sorted by descending score.

    ``num_conf`` counts anchors above the confidence threshold and
    ``num_kept`` NMS survivors before the ``max_detections`` cut; either
    above its cap means the cap bound (as in the JAX package)."""

    boxes_xywha: torch.Tensor  # f32[B, max_det, 5]
    scores: torch.Tensor       # f32[B, max_det]
    intentions: torch.Tensor   # i32[B, max_det]
    valid: torch.Tensor        # bool[B, max_det]
    num_conf: torch.Tensor     # i32[B]
    num_kept: torch.Tensor     # i32[B]


def greedy_nms_mask(boxes_xywha: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over score-sorted candidates [..., K, 5] -> keep [..., K].

    A candidate is suppressed by an earlier kept one with IoU strictly
    above the threshold (heading ignored). Computed as the fixpoint of
    keep <- valid & ~any_j(overlap[j, i] & keep[j]), which equals the
    sequential greedy result once it stops changing."""
    k = boxes_xywha.shape[-2]
    iou = axis_aligned_iou(boxes_xywha, boxes_xywha)
    idx = torch.arange(k, device=boxes_xywha.device)
    overlap = (iou > iou_threshold) & (idx[:, None] < idx[None, :])
    keep = valid
    for _ in range(k):
        new = valid & ~(overlap & keep[..., :, None]).any(-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def postprocess_detections(cls_logits: torch.Tensor, box_deltas: torch.Tensor,
                           intent_logits: torch.Tensor, anchors: torch.Tensor,
                           **kwargs) -> Detections:
    """One sample: logits [N, 1] or [N], deltas [N, 6], intent [N, C]."""
    det = batched_postprocess(cls_logits.reshape(1, -1, 1), box_deltas[None],
                              intent_logits[None], anchors, **kwargs)
    return Detections(*(x[0] for x in det))


def batched_postprocess(cls_logits: torch.Tensor, box_deltas: torch.Tensor,
                        intent_logits: torch.Tensor, anchors: torch.Tensor, *,
                        confidence_threshold: float = 0.1,
                        nms_iou_threshold: float = 0.2, max_pre_nms: int = 1024,
                        max_detections: int = 128) -> Detections:
    """Logits [B, N, 1], deltas [B, N, 6], intent logits [B, N, C] and
    anchors [N, 5] -> :class:`Detections` (sigmoid -> score >= threshold ->
    top max_pre_nms -> decode -> NMS -> first max_detections kept)."""
    b = cls_logits.shape[0]
    scores = torch.sigmoid(cls_logits.reshape(b, -1))
    conf_ok = scores >= confidence_threshold
    masked = torch.where(conf_ok, scores, torch.full_like(scores, NEG_INF))
    top_scores, top_idx = torch.topk(masked, max_pre_nms, dim=-1, sorted=True)
    top_valid = top_scores > NEG_INF / 2

    def take(x):
        return torch.gather(x, 1, top_idx[..., None].expand(-1, -1, x.shape[-1]))

    top_boxes = decode_boxes(take(box_deltas), anchors[top_idx])
    top_intent = take(intent_logits).argmax(-1).to(torch.int32)
    keep = greedy_nms_mask(top_boxes, top_valid, nms_iou_threshold)

    # kept candidates go to slots 0.. in score order; the rest, and kept
    # ones past max_detections, go to a spare slot that is cut off
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    slot = torch.where(keep, rank, torch.full_like(rank, max_detections))
    slot = slot.clamp(max=max_detections)
    dev = cls_logits.device

    def place(src, fill_shape, dtype):
        out = torch.zeros((b, max_detections + 1) + fill_shape, dtype=dtype, device=dev)
        index = slot.reshape(slot.shape + (1,) * len(fill_shape)).expand_as(src)
        return out.scatter_(1, index, src)[:, :max_detections]

    valid = place(keep, (), torch.bool)
    return Detections(
        boxes_xywha=place(top_boxes, (5,), top_boxes.dtype),
        scores=torch.where(valid, place(top_scores, (), scores.dtype), 0.0),
        intentions=place(top_intent, (), torch.int32),
        valid=valid,
        num_conf=conf_ok.sum(-1, dtype=torch.int32),
        num_kept=keep.sum(-1, dtype=torch.int32),
    )
