"""Combined detection + intention loss with batched target assignment.

Counterpart of ``intentbev/losses.py`` (the JAX package's ``vmap`` over the
batch is a batch dimension here):

- anchors x GT axis-aligned IoU; per anchor max IoU < 0.45 -> negative,
  >= 0.6 -> positive, in between ignored; each valid GT's best anchor is
  forced positive when that IoU clears 0.45; every positive anchor
  regresses to and takes the intention of its own best-IoU GT;
- sigmoid focal loss (alpha 0.25, gamma 2) over non-ignored anchors and
  smooth-L1 (beta 1/9) over positive box deltas, each / max(1, num_pos);
- intention CE over positive anchors with the stochastic drop of the
  dominant classes (kept with probability 1 - 0.85); its uniforms are
  passed in;
- total = cls + box + 0.5 intent; a non-finite total zeroes the dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .boxes.codec import encode_boxes
from .boxes.iou import axis_aligned_iou


def assign_targets(anchors, gt_boxes, gt_intentions, gt_valid, cfg):
    """anchors f32[N, 5]; gt_boxes f32[B, G, 5]; gt_intentions int[B, G];
    gt_valid bool[B, G] -> (cls i32[B, N] in {-1, 0, 1}, box f32[B, N, 6],
    intent i32[B, N], class id or -1)."""
    if cfg.use_rotated_iou:
        raise NotImplementedError("rotated-IoU assignment is not ported")
    valid = gt_valid.bool()
    iou = axis_aligned_iou(anchors[None, :, :4], gt_boxes[..., :4])  # [B, N, G]
    iou = torch.where(valid[:, None, :], iou, -1.0)
    max_iou, best_gt = iou.max(-1).values, iou.argmax(-1)
    num_gt = valid.sum(-1, keepdim=True)  # [B, 1]

    cls = torch.full_like(best_gt, -1, dtype=torch.int32)
    cls = torch.where(max_iou < cfg.neg_iou_threshold, 0, cls)
    pos_by_thresh = max_iou >= cfg.iou_threshold
    cls = torch.where(pos_by_thresh, 1, cls)

    best_anchor = torch.where(valid[:, None, :], iou, float("-inf")).argmax(1)  # [B, G]
    force_iou = torch.gather(iou, 1, best_anchor[:, None, :])[:, 0]
    force_ok = valid & (force_iou >= cfg.neg_iou_threshold)
    forced = torch.zeros_like(best_gt, dtype=torch.int32).scatter_reduce_(
        1, best_anchor, force_ok.int(), "amax") > 0
    cls = torch.where(forced & ~pos_by_thresh, 1, cls)

    pos = (cls == 1) & (num_gt > 0)
    cls = torch.where(num_gt == 0, 0, cls)
    boxes = torch.gather(gt_boxes, 1, best_gt[..., None].expand(-1, -1, 5))
    box_t = torch.where(pos[..., None], encode_boxes(boxes, anchors[None]), 0.0)
    intent = torch.gather(gt_intentions.long(), 1, best_gt)
    return cls, box_t, torch.where(pos, intent, -1).int()


def sigmoid_focal_loss(logits, targets, alpha: float, gamma: float):
    """Elementwise sigmoid focal loss (torchvision semantics)."""
    p = torch.sigmoid(logits)
    ce = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


def smooth_l1(diff, beta: float):
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def softmax_ce(logits, labels):
    """Per-example CE; labels < 0 are read as 0 (callers mask them)."""
    logp = F.log_softmax(logits, -1)
    return -torch.gather(logp, -1, labels.long().clamp(min=0)[..., None])[..., 0]


def detection_intention_loss(cls_logits, box_preds, intent_logits, anchors, gt_boxes,
                             gt_intentions, gt_valid, cfg, uniforms) -> dict:
    """cls [B, N, 1], box [B, N, 6], intent [B, N, C] logits; anchors [N, 5];
    GT padded to G. ``uniforms`` f32[B*N] are the dominant-class drop's
    draws. Returns {"loss",
    "cls_loss", "box_loss", "intent_loss", "num_pos_anchors"} as f32
    scalars on the logits' device."""
    cls_t, box_t, intent_t = assign_targets(anchors, gt_boxes, gt_intentions, gt_valid, cfg)
    cls_t, box_t, intent_t = cls_t.reshape(-1), box_t.reshape(-1, 6), intent_t.reshape(-1)
    cls_l = cls_logits.reshape(-1).float()
    box_p = box_preds.reshape(-1, 6).float()
    intent_l = intent_logits.reshape(-1, intent_logits.shape[-1]).float()

    valid = cls_t >= 0
    pos = cls_t == 1
    num_pos = pos.float().sum()
    denom = num_pos.clamp(min=1.0)

    focal = sigmoid_focal_loss(cls_l, cls_t.float(), cfg.focal_loss_alpha,
                               cfg.focal_loss_gamma)
    cls_loss = torch.where(valid, focal, 0.0).sum() / denom
    box_loss = torch.where(pos[:, None], smooth_l1(box_p - box_t, cfg.smooth_l1_beta),
                           0.0).sum() / denom

    ce = softmax_ce(intent_l, intent_t)
    mask = pos.float()
    if cfg.apply_intention_downsampling:
        dominant = torch.zeros_like(pos)
        for d in cfg.dominant_intentions:
            dominant = dominant | (intent_t == d)
        keep = torch.where(dominant, uniforms < 1.0 - cfg.intention_downsample_ratio, True)
        mask = keep.float() * mask
    intent_loss = (ce * mask).sum() / mask.sum().clamp(min=1.0)
    intent_loss = torch.where(num_pos > 0, intent_loss, 0.0)
    box_loss = torch.where(num_pos > 0, box_loss, 0.0)

    total = cfg.cls_weight * cls_loss + cfg.box_weight * box_loss \
        + cfg.intent_weight * intent_loss
    bad = ~torch.isfinite(total)

    def guard(v):
        return torch.where(bad, torch.zeros_like(v), v)

    return {"loss": guard(total), "cls_loss": guard(cls_loss), "box_loss": guard(box_loss),
            "intent_loss": guard(intent_loss), "num_pos_anchors": num_pos}
