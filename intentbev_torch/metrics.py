"""Detection AP and intention metrics on tensors, on the detections' device.

Counterpart of ``intentbev/metrics.py`` (the JAX functions take one sample
under ``vmap``; these take any leading batch dimensions). The definitions
are the reference's:

- AP is per-sample PASCAL-VOC AP averaged over samples, not COCO's global
  ranking;
- edge rules: no predictions -> AP 1.0 if no GT else 0.0; no GT (with
  predictions) -> 0.0;
- matching is greedy in descending score order; each prediction takes only
  its own best-IoU GT, and a GT is matched once;
- intention accuracy / macro-F1 / weighted-F1 / per-class F1 count only
  the TP detections matched at IoU >= 0.5.

``calculate_ap_np`` is the host form (the reference's utils.py:564-575),
the test oracle of the tensor form.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .boxes.iou import axis_aligned_iou, rotated_iou


def calculate_ap_np(recall: np.ndarray, precision: np.ndarray) -> float:
    """VOC-style AP from recall/precision step arrays (utils.py:564-575)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def _voc_ap_fixed(recall: torch.Tensor, precision: torch.Tensor) -> torch.Tensor:
    """VOC AP over fixed-size recall / precision [..., P] (invalid tail
    entries carry the final recall and precision 0: no contribution)."""
    zeros = torch.zeros_like(recall[..., :1])
    mrec = torch.cat([zeros, recall, torch.ones_like(zeros)], -1)
    mpre = torch.cat([zeros, precision, zeros], -1)
    mpre = torch.cummax(mpre.flip(-1), -1).values.flip(-1)  # envelope from the right
    return ((mrec[..., 1:] - mrec[..., :-1]) * mpre[..., 1:]).sum(-1)


class SampleAP(NamedTuple):
    ap: torch.Tensor          # f32[..., num_iou_thresholds]
    tp_flags: torch.Tensor    # bool[..., num_iou_thresholds, max_pred]
    matched_gt: torch.Tensor  # i64[..., num_iou_thresholds, max_pred] (-1 = none)


def _iou(pred_boxes, gt_boxes, use_rotated_iou: bool):
    if use_rotated_iou:
        return rotated_iou(pred_boxes, gt_boxes)
    return axis_aligned_iou(pred_boxes[..., :4], gt_boxes[..., :4])


def greedy_match(iou_matrix: torch.Tensor, pred_valid: torch.Tensor, gt_valid: torch.Tensor,
                 iou_threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy score-order matching over [..., P, G] IoUs (predictions sorted
    by score) -> (tp bool[..., P], matched GT index [..., P], -1 for non-TP).

    Each prediction's candidate is its argmax GT, fixed before matching; the
    prediction that takes GT g is the lowest-index eligible one whose argmax
    is g (a scatter-min over prediction indices), as the JAX closed form."""
    num_pred, num_gt = iou_matrix.shape[-2:]
    if num_gt == 0:
        return (torch.zeros(iou_matrix.shape[:-1], dtype=torch.bool, device=iou_matrix.device),
                torch.full(iou_matrix.shape[:-1], -1, dtype=torch.int64,
                           device=iou_matrix.device))
    iou_masked = torch.where(gt_valid[..., None, :], iou_matrix, -1.0)
    idx = torch.arange(num_pred, device=iou_matrix.device).expand(iou_matrix.shape[:-1])
    best_gt = iou_masked.argmax(-1)  # the first of equal maxima, as jnp.argmax
    best_iou = torch.gather(iou_masked, -1, best_gt[..., None])[..., 0]
    eligible = pred_valid & (best_iou >= iou_threshold)
    first_idx = torch.full(iou_matrix.shape[:-2] + (num_gt,), num_pred, dtype=torch.int64,
                           device=iou_matrix.device).scatter_reduce(
        -1, best_gt, torch.where(eligible, idx, num_pred), "amin")
    tp = eligible & (torch.gather(first_idx, -1, best_gt) == idx)
    return tp, torch.where(tp, best_gt, -1)


def sample_average_precision(pred_boxes: torch.Tensor, pred_valid: torch.Tensor,
                             gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                             iou_thresholds: tuple[float, ...] = (0.5, 0.6, 0.7, 0.8, 0.9),
                             use_rotated_iou: bool = False) -> SampleAP:
    """Per-sample AP at several IoU thresholds. ``pred_boxes`` f32[..., P, 5]
    sorted by descending score with ``pred_valid``; ``gt_boxes`` f32[..., G,
    5] padded, with ``gt_valid``."""
    num_pred = pred_boxes.shape[-2]
    dev = pred_boxes.device
    num_gt_valid = gt_valid.sum(-1, dtype=torch.int32)
    num_pred_valid = pred_valid.sum(-1, dtype=torch.int32)
    iou = _iou(pred_boxes, gt_boxes, use_rotated_iou)
    rank = torch.arange(1, num_pred + 1, dtype=torch.float32, device=dev)

    aps, tps, matches = [], [], []
    for thresh in iou_thresholds:
        tp, match_idx = greedy_match(iou, pred_valid, gt_valid, float(thresh))
        tp = tp & pred_valid
        tp_cum = torch.cumsum(tp.float(), -1)
        recall = tp_cum / (num_gt_valid.float()[..., None] + 1e-9)
        precision = tp_cum / (rank + 1e-9)
        last = (num_pred_valid.long() - 1).clamp(min=0)[..., None]
        final_recall = torch.where(num_pred_valid[..., None] > 0,
                                   torch.gather(recall, -1, last), 0.0)
        recall = torch.where(pred_valid, recall, final_recall)
        precision = torch.where(pred_valid, precision, 0.0)
        ap = _voc_ap_fixed(recall, precision)
        no_gt = num_gt_valid == 0
        ap = torch.where(num_pred_valid == 0, no_gt.float(), torch.where(no_gt, 0.0, ap))
        aps.append(ap)
        tps.append(tp)
        matches.append(match_idx)
    return SampleAP(torch.stack(aps, -1), torch.stack(tps, -2), torch.stack(matches, -2))


def match_intentions(pred_boxes, pred_valid, pred_intentions, gt_boxes, gt_valid, gt_intentions,
                     iou_threshold: float = 0.5, use_rotated_iou: bool = False):
    """TP-matched (pred_intent i32[..., P], gt_intent i32[..., P] (-1 off a
    pair), pair_valid bool[..., P]) for the intention metrics."""
    tp, match_idx = greedy_match(_iou(pred_boxes, gt_boxes, use_rotated_iou), pred_valid,
                                 gt_valid, iou_threshold)
    pair_valid = tp & pred_valid
    gt_int = torch.gather(gt_intentions.long(), -1, match_idx.clamp(min=0))
    return (pred_intentions.to(torch.int32), torch.where(pair_valid, gt_int, -1).to(torch.int32),
            pair_valid)


class IntentionConfusion(NamedTuple):
    """Streaming confusion-matrix accumulator (rows GT class, columns the
    predicted class); updates are pure adds."""

    matrix: torch.Tensor  # i64[C, C]

    @staticmethod
    def zeros(num_classes: int, device=None) -> "IntentionConfusion":
        return IntentionConfusion(torch.zeros((num_classes, num_classes), dtype=torch.int64,
                                              device=device))

    def update(self, pred_intent, gt_intent, pair_valid) -> "IntentionConfusion":
        c = self.matrix.shape[0]
        flat = torch.where(pair_valid, gt_intent.long() * c + pred_intent.long(), c * c)
        counts = torch.bincount(flat.reshape(-1), minlength=c * c + 1)
        return IntentionConfusion(self.matrix + counts[: c * c].reshape(c, c))


def confusion_to_metrics(matrix: torch.Tensor) -> dict:
    """accuracy / macro-F1 / weighted-F1 / per-class F1 / support from a
    confusion matrix (sklearn's definitions with ``zero_division=0``)."""
    m = matrix.float()
    total = m.sum()
    safe_total = torch.where(total == 0, 1.0, total)
    accuracy = torch.where(total > 0, torch.trace(m) / safe_total, 0.0)
    tp = torch.diagonal(m)
    fp = m.sum(0) - tp
    fn = m.sum(1) - tp
    denom = 2 * tp + fp + fn
    f1 = torch.where(denom > 0, 2 * tp / torch.where(denom == 0, 1.0, denom), 0.0)
    support = m.sum(1)
    weighted = torch.where(total > 0, (f1 * support).sum() / safe_total, 0.0)
    return {"accuracy": accuracy, "macro_f1": f1.mean(), "weighted_f1": weighted,
            "per_class_f1": f1, "support": support}
