"""Evaluation CLI: detection mAP and intention metrics, on the device.

Counterpart of ``intentbev/evaluate.py`` on one device, with the
reference's eval semantics:

- the model rebuilt from the checkpoint's embedded config;
- per sample: sigmoid -> conf >= 0.1 -> decode against the anchors -> NMS
  at IoU 0.2 -> the argmax intention of the surviving anchors;
- detection mAP: per-sample VOC AP averaged over samples at IoU
  {0.5..0.9}, with the no-prediction / no-GT edge rules;
- intention accuracy / macro-F1 / weighted-F1 / per-class F1 over the TP
  detections matched at IoU >= 0.5;
- the GT-truncation, pre-NMS and detection cap audits (fixed shapes cap
  what the reference keeps uncapped).

The logits and the detections come from ``StreamingInferencer`` over the
points transport (the device voxelizer, then the serving structure and
its kernels). On CUDA that runs in bf16 with the erf GELU; on the CPU in
f32, the JAX package's eval dtype. Only the small accumulators (AP sums,
the confusion matrix, the audits' counts) cross to the host, at the end.

    python -m intentbev_torch.evaluate --ckpt_dir RUN --data_dir SPLIT [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple

import torch

from .configs import INTENTIONS_MAP_REV
from .metrics import (IntentionConfusion, confusion_to_metrics, match_intentions,
                      sample_average_precision)


class EvalAccum(NamedTuple):
    ap_sum: torch.Tensor            # f32[num_iou]
    num_samples: torch.Tensor       # i64
    confusion: torch.Tensor         # i64[C, C]
    pre_nms_overflow: torch.Tensor  # i64 samples with conf-pass > max_pre_nms
    det_overflow: torch.Tensor      # i64 samples with NMS-kept > max_detections


def make_eval_step(inferencer):
    """-> (``eval_step(batch, sample_valid, accum) -> (accum, detections)``,
    ``init_accum()``) for a ``StreamingInferencer``: ``batch`` holds
    points-transport tensors on its device (points, points_valid, map_bev,
    gt_boxes, gt_intentions, gt_valid), ``sample_valid`` bool[B] masks a
    padded tail."""
    cfg = inferencer.cfg
    ev = cfg.eval
    iou_thresholds = tuple(float(t) for t in ev.detection_iou_thresholds)
    num_classes = cfg.heads.num_intention_classes
    dev = inferencer.device

    @torch.inference_mode()
    def eval_step(batch: dict, sample_valid: torch.Tensor, accum: EvalAccum):
        det = inferencer.postprocess(*inferencer.logits_points(
            batch["points"], batch["points_valid"], batch["map_bev"]))
        res = sample_average_precision(det.boxes_xywha, det.valid, batch["gt_boxes"],
                                       batch["gt_valid"], iou_thresholds, ev.use_rotated_iou)
        p_int, g_int, pair_valid = match_intentions(
            det.boxes_xywha, det.valid, det.intentions, batch["gt_boxes"], batch["gt_valid"],
            batch["gt_intentions"], ev.iou_threshold_for_intention_match, ev.use_rotated_iou)
        conf = IntentionConfusion(accum.confusion).update(
            p_int, g_int, pair_valid & sample_valid[:, None])
        return EvalAccum(
            ap_sum=accum.ap_sum + torch.where(sample_valid[:, None], res.ap, 0.0).sum(0),
            num_samples=accum.num_samples + sample_valid.sum(),
            confusion=conf.matrix,
            pre_nms_overflow=accum.pre_nms_overflow
            + ((det.num_conf > ev.max_pre_nms) & sample_valid).sum(),
            det_overflow=accum.det_overflow
            + ((det.num_kept > ev.max_detections) & sample_valid).sum(),
        ), det

    def init_accum() -> EvalAccum:
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return EvalAccum(torch.zeros(len(iou_thresholds), dtype=torch.float32, device=dev),
                         zero, IntentionConfusion.zeros(num_classes, dev).matrix, zero, zero)

    return eval_step, init_accum


def evaluate(ckpt_dir: str, data_dir: str, cfg_override=None, num_workers: int = 4,
             max_batches: int | None = None, log_fn=print, step: int | None = None,
             device="cuda") -> dict:
    """Evaluate the latest checkpoint (or retained ``step``) of ``ckpt_dir``
    on the logs of ``data_dir``; returns the metrics and the audits' counts.
    ``device``: CUDA by default; ``"cpu"`` runs the plain versions in f32."""
    from .checkpoint import load_checkpoint
    from .data.argoverse import ArgoverseSampleLoader, ScenarioValidator, build_sequence_index
    from .data.pipeline import batch_iterator, batch_to_device, device_prefetch, pad_batch
    from .parallel.inference import StreamingInferencer
    from .train import resolve_device

    device = resolve_device(device)
    state, cfg = load_checkpoint(ckpt_dir, step=step)
    if cfg_override is not None:
        cfg = cfg_override
    inferencer = StreamingInferencer(cfg, state["model"], device, transport="points")
    del state
    eval_step, init_accum = make_eval_step(inferencer)

    scenarios = ScenarioValidator(data_dir).find_valid_scenarios()
    sequences = build_sequence_index(scenarios, cfg.grid.lidar_sweeps)
    if not sequences:
        raise ValueError(f"no sequences found under {data_dir}")
    log_fn(f"evaluating {len(sequences)} samples from {len(scenarios)} logs")

    loader = ArgoverseSampleLoader(cfg.grid, max_gt=cfg.loss.max_gt_boxes, verbose=False)
    accum = init_accum()
    t0 = time.time()
    it = batch_iterator(sequences, loader, cfg.eval.batch_size, num_workers=num_workers)

    def pad_and_put(batch):
        padded, sample_valid = pad_batch(batch, cfg.eval.batch_size)
        return batch_to_device(padded, device), torch.from_numpy(sample_valid).to(device)

    batches = device_prefetch(it, size=2, put=pad_and_put)
    try:
        for n, (bdict, sample_valid) in enumerate(batches, 1):
            accum, _ = eval_step(bdict, sample_valid, accum)
            if max_batches is not None and n >= max_batches:
                break
    finally:
        batches.close()

    num_samples = int(accum.num_samples)
    maps = (accum.ap_sum / max(num_samples, 1)).cpu().numpy()
    confusion = accum.confusion.cpu()
    pre_ovf, det_ovf = int(accum.pre_nms_overflow), int(accum.det_overflow)
    # counted by the loader over every sample it produced (the prefetch may
    # load past max_batches)
    gt_ovf = loader.gt_overflow_samples
    results = {"num_samples": num_samples, "pre_nms_overflow": pre_ovf,
               "det_overflow": det_ovf, "gt_overflow": gt_ovf}
    log_fn(f"GT-truncation audit: {gt_ovf} samples with more than "
           f"max_gt_boxes={cfg.loss.max_gt_boxes} annotated boxes"
           + (" (GT truncated: recall is understated vs the reference's "
              "uncapped GT — raise loss.max_gt_boxes)" if gt_ovf else " (never truncated)"))
    log_fn(f"truncation-cap audit: {pre_ovf} samples above max_pre_nms="
           f"{cfg.eval.max_pre_nms}, {det_ovf} above max_detections="
           f"{cfg.eval.max_detections}"
           + (" (caps bound: metrics deviate from the uncapped reference "
              "definition on those samples — raise eval.max_pre_nms/"
              "max_detections)" if pre_ovf or det_ovf else " (caps never bound)"))
    log_fn(f"--- Detection results ({num_samples} samples, {time.time() - t0:.1f}s) ---")
    for t, m in zip(cfg.eval.detection_iou_thresholds, maps):
        log_fn(f"mAP @ IoU={t:.1f}: {m:.4f}")
        results[f"mAP@{t:.1f}"] = float(m)

    im = confusion_to_metrics(confusion)
    n_matched = int(confusion.sum())
    log_fn(f"--- Intention results (on {n_matched} TP detections @ IoU>="
           f"{cfg.eval.iou_threshold_for_intention_match}) ---")
    if n_matched:
        log_fn(f"Overall Accuracy: {float(im['accuracy']):.4f}")
        log_fn(f"F1 (Macro):   {float(im['macro_f1']):.4f}")
        log_fn(f"F1 (Weighted): {float(im['weighted_f1']):.4f}")
        for i, f1 in enumerate(im["per_class_f1"].tolist()):
            log_fn(f"  {INTENTIONS_MAP_REV.get(i, i):<20}: {f1:.4f}")
        results.update(intention_accuracy=float(im["accuracy"]),
                       intention_macro_f1=float(im["macro_f1"]),
                       intention_weighted_f1=float(im["weighted_f1"]))
    else:
        log_fn("No TP detections to evaluate intention prediction.")
    return results


def main(argv=None):
    """``python -m intentbev_torch.evaluate --ckpt_dir ... --data_dir ...``."""
    from .checkpoint import load_config

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--rotated_iou", action="store_true",
                   help="exact rotated IoU for AP and intention matching "
                        "(reference EVAL_USE_ROTATED_IOU, eval_cnn.py:29)")
    p.add_argument("--step", type=int, default=None,
                   help="evaluate this retained checkpoint step (default: latest)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions in f32)")
    args = p.parse_args(argv)
    cfg_override = None
    if args.rotated_iou:
        cfg = load_config(args.ckpt_dir)
        cfg_override = dataclasses.replace(
            cfg, eval=dataclasses.replace(cfg.eval, use_rotated_iou=True))
    evaluate(args.ckpt_dir, args.data_dir, cfg_override=cfg_override,
             num_workers=args.num_workers, max_batches=args.max_batches, step=args.step,
             device=args.device)


if __name__ == "__main__":
    main()
