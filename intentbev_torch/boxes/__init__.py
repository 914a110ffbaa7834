"""Anchors, box decoding, IoU and NMS (torch)."""

from .anchors import generate_anchors
from .codec import decode_boxes, encode_boxes
from .iou import axis_aligned_iou, box_corners, rotated_iou
from .nms import Detections, batched_postprocess, greedy_nms_mask, postprocess_detections

__all__ = [
    "generate_anchors", "decode_boxes", "encode_boxes", "axis_aligned_iou", "box_corners", "rotated_iou", "Detections",
    "batched_postprocess", "greedy_nms_mask", "postprocess_detections",
]
