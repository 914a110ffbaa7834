"""Heuristic intention labels (a copy of ``intentbev/labeling``)."""

from .heuristic import MapContext, label_log_annotations, label_track

__all__ = ["MapContext", "label_log_annotations", "label_track"]
