"""Serving on one device."""

from .inference import StreamingInferencer

__all__ = ["StreamingInferencer"]
