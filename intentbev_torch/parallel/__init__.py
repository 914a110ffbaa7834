"""Serving on one device."""

from .inference import VIT_SERVING_VARIANTS, StreamingInferencer, vit_serving_variant

__all__ = ["StreamingInferencer", "VIT_SERVING_VARIANTS", "vit_serving_variant"]
