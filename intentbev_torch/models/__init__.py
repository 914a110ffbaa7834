"""Models of the port (inference)."""

from .vit import IntentNetViT, init_params

__all__ = ["IntentNetViT", "init_params"]
