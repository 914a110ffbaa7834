"""Models of the port: IntentNetViT and IntentNetCNN."""

from __future__ import annotations

import torch

from .cnn import CNNBackbone, IntentNetCNN
from .vit import IntentNetViT


def build_model(cfg, *, dtype: torch.dtype = torch.float32,
                param_dtype: torch.dtype | None = None, gelu: str = "erf",
                plain_ops: bool = False, bwd_fused: bool = True, bwd_kv_chunk: int = 0):
    """The configured model family (``cfg.model_family``): ``IntentNetViT(cfg.vit,
    cfg.heads)`` or ``IntentNetCNN(cfg.cnn, cfg.heads)``. ``dtype`` is the
    compute dtype, ``param_dtype`` that of the weights (f32 master weights
    in training); ``gelu`` is the ViT block MLP's (the CNN has none);
    ``bwd_fused`` / ``bwd_kv_chunk`` pick the ViT's flash backward, and its
    blocks are recomputed in training where ``cfg.train.remat_vit_blocks``
    is set, as the JAX ``build_model`` sets ``remat``."""
    if cfg.model_family == "cnn":
        return IntentNetCNN(cfg.cnn, cfg.heads, dtype=dtype, plain_ops=plain_ops,
                            param_dtype=param_dtype)
    if cfg.model_family == "vit":
        return IntentNetViT(cfg.vit, cfg.heads, dtype=dtype, gelu=gelu, plain_ops=plain_ops,
                            param_dtype=param_dtype, bwd_fused=bwd_fused,
                            bwd_kv_chunk=bwd_kv_chunk, remat=cfg.train.remat_vit_blocks)
    raise ValueError(f"unknown model family {cfg.model_family!r}")


def init_params(cfg, seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded random f32 parameters (CPU) of the configured model family, as
    a state dict."""
    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.state_dict()


__all__ = ["CNNBackbone", "IntentNetCNN", "IntentNetViT", "build_model", "init_params"]
