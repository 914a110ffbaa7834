"""Hand-written Hopper kernels, each with its plain PyTorch version."""

from ._build import launches, reset_launch_counts
from .flash_packed import (flash_attention_fn, flash_attention_packed,
                           flash_attention_packed_bwd, flash_attention_packed_bwd_plain,
                           flash_attention_packed_plain)
from .fused_ln_mlp import (fused_ln_mlp, fused_ln_mlp_bwd, fused_ln_mlp_bwd_plain,
                           fused_ln_mlp_fn, fused_ln_mlp_plain, fused_ln_mlp_train,
                           fused_ln_mlp_train_plain)
from .layernorm import (layernorm, layernorm_bwd, layernorm_bwd_plain, layernorm_fn,
                        layernorm_plain, layernorm_train, layernorm_train_plain)
from .voxel_embed import (VoxelChunks, voxel_embed_tokens, voxel_embed_tokens_plain,
                          voxel_fill_bev, voxel_fill_bev_plain)

__all__ = [
    "launches", "reset_launch_counts",
    "flash_attention_packed", "flash_attention_packed_plain",
    "flash_attention_packed_bwd", "flash_attention_packed_bwd_plain", "flash_attention_fn",
    "fused_ln_mlp", "fused_ln_mlp_plain", "fused_ln_mlp_train", "fused_ln_mlp_train_plain",
    "fused_ln_mlp_bwd", "fused_ln_mlp_bwd_plain", "fused_ln_mlp_fn",
    "layernorm", "layernorm_plain", "layernorm_train", "layernorm_train_plain",
    "layernorm_bwd", "layernorm_bwd_plain", "layernorm_fn",
    "VoxelChunks", "voxel_embed_tokens", "voxel_embed_tokens_plain",
    "voxel_fill_bev", "voxel_fill_bev_plain",
]
