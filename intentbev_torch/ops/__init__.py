"""Hand-written Hopper kernels, each with its plain PyTorch version."""

from ._build import launches, reset_launch_counts
from .flash_packed import flash_attention_packed, flash_attention_packed_plain
from .fused_ln_mlp import fused_ln_mlp, fused_ln_mlp_plain
from .layernorm import layernorm, layernorm_plain
from .voxel_embed import VoxelChunks, voxel_embed_tokens, voxel_embed_tokens_plain

__all__ = [
    "launches", "reset_launch_counts",
    "flash_attention_packed", "flash_attention_packed_plain",
    "fused_ln_mlp", "fused_ln_mlp_plain",
    "layernorm", "layernorm_plain",
    "VoxelChunks", "voxel_embed_tokens", "voxel_embed_tokens_plain",
]
