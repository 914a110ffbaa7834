"""Hand-written Hopper kernels, each with its plain PyTorch version."""

from ._build import launches, reset_launch_counts
from .flash_attention import (flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
                              flash_attention_fwd, flash_attention_fwd_plain)
from .flash_packed import (flash_attention_fn, flash_attention_packed,
                           flash_attention_packed_bwd, flash_attention_packed_bwd_plain,
                           flash_attention_packed_plain, reference_attention)
from .fused_ln_dense import (fused_ln_dense, fused_ln_dense_bwd, fused_ln_dense_bwd_plain,
                             fused_ln_dense_fn, fused_ln_dense_plain)
from .fused_ln_mlp import (fused_ln_mlp, fused_ln_mlp_bwd, fused_ln_mlp_bwd_plain,
                           fused_ln_mlp_fn, fused_ln_mlp_plain, fused_ln_mlp_train,
                           fused_ln_mlp_train_plain)
from .fused_mlp import (fused_mlp, fused_mlp_bwd, fused_mlp_bwd_plain, fused_mlp_fn,
                        fused_mlp_plain, fused_mlp_train)
from .fused_mlp_int8 import fused_mlp_int8, fused_mlp_int8_plain
from .int8 import int8_dense, quantize_cols, quantize_linear, quantize_rows
from .layernorm import (layernorm, layernorm_bwd, layernorm_bwd_plain, layernorm_fn,
                        layernorm_plain, layernorm_train, layernorm_train_plain)
from .patch_embed import patch_embed, patch_embed_plain
from .voxel_embed import (VoxelChunks, VoxelHits, voxel_embed_tokens,
                          voxel_embed_tokens_plain, voxel_fill_bev, voxel_fill_bev_plain,
                          voxel_hits, voxel_hits_plain)

__all__ = [
    "launches", "reset_launch_counts",
    "flash_attention_packed", "flash_attention_packed_plain",
    "flash_attention_packed_bwd", "flash_attention_packed_bwd_plain", "flash_attention_fn",
    "reference_attention", "flash_attention", "flash_attention_fwd",
    "flash_attention_fwd_plain", "flash_attention_bwd", "flash_attention_bwd_plain",
    "fused_ln_mlp", "fused_ln_mlp_plain", "fused_ln_mlp_train", "fused_ln_mlp_train_plain",
    "fused_ln_mlp_bwd", "fused_ln_mlp_bwd_plain", "fused_ln_mlp_fn",
    "layernorm", "layernorm_plain", "layernorm_train", "layernorm_train_plain",
    "layernorm_bwd", "layernorm_bwd_plain", "layernorm_fn",
    "fused_mlp", "fused_mlp_plain", "fused_mlp_train", "fused_mlp_bwd", "fused_mlp_bwd_plain",
    "fused_mlp_fn", "fused_mlp_int8", "fused_mlp_int8_plain",
    "fused_ln_dense", "fused_ln_dense_plain", "fused_ln_dense_bwd", "fused_ln_dense_bwd_plain",
    "fused_ln_dense_fn", "patch_embed", "patch_embed_plain",
    "int8_dense", "quantize_cols", "quantize_linear", "quantize_rows",
    "VoxelChunks", "VoxelHits", "voxel_embed_tokens", "voxel_embed_tokens_plain",
    "voxel_hits", "voxel_hits_plain", "voxel_fill_bev", "voxel_fill_bev_plain",
]
