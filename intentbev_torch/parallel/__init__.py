"""Serving and training over one device or a torch.distributed mesh."""

from .inference import VIT_SERVING_VARIANTS, StreamingInferencer, vit_serving_variant
from .mesh import create_mesh, initialize_distributed, local_batch_slice
from .sharding import batch_sharding, param_shardings, replicated
from .train_dp import gather_train_state, make_sharded_train_step, shard_train_state

__all__ = [
    "StreamingInferencer",
    "VIT_SERVING_VARIANTS",
    "vit_serving_variant",
    "create_mesh",
    "initialize_distributed",
    "local_batch_slice",
    "batch_sharding",
    "param_shardings",
    "replicated",
    "gather_train_state",
    "make_sharded_train_step",
    "shard_train_state",
]
