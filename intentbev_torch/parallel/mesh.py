"""Process groups and the (data, model) device mesh over torch.distributed.

Counterpart of ``intentbev/parallel/mesh.py``. One process drives one
device (torchrun's model: a rank per GPU, NCCL between them; gloo between
CPU processes); the mesh lays the world's ranks out as (data, model) in
rank order, so the data axis splits each global batch into the ranks'
local batches in rank order, as JAX's contiguous batch sharding does.

- :func:`initialize_distributed` joins the process group torchrun's
  environment describes (an entry point's ``main()`` passes it), or does
  nothing in a plain process;
- :func:`create_mesh` builds the ``DeviceMesh`` named ``(data_axis,
  model_axis)``, with the JAX function's checks;
- :func:`shard_sequences_for_process` is the JAX function: which sequences
  a rank loads;
- :func:`data_group` is the mesh's data axis as a ``utils.distributed.
  DataGroup``, which the train step, the loss and the models read;
  :func:`model_group` its model axis as a ``ModelGroup``, over which the
  ViT blocks split their heads and hidden units in training
  (:func:`check_model_parallel` admits the layouts JAX's sharding takes);
- :func:`local_batch_slice` puts a rank's local batch on its device.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..configs import MeshConfig
from ..utils.distributed import DataGroup, ModelGroup

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(env, backend: str | None = None,
                           timeout: timedelta = timedelta(minutes=10)) -> bool:
    """Join the process group a ``torchrun`` launch describes in ``env``
    (the environment, which an entry point's ``main()`` passes: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``): NCCL
    with the local rank's GPU as the current device where CUDA is present,
    gloo on the CPU (``backend`` overrides). Returns whether a group is up.
    Without that environment (a plain process) it does nothing, as the JAX
    function does in a single-process launch, and an already initialized
    group is kept. Any other failure raises."""
    if dist.is_initialized():
        return True
    if not all(k in env for k in TORCHRUN_ENV):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    device_id = None
    if backend == "nccl":
        device_id = torch.device("cuda", int(env["LOCAL_RANK"]))
        torch.cuda.set_device(device_id)
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                            rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
                            timeout=timeout, device_id=device_id)
    return True


def mesh_shape(cfg: MeshConfig, world_size: int) -> tuple[int, int]:
    """(data, model) sizes for ``world_size`` ranks, with the JAX
    ``create_mesh`` errors."""
    n = world_size
    mp = max(1, cfg.model_parallel)
    if n % mp != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={mp}")
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} devices")
    return dp, mp


def create_mesh(cfg: MeshConfig, device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (data, model) over the world's ranks in
    rank order, dimensions named ``(cfg.data_axis, cfg.model_axis)``. Needs
    an initialized process group (:func:`initialize_distributed`)."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: launch with torchrun "
                           "(initialize_distributed) or call init_process_group first")
    from torch.distributed.device_mesh import DeviceMesh

    dp, mp = mesh_shape(cfg, dist.get_world_size())
    ranks = torch.arange(dp * mp).reshape(dp, mp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=(cfg.data_axis, cfg.model_axis))


def data_group(mesh, cfg: MeshConfig) -> DataGroup:
    """The mesh's data axis: its process group, this rank's index on it and
    its size."""
    return DataGroup(mesh.get_group(cfg.data_axis), mesh.get_local_rank(cfg.data_axis),
                     mesh.size(mesh.mesh_dim_names.index(cfg.data_axis)))


def model_group(mesh, cfg: MeshConfig) -> ModelGroup:
    """The mesh's model axis: its process group, this rank's index on it
    and its size."""
    return ModelGroup(mesh.get_group(cfg.model_axis), mesh.get_local_rank(cfg.model_axis),
                      mesh.size(mesh.mesh_dim_names.index(cfg.model_axis)))


def check_model_parallel(cfg) -> None:
    """Raise ``ValueError`` where JAX's sharded step refuses the layout: the
    model axis must divide each dimension its rules split, the ViT's
    ``embed_dim`` (``attn.qkv``'s output, ``attn.proj``'s input) and its MLP
    hidden width (``cfg``: an ``ExperimentConfig``; the CNN, which nothing
    shards, takes any). The head count does not matter: a rank here holds
    a run of whole heads, one more on the first ``num_heads % mp`` ranks and
    none where the axis is wider than the head count (``sharding``)."""
    mp = max(1, cfg.mesh.model_parallel)
    if mp == 1 or cfg.model_family != "vit":
        return
    v = cfg.vit
    hidden = int(v.embed_dim * v.mlp_ratio)
    if v.embed_dim % mp or hidden % mp:
        raise ValueError(
            f"model_parallel={mp} must divide the ViT's embed_dim={v.embed_dim} and its MLP "
            f"hidden width {hidden}, the dimensions the model axis splits (as JAX's sharding "
            f"requires)")


def shard_sequences_for_process(sequences, process_index: int, process_count: int,
                                global_batch_size: int) -> tuple[list, int]:
    """Which sequences this process loads: a round-robin share
    (``sequences[p::n]``) cut to a common length, so every process runs the
    same number of steps (a straggler's extra step would deadlock the
    collectives). Returns (local sequences, local batch size)."""
    if process_count < 1:
        raise ValueError(f"process_count must be >= 1, got {process_count}")
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} out of range [0, {process_count})")
    if global_batch_size % process_count != 0:
        raise ValueError(
            f"batch_size {global_batch_size} not divisible by process_count {process_count}")
    per_proc = len(sequences) // process_count
    local = list(sequences[process_index::process_count])[:per_proc]
    return local, global_batch_size // process_count


def local_batch_slice(local_batch, device) -> dict:
    """A rank's local batch (a ``data.pipeline`` batch, a dict of numpy
    arrays or tensors) as tensors on its device. Under P('data') the global
    batch is the ranks' local batches in rank order: no collective moves a
    sample."""
    from ..data.pipeline import batch_to_device

    if hasattr(local_batch, "_fields"):
        return batch_to_device(local_batch, device)
    return {k: (v.to(device) if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v)).to(device))
            for k, v in local_batch.items()}
