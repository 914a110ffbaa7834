"""Sharding rules: the batch over the data axis, the ViT's attention and MLP
weights over the model axis.

Counterpart of ``intentbev/parallel/sharding.py``, over the port's
parameter names (``nn.Module`` names; ``weights.from_flax`` maps the flax
paths to them) and its [out, in] Linear weights:

- ``attn.qkv`` and ``mlp.fc1`` are sharded on their output (weight dim 0,
  the heads / hidden units; the bias with it);
- ``attn.proj`` and ``mlp.fc2`` on their input (weight dim 1; the bias
  replicated: the sum over the model axis follows the product);
- everything else (convs, norms, heads, adapters, embeddings) replicated.

A spec is a tuple with one entry per tensor dimension, the mesh axis name
that dimension is split over or None, as a JAX ``PartitionSpec`` reads;
``()`` is replicated. :func:`param_shardings`, :func:`batch_sharding` and
:func:`replicated` give DTensor placements on a (data, model) mesh, one per
mesh dimension, where JAX gives ``NamedSharding``s. Parameters are
replicated over the data axis always.

The tensor-parallel step (``parallel.train_dp``) holds its shards as plain
tensors in the layout :func:`shard_state_dict` cuts and
:func:`gather_state_dict` joins: whole heads of the attention, equal
contiguous slices of the MLP's hidden units. Rank r holds the contiguous run
of heads ``utils.distributed.head_share`` gives it (the first ``num_heads %
mp`` ranks one head more; none where the axis is wider than the head count):
the rows q[h], k[h] and v[h] of its heads of ``attn.qkv``'s [3D, D] weight
and [3D] bias (q | k | v, each head-major), so that its projection gives (q
| k | v) of its heads in the layout the attention entries take, and the
input columns of those heads of ``attn.proj``. (JAX's ``P(None, 'model')``
splits the (d, 3d) kernel into contiguous column blocks, the first of which
is all of q and part of k; GSPMD moves the columns where they are needed,
which a rank that computes on its own heads cannot. JAX takes any layout
whose model axis divides each split dimension, the head count aside:
``mesh.check_model_parallel`` admits the same.) Checkpoints hold the full
tensors, in the layout of one process.
"""

from __future__ import annotations

import torch

from ..configs import MeshConfig
from ..utils.distributed import head_share


def param_spec(name: str, ndim: int, model_axis: str = "model") -> tuple:
    """Tensor-parallel spec of the parameter ``name`` with ``ndim``
    dimensions (the JAX ``_param_spec`` rules on the port's layout)."""
    parts = name.split(".")
    if "attn" in parts or "mlp" in parts:
        if "qkv" in parts or "fc1" in parts:  # output-sharded: weight [out, in], bias [out]
            if ndim == 2:
                return (model_axis, None)
            if ndim == 1:
                return (model_axis,)
        if "proj" in parts or "fc2" in parts:  # input-sharded: weight [out, in]
            if ndim == 2:
                return (None, model_axis)
            return ()
    return ()


def _placements(spec: tuple, mesh) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(spec) if a == axis]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def replicated(mesh) -> tuple:
    """Placements of a tensor every rank holds whole."""
    return _placements((), mesh)


def batch_sharding(mesh, cfg: MeshConfig) -> tuple:
    """Placements of a batch tensor: the leading dimension split over the
    data axis."""
    return _placements((cfg.data_axis,), mesh)


def param_shardings(model, mesh, cfg: MeshConfig) -> dict[str, tuple]:
    """``{name: placements}`` for every parameter of ``model`` (the
    tensor-parallel rules over the model axis; replicated over data)."""
    return {name: _placements(param_spec(name, p.dim(), cfg.model_axis), mesh)
            for name, p in model.named_parameters()}


def model_dim(name: str, ndim: int, model_axis: str = "model") -> int | None:
    """The dimension of parameter ``name`` split over the model axis, or
    None where it is replicated."""
    spec = param_spec(name, ndim, model_axis)
    return spec.index(model_axis) if model_axis in spec else None


def split_sizes(name: str, size: int, mp: int, num_heads: int) -> list[int]:
    """The ranks' extents (in rank order) of the model-split dimension, of
    full extent ``size``, of parameter ``name``: whole heads of the
    attention's (``size / num_heads`` a head), equal slices of the MLP's."""
    if {"qkv", "proj"} & set(name.split(".")):
        return [head_share(num_heads, mp, r)[1] * (size // num_heads) for r in range(mp)]
    return [size // mp] * mp


def shard_tensor(name: str, t: torch.Tensor, rank: int, mp: int, num_heads: int,
                 model_axis: str = "model") -> torch.Tensor:
    """Rank ``rank``'s shard of the full tensor ``t`` (parameter ``name``,
    or its optimizer moment) over a model axis of ``mp`` ranks: a
    contiguous copy (``t`` itself where it is replicated)."""
    dim = model_dim(name, t.dim(), model_axis)
    if dim is None or mp == 1:
        return t
    if "qkv" in name.split("."):  # [3D, ...] rows as [3, H, D/H, ...]: its heads of each
        first, n = head_share(num_heads, mp, rank)
        heads = t.reshape(3, num_heads, t.shape[0] // (3 * num_heads), *t.shape[1:])
        return heads[:, first:first + n].reshape(-1, *t.shape[1:]).contiguous()
    sizes = split_sizes(name, t.shape[dim], mp, num_heads)
    return t.narrow(dim, sum(sizes[:rank]), sizes[rank]).contiguous()


def gather_tensor(name: str, parts: list, num_heads: int,
                  model_axis: str = "model") -> torch.Tensor:
    """The full tensor from the ranks' shards ``parts`` (in rank order):
    the inverse of :func:`shard_tensor`."""
    dim = model_dim(name, parts[0].dim(), model_axis)
    if dim is None or len(parts) == 1:
        return parts[0]
    if "qkv" in name.split("."):
        rows = sum(p.shape[0] for p in parts) // (3 * num_heads)  # the head dim
        split = [p.reshape(3, p.shape[0] // (3 * rows), rows, *p.shape[1:]) for p in parts]
        return torch.cat(split, 1).reshape(-1, *parts[0].shape[1:])
    return torch.cat(parts, dim)


def shard_state_dict(full: dict, rank: int, mp: int, cfg) -> dict:
    """Rank ``rank``'s state dict of a model axis of ``mp`` ranks from a
    full (one-process) state dict ``full`` (``cfg``: the
    ``ExperimentConfig``; the ViT's heads and the mesh's model axis name)."""
    return {k: shard_tensor(k, v, rank, mp, cfg.vit.num_heads, cfg.mesh.model_axis)
            for k, v in full.items()}


def gather_state_dict(shards: list, cfg) -> dict:
    """The full (one-process) state dict from the model axis's state dicts
    ``shards`` in rank order: the inverse of :func:`shard_state_dict`."""
    return {k: gather_tensor(k, [s[k] for s in shards], cfg.vit.num_heads,
                             cfg.mesh.model_axis)
            for k in shards[0]}
