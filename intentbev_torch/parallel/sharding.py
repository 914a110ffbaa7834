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
"""

from __future__ import annotations

from ..configs import MeshConfig


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
