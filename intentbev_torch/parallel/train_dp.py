"""The sharded training step over torch.distributed: data parallel over the
mesh's data axis, tensor parallel over its model axis.

Counterpart of ``intentbev/parallel/train_dp.py``. JAX compiles one
program over the mesh: the batch sharded over 'data', the parameters
replicated over 'data' and split over 'model' by its sharding rules, the
collectives inserted by GSPMD. Here each rank runs the one-device step
(``train.make_train_step``) on its contiguous share of the global batch,
with the mesh's data axis as its group:

- every random draw (the patch dropout, the intention drop's uniforms, the
  drop-path gates) is made for the global batch and cut to the rank's
  index on the data axis, so the same generator state (or the same
  ``StepDraws``) gives the same step at any mesh shape, and the ranks of
  one data index (the model axis) draw the same numbers;
- BatchNorm and the loss read the global batch's statistics and
  denominators, so each rank's loss is its share of the global loss;
- the gradients are summed over the data axis before AdamW (no averaging:
  the shares already carry the global denominators);
- the intention class weights are kept, as JAX keeps them.

Over a model axis wider than 1 (``MeshConfig.model_parallel``; the ViT's
blocks, :func:`mesh.check_model_parallel`) each rank holds its shards of
``attn.qkv`` / ``attn.proj`` and ``mlp.fc1`` / ``mlp.fc2`` in the layout of
``parallel.sharding`` (the qkv rows of whole heads, unevenly split where the
axis does not divide the head count), its AdamW moments of
those shards, and the rest whole; the blocks' collectives
(``utils.distributed.copy_to_model`` / ``reduce_from_model``, in
``models/vit.py``) give every replicated parameter the same gradient on
each rank of the model axis (``fuse_ln_dense``'s partial norm1 gradients
are summed by ``copy_to_model``'s backward), so no gradient is summed over
the model axis here. The CNN, which JAX's rules do not shard, is a replica
on each rank of the model axis. :func:`gather_train_state` joins the
shards into the full tensors of a one-process checkpoint.
"""

from __future__ import annotations

import torch

from ..utils.distributed import all_gather_over, broadcast_from_first
from .mesh import check_model_parallel, data_group, model_group
from .sharding import gather_tensor, model_dim, shard_tensor, split_sizes


@torch.no_grad()
def shard_train_state(model, optimizer, mesh, cfg) -> None:
    """Make every rank's parameters, buffers and optimizer state rank 0's
    of the data axis (a broadcast over it, in place), from the full
    tensors; then, over a model axis wider than 1, keep this rank's shards
    of the parameters and of their AdamW moments and put the model on the
    axis (``IntentNetViT.set_model_group``)."""
    check_model_parallel(cfg)
    state = [v for st in optimizer.state.values() for v in st.values()
             if isinstance(v, torch.Tensor)]
    broadcast_from_first([t.data for t in model.parameters()] + list(model.buffers()) + state,
                         data_group(mesh, cfg.mesh))
    mg = model_group(mesh, cfg.mesh)
    if mg.size == 1 or not hasattr(model, "set_model_group"):
        return
    heads, axis = cfg.vit.num_heads, cfg.mesh.model_axis
    for name, p in model.named_parameters():
        moments = {k: v for k, v in optimizer.state.get(p, {}).items()  # not the step count
                   if isinstance(v, torch.Tensor) and v.shape == p.shape}
        p.data = shard_tensor(name, p.data, mg.rank, mg.size, heads, axis)
        for k, v in moments.items():
            optimizer.state[p][k] = shard_tensor(name, v, mg.rank, mg.size, heads, axis)
    model.set_model_group(mg)


def full_tensor(name: str, t: torch.Tensor, group, cfg) -> torch.Tensor:
    """The full tensor of this rank's shard ``t`` of parameter ``name`` (or
    of a tensor shaped like it: its gradient, an AdamW moment), gathered over
    the model axis ``group``, so every rank of it must call; ``t`` itself
    where the parameter is replicated. The ranks' shards of the attention
    differ in size where the axis does not divide the head count: each is
    padded to the largest for the gather (which takes one shape) and cut
    back after it."""
    axis = cfg.mesh.model_axis
    dim = model_dim(name, t.dim(), axis)
    if group.size == 1 or dim is None:
        return t
    v, kind = cfg.vit, name.split(".")
    size = (3 * v.embed_dim if "qkv" in kind else v.embed_dim if "proj" in kind
            else int(v.embed_dim * v.mlp_ratio))
    sizes = split_sizes(name, size, group.size, v.num_heads)
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, max(sizes) - t.shape[dim]]
    parts = all_gather_over(torch.nn.functional.pad(t, pad), group)
    return gather_tensor(name, [p.narrow(dim, 0, n) for p, n in zip(parts, sizes)],
                         v.num_heads, axis)


def gather_train_state(model, optimizer, mesh, cfg) -> tuple[dict, dict]:
    """The full (one-process) model and optimizer state dicts from this
    rank's shards: each sharded tensor all-gathered over the model axis,
    so every rank of the axis must call it. Over a model axis of 1 the
    rank's own state dicts."""
    msd, osd = model.state_dict(), optimizer.state_dict()
    mg = model_group(mesh, cfg.mesh)
    if mg.size == 1 or getattr(model, "model_group", None) is None:
        return msd, osd
    msd = {k: full_tensor(k, v, mg, cfg) for k, v in msd.items()}
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in optimizer.param_groups for p in g["params"]]
    osd["state"] = {i: {k: (full_tensor(order[i], v, mg, cfg) if k in ("exp_avg", "exp_avg_sq")
                            else v) for k, v in st.items()}
                    for i, st in osd["state"].items()}
    return msd, osd


def make_sharded_train_step(model, cfg, anchors, optimizer, mesh, intention_weights=None):
    """-> ``step(batch, generator=None, draws=None) -> metrics``, the
    contract of ``train.make_train_step``, where ``batch`` is this rank's
    local batch (its contiguous share of the global batch, on its device,
    the same on each rank of the model axis), ``draws`` the global
    batch's, and the metrics the global batch's. ``intention_weights``: the
    loss's class weights, as the one-device step takes them. Over a model
    axis wider than 1 the model holds this rank's shards and the model axis
    (:func:`shard_train_state` puts them there)."""
    from ..train import make_train_step

    return make_train_step(model, cfg, anchors, optimizer, intention_weights,
                           group=data_group(mesh, cfg.mesh))
