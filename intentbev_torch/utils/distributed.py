"""The groups a step, a loss or a model forward runs in, and their
collectives.

A :class:`DataGroup` names the ranks that split one global batch (the data
axis of ``parallel.mesh.create_mesh``) and this rank's place in it; a
:class:`ModelGroup` the ranks that split one model's attention heads and
MLP hidden units (the model axis). Under
P('data') the global batch is the ranks' local batches in rank order, so
rank r holds samples ``[r * b, (r + 1) * b)`` of a global batch of
``size * b``. The functions here are what the JAX package gets from GSPMD
over a sharded batch:

- :func:`all_reduce_sum`: a sum over the group (differentiable when
  ``grad=True``: its backward sums the cotangents over the group too, so
  the BatchNorm statistics of the global batch train as JAX's do);
- :func:`rank_slice` / :func:`global_rand`: draws made for the global batch
  and cut to the rank, so the same generator state gives the same step at
  any world size;
- :func:`broadcast_from_first`: the first rank's tensors on every rank
  (replicated parameters); :func:`all_gather_over` every rank's tensor
  (the shards of a checkpoint).

Tensor parallelism over the model axis (the Megatron layout: each rank
holds its heads of the attention and its hidden units of the MLP) joins
the ranks' partial results with three autograd functions, where GSPMD
inserts its collectives in the JAX package:

- :func:`copy_to_model`: identity forward, sum over the model group
  backward, at the input of a column-parallel product (qkv, fc1), whose
  input gradient is a partial on each rank;
- :func:`reduce_from_model`: sum forward, identity backward, after a
  row-parallel product (proj, fc2);
- :func:`first_on_model`: a replicated tensor on the model axis's first
  rank and zeros on the others, its gradient whole on every rank, for a
  term a kernel adds inside a row-parallel partial (the residual and fc2's
  bias of the MLP kernel), which the sum then counts once;
- :func:`zero_partial`: the partial of a rank that holds no share of a
  row-parallel product (no heads: more ranks than heads), zeros made from
  the inputs its peers' products read, which get zero gradients, so the
  ``copy_to_model`` sums of their backward stay paired on every rank.

:func:`head_share` is a rank's run of whole heads when the model axis does
not divide the head count: the first ``num_heads % size`` ranks take one
head more, as ``numpy.array_split`` splits.

Everything takes ``group=None`` to mean one process holding the whole
batch (or model): no collective runs. A model group of size 1 launches
nothing either.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class DataGroup(NamedTuple):
    group: object  # a torch.distributed ProcessGroup
    rank: int      # this process's index on the data axis
    size: int      # number of ranks on the data axis


class ModelGroup(DataGroup):
    """The model axis: its process group, this rank's index on it and its
    size (the fields of :class:`DataGroup`)."""


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group of x; its backward sums the cotangents over
    the group, since every rank's loss reads y."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def all_reduce_sum(t: torch.Tensor, group: DataGroup | None, grad: bool = False) -> torch.Tensor:
    """Sum of ``t`` over the group (``t`` itself without one). ``grad``: the
    autograd-aware collective; else ``t`` is detached and reduced in a
    copy."""
    if group is None:
        return t
    if grad:
        return _AllReduceSum.apply(t, group.group)
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.group)
    return out


def rank_slice(t: torch.Tensor, group: DataGroup | None, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous share of ``t`` along ``dim`` (a global-batch
    tensor whose ``dim`` holds ``size`` equal shares)."""
    if group is None:
        return t
    n = t.shape[dim]
    if n % group.size:
        raise ValueError(f"dimension {dim} of size {n} does not split over {group.size} ranks")
    share = n // group.size
    return t.narrow(dim, group.rank * share, share)


def global_rand(n_local: int, group: DataGroup | None, generator, device) -> torch.Tensor:
    """Uniform [0, 1) f32 draws of a global batch, ``n_local`` per rank, cut
    to this rank: every rank draws the same ``size * n_local`` numbers."""
    size = 1 if group is None else group.size
    u = torch.rand(n_local * size, generator=generator, device=device)
    return rank_slice(u, group)


@torch.no_grad()
def broadcast_from_first(tensors, group: DataGroup) -> None:
    """Overwrite each tensor in place with the group's first rank's, through
    the group's device where a tensor lies elsewhere (a CPU step count under
    NCCL)."""
    src = dist.get_global_rank(group.group, 0)
    comm_dev = (torch.device("cuda", torch.cuda.current_device())
                if dist.get_backend(group.group) == "nccl" else torch.device("cpu"))
    for t in tensors:
        buf = t if t.device == comm_dev else t.to(comm_dev)
        dist.broadcast(buf, src, group=group.group)
        if buf is not t:
            t.copy_(buf)


def all_gather_over(t: torch.Tensor, group: DataGroup) -> list:
    """Every rank's ``t`` (one shape on all), in the group's rank order, on
    ``t``'s device; through the group's device where ``t`` lies elsewhere."""
    comm_dev = (torch.device("cuda", torch.cuda.current_device())
                if dist.get_backend(group.group) == "nccl" else torch.device("cpu"))
    buf = t.to(comm_dev, memory_format=torch.contiguous_format)
    parts = [torch.empty_like(buf) for _ in range(group.size)]
    dist.all_gather(parts, buf, group=group.group)
    return [q.to(t.device) for q in parts]


def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` in a new tensor (bf16 and f16 summed
    in f32, rounded once)."""
    wide = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype
    out = t.to(wide, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.dtype)


def head_share(num_heads: int, size: int, rank: int) -> tuple[int, int]:
    """(first head, number of heads) of rank ``rank`` on a model axis of
    ``size`` ranks: contiguous runs of whole heads, the first ``num_heads %
    size`` ranks one head more than the rest (zero where ``size`` exceeds
    ``num_heads``)."""
    base, extra = divmod(num_heads, size)
    return rank * base + min(rank, extra), base + (rank < extra)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _sum_over(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _FirstOnModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, first):
        return t.view_as(t) if first else torch.zeros_like(t)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ZeroPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        ctx.metas = [(t.shape, t.dtype, t.device) for t in inputs]
        return torch.zeros(inputs[0].shape, dtype=torch.float32, device=inputs[0].device)

    @staticmethod
    def backward(ctx, grad):
        return tuple(torch.zeros(s, dtype=dt, device=dev) for s, dt, dev in ctx.metas)


def _tp(group: ModelGroup | None) -> bool:
    return group is not None and group.size > 1


def copy_to_model(t: torch.Tensor, group: ModelGroup | None) -> torch.Tensor:
    """``t`` itself; in the backward its gradient summed over the model
    group (the column-parallel product's input gradient is a partial)."""
    return _CopyToModel.apply(t, group.group) if _tp(group) else t


def reduce_from_model(t: torch.Tensor, group: ModelGroup | None) -> torch.Tensor:
    """The sum of the ranks' partials ``t`` over the model group; the
    gradient passes to each rank's partial unchanged."""
    return _ReduceFromModel.apply(t, group.group) if _tp(group) else t


def first_on_model(t: torch.Tensor, group: ModelGroup | None) -> torch.Tensor:
    """``t`` on the model axis's first rank, zeros of its shape on the
    others, for a term added into a partial that :func:`reduce_from_model`
    then sums: the sum holds ``t`` once. Its gradient is passed whole on
    every rank, so a replicated ``t`` gets the same gradient everywhere."""
    return _FirstOnModel.apply(t, group.rank == 0) if _tp(group) else t


def zero_partial(*inputs: torch.Tensor) -> torch.Tensor:
    """An f32 zero partial shaped like ``inputs[0]`` for
    :func:`reduce_from_model`, from a rank with no share of the product that
    would read ``inputs`` (each a ``copy_to_model`` output); every input gets
    a zero gradient, so their backward sums run on this rank too."""
    return _ZeroPartial.apply(*inputs)
