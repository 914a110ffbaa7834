"""The data-parallel group a step, a loss or a model forward runs in.

A :class:`DataGroup` names the ranks that split one global batch (the data
axis of ``parallel.mesh.create_mesh``) and this rank's place in it. Under
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
  (replicated parameters).

Everything takes ``group=None`` to mean one process holding the whole
batch: no collective runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class DataGroup(NamedTuple):
    group: object  # a torch.distributed ProcessGroup
    rank: int      # this process's index on the data axis
    size: int      # number of ranks on the data axis


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
