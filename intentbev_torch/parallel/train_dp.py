"""The data-parallel training step over torch.distributed.

Counterpart of ``intentbev/parallel/train_dp.py``. JAX compiles one
program over the mesh: the batch sharded over 'data', the parameters
replicated, the gradient all-reduce and BatchNorm's global statistics
inserted by GSPMD. Here each rank runs the one-device step
(``train.make_train_step``) on its contiguous share of the global batch,
with the mesh's data axis as its group:

- every random draw (the patch dropout, the intention drop's uniforms, the
  drop-path gates) is made for the global batch and cut to the rank, so the
  same generator state (or the same ``StepDraws``) gives the same step at
  any world size;
- BatchNorm and the loss read the global batch's statistics and
  denominators, so each rank's loss is its share of the global loss;
- the gradients are summed over the group before AdamW (no averaging: the
  shares already carry the global denominators);
- the intention class weights are kept, as JAX keeps them.

Tensor parallelism over the model axis (``MeshConfig.model_parallel`` > 1)
is not ported (``ROADMAP.md`` §1 item 5) and raises.
"""

from __future__ import annotations

import torch

from ..utils.distributed import broadcast_from_first
from .mesh import data_group, require_data_parallel


@torch.no_grad()
def shard_train_state(model, optimizer, mesh, cfg) -> None:
    """Make every rank's parameters, buffers and optimizer state rank 0's
    of the data axis (a broadcast over it, in place). The parameters stay
    replicated: the model axis is 1 (:func:`mesh.require_data_parallel`)."""
    require_data_parallel(cfg.mesh)
    state = [v for st in optimizer.state.values() for v in st.values()
             if isinstance(v, torch.Tensor)]
    broadcast_from_first([t.data for t in model.parameters()] + list(model.buffers()) + state,
                         data_group(mesh, cfg.mesh))


def make_sharded_train_step(model, cfg, anchors, optimizer, mesh, intention_weights=None):
    """-> ``step(batch, generator=None, draws=None) -> metrics``, the
    contract of ``train.make_train_step``, where ``batch`` is this rank's
    local batch (its contiguous share of the global batch, on its device),
    ``draws`` the global batch's, and the metrics the global batch's.
    ``intention_weights``: the loss's class weights, as the one-device
    step takes them."""
    from ..train import make_train_step

    require_data_parallel(cfg.mesh)
    return make_train_step(model, cfg, anchors, optimizer, intention_weights,
                           group=data_group(mesh, cfg.mesh))
