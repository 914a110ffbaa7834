"""The training step of the port, on one device.

Counterpart of ``intentbev/train.py::make_train_step`` (the jitted step)
with its optimizer and plateau schedule, for either model family. One call
of the step does what the JAX program does:

- points transport: decode the i16 transport points, apply the host-drawn
  point-space augmentation to points and GT, voxelize on the device
  (scatter-max); chunk train transport (the host already augmented the
  points and built placement chunks, ``data.pipeline``): decode the
  chunks, fill the dense BEV with the ``voxel_fill`` kernel, and augment
  only the GT; either way, apply the patch-dropout mask to the lidar BEV
  and the decoded map;
- the model forward in training mode, the loss, the backward;
- the AdamW update.

The random draws of a step (patch dropout, drop-path gates, the intention
drop's uniforms) come from the ``torch.Generator`` the caller passes, or,
for the dropout and the uniforms, from explicit :class:`StepDraws` (a test
feeds the JAX package's draws). The metrics stay on the device. Each
stage of the step runs in a ``torch.profiler.record_function`` span
(``train/inputs``, which holds the fill, ``train/forward``, ``train/loss``,
``train/backward``, ``train/optimizer``), which
``tools/profile_torch_slice.py --train`` reads; outside a profiler a span
costs a few microseconds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .bev.augment import (DropoutDraws, augment_gt, augment_points_gt, draw_dropout,
                          dropout_keep_mask)
from .bev.rasterize import decode_map_transport
from .bev.voxelize import dequantize_points, voxelize_packed
from .ops.voxel_embed import (CNN_CHUNK_PATCH, VoxelChunks, decode_chunk_transport,
                              voxel_fill_bev, voxel_fill_bev_plain)

METRICS = ("loss", "cls_loss", "box_loss", "intent_loss", "num_pos_anchors")


def make_optimizer(params, cfg) -> torch.optim.AdamW:
    """AdamW as ``optax.adamw`` sets it: betas (0.9, 0.999), eps 1e-8, the
    decoupled weight decay on every parameter."""
    return torch.optim.AdamW(params, lr=cfg.train.learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.train.weight_decay)


class PlateauScheduler:
    """ReduceLROnPlateau(mode=min, factor, patience), stepped per epoch on
    the mean loss (a copy of the JAX package's host-side scheduler)."""

    def __init__(self, base_lr: float, factor: float, patience: int):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr

    def start_phase(self, lr: float) -> None:
        """Begin an explicit finetune phase: new LR, plateau tracking reset."""
        self.lr = float(lr)
        self.best = float("inf")
        self.bad_epochs = 0

    def state(self) -> dict:
        return {"lr": np.float32(self.lr), "best": np.float32(self.best),
                "bad_epochs": np.int32(self.bad_epochs)}

    def restore(self, d: dict) -> None:
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.bad_epochs = int(d["bad_epochs"])


class StepDraws(NamedTuple):
    """A step's data draws: the patch dropout and the intention drop's
    uniforms f32[B * num_anchors]."""

    dropout: DropoutDraws
    intent_u: torch.Tensor


def chunk_patch_for(cfg) -> int:
    """Band geometry of the chunk train transport: the ViT's patch size
    (shared with the serving transport) or the CNN constant."""
    return cfg.vit.patch_size if cfg.model_family == "vit" else CNN_CHUNK_PATCH


def augmented_inputs(batch, keep_mask, grid, dtype, chunk_patch: int = CNN_CHUNK_PATCH,
                     plain: bool = False):
    """Points or chunk transport -> (lidar BEV, map, gt_boxes,
    gt_intentions), the dropout's keep mask bool[B, H, W] applied to both
    BEVs. Chunks are filled with ``voxel_fill_bev`` (its plain version
    when ``plain``) at the band geometry of ``chunk_patch``."""
    if "aug_params" not in batch:
        raise ValueError("the port's step takes the point-space path: the batch "
                         "needs host-drawn aug_params")
    keep = keep_mask[..., None].to(dtype)
    map_bev = decode_map_transport(batch["map_bev"], grid.map_channels, dtype) * keep
    if "chunks" in batch:
        fill = voxel_fill_bev_plain if plain else voxel_fill_bev
        lidar = fill(decode_chunk_transport(VoxelChunks(*batch["chunks"])),
                     (grid.height_px, grid.width_px), grid.lidar_total_channels,
                     chunk_patch, dtype)
        lidar.mul_(keep)  # in place: the fill's output is this step's own
        gt_boxes, gt_intents = augment_gt(batch["gt_boxes"], batch["gt_intentions"],
                                          batch["gt_valid"], batch["aug_params"])
        return lidar, map_bev, gt_boxes, gt_intents
    pts, gt_boxes, gt_intents = augment_points_gt(
        dequantize_points(batch["points"]), batch["gt_boxes"], batch["gt_intentions"],
        batch["gt_valid"], batch["aug_params"])
    lidar = voxelize_packed(pts, batch["points_valid"], grid, out_dtype=dtype) * keep
    return lidar, map_bev, gt_boxes, gt_intents


def make_train_step(model, cfg, anchors: torch.Tensor, optimizer):
    """-> ``step(batch, generator=None, draws=None) -> metrics``.

    ``model``: ``IntentNetViT`` or ``IntentNetCNN`` with f32 parameters on
    the step's device (``dtype`` the compute dtype; with ``plain_ops`` set
    the chunk fill takes its plain version too). ``batch``: device tensors
    points [B, S, P, 4] (f32 or i16 transport) and points_valid [B, S, P],
    or ``chunks`` (packed ``VoxelChunks``, ``data.pipeline``) in their
    place; map_bev [B, H, W, 9] (any map transport), gt_boxes [B, G, 5],
    gt_intentions [B, G], gt_valid [B, G], aug_params [B, 3]. The step
    updates the parameters and the BatchNorm running averages in place and
    leaves each parameter's gradient in ``.grad``; it returns the five
    metrics as device scalars."""
    from .losses import detection_intention_loss

    grid, aug_cfg = cfg.grid, cfg.augment
    dtype = torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32
    chunk_patch = chunk_patch_for(cfg)

    def step(batch, generator: torch.Generator | None = None,
             draws: StepDraws | None = None) -> dict:
        span = torch.profiler.record_function
        b = batch["gt_boxes"].shape[0]
        with span("train/inputs"):
            if draws is None:
                draws = StepDraws(
                    draw_dropout(aug_cfg, grid.height_px, grid.width_px, b, generator,
                                 anchors.device),
                    torch.rand(b * anchors.shape[0], generator=generator,
                               device=anchors.device))
            keep = dropout_keep_mask(draws.dropout, grid.height_px, grid.width_px)
            lidar, map_bev, gt_boxes, gt_intents = augmented_inputs(
                batch, keep, grid, dtype, chunk_patch, model.plain_ops)
        with span("train/forward"):
            model.train()
            cls_l, box_d, int_l = model(lidar, map_bev, generator)
        with span("train/loss"):
            out = detection_intention_loss(
                cls_l, box_d, int_l, anchors, gt_boxes, gt_intents, batch["gt_valid"],
                cfg.loss, draws.intent_u)
        with span("train/backward"):
            optimizer.zero_grad(set_to_none=True)
            out["loss"].backward()
        with span("train/optimizer"):
            optimizer.step()
        return {k: out[k].detach() for k in METRICS}

    return step
