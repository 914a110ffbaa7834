"""Synthetic inputs, as the JAX package's benches draw them.

- :func:`serving_batch` (``bench.py`` ``run_sustained.random_batch``):
  uniform points over the grid's metric extent, u8-integral intensities,
  and a bit-packed binary map with 5 % of its cells set;
- :func:`bench_batch` (``bench.py`` ``build_bench``): uniform points and
  intensities and a dense 0/1 f32 map, the timed lines' inputs;
- :func:`train_batch` (``tools/bench_train.py``): uniform points and
  intensities, a dense 0/1 map, max_gt GT boxes per sample (2 x 4.5 m
  cars ahead of the ego), identity augmentation;
- :func:`chunk_train_batch` (``tools/bench_train.py --transport chunks``):
  the same draw over the chunk train transport;
- :func:`calibrated_params`: seeded random parameters whose BatchNorm
  running statistics are those of a synthetic serving batch.
"""

from __future__ import annotations

import numpy as np
import torch

from .bev.augment import IDENTITY_AUG
from .bev.rasterize import pack_map_channels
from .data.pipeline import ChunkBatch, stack_chunk_batch
from .train import chunk_patch_for


def serving_batch(grid, batch: int, points_per_sweep: int, seed: int):
    """-> (points f32[B, S, P, 4], valid bool[B, S, P], map u8[B, H, W, 2])."""
    r = np.random.default_rng(seed)
    shape = (batch, grid.lidar_sweeps, points_per_sweep)
    pts = np.zeros(shape + (4,), np.float32)
    pts[..., 0] = r.uniform(grid.bev_x_min, grid.bev_x_max, shape)
    pts[..., 1] = r.uniform(grid.bev_y_min + 2, grid.bev_y_max - 2, shape)
    pts[..., 2] = r.uniform(grid.z_min, grid.z_max - 0.1, shape)
    pts[..., 3] = r.integers(0, 256, shape).astype(np.float32)
    mp = pack_map_channels(
        r.uniform(0, 1, (batch, grid.height_px, grid.width_px, grid.map_channels)) < 0.05)
    return pts, np.ones(shape, bool), mp


def bench_batch(grid, batch: int, points_per_sweep: int, seed: int = 0):
    """-> (points f32[B, S, P, 4], valid bool[B, S, P], map f32[B, H, W, C]),
    drawn in ``bench.py``'s order."""
    r = np.random.default_rng(seed)
    shape = (batch, grid.lidar_sweeps, points_per_sweep)
    pts = np.zeros(shape + (4,), np.float32)
    pts[..., 0] = r.uniform(-20, 60, shape)
    pts[..., 1] = r.uniform(-70, 70, shape)
    pts[..., 2] = r.uniform(-2, 3.7, shape)
    pts[..., 3] = r.uniform(0, 255, shape)
    mp = (r.uniform(0, 1, (batch, grid.height_px, grid.width_px, grid.map_channels))
          < 0.05).astype(np.float32)
    return pts, np.ones(shape, bool), mp


def train_batch(grid, batch: int, points_per_sweep: int, max_gt: int, seed: int) -> dict:
    """numpy batch of the points-transport train step: points f32[B, S, P,
    4], points_valid, map_bev f32[B, H, W, C], gt_boxes f32[B, G, 5],
    gt_intentions i32[B, G] (all KEEP_LANE), gt_valid, aug_params f32[B, 3]."""
    r = np.random.default_rng(seed)
    b, s, p, g = batch, grid.lidar_sweeps, points_per_sweep, max_gt
    pts = np.zeros((b, s, p, 4), np.float32)
    pts[..., 0] = r.uniform(-20, 60, (b, s, p))
    pts[..., 1] = r.uniform(-70, 70, (b, s, p))
    pts[..., 2] = r.uniform(-2, 3.7, (b, s, p))
    pts[..., 3] = r.uniform(0, 255, (b, s, p))
    gtb = np.zeros((b, g, 5), np.float32)
    gtb[..., 0] = r.uniform(0, 50, (b, g))
    gtb[..., 1] = r.uniform(-30, 30, (b, g))
    gtb[..., 2] = 2.0
    gtb[..., 3] = 4.5
    return {
        "points": pts,
        "points_valid": np.ones((b, s, p), bool),
        "map_bev": (r.uniform(0, 1, (b, grid.height_px, grid.width_px, grid.map_channels))
                    < 0.05).astype(np.float32),
        "gt_boxes": gtb,
        "gt_intentions": np.zeros((b, g), np.int32),
        "gt_valid": np.ones((b, g), bool),
        "aug_params": np.tile(IDENTITY_AUG, (b, 1)),
    }


def chunk_train_batch(cfg, batch: int, points_per_sweep: int, seed: int) -> ChunkBatch:
    """:func:`train_batch`'s draw (same seed, same arrays) stacked for the
    chunk train transport at ``cfg.train.chunk_capacity`` chunks per band,
    at the band geometry of ``cfg.model_family``."""
    tb = train_batch(cfg.grid, batch, points_per_sweep, cfg.loss.max_gt_boxes, seed)
    return stack_chunk_batch(
        tb["points"], tb["points_valid"], tb["map_bev"], tb["gt_boxes"],
        tb["gt_intentions"], tb["gt_valid"], tb["aug_params"], cfg.grid,
        chunk_patch_for(cfg), cfg.train.chunk_capacity)


def calibrated_params(cfg, seed: int, device, batch: int = 8,
                      points_per_sweep: int = 16384) -> dict[str, torch.Tensor]:
    """``models.init_params(cfg, seed)`` with every BatchNorm's running mean
    and variance set to the statistics of one :func:`serving_batch` (drawn
    from the same seed) on the points transport, so that the eval-mode
    forward is normalized as a trained model's is. At init (running mean 0,
    variance 1) the CNN's activations grow through every block and the box
    decode overflows. The calibration runs in the compute dtype of
    ``device`` (bf16 on CUDA); the returned state dict is f32 on the CPU."""
    from .bev.voxelize import voxelize_packed
    from .models import blocks, build_model, init_params

    dev = torch.device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = init_params(cfg, seed)
    model = build_model(cfg, dtype=dtype, param_dtype=torch.float32)
    model.load_state_dict(params)
    model.to(dev).train()
    pts, valid, mp = serving_batch(cfg.grid, batch, points_per_sweep, seed)
    lidar = voxelize_packed(torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev),
                            cfg.grid, out_dtype=dtype)
    momentum = blocks.BN_MOMENTUM
    blocks.BN_MOMENTUM = 0.0  # running statistics := this batch's
    try:
        with torch.no_grad():
            model(lidar, torch.from_numpy(mp).to(dev))
    finally:
        blocks.BN_MOMENTUM = momentum
    stats = model.state_dict()
    for k in params:
        if k.endswith(("running_mean", "running_var")):
            params[k] = stats[k].float().cpu()
    return params
