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

:func:`train` is the loop of ``intentbev/train.py::train`` around the step:
AV2-format logs through ``data.argoverse`` and ``data.pipeline`` (the
batches the JAX package makes for the same seed), the plateau schedule
stepped per epoch on the mean loss and written into the optimizer, the
intention class weights (cached in ``out_dir``), checkpoints every
``checkpoint_every_steps`` (``checkpoint``), and a faithful resume: the
global step, the schedule, the epoch and the batch position in it. The
metrics stay on the device between log syncs. The step's draws (patch
dropout, drop-path gates, the intention drop) come from one
``torch.Generator`` on the device seeded with ``cfg.train.seed``, whose
state the checkpoints carry; JAX instead folds the step into its key
(``fold_in(rng, step)``), so the two loops draw differently. Run it as
``python -m intentbev_torch.train`` (:func:`main`); it takes the CUDA
device unless ``--device cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
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


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write the plateau schedule's learning rate into every param group."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def resolve_device(device) -> torch.device:
    """An entry point's device: CUDA unless the caller asks for the CPU; a
    CUDA device that is not there raises (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) to run on the CPU")
    return device


def compute_intention_class_weights(sequences, loader, num_classes: int = 8,
                                    max_sequences: int | None = 2048,
                                    num_workers: int = 4) -> np.ndarray:
    """Inverse-frequency intention class weights from the training GT
    (counts smoothed by +1, total / count, normalised to sum 1), over an
    even-stride sample of at most ``max_sequences`` sequences loaded by a
    thread pool; as ``intentbev/train.py``."""
    from concurrent.futures import ThreadPoolExecutor

    if max_sequences is not None and len(sequences) > max_sequences:
        idx = np.linspace(0, len(sequences) - 1, max_sequences).astype(np.int64)
        sequences = [sequences[i] for i in idx]

    counts = np.zeros(num_classes, dtype=np.int64)

    def count_one(seq) -> np.ndarray:
        s = loader.load(seq)
        if s is None:
            return np.zeros(num_classes, dtype=np.int64)
        labels = s.gt_intentions[s.gt_valid]
        labels = labels[(labels >= 0) & (labels < num_classes)]
        return np.bincount(labels, minlength=num_classes).astype(np.int64)

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for c in pool.map(count_one, sequences):
            counts += c
    total = counts.sum()
    if total == 0:
        return np.ones(num_classes, dtype=np.float32) / num_classes
    weights = total / (counts + 1.0)
    return (weights / weights.sum()).astype(np.float32)


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


def make_train_step(model, cfg, anchors: torch.Tensor, optimizer,
                    intention_weights: torch.Tensor | None = None):
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
    metrics as device scalars. ``intention_weights`` f32[C] on the step's
    device: the loss's intention class weights (used only where the
    dominant-class drop is off)."""
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
                cfg.loss, draws.intent_u, intention_class_weights=intention_weights)
        with span("train/backward"):
            optimizer.zero_grad(set_to_none=True)
            out["loss"].backward()
        with span("train/optimizer"):
            optimizer.step()
        return {k: out[k].detach() for k in METRICS}

    return step


def _intention_weights(cfg, data_dir, out_dir, sequences, loader, log_fn, num_workers):
    """The loss's class weights, cached in ``out_dir/intent_weights.json``
    keyed by the dataset (resumed runs skip the counting pass)."""
    cache_file = Path(out_dir) / "intent_weights.json"
    cache_key = {"data_dir": str(Path(data_dir).absolute()), "n_sequences": len(sequences)}
    if cache_file.exists():
        cached = json.loads(cache_file.read_text())
        if cached.get("key") == cache_key:
            w = np.asarray(cached["weights"], dtype=np.float32)
            log_fn(f"intention class weights (cached): {np.round(w, 4)}")
            return w
    log_fn("computing intention class weights from training GT...")
    w = compute_intention_class_weights(sequences, loader, cfg.heads.num_intention_classes,
                                        num_workers=num_workers)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    cache_file.write_text(json.dumps({"key": cache_key, "weights": [float(x) for x in w]}))
    log_fn(f"intention class weights: {np.round(w, 4)}")
    return w


def train(cfg, data_dir: str, out_dir: str, num_workers: int = 4,
          max_steps: int | None = None, log_fn=print, use_intention_weights: bool = False,
          resume: bool = False, resume_lr: float | None = None,
          max_points_per_sweep: int = 65536, device="cuda",
          state_out: dict | None = None) -> dict:
    """The training loop on one device; returns the last epoch's mean
    metrics (a partial epoch's when ``max_steps`` stops it).

    ``device``: CUDA by default; ``"cpu"`` runs the plain versions (a CUDA
    device that is missing raises). ``state_out``: a dict that receives
    ``model``, ``optimizer`` and ``step`` at the end (the live objects the
    last checkpoint was written from)."""
    from .boxes.anchors import generate_anchors
    from .checkpoint import latest_step, load_checkpoint, save_checkpoint
    from .data.argoverse import ArgoverseSampleLoader, ScenarioValidator, build_sequence_index
    from .data.pipeline import batch_iterator, device_prefetch
    from .models import build_model
    from .utils.profiling import MetricsLogger

    device = resolve_device(device)
    dtype = torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32
    model = build_model(cfg, dtype=dtype, param_dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(cfg.train.seed))
    model.to(device)
    optimizer = make_optimizer(model.parameters(), cfg)
    generator = torch.Generator(device=device).manual_seed(cfg.train.seed)

    scenarios = ScenarioValidator(data_dir).find_valid_scenarios()
    if not scenarios:
        raise ValueError(f"No valid scenarios found in {data_dir}")
    sequences = build_sequence_index(scenarios, cfg.grid.lidar_sweeps)
    if not sequences:
        raise ValueError(f"No valid sequences in {data_dir}")
    log_fn(f"{len(scenarios)} logs, {len(sequences)} sequences")
    loader = ArgoverseSampleLoader(cfg.grid, max_gt=cfg.loss.max_gt_boxes, verbose=False,
                                   max_points_per_sweep=max_points_per_sweep)

    intention_weights = None
    if use_intention_weights and not cfg.loss.apply_intention_downsampling:
        intention_weights = torch.from_numpy(_intention_weights(
            cfg, data_dir, out_dir, sequences, loader, log_fn, num_workers)).to(device)
    elif use_intention_weights:
        log_fn("Warning: intention weights requested but downsampling is on; "
               "weights are ignored by the loss (reference train_vit.py:89-91)")

    scheduler = PlateauScheduler(cfg.train.learning_rate, cfg.train.plateau_factor,
                                 cfg.train.plateau_patience)
    start_epoch = step_count = resume_skip = 0
    if resume and latest_step(out_dir) is not None:
        restored, _ = load_checkpoint(out_dir, map_location=device)
        model.load_state_dict(restored["model"])
        optimizer.load_state_dict(restored["optimizer"])
        generator.set_state(restored["generator"].cpu())
        loop = restored["loop"]
        # faithful resume: the schedule, the epoch and the batch position in
        # it continue where they stopped (the seeded iterator fast-forwards)
        scheduler.restore(loop)
        start_epoch = int(loop["epoch"])
        resume_skip = int(loop["epoch_batch"])
        step_count = int(restored["step"])
        if resume_lr is not None:
            scheduler.start_phase(resume_lr)  # explicit finetune phase
        log_fn(f"resumed from step {step_count} (epoch {start_epoch} batch {resume_skip}, "
               f"lr {scheduler.lr:.2e}, best {scheduler.best:.4f})")
    set_learning_rate(optimizer, scheduler.lr)

    anchors = torch.from_numpy(generate_anchors(cfg.grid, cfg.anchors)).to(device)
    step = make_train_step(model, cfg, anchors, optimizer, intention_weights)
    out_path = Path(out_dir)
    mlog = MetricsLogger(out_path / "metrics.jsonl")
    last_metrics: dict = {}
    t_start = time.time()
    start_step = step_count  # rate accounting: the steps this process ran

    def ckpt_state(epoch: int, epoch_batch: int = 0) -> dict:
        # epoch_batch: batches consumed in the epoch in progress (0: a boundary)
        return {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": step_count, "generator": generator.get_state(),
                "loop": {**{k: v.item() for k, v in scheduler.state().items()},
                         "epoch": int(epoch), "epoch_batch": int(epoch_batch)}}

    epoch = start_epoch - 1  # final-save accounting if the loop body never runs
    skip = n_batches = 0
    interrupted = False  # a max_steps stop in the middle of an epoch
    for epoch in range(start_epoch, cfg.train.num_epochs):
        skip = resume_skip if epoch == start_epoch else 0
        it = batch_iterator(
            sequences, loader, cfg.train.batch_size, shuffle=True, seed=cfg.train.seed + epoch,
            num_workers=num_workers, drop_last=True, augment=cfg.augment, skip_batches=skip,
            transport=cfg.train.transport, chunk_patch=chunk_patch_for(cfg),
            chunk_capacity=cfg.train.chunk_capacity)
        accum = {"loss": 0.0, "cls_loss": 0.0, "box_loss": 0.0, "intent_loss": 0.0}
        n_batches = 0
        # the metrics stay on the device between log syncs; the pending list
        # is drained at each log_every_steps sync, one host copy for all
        pending: list = []

        def drain() -> None:
            if pending:
                rows = torch.stack([torch.stack([m[k] for k in accum]) for m in pending])
                for row in rows.cpu().tolist():
                    for k, v in zip(accum, row):
                        accum[k] += v
                pending.clear()

        batches = device_prefetch(it, size=2, device=device)
        try:
            for batch in batches:
                metrics = step(batch, generator)
                step_count += 1
                n_batches += 1
                pending.append(metrics)
                if step_count % cfg.train.log_every_steps == 0:
                    m = {k: float(v) for k, v in zip(
                        METRICS, torch.stack([metrics[k] for k in METRICS]).cpu().tolist())}
                    drain()
                    rate = ((step_count - start_step) * cfg.train.batch_size
                            / (time.time() - t_start))
                    mlog.log(step_count, samples_per_sec=rate, **m)
                    log_fn(f"epoch {epoch + 1} step {step_count} loss {m['loss']:.4f} "
                           f"(cls {m['cls_loss']:.3f} box {m['box_loss']:.3f} "
                           f"int {m['intent_loss']:.3f}) #pos {m['num_pos_anchors']:.0f} "
                           f"[{rate:.1f} samples/s]")
                if step_count % cfg.train.checkpoint_every_steps == 0:
                    # the global step: names keep sorting after a resume's
                    save_checkpoint(out_path, step_count, ckpt_state(epoch, skip + n_batches),
                                    cfg)
                if max_steps is not None and step_count >= max_steps:
                    interrupted = True
                    break
        finally:
            batches.close()  # stops the producer and the loader pool
        if n_batches:
            drain()
            last_metrics = {k: v / n_batches for k, v in accum.items()}
            if interrupted:
                # a partial epoch does not step the plateau schedule: the
                # epoch finishes (and steps it) after resume
                log_fn(f"epoch {epoch + 1} interrupted at batch {skip + n_batches}: "
                       f"avg loss {last_metrics['loss']:.4f} (partial)")
            else:
                new_lr = scheduler.step(last_metrics["loss"])
                set_learning_rate(optimizer, new_lr)
                log_fn(f"epoch {epoch + 1} done: avg loss {last_metrics['loss']:.4f} "
                       f"lr {new_lr:.1e}")
        if interrupted:
            break

    # mid-epoch stop: the position in the epoch; clean stop: the boundary
    save_checkpoint(out_path, step_count,
                    ckpt_state(epoch if interrupted else epoch + 1,
                               (skip + n_batches) if interrupted else 0), cfg)
    log_fn(f"saved final checkpoint at step {step_count} to {out_path}")
    if state_out is not None:
        state_out.update(model=model, optimizer=optimizer, step=step_count)
    return last_metrics


def main(argv=None):
    """``python -m intentbev_torch.train --data_dir ... [--device cpu]``."""
    from .configs import default_cnn_config, default_vit_config, tiny_test_config

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", default="./runs/intentbev")
    p.add_argument("--model", choices=["vit", "cnn"], default="vit")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--max_points_per_sweep", type=int, default=65536,
                   help="per-sweep point capacity of the packed transport tensor "
                        "(points beyond it are evenly subsampled)")
    p.add_argument("--tiny-smoke", action="store_true",
                   help="tiny config for smoke runs on synthetic logs")
    p.add_argument("--debug_nans", action="store_true",
                   help="autograd anomaly detection (the counterpart of jax_debug_nans)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --out_dir")
    p.add_argument("--resume_lr", type=float, default=None,
                   help="with --resume: override the restored learning rate "
                        "(explicit finetune phase)")
    p.add_argument("--use_intention_weights", action="store_true")
    p.add_argument("--no_intention_downsampling", action="store_true")
    p.add_argument("--transport", choices=["points", "chunks"], default=None,
                   help="train input transport (TrainConfig.transport)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)

    if args.tiny_smoke:
        cfg = dataclasses.replace(tiny_test_config(), model_family=args.model)
    else:
        cfg = default_vit_config() if args.model == "vit" else default_cnn_config()
    tr = cfg.train
    for field, value in (("num_epochs", args.epochs), ("batch_size", args.batch_size),
                         ("learning_rate", args.learning_rate), ("transport", args.transport)):
        if value is not None:
            tr = dataclasses.replace(tr, **{field: value})
    cfg = dataclasses.replace(cfg, train=tr)
    if args.no_intention_downsampling:
        cfg = dataclasses.replace(
            cfg, loss=dataclasses.replace(cfg.loss, apply_intention_downsampling=False))
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    train(cfg, args.data_dir, args.out_dir, num_workers=args.num_workers,
          max_steps=args.max_steps, use_intention_weights=args.use_intention_weights,
          resume=args.resume, resume_lr=args.resume_lr,
          max_points_per_sweep=args.max_points_per_sweep, device=args.device)


if __name__ == "__main__":
    main()
