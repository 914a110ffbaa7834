"""The training step of the port, on one device.

Counterpart of ``intentbev/train.py::make_train_step`` (the jitted step)
with its optimizer and plateau schedule, for either model family. One call
of the step does what the JAX program does:

- points transport: decode the i16 transport points, apply the host-drawn
  point-space augmentation to points and GT, voxelize on the device
  (scatter-max); a points batch without ``aug_params`` is voxelized first
  and then takes the image-space augmentation of the BEVs and GT
  (``bev.augment.augment_bev``, the JAX step's ``batched_augment_bev``);
  chunk train transport (the host already augmented the
  points and built placement chunks, ``data.pipeline``): decode the
  chunks, fill the dense BEV with the ``voxel_fill`` kernel, and augment
  only the GT; either way, apply the patch-dropout mask to the lidar BEV
  and the decoded map;
- the model forward in training mode, the loss, the backward;
- the AdamW update.

The random draws of a step (patch dropout, the image-space augmentation's
flip, rotation and scale where the batch takes it, drop-path gates, the
intention drop's uniforms) come from the ``torch.Generator`` the caller
passes, or, but for the gates, from explicit :class:`StepDraws` (a test
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

``distributed=True`` (``--distributed``, under ``torchrun``, whose
environment :func:`main` passes to ``parallel.mesh.initialize_distributed``)
trains over the (data, model) mesh of the process group
(``parallel.make_sharded_train_step``): each index of the data axis loads
its share of the sequences (``parallel.mesh.shard_sequences_for_process``
over the data axis) and steps on its share of every global batch; with
``cfg.mesh.model_parallel`` > 1 (``--model_parallel N``) the ranks of the
model axis load the same samples and split the ViT blocks' heads and
hidden units (tensor parallelism, ``parallel.train_dp``). Rank 0 alone
logs and writes the checkpoints and ``metrics.jsonl``; a checkpoint holds
full tensors, parameters and AdamW moments gathered over the model axis,
in the layout of a one-process checkpoint, so any mesh (or one process)
resumes from it and ``evaluate`` loads it as it is.
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

from .bev.augment import (DropoutDraws, ImageAugDraws, augment_bev, augment_gt,
                          augment_points_gt, draw_dropout, draw_image_aug, dropout_keep_mask)
from .bev.rasterize import decode_map_transport
from .bev.voxelize import dequantize_points, voxelize_packed
from .ops.voxel_embed import (CNN_CHUNK_PATCH, VoxelChunks, decode_chunk_transport,
                              voxel_fill_bev, voxel_fill_bev_plain)
from .utils.distributed import DataGroup, all_reduce_sum, rank_slice

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
    """A step's data draws: the patch dropout, the intention drop's
    uniforms f32[B * num_anchors], and the image-space augmentation's draws
    (None where the batch carries ``aug_params``)."""

    dropout: DropoutDraws
    intent_u: torch.Tensor
    image: ImageAugDraws | None = None


def takes_image_aug(batch) -> bool:
    """Whether a batch takes the image-space augmentation: a points batch
    without host-drawn ``aug_params``."""
    return "aug_params" not in batch and "chunks" not in batch


def chunk_patch_for(cfg) -> int:
    """Band geometry of the chunk train transport: the ViT's patch size
    (shared with the serving transport) or the CNN constant."""
    return cfg.vit.patch_size if cfg.model_family == "vit" else CNN_CHUNK_PATCH


def augmented_inputs(batch, keep_mask, grid, dtype, chunk_patch: int = CNN_CHUNK_PATCH,
                     plain: bool = False, image_draws: ImageAugDraws | None = None):
    """Points or chunk transport -> (lidar BEV, map, gt_boxes,
    gt_intentions), the dropout's keep mask bool[B, H, W] applied to both
    BEVs. Chunks are filled with ``voxel_fill_bev`` (its plain version
    when ``plain``) at the band geometry of ``chunk_patch``. A points batch
    without ``aug_params`` is voxelized, then augmented in image space
    with ``image_draws``; a chunks batch needs ``aug_params`` (the host
    applied them to its points)."""
    if "aug_params" not in batch:
        if "chunks" in batch:
            raise ValueError("a chunks batch needs the host-drawn aug_params its points took")
        lidar = voxelize_packed(dequantize_points(batch["points"]), batch["points_valid"],
                                grid, out_dtype=dtype)
        map_in = decode_map_transport(batch["map_bev"], grid.map_channels, dtype)
        return augment_bev(lidar, map_in, batch["gt_boxes"], batch["gt_intentions"],
                           batch["gt_valid"], image_draws, keep_mask, grid)
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


def global_draws(aug_cfg, grid, b: int, num_anchors: int, generator, device,
                 group: DataGroup | None = None, image: bool = False) -> StepDraws:
    """A step's data draws for the global batch of ``group`` (``b`` samples
    a rank), cut to this rank: the same generator state gives the same
    draws for a sample at any world size. ``image``: draw the image-space
    augmentation's numbers too (after the others)."""
    size = 1 if group is None else group.size
    dropout = draw_dropout(aug_cfg, grid.height_px, grid.width_px, b * size, generator, device)
    intent_u = torch.rand(b * num_anchors * size, generator=generator, device=device)
    image_draws = draw_image_aug(aug_cfg, b * size, generator, device) if image else None
    return rank_draws(StepDraws(dropout, intent_u, image_draws), group)


def rank_draws(draws: StepDraws, group: DataGroup | None) -> StepDraws:
    """The global batch's draws cut to this rank's samples."""
    def cut(t):
        return None if t is None else rank_slice(t, group)

    return StepDraws(DropoutDraws(*map(cut, draws.dropout)), cut(draws.intent_u),
                     None if draws.image is None else ImageAugDraws(*map(cut, draws.image)))


def all_reduce_grads(params, group: DataGroup | None) -> None:
    """Sum every parameter's gradient over the group, through one flat f32
    buffer (a parameter without a gradient takes zeros, so every rank sends
    the same layout)."""
    if group is None:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1).float() for p in params])
    flat = all_reduce_sum(flat, group)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def grad_buckets(model) -> list[list]:
    """The parameters in the flat buffers that :func:`all_reduce_grads` sums
    over the data axis: all in one, or under tensor parallelism (a model
    with a ``model_group``) the replicated ones apart from the model axis's
    shards. A collective's summation order follows its buffer's length, and
    the shards of the attention differ in size between the ranks of the
    model axis where it does not divide the head count: a buffer of the
    replicated parameters alone has one layout on every rank of the axis,
    so their sums keep the same bits there."""
    if getattr(model, "model_group", None) is None:
        return [list(model.parameters())]
    from .parallel.sharding import model_dim

    named = list(model.named_parameters())
    return [[p for n, p in named if model_dim(n, p.dim()) is None],
            [p for n, p in named if model_dim(n, p.dim()) is not None]]


def make_train_step(model, cfg, anchors: torch.Tensor, optimizer,
                    intention_weights: torch.Tensor | None = None,
                    group: DataGroup | None = None):
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
    dominant-class drop is off).

    ``group`` (``parallel.make_sharded_train_step``): the data-parallel
    group whose global batch the rank's ``batch`` is a contiguous share of.
    The step's draws (``draws`` when given, which are then the global
    batch's) are cut to the rank; BatchNorm and the loss read the global
    batch's statistics and denominators; the gradients are summed over the
    group before the update; the metrics are the global batch's."""
    from .losses import detection_intention_loss

    grid, aug_cfg = cfg.grid, cfg.augment
    dtype = torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32
    chunk_patch = chunk_patch_for(cfg)

    def step(batch, generator: torch.Generator | None = None,
             draws: StepDraws | None = None) -> dict:
        span = torch.profiler.record_function
        b = batch["gt_boxes"].shape[0]
        with span("train/inputs"):
            image = takes_image_aug(batch)
            if draws is None:
                draws = global_draws(aug_cfg, grid, b, anchors.shape[0], generator,
                                     anchors.device, group, image)
            else:
                draws = rank_draws(draws, group)
            if image and draws.image is None:
                raise ValueError("a batch without aug_params takes the image-space "
                                 "augmentation: its draws need StepDraws.image")
            keep = dropout_keep_mask(draws.dropout, grid.height_px, grid.width_px)
            lidar, map_bev, gt_boxes, gt_intents = augmented_inputs(
                batch, keep, grid, dtype, chunk_patch, model.plain_ops, draws.image)
        with span("train/forward"):
            model.train()
            cls_l, box_d, int_l = model(lidar, map_bev, generator, group)
        with span("train/loss"):
            out = detection_intention_loss(
                cls_l, box_d, int_l, anchors, gt_boxes, gt_intents, batch["gt_valid"],
                cfg.loss, draws.intent_u, intention_class_weights=intention_weights,
                group=group)
        with span("train/backward"):
            optimizer.zero_grad(set_to_none=True)
            out["loss"].backward()
            for params in grad_buckets(model):
                all_reduce_grads(params, group)
        with span("train/optimizer"):
            optimizer.step()
        if group is None:
            return {k: out[k].detach() for k in METRICS}
        terms = all_reduce_sum(torch.stack([out[k].detach() for k in METRICS[:4]]), group)
        return {**dict(zip(METRICS[:4], terms.unbind())),
                "num_pos_anchors": out["num_pos_anchors"].detach()}

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
          state_out: dict | None = None, distributed: bool = False) -> dict:
    """The training loop; returns the last epoch's mean metrics (a partial
    epoch's when ``max_steps`` stops it).

    ``device``: CUDA by default (this rank's under ``distributed``);
    ``"cpu"`` runs the plain versions (a CUDA device that is missing
    raises). ``state_out``: a dict that receives ``model``, ``optimizer``
    and ``step`` at the end (the live objects the last checkpoint was
    written from; this rank's shards under tensor parallelism).
    ``distributed``: over the (data, model) mesh of the process group's
    ranks (the module docstring); the global batch
    (``cfg.train.batch_size``) must divide by the data axis, and the caller
    brings the process group up first (:func:`main` does under
    ``torchrun``: ``parallel.mesh.initialize_distributed``)."""
    from .boxes.anchors import generate_anchors
    from .checkpoint import latest_step, load_checkpoint, save_checkpoint
    from .data.argoverse import ArgoverseSampleLoader, ScenarioValidator, build_sequence_index
    from .data.pipeline import batch_iterator, device_prefetch
    from .models import build_model
    from .utils.profiling import MetricsLogger

    device = resolve_device(device)
    group = mesh = None
    local_batch_size, rank, writer = cfg.train.batch_size, 0, True
    if distributed:
        from .parallel.mesh import create_mesh, data_group

        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())  # this rank's card
        mesh = create_mesh(cfg.mesh, device.type)
        group = data_group(mesh, cfg.mesh)
        if cfg.train.batch_size % group.size:
            raise ValueError(f"batch_size {cfg.train.batch_size} not divisible by the data "
                             f"axis ({group.size} of mesh {tuple(mesh.shape)})")
        rank, local_batch_size = group.rank, cfg.train.batch_size // group.size
        writer = torch.distributed.get_rank() == 0
        if not writer:
            def log_fn(*_):  # rank 0 logs
                return None
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
    local_sequences = sequences
    if group is not None:
        from .parallel.mesh import shard_sequences_for_process

        local_sequences, _ = shard_sequences_for_process(sequences, rank, group.size,
                                                         cfg.train.batch_size)
        log_fn(f"distributed: mesh {tuple(mesh.shape)} (data x model), "
               f"{len(local_sequences)} sequences and a batch of {local_batch_size} a rank")

    intention_weights = None
    if use_intention_weights and not cfg.loss.apply_intention_downsampling:
        if writer:  # counted (or read from the cache) once, then broadcast
            intention_weights = torch.from_numpy(_intention_weights(
                cfg, data_dir, out_dir, sequences, loader, log_fn, num_workers)).to(device)
        else:
            intention_weights = torch.empty(cfg.heads.num_intention_classes, device=device)
        if group is not None:
            torch.distributed.broadcast(intention_weights, 0)
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
    if group is not None:
        from .parallel.train_dp import make_sharded_train_step, shard_train_state

        shard_train_state(model, optimizer, mesh, cfg)
        step = make_sharded_train_step(model, cfg, anchors, optimizer, mesh, intention_weights)
    else:
        step = make_train_step(model, cfg, anchors, optimizer, intention_weights)
    out_path = Path(out_dir)
    mlog = MetricsLogger(out_path / "metrics.jsonl" if writer else None)

    def save(step_: int, state: dict) -> None:
        if writer:  # the ranks' states are one state
            save_checkpoint(out_path, step_, state, cfg)
    last_metrics: dict = {}
    t_start = time.time()
    start_step = step_count  # rate accounting: the steps this process ran

    def ckpt_state(epoch: int, epoch_batch: int = 0) -> dict:
        # epoch_batch: batches consumed in the epoch in progress (0: a boundary)
        if mesh is not None and rank == 0:  # full tensors: the model axis gathers them
            from .parallel.train_dp import gather_train_state

            model_sd, optim_sd = gather_train_state(model, optimizer, mesh, cfg)
        else:
            model_sd, optim_sd = model.state_dict(), optimizer.state_dict()
        return {"model": model_sd, "optimizer": optim_sd,
                "step": step_count, "generator": generator.get_state(),
                "loop": {**{k: v.item() for k, v in scheduler.state().items()},
                         "epoch": int(epoch), "epoch_batch": int(epoch_batch)}}

    epoch = start_epoch - 1  # final-save accounting if the loop body never runs
    skip = n_batches = 0
    interrupted = False  # a max_steps stop in the middle of an epoch
    for epoch in range(start_epoch, cfg.train.num_epochs):
        skip = resume_skip if epoch == start_epoch else 0
        it = batch_iterator(
            local_sequences, loader, local_batch_size, shuffle=True, seed=cfg.train.seed + epoch,
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
                    save(step_count, ckpt_state(epoch, skip + n_batches))
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
    save(step_count, ckpt_state(epoch if interrupted else epoch + 1,
                                (skip + n_batches) if interrupted else 0))
    if group is not None:
        torch.distributed.barrier(group=group.group)  # the checkpoint is on disk for all
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
    p.add_argument("--distributed", action="store_true",
                   help="training over the (data, model) mesh of a torchrun launch's ranks "
                        "(NCCL on the card, gloo with --device cpu)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="with --distributed: the mesh's model axis, over which the ViT "
                        "blocks split their heads and MLP hidden units (tensor parallelism; "
                        "it must divide both)")
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
    if args.model_parallel != 1:
        from .parallel.mesh import check_model_parallel

        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, model_parallel=args.model_parallel))
        check_model_parallel(cfg)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if args.distributed:
        import os

        from .parallel.mesh import initialize_distributed

        initialize_distributed(os.environ,
                               "nccl" if torch.device(args.device).type == "cuda" else "gloo")
    try:
        train(cfg, args.data_dir, args.out_dir, num_workers=args.num_workers,
              max_steps=args.max_steps, use_intention_weights=args.use_intention_weights,
              resume=args.resume, resume_lr=args.resume_lr,
              max_points_per_sweep=args.max_points_per_sweep, device=args.device,
              distributed=args.distributed)
    finally:
        if args.distributed and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
