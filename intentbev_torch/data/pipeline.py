"""Host input pipeline: threaded sample loading, batch stacking over both
train transports, and the copy to the device ahead of the consumer.

Counterpart of ``intentbev/data/pipeline.py``:

- :func:`batch_iterator` loads samples (``ArgoverseSampleLoader``) in a
  thread pool ahead of the consumer, drops failed samples (``None``), and
  stacks fixed-shape numpy batches: :class:`Batch` on the points transport
  (i16-centimetre points, bit-packed map) or :class:`ChunkBatch` on the
  chunk train transport. Shuffle order and augmentation draws come from
  one ``np.random.default_rng(seed)``, shuffle first, so the batches are
  the JAX package's for the same seed.
- Chunk transport, per sample: the points make the i16-centimetre round
  trip of the points transport first (so both transports voxelize
  identical coordinates), take the drawn flip/rotate/scale on the host
  (``augment_points_np``), and go through the C++ chunk build at the
  fixed ``chunk_capacity`` (overfull bands drop their excess chunks); the
  chunks are stacked and packed. The GT stays unaugmented: the train step
  applies ``augment_gt`` on the device.
- :func:`device_prefetch` copies batches to a device ``size`` steps ahead
  on a producer thread. Unlike the JAX package's daemon producer, it
  stops when the consumer stops early (a ``max_steps`` break, an
  exception, ``close()``): the producer leaves its blocking put, closes
  the source iterator (which shuts the loader pool of
  :func:`batch_iterator` down) and is joined.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

from ..bev.augment import IDENTITY_AUG, aug_linear_matrix, augment_points_np, draw_aug_params
from ..bev.rasterize import pack_map_channels
from ..bev.voxelize import dequantize_points_np, quantize_points_cm
from ..ops.voxel_embed import (VoxelChunks, build_voxel_chunks, chunks_to_device,
                               pack_chunk_transport, stack_voxel_chunks)


class Batch(NamedTuple):
    """Points-transport training / eval batch (compact transport dtypes:
    the device decodes them, ``bev.voxelize.dequantize_points`` and
    ``bev.rasterize.decode_map_transport``)."""

    points: np.ndarray         # i16[B, S, P, 4] xyz in cm, intensity raw
    points_valid: np.ndarray   # bool[B, S, P]
    map_bev: np.ndarray        # u8[B, H, W, ceil(9/8)=2] bit-packed
    gt_boxes: np.ndarray       # f32[B, G, 5]
    gt_intentions: np.ndarray  # i32[B, G]
    gt_valid: np.ndarray       # bool[B, G]
    aug_params: np.ndarray     # f32[B, 3] = (flip_sign, theta, scale); identity (1, 0, 1)


class ChunkBatch(NamedTuple):
    chunks: VoxelChunks        # packed (u16 slot|channel, u8 values when integral)
    map_bev: np.ndarray        # u8[B, H, W, ceil(C/8)] bit-packed (binary u8 maps)
    gt_boxes: np.ndarray       # f32[B, G, 5], unaugmented
    gt_intentions: np.ndarray  # i32[B, G]
    gt_valid: np.ndarray       # bool[B, G]
    aug_params: np.ndarray     # f32[B, 3] = (flip_sign, theta, scale)


def _stack_map(maps: Sequence[np.ndarray]) -> np.ndarray:
    """Stack per-sample maps; binary u8 maps ship bit-packed (exact)."""
    map_bev = np.stack(maps)
    if map_bev.dtype == np.uint8 and map_bev.shape[-1] > 1:
        map_bev = pack_map_channels(map_bev)
    return map_bev


def stack_chunk_batch(points: Sequence[np.ndarray], points_valid: Sequence[np.ndarray],
                      map_bev: Sequence[np.ndarray], gt_boxes: Sequence[np.ndarray],
                      gt_intentions: Sequence[np.ndarray], gt_valid: Sequence[np.ndarray],
                      aug_params: Sequence[np.ndarray], grid, chunk_patch: int,
                      chunk_capacity: int) -> ChunkBatch:
    """Per-sample arrays (points f32[S, P, 4], valid bool[S, P], map [H, W,
    C], GT, aug params f32[3]) -> one :class:`ChunkBatch`."""
    chunks = []
    for pts, valid, aug in zip(points, points_valid, aug_params):
        pts = augment_points_np(dequantize_points_np(quantize_points_cm(pts)), aug)
        chunks.append(build_voxel_chunks(pts, valid, grid, chunk_patch, chunk_capacity,
                                         on_overflow="drop"))
    return ChunkBatch(
        chunks=pack_chunk_transport(stack_voxel_chunks(chunks)),
        map_bev=_stack_map(map_bev),
        gt_boxes=np.stack(gt_boxes),
        gt_intentions=np.stack(gt_intentions),
        gt_valid=np.stack(gt_valid),
        aug_params=np.stack(aug_params).astype(np.float32),
    )


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def chunk_batch_to_device(batch: ChunkBatch, device) -> dict:
    """-> the train step's batch dict on ``device`` (``chunks`` still in the
    packed transport encoding; the step decodes it)."""
    out = {"chunks": chunks_to_device(batch.chunks, device)}
    for name in ChunkBatch._fields[1:]:
        out[name] = _to_device(getattr(batch, name), device)
    return out


def batch_to_device(batch, device) -> dict:
    """A :class:`Batch` or :class:`ChunkBatch` -> the train step's batch dict
    of tensors on ``device`` (pinned, asynchronous copies to a GPU)."""
    if isinstance(batch, ChunkBatch):
        return chunk_batch_to_device(batch, device)
    return {name: _to_device(a, device) for name, a in batch._asdict().items()}


def _stack(samples: Sequence, aug: Sequence[np.ndarray]) -> Batch:
    return Batch(
        points=quantize_points_cm(np.stack([s.points for s in samples])),
        points_valid=np.stack([s.points_valid for s in samples]),
        map_bev=_stack_map([s.map_bev for s in samples]),
        gt_boxes=np.stack([s.gt_boxes for s in samples]),
        gt_intentions=np.stack([s.gt_intentions for s in samples]),
        gt_valid=np.stack([s.gt_valid for s in samples]),
        aug_params=np.stack(aug).astype(np.float32),
    )


def _stack_chunks(samples: Sequence, aug: Sequence[np.ndarray], grid, chunk_patch: int,
                  chunk_capacity: int) -> ChunkBatch:
    return stack_chunk_batch(
        [s.points for s in samples], [s.points_valid for s in samples],
        [s.map_bev for s in samples], [s.gt_boxes for s in samples],
        [s.gt_intentions for s in samples], [s.gt_valid for s in samples], aug, grid,
        chunk_patch, chunk_capacity)


def batch_iterator(
    sequences: Sequence,
    loader,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    num_workers: int = 4,
    drop_last: bool = False,
    augment=None,
    skip_batches: int = 0,
    transport: str = "points",
    chunk_patch: int = 8,
    chunk_capacity: int = 768,
) -> Iterator:
    """Yield fixed-shape batches of ``loader.load(sequence)`` samples; failed
    samples are dropped (so a batch can be smaller than ``batch_size``).

    ``augment``: an AugmentConfig; per-sample flip/rotate/scale parameters
    are drawn on the host, the map is rasterized at the augmented pose in
    ``loader.load``, and the parameters ship in ``aug_params`` (the device
    transforms points and GT; on the chunk transport the host transforms
    the points). Deterministic per ``seed``.

    ``skip_batches``: fast-forward over the first N batches without loading
    them (mid-epoch resume). The shuffle order and the draws are made for
    the whole epoch first, so the batches from position N on are those a
    full iteration yields (as long as no sample before N fails to load).

    ``transport``: "points" (:class:`Batch`) or "chunks"
    (:class:`ChunkBatch` at ``chunk_patch`` / ``chunk_capacity``).
    ``num_workers`` > 1 loads in a thread pool, a window of 2 x workers
    ahead; the pool shuts down (queued loads cancelled) when the generator
    ends or is closed.
    """
    if transport == "chunks":
        grid = loader.grid

        def stack(samples, aug):
            return _stack_chunks(samples, aug, grid, chunk_patch, chunk_capacity)
    elif transport == "points":
        stack = _stack
    else:
        raise ValueError(f"transport {transport!r} not in ('points', 'chunks')")

    order = np.arange(len(sequences))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(order)
    if augment is not None:
        params = draw_aug_params(augment, rng, len(order))
        linears = [aug_linear_matrix(p) for p in params]
    else:
        params = np.tile(IDENTITY_AUG, (len(order), 1))
        linears = [None] * len(order)
    if skip_batches:
        n_skip = skip_batches * batch_size
        order, params, linears = order[n_skip:], params[n_skip:], linears[n_skip:]

    pending: list = []
    pending_aug: list = []
    if num_workers <= 1:
        for k, idx in enumerate(order):
            s = loader.load(sequences[int(idx)], aug_linear=linears[k])
            if s is not None:
                pending.append(s)
                pending_aug.append(params[k])
            if len(pending) == batch_size:
                yield stack(pending, pending_aug)
                pending, pending_aug = [], []
        if pending and not drop_last:
            yield stack(pending, pending_aug)
        return

    pool = ThreadPoolExecutor(max_workers=num_workers, thread_name_prefix="batch-loader")
    try:
        window = num_workers * 2
        futures = [pool.submit(loader.load, sequences[int(order[k])], linears[k])
                   for k in range(min(window, len(order)))]
        next_submit = window
        for k in range(len(order)):
            s = futures[k].result()
            futures[k] = None  # release the Sample (10s of MB each) promptly
            if next_submit < len(order):
                futures.append(pool.submit(loader.load, sequences[int(order[next_submit])],
                                           linears[next_submit]))
                next_submit += 1
            if s is not None:
                pending.append(s)
                pending_aug.append(params[k])
            if len(pending) == batch_size:
                yield stack(pending, pending_aug)
                pending, pending_aug = [], []
        if pending and not drop_last:
            yield stack(pending, pending_aug)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _pad_leaves(x, fn):
    if isinstance(x, tuple):
        leaves = [_pad_leaves(v, fn) for v in x]
        return type(x)(*leaves) if hasattr(x, "_fields") else tuple(leaves)
    return fn(x)


def pad_batch(batch, batch_size: int):
    """Pad a short tail batch (:class:`Batch` or :class:`ChunkBatch`) with
    zeros up to ``batch_size`` -> (padded batch, sample_valid
    bool[batch_size]). Padding samples carry no GT; eval masks them by
    ``sample_valid``."""
    b = batch.gt_boxes.shape[0]
    sample_valid = np.zeros((batch_size,), dtype=bool)
    sample_valid[:b] = True
    if b == batch_size:
        return batch, sample_valid

    def pad(arr):
        return np.pad(arr, [(0, batch_size - b)] + [(0, 0)] * (arr.ndim - 1))

    return _pad_leaves(batch, pad), sample_valid


class _ProducerError:
    """Wrapper distinguishing a producer exception from a yielded batch."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def device_prefetch(iterator: Iterator, size: int = 2, put=None, device=None) -> Iterator:
    """Yield ``put(item)`` for each item of ``iterator``, computed on a
    producer thread up to ``size`` items ahead of the consumer.

    ``put`` defaults to :func:`batch_to_device` on ``device``. A producer
    error is raised in the consumer. When the consumer stops early (break,
    exception, ``close()``), the producer is told to stop, closes
    ``iterator`` and is joined."""
    if put is None:
        if device is None:
            raise ValueError("device_prefetch needs a put function or a device")

        def put(b):
            return batch_to_device(b, device)

    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    sentinel = object()

    def offer(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if stop.is_set() or not offer(put(item)):
                    break
        except BaseException as exc:  # noqa: BLE001 - re-raised in the consumer
            offer(_ProducerError(exc))
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()
            offer(sentinel)

    t = threading.Thread(target=producer, name="device-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, _ProducerError):
                raise item.exc
            yield item
    finally:
        stop.set()
        t.join()
