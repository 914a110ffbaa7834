"""End-to-end serving throughput of the PyTorch port: BEV frames/s on one
CUDA card.

The twin of ``bench.py``, which times the JAX package and stays as it is.
Each mode prints one JSON line with ``bench.py``'s keys, the flagship
(IntentNetViT over the chunk transport) line last:

  {"metric": "bev_frames_per_sec_per_chip", "value": N, "unit": "frames/s",
   "vs_baseline": N / 2000.0}

    python3 bench_torch.py             # _cnn, _cnn_chunks, _dense, _sustained, flagship
    python3 bench_torch.py --model cnn [--cnn_chunks]   # a CNN line only
    python3 bench_torch.py --model vit # the dense-BEV ViT line only
    python3 bench_torch.py --voxembed  # the flagship only
    python3 bench_torch.py --cells     # the host-pre-reduced (cell, max) transport
    python3 bench_torch.py --int8      # the W8A8 line first (with --model vit, only it)
    python3 bench_torch.py --sustained # host build + H2D + device + fetch, wall clock
    python3 bench_torch.py --batch N   # batch size (default 8)

Timing, as ``bench.py`` times: the host transport (points, cells, or
placement chunks decoded on the device) is built before the timed loop; 20
iterations run, each fed by the previous one's output (a zero times the
sum of its scores is added to its input), with one synchronize at the end.
An iteration is the device voxelizer (points, cells) or the chunk decode's
consumer (voxel_embed for the ViT, ``voxel_fill`` for the CNN), the model
in bf16, and the post-processing: box decode, top-k and the fixpoint NMS,
which waits for the device once per iteration of its fixpoint
(``boxes/nms.py``), inside the timed loop. The ViT lines serve
``default_vit_config()`` with ``bench.py``'s serving switches
(``fwd_kv_chunk=1152, unsafe_softmax=True``, attention through the flash
kernels on the card: the forward in the fixed-max form, as JAX's) and the
sigmoid GELU.
Weights are random, from ``--seed`` (the CNN's BatchNorm statistics from one
synthetic batch, ``synthetic.calibrated_params``).

``_sustained`` serves through ``StreamingInferencer`` as ``bench.py
--sustained`` does (``default_vit_config()`` without the serving switches,
so the forward's monolithic safe form): per pass, a producer thread builds
each batch's chunks
and copies them to the card on a stream of its own while the device runs
the previous batch; the Detections of batch i are fetched after batch i+1
is launched; frames/s is the median of 3 passes. The line carries the best
of 3 host-to-device copies of 64 MiB (``h2d_MiBps``), the transport bytes
per frame and the host chunk-build rate.

``INTENTBEV_LNMLP_BLOCK`` and ``INTENTBEV_MLP_HCHUNK`` (``bench.py:371``,
``:376``) tile the TPU kernels; the port's kernels have no counterpart and
this script reads neither. ``INTENTBEV_CNN_FILL_LAYOUT`` (``bench.py:101``)
is read: ``f32`` makes the CNN chunk lines' ``voxel_fill`` write the BEV in
f32, cast to bf16 before the first convolution; ``barrier`` (an XLA
optimization barrier) has no counterpart and is refused. It imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import sys
import threading
import time

import numpy as np
import torch

# bench.py's lines in the order of its default run, the flagship last
DEFAULT_LINES = ("bev_frames_per_sec_per_chip_cnn", "bev_frames_per_sec_per_chip_cnn_chunks",
                 "bev_frames_per_sec_per_chip_dense", "bev_frames_per_sec_sustained",
                 "bev_frames_per_sec_per_chip")
KEYS = ("metric", "value", "unit", "vs_baseline")
SUSTAINED_KEYS = KEYS + ("passes", "h2d_MiBps", "transport_MiB_per_frame",
                         "host_build_samples_per_sec")
SERVING_CHUNKS = 512  # chunk capacity per band, StreamingInferencer's


def note(msg: str) -> None:
    print(f"# bench_torch: {msg}", file=sys.stderr, flush=True)


def line(metric: str, fps: float, **extra) -> dict:
    out = {"metric": metric, "value": round(fps, 2), "unit": "frames/s",
           "vs_baseline": round(fps / 2000.0, 4), **extra}  # bench.py's: from the unrounded rate
    print(json.dumps(out), flush=True)
    return out


def _config(model_name: str, int8: bool, device, cfg=None):
    from intentbev_torch.configs import default_cnn_config, default_vit_config

    if cfg is None:
        cfg = default_vit_config() if model_name == "vit" else default_cnn_config()
    cfg = dataclasses.replace(cfg, model_family=model_name)
    if model_name == "vit":  # bench.py:64-69; on_tpu: on the accelerator
        cfg = dataclasses.replace(cfg, vit=dataclasses.replace(
            cfg.vit, use_flash_attention=torch.device(device).type == "cuda",
            serving_int8=int8, fwd_kv_chunk=1152, unsafe_softmax=True))
    return cfg


def build_bench(batch_size: int, points_per_sweep: int, model_name: str = "vit",
                int8: bool = False, cells: bool = False, voxembed: bool = False,
                device="cuda", cfg=None, seed: int = 0, fill_dtype: torch.dtype | None = None):
    """-> (infer, state): ``infer(state) -> (Detections, state')`` runs one
    batch on the device and returns the input of the next, chained on its
    scores. ``cfg``: the configuration to cut (default the family's
    default), with ``bench.py``'s serving switches applied. ``fill_dtype``:
    the dtype the CNN's chunk fill writes (default the compute dtype, to
    which it is cast before the model)."""
    from intentbev_torch.bev.voxelize import dedup_cells_host, voxelize_cells, voxelize_packed
    from intentbev_torch.boxes import generate_anchors
    from intentbev_torch.boxes.nms import batched_postprocess
    from intentbev_torch.models import build_model, init_params
    from intentbev_torch.ops.voxel_embed import (chunks_to_device, decode_chunk_transport,
                                                 voxel_fill_bev)
    from intentbev_torch.parallel.inference import build_chunk_transport
    from intentbev_torch.synthetic import bench_batch, calibrated_params
    from intentbev_torch.train import chunk_patch_for

    dev = torch.device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    cfg = _config(model_name, int8, dev, cfg)
    g, ev = cfg.grid, cfg.eval
    params = init_params(cfg, seed) if model_name == "vit" else calibrated_params(cfg, seed, dev)
    model = build_model(cfg, dtype=dtype, gelu="sigmoid")
    model.load_state_dict(params)
    model = model.to(dev).eval()
    anchors = torch.from_numpy(generate_anchors(g, cfg.anchors)).to(dev)
    pts, valid, mp = bench_batch(g, batch_size, points_per_sweep, seed)
    map_bev = torch.from_numpy(mp).to(dev)

    def detect(lidar):
        det = batched_postprocess(
            *model(lidar, map_bev), anchors, confidence_threshold=ev.confidence_threshold,
            nms_iou_threshold=ev.nms_iou_threshold, max_pre_nms=ev.max_pre_nms,
            max_detections=ev.max_detections)
        return det, (0.0 * det.scores.sum())

    if voxembed:
        patch = chunk_patch_for(cfg)
        chunks = decode_chunk_transport(chunks_to_device(
            build_chunk_transport(pts, valid, g, patch, SERVING_CHUNKS), dev))

        @torch.inference_mode()
        def infer(chunks):
            lidar = chunks
            if model_name == "cnn":
                lidar = voxel_fill_bev(chunks, (g.height_px, g.width_px),
                                       g.lidar_total_channels, patch, fill_dtype or dtype
                                       ).to(dtype)
            det, zero = detect(lidar)
            return det, chunks._replace(val=chunks.val + zero)
        return infer, chunks

    if cells:
        ids, vals = zip(*(dedup_cells_host(p, v, g) for p, v in zip(pts, valid)))
        state = (torch.from_numpy(np.stack(ids)).to(dev), torch.from_numpy(np.stack(vals)).to(dev))

        @torch.inference_mode()
        def infer(state):
            det, zero = detect(voxelize_cells(*state, g, out_dtype=dtype))
            return det, (state[0], state[1] + zero)
        return infer, state

    state = (torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev))

    @torch.inference_mode()
    def infer(state):
        det, zero = detect(voxelize_packed(*state, g, out_dtype=dtype))
        return det, (state[0] + zero, state[1])
    return infer, state


def run_mode(metric: str, model_name: str, int8: bool = False, batch_size: int = 8,
             points_per_sweep: int = 16384, cells: bool = False, voxembed: bool = False,
             iters: int = 20, device="cuda", cfg=None, seed: int = 0,
             fill_dtype: torch.dtype | None = None) -> dict:
    """Time ``iters`` chained batches after one warm-up; print and return
    the JSON line."""
    infer, state = build_bench(batch_size, points_per_sweep, model_name, int8, cells,
                               voxembed, device, cfg, seed, fill_dtype)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    det, state = infer(state)  # warm-up: cuBLAS/cuDNN handles, allocator, kernel build
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        det, state = infer(state)
    sync()
    return line(metric, batch_size * iters / (time.perf_counter() - t0))


def run_sustained(batch_size: int = 8, batches: int = 12, points_per_sweep: int = 16384,
                  passes: int = 3, device="cuda", cfg=None, seed: int = 0) -> dict:
    """``bench.py``'s ``run_sustained`` on ``StreamingInferencer``; see the
    module docstring."""
    from intentbev_torch.configs import default_vit_config
    from intentbev_torch.models import init_params
    from intentbev_torch.ops.voxel_embed import chunks_to_device
    from intentbev_torch.parallel import StreamingInferencer
    from intentbev_torch.synthetic import serving_batch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = default_vit_config() if cfg is None else cfg
    g = cfg.grid
    note("sustained: init params")
    inf = StreamingInferencer(cfg, init_params(cfg, seed), dev, transport="chunks",
                              gelu="sigmoid")
    note("sustained: warm the serving path")
    t0 = time.perf_counter()
    pts0, pv0, mp0 = serving_batch(g, batch_size, points_per_sweep, seed)
    draw_ms = (time.perf_counter() - t0) * 1e3  # the producer draws each batch too
    chunks0 = inf.build_chunks(pts0, pv0)
    inf.infer_chunks(chunks0, mp0)
    bytes_per_frame = (sum(np.asarray(a).nbytes for a in chunks0) + mp0.nbytes) / batch_size

    probe = np.zeros(64 << 20, np.uint8)  # H2D rate of this run: best of 3
    h2d = []
    for _ in range(3):
        t0 = time.perf_counter()
        torch.from_numpy(probe).to(dev)
        if cuda:
            torch.cuda.synchronize()
        h2d.append(probe.nbytes / (time.perf_counter() - t0) / 2**20)
    t0 = time.perf_counter()
    inf.build_chunks(pts0, pv0)
    build_sps = batch_size / (time.perf_counter() - t0)
    note(f"sustained: one batch's synthetic draw {draw_ms:.1f} ms, its chunk build "
         f"{batch_size / build_sps * 1e3:.1f} ms (host)")

    def one_pass(pass_idx: int) -> float:
        q: queue.Queue = queue.Queue(maxsize=2)
        copy_stream = torch.cuda.Stream(dev) if cuda else None

        def producer():
            try:
                for i in range(batches):
                    pts, pv, mp = serving_batch(g, batch_size, points_per_sweep,
                                                1000 * pass_idx + i + 1)
                    chunks = inf.build_chunks(pts, pv)
                    if cuda:  # H2D of batch i+1 overlaps the device's work on batch i
                        with torch.cuda.stream(copy_stream):
                            item = (chunks_to_device(chunks, dev),
                                    torch.from_numpy(mp).pin_memory().to(dev, non_blocking=True))
                            ready = torch.cuda.Event()
                            ready.record(copy_stream)
                        q.put((item, ready))
                    else:
                        q.put(((chunks, mp), None))
                q.put(None)
            except Exception as e:  # the consumer raises it
                q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        n, pending = 0, None  # pending: the previous batch's Detections, fetched late
        t0 = time.perf_counter()
        while (item := q.get(timeout=120)) is not None:  # a batch takes seconds at most
            if isinstance(item, Exception):
                raise RuntimeError("sustained: the producer failed") from item
            (chunks, mp), ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(ready)
                for t in (*chunks, mp):  # made on the copy stream, read on this one
                    t.record_stream(stream)
            det = inf.infer_chunks(chunks, mp, blocking=False)
            if pending is not None:
                inf.fetch(pending)
            pending = det
            n += batch_size
        if pending is not None:
            inf.fetch(pending)
        rate = n / (time.perf_counter() - t0)
        thread.join(timeout=60)
        return rate

    rates = []
    for i in range(passes):
        rates.append(one_pass(i))
        note(f"sustained: pass {i + 1}/{passes}: {rates[-1]:.2f} frames/s")
    rates.sort()
    return line("bev_frames_per_sec_sustained", rates[len(rates) // 2],
                passes=[round(r, 2) for r in rates], h2d_MiBps=round(max(h2d), 1),
                transport_MiB_per_frame=round(bytes_per_frame / 2**20, 3),
                host_build_samples_per_sec=round(build_sps, 1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("vit", "cnn"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--cells", action="store_true")
    ap.add_argument("--voxembed", action="store_true")
    ap.add_argument("--cnn_chunks", "--voxembed_cnn", action="store_true", dest="cnn_chunks")
    ap.add_argument("--sustained", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    fill_layout = os.environ.get("INTENTBEV_CNN_FILL_LAYOUT", "")
    if fill_layout == "barrier":
        sys.exit("bench_torch: INTENTBEV_CNN_FILL_LAYOUT=barrier is XLA-only (bench.py's "
                 "jax.lax.optimization_barrier on the fill's output); the port has no "
                 "counterpart: unset it, or take f32")
    fill_dtype = torch.float32 if fill_layout == "f32" else None
    if not torch.cuda.is_available():
        sys.exit("bench_torch: needs a CUDA card")
    b, seed = args.batch, args.seed
    # bench.py's dispatch (main, :387-434)
    if args.cells:
        run_mode("bev_frames_per_sec_per_chip_cells", "vit", batch_size=b, cells=True, seed=seed)
        return
    if args.voxembed:
        run_mode("bev_frames_per_sec_per_chip", "vit", batch_size=b, voxembed=True, seed=seed)
        return
    if args.model == "cnn":
        if args.cnn_chunks:
            run_mode("bev_frames_per_sec_per_chip_cnn_chunks", "cnn", batch_size=b,
                     voxembed=True, seed=seed, fill_dtype=fill_dtype)
        else:
            run_mode("bev_frames_per_sec_per_chip_cnn", "cnn", batch_size=b, seed=seed)
        return
    if args.int8:
        run_mode("bev_frames_per_sec_per_chip_int8", "vit", int8=True, batch_size=b, seed=seed)
        if args.model == "vit":
            return
    if args.model == "vit":
        run_mode("bev_frames_per_sec_per_chip_dense", "vit", batch_size=b, seed=seed)
        return
    if args.sustained:
        run_sustained(batch_size=b, seed=seed)
        return
    run_mode(DEFAULT_LINES[0], "cnn", batch_size=b, seed=seed)
    run_mode(DEFAULT_LINES[1], "cnn", batch_size=b, voxembed=True, seed=seed,
             fill_dtype=fill_dtype)
    run_mode(DEFAULT_LINES[2], "vit", batch_size=b, seed=seed)
    run_sustained(batch_size=b, seed=seed)
    run_mode(DEFAULT_LINES[4], "vit", batch_size=b, voxembed=True, seed=seed)


if __name__ == "__main__":
    main()
