"""Sustained offline serving on the chunk transport with the PyTorch port
(the twin of ``examples/serve_chunks.py``).

Drives ``StreamingInferencer(transport="chunks")``, the flagship serving
configuration, with the serving switches ``bench.py`` sets by environment
set here through the config and the harness: the forward's fixed-max
softmax (``fwd_kv_chunk=1152, unsafe_softmax=True``, as ``bench_torch.py``'s
ViT lines) and the sigmoid GELU. A host producer thread builds placement
chunks (C++ ``ib_build_chunks``) for upcoming batches into a bounded queue
while the device runs the current one. It prints three rates:

- host chunk-build rate (the transport's preparation, samples/s),
- device-only inference rate (inputs staged on the device, dispatch
  queued, one fetch at the end),
- sustained pipeline rate (frames in -> detections out, wall clock, the
  host build and the host-to-device copies included).

    python examples/serve_chunks_torch.py --batches 8 --batch 8 [--tiny --device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def serve(batch: int = 8, batches: int = 8, points_per_sweep: int = 16384, tiny: bool = False,
          iters: int = 10, device="cuda", seed: int = 0) -> dict:
    """Print the three rates and return them (frames or samples a second)
    with the last batch's detection count."""
    from intentbev_torch.bev.rasterize import pack_map_channels
    from intentbev_torch.configs import default_vit_config, tiny_test_config
    from intentbev_torch.models import init_params
    from intentbev_torch.ops.voxel_embed import chunks_to_device
    from intentbev_torch.parallel import StreamingInferencer
    from intentbev_torch.train import resolve_device

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    cfg = tiny_test_config() if tiny else default_vit_config()
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(  # bench.py's serving switches
        cfg.vit, use_flash_attention=True, fwd_kv_chunk=1152, unsafe_softmax=True))
    g = cfg.grid
    inf = StreamingInferencer(cfg, init_params(cfg, seed), dev, transport="chunks",
                              gelu="sigmoid")
    b, s, p = batch, g.lidar_sweeps, points_per_sweep

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def random_batch(batch_seed):
        r = np.random.default_rng(batch_seed)
        pts = np.zeros((b, s, p, 4), np.float32)
        pts[..., 0] = r.uniform(-g.x_range_m / 4, g.x_range_m * 3 / 4, pts.shape[:3])
        pts[..., 1] = r.uniform(-g.y_range_m / 2, g.y_range_m / 2, pts.shape[:3])
        pts[..., 2] = r.uniform(g.z_min, g.z_max - 0.1, pts.shape[:3])
        pts[..., 3] = r.uniform(0, 255, pts.shape[:3])
        pv = np.ones((b, s, p), bool)
        # the bit-packed u8 map transport, the loader's encoding
        mp = pack_map_channels(r.uniform(0, 1, (b, g.height_px, g.width_px, g.map_channels))
                               < 0.05)
        return pts, pv, mp

    # host chunk-build rate
    pts0, pv0, mp0 = random_batch(0)
    inf.build_chunks(pts0, pv0)  # warm the native library
    t0 = time.perf_counter()
    chunks0 = inf.build_chunks(pts0, pv0)
    t_build = time.perf_counter() - t0
    build_sps = b / t_build
    print(f"host chunk build: {t_build / b * 1000:.1f} ms/sample "
          f"({build_sps:.0f} samples/s on this host)", flush=True)

    # device-only rate: inputs staged, dispatch queued, one fetch at the end
    inf.infer_chunks(chunks0, mp0)  # warm-up: the kernel build, cuBLAS handles
    staged = chunks_to_device(chunks0, dev)
    mp_dev = torch.from_numpy(mp0).to(dev)
    sync()
    t0 = time.perf_counter()
    det_dev = None
    for _ in range(iters):
        det_dev = inf.infer_chunks(staged, mp_dev, blocking=False)
    inf.fetch(det_dev)  # one stream: this drains every iteration
    device_fps = b * iters / (time.perf_counter() - t0)
    print(f"device inference: {device_fps:.1f} frames/s "
          f"(queued dispatch; one detection fetch at the end)", flush=True)

    # sustained pipeline: a producer thread builds, this thread infers
    q: queue.Queue = queue.Queue(maxsize=2)

    def producer():
        try:
            for i in range(batches):
                pts, pv, mp = random_batch(seed + i + 1)
                q.put((inf.build_chunks(pts, pv), mp))
            q.put(None)
        except Exception as e:  # the consumer raises it
            q.put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    n, det = 0, None  # double buffer: fetch batch i while i+1 computes
    t0 = time.perf_counter()
    while (item := q.get(timeout=300)) is not None:
        if isinstance(item, Exception):
            raise RuntimeError("serve_chunks: the producer failed") from item
        chunks, mp = item
        det_dev = inf.infer_chunks(chunks, mp, blocking=False)
        if det is not None:
            inf.fetch(det)
        det = det_dev
        n += b
    det = inf.fetch(det)
    sustained_fps = n / (time.perf_counter() - t0)
    thread.join(timeout=60)
    print(f"sustained pipeline: {sustained_fps:.1f} frames/s over {n} frames "
          f"(incl. host build + host->device transfer)", flush=True)
    detections = int(det.valid.sum())
    print(f"last batch: {detections} detections across {b} frames", flush=True)
    return {"host_build_samples_per_sec": build_sps, "device_frames_per_sec": device_fps,
            "sustained_frames_per_sec": sustained_fps, "detections": detections}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--points_per_sweep", type=int, default=16384)
    p.add_argument("--tiny", action="store_true", help="tiny config (for CPU smoke runs)")
    p.add_argument("--iters", type=int, default=10, help="device-only timing iterations")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    args = p.parse_args(argv)
    serve(args.batch, args.batches, args.points_per_sweep, args.tiny, args.iters, args.device)


if __name__ == "__main__":
    main()
