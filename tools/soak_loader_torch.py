"""Loader scale soak of the PyTorch port (the twin of ``tools/soak_loader.py``,
same flags, same JSON line).

Stress the port's host input pipeline at production scale: many logs,
several loader threads, >= 10k sample loads, the regime where the per-log
LRU caches (poses, GT dataframes, parsed maps; ``data/argoverse.py``
``max_cached_logs``) and the single arrow-reader thread actually cycle.
It measures

- sustained samples/s through ``batch_iterator`` (the train feed,
  collation included), and
- the RSS ceiling over the whole soak (a leak or unbounded-cache detector),

and prints one JSON line. It imports nothing of JAX and does no device
work.

Usage:
    python tools/soak_loader_torch.py --logs 100 --samples 10000 --workers 4
    python tools/soak_loader_torch.py --data /path/to/existing/train  # reuse
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def generate(root: Path, num_logs: int, frames: int, points: int,
             seed: int) -> None:
    from intentbev_torch.data.synthetic import (curved_multi_lane_map_data,
                                                curved_scripted_vehicles, ego_profile,
                                                multi_lane_map_data, scripted_vehicles,
                                                write_synthetic_log)
    from intentbev_torch.precompute_labels import run as precompute_run

    t0 = time.time()
    for i in range(num_logs):
        rng = np.random.default_rng(seed * 7919 + i)
        if i % 2 == 1:  # half curved: a bigger map JSON, a heavier raster
            radius = float(rng.uniform(250.0, 400.0))
            csign = 1.0 if (i // 2) % 2 == 0 else -1.0
            vehicles = curved_scripted_vehicles(rng, radius, csign, frames)
            map_data = curved_multi_lane_map_data(radius, csign)
            ego_xs = np.zeros(frames)
        else:
            crosswalk_x = float(rng.uniform(10.0, 20.0))
            vehicles = scripted_vehicles(rng, crosswalk_x, frames)
            map_data = multi_lane_map_data(crosswalk_x=crosswalk_x)
            ego_xs = ego_profile(rng, "stopped", frames)
        write_synthetic_log(
            root, log_id=f"soak{i:05d}aaaaaaaa", num_frames=frames,
            points_per_sweep=points, seed=seed * 7919 + i,
            vehicles=vehicles, map_data=map_data, ego_xs=ego_xs)
    print(f"generated {num_logs} logs in {time.time()-t0:.1f}s", flush=True)
    precompute_run(str(root.parent), [root.name], force=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", default=None,
                   help="existing split dir; omit to generate a fresh one")
    p.add_argument("--logs", type=int, default=100)
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--points", type=int, default=30000)
    p.add_argument("--samples", type=int, default=10000)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max_cached_logs", type=int, default=32)
    p.add_argument("--transport", default="points",
                   choices=["points", "chunks"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from intentbev_torch.configs import default_vit_config
    from intentbev_torch.data.argoverse import (ArgoverseSampleLoader, ScenarioValidator,
                                                build_sequence_index)
    from intentbev_torch.data.pipeline import batch_iterator

    if args.data is None:
        tmp = tempfile.mkdtemp(prefix="ivb_soak_torch_")
        root = Path(tmp) / "train"
        root.mkdir()
        generate(root, args.logs, args.frames, args.points, args.seed)
    else:
        root = Path(args.data)

    cfg = default_vit_config()
    scenarios = ScenarioValidator(str(root)).find_valid_scenarios()
    sequences = build_sequence_index(scenarios, cfg.grid.lidar_sweeps)
    print(f"{len(scenarios)} logs, {len(sequences)} sequences", flush=True)
    loader = ArgoverseSampleLoader(
        cfg.grid, max_gt=cfg.loss.max_gt_boxes, verbose=False,
        max_cached_logs=args.max_cached_logs)

    rss0 = rss_mb()
    peak = {"rss": rss0}
    stop = threading.Event()

    def monitor():
        while not stop.is_set():
            peak["rss"] = max(peak["rss"], rss_mb())
            time.sleep(0.5)

    mon = threading.Thread(target=monitor, daemon=True)
    mon.start()

    n = 0
    epoch = 0
    t0 = time.perf_counter()
    last = t0
    try:
        while n < args.samples:
            it = batch_iterator(
                sequences, loader, args.batch, shuffle=True,
                seed=args.seed + epoch, num_workers=args.workers,
                augment=cfg.augment, transport=args.transport,
                chunk_capacity=cfg.train.chunk_capacity)
            for batch in it:
                n += batch.gt_boxes.shape[0]
                now = time.perf_counter()
                if now - last > 20.0:
                    print(f"  {n} samples, {n/(now-t0):.1f} samples/s, "
                          f"RSS {rss_mb():.0f} MB", flush=True)
                    last = now
                if n >= args.samples:
                    break
            epoch += 1
    finally:
        stop.set()
        mon.join(timeout=2)
    dt = time.perf_counter() - t0
    peak["rss"] = max(peak["rss"], rss_mb())
    print(json.dumps({
        "metric": "loader_soak_samples_per_sec",
        "value": round(n / dt, 2),
        "unit": "samples/s",
        "samples": n,
        "logs": len(scenarios),
        "workers": args.workers,
        "transport": args.transport,
        "rss_start_mb": round(rss0, 1),
        "rss_peak_mb": round(peak["rss"], 1),
    }), flush=True)


if __name__ == "__main__":
    main()
