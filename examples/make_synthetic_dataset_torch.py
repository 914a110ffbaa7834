"""Build a multi-log, full-size synthetic AV2-layout dataset with the
PyTorch port (the twin of ``examples/make_synthetic_dataset.py``, same
flags, same files).

Produces train/ and val/ splits of scripted scenes whose vehicle tracks
cover every intention class the heuristic labeler can assign: keep-lane
movers, parked cars, stopping cars, left/right turners, lane changers and
the OTHER signatures (the scene scripts live in
``intentbev_torch/data/synthetic.py``), then runs the port's intent-label
precompute over both splits, so the result trains with
``python -m intentbev_torch.train`` at the full flagship geometry. It
imports nothing of JAX and does no device work.

Usage:
    python examples/make_synthetic_dataset_torch.py --out /data/synth \
        --train_logs 6 --val_logs 2 --frames 40 --points 30000 [--hard]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from intentbev_torch.data.synthetic import (  # noqa: E402
    curved_multi_lane_map_data,
    curved_scripted_vehicles,
    ego_profile,
    inject_label_noise,
    multi_lane_map_data,
    scripted_vehicles,
    write_synthetic_log,
)
from intentbev_torch.precompute_labels import run as precompute_run  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--train_logs", type=int, default=10)
    p.add_argument("--val_logs", type=int, default=3)
    p.add_argument("--frames", type=int, default=50)
    p.add_argument("--points", type=int, default=30000,
                   help="LiDAR points per sweep (real AV2 is ~100k)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hard", action="store_true",
                   help="hard ViT-vs-CNN benchmark preset (VERDICT r4 "
                        "missing #4): ray-shadow occlusion (annotations "
                        "persist for shadowed cars), unannotated off-lane "
                        "clutter, HALF the logs on curved corridors "
                        "(keep-laners curve too — map context required), "
                        "and train-split label noise")
    p.add_argument("--occlusion", type=float, default=None,
                   help="shadowed-point drop probability "
                        "(default 0.9 with --hard, 0 otherwise)")
    p.add_argument("--clutter", type=int, default=None,
                   help="clutter objects per log "
                        "(default 14 with --hard, 0 otherwise)")
    p.add_argument("--label_noise", type=float, default=None,
                   help="train-split intent label flip rate "
                        "(default 0.15 with --hard, 0 otherwise)")
    args = p.parse_args(argv)

    occl = args.occlusion if args.occlusion is not None else (
        0.9 if args.hard else 0.0)
    clut = args.clutter if args.clutter is not None else (
        14 if args.hard else 0)
    noise = args.label_noise if args.label_noise is not None else (
        0.15 if args.hard else 0.0)

    root = Path(args.out)
    t0 = time.time()
    for split, count in (("train", args.train_logs), ("val", args.val_logs)):
        split_dir = root / split
        split_dir.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            seed = args.seed * 1000 + (0 if split == "train" else 500) + i
            rng = np.random.default_rng(seed)
            # hard preset: every other log is a curved corridor (radius
            # 250-400 m, alternating bend direction; stationary ego —
            # the pose writer scripts ego motion along +x only, which is
            # wrong on an arc)
            curved = args.hard and i % 2 == 1
            if curved:
                radius = float(rng.uniform(250.0, 400.0))
                csign = 1.0 if (i // 2) % 2 == 0 else -1.0
                vehicles = curved_scripted_vehicles(
                    rng, radius, csign, args.frames)
                map_data = curved_multi_lane_map_data(radius, csign)
                ego_xs = np.zeros(args.frames)
                mode = f"curved R={radius:.0f} sign={csign:+.0f}"
                clutter_arc = (radius, csign)
            else:
                # ~2/3 stopped, ~1/3 cruise ego (see ego_profile
                # docstring); the pattern puts both modes in every split
                mode = "stopped" if i % 3 < 2 else "cruise"
                if mode == "stopped":
                    crosswalk_x = float(rng.uniform(10.0, 20.0))
                else:
                    crosswalk_x = float(rng.uniform(25.0, 45.0))
                vehicles = scripted_vehicles(rng, crosswalk_x, args.frames)
                if mode == "cruise":
                    # one co-mover at ego speed: zero relative motion, the
                    # ego-relative heuristic labels it PARKED — a visually
                    # consistent example of the reference's label semantics
                    vehicles.append({
                        "start": (float(rng.uniform(8.0, 25.0)), 1.75),
                        "velocity": (5.0, 0.0), "yaw": 0.0,
                    })
                map_data = multi_lane_map_data(crosswalk_x=crosswalk_x)
                ego_xs = ego_profile(rng, mode, args.frames)
                clutter_arc = None
            log_dir = write_synthetic_log(
                split_dir,
                log_id=f"{split}log{i:04d}aaaaaaaa",
                num_frames=args.frames,
                points_per_sweep=args.points,
                seed=seed,
                vehicles=vehicles,
                map_data=map_data,
                ego_xs=ego_xs,
                occlusion_drop=occl,
                num_clutter=clut,
                clutter_arc=clutter_arc,
            )
            print(f"wrote {log_dir} ({mode})", flush=True)
    print(f"logs written in {time.time()-t0:.1f}s; precomputing intent labels...",
          flush=True)
    precompute_run(str(root), ["train", "val"], force=True)
    if noise > 0.0:
        flips = inject_label_noise(root / "train", noise, seed=args.seed)
        print(f"label noise {noise:.0%} on train: "
              f"{sum(flips.values())} labels flipped across {len(flips)} logs")
    print(f"done in {time.time()-t0:.1f}s total")


if __name__ == "__main__":
    main()
