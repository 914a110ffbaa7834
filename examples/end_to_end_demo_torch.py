"""End-to-end demo of the PyTorch port on a synthetic Argoverse-2-layout log.

The twin of ``examples/end_to_end_demo.py``: writes a synthetic AV2 log,
precomputes its intention labels, trains a small IntentNetViT (the tiny
config's grid and depth at ViT-Ti's width, which the kernels take) for a
few steps, evaluates it with the reference metric suite, and runs the
streaming stage: a sweep ring on the device voxelized at the current pose,
and the log's city-frame map raster warped to that pose on the device, both
fed to the trained model. It runs on the CUDA card unless ``--device cpu``.

    python examples/end_to_end_demo_torch.py --workdir /tmp/intentbev-demo-torch [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default="/tmp/intentbev-demo-torch")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    p.add_argument("--steps", type=int, default=80)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from intentbev_torch.bev.city_raster import build_city_raster, warp_city_to_ego_device
    from intentbev_torch.bev.rasterize import parse_map_json
    from intentbev_torch.checkpoint import load_checkpoint
    from intentbev_torch.configs import tiny_test_config
    from intentbev_torch.data.argoverse import ScenarioValidator, build_sequence_index
    from intentbev_torch.data.streaming import make_ring, push_sweep, voxelize_ring
    from intentbev_torch.data.synthetic import write_synthetic_log
    from intentbev_torch.evaluate import evaluate
    from intentbev_torch.geometry import quat_to_yaw
    from intentbev_torch.parallel import StreamingInferencer
    from intentbev_torch.precompute_labels import run as precompute_labels
    from intentbev_torch.train import resolve_device, train

    device = resolve_device(args.device)
    work = Path(args.workdir)
    shutil.rmtree(work, ignore_errors=True)
    split = work / "train"
    split.mkdir(parents=True)

    print("== 1. synthetic AV2 log")
    write_synthetic_log(
        split, log_id="demolog00000001", num_frames=12, seed=0, ego_speed=0.0,
        vehicles=[
            {"start": (4.0, 1.0), "velocity": (0.0, 0.0), "yaw": 0.0,
             "category": "REGULAR_VEHICLE"},
            {"start": (-1.0, -4.0), "velocity": (0.0, 0.0), "yaw": 1.57,
             "category": "REGULAR_VEHICLE"},
        ])

    print("== 2. intention label precompute")
    precompute_labels(str(work), ["train"], force=True)

    print("== 3. train IntentNetViT (the tiny config's grid and depth at ViT-Ti's width)")
    cfg = tiny_test_config()
    grid = dataclasses.replace(cfg.grid, lidar_sweeps=3)
    # the kernels take D 192 or 384 in bf16: ViT-Ti's 3 heads of 64 (the JAX
    # demo's tiny width, 32, runs on the plain versions only)
    vit = dataclasses.replace(
        cfg.vit, lidar_input_channels=grid.lidar_total_channels, drop_path_rate=0.0,
        embed_dim=192, num_heads=3, use_flash_attention=True)
    tr = dataclasses.replace(cfg.train, batch_size=4, num_epochs=10, learning_rate=3e-4,
                             log_every_steps=10, checkpoint_every_steps=10_000,
                             compute_dtype="bfloat16" if device.type == "cuda" else "float32")
    cfg = dataclasses.replace(cfg, grid=grid, vit=vit, train=tr)
    train(cfg, str(split), str(work / "run"), num_workers=2, max_steps=args.steps,
          device=device)

    print("== 4. evaluate (reference metric suite)")
    evaluate(str(work / "run"), str(split), num_workers=2, device=device)

    print("== 5. streaming: sweep ring and city-raster map on the device")
    seq = build_sequence_index(ScenarioValidator(str(split), verbose=False)
                               .find_valid_scenarios(), grid.lidar_sweeps)[0]
    rng = np.random.default_rng(0)
    ring = make_ring(grid.lidar_sweeps, 1024, device)
    for _ in range(grid.lidar_sweeps):
        pts = np.stack([
            rng.uniform(-6, 8, 1024), rng.uniform(-6, 6, 1024),
            rng.uniform(-1.5, 1.0, 1024), rng.uniform(0, 255, 1024)], 1).astype(np.float32)
        ring = push_sweep(ring, torch.from_numpy(pts), torch.ones(1024, dtype=torch.bool),
                          torch.eye(4))
    bev = voxelize_ring(ring, torch.eye(4), grid)
    print(f"ring BEV: {tuple(bev.shape)}, occupied cells: {int((bev > 0).sum())}")

    city = build_city_raster(parse_map_json(seq.map_json_path), grid)
    raster = torch.from_numpy(city.raster).to(device)
    pose = {"tx_m": 0.0, "ty_m": 0.0, "qx": 0.0, "qy": 0.0, "qz": 0.0, "qw": 1.0}
    yaw = float(quat_to_yaw(pose["qx"], pose["qy"], pose["qz"], pose["qw"]))
    map_bev = warp_city_to_ego_device(raster, city.origin_xy,
                                      torch.tensor([pose["tx_m"], pose["ty_m"], yaw]), grid)
    print(f"warped map: {tuple(map_bev.shape)}, drivable cells: {int(map_bev[..., 0].sum())}")

    state, ckpt_cfg = load_checkpoint(work / "run")
    inf = StreamingInferencer(ckpt_cfg, state["model"], device)
    with torch.inference_mode():
        det = inf.postprocess(*inf.model(bev[None].to(inf.dtype), map_bev[None]))
    print(f"ring + map detections: {int(det.valid.sum())} boxes")
    print("demo complete.")


if __name__ == "__main__":
    main()
