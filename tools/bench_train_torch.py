"""Training-step benchmark of the PyTorch port at full scale, on one CUDA card.

The twin of ``tools/bench_train.py``, which times the JAX package and stays
as it is. Times ``intentbev_torch.train.make_train_step`` (device voxelize
+ augment + forward/backward + AdamW, or with ``--transport chunks`` the
``voxel_fill`` kernel over host-built chunks) on resident synthetic data
drawn as ``tools/bench_train.py`` draws it, and prints ms/step and
samples/s. The flash backward's form is swept with the JAX package's env
names, which ``main()`` reads once and passes down as the model's
``bwd_fused`` / ``bwd_kv_chunk``:

    python3 tools/bench_train_torch.py                          # fused backward
    INTENTBEV_BWD_FUSED=0 python3 tools/bench_train_torch.py    # split
    INTENTBEV_BWD_FUSED=0 INTENTBEV_BWD_KV_CHUNK=1152 python3 tools/bench_train_torch.py
    python3 tools/bench_train_torch.py --remat                  # TrainConfig.remat_vit_blocks
    python3 tools/bench_train_torch.py --model cnn --transport chunks
    python3 tools/bench_train_torch.py --trace [--top 18]      # device time by kernel group
    python3 tools/bench_train_torch.py --vit-config unfused_ln  # or ln_dense, tiny, tiny_ln_dense,
                                                                # tiny_unfused_ln

``INTENTBEV_BWD_LANE_BLOCK`` and ``INTENTBEV_BWD_BLOCK`` group the TPU
kernels' tiles and change no arithmetic; the port has no counterpart and
reads neither. Beside ``tools/bench_train.py``'s lines it prints the card,
the flash backward's form and the kernel launches of one step. It imports
no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def run(model: str = "vit", transport: str = "points", batch: int = 8, steps: int = 10,
        points_per_sweep: int = 16384, remat: bool = False, trace: bool = False,
        top: int = 18, bwd_fused: bool = True, bwd_kv_chunk: int = 0, device="cuda",
        cfg=None) -> dict:
    """Warm up (first step timed alone, as JAX's compile + first step), then
    time ``steps`` steps with one synchronize at the end; print and return
    ms/step, samples/s, the last loss, the flash backward's form and one
    step's launch counts. ``cfg``: the configuration to cut (default the
    family's default)."""
    import torch

    from intentbev_torch.boxes import generate_anchors
    from intentbev_torch.configs import default_cnn_config, default_vit_config
    from intentbev_torch.data.pipeline import chunk_batch_to_device
    from intentbev_torch.models import build_model, init_params
    from intentbev_torch.ops import _build
    from intentbev_torch.ops.flash_packed import MODEL_PAD_ROWS, bwd_mode, pad_len
    from intentbev_torch.synthetic import chunk_train_batch, train_batch
    from intentbev_torch.train import make_optimizer, make_train_step

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cfg is None:
        cfg = default_vit_config() if model == "vit" else default_cnn_config()
    cfg = dataclasses.replace(cfg, model_family=model, train=dataclasses.replace(
        cfg.train, remat_vit_blocks=remat and model == "vit", transport=transport))
    g = cfg.grid
    net = build_model(cfg, dtype=torch.bfloat16 if cuda else torch.float32,
                      param_dtype=torch.float32, bwd_fused=bwd_fused, bwd_kv_chunk=bwd_kv_chunk)
    net.load_state_dict(init_params(cfg, seed=0))
    net.to(dev)
    anchors = torch.from_numpy(generate_anchors(g, cfg.anchors)).to(dev)
    step = make_train_step(net, cfg, anchors, make_optimizer(net.parameters(), cfg))

    if transport == "chunks":
        t0 = time.perf_counter()
        cb = chunk_train_batch(cfg, batch, points_per_sweep, seed=0)
        print(f"host chunk build: {(time.perf_counter() - t0) * 1000:.1f} ms/batch-{batch} "
              "(loader-thread work, overlaps device compute)", flush=True)
        data = chunk_batch_to_device(cb, dev)
    else:
        data = {k: torch.from_numpy(a).to(dev) for k, a in train_batch(
            g, batch, points_per_sweep, cfg.loss.max_gt_boxes, seed=0).items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    t0 = time.perf_counter()
    m = step(data, gen)
    sync()
    print(f"compile+first step: {time.perf_counter() - t0:.1f}s (kernel library build "
          "included where it was not built)", flush=True)
    _build.reset_launch_counts()
    m = step(data, gen)
    sync()
    counts = {k: n for k, n in _build.launches.items() if n}

    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(data, gen)
    sync()
    dt = (time.perf_counter() - t0) / steps
    loss = float(m["loss"])
    print(f"train step: {dt * 1000:.1f} ms/batch-{batch} ({batch / dt:.1f} samples/s), "
          f"loss={loss:.4f}", flush=True)
    tokens = 1 + cfg.vit.num_patches
    mode = (bwd_mode(pad_len(tokens, MODEL_PAD_ROWS), bwd_fused, bwd_kv_chunk)
            if model == "vit" else None)
    print(f"flash backward: {mode}; launches of one step {counts}", flush=True)
    out = {"ms_per_step": dt * 1000, "samples_per_s": batch / dt, "loss": loss,
           "bwd_mode": mode, "launches_per_step": counts}
    if trace:
        out["groups_ms_calls"] = trace_steps(step, data, gen, steps, top)
    return out


def trace_steps(step, data, gen, steps: int, top: int) -> dict:
    """Profile ``steps`` steps and print device ms and calls by the kernel
    groups of ``tools/profile_torch_slice.py``, the largest ``top``."""
    import json
    import tempfile

    import torch

    from profile_torch_slice import DEVICE_CATS, device_groups

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step(data, gen)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    groups = device_groups([e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e])[0]
    print(f"device time over {steps} steps, by kernel group:")
    for name, (ms, n) in list(groups.items())[:top]:
        print(f"  {ms / steps:9.3f} ms/step  {n // steps:5d} calls/step  {name}")
    return groups


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--points_per_sweep", type=int, default=16384)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--model", default="vit", choices=["vit", "cnn"])
    ap.add_argument("--trace", action="store_true",
                    help="profile the timed steps and print top kernel groups")
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--transport", default="points", choices=["points", "chunks"],
                    help="'chunks' feeds host-built augmented voxel chunks, so the device "
                         "step skips the scatter-max voxelizer")
    ap.add_argument("--vit-config", default="default",
                    choices=("default", "ln_dense", "unfused_ln", "tiny", "tiny_ln_dense",
                             "tiny_unfused_ln"),
                    help="the ViT's kernel switches (tools/profile_torch_slice.py's "
                         "--vit-config): B fuse_ln_dense, C use_fused_layernorm=False, "
                         "ViT-Ti's widths, or ViT-Ti under B or C")
    args = ap.parse_args()
    # the JAX package's knobs, read here once (intentbev/ops/flash_packed.py:73, :84)
    bwd_fused = os.environ.get("INTENTBEV_BWD_FUSED", "1") == "1"
    bwd_kv_chunk = int(os.environ.get("INTENTBEV_BWD_KV_CHUNK", "0"))

    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_train_torch: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0].strip()
    print(f"card: {card}", flush=True)
    cfg = None
    if args.vit_config != "default":
        from intentbev_torch.configs import default_vit_config
        from profile_torch_slice import vit_config

        cfg = vit_config(default_vit_config(), args.vit_config)[0]
        print(f"vit config: {args.vit_config}", flush=True)
    run(args.model, args.transport, args.batch, args.steps, args.points_per_sweep, args.remat,
        args.trace, args.top, bwd_fused, bwd_kv_chunk, cfg=cfg)


if __name__ == "__main__":
    main()
