"""Measure attention score ranges on a checkpoint of the PyTorch port (the
twin of ``tools/score_range.py``).

The fixed-max softmax (``unsafe_softmax=True``, the form the bench lines
serve) is exact iff every pre-softmax score s = q.k/sqrt(d) stays inside the
f32 exp range (|s| < ~88). The kernels never hold s in memory, so this tool
runs the model through the attention's plain path (``plain_ops``) with a
hook on its flash entry that reads s from each call's q and k as JAX's
probe does (f32 products, then the scale; every token of a sample is real)
and prints the per-call extrema, the global range and the margin, in the
lines of the JAX tool.

    python tools/score_range_torch.py --ckpt_dir RUN --data_dir SPLIT [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def score_probe(stats: list):
    """Within the block, every call of the plain flash entry appends its
    (min, max) score to ``stats`` and prints it."""
    from intentbev_torch.models import vit as vit_mod

    plain = vit_mod.PLAIN_OPS

    def probed(qkv, num_heads, kv_chunk, unsafe_softmax):
        b, t, d3 = qkv.shape
        dh = d3 // 3 // num_heads
        q, k, _ = vit_mod._split_qkv(qkv)
        lo, hi = float("inf"), float("-inf")
        for i in range(b):  # one sample at a time bounds the [H, T, T] scores
            qh = q[i].float().reshape(t, num_heads, dh).transpose(0, 1)
            kh = k[i].float().reshape(t, num_heads, dh).transpose(0, 1)
            s = torch.matmul(qh, kh.transpose(-1, -2)) * (dh ** -0.5)
            lo, hi = min(lo, float(s.min())), max(hi, float(s.max()))
        stats.append((lo, hi))
        print(f"  attention call {len(stats):2d}: score range [{lo:+.2f}, {hi:+.2f}]",
              flush=True)
        return plain.flash(qkv, num_heads, kv_chunk, unsafe_softmax)

    vit_mod.PLAIN_OPS = plain._replace(flash=probed)
    try:
        yield stats
    finally:
        vit_mod.PLAIN_OPS = plain


def score_range(ckpt_dir: str, data_dir: str, step: int | None = None, batch: int = 2,
                device="cuda") -> tuple[float, float, int]:
    """-> (lowest score, highest score, attention calls) of the checkpoint's
    ViT on the first ``batch`` sequences of the split."""
    from intentbev_torch.bev.rasterize import decode_map_transport
    from intentbev_torch.bev.voxelize import dequantize_points, voxelize_packed
    from intentbev_torch.checkpoint import load_checkpoint
    from intentbev_torch.data.argoverse import (ArgoverseSampleLoader, ScenarioValidator,
                                                build_sequence_index)
    from intentbev_torch.data.pipeline import batch_iterator
    from intentbev_torch.models import IntentNetViT
    from intentbev_torch.train import resolve_device

    dev = resolve_device(device)
    state, cfg = load_checkpoint(ckpt_dir, step=step)
    vit_cfg = dataclasses.replace(cfg.vit, use_flash_attention=True)
    model = IntentNetViT(vit_cfg, cfg.heads, dtype=torch.bfloat16, plain_ops=True)
    model.load_state_dict(state["model"])
    model = model.to(dev).eval()
    g = cfg.grid

    scenarios = ScenarioValidator(data_dir).find_valid_scenarios()
    sequences = build_sequence_index(scenarios, g.lidar_sweeps)
    loader = ArgoverseSampleLoader(g, max_gt=cfg.loss.max_gt_boxes, verbose=False)
    b = next(iter(batch_iterator(sequences[:batch], loader, batch, num_workers=0)))
    pts = dequantize_points(torch.from_numpy(b.points).to(dev))
    lidar = voxelize_packed(pts, torch.from_numpy(b.points_valid).to(dev), g,
                            out_dtype=torch.bfloat16)
    map_bev = decode_map_transport(torch.from_numpy(b.map_bev).to(dev), g.map_channels,
                                   lidar.dtype)
    stats: list = []
    with score_probe(stats), torch.inference_mode():
        model(lidar, map_bev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return min(s[0] for s in stats), max(s[1] for s in stats), len(stats)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    args = ap.parse_args()
    lo, hi, calls = score_range(args.ckpt_dir, args.data_dir, args.step, args.batch,
                                args.device)
    print(f"\nglobal score range over {calls} attention calls: [{lo:+.2f}, {hi:+.2f}]")
    margin = 88.0 - max(abs(lo), abs(hi))
    verdict = "SAFE" if margin > 20 else "MARGINAL" if margin > 0 else "UNSAFE"
    print(f"fixed-max softmax margin to the f32 exp range (+-88): "
          f"{margin:.1f} -> {verdict} for FWD_UNSAFE_SOFTMAX")


if __name__ == "__main__":
    main()
