"""Where a serving request's, or a training step's, time goes in the
PyTorch port, on one CUDA card.

    python3 tools/profile_torch_slice.py [--requests 4] [--out chiprun_out/profile_slice]
    python3 tools/profile_torch_slice.py --train [--out DIR]

Serving: drives ``intentbev_torch``'s ``StreamingInferencer``
(``default_vit_config()`` at full width and depth, seeded random weights,
bf16, the serving sigmoid GELU) over synthetic batches of 8 drawn as
``bench.py`` draws them, and reports:

- per request, the wall time of each stage: host chunk build; H2D copy and
  forward, synchronized; post-processing (decode, top-k, fixpoint NMS) and
  the copy of the Detections to the host;
- from one ``torch.profiler`` trace of one whole request: device time per
  kernel group, the device's busy time (the union of its kernel, copy and
  memset intervals), and its idle share of the request and of the forward.

``--train``: drives ``make_train_step`` (the same model with f32 master
weights, erf GELU, drop-path 0.1, batch 8 drawn as ``tools/bench_train.py``
draws it, resident on the device) and reports the wall time of each step
(synchronized) and, from one traced step, the device time per kernel
group, the busy time and idle share of the step, and the device time of
the kernels each of its spans launched (inputs, forward, loss, backward,
optimizer; matched to their launch by the trace's correlation ids, as the
device runs behind the host).

It prints a summary and writes ``profile_slice.json`` (``profile_train.json``)
and the Chrome trace ``trace.json`` under ``--out`` (for ``--train`` by
default a ``profile_train`` directory beside the serving default). It
imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# kernel-name substring -> group, first match wins
GROUPS = (
    ("flash_fwd_kernel", "flash_packed"),
    ("flash_bwd", "flash_packed_bwd"),
    ("fused_ln_mlp_kernel", "fused_ln_mlp (serving or train forward)"),
    ("ln_mlp_bwd_rows", "fused_ln_mlp_bwd (row kernel)"),
    ("gemm_at_b", "fused_ln_mlp_bwd (dW kernel)"),
    ("sum_partials", "column partial sums (LN, LN+MLP backward)"),
    ("layernorm_kernel", "layernorm"),
    ("layernorm_train_kernel", "layernorm_train"),
    ("layernorm_bwd_kernel", "layernorm_bwd"),
    ("voxel_embed_kernel", "voxel_embed"),
    ("scatter", "scatter (voxelizer, assignment)"),
    ("multi_tensor_apply", "optimizer (AdamW, foreach)"),
    ("fprop", "conv (map embed, fusion, heads)"),  # cuDNN's implicit-GEMM convs
    ("conv", "conv (map embed, fusion, heads)"),
    ("cudnn", "conv (map embed, fusion, heads)"),
    ("gemm", "gemm (qkv, proj, adapters)"),
    ("nvjet", "gemm (qkv, proj, adapters)"),  # cuBLAS's Hopper GEMMs
    ("cutlass", "gemm (qkv, proj, adapters)"),
    ("sort", "sort / top-k"),
    ("topk", "sort / top-k"),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def group_of(name: str) -> str:
    low = name.lower()
    for key, group in GROUPS:
        if key.lower() in low:
            return group
    return "other (elementwise, reductions, NMS)"


def union_us(intervals, lo=float("-inf"), hi=float("inf")) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_groups(dev):
    """Device time (ms) and calls per kernel group and per kernel name."""
    groups = collections.defaultdict(lambda: [0.0, 0])
    names = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        g = group_of(e["name"]) if e["cat"] == "kernel" else e["cat"]
        groups[g][0] += e["dur"] / 1e3
        groups[g][1] += 1
        names[e["name"][:90]][0] += e["dur"] / 1e3
        names[e["name"][:90]][1] += 1
    return (dict(sorted(groups.items(), key=lambda kv: -kv[1][0])),
            dict(sorted(names.items(), key=lambda kv: -kv[1][0])[:15]))


def profile_train(args, card) -> None:
    import torch

    from intentbev_torch.boxes import generate_anchors
    from intentbev_torch.configs import default_vit_config
    from intentbev_torch.models import IntentNetViT, init_params
    from intentbev_torch.synthetic import train_batch
    from intentbev_torch.train import make_optimizer, make_train_step

    cfg = default_vit_config()
    model = IntentNetViT(cfg.vit, cfg.heads, dtype=torch.bfloat16, param_dtype=torch.float32)
    model.load_state_dict(init_params(cfg, seed=0))
    model.to("cuda")
    anchors = torch.from_numpy(generate_anchors(cfg.grid, cfg.anchors)).to("cuda")
    step = make_train_step(model, cfg, anchors, make_optimizer(model.parameters(), cfg))
    batch = {k: torch.from_numpy(a).to("cuda") for k, a in train_batch(
        cfg.grid, 8, 16384, cfg.loss.max_gt_boxes, seed=0).items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(batch, gen)  # warm-up
    step_ms = []
    for _ in range(args.requests):
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / "trace.json"
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("train/step"):
            step(batch, gen)
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))

    events = json.loads(trace_path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name", "").startswith("train/")}
    lo, hi = spans.pop("train/step")
    busy = union_us([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi) / 1e3
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    span_dev = collections.defaultdict(float)
    for e in dev:
        t = launched.get(e.get("args", {}).get("correlation"))
        span = next((k for k, (a, b) in spans.items() if t is not None and a <= t < b),
                    "outside the spans")
        span_dev[span] += e["dur"] / 1e3
    groups, names = device_groups(dev)
    result = {
        "card": card,
        "step_ms": step_ms,
        "profiled_step": {
            "step_window_ms": (hi - lo) / 1e3,
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy * 1e3 / (hi - lo),
            "span_host_ms": {k: (b - a) / 1e3 for k, (a, b) in spans.items()},
            "span_device_ms": dict(span_dev),
            "groups_ms_calls": groups,
            "top_kernels_ms_calls": names,
        },
    }
    (out / "profile_train.json").write_text(json.dumps(result, indent=1))
    print(f"card: {card}")
    print("step ms (synchronized): " + " ".join(f"{x:.1f}" for x in step_ms))
    p = result["profiled_step"]
    print(f"profiled step: {p['step_window_ms']:.2f} ms, device busy "
          f"{p['device_busy_ms']:.2f} ms, idle share {p['device_idle_share']:.4f}")
    for k, w in p["span_host_ms"].items():
        print(f"span {k}: host {w:.2f} ms, device time it launched "
              f"{p['span_device_ms'].get(k, 0.0):.2f} ms")
    for g, (ms, n) in p["groups_ms_calls"].items():
        print(f"  {g}: {ms:.3f} ms over {n} calls")
    print(f"wrote {out / 'profile_train.json'} and {trace_path}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=4,
                    help="timed requests (serving) or steps (--train)")
    ap.add_argument("--train", action="store_true", help="profile a training step")
    ap.add_argument("--out", default="chiprun_out/profile_slice")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0].strip()
    if args.train:
        if args.out == ap.get_default("out"):
            args.out = str(Path(args.out).with_name("profile_train"))
        profile_train(args, card)
        return

    from intentbev_torch.configs import default_vit_config
    from intentbev_torch.models import init_params
    from intentbev_torch.parallel import StreamingInferencer
    from intentbev_torch.synthetic import serving_batch

    cfg = default_vit_config()
    batch = 8
    inf = StreamingInferencer(cfg, init_params(cfg, seed=0), "cuda", transport="chunks",
                              gelu="sigmoid")
    requests = [serving_batch(cfg.grid, batch, 16384, seed=s)
                for s in range(args.requests + 1)]

    def request(pts, valid, mp, stamps):
        with torch.profiler.record_function("host_chunk_build"):
            t0 = time.perf_counter()
            chunks = inf.build_chunks(pts, valid)
            t1 = time.perf_counter()
        with torch.profiler.record_function("forward"):
            logits = inf.logits(chunks, mp)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        with torch.profiler.record_function("postprocess"):
            inf.fetch(inf.postprocess(*logits))
            t3 = time.perf_counter()
        stamps.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))

    warm = []
    request(*requests[0], warm)  # warm-up: cuBLAS/cuDNN handles, allocator
    stages = []
    for r in requests[1:]:
        request(*r, stages)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / "trace.json"
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        request(*requests[1], [])
    prof.export_chrome_trace(str(trace_path))

    events = json.loads(trace_path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") in ("host_chunk_build", "forward", "postprocess")}
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    req_lo, req_hi = spans["host_chunk_build"][0], spans["postprocess"][1]
    fwd_lo, fwd_hi = spans["forward"]
    busy_req = union_us(intervals, req_lo, req_hi)
    busy_fwd = union_us(intervals, fwd_lo, fwd_hi)

    groups, names = device_groups(dev)
    result = {
        "card": card,
        "requests": len(stages),
        "stage_ms": {k: [s[i] for s in stages]
                     for i, k in enumerate(("host_chunk_build", "h2d_forward_sync",
                                            "postprocess_fetch"))},
        "profiled_request": {
            "window_ms": {k: (hi - lo) / 1e3 for k, (lo, hi) in spans.items()},
            "device_busy_ms": {"request": busy_req / 1e3, "forward": busy_fwd / 1e3},
            "device_idle_share": {"request": 1 - busy_req / (req_hi - req_lo),
                                  "forward": 1 - busy_fwd / (fwd_hi - fwd_lo)},
            "groups_ms_calls": groups,
            "top_kernels_ms_calls": names,
        },
    }
    (out / "profile_slice.json").write_text(json.dumps(result, indent=1))

    print(f"card: {card}")
    for k, v in result["stage_ms"].items():
        print(f"stage {k}: " + " ".join(f"{x:.1f}" for x in v) + " ms")
    p = result["profiled_request"]
    print("profiled request windows (ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in p["window_ms"].items()))
    print(f"device busy: request {p['device_busy_ms']['request']:.2f} ms, forward "
          f"{p['device_busy_ms']['forward']:.2f} ms; idle share: request "
          f"{p['device_idle_share']['request']:.4f}, forward "
          f"{p['device_idle_share']['forward']:.4f}")
    for g, (ms, n) in p["groups_ms_calls"].items():
        print(f"  {g}: {ms:.3f} ms over {n} calls")
    print(f"wrote {out / 'profile_slice.json'} and {trace_path}")


if __name__ == "__main__":
    main()
