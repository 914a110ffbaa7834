"""Where a serving request's, or a training step's, time goes in the
PyTorch port, on one CUDA card.

    python3 tools/profile_torch_slice.py [--model vit|cnn] [--requests 4] [--out DIR]
    python3 tools/profile_torch_slice.py --vit-config {int8,ln_dense,unfused_ln,patch_embed,tiny,tiny_int8,tiny_patch_embed}
    python3 tools/profile_torch_slice.py --train [--model vit|cnn] [--out DIR]
    python3 tools/profile_torch_slice.py --train --vit-config {ln_dense,unfused_ln,tiny,tiny_ln_dense}
    python3 tools/profile_torch_slice.py --experimental [--out DIR]

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
device runs behind the host). The dW and partial-sum kernels that several
backward entries share are also split by the row kernel launched before
them on their stream (row 14's, row 7's, the LayerNorm backward's).

``--vit-config`` serves one of the ViT's other serving configurations
(``intentbev_torch.parallel.VIT_SERVING_VARIANTS``: W8A8 ``int8``, the
``bench.py --int8`` line, and ``patch_embed`` over the points transport,
whose host stage is empty; ``ln_dense`` and ``unfused_ln`` over chunks), so
that device time splits by the groups of its kernels. With ``--train`` it
profiles the training step under ``ln_dense`` or ``unfused_ln`` (the
switches of those configurations; the step's points transport). ``tiny``
is the default configuration at ViT-Ti's widths (embed 192, 3 heads of 64,
as ``intentbev/import_torch.py:235`` reads a timm ``vit_tiny`` checkpoint),
served over chunks and trained as the default is; its attention runs the
BHTD kernels. ``tiny_ln_dense`` is ViT-Ti under ``ln_dense``'s switches (the
LN + dense pair at D=192), ``tiny_int8`` ViT-Ti under ``int8``'s (the W8A8
MLP at D=192, serving only), ``tiny_patch_embed`` ViT-Ti under
``patch_embed``'s (the dense patch embed at D=192, serving only).

``--model cnn`` profiles IntentNetCNN (``default_cnn_config()``, random
seeded weights with BatchNorm statistics from a synthetic batch,
``synthetic.calibrated_params``) the same way: serving over the chunk transport (the ``voxel_fill`` kernel, then the
CNN), training over the chunk train transport (``chunk_train_batch``).
Device time is grouped as the fill, the first conv (the 290 -> 160 5x5/s2
conv and the 1x1/s2 projection beside it, both reading the fill's
channels-last output; their forward kernels are found through a profiler
span), the other convs, BatchNorm's elementwise work (forward kernels
launched in a BN span), and the rest by kernel name. A copy kernel inside
the first-conv span would be cuDNN relaying out the 290-channel input. The
first conv is also timed alone with CUDA events, on the fill's output as
the model reads it and on an NCHW-contiguous copy of it.

``--experimental`` traces one call of each library op of
``intentbev_torch.ops.experimental`` (no model path calls them) at
``chip_smoke.py`` phase 13's shapes: the int8 attention over [8, 4608, 384]
with 4501 real keys at 6 heads of 64 and 12 of 32, and
``fused_dense_residual`` over the same rows (W [384, 384], a per-sample
drop-path gate), forward and backward through autograd, beside the
model's unfused Linear, gate and residual on the same tensors, and reports
the device time of each kernel each op launched (its pre-pass, row
kernels, column sums and split-K GEMM; cuBLAS's GEMMs) in
``profile_experimental.json``.

It prints a summary and writes ``profile_slice.json`` (``profile_train.json``)
and the Chrome trace ``trace.json`` under ``--out`` (by default
directories ``profile_slice``, ``profile_train``, ``profile_cnn_slice`` or
``profile_cnn_train`` side by side; ``profile_slice_<config>`` or
``profile_train_<config>`` for ``--vit-config``). It imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# profiler span (see instrument_cnn) -> group of the kernels launched in it
SPAN_GROUPS = {"cnn/first_conv": "first conv (290->160 5x5/s2 + 1x1/s2 projection)",
               "cnn/bn": "BatchNorm elementwise (forward)"}
# kernel-name substring -> group, first match wins
GROUPS = (
    ("voxel_fill_kernel", "voxel_fill"),
    ("flash_fwd_kernel", "flash forward (packed or BHTD)"),
    ("flash_bwd_dkdv", "flash backward dk/dv (packed or BHTD)"),
    ("flash_bwd_dq", "flash backward dq (packed or BHTD)"),
    ("mlp_int8_fwd_kernel", "fused_mlp_int8"),
    ("fused_mlp_int8_kernel", "fused_mlp_int8"),  # its mma.sync form, on older trees
    ("ln_mlp_fwd_kernel<384, 0, false, false>", "fused_mlp (no LN)"),
    ("ln_mlp_fwd_kernel<384, 1, false, false>", "fused_mlp (no LN)"),
    ("ln_mlp_fwd_kernel", "fused_ln_mlp (serving or train forward)"),
    ("ln_dense_fwd_kernel", "fused_ln_dense"),
    ("fused_ln_dense_kernel", "fused_ln_dense"),  # its mma.sync form, on older trees
    ("patch_embed_kernel", "patch_embed"),
    ("ln_mlp_bwd_kernel<384, false>", "fused_mlp_bwd (row kernel)"),
    ("ln_mlp_bwd_kernel", "fused_ln_mlp_bwd (row kernel)"),
    ("ln_dense_bwd_kernel", "fused_ln_dense_bwd (row kernel)"),
    ("ln_dense_bwd_rows", "fused_ln_dense_bwd (row kernel)"),  # its mma.sync form
    ("dw_gemm_kernel", "LN+MLP / MLP / LN+dense backward dW (wgmma)"),
    ("col_sums_kernel", "LN+MLP / MLP / LN+dense backward partial sums"),
    ("split_sums_kernel", "LN+MLP / MLP / LN+dense backward partial sums"),
    ("gemm_at_b", "dW kernel gemm_at_b (projection backward)"),
    ("sum_partials", "column partial sums (LN, projection backward)"),
    ("layernorm_kernel", "layernorm"),
    ("layernorm_train_kernel", "layernorm_train"),
    ("layernorm_bwd_kernel", "layernorm_bwd"),
    ("voxel_hits_kernel", "voxel_embed (hit list)"),
    ("voxel_gather_kernel", "voxel_embed (gather)"),
    ("voxel_embed_kernel", "voxel_embed"),  # its one-kernel form, on older trees
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
# kernels that several backward entries launch after their row kernel:
# their device time is also split by that row kernel's group (shared_by_owner)
SHARED = ("dw_gemm_kernel", "col_sums_kernel", "split_sums_kernel", "gemm_at_b",
          "sum_partials")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TINY = dict(embed_dim=192, num_heads=3)  # ViT-Ti (intentbev/import_torch.py:235)


def vit_config(cfg, name: str):
    """(config, transport) of ``--vit-config name``: a serving variant's
    switches, ``tiny``, ViT-Ti's widths over chunks, or ``tiny_ln_dense`` /
    ``tiny_int8`` / ``tiny_patch_embed``, ViT-Ti under B's / A's / D's
    switches."""
    from intentbev_torch.parallel import vit_serving_variant

    if name.startswith("tiny"):
        cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, **TINY))
        return (cfg, "chunks") if name == "tiny" else vit_serving_variant(cfg, name[5:])
    return vit_serving_variant(cfg, name)


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


def launch_spans(events, dev, prefix):
    """For each device event, the innermost ``prefix`` span (by the host
    time of its launch, matched through the trace's correlation ids) that
    launched it, or None."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name", "").startswith(prefix)]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = []
    for e in dev:
        t = launched.get(e.get("args", {}).get("correlation"))
        inside = [(b - a, name) for a, b, name in spans if t is not None and a <= t < b]
        out.append(min(inside)[1] if inside else None)
    return out


def span_kernels(dev, span_of) -> dict:
    """Device ms and calls per kernel name inside each span of
    :data:`SPAN_GROUPS` (what the first conv really launched)."""
    out = collections.defaultdict(lambda: collections.defaultdict(lambda: [0.0, 0]))
    for e, span in zip(dev, span_of):
        if span in SPAN_GROUPS and span != "cnn/bn":
            out[span][e["name"][:90]][0] += e["dur"] / 1e3
            out[span][e["name"][:90]][1] += 1
    return {k: dict(v) for k, v in out.items()}


def host_api_ms(events, lo, hi) -> dict:
    """Host ms and calls per CUDA runtime/driver call inside [lo, hi), the
    largest 8: where the host waits (synchronize, allocation, copies)."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and lo <= e["ts"] < hi:
            out[e["name"]][0] += e.get("dur", 0) / 1e3
            out[e["name"]][1] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0])[:8])


def device_groups(dev, span_of=None):
    """Device time (ms) and calls per kernel group and per kernel name;
    ``span_of`` (one span name or None per event) overrides the name group
    of the kernels launched in a span of :data:`SPAN_GROUPS`."""
    groups = collections.defaultdict(lambda: [0.0, 0])
    names = collections.defaultdict(lambda: [0.0, 0])
    for i, e in enumerate(dev):
        g = group_of(e["name"]) if e["cat"] == "kernel" else e["cat"]
        if span_of is not None and span_of[i] in SPAN_GROUPS and e["cat"] == "kernel":
            g = SPAN_GROUPS[span_of[i]]
        groups[g][0] += e["dur"] / 1e3
        groups[g][1] += 1
        names[e["name"][:90]][0] += e["dur"] / 1e3
        names[e["name"][:90]][1] += 1
    return (dict(sorted(groups.items(), key=lambda kv: -kv[1][0])),
            dict(sorted(names.items(), key=lambda kv: -kv[1][0])[:15]))


def shared_by_owner(dev) -> dict:
    """Device ms and calls of each :data:`SHARED` kernel group by the group of
    the kernel launched last before it on the same stream: an entry's row
    kernel, since an entry launches its row kernel, dW product and sums
    back to back (row 14's, row 7's and the LayerNorm backward's share the
    dW and sums kernels)."""
    out = collections.defaultdict(lambda: collections.defaultdict(lambda: [0.0, 0]))
    owner = {}
    for e in sorted((e for e in dev if e["cat"] == "kernel"), key=lambda e: e["ts"]):
        stream = e.get("args", {}).get("stream", e.get("tid"))
        if any(k in e["name"] for k in SHARED):
            cell = out[owner.get(stream, "none")][group_of(e["name"])]
            cell[0] += e["dur"] / 1e3
            cell[1] += 1
        else:
            owner[stream] = group_of(e["name"])
    return {k: dict(v) for k, v in out.items()}


def instrument_cnn(model):
    """Wrap the CNN's first conv (and its projection) and every BatchNorm in
    profiler spans: ``cnn/first_conv``, ``cnn/bn``. Returns a function that
    undoes it."""
    import torch

    from intentbev_torch.models import blocks

    blk = model.backbone.lidar_stage1.blocks[0]
    first = {id(blk.conv1), id(blk.proj_conv)}
    saved = blocks.conv, blocks.batch_norm_infer, blocks.batch_norm_train

    def spanned(fn, name, pick=lambda mod: True):
        def call(mod, x):
            if not pick(mod):
                return fn(mod, x)
            with torch.profiler.record_function(name):
                return fn(mod, x)
        return call

    blocks.conv = spanned(saved[0], "cnn/first_conv", lambda mod: id(mod) in first)
    blocks.batch_norm_infer = spanned(saved[1], "cnn/bn")
    blocks.batch_norm_train = spanned(saved[2], "cnn/bn")

    def undo():
        blocks.conv, blocks.batch_norm_infer, blocks.batch_norm_train = saved
    return undo


def first_conv_ms(model, lidar_nhwc) -> dict:
    """CUDA-event time of the CNN's first conv (forward) on the fill's NHWC
    output as the model reads it (a channels-last NCHW view), and on an
    NCHW-contiguous copy of the same input."""
    import torch

    from intentbev_torch.models.blocks import conv

    mod = model.backbone.lidar_stage1.blocks[0].conv1
    out = {}
    with torch.no_grad():
        for name, x in (("channels_last_view", lidar_nhwc.permute(0, 3, 1, 2)),
                        ("nchw_contiguous", lidar_nhwc.permute(0, 3, 1, 2).contiguous())):
            conv(mod, x)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                conv(mod, x)
            end.record()
            end.synchronize()
            out[name] = start.elapsed_time(end) / 10
    return out


def print_details(p) -> None:
    for owner, shared in p["shared_by_owner_ms_calls"].items():
        print(f"shared kernels after {owner}: " + "; ".join(
            f"{g} {ms:.3f} ms / {n}" for g, (ms, n) in shared.items()))
    for span, kernels in p["span_kernels_ms_calls"].items():
        print(f"kernels launched in {span}:")
        for name, (ms, n) in kernels.items():
            print(f"    {ms:.3f} ms over {n} calls: {name}")
    print("host CUDA API calls (forward or step window): " + "; ".join(
        f"{k} {ms:.2f} ms / {n}" for k, (ms, n) in p["host_api_ms_calls"].items()))


def profile_train(args, card) -> None:
    import torch

    from intentbev_torch.boxes import generate_anchors
    from intentbev_torch.configs import default_cnn_config, default_vit_config
    from intentbev_torch.data.pipeline import chunk_batch_to_device
    from intentbev_torch.models import build_model, init_params
    from intentbev_torch.synthetic import calibrated_params, chunk_train_batch, train_batch
    from intentbev_torch.train import make_optimizer, make_train_step

    cnn = args.model == "cnn"
    cfg = default_cnn_config() if cnn else default_vit_config()
    if args.vit_config != "default":  # the configuration's switches, not its transport
        cfg, _ = vit_config(cfg, args.vit_config)
    model = build_model(cfg, dtype=torch.bfloat16, param_dtype=torch.float32)
    model.load_state_dict(calibrated_params(cfg, 0, "cuda") if cnn else init_params(cfg, seed=0))
    model.to("cuda")
    anchors = torch.from_numpy(generate_anchors(cfg.grid, cfg.anchors)).to("cuda")
    step = make_train_step(model, cfg, anchors, make_optimizer(model.parameters(), cfg))
    if cnn:  # the CNN trains over the chunk train transport
        batch = chunk_batch_to_device(chunk_train_batch(cfg, 8, 16384, seed=0), "cuda")
    else:
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

    peak_gib = None
    if cnn:
        torch.cuda.reset_peak_memory_stats()
        step(batch, gen)
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / "trace.json"
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    undo = instrument_cnn(model) if cnn else (lambda: None)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("train/step"):
                step(batch, gen)
                torch.cuda.synchronize()
    finally:
        undo()
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
    span_of = launch_spans(events, dev, "cnn/")
    groups, names = device_groups(dev, span_of)
    result = {
        "card": card,
        "model": args.model,
        "vit_config": args.vit_config,
        "step_ms": step_ms,
        "peak_memory_gib": peak_gib,
        "profiled_step": {
            "step_window_ms": (hi - lo) / 1e3,
            "device_busy_ms": busy,
            "device_idle_share": 1 - busy * 1e3 / (hi - lo),
            "span_host_ms": {k: (b - a) / 1e3 for k, (a, b) in spans.items()},
            "span_device_ms": dict(span_dev),
            "groups_ms_calls": groups,
            "top_kernels_ms_calls": names,
            "span_kernels_ms_calls": span_kernels(dev, span_of),
            "shared_by_owner_ms_calls": shared_by_owner(dev),
            "host_api_ms_calls": host_api_ms(events, lo, hi),
        },
    }
    (out / "profile_train.json").write_text(json.dumps(result, indent=1))
    print(f"card: {card}")
    print("step ms (synchronized): " + " ".join(f"{x:.1f}" for x in step_ms))
    if peak_gib is not None:
        print(f"peak device memory of a step: {peak_gib:.2f} GiB")
    p = result["profiled_step"]
    print(f"profiled step: {p['step_window_ms']:.2f} ms, device busy "
          f"{p['device_busy_ms']:.2f} ms, idle share {p['device_idle_share']:.4f}")
    for k, w in p["span_host_ms"].items():
        print(f"span {k}: host {w:.2f} ms, device time it launched "
              f"{p['span_device_ms'].get(k, 0.0):.2f} ms")
    for g, (ms, n) in p["groups_ms_calls"].items():
        print(f"  {g}: {ms:.3f} ms over {n} calls")
    print_details(p)
    print(f"wrote {out / 'profile_train.json'} and {trace_path}")


def profile_experimental(args, card) -> None:
    """One traced call of each op of ``ops.experimental`` at phase 13's
    shapes: device ms and calls per kernel, per op."""
    import torch

    from intentbev_torch.ops.experimental import (flash_attention_packed_int8,
                                                  fused_dense_residual)

    b, t, seq_len, d = 8, 4608, 4501, 384
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).bfloat16()

    qkv = randn(b, t, 3 * d)
    q, k, v = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    dy = randn(b, t, d)
    leaves = [a.requires_grad_(True) for a in (
        randn(b, t, d), randn(d, d, std=d ** -0.5),
        torch.randn(d, generator=gen, device="cuda") * 0.1, randn(b, t, d))]
    gate = (torch.rand(b, 1, generator=gen, device="cuda") < 0.9).float() / 0.9

    w_lin = leaves[1].detach().t().contiguous().requires_grad_(True)  # [out, in]

    def calls():
        for heads in (6, 12):
            with torch.profiler.record_function(f"exp/flash_int8 {heads}x{d // heads}"):
                flash_attention_packed_int8(q, k, v, heads, seq_len)
        for a in (*leaves, w_lin):
            a.grad = None  # no accumulation kernels in the backward spans
        with torch.profiler.record_function("exp/fused_proj forward"):
            y = fused_dense_residual(*leaves, gate)
        with torch.profiler.record_function("exp/fused_proj backward"):
            y.backward(dy)  # the launches run on autograd's thread, inside this span
        # the reference: the model's unfused Linear, gate and residual
        for a in leaves:
            a.grad = None
        with torch.profiler.record_function("exp/unfused forward"):
            y = leaves[3] + torch.nn.functional.linear(
                leaves[0], w_lin, leaves[2].bfloat16()) * gate[:, :, None].bfloat16()
        with torch.profiler.record_function("exp/unfused backward"):
            y.backward(dy)
        torch.cuda.synchronize()

    calls()  # warm-up: the kernel library's build, the allocator
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / "trace.json"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        calls()
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    ops = collections.defaultdict(lambda: collections.defaultdict(lambda: [0.0, 0]))
    for e, span in zip(dev, launch_spans(events, dev, "exp/")):
        if span is not None:
            ops[span][e["name"][:90]][0] += e["dur"] / 1e3
            ops[span][e["name"][:90]][1] += 1
    result = {"card": card, "ops": {
        span: {"device_ms": sum(ms for ms, _ in kern.values()),
               "kernels_ms_calls": dict(sorted(kern.items(), key=lambda kv: -kv[1][0]))}
        for span, kern in ops.items()}}
    (out / "profile_experimental.json").write_text(json.dumps(result, indent=1))
    print(f"card: {card}")
    for span, r in result["ops"].items():
        print(f"{span}: device {r['device_ms']:.4f} ms")
        for name, (ms, n) in r["kernels_ms_calls"].items():
            print(f"  {name}: {ms:.4f} ms over {n} calls")
    print(f"wrote {out / 'profile_experimental.json'} and {trace_path}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=4,
                    help="timed requests (serving) or steps (--train)")
    ap.add_argument("--train", action="store_true", help="profile a training step")
    ap.add_argument("--model", choices=("vit", "cnn"), default="vit")
    ap.add_argument("--vit-config", choices=("default", "int8", "ln_dense", "unfused_ln",
                                             "patch_embed", "tiny", "tiny_ln_dense",
                                             "tiny_int8", "tiny_patch_embed"),
                    default="default",
                    help="the ViT configuration (training: ln_dense, unfused_ln, tiny or "
                         "tiny_ln_dense)")
    ap.add_argument("--experimental", action="store_true",
                    help="profile the library ops of ops.experimental")
    ap.add_argument("--out", default="chiprun_out/profile_slice")
    args = ap.parse_args()
    if args.vit_config != "default" and args.model != "vit":
        ap.error("--vit-config profiles the ViT")
    if args.train and args.vit_config not in ("default", "ln_dense", "unfused_ln", "tiny"):
        ap.error("--train --vit-config takes ln_dense, unfused_ln or tiny")
    if args.experimental and (args.train or args.model != "vit"
                              or args.vit_config != "default"):
        ap.error("--experimental takes no other mode")
    if args.out == ap.get_default("out") and args.experimental:
        args.out = str(Path(args.out).with_name("profile_experimental"))
    elif args.out == ap.get_default("out"):
        suffix = "" if args.vit_config == "default" else f"_{args.vit_config}"
        args.out = str(Path(args.out).with_name("profile_" + "cnn_" * (args.model == "cnn")
                                                + ("train" if args.train else "slice")
                                                + suffix))

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0].strip()
    if args.train:
        profile_train(args, card)
        return
    if args.experimental:
        profile_experimental(args, card)
        return

    from intentbev_torch.configs import default_cnn_config, default_vit_config
    from intentbev_torch.models import init_params
    from intentbev_torch.ops.voxel_embed import (chunks_to_device, decode_chunk_transport,
                                                 voxel_fill_bev)
    from intentbev_torch.parallel import StreamingInferencer
    from intentbev_torch.synthetic import calibrated_params, serving_batch

    cnn = args.model == "cnn"
    cfg = default_cnn_config() if cnn else default_vit_config()
    batch = 8
    transport = "chunks"
    if args.vit_config != "default":
        cfg, transport = vit_config(cfg, args.vit_config)
    params = calibrated_params(cfg, 0, "cuda") if cnn else init_params(cfg, seed=0)
    inf = StreamingInferencer(cfg, params, "cuda", transport=transport, gelu="sigmoid")
    requests = [serving_batch(cfg.grid, batch, 16384, seed=s)
                for s in range(args.requests + 1)]

    def request(pts, valid, mp, stamps):
        with torch.profiler.record_function("host_chunk_build"):
            t0 = time.perf_counter()
            chunks = inf.build_chunks(pts, valid) if transport == "chunks" else None
            t1 = time.perf_counter()
        with torch.profiler.record_function("forward"):
            logits = (inf.logits(chunks, mp) if chunks is not None
                      else inf.logits_points(pts, valid, mp))
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
    undo = instrument_cnn(inf.model) if cnn else (lambda: None)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            request(*requests[1], [])
    finally:
        undo()
    prof.export_chrome_trace(str(trace_path))
    conv_ms = None
    if cnn:
        g = cfg.grid
        with torch.inference_mode():
            lidar = voxel_fill_bev(
                decode_chunk_transport(chunks_to_device(inf.build_chunks(*requests[1][:2]),
                                                        "cuda")),
                (g.height_px, g.width_px), g.lidar_total_channels, inf.chunk_patch)
        conv_ms = first_conv_ms(inf.model, lidar)
        del lidar

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

    span_of = launch_spans(events, dev, "cnn/")
    groups, names = device_groups(dev, span_of)
    result = {
        "card": card,
        "model": args.model,
        "vit_config": args.vit_config,
        "first_conv_ms": conv_ms,
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
            "span_kernels_ms_calls": span_kernels(dev, span_of),
            "shared_by_owner_ms_calls": shared_by_owner(dev),
            "host_api_ms_calls": host_api_ms(events, fwd_lo, fwd_hi),
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
    print_details(p)
    if conv_ms is not None:
        print("first conv alone (CUDA events): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in conv_ms.items()))
    print(f"wrote {out / 'profile_slice.json'} and {trace_path}")


if __name__ == "__main__":
    main()
