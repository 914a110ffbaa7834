"""Smoke run of the PyTorch port on one CUDA card: the serving paths and the
training steps of both model families, data and tensor parallel included.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits nonzero with no result):

1. device: CUDA must be present; prints the card's name and power limit.
2. build: compiles the kernel library (nvcc, sm_90a) and the host library
   (g++) from the checkout's sources.
3. kernels: each hand-written kernel (serving and training entries, those
   of the MLP without LN and of the LN + dense too) against its plain
   PyTorch version at the main paths' shapes in bf16,
   with CUDA-event times of both and, where one PyTorch call computes the
   same function (SDPA, layer_norm, conv2d), of that call; the least time
   the card could take (bytes over 3.35 TB/s or operations over 989
   TFLOP/s bf16, 1979 TOP/s for the int8 kernel) is computed from the
   inputs. Each reading (relative L2 error) must lie
   under its limit, and a control, the plain version with one named fault,
   must reach it. The flash forward runs in JAX's three softmax forms
   (monolithic safe, fixed max, chunked safe at 1152 keys), each against
   its plain version in that form, o read both by its relative L2 and by
   the share of its elements that differ; controls: the plain version of
   another form (the rounding of P against another max) and the old masking
   faults. Each flash backward entry also prints its device time
   split by kernel from a profiler trace (dk/dv, dq, the wrapper's own
   kernels) and its TFLOP/s counted as the 5-product bound counts them;
   each LN + dense backward (row 14: qkv and the adapter with the erf GELU,
   at D=384 and 192) its row kernel, dW product and partial sums. Row 14's
   forward runs as qkv and as the adapter with each GELU, at both widths
   (the instances the ViT and ViT-Ti paths launch). Row 14 also
   reads y's and dx's shares of differing elements (controls: xn kept in
   f32 before the product; dg kept in f32 before dxn, or without GELU dxn
   rounded before the LN backward), and prints the time of the same
   function as F.layer_norm, F.linear [+ the GELU] in bf16 (the backward by
   autograd through them), a yardstick the port never calls. Row 17, the
   W8A8 MLP, runs at D=384 and 192 (the instances the A paths launch), y
   read by its relative L2 and its share of differing elements (controls:
   one h scale per 32-row block; h rounded to bf16 before its codes). The
   patch embeds, rows 15 (dense BEV) and 1 (chunks), run at D=384 and 192,
   their tokens read by relative L2 and share (controls: the weight read as
   w[dx, dy] and the sum rounded to bf16 before the bias; the last chunk of
   each band skipped); row 15 prints F.conv2d over contiguous NCHW copies
   beside its library call (channels_last strides) and the PatchEmbed.dense
   chain as its reference; row 1's first kernel, the token-ordered hit list,
   must equal its plain version entry for entry, and two calls of row 1 the
   same bits. Row 13, the MLP without LN, runs at D=384 and 192 (ViT-Ti's
   tails under C): serving (sigmoid GELU), the gated training forward and
   the gated backward.
4. serving: the full-width ViT (default_vit_config, random seeded weights,
   bf16, the serving sigmoid GELU) serves 3 requests of 8 synthetic frames
   through ``StreamingInferencer``; the launch counts show every kernel ran,
   the logits agree with the same model run through the plain versions
   (and a plain run with the other GELU is caught), and the Detections are
   fixed-shape and finite.
5. training: the full-width ViT (f32 master weights, bf16 compute, erf
   GELU, drop-path 0.1) takes train steps of 8 synthetic samples (points
   transport, as ``tools/bench_train.py`` draws them) through
   ``make_train_step``. The loss and gradients of one step agree with the
   same step through the plain versions, and a plain step whose LN+MLP
   backward ignores the drop-path gate is caught (a plain step whose
   LayerNorm backward lacks its mean(dyg*xhat) term is read too: at init
   it hides in the bf16 noise, and the kernel check of phase 3 carries
   it); then one warm-up and 3 timed steps, whose launch counts show every
   kernel of the step ran and whose loss and gradients are finite.
6. CNN serving: the full-width IntentNetCNN (default_cnn_config, random
   seeded weights whose BatchNorm statistics are those of a synthetic
   batch, bf16) serves 3 requests of 8 synthetic frames through
   ``StreamingInferencer(transport="chunks")``: one ``voxel_fill`` launch per
   request and no other kernel; the logits agree with the same model run
   through the plain fill and with ``transport="points"`` on the same
   points binned as the host chunk build bins them (the fill's BEV and the
   host bins agree cell for cell; the device voxelizer, which bins as
   the jitted JAX one, differs only where a point on a cell boundary
   moved, at most 2 cells a point); a plain
   run with the last chunk of each band skipped is caught; the Detections
   are fixed-shape and finite.
7. CNN training over the chunk train transport (f32 master weights, bf16
   compute): one step's loss and gradients agree with the same step
   through the plain fill and with the points-transport step on the same
   points (identity augmentation, the host bins as in phase 6), and
   the plain step with the last chunk
   of each band skipped is caught; then one warm-up and 3 timed steps of
   one ``voxel_fill`` launch each. The ViT of phase 5 then takes one step
   over the chunk train transport: finite, with one ``voxel_fill`` launch
   beside its 24/24/24/24/28/28.
8. ViT serving configurations: the full-width ViT of phase 4 under four
   kernel switches of ``ViTBackboneConfig`` serves 3 requests of 8 frames
   each: A ``serving_int8`` (the ``bench.py --int8`` line, points
   transport), B ``fuse_ln_dense`` (chunks), C ``use_fused_layernorm=False``
   (chunks), D ``fuse_patch_embed`` (points). The launch counts per request
   are those of the JAX model's structure for the configuration; the logits
   agree with the same configuration through the plain versions (and the
   plain run with the erf GELU is caught); the Detections are fixed-shape
   and finite; frames/s are printed.
9. ViT training under two of those switches: the full-width ViT of phase 5
   takes train steps under B ``fuse_ln_dense`` and C
   ``use_fused_layernorm=False`` (the JAX model's training structures: the
   LN + dense kernel for qkv and the adapters with its backward kernel; the
   MLP without LN with its drop-path gate and its backward kernel, every
   LayerNorm in plain PyTorch). One step's loss and gradients agree with the
   same step through the plain versions, and a plain step with one fault in
   the new backward is caught (B: the adapters' LN + dense backward without
   GELU'; C: the MLP backward ignoring the gate); then one warm-up and 3
   timed steps whose launch counts are those of the structure, with finite
   metrics, ms/step, samples/s and peak memory.
10. ViT-Ti (embed 192, 3 heads of 64, whose heads do not pair: the BHTD
    attention) serves 3 requests and trains: launch counts, logits and one
    step's gradients against the plain versions with controls, 3 timed
    steps. Then ViT-Ti under B ``fuse_ln_dense`` (the LN + dense pair at
    D=192) serves one request and takes one timed train step, under A
    ``serving_int8`` (the W8A8 MLP at D=192) and under D
    ``fuse_patch_embed`` (the dense patch embed at D=192, points) serves one
    request each, with the checks and controls of phases 8 and 9; under C
    ``use_fused_layernorm=False`` (row 13 at D=192 after the plain
    FastLayerNorms) it serves one request and takes 3 timed train steps
    (24 row-13 forwards a request, 24 + 24 a step).
11. The flash backward's forms (JAX's split and chunked backwards, the
    model's ``bwd_fused=False`` and ``bwd_kv_chunk=1152``) and the packed
    path at head dim 32: each form's kernels against their plain versions
    at [8, 4501, 384] in 6 heads of 64 (control: delta left out) and in 12
    heads of 32, with the packed forward and the fused backward (controls:
    another form's rounding, and the forward with the f32 scale); one
    step's loss and gradients under split and under chunked against the
    fused step's (one function at head dim 64, so the limits are far under
    phase 5's), with launch counts under the forms' own names; then 3 timed
    steps of each form at 6 heads of 64 and at 12 heads of 32. The
    backward entries print the split of phase 3. The forward's three forms
    at 12 heads of 32 against their plain versions (controls as phase 3's,
    and q scaled by the f32 scale); then the full-width ViT serves 3
    requests in the form the bench lines do not take, as phase 8 serves
    its configurations: E the chunked safe softmax at 6 heads of 64
    (``fwd_kv_chunk=1152``), counted under its form's own name.
12. The bench twins: every line of ``bench_torch.py`` once (2 iterations;
    ``_sustained`` one pass of 3 batches) with ``bench.py``'s keys in its
    order, finite and positive, its ViT lines through the fixed-max forward
    (``bench.py``'s serving switches: ``flash_packed_fixed`` launched, the
    other forms not; ``_sustained`` serves the default config, as
    ``bench.py``'s does: the safe form), and ``tools/bench_train_torch.py``'s
    step under the fused and the chunked backward (2 steps).
13. The library ops of ``intentbev_torch.ops.experimental``, which no model
    path calls (in JAX neither): each op's own entry at the attention
    sublayer's shapes of the flagship ViT ([8, 4608, 384], 4501 real keys),
    counted, then each kernel against its plain version with a control:
    ``flash_attention_packed_int8`` at 6 heads of 64, 12 of 32, 24 of 16
    and 3 of 128 in bf16 and at 6 of 64 in f32 (control: P's codes rounded
    against a running tile max; two calls give the same bits) and
    ``fused_dense_residual`` forward and backward through its autograd
    function with a per-sample drop-path gate (controls: the Dense output
    rounded before the gate and residual; db from the rounded dyg), with
    the reference calls' times: the bf16 packed forward (head dims 32 and
    64) and SDPA for the int8 attention; ``torch.addmm`` (gate 1, bias in the residual) and the
    model's unfused Linear, gate and residual, forward and backward (the
    kernels autograd launches for it) for the projection.

14. The lifecycle at full width, through the port's entry points: 2
    synthetic AV2-format logs of 17 frames (40000 points a sweep, the
    default grid, 10 sweeps: 16 sequences) written, labelled
    (``precompute_labels.run``), loaded (the loader alone timed, cold);
    ``train()`` of ``default_vit_config()`` at batch 8 (bf16 compute, f32
    master weights, points) for 3 steps with checkpoints every 2, then a
    resume to step 4: the step count continues, ``loop.epoch_batch`` is
    restored, the saved parameters equal the live model's bit for bit,
    every logged loss is finite, and the loop's launch counts are 4 x phase
    5's per step; one step over the chunk train transport (one
    ``voxel_fill``); ``evaluate()`` of the run on 2 batches (16 samples,
    every mAP in [0, 1]; launches ``flash_packed`` / ``fused_ln_mlp`` 24 and
    ``layernorm`` 4 a batch); one eval batch's logits through the kernels
    against the plain path (limit 1.3e-2; control: the plain path binning
    the points by true division, as the host chunk build does). It prints the loader's samples/s, the loop's ms/step
    beside phase 5's step alone, and eval's samples/s.
15. The deployment paths: 8 stream rings (``data.streaming``) of the
    default grid's 10 sweeps x 65536 points, 12 sweeps pushed at advancing
    poses on the card; ``batched_voxelize_rings`` on the card against the
    same function on a CPU copy and against ``voxelize_packed`` over the
    host's f64 re-projection (cells that differ: at most 2 a point whose
    exact bins lie within 1e-3 of a boundary); phase 14's log's map as a
    ``CityRaster``, warped to the 8 current poses on the card against the
    host warp (share of differing values under 2e-3, the JAX test's
    limit); the full-width ViT on those BEVs and maps through NMS (launch
    counts; logits against the plain path under phase 4's limit, control
    the erf GELU); the card's ms for a ring voxelize and a warp a batch of
    8. Then, in a child process with a 600 s timeout (``--dp-child``), a
    one-rank NCCL group through a TCPStore on a free localhost port: the
    sharded train step on phase 5's batch and draws against phase 5's
    kernel step (loss terms within 1e-3 relative, num_pos equal, gradients
    under phase 5's limits) and the distributed eval of phase 14's
    checkpoint against phase 14's (counts and confusion matrix equal), with
    launch counts; the group is destroyed.
16. Tensor parallelism: two child processes (``--tp-child``) on the one
    card, a gloo group through a TCPStore on a free localhost port (NCCL
    refuses two ranks on one device), mesh (1, 2), killed after 300 s:
    phase 5's step (batch, weights, draws, lr 0) of the full-width ViT at
    ``model_parallel=2``, each rank on 3 of the 6 heads (the BHTD kernels)
    and 768 of the 1536 hidden units (the MLP kernel without LN after a
    separate LayerNorm), against phase 5's kernel step: loss terms within
    1e-2 relative, num_pos equal, the gradients gathered to full tensors
    under phase 5's limits (the rule of phase 5's kernel step against its
    plain step); the ranks' metrics equal; each rank's launch counts exact
    (rows 16, 13, 8 and 9; none of rows 3, 6, 7 and 10); a control (both
    ranks skip the MLP's ``reduce_from_model``) must break the rule. Then
    B's step (``fuse_ln_dense``: row 14 on the rank's qkv shard, Dout 576)
    the same way against phase 9's B kernel step. It prints the pair's ms a
    step and gloo's share of it: two ranks share one card, so this is not
    TP's speed.

17. The last modules: reference-schema ``.pth`` files (the reference repo's
    names, numpy draws) of the CNN, ViT-S (``vit_small_patch8_224``) and
    ViT-Ti (``vit_tiny_patch8_224``) at full width go through ``python -m
    intentbev_torch.import_torch`` (three processes side by side); each
    checkpoint serves one request of 8 through the kernels, its logits held
    against the plain path under phase 4's limit (control: the qkv rows
    imported k-first; the CNN's conv1 kernels with kh and kw swapped). One
    train step on phase 5's batch without ``aug_params`` (the image-space
    augmentation, every sample flipped, rotated 5 degrees and scaled 1.03,
    no dropout) against the same step through the plain versions under
    phase 5's limits (control: theta with the wrong sign). ``bench_torch``'s
    CNN chunk line with the f32 fill (``INTENTBEV_CNN_FILL_LAYOUT=f32``).
    The four twins, each a child process, start when the imports end and
    run side by side with each other and with those checks: the synthetic
    dataset (1 + 1 logs of 10 frames, with labels), ``score_range_torch``
    on phase 14's checkpoint and split (|s| < 88 over its 24 attention
    calls), ``serve_chunks_torch --batches 2`` (its three rates) and
    ``soak_loader_torch`` on phase 14's split (200 samples: samples/s and
    the RSS). Their rates, read side by side, show that each twin runs; they
    measure nothing. A twin still running when the smoke exits is killed.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor cores
INT8_OPS_PER_S = 1979e12     # H100 SXM dense int8 tensor cores
# Phase 8: limits of the relative L2 error of each configuration's logits,
# kernels against plain versions, between the sound readings and those of
# the control (the plain path with the erf GELU); PERF.md has both. Under
# W8A8 the bf16 noise of 24 blocks flips int8 codes, which lifts the sound
# reading to ~2e-2; the int8 kernel itself is exact against its plain
# version (phase 3).
TP_TIMEOUT_S = 300  # phase 16's ranks: a hang fails the phase, not the smoke's limit
CONFIG_LIMITS = {**{name: (2.3e-2,) * 3 for name in ("A serving_int8", "Ti A serving_int8")},
                 **{name: (1.3e-2,) * 3 for name in (
    "import CNN", "import ViT-S", "import ViT-Ti",
    "B fuse_ln_dense", "C use_fused_layernorm=False", "D fuse_patch_embed",
    "E fwd_kv_chunk=1152", "Ti B fuse_ln_dense", "Ti C use_fused_layernorm=False",
    "Ti D fuse_patch_embed")}}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


@contextlib.contextmanager
def with_host_bins(module):
    """``module.voxelize_packed`` takes the host chunk build's bins inside
    (``arithmetic="host"``): the points transport then fills the BEV the
    chunk transport fills, and a reading can hold one against the other."""
    import functools

    sound = module.voxelize_packed
    module.voxelize_packed = functools.partial(sound, arithmetic="host")
    try:
        yield
    finally:
        module.voxelize_packed = sound


@contextlib.contextmanager
def capture_confusion(store: list):
    """Inside, each ``evaluate()`` appends its confusion matrix (as nested
    lists) to ``store``."""
    import intentbev_torch.evaluate as ev

    sound = ev.confusion_to_metrics

    def spy(confusion):
        store.append(confusion.cpu().tolist())
        return sound(confusion)

    ev.confusion_to_metrics = spy
    try:
        yield
    finally:
        ev.confusion_to_metrics = sound


def dp_child(dp_dir: Path, run_dir: str, split: str) -> None:
    """Phase 15's data-parallel half, in its own process: a one-rank NCCL
    group through a TCPStore on a free localhost port; the sharded train
    step on phase 5's batch and draws (gradients to ``grads.pt``) and the
    distributed eval of phase 14's checkpoint, with their launch counts
    (``result.json``); the group destroyed at the end."""
    import socket
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from intentbev_torch.boxes import generate_anchors
    from intentbev_torch.configs import default_vit_config
    from intentbev_torch.evaluate import evaluate
    from intentbev_torch.models import IntentNetViT
    from intentbev_torch.ops import _build
    from intentbev_torch.parallel import create_mesh, make_sharded_train_step, shard_train_state
    from intentbev_torch.train import StepDraws
    from intentbev_torch.utils import native

    check(torch.cuda.is_available(), "the data-parallel child needs the CUDA card")
    torch.cuda.set_device(0)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    store = dist.TCPStore("127.0.0.1", port, 1, True, timeout=timedelta(seconds=60))
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=timedelta(seconds=120), device_id=torch.device("cuda", 0))
    try:
        _build.kernels()
        native.host_lib()
        dev = torch.device("cuda", 0)
        inp = torch.load(dp_dir / "inputs.pt", weights_only=False)
        cfg = default_vit_config()
        mesh = create_mesh(cfg.mesh, "cuda")
        model = IntentNetViT(cfg.vit, cfg.heads, dtype=torch.bfloat16, param_dtype=torch.float32)
        model.load_state_dict(inp["params"])
        model.to(dev)
        opt = torch.optim.SGD(model.parameters(), lr=0.0)  # phase 5's step at lr 0
        shard_train_state(model, opt, mesh, cfg)
        anchors = torch.from_numpy(generate_anchors(cfg.grid, cfg.anchors)).to(dev)
        step = make_sharded_train_step(model, cfg, anchors, opt, mesh)
        draws = inp["draws"]
        draws = StepDraws(type(draws.dropout)(*(t.to(dev) for t in draws.dropout)),
                          draws.intent_u.to(dev))
        batch = {k: t.to(dev) for k, t in inp["batch"].items()}
        _build.reset_launch_counts()
        metrics = step(batch, torch.Generator(device="cuda").manual_seed(1), draws)
        torch.cuda.synchronize()
        step_counts = dict(_build.launches)
        torch.save({k: p.grad.detach().float().cpu() for k, p in model.named_parameters()},
                   dp_dir / "grads.pt")
        del model, opt, step, batch
        torch.cuda.empty_cache()
        print(f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}, backend "
              f"{dist.get_backend()}, world {dist.get_world_size()}", flush=True)
        confusion = []
        _build.reset_launch_counts()
        with capture_confusion(confusion):
            res = evaluate(run_dir, split, num_workers=4, max_batches=2, device="cuda",
                           distributed=True, log_fn=lambda line: print(line, flush=True))
        torch.cuda.synchronize()
        (dp_dir / "result.json").write_text(json.dumps({
            "metrics": {k: float(v) for k, v in metrics.items()}, "step_counts": step_counts,
            "eval": res, "confusion": confusion[-1], "eval_counts": dict(_build.launches)}))
    finally:
        dist.destroy_process_group()


TP_VARIANTS = ("default", "ln_dense")  # phase 16's steps: the default switches, then B


def tp_child(tp_dir: Path, inputs: str, rank: int, port: int) -> None:
    """Phase 16's ranks, two processes on the one card over gloo (NCCL
    refuses two ranks on one device), mesh (1, 2): each takes phase 5's
    step (its batch, weights and draws, lr 0) under tensor parallelism, by
    ``shard_train_state`` and ``make_sharded_train_step``, with its launch
    counts and the gradients gathered to full tensors (``grads_<variant>.pt``
    from rank 0); for the default switches also the control step with
    the MLP's ``reduce_from_model`` skipped on both ranks (the collectives
    stay paired), its gradients too, and 3 timed steps, gloo's time inside
    them summed; then B's step (``fuse_ln_dense``). ``result_rank<r>.json``
    holds the rest."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    import intentbev_torch.models.vit as vit_mod
    from intentbev_torch.boxes import generate_anchors
    from intentbev_torch.configs import default_vit_config
    from intentbev_torch.models import IntentNetViT
    from intentbev_torch.ops import _build
    from intentbev_torch.parallel import create_mesh, make_sharded_train_step, shard_train_state
    from intentbev_torch.parallel.inference import vit_serving_variant
    from intentbev_torch.parallel.mesh import model_group
    from intentbev_torch.parallel.train_dp import full_tensor
    from intentbev_torch.train import StepDraws

    check(torch.cuda.is_available(), "the tensor-parallel ranks need the CUDA card")
    torch.cuda.set_device(0)
    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0, timeout=timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2,
                            timeout=timedelta(seconds=120))
    gloo_s = [0.0]
    sound_all_reduce = dist.all_reduce

    def timed_all_reduce(*a, **kw):  # gloo's time: the card idle before and after
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sound_all_reduce(*a, **kw)
        torch.cuda.synchronize()
        gloo_s[0] += time.perf_counter() - t0
        return out

    try:
        _build.kernels()
        dev = torch.device("cuda", 0)
        inp = torch.load(inputs, weights_only=False)
        draws = inp["draws"]
        draws = StepDraws(type(draws.dropout)(*(t.to(dev) for t in draws.dropout)),
                          draws.intent_u.to(dev))
        batch = {k: t.to(dev) for k, t in inp["batch"].items()}
        result = {"backend": dist.get_backend()}
        for variant in TP_VARIANTS:
            cfg = default_vit_config()
            if variant != "default":
                cfg = vit_serving_variant(cfg, variant)[0]
            cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, model_parallel=2))
            mesh = create_mesh(cfg.mesh, "cuda")
            model = IntentNetViT(cfg.vit, cfg.heads, dtype=torch.bfloat16,
                                 param_dtype=torch.float32)
            model.load_state_dict(inp["params"])
            model.to(dev)
            opt = torch.optim.SGD(model.parameters(), lr=0.0)  # phase 5's step at lr 0
            shard_train_state(model, opt, mesh, cfg)
            anchors = torch.from_numpy(generate_anchors(cfg.grid, cfg.anchors)).to(dev)
            step = make_sharded_train_step(model, cfg, anchors, opt, mesh)
            _build.reset_launch_counts()
            metrics = step(batch, torch.Generator(device="cuda").manual_seed(1), draws)
            torch.cuda.synchronize()
            counts = dict(_build.launches)
            mg = model_group(mesh, cfg.mesh)

            def save_grads(name_):
                """The rank's gradients as full tensors, gathered over the model
                axis as a checkpoint's are; rank 0 writes them."""
                grads = {k_: full_tensor(k_, p_.grad.detach().float(), mg, cfg).cpu()
                         for k_, p_ in model.named_parameters()}
                if rank == 0:
                    torch.save(grads, tp_dir / f"grads_{name_}.pt")

            save_grads(variant)
            res = {"metrics": {k: float(v) for k, v in metrics.items()}, "counts": counts,
                   "mesh": [list(mesh.shape), list(mesh.mesh_dim_names)],
                   "model_axis": [mg.rank, mg.size]}
            if variant == "default":
                # control: both ranks skip the MLP's sum (every second call a
                # block makes), so each carries its own partial on
                calls = [0]
                sound_reduce = vit_mod.reduce_from_model

                def skip_mlp_reduce(t, group):
                    calls[0] += 1
                    return t if calls[0] % 2 == 0 else sound_reduce(t, group)

                vit_mod.reduce_from_model = skip_mlp_reduce
                try:
                    ctrl = step(batch, torch.Generator(device="cuda").manual_seed(1), draws)
                    res["control"] = {k: float(v) for k, v in ctrl.items()}
                finally:
                    vit_mod.reduce_from_model = sound_reduce
                save_grads("control")
                tgen = torch.Generator(device="cuda").manual_seed(2)
                step(batch, tgen)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                dist.all_reduce = timed_all_reduce
                step_ms, gloo_ms = [], []
                try:
                    for _ in range(3):
                        gloo_s[0] = 0.0
                        t0 = time.perf_counter()
                        step(batch, tgen)
                        torch.cuda.synchronize()
                        step_ms.append((time.perf_counter() - t0) * 1e3)
                        gloo_ms.append(gloo_s[0] * 1e3)
                finally:
                    dist.all_reduce = sound_all_reduce
                res.update(step_ms=step_ms, gloo_ms=gloo_ms,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            result[variant] = res
            del model, opt, step
            torch.cuda.empty_cache()
            dist.barrier()
        (tp_dir / f"result_rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def main() -> None:
    t_start = time.perf_counter()
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke runs on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card, flush=True)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    import importlib

    import numpy as np
    import torch.nn.functional as F

    from intentbev_torch.bev.augment import draw_dropout
    from intentbev_torch.bev.voxelize import moved_points, quantize_points_cm, voxelize_packed
    from intentbev_torch.boxes import generate_anchors
    from intentbev_torch.configs import default_cnn_config, default_vit_config
    from intentbev_torch.data.pipeline import chunk_batch_to_device
    from intentbev_torch.models import IntentNetCNN, IntentNetViT, init_params
    from intentbev_torch.ops import _build
    from intentbev_torch.ops import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain,
        fused_ln_dense, fused_ln_dense_bwd, fused_ln_dense_bwd_plain, fused_ln_dense_plain,
        fused_mlp, fused_mlp_bwd, fused_mlp_bwd_plain, fused_mlp_int8, fused_mlp_int8_plain,
        fused_mlp_plain, fused_mlp_train, patch_embed, patch_embed_plain, quantize_linear,
        quantize_rows,
        flash_attention_packed, flash_attention_packed_bwd, flash_attention_packed_bwd_plain,
        flash_attention_packed_plain, fused_ln_mlp, fused_ln_mlp_bwd, fused_ln_mlp_bwd_plain,
        fused_ln_mlp_plain, fused_ln_mlp_train, fused_ln_mlp_train_plain, layernorm,
        layernorm_bwd, layernorm_bwd_plain, layernorm_plain, layernorm_train,
        layernorm_train_plain, voxel_embed_tokens, voxel_embed_tokens_plain, voxel_fill_bev,
        voxel_fill_bev_plain, voxel_hits, voxel_hits_plain)
    from intentbev_torch.ops.experimental import (
        flash_attention_packed_int8, flash_attention_packed_int8_plain, fused_dense_residual,
        fused_proj_bwd, fused_proj_bwd_plain, fused_proj_fwd, fused_proj_fwd_plain)
    from intentbev_torch.ops.flash_attention import flash_attention_packed_layout, heads_view
    from intentbev_torch.ops.fused_ln_mlp import gelu as gelu_fn
    from intentbev_torch.ops.fused_ln_mlp import gelu_erf_grad as gelu_grad_fn
    from intentbev_torch.ops.int8 import int_matmul
    from intentbev_torch.ops.voxel_embed import chunks_to_device, decode_chunk_transport
    from intentbev_torch.parallel import StreamingInferencer, vit_serving_variant
    from intentbev_torch.parallel.inference import build_chunk_transport
    from intentbev_torch.synthetic import (calibrated_params, chunk_train_batch, serving_batch,
                                           train_batch)
    from intentbev_torch.train import StepDraws, make_optimizer, make_train_step
    from intentbev_torch.utils import native

    # 2. build
    t0 = time.perf_counter()
    _build.kernels()
    t1 = time.perf_counter()
    native.host_lib()
    t2 = time.perf_counter()
    print(f"build: kernel library {t1 - t0:.1f} s (nvcc "
          f"{_build.build_seconds if _build.build_seconds is not None else 0:.1f} s), "
          f"host library {t2 - t1:.1f} s", flush=True)

    # 3. kernels vs plain at main-path shapes
    cfg = default_vit_config()
    g, v = cfg.grid, cfg.vit
    batch, d, hidden = 8, v.embed_dim, int(v.embed_dim * v.mlp_ratio)
    tokens = 1 + v.num_patches
    rows = batch * tokens
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, std, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def cuda_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def rel_l2(got, want):
        return float((got.double() - want.double()).norm() / want.double().norm())

    def max_abs(got, want):
        return float((got.float() - want.float()).abs().max())

    def n_differ(got, want):
        return float((got != want).sum())

    def share(got, want):
        return float((got != want).float().mean())

    def o_twice(r):
        """A forward's (o, lse) as (o, o, lse): o read by two metrics."""
        return r[0], r[0], r[1]

    def readings(name, got, want, metrics):
        """One reading per output (metrics: one function per output)."""
        out = []
        for a, b, metric in zip(got, want, metrics):
            check(a.shape == b.shape, f"{name}: shape {tuple(a.shape)} != {tuple(b.shape)}")
            check(bool(torch.isfinite(a).all()), f"{name}: non-finite output")
            out.append(metric(a, b))
        return out

    def compare(name, got, want, control, metrics, limits, fault, failures=None):
        """Every reading of the kernel against its plain version must lie under
        its limit, and the control (the plain version with one named fault)
        must reach a limit, which shows the limits can see such a fault.
        With a ``failures`` list, what fails is added to it instead."""
        sound = readings(name, got, want, metrics)
        ctrl = readings(name, got, control, metrics)
        said = f"readings {sound}, control ({fault}) {ctrl}, limits {limits}"
        problems = []
        if not all(r < lim for r, lim in zip(sound, limits)):
            problems.append(f"{name}: a reading reaches its limit: {said}")
        if not any(r >= lim for r, lim in zip(ctrl, limits)):
            problems.append(f"{name}: the control stays under every limit, so the check "
                            f"cannot see that fault: {said}")
        if failures is None:
            check(not problems, "; ".join(problems))
        else:
            failures.extend(problems)
        return sound, ctrl

    def layernorm_unbiased(x, gamma, beta, eps=1e-6, train=False):
        # the control's fault: variance over N-1 (torch.var's default)
        xf = x.float()
        inv = torch.rsqrt(xf.var(-1, keepdim=True, correction=1) + eps)
        xhat = (xf - xf.mean(-1, keepdim=True)) * inv
        y = (xhat * gamma + beta).to(x.dtype)
        return (y, xhat.to(x.dtype), inv[..., 0]) if train else y

    def layernorm_bwd_no_m2(dy, xhat, inv, gamma):
        # the control's fault: the LN backward without its mean(dyg*xhat) term
        dyg = dy.float() * gamma
        dx = inv[..., None] * (dyg - dyg.mean(-1, keepdim=True))
        dy2, xh2 = (t.float().reshape(-1, dy.shape[-1]) for t in (dy, xhat))
        return dx.to(dy.dtype), (dy2 * xh2).sum(0), dy2.sum(0)

    def gelu_grad_skipped(module, fn):
        """fn() with the control's fault: the plain backward of ``module``
        takes GELU'(g) as 1. (``intentbev_torch.ops`` re-exports functions
        named like their modules, hence importlib.)"""
        mod = importlib.import_module(f"intentbev_torch.ops.{module}")
        sound_fn = mod.gelu_erf_grad
        mod.gelu_erf_grad = torch.ones_like
        try:
            return fn()
        finally:
            mod.gelu_erf_grad = sound_fn

    def ln_dense_bwd_no_m2(x_, gamma_, beta_, w_, bias_, dy_):
        # the control's fault (no GELU): dx through an LN backward without
        # its mean(dyg*xhat) term; the other gradients sound
        _, dgamma_, dbeta_, dw_, db_ = fused_ln_dense_bwd_plain(x_, gamma_, beta_, w_, bias_, dy_)
        _, xhat_, inv_ = layernorm_train_plain(x_, gamma_, beta_)
        dxn = torch.matmul(dy_.float(), w_.float())
        return (layernorm_bwd_no_m2(dxn, xhat_, inv_, gamma_)[0].to(x_.dtype), dgamma_, dbeta_,
                dw_, db_)

    def xn_f32(x_, ln_, w_, b_, mode=None):
        # the control's fault: xn kept in f32 before the LN + dense product
        y_ = layernorm_plain(x_.float(), *ln_) @ w_.float().t() + b_
        return (gelu_fn(y_, mode) if mode else y_).to(x_.dtype)

    def ln_dense_dx_moved(x_, ln_, w_, b_, dy_, mode=None):
        # the control's fault for dx's share, the other outputs sound: with
        # the GELU, dg kept in f32 before dxn; without (dg = dy, already
        # bf16), dxn rounded to bf16 before the LN backward
        xf = x_.float()
        xc = xf - xf.mean(-1, keepdim=True)
        inv_ = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-6)
        xh = xc * inv_
        dg = dy_.float()
        if mode:
            xn = (xh * ln_[0] + ln_[1]).to(x_.dtype).float()
            dg = dg * gelu_grad_fn(xn @ w_.float().t() + b_)
        dxn = dg @ w_.float()
        if not mode:
            dxn = dxn.to(x_.dtype).float()
        dyg = dxn * ln_[0]
        dx_ = inv_ * (dyg - dyg.mean(-1, keepdim=True) - xh * (dyg * xh).mean(-1, keepdim=True))
        rest = fused_ln_dense_bwd_plain(x_, *ln_, w_, b_, dy_, gelu_mode=mode)[1:]
        return dx_twice((dx_.to(x_.dtype),) + tuple(rest))

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def bound(n_bytes, flops, rate=BF16_FLOPS_PER_S):
        """Least time (ms) for this work: bytes over the memory rate or
        operations over the peak rate of their type, whichever is larger.
        ``flops`` may be a list of (operations, rate) pairs, each the work of
        one unit (the int8 products, the exponentials): the slowest counts."""
        pairs = flops if isinstance(flops, list) else [(flops, rate)]
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(n_ / r_ * 1e3 for n_, r_ in pairs)
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def fused_mlp_int8_faulty(x_, w1q_, s1_, b1_, w2q_, s2_, b2_, res_, mode, fault):
        # the controls' faults: one scale of h per block of 32 rows, not per
        # row ("block"); h rounded to bf16 before its codes ("h_bf16")
        xq, xs = quantize_rows(x_.reshape(-1, x_.shape[-1]))
        h = gelu_fn(int_matmul(xq, w1q_.t()) * xs * s1_ + b1_, mode)
        n = h.shape[0]
        if fault == "h_bf16":
            hq, hs = quantize_rows(h.bfloat16().float())
        else:
            amax = F.pad(h.abs().amax(-1), (0, -n % 32)).reshape(-1, 32).amax(-1)
            hs = amax.repeat_interleave(32)[:n, None].clamp(min=1e-8) / 127.0
            hq = torch.clamp(torch.round(h / hs), -127, 127)
        y = int_matmul(hq, w2q_.t()) * hs * s2_ + b2_ + res_.reshape(n, -1).float()
        return twice(y.to(x_.dtype).reshape(x_.shape))

    def h_f32(x_, w1_, b1_, w2_, b2_, mode, ln_=None, gate_=None, res_=None, ln_next=None):
        # the control's fault: h kept in f32 before fc2 (the plain forwards'
        # rounding points otherwise); x's rows, LN2 with ln_ (or none), the
        # residual res_ (x if None), the drop-path gate_, the next LN ln_next
        d_ = x_.shape[-1]
        xf = x_.reshape(-1, d_).float()
        xn = layernorm_plain(xf, *ln_).to(x_.dtype).float() if ln_ else xf
        m = gelu_fn(xn @ w1_.float().t() + b1_, mode) @ w2_.float().t() + b2_
        if gate_ is not None:
            m = m * gate_.float().reshape(-1, 1)
        y_ = m + (x_ if res_ is None else res_).reshape(-1, d_).float()
        y_lp = y_.to(x_.dtype).reshape(x_.shape)
        return (y_lp, layernorm_plain(y_, *ln_next).to(x_.dtype)) if ln_next else y_lp

    def twice(r):
        # a forward's outputs read by two metrics each: relative L2, then
        # the share of elements that differ
        r = r if isinstance(r, tuple) else (r,)
        return r + r

    def dx_twice(r):
        # a backward's outputs with dx read twice: relative L2, then the
        # share of elements that differ; the rest by relative L2
        return (r[0],) + tuple(r)

    def dg_f32(plain_bwd, x_, w1_, b1_, w2_, gate_, dy_, ln_=None):
        # the control's fault: dx from dg kept in f32 before the dxn product
        # (the plain backward's other outputs), dx read twice
        d_ = x_.shape[-1]
        xf, dyf = x_.reshape(-1, d_).float(), dy_.reshape(-1, d_).float()
        xn = xf
        if ln_:
            xc = xf - xf.mean(-1, keepdim=True)
            inv_ = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-6)
            xh = xc * inv_
            xn = (xh * ln_[0] + ln_[1]).to(x_.dtype).float()
        gt = 1.0 if gate_ is None else gate_.float().reshape(-1, 1)
        dg = ((dyf * gt).to(x_.dtype).float() @ w2_.float()) * gelu_grad_fn(
            xn @ w1_.float().t() + b1_)
        dx_ = dg @ w1_.float()
        if ln_:
            dyg = dx_ * ln_[0]
            dx_ = inv_ * (dyg - dyg.mean(-1, keepdim=True)
                          - xh * (dyg * xh).mean(-1, keepdim=True)) + dyf
        return dx_twice((dx_.to(x_.dtype).reshape(x_.shape),) + tuple(plain_bwd()[1:]))

    pts, valid, mp = serving_batch(g, batch, 16384, seed=0)
    chunks = decode_chunk_transport(chunks_to_device(
        build_chunk_transport(pts, valid, g, v.patch_size, 512), dev))
    w_pe = randn((v.patch_size, v.patch_size, v.lidar_input_channels, d), 0.02)
    b_pe = randn((d,), 0.02, torch.float32)
    x = randn((rows, d), 1.0)
    ln = [randn((d,), 0.2, torch.float32) + (1 - i % 2) for i in range(4)]
    w1, b1 = randn((hidden, d), d ** -0.5), randn((hidden,), 0.1, torch.float32)
    w2, b2 = randn((d, hidden), hidden ** -0.5), randn((d,), 0.1, torch.float32)
    qkv = randn((batch, tokens, 3 * d), 1.0)
    q, k, vv = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    hw = tuple(v.img_size)
    mlp_args = (x, ln[0], ln[1], w1, b1, w2, b2, ln[2], ln[3])
    tile_len = tokens // 128 * 128  # keys before flash's last, partial key tile
    heads = v.num_heads
    # training inputs: a per-sample drop-path gate (0 or 1/0.9; sample 0
    # dropped), upstream gradients, and the saved forward results
    keep = torch.rand(batch, generator=gen, device=dev) < 0.7
    keep[0] = False
    gate = (keep.float() / 0.9)[:, None].expand(batch, tokens).contiguous()
    x3, dy = x.view(batch, tokens, d), randn((rows, d), 1.0)
    dy3 = dy.view(batch, tokens, d)
    train_mlp = (x3, ln[0], ln[1], w1, b1, w2)
    _, xhat, inv = layernorm_train_plain(x, ln[0], ln[1])
    o, lse = flash_attention_packed(q, k, vv, heads)
    do = randn((batch, tokens, d), 1.0)
    # the other serving configurations' kernels: W8A8 MLP inputs (rows of
    # varied scale, as a residual stream's are; codes of f32 weights), the
    # qkv and adapter LN + dense, a dense lidar BEV for the patch embed
    x8 = (torch.randn(rows, d, generator=gen, device=dev)
          * torch.exp(0.5 * torch.randn(rows, 1, generator=gen, device=dev))).bfloat16()
    w1q, s1 = quantize_linear(w1.float())
    w2q, s2 = quantize_linear(w2.float())
    int8_args = (x8, w1q, s1, b1, w2q, s2, b2, x)
    w_qkv, b_qkv = randn((3 * d, d), d ** -0.5), randn((3 * d,), 0.1, torch.float32)
    a_out = v.adapter_out_channels
    x_ad = randn((batch * v.num_patches, d), 1.0)
    w_ad, b_ad = randn((a_out, d), d ** -0.5), randn((a_out,), 0.1, torch.float32)
    # training entries of the MLP without LN and of the LN + dense: a
    # per-row gate, the upstream gradients of qkv and of an adapter
    gate_r = gate.reshape(rows)
    dy_qkv, dy_ad = randn((rows, 3 * d), 1.0), randn((x_ad.shape[0], a_out), 1.0)
    x_pe = randn((batch, g.height_px, g.width_px, v.lidar_input_channels), 1.0)
    w_conv = w_pe.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    b_conv = b_pe.bfloat16()

    @torch.no_grad()
    def lib_conv():  # input and weight in channels_last strides (x_pe's NHWC as a view)
        return F.conv2d(x_pe.permute(0, 3, 1, 2), w_conv, b_conv, stride=v.patch_size)

    def pe_dense_chain(w_, b_):
        """The PatchEmbed.dense chain (a reference the port never calls on
        this path): a permute copy of the patches, one matmul, the bias."""
        p_ = v.patch_size
        xp = x_pe.reshape(batch, g.height_px // p_, p_, g.width_px // p_, p_, -1)
        xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(batch, v.num_patches, -1)
        return torch.matmul(xp, w_.reshape(-1, w_.shape[-1])) + b_.bfloat16()

    def pe_rounded(w_, b_):
        """The plain patch embed with the control's fault: the f32 sum
        rounded to bf16 before the bias."""
        return (patch_embed_plain(x_pe, w_, torch.zeros_like(b_), v.patch_size).float()
                + b_).bfloat16()

    used = torch.arange(chunks.wid.shape[-1], device=dev) < chunks.count[..., None]
    cells = int(((chunks.val != 0) & used[..., None, None]).sum())
    # the fill reads each band's chunks up to its count (wid and 64 cells of
    # sl, ch, val) and writes every byte of the dense bf16 BEV
    fill_bytes = (int(used.sum()) * (4 + 64 * 12) + nbytes(chunks.count)
                  + batch * g.height_px * g.width_px * g.lidar_total_channels * 2)

    # library yardsticks (timed only): SDPA over [B, H, T, 64], F.layer_norm
    def bhtd(t):
        return t.reshape(batch, tokens, heads, d // heads).transpose(1, 2).contiguous()

    qh, kh, vh, doh = (bhtd(t).requires_grad_(t is not do) for t in (q, k, vv, do))
    o_sdpa = F.scaled_dot_product_attention(qh, kh, vh)
    xl = x.detach().clone().requires_grad_(True)
    gl, bl = (p.to(torch.bfloat16).requires_grad_(True) for p in (ln[0], ln[1]))
    y_ln = F.layer_norm(xl, (d,), gl, bl, 1e-6)

    @torch.no_grad()
    def lib_ln():
        return F.layer_norm(x, (d,), gl, bl, 1e-6)

    def lib_ln_bwd():
        return torch.autograd.grad(y_ln, (xl, gl, bl), dy, retain_graph=True)

    @torch.no_grad()
    def lib_sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh)

    def lib_sdpa_bwd():
        return torch.autograd.grad(o_sdpa, (qh, kh, vh), doh, retain_graph=True)

    def dqkv_parts(t):
        return tuple(t[..., i * d:(i + 1) * d] for i in range(3))

    # Readings: relative L2, ||kernel - plain|| / ||plain||, per output; max|d|
    # for flash's f32 lse; for the fill, which rounds each cell to bf16 as
    # its plain version does and sums nothing, the count of elements that
    # differ (limit: none). Both sides round the same f32 values to bf16 at the
    # same points, so a sound kernel differs only where f32 summation order
    # tips a value to the neighbouring bf16. The flash forward's o is also
    # read as the share of its elements that differ, which sees where P is
    # rounded (another softmax form's max moves 30-50 % of o, its relative L2
    # only ~2e-3). Each limit lies between that noise and the reading of the
    # case's controls: the plain version with one fault the kernel could
    # plausibly have (PERF.md has both readings). Work: flash 4*B*T*T*384
    # flops forward (the two-pass forms do a third product), 5 products
    # (10*B*T*T*384) backward; LN+MLP 4*N*384*1536 forward, 5 products
    # backward; LN and voxel_embed are bound by their bytes.
    flash_flops = 4 * batch * tokens * tokens * d
    fpk = importlib.import_module("intentbev_torch.ops.flash_packed")
    FWD_CHUNK = 1152  # divides the 4608 rows JAX pads 4501 tokens to
    # the forward's limits: sound <= 2.4e-4 (relative L2), <= 0.82 % of o
    # (share), lse <= 2e-6; another form's P >= 2.1e-3 and >= 30 % (PERF.md)
    FWD_METRICS, FWD_LIMITS = (rel_l2, share, max_abs), (1e-3, 2e-2, 1e-3)
    # the LN+MLP forwards: each output's relative L2, then its share of
    # differing elements (the h-in-f32 control moves ~30 %, sound ~0.4 %)
    MLP_METRICS = {1: (rel_l2, share), 2: (rel_l2, rel_l2, share, share)}
    MLP_LIMITS = {1: (1e-3, 2e-2), 2: (1e-3, 1e-3, 2e-2, 2e-2)}
    # the LN+MLP backwards: dx's relative L2 and share of differing elements
    # (the dg-in-f32 control moves the share), every other output's
    # relative L2 (PERF.md has the sound and control readings)
    BWD_METRICS = {7: (rel_l2, share) + (rel_l2,) * 6, 5: (rel_l2, share) + (rel_l2,) * 4}
    BWD_LIMITS = {7: (2e-3, 2e-2) + (2e-3,) * 6, 5: (2e-3, 2e-2) + (2e-3,) * 4}
    # the LN backward (row 9): dx's relative L2 and share of differing
    # elements, dgamma's and dbeta's relative L2 (the control without the
    # mean(dyg*xhat) term moves most of dx)
    LN_BWD_METRICS, LN_BWD_LIMITS = (rel_l2, share, rel_l2, rel_l2), (1e-3, 2e-2, 1e-3, 1e-3)

    def bhtd_plain_form(q_, k_, v_, seq=None, form="fixed"):
        """The BHTD plain forward with P rounded against another form's max
        (the controls' fault; the BHTD kernel takes the row max)."""
        b_, h_, t_, d_ = q_.shape
        seq = t_ if seq is None else seq
        sc_ = torch.tensor(d_ ** -0.5, dtype=q_.dtype)
        o_ = torch.empty(b_, h_, t_, d_, dtype=q_.dtype, device=q_.device)
        lse_ = torch.empty(b_, h_, t_, device=q_.device)
        for i in range(b_):
            s_ = torch.matmul((q_[i] * sc_).float(), k_[i].float().transpose(-1, -2))
            s_[..., seq:] = float("-inf")
            oi, lse_[i] = fpk.softmax_pv(s_, v_[i].float(), q_.dtype, form)
            o_[i] = oi.to(q_.dtype)
        return o_, lse_
    mlp_flops = 4 * rows * d * hidden
    # row 17: y's relative L2 and share of differing elements (the kernel
    # matches its plain version bit for bit; the controls move most of y)
    INT8_METRICS, INT8_LIMITS = (rel_l2, share), (5e-4, 1e-3)
    pe_flops = 2 * batch * v.num_patches * v.patch_size ** 2 * v.lidar_input_channels * d
    # rows 15 and 1: the tokens' relative L2 and share of differing elements
    # (the plain versions sum in another order: sound ~1 % of row 15's
    # tokens over K = 18560, ~0.01 % of row 1's; the sum rounded before the
    # bias moves ~26 %, a skipped chunk the relative L2)
    PATCH_LIMITS, VOXEL_LIMITS = (1e-3, 5e-2), (3e-3, 2e-2)
    rates = {"fused_mlp_int8": INT8_OPS_PER_S,  # ops of another type than bf16
             "fused_mlp_int8[D=192]": INT8_OPS_PER_S}
    cases = {
        # json name: (kernel call, plain call, control call, the control's
        #   fault, metrics, limits, kernel iters, plain iters, bytes, flops,
        #   library call or None)
        "voxel_embed": (
            lambda: twice(voxel_embed_tokens(chunks, w_pe, b_pe, v.patch_size, hw)),
            lambda: twice(voxel_embed_tokens_plain(chunks, w_pe, b_pe, v.patch_size, hw)),
            lambda: twice(voxel_embed_tokens_plain(
                chunks._replace(count=(chunks.count - 1).clamp(min=0)),
                w_pe, b_pe, v.patch_size, hw)),
            "last chunk of each band skipped", (rel_l2, share), VOXEL_LIMITS, 10, 3,
            nbytes(*chunks, w_pe, b_pe) + batch * v.num_patches * d * 2,
            2 * cells * d, None),
        "voxel_fill": (
            lambda: voxel_fill_bev(chunks, hw, g.lidar_total_channels, v.patch_size),
            lambda: voxel_fill_bev_plain(chunks, hw, g.lidar_total_channels, v.patch_size),
            lambda: voxel_fill_bev_plain(
                chunks._replace(count=(chunks.count - 1).clamp(min=0)), hw,
                g.lidar_total_channels, v.patch_size),
            "last chunk of each band skipped", (n_differ,), (1,), 20, 3, fill_bytes, 0, None),
        # the forward in JAX's three softmax forms (monolithic safe, fixed max,
        # chunked safe at 1152 keys); controls: another form's plain version
        "flash_packed": (
            lambda: o_twice(flash_attention_packed(q, k, vv, heads)),
            lambda: o_twice(flash_attention_packed_plain(q, k, vv, heads)),
            [lambda: o_twice(flash_attention_packed_plain(q, k, vv, heads, None, 0, True)),
             lambda: o_twice(flash_attention_packed_plain(q, k, vv, heads, tile_len))],
            ["P rounded against the fixed max", "keys of the last partial tile masked"],
            FWD_METRICS, FWD_LIMITS, 10, 3, nbytes(q, k, vv, o, lse), flash_flops, lib_sdpa),
        "flash_packed_fixed": (
            lambda: o_twice(flash_attention_packed(q, k, vv, heads, None, FWD_CHUNK, True)),
            lambda: o_twice(flash_attention_packed_plain(q, k, vv, heads, None, FWD_CHUNK, True)),
            lambda: o_twice(flash_attention_packed_plain(q, k, vv, heads)),
            "P rounded against the row max", FWD_METRICS, FWD_LIMITS, 10, 3,
            nbytes(q, k, vv, o, lse), flash_flops, lib_sdpa),
        "flash_packed_chunked": (
            lambda: o_twice(flash_attention_packed(q, k, vv, heads, None, FWD_CHUNK)),
            lambda: o_twice(flash_attention_packed_plain(q, k, vv, heads, None, FWD_CHUNK)),
            lambda: o_twice(flash_attention_packed_plain(q, k, vv, heads)),
            "P rounded against the row max, not the running max", FWD_METRICS, FWD_LIMITS,
            10, 3, nbytes(q, k, vv, o, lse), flash_flops, lib_sdpa),
        "fused_ln_mlp[erf]": (
            lambda: twice(fused_ln_mlp(*mlp_args, gelu_mode="erf")),
            lambda: twice(fused_ln_mlp_plain(*mlp_args, gelu_mode="erf")),
            [lambda: twice(fused_ln_mlp_plain(*mlp_args, gelu_mode="sigmoid")),
             lambda: twice(h_f32(x, w1, b1, w2, b2, "erf", ln[:2], ln_next=ln[2:]))],
            ["sigmoid GELU", "h kept in f32"], MLP_METRICS[2], MLP_LIMITS[2], 10, 3,
            nbytes(x, w1, b1, w2, b2, *ln) + 2 * nbytes(x), mlp_flops, None),
        "fused_ln_mlp": (
            lambda: twice(fused_ln_mlp(*mlp_args, gelu_mode="sigmoid")),
            lambda: twice(fused_ln_mlp_plain(*mlp_args, gelu_mode="sigmoid")),
            [lambda: twice(fused_ln_mlp_plain(*mlp_args, gelu_mode="erf")),
             lambda: twice(h_f32(x, w1, b1, w2, b2, "sigmoid", ln[:2], ln_next=ln[2:]))],
            ["erf GELU", "h kept in f32"], MLP_METRICS[2], MLP_LIMITS[2], 10, 3,
            nbytes(x, w1, b1, w2, b2, *ln) + 2 * nbytes(x), mlp_flops, None),
        "layernorm": (
            lambda: layernorm(x, ln[0], ln[1]),
            lambda: layernorm_plain(x, ln[0], ln[1]),
            lambda: layernorm_unbiased(x, ln[0], ln[1]),
            "variance over N-1", (rel_l2,), (3e-4,), 20, 5,
            2 * nbytes(x) + nbytes(ln[0], ln[1]), 0, lib_ln),
        "layernorm_train": (
            lambda: layernorm_train(x, ln[0], ln[1]),
            lambda: layernorm_train_plain(x, ln[0], ln[1]),
            lambda: layernorm_unbiased(x, ln[0], ln[1], train=True),
            "variance over N-1", (rel_l2,) * 3, (3e-4, 3e-4, 1e-5), 20, 5,
            3 * nbytes(x) + nbytes(inv, ln[0], ln[1]), 0, lib_ln),
        "layernorm_bwd": (
            lambda: dx_twice(layernorm_bwd(dy, xhat, inv, ln[0])),
            lambda: dx_twice(layernorm_bwd_plain(dy, xhat, inv, ln[0])),
            lambda: dx_twice(layernorm_bwd_no_m2(dy, xhat, inv, ln[0])),
            "no mean(dyg*xhat) term", LN_BWD_METRICS, LN_BWD_LIMITS, 20, 5,
            3 * nbytes(x) + nbytes(inv, ln[0]) + 2 * d * 4, 0, lib_ln_bwd),
        "fused_ln_mlp_train": (
            lambda: twice(fused_ln_mlp_train(*train_mlp, b2, gate)),
            lambda: twice(fused_ln_mlp_train_plain(*train_mlp, b2, gate)),
            [lambda: twice(fused_ln_mlp_train_plain(*train_mlp, b2)),
             lambda: twice(h_f32(x3, w1, b1, w2, b2, "erf", ln[:2], gate))],
            ["gate ignored", "h kept in f32"], MLP_METRICS[1], MLP_LIMITS[1], 10, 3,
            nbytes(x, w1, b1, w2, b2, ln[0], ln[1], gate) + nbytes(x), mlp_flops, None),
        "fused_ln_mlp_bwd": (
            lambda: dx_twice(fused_ln_mlp_bwd(*train_mlp, gate, dy3)),
            lambda: dx_twice(fused_ln_mlp_bwd_plain(*train_mlp, gate, dy3)),
            [lambda: dx_twice(fused_ln_mlp_bwd_plain(*train_mlp, None, dy3)),
             lambda: dg_f32(lambda: fused_ln_mlp_bwd_plain(*train_mlp, gate, dy3), x3, w1, b1,
                            w2, gate, dy3, ln[:2])],
            ["gate ignored", "dg kept in f32"], BWD_METRICS[7], BWD_LIMITS[7], 5, 2,
            3 * nbytes(x) + nbytes(w1, b1, w2, ln[0], ln[1], gate)
            + 4 * (3 * d + hidden + 2 * d * hidden), 5 * mlp_flops // 2, None),
        "flash_packed_bwd": (
            lambda: dqkv_parts(flash_attention_packed_bwd(q, k, vv, o, lse, do, heads)),
            lambda: dqkv_parts(flash_attention_packed_bwd_plain(q, k, vv, o, lse, do, heads)),
            lambda: dqkv_parts(flash_attention_packed_bwd_plain(
                q, k, vv, torch.zeros_like(o), lse, do, heads)),
            "delta = rowsum(dO*O) left out", (rel_l2,) * 3, (1e-2,) * 3, 5, 2,
            nbytes(q, k, vv, o, do, lse) + nbytes(qkv), 5 * flash_flops // 2, lib_sdpa_bwd),
        "fused_mlp_int8": (
            lambda: twice(fused_mlp_int8(*int8_args, "sigmoid")),
            lambda: twice(fused_mlp_int8_plain(*int8_args, "sigmoid")),
            [lambda: fused_mlp_int8_faulty(*int8_args, "sigmoid", "block"),
             lambda: fused_mlp_int8_faulty(*int8_args, "sigmoid", "h_bf16")],
            ["one h scale per 32-row block", "h rounded to bf16 before its codes"],
            INT8_METRICS, INT8_LIMITS, 10, 2, nbytes(*int8_args) + nbytes(x), mlp_flops, None),
        "fused_mlp": (
            lambda: twice(fused_mlp(x8, w1, b1, w2, b2, x, gelu_mode="sigmoid")),
            lambda: twice(fused_mlp_plain(x8, w1, b1, w2, b2, x, gelu_mode="sigmoid")),
            [lambda: twice(fused_mlp_plain(x8, w1, torch.zeros_like(b1), w2, b2, x,
                                           gelu_mode="sigmoid")),
             lambda: twice(h_f32(x8, w1, b1, w2, b2, "sigmoid", res_=x))],
            ["b1 left out", "h kept in f32"], MLP_METRICS[1], MLP_LIMITS[1], 10, 3,
            nbytes(x8, w1, b1, w2, b2, x) + nbytes(x), mlp_flops, None),
        "fused_ln_dense": (
            lambda: twice(fused_ln_dense(x, ln[0], ln[1], w_qkv, b_qkv)),
            lambda: twice(fused_ln_dense_plain(x, ln[0], ln[1], w_qkv, b_qkv)),
            [lambda: twice(fused_ln_dense_plain(x, ln[0], ln[1], w_qkv, torch.zeros_like(b_qkv))),
             lambda: twice(xn_f32(x, ln[:2], w_qkv, b_qkv))],
            ["bias left out", "xn kept in f32"], MLP_METRICS[1], MLP_LIMITS[1], 20, 3,
            nbytes(x, ln[0], ln[1], w_qkv, b_qkv) + rows * 3 * d * 2, 2 * rows * d * 3 * d,
            None),
        "fused_ln_dense[adapter]": (
            lambda: twice(fused_ln_dense(x_ad, ln[0], ln[1], w_ad, b_ad, gelu_mode="sigmoid")),
            lambda: twice(fused_ln_dense_plain(x_ad, ln[0], ln[1], w_ad, b_ad,
                                               gelu_mode="sigmoid")),
            [lambda: twice(fused_ln_dense_plain(x_ad, ln[0], ln[1], w_ad, b_ad)),
             lambda: twice(xn_f32(x_ad, ln[:2], w_ad, b_ad, "sigmoid"))],
            ["GELU epilogue skipped", "xn kept in f32"], MLP_METRICS[1], MLP_LIMITS[1], 20, 3,
            nbytes(x_ad, ln[0], ln[1], w_ad, b_ad) + x_ad.shape[0] * a_out * 2,
            2 * x_ad.shape[0] * d * a_out, None),
        # the adapter's training forward (erf GELU): held, not listed (its
        # launches count under fused_ln_dense)
        "fused_ln_dense[adapter,erf]": (
            lambda: twice(fused_ln_dense(x_ad, ln[0], ln[1], w_ad, b_ad, gelu_mode="erf")),
            lambda: twice(fused_ln_dense_plain(x_ad, ln[0], ln[1], w_ad, b_ad, gelu_mode="erf")),
            [lambda: twice(fused_ln_dense_plain(x_ad, ln[0], ln[1], w_ad, b_ad,
                                                gelu_mode="sigmoid")),
             lambda: twice(xn_f32(x_ad, ln[:2], w_ad, b_ad, "erf"))],
            ["sigmoid GELU", "xn kept in f32"], MLP_METRICS[1], MLP_LIMITS[1], 20, 3,
            nbytes(x_ad, ln[0], ln[1], w_ad, b_ad) + x_ad.shape[0] * a_out * 2,
            2 * x_ad.shape[0] * d * a_out, None),
        "fused_mlp_train": (
            lambda: fused_mlp_train(x8, w1, b1, w2, b2, x, gate_r),
            lambda: fused_mlp_plain(x8, w1, b1, w2, b2, x, gate=gate_r),
            lambda: fused_mlp_plain(x8, w1, b1, w2, b2, x),
            "gate ignored", (rel_l2,), (1e-3,), 10, 3,
            nbytes(x8, w1, b1, w2, b2, x, gate_r) + nbytes(x), mlp_flops, None),
        "fused_mlp_bwd": (
            lambda: dx_twice(fused_mlp_bwd(x8, w1, b1, w2, gate_r, dy)),
            lambda: dx_twice(fused_mlp_bwd_plain(x8, w1, b1, w2, gate_r, dy)),
            [lambda: dx_twice(fused_mlp_bwd_plain(x8, w1, b1, w2, None, dy)),
             lambda: dg_f32(lambda: fused_mlp_bwd_plain(x8, w1, b1, w2, gate_r, dy), x8, w1, b1,
                            w2, gate_r, dy)],
            ["gate ignored", "dg kept in f32"], BWD_METRICS[5], BWD_LIMITS[5], 5, 2,
            3 * nbytes(x8) + nbytes(w1, b1, w2, gate_r) + 4 * (d + hidden + 2 * d * hidden),
            5 * mlp_flops // 2, None),
        "fused_mlp_bwd[no gate]": (
            lambda: dx_twice(fused_mlp_bwd(x8, w1, b1, w2, None, dy)),
            lambda: dx_twice(fused_mlp_bwd_plain(x8, w1, b1, w2, None, dy)),
            [lambda: dx_twice(gelu_grad_skipped(
                "fused_mlp", lambda: fused_mlp_bwd_plain(x8, w1, b1, w2, None, dy))),
             lambda: dg_f32(lambda: fused_mlp_bwd_plain(x8, w1, b1, w2, None, dy), x8, w1, b1,
                            w2, None, dy)],
            ["GELU' skipped", "dg kept in f32"], BWD_METRICS[5], BWD_LIMITS[5], 5, 2,
            3 * nbytes(x8) + nbytes(w1, b1, w2) + 4 * (d + hidden + 2 * d * hidden),
            5 * mlp_flops // 2, None),
        "fused_ln_dense_bwd": (
            lambda: dx_twice(fused_ln_dense_bwd(x, ln[0], ln[1], w_qkv, b_qkv, dy_qkv)),
            lambda: dx_twice(fused_ln_dense_bwd_plain(x, ln[0], ln[1], w_qkv, b_qkv, dy_qkv)),
            [lambda: dx_twice(ln_dense_bwd_no_m2(x, ln[0], ln[1], w_qkv, b_qkv, dy_qkv)),
             lambda: ln_dense_dx_moved(x, ln[:2], w_qkv, b_qkv, dy_qkv)],
            ["no mean(dyg*xhat) term", "dxn rounded before the LN backward"],
            BWD_METRICS[5], BWD_LIMITS[5], 10, 2,
            2 * nbytes(x) + nbytes(dy_qkv, ln[0], ln[1], w_qkv, b_qkv)
            + 4 * (2 * d + 3 * d * d + 3 * d), 2 * 2 * rows * d * 3 * d, None),
        "fused_ln_dense_bwd[adapter]": (
            lambda: dx_twice(fused_ln_dense_bwd(x_ad, ln[0], ln[1], w_ad, b_ad, dy_ad,
                                                gelu_mode="erf")),
            lambda: dx_twice(fused_ln_dense_bwd_plain(x_ad, ln[0], ln[1], w_ad, b_ad, dy_ad,
                                                      gelu_mode="erf")),
            [lambda: dx_twice(gelu_grad_skipped("fused_ln_dense", lambda: fused_ln_dense_bwd_plain(
                x_ad, ln[0], ln[1], w_ad, b_ad, dy_ad, gelu_mode="erf"))),
             lambda: ln_dense_dx_moved(x_ad, ln[:2], w_ad, b_ad, dy_ad, "erf")],
            ["GELU' skipped", "dg kept in f32"], BWD_METRICS[5], BWD_LIMITS[5], 10, 2,
            2 * nbytes(x_ad) + nbytes(dy_ad, ln[0], ln[1], w_ad, b_ad)
            + 4 * (2 * d + a_out * d + a_out), 3 * 2 * x_ad.shape[0] * d * a_out, None),
        "patch_embed": (
            lambda: twice(patch_embed(x_pe, w_pe, b_pe, v.patch_size)),
            lambda: twice(patch_embed_plain(x_pe, w_pe, b_pe, v.patch_size)),
            [lambda: twice(patch_embed_plain(x_pe, w_pe.transpose(0, 1).contiguous(), b_pe,
                                             v.patch_size)),
             lambda: twice(pe_rounded(w_pe, b_pe))],
            ["weight read as w[dx, dy]", "sum rounded to bf16 before the bias"],
            (rel_l2, share), PATCH_LIMITS, 10, 2,
            nbytes(x_pe, w_pe, b_pe) + batch * v.num_patches * d * 2, pe_flops, lib_conv),
    }

    # Tensor parallelism's shard shapes (phase 16, model_parallel=2): row 13 at
    # a rank's hidden 768 with the residual and fc2's bias zero (every rank
    # but the model axis's first), and row 14 at a rank's qkv shard under B
    # (Dout 576: 3 heads of 64 of each of q, k, v); each case as the
    # one-process one of the same kernel (same faults, limits, work
    # formulas). Row 16 at 3 heads of 64 over [8, 4501] is ViT-Ti's instance
    # below, and rows 8 and 9 the one-process ones: the same shapes.
    hid_s = hidden // 2
    w1_s, b1_s, w2_s = w1[:hid_s].contiguous(), b1[:hid_s].contiguous(), w2[:, :hid_s].contiguous()
    zero_b2, zero_res = torch.zeros_like(b2), torch.zeros_like(x)
    w_qkv_s, b_qkv_s = w_qkv[:3 * d // 2].contiguous(), b_qkv[:3 * d // 2].contiguous()
    dy_qkv_s = dy_qkv[:, :3 * d // 2].contiguous()
    cases.update({
        "fused_mlp_train[TP,hidden=768]": (
            lambda: fused_mlp_train(x8, w1_s, b1_s, w2_s, zero_b2, zero_res, gate_r),
            lambda: fused_mlp_plain(x8, w1_s, b1_s, w2_s, zero_b2, zero_res, gate=gate_r),
            lambda: fused_mlp_plain(x8, w1_s, b1_s, w2_s, zero_b2, zero_res),
            "gate ignored", (rel_l2,), (1e-3,), 10, 3,
            nbytes(x8, w1_s, b1_s, w2_s, zero_b2, zero_res, gate_r) + nbytes(x),
            mlp_flops // 2, None),
        "fused_mlp_bwd[TP,hidden=768]": (
            lambda: dx_twice(fused_mlp_bwd(x8, w1_s, b1_s, w2_s, gate_r, dy)),
            lambda: dx_twice(fused_mlp_bwd_plain(x8, w1_s, b1_s, w2_s, gate_r, dy)),
            [lambda: dx_twice(fused_mlp_bwd_plain(x8, w1_s, b1_s, w2_s, None, dy)),
             lambda: dg_f32(lambda: fused_mlp_bwd_plain(x8, w1_s, b1_s, w2_s, gate_r, dy), x8,
                            w1_s, b1_s, w2_s, gate_r, dy)],
            ["gate ignored", "dg kept in f32"], BWD_METRICS[5], BWD_LIMITS[5], 5, 2,
            3 * nbytes(x8) + nbytes(w1_s, b1_s, w2_s, gate_r) + 4 * (d + hid_s + 2 * d * hid_s),
            5 * mlp_flops // 4, None),
        "fused_ln_dense[TP,Dout=576]": (
            lambda: twice(fused_ln_dense(x, ln[0], ln[1], w_qkv_s, b_qkv_s)),
            lambda: twice(fused_ln_dense_plain(x, ln[0], ln[1], w_qkv_s, b_qkv_s)),
            [lambda: twice(fused_ln_dense_plain(x, ln[0], ln[1], w_qkv_s,
                                                torch.zeros_like(b_qkv_s))),
             lambda: twice(xn_f32(x, ln[:2], w_qkv_s, b_qkv_s))],
            ["bias left out", "xn kept in f32"], MLP_METRICS[1], MLP_LIMITS[1], 20, 3,
            nbytes(x, ln[0], ln[1], w_qkv_s, b_qkv_s) + rows * 3 * d, rows * d * 3 * d, None),
        "fused_ln_dense_bwd[TP,Dout=576]": (
            lambda: dx_twice(fused_ln_dense_bwd(x, ln[0], ln[1], w_qkv_s, b_qkv_s, dy_qkv_s)),
            lambda: dx_twice(fused_ln_dense_bwd_plain(x, ln[0], ln[1], w_qkv_s, b_qkv_s,
                                                      dy_qkv_s)),
            [lambda: dx_twice(ln_dense_bwd_no_m2(x, ln[0], ln[1], w_qkv_s, b_qkv_s, dy_qkv_s)),
             lambda: ln_dense_dx_moved(x, ln[:2], w_qkv_s, b_qkv_s, dy_qkv_s)],
            ["no mean(dyg*xhat) term", "dxn rounded before the LN backward"],
            BWD_METRICS[5], BWD_LIMITS[5], 10, 2,
            2 * nbytes(x) + nbytes(dy_qkv_s, ln[0], ln[1], w_qkv_s, b_qkv_s)
            + 4 * (2 * d + 3 * d * d // 2 + 3 * d // 2), 2 * rows * d * 3 * d, None),
    })

    # ViT-Ti (vit_tiny's widths, intentbev/import_torch.py:235: embed 192, 3
    # heads of 64, MLP 768) at its main-path shapes: the BHTD attention on
    # the views of the qkv projection output (its heads do not pair into 128
    # lanes), and the D=192 instances of the row kernels, each case as the
    # D=384 one of the same kernel (same faults, limits and work formulas).
    # Attention also at head dim 32 on a small contiguous [2, 3, 1000, 32]
    # input with keys past 950 masked (the scale 32**-0.5 rounds in bf16).
    dt_, ht_ = d // 2, heads // 2
    hid_t = int(dt_ * v.mlp_ratio)
    qkv_t = randn((batch, tokens, 3 * dt_), 1.0)
    qkv_v = [heads_view(qkv_t[..., i * dt_:(i + 1) * dt_], ht_) for i in range(3)]
    o_t, lse_t = flash_attention_packed_layout(*(qkv_t[..., i * dt_:(i + 1) * dt_]
                                                 for i in range(3)), ht_)
    o_tv, do_tv = heads_view(o_t, ht_), heads_view(randn((batch, tokens, dt_), 1.0), ht_)
    qh_t, kh_t, vh_t, doh_t = (t.contiguous().requires_grad_(t is not do_tv)
                               for t in (*qkv_v, do_tv))
    o_sdpa_t = F.scaled_dot_product_attention(qh_t, kh_t, vh_t)
    q32, k32, v32, do32 = (randn((2, 3, 1000, 32), 1.0) for _ in range(4))
    o32, lse32 = flash_attention_fwd_plain(q32, k32, v32, 950)
    x_t, dy_t = randn((rows, dt_), 1.0), randn((rows, dt_), 1.0)
    ln_t = [randn((dt_,), 0.2, torch.float32) + (1 - i % 2) for i in range(4)]
    w1_t, b1_t = randn((hid_t, dt_), dt_ ** -0.5), randn((hid_t,), 0.1, torch.float32)
    w2_t, b2_t = randn((dt_, hid_t), hid_t ** -0.5), randn((dt_,), 0.1, torch.float32)
    mlp_t = (x_t, ln_t[0], ln_t[1], w1_t, b1_t, w2_t, b2_t, ln_t[2], ln_t[3])
    train_t = (x_t.view(batch, tokens, dt_), ln_t[0], ln_t[1], w1_t, b1_t, w2_t)
    _, xhat_t, inv_t = layernorm_train_plain(x_t, ln_t[0], ln_t[1])
    w_pe_t, b_pe_t = randn(w_pe.shape[:3] + (dt_,), 0.02), randn((dt_,), 0.02, torch.float32)
    w_conv_t = w_pe_t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    gl_t, bl_t = (p.to(torch.bfloat16).requires_grad_(True) for p in (ln_t[0], ln_t[1]))
    xl_t = x_t.detach().clone().requires_grad_(True)
    y_ln_t = F.layer_norm(xl_t, (dt_,), gl_t, bl_t, 1e-6)
    flash_flops_t = 4 * batch * tokens * tokens * dt_
    mlp_flops_t = 4 * rows * dt_ * hid_t
    # ViT-Ti's qkv projection under B: the LN + dense pair at D=192, Dout 576
    w_qkv_t, b_qkv_t = randn((3 * dt_, dt_), dt_ ** -0.5), randn((3 * dt_,), 0.1, torch.float32)
    dy_qkv_t = randn((rows, 3 * dt_), 1.0)
    # and its adapters: [36000, 192] -> 192, the serving sigmoid GELU, the
    # training erf GELU and its backward
    x_ad_t = randn((x_ad.shape[0], dt_), 1.0)
    w_ad_t, b_ad_t = randn((a_out, dt_), dt_ ** -0.5), randn((a_out,), 0.1, torch.float32)
    dy_ad_t = randn((x_ad.shape[0], a_out), 1.0)
    ad_bytes_t = nbytes(x_ad_t, ln_t[0], ln_t[1], w_ad_t, b_ad_t) + x_ad.shape[0] * a_out * 2
    ad_flops_t = 2 * x_ad.shape[0] * dt_ * a_out
    # and its W8A8 MLP under A: rows of varied scale, the codes of its weights
    x8_t = (torch.randn(rows, dt_, generator=gen, device=dev)
            * torch.exp(0.5 * torch.randn(rows, 1, generator=gen, device=dev))).bfloat16()
    w1q_t, s1_t = quantize_linear(w1_t.float())
    w2q_t, s2_t = quantize_linear(w2_t.float())
    int8_args_t = (x8_t, w1q_t, s1_t, b1_t, w2q_t, s2_t, b2_t, x_t)

    def bhtd_attn_plain_ctl(*a):
        # the control's fault: delta = rowsum(dO*O) left out (O = 0)
        return flash_attention_bwd_plain(a[0], a[1], a[2], torch.zeros_like(a[3]), *a[4:])

    cases.update({
        "flash_attention": (
            lambda: o_twice(flash_attention_fwd(*qkv_v, out=o_tv)),
            lambda: o_twice(flash_attention_fwd_plain(*qkv_v)),
            [lambda: o_twice(bhtd_plain_form(*qkv_v)),
             lambda: o_twice(flash_attention_fwd_plain(*qkv_v, tile_len))],
            ["P rounded against the fixed max", "keys of the last partial tile masked"],
            FWD_METRICS, FWD_LIMITS, 10, 3, nbytes(qkv_t, o_t, lse_t), flash_flops_t,
            torch.no_grad()(lambda: F.scaled_dot_product_attention(qh_t, kh_t, vh_t))),
        "flash_attention_bwd": (
            lambda: flash_attention_bwd(*qkv_v, o_tv, lse_t, do_tv),
            lambda: flash_attention_bwd_plain(*qkv_v, o_tv, lse_t, do_tv),
            lambda: bhtd_attn_plain_ctl(*qkv_v, o_tv, lse_t, do_tv),
            "delta = rowsum(dO*O) left out", (rel_l2,) * 3, (1e-2,) * 3, 5, 2,
            nbytes(qkv_t, o_t, o_t, lse_t) + nbytes(qkv_t), 5 * flash_flops_t // 2,
            lambda: torch.autograd.grad(o_sdpa_t, (qh_t, kh_t, vh_t), doh_t,
                                        retain_graph=True)),
        "flash_attention[D=32]": (
            lambda: o_twice(flash_attention_fwd(q32, k32, v32, 950)),
            lambda: o_twice(flash_attention_fwd_plain(q32, k32, v32, 950)),
            [lambda: o_twice(bhtd_plain_form(q32, k32, v32, 950)),
             lambda: o_twice(flash_attention_fwd_plain(q32, k32, v32, 1000))],
            ["P rounded against the fixed max", "keys past seq_len not masked"],
            FWD_METRICS, FWD_LIMITS, 20, 3, nbytes(q32, k32, v32, o32, lse32),
            4 * 2 * 3 * 1000 * 950 * 32, None),
        "flash_attention_bwd[D=32]": (
            lambda: flash_attention_bwd(q32, k32, v32, o32, lse32, do32, 950),
            lambda: flash_attention_bwd_plain(q32, k32, v32, o32, lse32, do32, 950),
            lambda: bhtd_attn_plain_ctl(q32, k32, v32, o32, lse32, do32, 950),
            "delta = rowsum(dO*O) left out", (rel_l2,) * 3, (1e-2,) * 3, 20, 3,
            nbytes(q32, k32, v32, o32, do32, lse32) + 3 * nbytes(q32),
            10 * 2 * 3 * 1000 * 950 * 32, None),
        "voxel_embed[D=192]": (
            lambda: twice(voxel_embed_tokens(chunks, w_pe_t, b_pe_t, v.patch_size, hw)),
            lambda: twice(voxel_embed_tokens_plain(chunks, w_pe_t, b_pe_t, v.patch_size, hw)),
            lambda: twice(voxel_embed_tokens_plain(
                chunks._replace(count=(chunks.count - 1).clamp(min=0)),
                w_pe_t, b_pe_t, v.patch_size, hw)),
            "last chunk of each band skipped", (rel_l2, share), VOXEL_LIMITS, 10, 3,
            nbytes(*chunks, w_pe_t, b_pe_t) + batch * v.num_patches * dt_ * 2,
            2 * cells * dt_, None),
        "patch_embed[D=192]": (
            lambda: twice(patch_embed(x_pe, w_pe_t, b_pe_t, v.patch_size)),
            lambda: twice(patch_embed_plain(x_pe, w_pe_t, b_pe_t, v.patch_size)),
            [lambda: twice(patch_embed_plain(x_pe, w_pe_t.transpose(0, 1).contiguous(), b_pe_t,
                                             v.patch_size)),
             lambda: twice(pe_rounded(w_pe_t, b_pe_t))],
            ["weight read as w[dx, dy]", "sum rounded to bf16 before the bias"],
            (rel_l2, share), PATCH_LIMITS, 10, 2,
            nbytes(x_pe, w_pe_t, b_pe_t) + batch * v.num_patches * dt_ * 2, pe_flops // 2,
            torch.no_grad()(lambda: F.conv2d(x_pe.permute(0, 3, 1, 2), w_conv_t,
                                             b_pe_t.bfloat16(), stride=v.patch_size))),
        "fused_ln_mlp[D=192]": (
            lambda: twice(fused_ln_mlp(*mlp_t, gelu_mode="sigmoid")),
            lambda: twice(fused_ln_mlp_plain(*mlp_t, gelu_mode="sigmoid")),
            [lambda: twice(fused_ln_mlp_plain(*mlp_t, gelu_mode="erf")),
             lambda: twice(h_f32(x_t, w1_t, b1_t, w2_t, b2_t, "sigmoid", ln_t[:2],
                                 ln_next=ln_t[2:]))],
            ["erf GELU", "h kept in f32"], MLP_METRICS[2], MLP_LIMITS[2], 10, 3,
            nbytes(x_t, w1_t, b1_t, w2_t, b2_t, *ln_t) + 2 * nbytes(x_t), mlp_flops_t, None),
        "layernorm[D=192]": (
            lambda: layernorm(x_t, ln_t[0], ln_t[1]),
            lambda: layernorm_plain(x_t, ln_t[0], ln_t[1]),
            lambda: layernorm_unbiased(x_t, ln_t[0], ln_t[1]),
            "variance over N-1", (rel_l2,), (3e-4,), 20, 5,
            2 * nbytes(x_t) + nbytes(ln_t[0], ln_t[1]), 0,
            torch.no_grad()(lambda: F.layer_norm(x_t, (dt_,), gl_t, bl_t, 1e-6))),
        "layernorm_train[D=192]": (
            lambda: layernorm_train(x_t, ln_t[0], ln_t[1]),
            lambda: layernorm_train_plain(x_t, ln_t[0], ln_t[1]),
            lambda: layernorm_unbiased(x_t, ln_t[0], ln_t[1], train=True),
            "variance over N-1", (rel_l2,) * 3, (3e-4, 3e-4, 1e-5), 20, 5,
            3 * nbytes(x_t) + nbytes(inv_t, ln_t[0], ln_t[1]), 0,
            torch.no_grad()(lambda: F.layer_norm(x_t, (dt_,), gl_t, bl_t, 1e-6))),
        "layernorm_bwd[D=192]": (
            lambda: dx_twice(layernorm_bwd(dy_t, xhat_t, inv_t, ln_t[0])),
            lambda: dx_twice(layernorm_bwd_plain(dy_t, xhat_t, inv_t, ln_t[0])),
            lambda: dx_twice(layernorm_bwd_no_m2(dy_t, xhat_t, inv_t, ln_t[0])),
            "no mean(dyg*xhat) term", LN_BWD_METRICS, LN_BWD_LIMITS, 20, 5,
            3 * nbytes(x_t) + nbytes(inv_t, ln_t[0]) + 2 * dt_ * 4, 0,
            lambda: torch.autograd.grad(y_ln_t, (xl_t, gl_t, bl_t), dy_t, retain_graph=True)),
        "fused_ln_mlp_train[D=192]": (
            lambda: twice(fused_ln_mlp_train(*train_t, b2_t, gate)),
            lambda: twice(fused_ln_mlp_train_plain(*train_t, b2_t, gate)),
            [lambda: twice(fused_ln_mlp_train_plain(*train_t, b2_t)),
             lambda: twice(h_f32(train_t[0], w1_t, b1_t, w2_t, b2_t, "erf", ln_t[:2], gate))],
            ["gate ignored", "h kept in f32"], MLP_METRICS[1], MLP_LIMITS[1], 10, 3,
            nbytes(x_t, w1_t, b1_t, w2_t, b2_t, ln_t[0], ln_t[1], gate) + nbytes(x_t),
            mlp_flops_t, None),
        "fused_ln_mlp_bwd[D=192]": (
            lambda: dx_twice(fused_ln_mlp_bwd(*train_t, gate, dy_t.view(batch, tokens, dt_))),
            lambda: dx_twice(fused_ln_mlp_bwd_plain(*train_t, gate,
                                                    dy_t.view(batch, tokens, dt_))),
            [lambda: dx_twice(fused_ln_mlp_bwd_plain(*train_t, None,
                                                     dy_t.view(batch, tokens, dt_))),
             lambda: dg_f32(lambda: fused_ln_mlp_bwd_plain(*train_t, gate,
                                                           dy_t.view(batch, tokens, dt_)),
                            train_t[0], w1_t, b1_t, w2_t, gate, dy_t, ln_t[:2])],
            ["gate ignored", "dg kept in f32"], BWD_METRICS[7], BWD_LIMITS[7], 5, 2,
            3 * nbytes(x_t) + nbytes(w1_t, b1_t, w2_t, ln_t[0], ln_t[1], gate)
            + 4 * (3 * dt_ + hid_t + 2 * dt_ * hid_t), 5 * mlp_flops_t // 2, None),
        "fused_ln_dense[D=192]": (
            lambda: twice(fused_ln_dense(x_t, ln_t[0], ln_t[1], w_qkv_t, b_qkv_t)),
            lambda: twice(fused_ln_dense_plain(x_t, ln_t[0], ln_t[1], w_qkv_t, b_qkv_t)),
            [lambda: twice(fused_ln_dense_plain(x_t, ln_t[0], ln_t[1], w_qkv_t,
                                                torch.zeros_like(b_qkv_t))),
             lambda: twice(xn_f32(x_t, ln_t[:2], w_qkv_t, b_qkv_t))],
            ["bias left out", "xn kept in f32"], MLP_METRICS[1], MLP_LIMITS[1], 20, 3,
            nbytes(x_t, ln_t[0], ln_t[1], w_qkv_t, b_qkv_t) + rows * 3 * dt_ * 2,
            2 * rows * dt_ * 3 * dt_, None),
        "fused_ln_dense_bwd[D=192]": (
            lambda: dx_twice(fused_ln_dense_bwd(x_t, ln_t[0], ln_t[1], w_qkv_t, b_qkv_t,
                                                dy_qkv_t)),
            lambda: dx_twice(fused_ln_dense_bwd_plain(x_t, ln_t[0], ln_t[1], w_qkv_t, b_qkv_t,
                                                      dy_qkv_t)),
            [lambda: dx_twice(ln_dense_bwd_no_m2(x_t, ln_t[0], ln_t[1], w_qkv_t, b_qkv_t,
                                                 dy_qkv_t)),
             lambda: ln_dense_dx_moved(x_t, ln_t[:2], w_qkv_t, b_qkv_t, dy_qkv_t)],
            ["no mean(dyg*xhat) term", "dxn rounded before the LN backward"],
            BWD_METRICS[5], BWD_LIMITS[5], 10, 2,
            2 * nbytes(x_t) + nbytes(dy_qkv_t, ln_t[0], ln_t[1], w_qkv_t, b_qkv_t)
            + 4 * (2 * dt_ + 3 * dt_ * dt_ + 3 * dt_), 2 * 2 * rows * dt_ * 3 * dt_, None),
        "fused_mlp_int8[D=192]": (
            lambda: twice(fused_mlp_int8(*int8_args_t, "sigmoid")),
            lambda: twice(fused_mlp_int8_plain(*int8_args_t, "sigmoid")),
            [lambda: fused_mlp_int8_faulty(*int8_args_t, "sigmoid", "block"),
             lambda: fused_mlp_int8_faulty(*int8_args_t, "sigmoid", "h_bf16")],
            ["one h scale per 32-row block", "h rounded to bf16 before its codes"],
            INT8_METRICS, INT8_LIMITS, 10, 2, nbytes(*int8_args_t) + nbytes(x_t), mlp_flops_t,
            None),
        # row 13 at D=192, ViT-Ti's MLP tails under C: serving (sigmoid), the
        # gated training forward (erf) and its backward, as the D=384 cases
        "fused_mlp[D=192]": (
            lambda: twice(fused_mlp(x8_t, w1_t, b1_t, w2_t, b2_t, x_t, gelu_mode="sigmoid")),
            lambda: twice(fused_mlp_plain(x8_t, w1_t, b1_t, w2_t, b2_t, x_t,
                                          gelu_mode="sigmoid")),
            [lambda: twice(fused_mlp_plain(x8_t, w1_t, torch.zeros_like(b1_t), w2_t, b2_t, x_t,
                                           gelu_mode="sigmoid")),
             lambda: twice(h_f32(x8_t, w1_t, b1_t, w2_t, b2_t, "sigmoid", res_=x_t))],
            ["b1 left out", "h kept in f32"], MLP_METRICS[1], MLP_LIMITS[1], 10, 3,
            nbytes(x8_t, w1_t, b1_t, w2_t, b2_t, x_t) + nbytes(x_t), mlp_flops_t, None),
        "fused_mlp_train[D=192]": (
            lambda: fused_mlp_train(x8_t, w1_t, b1_t, w2_t, b2_t, x_t, gate_r),
            lambda: fused_mlp_plain(x8_t, w1_t, b1_t, w2_t, b2_t, x_t, gate=gate_r),
            lambda: fused_mlp_plain(x8_t, w1_t, b1_t, w2_t, b2_t, x_t),
            "gate ignored", (rel_l2,), (1e-3,), 10, 3,
            nbytes(x8_t, w1_t, b1_t, w2_t, b2_t, x_t, gate_r) + nbytes(x_t), mlp_flops_t, None),
        "fused_mlp_bwd[D=192]": (
            lambda: dx_twice(fused_mlp_bwd(x8_t, w1_t, b1_t, w2_t, gate_r, dy_t)),
            lambda: dx_twice(fused_mlp_bwd_plain(x8_t, w1_t, b1_t, w2_t, gate_r, dy_t)),
            [lambda: dx_twice(fused_mlp_bwd_plain(x8_t, w1_t, b1_t, w2_t, None, dy_t)),
             lambda: dg_f32(lambda: fused_mlp_bwd_plain(x8_t, w1_t, b1_t, w2_t, gate_r, dy_t),
                            x8_t, w1_t, b1_t, w2_t, gate_r, dy_t)],
            ["gate ignored", "dg kept in f32"], BWD_METRICS[5], BWD_LIMITS[5], 5, 2,
            3 * nbytes(x8_t) + nbytes(w1_t, b1_t, w2_t, gate_r)
            + 4 * (dt_ + hid_t + 2 * dt_ * hid_t), 5 * mlp_flops_t // 2, None),
        # ViT-Ti's adapter instances: held, not listed (their launches count
        # under fused_ln_dense[D=192] and fused_ln_dense_bwd[D=192])
        "fused_ln_dense[adapter,D=192]": (
            lambda: twice(fused_ln_dense(x_ad_t, ln_t[0], ln_t[1], w_ad_t, b_ad_t,
                                         gelu_mode="sigmoid")),
            lambda: twice(fused_ln_dense_plain(x_ad_t, ln_t[0], ln_t[1], w_ad_t, b_ad_t,
                                               gelu_mode="sigmoid")),
            [lambda: twice(fused_ln_dense_plain(x_ad_t, ln_t[0], ln_t[1], w_ad_t, b_ad_t)),
             lambda: twice(xn_f32(x_ad_t, ln_t[:2], w_ad_t, b_ad_t, "sigmoid"))],
            ["GELU epilogue skipped", "xn kept in f32"], MLP_METRICS[1], MLP_LIMITS[1], 20, 3,
            ad_bytes_t, ad_flops_t, None),
        "fused_ln_dense[adapter,erf,D=192]": (
            lambda: twice(fused_ln_dense(x_ad_t, ln_t[0], ln_t[1], w_ad_t, b_ad_t,
                                         gelu_mode="erf")),
            lambda: twice(fused_ln_dense_plain(x_ad_t, ln_t[0], ln_t[1], w_ad_t, b_ad_t,
                                               gelu_mode="erf")),
            [lambda: twice(fused_ln_dense_plain(x_ad_t, ln_t[0], ln_t[1], w_ad_t, b_ad_t,
                                                gelu_mode="sigmoid")),
             lambda: twice(xn_f32(x_ad_t, ln_t[:2], w_ad_t, b_ad_t, "erf"))],
            ["sigmoid GELU", "xn kept in f32"], MLP_METRICS[1], MLP_LIMITS[1], 20, 3,
            ad_bytes_t, ad_flops_t, None),
        "fused_ln_dense_bwd[adapter,D=192]": (
            lambda: dx_twice(fused_ln_dense_bwd(x_ad_t, ln_t[0], ln_t[1], w_ad_t, b_ad_t,
                                                dy_ad_t, gelu_mode="erf")),
            lambda: dx_twice(fused_ln_dense_bwd_plain(x_ad_t, ln_t[0], ln_t[1], w_ad_t, b_ad_t,
                                                      dy_ad_t, gelu_mode="erf")),
            [lambda: dx_twice(gelu_grad_skipped("fused_ln_dense", lambda: fused_ln_dense_bwd_plain(
                x_ad_t, ln_t[0], ln_t[1], w_ad_t, b_ad_t, dy_ad_t, gelu_mode="erf"))),
             lambda: ln_dense_dx_moved(x_ad_t, ln_t[:2], w_ad_t, b_ad_t, dy_ad_t, "erf")],
            ["GELU' skipped", "dg kept in f32"], BWD_METRICS[5], BWD_LIMITS[5], 10, 2,
            2 * nbytes(x_ad_t) + nbytes(dy_ad_t, ln_t[0], ln_t[1], w_ad_t, b_ad_t)
            + 4 * (2 * dt_ + a_out * dt_ + a_out), 3 * ad_flops_t, None),
    })
    record = {}

    def bwd_split(fn, kinds, iters=3):
        """Device ms per call of a backward entry, from a profiler trace:
        its kernels by part (``kinds``: part -> kernel-name substring; the
        last part takes every other kernel: a flash backward's dk/dv and dq
        kernels and its wrapper's own (delta = rowsum(dO*O) and the rest);
        the LN + dense backward's row kernel, dW product and partial sums).
        A trace that holds no device event at all is taken again, up to
        three sessions (the profiler has returned one empty in a long run)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        for session in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            parts = dict.fromkeys(kinds, 0.0)
            for ev in prof.key_averages():
                if ev.device_type != DeviceType.CUDA:
                    continue
                part = next((p_ for p_, key in kinds.items() if key in ev.key), list(kinds)[-1])
                parts[part] += ev.device_time_total / 1e3 / iters
            if any(t > 0 for t in parts.values()):
                break
            print(f"profiler session {session + 1} held no device event; again", flush=True)
        check(all(t > 0 for p_, t in parts.items() if kinds[p_]),
              f"backward trace without its kernels: {parts}")
        return parts

    flash_parts = {"dk/dv": "flash_bwd_dkdv", "dq": "flash_bwd_dq", "wrapper": ""}
    ln_dense_parts = {"rows": "ln_dense_bwd_kernel", "dW": "dw_gemm", "sums": ""}

    def check_kernels(cases):
        """Each case's kernel against its plain version and control; its
        times, bound and library time go to ``record``."""
        for name, (kern, plain, control, fault, metrics, limits, it_k, it_p, n_bytes, flops,
                   library) in cases.items():
            def tup(r):
                return r if isinstance(r, tuple) else (r,)
            got, want = tup(kern()), tup(plain())
            torch.cuda.synchronize()
            controls = list(zip(control, fault)) if isinstance(control, list) else [
                (control, fault)]
            caught = []
            for c_call, c_fault in controls:  # each control must be caught
                sound, ctrl_r = compare(name, got, want, tup(c_call()), metrics, limits, c_fault)
                caught.append(f"control ({c_fault}) [{', '.join(f'{r:.3e}' for r in ctrl_r)}]")
            abs_err = max(max_abs(a, b) for a, b in zip(got, want))
            del got, want
            ms, plain_ms = cuda_ms(kern, it_k), cuda_ms(plain, it_p)
            lib_ms = cuda_ms(library, it_k) if library is not None else None
            bound_ms, bound_by = bound(n_bytes, flops, rates.get(name, BF16_FLOPS_PER_S))
            record[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
            fmt = ", ".join
            lib = f"{lib_ms:.3f} ms" if lib_ms is not None else "none"
            print(f"kernel {name}: readings [{fmt(f'{r:.3e}' for r in sound)}] "
                  f"under limits [{fmt(f'{lim:g}' for lim in limits)}]; {fmt(caught)} "
                  f"caught; max|d| {abs_err:.3e}; "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib}, bound "
                  f"{bound_ms:.4f} ms ({bound_by})  [{card}]", flush=True)
            if name.startswith(("flash_packed_bwd", "flash_attention_bwd", "fused_ln_dense_bwd")):
                parts = bwd_split(kern, ln_dense_parts if name.startswith("fused_ln_dense")
                                  else flash_parts)
                print(f"kernel {name} by kernel (profiler trace, per call): "
                      + ", ".join(f"{k_} {t:.3f} ms" for k_, t in parts.items())
                      + f"; {flops / ms / 1e9:.1f} TFLOP/s of the bound's work "
                      f"(bound {bound_ms:.4f} ms)  [{card}]", flush=True)

    def same_bits(cases_, names):
        """Two calls of each named kernel give the same bits (its sums run in
        a fixed order)."""
        for name in names:
            kern = cases_[name][0]
            a_, b_ = kern(), kern()
            check(all(torch.equal(u, w_) for u, w_ in zip(a_, b_)),
                  f"{name}: two calls differ")
            print(f"kernel {name}: two calls give the same bits", flush=True)

    check_kernels(cases)
    same_bits(cases, ("layernorm_bwd", "layernorm_bwd[D=192]"))
    # the reference for the LN+MLP forwards (timed only, the port never
    # calls it): the same function as a chain of PyTorch calls in bf16,
    # F.layer_norm, F.linear, the GELU, F.linear and the residual (cuBLAS)
    def mlp_chain(x_, w1_, b1_, w2_, b2_, mode, ln_=None):
        xn = F.layer_norm(x_, (x_.shape[-1],), ln_[0].bfloat16(), ln_[1].bfloat16(),
                          1e-6) if ln_ else x_
        h = F.linear(xn, w1_, b1_.bfloat16())
        h = F.gelu(h) if mode == "erf" else h * torch.sigmoid(1.702 * h)
        return F.linear(h, w2_, b2_.bfloat16())

    def mlp_next_ln(y_, ln_):
        return F.layer_norm(y_, (y_.shape[-1],), ln_[0].bfloat16(), ln_[1].bfloat16(), 1e-6)

    gate16, w_t = gate.bfloat16()[..., None], (w1_t, b1_t, w2_t, b2_t)
    mlp_refs = {
        "fused_ln_mlp[erf]": lambda: mlp_next_ln(
            x + mlp_chain(x, w1, b1, w2, b2, "erf", ln[:2]), ln[2:]),
        "fused_ln_mlp": lambda: mlp_next_ln(
            x + mlp_chain(x, w1, b1, w2, b2, "sigmoid", ln[:2]), ln[2:]),
        "fused_ln_mlp_train": lambda: x3 + mlp_chain(x3, w1, b1, w2, b2, "erf", ln[:2]) * gate16,
        "fused_mlp": lambda: x + mlp_chain(x8, w1, b1, w2, b2, "sigmoid"),
        "fused_mlp[D=192]": lambda: x_t + mlp_chain(x8_t, *w_t, "sigmoid"),
        "fused_ln_mlp[D=192]": lambda: mlp_next_ln(
            x_t + mlp_chain(x_t, *w_t, "sigmoid", ln_t[:2]), ln_t[2:]),
        "fused_ln_mlp_train[D=192]": lambda: train_t[0] + mlp_chain(
            train_t[0], *w_t, "erf", ln_t[:2]) * gate16}
    # and for the LN + dense pair: F.layer_norm, F.linear [+ the GELU], and
    # the backward by autograd through them
    def ln_dense_chain(x_, ln_, w_, b_, mode=None):
        y_ = F.linear(F.layer_norm(x_, (x_.shape[-1],), ln_[0].bfloat16(), ln_[1].bfloat16(),
                                   1e-6), w_, b_.bfloat16())
        return (F.gelu(y_) if mode == "erf" else y_ * torch.sigmoid(1.702 * y_)) if mode else y_

    def ln_dense_chain_bwd(x_, ln_, w_, b_, dy_, mode=None):
        leaves = [t.detach().clone().requires_grad_(True) for t in
                  (x_, ln_[0].bfloat16(), ln_[1].bfloat16(), w_, b_.bfloat16())]
        y_ = F.linear(F.layer_norm(leaves[0], (x_.shape[-1],), leaves[1], leaves[2], 1e-6),
                      leaves[3], leaves[4])
        y_ = F.gelu(y_) if mode == "erf" else y_
        return lambda: torch.autograd.grad(y_, leaves, dy_, retain_graph=True)

    mlp_refs.update({
        "fused_ln_dense": torch.no_grad()(lambda: ln_dense_chain(x, ln, w_qkv, b_qkv)),
        "fused_ln_dense[adapter]": torch.no_grad()(
            lambda: ln_dense_chain(x_ad, ln, w_ad, b_ad, "sigmoid")),
        "fused_ln_dense[adapter,erf]": torch.no_grad()(
            lambda: ln_dense_chain(x_ad, ln, w_ad, b_ad, "erf")),
        "fused_ln_dense[D=192]": torch.no_grad()(
            lambda: ln_dense_chain(x_t, ln_t, w_qkv_t, b_qkv_t)),
        "fused_ln_dense[adapter,D=192]": torch.no_grad()(
            lambda: ln_dense_chain(x_ad_t, ln_t, w_ad_t, b_ad_t, "sigmoid")),
        "fused_ln_dense[adapter,erf,D=192]": torch.no_grad()(
            lambda: ln_dense_chain(x_ad_t, ln_t, w_ad_t, b_ad_t, "erf")),
        "fused_ln_dense_bwd": ln_dense_chain_bwd(x, ln, w_qkv, b_qkv, dy_qkv),
        "fused_ln_dense_bwd[adapter]": ln_dense_chain_bwd(x_ad, ln, w_ad, b_ad, dy_ad, "erf"),
        "fused_ln_dense_bwd[D=192]": ln_dense_chain_bwd(x_t, ln_t, w_qkv_t, b_qkv_t, dy_qkv_t),
        "fused_ln_dense_bwd[adapter,D=192]": ln_dense_chain_bwd(x_ad_t, ln_t, w_ad_t, b_ad_t,
                                                                dy_ad_t, "erf")})
    # the patch embeds' reference: PatchEmbed.dense, a permute copy and one matmul
    mlp_refs.update({"patch_embed": lambda: pe_dense_chain(w_pe, b_pe),
                     "patch_embed[D=192]": lambda: pe_dense_chain(w_pe_t, b_pe_t)})
    for name, ref in mlp_refs.items():
        ref_ms = cuda_ms(torch.no_grad()(ref) if "bwd" not in name else ref, 10)
        print(f"kernel {name}: kernel {record[name]['ms']:.3f} ms; reference (the same "
              f"function as a chain of PyTorch calls, bf16) {ref_ms:.3f} ms  [{card}]",
              flush=True)
    # row 15's library call both ways: the line's library_ms takes input and
    # weight in channels_last strides; here over contiguous NCHW copies
    x_nchw = x_pe.permute(0, 3, 1, 2).contiguous()
    for name, w_, b_ in (("patch_embed", w_pe, b_pe), ("patch_embed[D=192]", w_pe_t, b_pe_t)):
        w_nchw = w_.permute(3, 2, 0, 1).contiguous()
        nchw_ms = cuda_ms(torch.no_grad()(lambda: F.conv2d(
            x_nchw, w_nchw, b_.bfloat16(), stride=v.patch_size)), 3)
        print(f"kernel {name}: library F.conv2d over contiguous NCHW input and weight "
              f"{nchw_ms:.3f} ms; in channels_last strides (library_ms) "
              f"{record[name]['library_ms']:.3f} ms  [{card}]", flush=True)
    del x_nchw, w_nchw
    # row 1's first kernel: its token-ordered hit list against the plain
    # version's, entry for entry; and two calls of row 1 give the same bits
    hk = voxel_hits(chunks, g.lidar_total_channels, v.patch_size, hw)
    hp = voxel_hits_plain(chunks, g.lidar_total_channels, v.patch_size, hw)
    in_list = torch.arange(hp.wrow.shape[-1], device=dev) < hp.offsets[..., -1:].long()
    check(torch.equal(hk.offsets, hp.offsets) and torch.equal(hk.wrow[in_list], hp.wrow[in_list])
          and torch.equal(hk.val[in_list], hp.val[in_list]),
          "voxel_hits: the kernel's hit list differs from the plain version's")
    for w_, b_ in ((w_pe, b_pe), (w_pe_t, b_pe_t)):
        check(torch.equal(voxel_embed_tokens(chunks, w_, b_, v.patch_size, hw),
                          voxel_embed_tokens(chunks, w_, b_, v.patch_size, hw)),
              "voxel_embed: two calls differ")
    print(f"kernel voxel_embed: the hit list of its first kernel equals the plain version's "
          f"({int(hp.offsets[..., -1].sum())} hits); two calls give the same bits at D={d} and "
          f"{dt_}", flush=True)
    del hk, hp, in_list
    del mlp_refs, ref, gate16, w_t, w_qkv_t, b_qkv_t, dy_qkv_t, x_ad_t, w_ad_t, b_ad_t, dy_ad_t
    del chunks, x, qkv, q, k, vv, o, lse, do, dy, x3, dy3, xhat, inv, gate, train_mlp
    del qh, kh, vh, doh, o_sdpa, xl, gl, bl, y_ln, mlp_args, x8, int8_args, x_ad
    del x_pe, w_conv, w_conv_t, gate_r, dy_qkv, dy_ad
    del qkv_t, qkv_v, o_t, lse_t, o_tv, do_tv, qh_t, kh_t, vh_t, doh_t, o_sdpa_t, x_t, dy_t
    del mlp_t, train_t, xhat_t, inv_t, xl_t, y_ln_t, q32, k32, v32, do32, o32, lse32, cases
    del x8_t, w1q_t, w2q_t, int8_args_t
    torch.cuda.empty_cache()

    # 4. the slice
    params = init_params(cfg, seed=0)
    inf = StreamingInferencer(cfg, params, "cuda", transport="chunks", gelu="sigmoid")
    requests = [serving_batch(g, batch, 16384, seed=s) for s in (1, 2, 3)]
    inf(*requests[0])  # warm-up: cuBLAS/cuDNN handles, allocator
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    dets = [inf(*r) for r in requests]
    elapsed = time.perf_counter() - t0
    serve_counts = dict(_build.launches)
    per_request = {"voxel_embed": 1, "flash_packed": 2 * v.depth,
                   "fused_ln_mlp": 2 * v.depth, "layernorm": 4}
    want_counts = {k_: per_request.get(k_, 0) * len(requests) for k_ in serve_counts}
    check(serve_counts == want_counts, f"launch counts {serve_counts} != {want_counts}")
    print(f"slice: launches over {len(requests)} requests {serve_counts} "
          f"(per request {per_request})", flush=True)

    t0 = time.perf_counter()
    host_chunks = inf.build_chunks(*requests[0][:2])
    host_ms = (time.perf_counter() - t0) * 1e3

    n_anchor = (g.height_px // cfg.anchors.stride) * (g.width_px // cfg.anchors.stride) \
        * cfg.anchors.num_anchors_per_loc
    got = inf.logits(host_chunks, requests[0][2])
    plain = StreamingInferencer(cfg, params, "cuda", transport="chunks", gelu="sigmoid",
                                plain_ops=True)
    want = plain.logits(host_chunks, requests[0][2])
    control = StreamingInferencer(cfg, params, "cuda", transport="chunks", gelu="erf",
                                  plain_ops=True)
    ctrl = control.logits(host_chunks, requests[0][2])
    del control
    widths = (1, cfg.heads.num_box_params, cfg.heads.num_intention_classes)
    for name, a, wdt in zip(("cls", "box", "intent"), got, widths):
        check(tuple(a.shape) == (batch, n_anchor, wdt), f"{name} logits shape {tuple(a.shape)}")
    # 24 blocks compound the kernels' rounding noise (flash's P rounding most);
    # the control is the plain path with the other block GELU (erf), a fault
    # the limit must see. On an H100 the sound readings were 8.5e-3-9.7e-3 and
    # the control's 1.9e-2-2.2e-2; the limit sits near their geometric mean.
    slice_limit = (1.3e-2,) * 3
    sound, ctrl_r = compare("slice logits", got, want, ctrl, (rel_l2,) * 3, slice_limit,
                            "erf GELU in the blocks")
    print("slice: logits kernel vs plain path, relative L2 (cls, box, intent) "
          f"[{', '.join(f'{r:.3e}' for r in sound)}] under {slice_limit[0]:g}; control "
          f"(plain path, erf GELU) [{', '.join(f'{r:.3e}' for r in ctrl_r)}] caught",
          flush=True)

    ev = cfg.eval
    det_plain = plain.infer_chunks(host_chunks, requests[0][2])
    for det in dets + [det_plain]:
        check(det.boxes_xywha.shape == (batch, ev.max_detections, 5), "boxes shape")
        check(det.scores.shape == det.valid.shape == (batch, ev.max_detections), "scores shape")
        check(np.isfinite(det.boxes_xywha).all() and np.isfinite(det.scores).all(),
              "non-finite detections")
    print(f"slice: valid per frame {dets[0].valid.sum(1).tolist()} vs plain "
          f"{det_plain.valid.sum(1).tolist()}; num_conf {dets[0].num_conf.tolist()} vs plain "
          f"{det_plain.num_conf.tolist()}", flush=True)
    fps = len(requests) * batch / elapsed
    print(f"slice: {fps:.2f} frames/s over {len(requests)} requests of {batch} "
          f"(host chunk build {host_ms:.1f} ms/request included) [{card}]", flush=True)

    del inf, plain, dets, det_plain, got, want, ctrl
    torch.cuda.empty_cache()

    # 5. training
    model = IntentNetViT(cfg.vit, cfg.heads, dtype=torch.bfloat16, param_dtype=torch.float32)
    model.load_state_dict(params)
    model.to(dev)
    anchors = torch.from_numpy(generate_anchors(g, cfg.anchors)).to(dev)
    tbatch = {k_: torch.from_numpy(a).to(dev) for k_, a in train_batch(
        g, batch, 16384, cfg.loss.max_gt_boxes, seed=0).items()}
    draws = StepDraws(draw_dropout(cfg.augment, g.height_px, g.width_px, batch, gen, dev),
                      torch.rand(batch * n_anchor, generator=gen, device=dev))

    def loss_and_grads(plain_ops, net=model, step_cfg=cfg, batch_=None, draws_=None):
        """One step at lr 0 with the same draws and drop-path gates (on
        ``batch_`` with ``draws_``, by default phase 5's): the metrics and
        every parameter's gradient (f32)."""
        net.plain_ops = plain_ops
        step0 = make_train_step(net, step_cfg, anchors, torch.optim.SGD(net.parameters(), lr=0.0))
        m = step0(tbatch if batch_ is None else batch_,
                  torch.Generator(device="cuda").manual_seed(1),
                  draws if draws_ is None else draws_)
        return ({k_: float(t) for k_, t in m.items()},
                {k_: p_.grad.detach().float().clone() for k_, p_ in net.named_parameters()})

    def grad_readings(ga, gb):
        """(relative L2 over all parameters, worst tensor's relative L2, its name)."""
        num = sum(float((ga[k_] - gb[k_]).double().norm() ** 2) for k_ in ga)
        den = sum(float(gb[k_].double().norm() ** 2) for k_ in ga)
        worst = max((rel_l2(ga[k_], gb[k_]), k_) for k_ in ga if float(gb[k_].norm()) > 0)
        return (num / den) ** 0.5, worst[0], worst[1]

    m_k, g_k = loss_and_grads(False)
    check(all(np.isfinite(val) for val in m_k.values()), f"non-finite metrics {m_k}")
    check(all(bool(torch.isfinite(t).all()) for t in g_k.values()), "non-finite gradient")
    m_p, g_p = loss_and_grads(True)
    # f32 reference, read and not checked: the same step through the plain
    # versions in f32 (no TF32), against which both bf16 steps are read
    ref = IntentNetViT(cfg.vit, cfg.heads, dtype=torch.float32)
    ref.load_state_dict(params)
    ref.to(dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg32 = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, compute_dtype="float32"))
        g_ref = loss_and_grads(True, ref, cfg32)[1]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del ref

    def faulty_plain(module, name, fault, net=model, step_cfg=cfg):
        """The plain step with one plausible fault in a plain backward:
        its gradients."""
        mod = importlib.import_module(f"intentbev_torch.ops.{module}")
        sound_fn = getattr(mod, name)
        setattr(mod, name, fault(sound_fn))
        try:
            return loss_and_grads(True, net, step_cfg)[1]
        finally:
            setattr(mod, name, sound_fn)

    g_c = faulty_plain("fused_ln_mlp", "fused_ln_mlp_bwd_plain",
                       lambda f: lambda x_, ga, be, w1_, b1_, w2_, gate_, dy_, eps:
                       f(x_, ga, be, w1_, b1_, w2_, None, dy_, eps))
    g_ln = faulty_plain("layernorm", "layernorm_bwd_plain", lambda f: layernorm_bwd_no_m2)
    model.plain_ops = False
    sound_g, ctrl_g, ln_g = (grad_readings(a, g_p) for a in (g_k, g_c, g_ln))
    k_ref, p_ref = grad_readings(g_k, g_ref), grad_readings(g_p, g_ref)
    loss_rel = abs(m_k["loss"] - m_p["loss"]) / abs(m_p["loss"])
    # Limits between the sound reading (kernel step vs plain step: bf16
    # rounding noise through 24 blocks forward and backward, which weight
    # gradients summed over 36008 tokens amplify; worst at the lidar patch
    # embed, 0.16) and the control's (plain step whose LN+MLP backward
    # ignores the drop-path gate). PERF.md has both readings.
    grad_limit, worst_limit, loss_limit = 6e-3, 4e-1, 1e-2
    said = (f"sound {sound_g[:2]} (worst {sound_g[2]}), control {ctrl_g[:2]} "
            f"(worst {ctrl_g[2]}), limits {grad_limit}, {worst_limit}")
    check(sound_g[0] < grad_limit and sound_g[1] < worst_limit and loss_rel < loss_limit,
          f"train step: kernel vs plain reaches a limit: {said}; loss {m_k} vs {m_p}")
    check(ctrl_g[0] >= grad_limit or ctrl_g[1] >= worst_limit,
          f"train step: the control stays under the limits: {said}")
    print(f"train: step kernel vs plain, loss {m_k['loss']:.6f} vs {m_p['loss']:.6f} "
          f"(rel {loss_rel:.3e} < {loss_limit:g}); gradients relative L2 all {sound_g[0]:.3e} "
          f"< {grad_limit:g}, worst {sound_g[1]:.3e} ({sound_g[2]}) < {worst_limit:g}; control "
          f"(plain, LN+MLP backward ignores the gate) all {ctrl_g[0]:.3e}, worst "
          f"{ctrl_g[1]:.3e} ({ctrl_g[2]}) caught; read, not checked (plain, LN backward "
          f"without mean(dyg*xhat)): all {ln_g[0]:.3e}, worst {ln_g[1]:.3e} ({ln_g[2]}); "
          f"metrics {m_k}", flush=True)
    print(f"train: against the f32 plain step, the kernel step reads all {k_ref[0]:.3e}, "
          f"worst {k_ref[1]:.3e} ({k_ref[2]}); the bf16 plain step all {p_ref[0]:.3e}, "
          f"worst {p_ref[1]:.3e} ({p_ref[2]})", flush=True)
    p5_metrics, p5_grads = m_k, {k_: t.cpu() for k_, t in g_k.items()}  # phases 15, 16
    p5_ref = {k_: t.cpu() for k_, t in g_ref.items()}  # phase 16 reads it
    del g_k, g_p, g_c, g_ln, g_ref

    opt = make_optimizer(model.parameters(), cfg)
    step = make_train_step(model, cfg, anchors, opt)
    tgen = torch.Generator(device="cuda").manual_seed(2)
    step(tbatch, tgen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    step_ms, metrics = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        metrics.append(step(tbatch, tgen))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train_counts = dict(_build.launches)
    per_step = {"flash_packed": 2 * v.depth, "flash_packed_bwd": 2 * v.depth,
                "fused_ln_mlp_train": 2 * v.depth, "fused_ln_mlp_bwd": 2 * v.depth,
                "layernorm_train": 2 * (v.depth + 2), "layernorm_bwd": 2 * (v.depth + 2)}
    want_counts = {k_: per_step.get(k_, 0) * len(step_ms) for k_ in train_counts}
    check(train_counts == want_counts, f"train launch counts {train_counts} != {want_counts}")
    for m in metrics:
        check(all(bool(torch.isfinite(t)) for t in m.values()), f"non-finite metrics {m}")
    check(all(bool(torch.isfinite(p_.grad).all()) for p_ in model.parameters()),
          "non-finite gradient")
    ms_step = sum(step_ms) / len(step_ms)
    vit_step_ms, vit_per_step = ms_step, per_step  # phase 14 reads the step alone
    print(f"train: launches over {len(step_ms)} steps {train_counts} (per step {per_step})",
          flush=True)
    print(f"train: losses {[round(float(m['loss']), 6) for m in metrics]}; step ms "
          f"{[round(t, 2) for t in step_ms]}; {ms_step:.2f} ms/step, "
          f"{batch / ms_step * 1e3:.2f} samples/s at batch {batch}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)

    del metrics  # tbatch: phase 9 trains on the same batch
    torch.cuda.empty_cache()

    # 6. CNN serving over the chunk transport
    ccfg = default_cnn_config()
    cg = ccfg.grid
    cparams = calibrated_params(ccfg, 0, dev)  # finite box decode at random weights
    cinf = StreamingInferencer(ccfg, cparams, "cuda", transport="chunks")
    creqs = [serving_batch(cg, batch, 16384, seed=s_) for s_ in (1, 2, 3)]
    cinf(*creqs[0])  # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    cdets = [cinf(*r) for r in creqs]
    elapsed = time.perf_counter() - t0
    cnn_serve_counts = dict(_build.launches)
    want_counts = {k_: len(creqs) if k_ == "voxel_fill" else 0 for k_ in cnn_serve_counts}
    check(cnn_serve_counts == want_counts,
          f"CNN serving launch counts {cnn_serve_counts} != {want_counts}")
    print(f"cnn serving: launches over {len(creqs)} requests {cnn_serve_counts}", flush=True)

    # The comparisons below run cuDNN's deterministic algorithms: each pair
    # of runs gives the model the same BEV, so a sound reading is then 0
    # and any difference is the kernel's. The timed runs use the default.
    torch.backends.cudnn.deterministic = True
    cpts, cvalid, cmap = creqs[0]
    t0 = time.perf_counter()
    host_chunks = cinf.build_chunks(cpts, cvalid)
    host_ms = (time.perf_counter() - t0) * 1e3
    skipped = host_chunks._replace(count=np.maximum(host_chunks.count - 1, 0))
    cplain = StreamingInferencer(ccfg, cparams, "cuda", transport="chunks", plain_ops=True)
    cpoints = StreamingInferencer(ccfg, cparams, "cuda", transport="points")
    got = cinf.logits(host_chunks, cmap)
    want, ctrl = cplain.logits(host_chunks, cmap), cplain.logits(skipped, cmap)
    # the points transport on the host chunk build's bins: one BEV on both sides
    with with_host_bins(importlib.import_module("intentbev_torch.parallel.inference")):
        via_points = cpoints.logits_points(cpts, cvalid, cmap)
    for name, a, wdt in zip(("cls", "box", "intent"), got, widths):
        check(tuple(a.shape) == (batch, n_anchor, wdt), f"CNN {name} logits shape {tuple(a.shape)}")
    with torch.inference_mode():
        dev_chunks = decode_chunk_transport(chunks_to_device(host_chunks, dev))
        bev = voxel_fill_bev(dev_chunks, (cg.height_px, cg.width_px), cg.lidar_total_channels,
                             cinf.chunk_patch)
        pts_t, valid_t = torch.from_numpy(cpts).to(dev), torch.from_numpy(cvalid).to(dev)
        bev_host = voxelize_packed(pts_t, valid_t, cg, out_dtype=torch.bfloat16,
                                   arithmetic="host")
        bev_pts = voxelize_packed(pts_t, valid_t, cg, out_dtype=torch.bfloat16)
        fill_cells = int((bev != bev_host).sum())
        bev_cells = int((bev != bev_pts).sum())
        n_moved = moved_points(pts_t, valid_t, cg)
    del dev_chunks, bev, bev_pts, bev_host, pts_t, valid_t
    # the fill against the host bins: cell for cell; against the device
    # voxelizer: only where a boundary point moved (at most 2 cells each)
    check(fill_cells == 0, f"CNN: the fill's BEV and the host bins differ in "
                           f"{fill_cells} cells")
    check(bev_cells <= 2 * n_moved, f"CNN: the fill's BEV and the voxelizer's differ in "
                                    f"{bev_cells} cells, {n_moved} boundary points moved")
    # Both paths give the model the same BEV and run the same deterministic
    # convolutions; the control (a plain fill that skips the last chunk of
    # each band) changes the input.
    cnn_limit = (1e-6,) * 3
    sound, ctrl_r = compare("CNN logits, kernel vs plain fill", got, want, ctrl, (rel_l2,) * 3,
                            cnn_limit, "last chunk of each band skipped")
    sound_p, ctrl_p = compare("CNN logits, points vs chunks", via_points, got, ctrl,
                              (rel_l2,) * 3, cnn_limit, "last chunk of each band skipped")
    fmt3 = ", ".join
    print(f"cnn serving: BEV of the fill vs the host bins: 0 differing cells, vs the "
          f"device voxelizer: {bev_cells} ({n_moved} points on a cell boundary moved); logits "
          "relative L2 "
          f"(cls, box, intent), kernel vs plain fill [{fmt3(f'{r:.3e}' for r in sound)}], "
          f"points transport (host bins) vs chunks [{fmt3(f'{r:.3e}' for r in sound_p)}] under "
          f"{cnn_limit[0]:g}; control (plain fill, last chunk of each band skipped) "
          f"[{fmt3(f'{r:.3e}' for r in ctrl_r)}] / [{fmt3(f'{r:.3e}' for r in ctrl_p)}] caught",
          flush=True)
    cdet_plain = cplain.infer_chunks(host_chunks, cmap)
    for det in cdets + [cdet_plain]:
        check(det.boxes_xywha.shape == (batch, ev.max_detections, 5), "CNN boxes shape")
        check(det.scores.shape == det.valid.shape == (batch, ev.max_detections),
              "CNN scores shape")
        check(np.isfinite(det.boxes_xywha).all() and np.isfinite(det.scores).all(),
              "non-finite CNN detections")
    fps = len(creqs) * batch / elapsed
    print(f"cnn serving: valid per frame {cdets[0].valid.sum(1).tolist()}, num_conf "
          f"{cdets[0].num_conf.tolist()}; {fps:.2f} frames/s over {len(creqs)} requests of "
          f"{batch} (host chunk build {host_ms:.1f} ms/request included) [{card}]", flush=True)
    del cinf, cplain, cpoints, cdets, cdet_plain, got, want, ctrl, via_points
    torch.cuda.empty_cache()

    # 7. CNN training over the chunk train transport
    cmodel = IntentNetCNN(ccfg.cnn, ccfg.heads, dtype=torch.bfloat16, param_dtype=torch.float32)
    cmodel.load_state_dict(cparams)
    cmodel.to(dev)
    cb = chunk_train_batch(ccfg, batch, 16384, seed=0)
    cbatch = chunk_batch_to_device(cb, dev)
    cskip = {**cbatch, "chunks": cbatch["chunks"]._replace(
        count=(cbatch["chunks"].count - 1).clamp(min=0))}
    tb = train_batch(cg, batch, 16384, ccfg.loss.max_gt_boxes, seed=0)  # the same draw
    pbatch = {k_: torch.from_numpy(a).to(dev) for k_, a in tb.items()}
    pbatch["points"] = torch.from_numpy(quantize_points_cm(tb["points"])).to(dev)
    cdraws = StepDraws(draw_dropout(ccfg.augment, cg.height_px, cg.width_px, batch, gen, dev),
                       torch.rand(batch * n_anchor, generator=gen, device=dev))

    def cnn_step(plain_ops, b_):
        """One CNN step at lr 0 with the same draws: metrics, gradients."""
        cmodel.plain_ops = plain_ops
        step0 = make_train_step(cmodel, ccfg, anchors,
                                torch.optim.SGD(cmodel.parameters(), lr=0.0))
        m = step0(b_, None, cdraws)
        return ({k_: float(t) for k_, t in m.items()},
                {k_: p_.grad.detach().float().clone() for k_, p_ in cmodel.named_parameters()})

    cm_k, cg_k = cnn_step(False, cbatch)
    check(all(np.isfinite(val) for val in cm_k.values()), f"non-finite CNN metrics {cm_k}")
    check(all(bool(torch.isfinite(t).all()) for t in cg_k.values()), "non-finite CNN gradient")
    cm_p, cg_p = cnn_step(True, cbatch)
    cm_c, cg_c = cnn_step(True, cskip)
    with with_host_bins(importlib.import_module("intentbev_torch.train")):
        cm_pts, cg_pts = cnn_step(False, pbatch)  # one BEV on both transports
    cmodel.plain_ops = False
    r_plain, r_ctrl, r_pts, r_pts_ctrl = (grad_readings(a, b) for a, b in (
        (cg_k, cg_p), (cg_c, cg_p), (cg_pts, cg_k), (cg_c, cg_k)))
    torch.backends.cudnn.deterministic = False
    # Same BEV and deterministic convolutions on both sides of each reading;
    # the control changes the input.
    cnn_grad_limit, cnn_worst_limit, cnn_loss_limit = 1e-6, 1e-5, 1e-6
    for name, sound_r, ctrl_r, m_a, m_b in (
            ("kernel vs plain fill", r_plain, r_ctrl, cm_k, cm_p),
            ("points (host bins) vs chunk transport", r_pts, r_pts_ctrl, cm_pts, cm_k)):
        loss_rel = abs(m_a["loss"] - m_b["loss"]) / abs(m_b["loss"])
        said = (f"sound {sound_r[:2]} (worst {sound_r[2]}), control {ctrl_r[:2]} (worst "
                f"{ctrl_r[2]}), limits {cnn_grad_limit}, {cnn_worst_limit}; loss rel {loss_rel}")
        check(sound_r[0] < cnn_grad_limit and sound_r[1] < cnn_worst_limit
              and loss_rel < cnn_loss_limit, f"CNN train step, {name}, reaches a limit: {said}")
        check(ctrl_r[0] >= cnn_grad_limit or ctrl_r[1] >= cnn_worst_limit,
              f"CNN train step, {name}: the control stays under the limits: {said}")
        print(f"cnn train: step {name}, loss {m_a['loss']:.6f} vs {m_b['loss']:.6f} (rel "
              f"{loss_rel:.3e} < {cnn_loss_limit:g}); gradients relative L2 all "
              f"{sound_r[0]:.3e} < {cnn_grad_limit:g}, worst {sound_r[1]:.3e} ({sound_r[2]}) < "
              f"{cnn_worst_limit:g}; control (plain fill, last chunk of each band skipped) all "
              f"{ctrl_r[0]:.3e}, worst {ctrl_r[1]:.3e} ({ctrl_r[2]}) caught", flush=True)
    del cg_k, cg_p, cg_c, cg_pts, cskip, pbatch

    copt = make_optimizer(cmodel.parameters(), ccfg)
    cstep = make_train_step(cmodel, ccfg, anchors, copt)
    cstep(cbatch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    cstep_ms, cmetrics = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        cmetrics.append(cstep(cbatch))
        torch.cuda.synchronize()
        cstep_ms.append((time.perf_counter() - t0) * 1e3)
    cnn_train_counts = dict(_build.launches)
    want_counts = {k_: len(cstep_ms) if k_ == "voxel_fill" else 0 for k_ in cnn_train_counts}
    check(cnn_train_counts == want_counts,
          f"CNN train launch counts {cnn_train_counts} != {want_counts}")
    for m in cmetrics:
        check(all(bool(torch.isfinite(t)) for t in m.values()), f"non-finite CNN metrics {m}")
    check(all(bool(torch.isfinite(p_.grad).all()) for p_ in cmodel.parameters()),
          "non-finite CNN gradient")
    ms_step = sum(cstep_ms) / len(cstep_ms)
    print(f"cnn train: launches over {len(cstep_ms)} steps {cnn_train_counts}; losses "
          f"{[round(float(m['loss']), 6) for m in cmetrics]}; step ms "
          f"{[round(t, 2) for t in cstep_ms]}; {ms_step:.2f} ms/step, "
          f"{batch / ms_step * 1e3:.2f} samples/s at batch {batch}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    del cmodel, copt, cstep, cbatch, cmetrics
    torch.cuda.empty_cache()

    # the ViT of phase 5, one step over the chunk train transport
    vbatch = chunk_batch_to_device(chunk_train_batch(cfg, batch, 16384, seed=0), dev)
    _build.reset_launch_counts()
    vm = step(vbatch, tgen)
    torch.cuda.synchronize()
    vit_chunk_counts = dict(_build.launches)
    want_counts = {k_: per_step.get(k_, 0) for k_ in vit_chunk_counts}
    want_counts["voxel_fill"] = 1
    check(vit_chunk_counts == want_counts,
          f"ViT chunk-transport step launch counts {vit_chunk_counts} != {want_counts}")
    check(all(bool(torch.isfinite(t)) for t in vm.values()), f"non-finite ViT metrics {vm}")
    check(all(bool(torch.isfinite(p_.grad).all()) for p_ in model.parameters()),
          "non-finite ViT gradient")
    print(f"vit train, chunk transport: launches {vit_chunk_counts}; loss "
          f"{float(vm['loss']):.6f}", flush=True)


    # 8. ViT serving configurations
    per_request_by_config = {  # label: (variant, launches per request)
        "A serving_int8": ("int8", {"flash_packed": 24, "fused_mlp_int8": 24,
                                    "layernorm": 52}),
        "B fuse_ln_dense": ("ln_dense", {"voxel_embed": 1, "fused_ln_dense": 26,
                                         "flash_packed": 24, "fused_ln_mlp_train": 24,
                                         "layernorm": 2}),
        "C use_fused_layernorm=False": ("unfused_ln", {"voxel_embed": 1, "flash_packed": 24,
                                                       "fused_mlp": 24}),
        "D fuse_patch_embed": ("patch_embed", {"patch_embed": 1, "flash_packed": 24,
                                               "fused_ln_mlp": 24, "layernorm": 4}),
    }
    def serve_config(cname, vcfg, transport, per_req, failures, net_params=params,
                     reqs=requests, control=None):
        """Serve ``reqs`` under ``vcfg`` with ``net_params``: launch counts per
        request as ``per_req``, logits against the plain path (control: the
        plain path with the erf GELU, or with ``control`` = (parameters with
        a fault, the fault's name), those parameters), fixed-shape finite
        Detections, frames/s; the counts of the timed requests are
        returned."""
        vinf = StreamingInferencer(vcfg, net_params, "cuda", transport=transport, gelu="sigmoid")
        vinf(*requests[0])  # warm-up
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        vdets = [vinf(*r) for r in reqs]
        elapsed = time.perf_counter() - t0
        counts = dict(_build.launches)
        want_counts = {k_: per_req.get(k_, 0) * len(reqs) for k_ in counts}
        check(counts == want_counts, f"{cname}: launch counts {counts} != {want_counts}")

        def config_logits(inf_):
            pts_, valid_, map_ = requests[0]
            if transport == "points":
                return inf_.logits_points(pts_, valid_, map_)
            return inf_.logits(inf_.build_chunks(pts_, valid_), map_)

        got = config_logits(vinf)
        want = config_logits(StreamingInferencer(vcfg, net_params, "cuda", transport=transport,
                                                 gelu="sigmoid", plain_ops=True))
        ctrl_params, fault = control or (net_params, "plain, erf GELU in the blocks")
        ctrl = config_logits(StreamingInferencer(vcfg, ctrl_params, "cuda", transport=transport,
                                                 gelu="sigmoid" if control else "erf",
                                                 plain_ops=True))
        for name, a, wdt in zip(("cls", "box", "intent"), got, widths):
            check(tuple(a.shape) == (batch, n_anchor, wdt),
                  f"{cname}: {name} logits shape {tuple(a.shape)}")
        sound, ctrl_r = compare(f"{cname} logits", got, want, ctrl, (rel_l2,) * 3,
                                CONFIG_LIMITS[cname], fault, failures)
        for det in vdets:
            check(det.boxes_xywha.shape == (batch, ev.max_detections, 5), f"{cname}: boxes shape")
            check(det.scores.shape == det.valid.shape == (batch, ev.max_detections),
                  f"{cname}: scores shape")
            check(np.isfinite(det.boxes_xywha).all() and np.isfinite(det.scores).all(),
                  f"{cname}: non-finite detections")
        fmt3 = ", ".join
        print(f"config {cname} ({transport}): launches per request {per_req}; logits kernel vs "
              f"plain, relative L2 (cls, box, intent) [{fmt3(f'{r:.3e}' for r in sound)}] under "
              f"{CONFIG_LIMITS[cname][0]:g}; control ({fault}) "
              f"[{fmt3(f'{r:.3e}' for r in ctrl_r)}]; valid per frame "
              f"{vdets[0].valid.sum(1).tolist()}; {len(reqs) * batch / elapsed:.2f} frames/s "
              f"over {len(reqs)} requests of {batch} [{card}]", flush=True)
        del vinf, vdets, got, want, ctrl
        torch.cuda.empty_cache()
        return counts

    config_counts, config_failures = {}, []
    for cname, (variant, per_req) in per_request_by_config.items():
        vcfg, transport = vit_serving_variant(cfg, variant)
        config_counts[cname] = serve_config(cname, vcfg, transport, per_req, config_failures)
    check(not config_failures, "; ".join(config_failures))

    # 9. ViT training under B fuse_ln_dense and C use_fused_layernorm=False
    def adapter_no_gelu_grad(f):
        # B's control: the adapters' (erf GELU) LN + dense backward without GELU'
        def call(*args):
            if args[-1] is None:  # qkv: no GELU
                return f(*args)
            return gelu_grad_skipped("fused_ln_dense", lambda: f(*args))
        return call

    train_by_config = {  # label: (variant, launches per step, control, its fault)
        "B fuse_ln_dense": (
            "ln_dense", {"fused_ln_dense": 26, "fused_ln_dense_bwd": 26, "flash_packed": 24,
                         "flash_packed_bwd": 24, "fused_ln_mlp_train": 24,
                         "fused_ln_mlp_bwd": 24, "layernorm_train": 2, "layernorm_bwd": 2},
            ("fused_ln_dense", "fused_ln_dense_bwd_plain", adapter_no_gelu_grad),
            "adapters' LN + dense backward without GELU'"),
        "C use_fused_layernorm=False": (
            "unfused_ln", {"flash_packed": 24, "flash_packed_bwd": 24, "fused_mlp_train": 24,
                           "fused_mlp_bwd": 24},
            ("fused_mlp", "fused_mlp_bwd_plain",
             lambda f: lambda h_, w1_, b1_, w2_, gate_, dy_: f(h_, w1_, b1_, w2_, None, dy_)),
            "MLP backward ignores the gate"),
    }
    def train_config(cname, tcfg_, net_params, per_step_c, control, fault, steps=3):
        """Train the ViT under ``tcfg_`` from ``net_params``: one step's loss
        and gradients against the plain step, and the plain step with
        ``control`` (module, plain backward, fault) caught; then a warm-up
        and ``steps`` timed steps whose launch counts are ``per_step_c``
        each. Returns the timed steps' counts."""
        c_mod, c_name, c_fault = control
        net = IntentNetViT(tcfg_.vit, tcfg_.heads, dtype=torch.bfloat16,
                           param_dtype=torch.float32)
        net.load_state_dict(net_params)
        net.to(dev)
        m_k, g_k = loss_and_grads(False, net, tcfg_)
        check(all(np.isfinite(val) for val in m_k.values()), f"{cname}: non-finite metrics {m_k}")
        check(all(bool(torch.isfinite(t).all()) for t in g_k.values()),
              f"{cname}: non-finite gradient")
        m_p, g_p = loss_and_grads(True, net, tcfg_)
        g_c = faulty_plain(c_mod, c_name, c_fault, net, tcfg_)
        net.plain_ops = False
        sound_g, ctrl_g = grad_readings(g_k, g_p), grad_readings(g_c, g_p)
        loss_rel = abs(m_k["loss"] - m_p["loss"]) / abs(m_p["loss"])
        said = (f"sound {sound_g[:2]} (worst {sound_g[2]}), control {ctrl_g[:2]} "
                f"(worst {ctrl_g[2]}), limits {grad_limit}, {worst_limit}")
        check(sound_g[0] < grad_limit and sound_g[1] < worst_limit and loss_rel < loss_limit,
              f"{cname} train step: kernel vs plain reaches a limit: {said}; loss {m_k} vs {m_p}")
        check(ctrl_g[0] >= grad_limit or ctrl_g[1] >= worst_limit,
              f"{cname} train step: the control stays under the limits: {said}")
        print(f"config {cname} train: step kernel vs plain, loss {m_k['loss']:.6f} vs "
              f"{m_p['loss']:.6f} (rel {loss_rel:.3e} < {loss_limit:g}); gradients relative L2 "
              f"all {sound_g[0]:.3e} < {grad_limit:g}, worst {sound_g[1]:.3e} ({sound_g[2]}) < "
              f"{worst_limit:g}; control (plain, {fault}) all {ctrl_g[0]:.3e}, worst "
              f"{ctrl_g[1]:.3e} ({ctrl_g[2]}) caught", flush=True)
        kernel_steps[cname] = (m_k, {k_: t.cpu() for k_, t in g_k.items()})  # phase 16
        del g_k, g_p, g_c

        cstep_ = make_train_step(net, tcfg_, anchors, make_optimizer(net.parameters(), tcfg_))
        tgen = torch.Generator(device="cuda").manual_seed(2)
        cstep_(tbatch, tgen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        step_ms, metrics = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            metrics.append(cstep_(tbatch, tgen))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = dict(_build.launches)
        want_counts = {k_: per_step_c.get(k_, 0) * len(step_ms) for k_ in counts}
        check(counts == want_counts, f"{cname} train launch counts {counts} != {want_counts}")
        for m in metrics:
            check(all(bool(torch.isfinite(t)) for t in m.values()),
                  f"{cname}: non-finite metrics {m}")
        check(all(bool(torch.isfinite(p_.grad).all()) for p_ in net.parameters()),
              f"{cname}: non-finite gradient")
        ms_step = sum(step_ms) / len(step_ms)
        print(f"config {cname} train: launches per step {per_step_c}; losses "
              f"{[round(float(m['loss']), 6) for m in metrics]}; step ms "
              f"{[round(t, 2) for t in step_ms]}; {ms_step:.2f} ms/step, "
              f"{batch / ms_step * 1e3:.2f} samples/s at batch {batch}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
        del net, cstep_, metrics
        torch.cuda.empty_cache()
        return counts

    kernel_steps = {}  # label: the kernel step's (metrics, gradients)
    config_train_counts = {
        cname: train_config(cname, vit_serving_variant(cfg, variant)[0], params, per_step_c,
                            control, fault)
        for cname, (variant, per_step_c, control, fault) in train_by_config.items()}
    train_b, train_c = config_train_counts.values()

    # 10. ViT-Ti: the widths vit_config_from_state_dict reads for a timm
    # vit_tiny checkpoint (intentbev/import_torch.py:235), at full depth on
    # the flagship grid
    tcfg = dataclasses.replace(cfg, vit=dataclasses.replace(v, embed_dim=dt_, num_heads=ht_))
    tparams = init_params(tcfg, seed=0)
    tinf = StreamingInferencer(tcfg, tparams, "cuda", transport="chunks", gelu="sigmoid")
    tinf(*requests[0])  # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    tdets = [tinf(*r) for r in requests]
    elapsed = time.perf_counter() - t0
    tiny_serve_counts = dict(_build.launches)
    per_req_t = {"voxel_embed": 1, "layernorm": 4, "fused_ln_mlp": 2 * v.depth,
                 "flash_attention": 2 * v.depth}
    want_counts = {k_: per_req_t.get(k_, 0) * len(requests) for k_ in tiny_serve_counts}
    check(tiny_serve_counts == want_counts,
          f"ViT-Ti serving launch counts {tiny_serve_counts} != {want_counts}")
    host_chunks = tinf.build_chunks(*requests[0][:2])
    got = tinf.logits(host_chunks, requests[0][2])
    want = StreamingInferencer(tcfg, tparams, "cuda", transport="chunks", gelu="sigmoid",
                               plain_ops=True).logits(host_chunks, requests[0][2])
    ctrl = StreamingInferencer(tcfg, tparams, "cuda", transport="chunks", gelu="erf",
                               plain_ops=True).logits(host_chunks, requests[0][2])
    for name, a, wdt in zip(("cls", "box", "intent"), got, widths):
        check(tuple(a.shape) == (batch, n_anchor, wdt),
              f"ViT-Ti {name} logits shape {tuple(a.shape)}")
    sound, ctrl_r = compare("ViT-Ti logits", got, want, ctrl, (rel_l2,) * 3, slice_limit,
                            "erf GELU in the blocks")
    for det in tdets:
        check(det.boxes_xywha.shape == (batch, ev.max_detections, 5), "ViT-Ti boxes shape")
        check(det.scores.shape == det.valid.shape == (batch, ev.max_detections),
              "ViT-Ti scores shape")
        check(np.isfinite(det.boxes_xywha).all() and np.isfinite(det.scores).all(),
              "non-finite ViT-Ti detections")
    fmt3 = ", ".join
    print(f"vit-ti serving: launches per request {per_req_t}; logits kernel vs plain, relative "
          f"L2 (cls, box, intent) [{fmt3(f'{r:.3e}' for r in sound)}] under "
          f"{slice_limit[0]:g}; control (plain, erf GELU in the blocks) "
          f"[{fmt3(f'{r:.3e}' for r in ctrl_r)}] caught; valid per frame "
          f"{tdets[0].valid.sum(1).tolist()}; {len(requests) * batch / elapsed:.2f} frames/s "
          f"over {len(requests)} requests of {batch} [{card}]", flush=True)
    del tinf, tdets, got, want, ctrl, host_chunks
    torch.cuda.empty_cache()

    tnet = IntentNetViT(tcfg.vit, tcfg.heads, dtype=torch.bfloat16, param_dtype=torch.float32)
    tnet.load_state_dict(tparams)
    tnet.to(dev)
    m_k, g_k = loss_and_grads(False, tnet, tcfg)
    check(all(np.isfinite(val) for val in m_k.values()), f"ViT-Ti: non-finite metrics {m_k}")
    check(all(bool(torch.isfinite(t).all()) for t in g_k.values()), "ViT-Ti: non-finite gradient")
    m_p, g_p = loss_and_grads(True, tnet, tcfg)
    g_c = faulty_plain("fused_ln_mlp", "fused_ln_mlp_bwd_plain",
                       lambda f: lambda x_, ga, be, w1_, b1_, w2_, gate_, dy_, eps:
                       f(x_, ga, be, w1_, b1_, w2_, None, dy_, eps), tnet, tcfg)
    tnet.plain_ops = False
    sound_g, ctrl_g = grad_readings(g_k, g_p), grad_readings(g_c, g_p)
    loss_rel = abs(m_k["loss"] - m_p["loss"]) / abs(m_p["loss"])
    said = (f"sound {sound_g[:2]} (worst {sound_g[2]}), control {ctrl_g[:2]} "
            f"(worst {ctrl_g[2]}), limits {grad_limit}, {worst_limit}")
    check(sound_g[0] < grad_limit and sound_g[1] < worst_limit and loss_rel < loss_limit,
          f"ViT-Ti train step: kernel vs plain reaches a limit: {said}; loss {m_k} vs {m_p}")
    check(ctrl_g[0] >= grad_limit or ctrl_g[1] >= worst_limit,
          f"ViT-Ti train step: the control stays under the limits: {said}")
    print(f"vit-ti train: step kernel vs plain, loss {m_k['loss']:.6f} vs {m_p['loss']:.6f} "
          f"(rel {loss_rel:.3e} < {loss_limit:g}); gradients relative L2 all {sound_g[0]:.3e} "
          f"< {grad_limit:g}, worst {sound_g[1]:.3e} ({sound_g[2]}) < {worst_limit:g}; control "
          f"(plain, LN+MLP backward ignores the gate) all {ctrl_g[0]:.3e}, worst "
          f"{ctrl_g[1]:.3e} ({ctrl_g[2]}) caught", flush=True)
    del g_k, g_p, g_c
    tstep = make_train_step(tnet, tcfg, anchors, make_optimizer(tnet.parameters(), tcfg))
    tgen = torch.Generator(device="cuda").manual_seed(2)
    tstep(tbatch, tgen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    step_ms, metrics = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        metrics.append(tstep(tbatch, tgen))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    tiny_train_counts = dict(_build.launches)
    per_step_t = {"flash_attention": 2 * v.depth, "flash_attention_bwd": 2 * v.depth,
                  "fused_ln_mlp_train": 2 * v.depth, "fused_ln_mlp_bwd": 2 * v.depth,
                  "layernorm_train": 2 * (v.depth + 2), "layernorm_bwd": 2 * (v.depth + 2)}
    want_counts = {k_: per_step_t.get(k_, 0) * len(step_ms) for k_ in tiny_train_counts}
    check(tiny_train_counts == want_counts,
          f"ViT-Ti train launch counts {tiny_train_counts} != {want_counts}")
    for m in metrics:
        check(all(bool(torch.isfinite(t)) for t in m.values()), f"ViT-Ti: non-finite metrics {m}")
    check(all(bool(torch.isfinite(p_.grad).all()) for p_ in tnet.parameters()),
          "ViT-Ti: non-finite gradient")
    ms_step = sum(step_ms) / len(step_ms)
    print(f"vit-ti train: launches per step {per_step_t}; losses "
          f"{[round(float(m['loss']), 6) for m in metrics]}; step ms "
          f"{[round(t, 2) for t in step_ms]}; {ms_step:.2f} ms/step, "
          f"{batch / ms_step * 1e3:.2f} samples/s at batch {batch}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    del tnet, tstep, metrics
    torch.cuda.empty_cache()

    # ViT-Ti under B fuse_ln_dense (the LN + dense pair at D=192: qkv 576
    # wide, the adapters 192) serves one request and takes one timed train
    # step, with phase 8's and phase 9's checks and controls
    tcfg_b, _ = vit_serving_variant(tcfg, "ln_dense")
    tiny_b_serve_counts = serve_config(
        "Ti B fuse_ln_dense", tcfg_b, "chunks",
        {"voxel_embed": 1, "fused_ln_dense": 26, "flash_attention": 24,
         "fused_ln_mlp_train": 24, "layernorm": 2}, config_failures, tparams, requests[:1])
    # and under A serving_int8 (the W8A8 MLP at D=192), one request over points
    tcfg_a, transport_a = vit_serving_variant(tcfg, "int8")
    tiny_a_serve_counts = serve_config(
        "Ti A serving_int8", tcfg_a, transport_a,
        {"flash_attention": 24, "fused_mlp_int8": 24, "layernorm": 52}, config_failures,
        tparams, requests[:1])
    # and under D fuse_patch_embed (row 15 at D=192), one request over points
    tcfg_d, transport_d = vit_serving_variant(tcfg, "patch_embed")
    tiny_d_serve_counts = serve_config(
        "Ti D fuse_patch_embed", tcfg_d, transport_d,
        {"patch_embed": 1, "flash_attention": 24, "fused_ln_mlp": 24, "layernorm": 4},
        config_failures, tparams, requests[:1])
    # and under C use_fused_layernorm=False (row 13 at D=192 after the plain
    # FastLayerNorms), one request over chunks
    tcfg_c, transport_c = vit_serving_variant(tcfg, "unfused_ln")
    tiny_c_serve_counts = serve_config(
        "Ti C use_fused_layernorm=False", tcfg_c, transport_c,
        {"voxel_embed": 1, "flash_attention": 24, "fused_mlp": 24}, config_failures, tparams,
        requests[:1])
    check(not config_failures, "; ".join(config_failures))
    tiny_b_train_counts = train_config(
        "Ti B fuse_ln_dense", tcfg_b, tparams,
        {"fused_ln_dense": 26, "fused_ln_dense_bwd": 26, "flash_attention": 24,
         "flash_attention_bwd": 24, "fused_ln_mlp_train": 24, "fused_ln_mlp_bwd": 24,
         "layernorm_train": 2, "layernorm_bwd": 2}, *train_by_config["B fuse_ln_dense"][2:],
        steps=1)
    tiny_c_train_counts = train_config(
        "Ti C use_fused_layernorm=False", tcfg_c, tparams,
        {"flash_attention": 24, "flash_attention_bwd": 24, "fused_mlp_train": 24,
         "fused_mlp_bwd": 24}, *train_by_config["C use_fused_layernorm=False"][2:])

    # 11. the flash backward's forms (row 11): JAX's split and chunked
    # backwards (INTENTBEV_BWD_FUSED=0, INTENTBEV_BWD_KV_CHUNK) as the model's
    # bwd_fused / bwd_kv_chunk, and the packed path at head dim 32 (ViT-S's
    # width in 12 heads of 32, whose heads pair into 128 lanes)
    chunk = FWD_CHUNK
    forms = {"fused": (True, 0), "split": (False, 0), "chunked": (False, chunk)}
    qkv = randn((batch, tokens, 3 * d), 1.0)
    q, k, vv = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    do = randn((batch, tokens, d), 1.0)

    def f32_scaled(fn):
        """fn() with the packed path's fault before this check: q scaled by
        the f32 scale, not the scale rounded to bf16."""
        sound_scales = fpk.scales
        fpk.scales = lambda dh_, dtype_: (dh_ ** -0.5, dh_ ** -0.5)
        try:
            return fn()
        finally:
            fpk.scales = sound_scales

    def bwd_call(fn, form, h, o_, lse_, o_in=None):
        return lambda: dqkv_parts(fn(q, k, vv, o_ if o_in is None else o_in, lse_, do, h,
                                     None, *forms[form]))

    def sdpa_calls(h):
        """SDPA forward and backward over the same q, k, v in [B, H, T, D]."""
        def heads_of(t):
            return t.reshape(batch, tokens, h, d // h).transpose(1, 2).contiguous()
        qs, ks, vs = (heads_of(t).requires_grad_(True) for t in (q, k, vv))
        dos = heads_of(do)
        out = F.scaled_dot_product_attention(qs, ks, vs)
        return (torch.no_grad()(lambda: F.scaled_dot_product_attention(qs, ks, vs)),
                lambda: torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True))

    # Limits: at 12 heads of 32 the kernels read <= 1.9e-4 against their plain
    # versions and a moved rounding point reads >= 2.5e-3 on dk (PERF.md).
    row11_limit = (7e-4,) * 3
    row11 = {}
    for h_, tag in ((heads, ""), (2 * heads, "[D=32]")):
        o_, lse_ = flash_attention_packed(q, k, vv, h_)
        lib_fwd, lib_bwd = sdpa_calls(h_)
        bwd_bytes = nbytes(q, k, vv, o_, do, lse_) + nbytes(qkv)
        plain_bwd = flash_attention_packed_bwd_plain
        if tag:  # the forward's three forms at head dim 32
            def fwd(fn, h_=h_, form="safe"):
                args = {"safe": (), "fixed": (chunk, True), "chunked": (chunk,)}[form]
                return lambda: o_twice(fn(q, k, vv, h_, None, *args))

            row11[f"flash_packed{tag}"] = (
                fwd(flash_attention_packed), fwd(flash_attention_packed_plain),
                [fwd(flash_attention_packed_plain, form="fixed"),
                 lambda: f32_scaled(fwd(flash_attention_packed_plain))],
                ["P rounded against the fixed max", "q scaled by the f32 scale"],
                FWD_METRICS, FWD_LIMITS, 10, 3, nbytes(q, k, vv, o_, lse_), flash_flops, lib_fwd)
            for form in ("fixed", "chunked"):
                row11[f"{fpk.FWD_COUNTERS[form]}{tag}"] = (
                    fwd(flash_attention_packed, form=form),
                    fwd(flash_attention_packed_plain, form=form),
                    fwd(flash_attention_packed_plain),
                    "P rounded against the row max" + (", not the running max"
                                                       if form == "chunked" else ""),
                    FWD_METRICS, FWD_LIMITS, 10, 3, nbytes(q, k, vv, o_, lse_), flash_flops,
                    lib_fwd)
            row11[f"flash_packed_bwd{tag}"] = (
                bwd_call(flash_attention_packed_bwd, "fused", h_, o_, lse_),
                bwd_call(plain_bwd, "fused", h_, o_, lse_),
                bwd_call(plain_bwd, "split", h_, o_, lse_),
                "split's dk rounding", (rel_l2,) * 3, row11_limit, 5, 2,
                bwd_bytes, 5 * flash_flops // 2, lib_bwd)
        controls = ({"split": ("fused", None, "the fused dk rounding"),
                     "chunked": ("split", None, "split's scores")} if tag else
                    {form: (form, torch.zeros_like(o_), "delta = rowsum(dO*O) left out")
                     for form in ("split", "chunked")})
        for form, (c_form, c_o, fault) in controls.items():
            row11[f"flash_packed_bwd_{form}{tag}"] = (
                bwd_call(flash_attention_packed_bwd, form, h_, o_, lse_),
                bwd_call(plain_bwd, form, h_, o_, lse_),
                bwd_call(plain_bwd, c_form, h_, o_, lse_, c_o),
                fault, (rel_l2,) * 3, row11_limit, 5, 2, bwd_bytes, 5 * flash_flops // 2,
                lib_bwd)
    check_kernels(row11)
    del row11, qkv, q, k, vv, do
    torch.cuda.empty_cache()

    def vit_net(vcfg, **kw):
        net = IntentNetViT(vcfg.vit, vcfg.heads, dtype=torch.bfloat16,
                           param_dtype=torch.float32, **kw)
        net.load_state_dict(params)  # 12 heads of 32 take the same parameter shapes
        return net.to(dev)

    # one step's loss and gradients under each form against the fused step's,
    # on phase 5's batch, weights and draws; at head dim 64 the forms are one
    # function (the scale 1/8 is exact), so the limits are far under phase 5's
    m_f, g_f = loss_and_grads(False, vit_net(cfg), cfg)
    form_limit, form_worst_limit, form_loss_limit = 1e-5, 1e-4, 1e-6
    for form in ("split", "chunked"):
        _build.reset_launch_counts()
        m_s, g_s = loss_and_grads(False, vit_net(cfg, bwd_fused=False, bwd_kv_chunk=forms[form][1]),
                                  cfg)
        counter = fpk.BWD_COUNTERS[form]
        check(_build.launches[counter] == 2 * v.depth and _build.launches["flash_packed_bwd"] == 0,
              f"{form} step: launches {dict(_build.launches)}")
        r_all, r_worst, r_name = grad_readings(g_s, g_f)
        loss_rel = abs(m_s["loss"] - m_f["loss"]) / abs(m_f["loss"])
        check(r_all < form_limit and r_worst < form_worst_limit and loss_rel < form_loss_limit,
              f"{form} step against the fused step: all {r_all}, worst {r_worst} ({r_name}), "
              f"loss rel {loss_rel}; limits {form_limit}, {form_worst_limit}, {form_loss_limit}")
        print(f"flash forms: step {form} vs fused, loss {m_s['loss']:.6f} vs {m_f['loss']:.6f} "
              f"(rel {loss_rel:.3e} < {form_loss_limit:g}); gradients relative L2 all "
              f"{r_all:.3e} < {form_limit:g}, worst {r_worst:.3e} ({r_name}) < "
              f"{form_worst_limit:g}; launches {counter} {_build.launches[counter]}, "
              f"flash_packed_bwd 0", flush=True)
        del g_s
    del g_f

    # timed steps under each form, at 6 heads of 64 and at 12 heads of 32
    cfg32 = dataclasses.replace(cfg, vit=dataclasses.replace(v, num_heads=2 * heads))
    form_counts = {}
    for vcfg, tag in ((cfg, ""), (cfg32, "[D=32]")):
        for form, (fused, ck_) in forms.items():
            if not tag and form == "fused":
                continue  # phase 5 timed it
            net = vit_net(vcfg, bwd_fused=fused, bwd_kv_chunk=ck_)
            fstep = make_train_step(net, vcfg, anchors, make_optimizer(net.parameters(), vcfg))
            fgen = torch.Generator(device="cuda").manual_seed(2)
            fstep(tbatch, fgen)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            step_ms, metrics = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                metrics.append(fstep(tbatch, fgen))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            counts = dict(_build.launches)
            form_counts[f"{form}{tag}"] = counts
            per_step_f = {**per_step, "flash_packed_bwd": 0, fpk.BWD_COUNTERS[form]: 2 * v.depth}
            want_counts = {k_: per_step_f.get(k_, 0) * len(step_ms) for k_ in counts}
            check(counts == want_counts,
                  f"{form}{tag} train launch counts {counts} != {want_counts}")
            for m in metrics:
                check(all(bool(torch.isfinite(t)) for t in m.values()),
                      f"{form}{tag}: non-finite metrics {m}")
            ms_step = sum(step_ms) / len(step_ms)
            print(f"flash forms: train {form}{tag} ({vcfg.vit.num_heads} heads of "
                  f"{d // vcfg.vit.num_heads}): launches per step "
                  f"{ {k_: n // 3 for k_, n in counts.items() if n} }; losses "
                  f"{[round(float(m['loss']), 6) for m in metrics]}; step ms "
                  f"{[round(t, 2) for t in step_ms]}; {ms_step:.2f} ms/step, "
                  f"{batch / ms_step * 1e3:.2f} samples/s at batch {batch}; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
            del net, fstep, metrics
            torch.cuda.empty_cache()

    # the forward's chunked safe softmax served (fwd_kv_chunk=1152, the sweep
    # of tools/perf_sweep.sh; phase 12's bench lines serve the fixed max)
    form_failures = []
    ecfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, fwd_kv_chunk=chunk))
    chunked_serve_counts = serve_config(
        "E fwd_kv_chunk=1152", ecfg, "chunks",
        {**per_request, "flash_packed": 0, "flash_packed_chunked": 2 * v.depth}, form_failures)
    check(not form_failures, "; ".join(form_failures))

    # 12. the bench twins (bench_torch.py, tools/bench_train_torch.py): every
    # line once, through their functions, at a reduced count; the full runs
    # are the scripts' own
    import bench_torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import bench_train_torch

    names = bench_torch.DEFAULT_LINES
    bench_lines, line_counts = [], {}
    for metric, kw in ((names[0], dict(model_name="cnn")),
                       (names[1], dict(model_name="cnn", voxembed=True)),
                       (names[2], dict(model_name="vit")), (names[3], None),
                       (names[4], dict(model_name="vit", voxembed=True)),
                       ("bev_frames_per_sec_per_chip_int8", dict(model_name="vit", int8=True)),
                       ("bev_frames_per_sec_per_chip_cells", dict(model_name="vit", cells=True))):
        _build.reset_launch_counts()
        if kw is None:
            bench_lines.append(bench_torch.run_sustained(batches=3, passes=1))
        else:
            bench_lines.append(bench_torch.run_mode(metric, iters=2, **kw))
        line_counts[metric] = dict(_build.launches)
        torch.cuda.empty_cache()
    # the ViT lines serve bench.py's switches (the fixed max); _sustained, as
    # bench.py's run_sustained, the default config (the safe form)
    bench_counts = {k_: sum(c[k_] for c in line_counts.values()) for k_ in _build.launches}
    for metric, c in line_counts.items():
        fwd_counts = {k_: c[k_] for k_ in fpk.FWD_COUNTERS.values()}
        want = (None if "cnn" in metric else "flash_packed" if metric == names[3]
                else "flash_packed_fixed")
        check(all((n > 0) == (k_ == want) for k_, n in fwd_counts.items()),
              f"bench line {metric}: flash forwards {fwd_counts}, want only {want}")
    check([ln["metric"] for ln in bench_lines[:5]] == list(names),
          f"bench lines {[ln['metric'] for ln in bench_lines]} != {names}")
    for ln in bench_lines:
        keys = bench_torch.SUSTAINED_KEYS if ln["metric"] == names[3] else bench_torch.KEYS
        nums = [ln["value"], ln["vs_baseline"], *(
            [*ln["passes"], ln["h2d_MiBps"], ln["transport_MiB_per_frame"],
             ln["host_build_samples_per_sec"]] if ln["metric"] == names[3] else [])]
        check(tuple(ln) == keys and ln["unit"] == "frames/s"
              and all(np.isfinite(x) and x > 0 for x in nums), f"bench line {ln}")
    bench_train = {}
    for form in ("fused", "chunked"):
        r = bench_train_torch.run(steps=2, bwd_fused=forms[form][0], bwd_kv_chunk=forms[form][1])
        check(r["bwd_mode"] == form and r["launches_per_step"].get(fpk.BWD_COUNTERS[form]) == 24
              and np.isfinite(r["loss"]) and r["ms_per_step"] > 0, f"bench_train {form}: {r}")
        bench_train[form] = r
        torch.cuda.empty_cache()
    print(f"bench twins: {len(bench_lines)} bench_torch lines with bench.py's keys in its order "
          f"(default run {list(names)}), bench_train_torch under fused and chunked "
          f"({ {f: round(r['ms_per_step'], 2) for f, r in bench_train.items()} } ms/step over "
          f"2 steps); the bench_torch ViT lines launched flash_packed_fixed "
          f"{bench_counts['flash_packed_fixed']} times and no other forward, _sustained "
          f"flash_packed {line_counts[names[3]]['flash_packed']} [{card}]", flush=True)

    # 13. the library ops of ops.experimental (rows 18 and 19): no model path
    # calls them, so the path is each op's entry at the attention sublayer's
    # shapes (JAX's ViT pads 4501 tokens to 4608 rows; 4501 real keys)
    t13 = time.perf_counter()
    t_pad = 4608
    qkv = randn((batch, t_pad, 3 * d), 1.0)
    q, k, vv = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    n_p = batch * t_pad
    xp, rp, dyp = randn((n_p, d), 1.0), randn((n_p, d), 1.0), randn((n_p, d), 1.0)
    wp, bp = randn((d, d), d ** -0.5), randn((d,), 0.1, torch.float32)
    keep_p = (torch.rand(batch, 1, generator=gen, device=dev) < 0.9).float() / 0.9
    gate_p = keep_p.repeat_interleave(t_pad, 0).contiguous()  # per sample, [N, 1]
    exp_counts = {}
    qkv32 = qkv.float()  # the f32 instance's q, k, v: slices of one f32 qkv
    q32, k32, v32 = (qkv32[..., i * d:(i + 1) * d] for i in range(3))
    # the int8 attention's instances: name -> (heads, q, k, v)
    int8_cases = {"flash_int8": (heads, q, k, vv), "flash_int8[D=32]": (2 * heads, q, k, vv),
                  "flash_int8[D=16]": (4 * heads, q, k, vv),
                  "flash_int8[D=128]": (heads // 2, q, k, vv),
                  "flash_int8[f32]": (heads, q32, k32, v32)}
    for name, (h_, q_, k_, v_) in int8_cases.items():
        _build.reset_launch_counts()
        o8 = flash_attention_packed_int8(q_, k_, v_, h_, tokens)
        torch.cuda.synchronize()
        exp_counts[name] = dict(_build.launches)
        check(o8.shape == (batch, t_pad, d) and o8.dtype == q_.dtype
              and bool(torch.isfinite(o8).all()),
              f"{name}: o {tuple(o8.shape)} {o8.dtype} not finite {q_.dtype} of shape "
              f"{(batch, t_pad, d)}")
    leaves = [t_.detach().clone().requires_grad_(True) for t_ in
              (xp.view(batch, t_pad, d), wp, bp, rp.view(batch, t_pad, d), keep_p)]
    _build.reset_launch_counts()
    y_p = fused_dense_residual(*leaves)
    y_p.backward(dyp.view(batch, t_pad, d))
    torch.cuda.synchronize()
    exp_counts["fused_proj"] = exp_counts["fused_proj_bwd"] = dict(_build.launches)
    finite = bool(torch.isfinite(y_p).all()) and all(
        bool(torch.isfinite(t_.grad).all()) for t_ in leaves)
    check(finite and not leaves[4].grad.any()
          and torch.equal(leaves[3].grad, dyp.view(batch, t_pad, d)),
          "fused_dense_residual: non-finite output or gradient, a gate gradient, or d residual "
          "!= dy")
    for name, counter in (*((n_, "flash_int8") for n_ in int8_cases),
                          ("fused_proj", "fused_proj"), ("fused_proj", "fused_proj_bwd")):
        check(exp_counts[name][counter] == 1 and sum(exp_counts[name].values()) == (
            2 if name == "fused_proj" else 1), f"{name}: launches {exp_counts[name]}")
    print(f"experimental: launches flash_int8 1 each ({', '.join(int8_cases)}); "
          f"fused_dense_residual "
          f"forward + backward: fused_proj 1, fused_proj_bwd 1; d gate 0, d residual = dy",
          flush=True)
    del y_p, leaves, o8

    def proj_unfused(x_, w_, b_, r_, g_):
        # the control's fault: the model's rounding, the Dense output to bf16
        # before the gate and the residual
        return ((torch.matmul(x_.float(), w_.float()) + b_).to(x_.dtype).float() * g_
                + r_.float()).to(x_.dtype)

    # the int8 attention's bound: the largest of its bytes, its two integer
    # products over the real keys (1979 TOP/s) and its B*H*T*seq_len
    # exponentials (16 a clock per SM at the card's top SM clock)
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    ex2_per_s = 16 * torch.cuda.get_device_properties(0).multi_processor_count * max_mhz * 1e6
    exp_cases = {}
    for name, (h_, q_, k_, v_) in int8_cases.items():
        exp_cases[name] = (
            lambda a=(q_, k_, v_, h_): flash_attention_packed_int8(*a, tokens),
            lambda a=(q_, k_, v_, h_): flash_attention_packed_int8_plain(*a, tokens),
            lambda a=(q_, k_, v_, h_): flash_attention_packed_int8_plain(*a, tokens, p_max="tile"),
            "P rounded against a running tile max", (rel_l2,), (2e-3,), 10, 2,
            nbytes(q_, k_, v_) + n_p * d * q_.element_size(),
            [(4 * batch * t_pad * tokens * d, INT8_OPS_PER_S),
             (batch * h_ * t_pad * tokens, ex2_per_s)], None)
    # row 19: y's and dx's relative L2 and share of differing elements, dW's
    # and db's relative L2 (the forward's control moves most of y)
    exp_cases["fused_proj"] = (
        lambda: twice(fused_proj_fwd(xp, wp, bp, rp, gate_p)),
        lambda: twice(fused_proj_fwd_plain(xp, wp, bp, rp, gate_p)),
        lambda: twice(proj_unfused(xp, wp, bp, rp, gate_p)),
        "Dense output rounded before gate and residual", (rel_l2, share), (3e-4, 2e-2), 20, 5,
        nbytes(xp, wp, bp, rp, gate_p) + n_p * d * 2, 2 * n_p * d * d, None)
    exp_cases["fused_proj_bwd"] = (
        lambda: dx_twice(fused_proj_bwd(xp, wp, dyp, gate_p)),
        lambda: dx_twice(fused_proj_bwd_plain(xp, wp, dyp, gate_p)),
        lambda: dx_twice((*fused_proj_bwd_plain(xp, wp, dyp, gate_p)[:2],
                          (dyp.float() * gate_p).bfloat16().float().sum(0))),
        "db from the rounded dyg", (rel_l2, share, rel_l2, rel_l2), (1e-3, 2e-2, 1e-4, 1e-4),
        20, 5, nbytes(xp, wp, dyp, gate_p) + n_p * d * 2 + d * d * 4 + d * 4, 4 * n_p * d * d,
        None)
    check_kernels(exp_cases)
    same_bits(exp_cases, (*int8_cases, "fused_proj", "fused_proj_bwd"))

    # reference columns (timed only; none computes the same function): the
    # bf16 packed forward and SDPA over the same q, k, v; cuBLAS's addmm with
    # gate 1 and the bias in the residual, and the model's unfused Linear,
    # gate and residual, forward and backward
    refs = {}
    for name, (h_, q_, k_, v_) in int8_cases.items():
        def heads_of(t_, h_=h_):
            return t_[:, :tokens].reshape(batch, tokens, h_, d // h_).transpose(1, 2).contiguous()
        qs_, ks_, vs_ = heads_of(q_), heads_of(k_), heads_of(v_)
        refs[name] = {f"SDPA {str(q_.dtype)[6:]}": cuda_ms(torch.no_grad()(
            lambda: F.scaled_dot_product_attention(qs_, ks_, vs_)), 10)}
        if q_.dtype == torch.bfloat16 and d // h_ in (32, 64):
            refs[name]["bf16 packed forward"] = cuda_ms(
                lambda h_=h_: flash_attention_packed(q, k, vv, h_, tokens), 10)
        del qs_, ks_, vs_
    r2b = (rp.float() + bp).bfloat16()
    w_lin = wp.t().contiguous()  # PyTorch's Linear layout [out, in]
    x3p, r3p, b16, g16 = xp.view(batch, t_pad, d), rp.view(batch, t_pad, d), bp.bfloat16(), \
        keep_p.view(batch, 1, 1).bfloat16()

    @torch.no_grad()
    def unfused_bwd():
        # the kernels autograd launches for it: dyg = dy * gate, dx = dyg W,
        # dW = dyg^T x, db = sum(dyg) (d residual = dy), without the
        # engine's host time, which the card would otherwise wait on
        dyg = (dyp.view(batch, t_pad, d) * g16).view(n_p, d)
        return torch.matmul(dyg, w_lin), torch.matmul(dyg.t(), xp), dyg.sum(0)

    refs["fused_proj"] = {
        "addmm (gate 1, bias in residual)": cuda_ms(
            torch.no_grad()(lambda: torch.addmm(r2b, xp, wp)), 20),
        "unfused Linear, gate, residual": cuda_ms(
            torch.no_grad()(lambda: r3p + F.linear(x3p, w_lin, b16) * g16), 20)}
    refs["fused_proj_bwd"] = {"unfused backward (its kernels)": cuda_ms(unfused_bwd, 20)}
    for name, cols in refs.items():
        r = record[name]
        print(f"experimental {name}: kernel {r['ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.3f} ms; references "
              + ", ".join(f"{k_} {v_:.3f} ms" for k_, v_ in cols.items()) + f"  [{card}]",
              flush=True)
    del qkv, q, k, vv, qkv32, q32, k32, v32, xp, rp, dyp, r2b, w_lin, x3p, r3p, exp_cases
    torch.cuda.empty_cache()
    print(f"experimental: phase 13 took {time.perf_counter() - t13:.1f} s", flush=True)

    # 14. the lifecycle at full width: AV2-format logs -> labels -> train()
    # with checkpoints and resume -> evaluate(), through the port's entry points
    import tempfile

    from intentbev_torch.checkpoint import load_checkpoint
    from intentbev_torch.data.argoverse import (ArgoverseSampleLoader, ScenarioValidator,
                                                build_sequence_index)
    from intentbev_torch.data.pipeline import batch_iterator
    from intentbev_torch.data.synthetic import multi_lane_map_data, write_synthetic_log
    from intentbev_torch.evaluate import evaluate
    from intentbev_torch.precompute_labels import run as precompute_labels
    from intentbev_torch.train import train as train_loop

    t14 = time.perf_counter()
    lcfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=batch, checkpoint_every_steps=2, log_every_steps=1))
    check(lcfg.train.compute_dtype == "bfloat16" and lcfg.train.transport == "points",
          f"phase 14 trains bf16 over points, not {lcfg.train}")
    frames, sweeps = 17, g.lidar_sweeps
    tmp14 = tempfile.TemporaryDirectory(prefix="smoke14_")  # phase 15 evaluates its run too
    with contextlib.nullcontext(tmp14.name) as tmp:
        root = Path(tmp)
        split, run_dir = root / "train", root / "run"
        for k_ in range(2):  # 2 logs: 2 x (17 - 10 + 1) = 16 sequences, 2 batches an epoch
            write_synthetic_log(
                split, log_id=f"smokelog{k_:02d}", num_frames=frames, seed=k_,
                points_per_sweep=40000, map_data=multi_lane_map_data(),
                vehicles=[{"start": (12.0 + 5 * k_, 1.75), "velocity": (6.0, 0.0)},
                          {"start": (8.0, -5.25), "velocity": (3.0, 0.0), "yaw_rate": 0.3},
                          {"start": (20.0, 9.0), "velocity": (0.0, 0.0)}])
        labelled = precompute_labels(str(root), ["train"], force=True)
        check(labelled == {"ok": 2, "skipped": 0, "failed": 0}, f"labels: {labelled}")
        seqs = build_sequence_index(ScenarioValidator(str(split), verbose=False)
                                    .find_valid_scenarios(), sweeps)
        check(len(seqs) == 16, f"{len(seqs)} sequences, want 16")

        # the loader alone, cold (feather reads, map rasters at augmented poses)
        loader = ArgoverseSampleLoader(g, max_gt=cfg.loss.max_gt_boxes, verbose=False)
        t0 = time.perf_counter()
        n_loaded = sum(b_.gt_boxes.shape[0] for b_ in batch_iterator(
            seqs, loader, batch, shuffle=True, num_workers=4, augment=cfg.augment))
        load_s = time.perf_counter() - t0
        check(n_loaded == 16, f"the loader gave {n_loaded} samples")
        pts_per_sweep = min(int(s_.points_valid.sum(1).min()) for s_ in (
            loader.load(seqs[0]), loader.load(seqs[-1])))
        check(pts_per_sweep >= 20000, f"{pts_per_sweep} points in a sweep, want >= 20000")
        print(f"lifecycle: 2 logs x {frames} frames, {pts_per_sweep}+ points a sweep, "
              f"{len(seqs)} sequences; loader {n_loaded / load_s:.2f} samples/s cold "
              f"(4 threads, augmented, batch {batch}) [{card}]", flush=True)

        def timed_log(stamps):
            def log(line):
                stamps.append((time.perf_counter(), str(line)))
                print(f"lifecycle: {line}", flush=True)
            return log

        live, stamps1, stamps2 = {}, [], []
        _build.reset_launch_counts()
        train_loop(lcfg, str(split), str(run_dir), num_workers=4, max_steps=3,
                   log_fn=timed_log(stamps1), state_out=live)
        torch.cuda.synchronize()
        ckpt, ckpt_cfg = load_checkpoint(run_dir, map_location=dev)
        check(ckpt["step"] == live["step"] == 3 and ckpt_cfg == lcfg,
              f"checkpoint step {ckpt['step']}, live {live['step']}")
        check(ckpt["loop"]["epoch"] == 1 and ckpt["loop"]["epoch_batch"] == 1,
              f"after 3 steps of 2-batch epochs: loop {ckpt['loop']}")
        live_sd = live["model"].state_dict()
        check(set(live_sd) == set(ckpt["model"]) and all(
            torch.equal(ckpt["model"][k_], v_) for k_, v_ in live_sd.items()),
            "the saved parameters differ from the live model's")
        check(sorted(p_.name for p_ in run_dir.glob("step_*")) == ["step_00000002",
                                                                   "step_00000003"],
              f"checkpoints {sorted(p_.name for p_ in run_dir.glob('step_*'))}")
        del live, live_sd, ckpt
        train_loop(lcfg, str(split), str(run_dir), num_workers=4, max_steps=4, resume=True,
                   log_fn=timed_log(stamps2))
        torch.cuda.synchronize()
        loop_counts = dict(_build.launches)
        check(any("resumed from step 3 (epoch 1 batch 1" in s_ for _, s_ in stamps2),
              "the resumed run did not report step 3, epoch 1, batch 1")
        ckpt, _ = load_checkpoint(run_dir)
        check(ckpt["step"] == 4 and ckpt["loop"]["epoch"] == 1
              and ckpt["loop"]["epoch_batch"] == 2,
              f"resumed run: step {ckpt['step']}, loop {ckpt['loop']} (want 4, epoch 1, "
              f"batch 2)")
        records = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
        check([r_["step"] for r_ in records] == [1, 2, 3, 4], f"logged steps {records}")
        check(all(np.isfinite(r_[k_]) for r_ in records for k_ in ("loss", "cls_loss",
                                                                   "box_loss", "intent_loss")),
              f"non-finite losses {records}")
        want_counts = {k_: vit_per_step.get(k_, 0) * 4 for k_ in loop_counts}
        check(loop_counts == want_counts,
              f"train loop launch counts {loop_counts} != {want_counts}")
        step_times = [t_ for t_, s_ in stamps1 if " step " in s_ and "loss" in s_]
        loop_ms = (step_times[2] - step_times[0]) / 2 * 1e3  # steps 2 and 3, sync each
        print(f"lifecycle: train loop, 3 steps then a resume to step 4: launches "
              f"{loop_counts}; losses {[round(r_['loss'], 4) for r_ in records]}; loop "
              f"{loop_ms:.1f} ms/step (steps 2-3, loader and an epoch turn included) "
              f"against {vit_step_ms:.2f} ms/step for the step alone (phase 5) [{card}]",
              flush=True)

        # one step over the chunk train transport (row 12's fill in the loop)
        ccfg14 = dataclasses.replace(lcfg, train=dataclasses.replace(
            lcfg.train, transport="chunks"))
        _build.reset_launch_counts()
        m14 = train_loop(ccfg14, str(split), str(root / "run_chunks"), num_workers=4,
                         max_steps=1, log_fn=lambda *_: None)
        torch.cuda.synchronize()
        chunk_loop_counts = dict(_build.launches)
        want_counts = {k_: vit_per_step.get(k_, 0) for k_ in chunk_loop_counts}
        want_counts["voxel_fill"] = 1
        check(chunk_loop_counts == want_counts and np.isfinite(m14["loss"]),
              f"chunk-transport loop: launches {chunk_loop_counts} != {want_counts}, {m14}")
        print(f"lifecycle: one step over the chunk train transport: launches "
              f"{chunk_loop_counts}, loss {m14['loss']:.4f}", flush=True)

        _build.reset_launch_counts()
        eval_logs = []
        t0 = time.perf_counter()
        p14_confusion = []
        with capture_confusion(p14_confusion):
            results = evaluate(str(run_dir), str(split), num_workers=4, max_batches=2,
                               log_fn=eval_logs.append)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_counts = dict(_build.launches)
        per_batch = {"flash_packed": 2 * v.depth, "fused_ln_mlp": 2 * v.depth, "layernorm": 4}
        want_counts = {k_: per_batch.get(k_, 0) * 2 for k_ in eval_counts}
        check(eval_counts == want_counts, f"eval launch counts {eval_counts} != {want_counts}")
        check(results["num_samples"] == 16, f"eval: {results['num_samples']} samples")
        maps = {k_: v_ for k_, v_ in results.items() if k_.startswith("mAP@")}
        check(len(maps) == 5 and all(np.isfinite(m_) and 0.0 <= m_ <= 1.0
                                     for m_ in maps.values()), f"eval mAPs {maps}")
        print(f"lifecycle: eval {results}; launches {eval_counts}; "
              f"{results['num_samples'] / eval_s:.2f} samples/s (2 batches of {batch}, "
              f"checkpoint load and loader included) [{card}]", flush=True)
        for line in eval_logs:
            print(f"lifecycle: eval | {line}", flush=True)

        # the eval logits of one batch through the kernels against the plain
        # versions; control: the plain path binning the points with true
        # divisions (the host chunk build's arithmetic, not the jitted JAX
        # voxelizer's: a fault this slice repaired)
        ckpt, ckpt_cfg = load_checkpoint(run_dir)
        ebatch = next(iter(batch_iterator(seqs[:batch], ArgoverseSampleLoader(
            g, max_gt=cfg.loss.max_gt_boxes, verbose=False), batch, num_workers=4)))
        eargs = (ebatch.points, ebatch.points_valid, ebatch.map_bev)
        got = StreamingInferencer(ckpt_cfg, ckpt["model"], "cuda").logits_points(*eargs)
        eplain = StreamingInferencer(ckpt_cfg, ckpt["model"], "cuda", plain_ops=True)
        want = eplain.logits_points(*eargs)
        with with_host_bins(importlib.import_module("intentbev_torch.parallel.inference")):
            ctrl = eplain.logits_points(*eargs)
        sound, ctrl_r = compare("eval logits", got, want, ctrl, (rel_l2,) * 3, slice_limit,
                                "points binned by true division")
        print("lifecycle: eval logits kernel vs plain path, relative L2 (cls, box, intent) "
              f"[{', '.join(f'{r:.3e}' for r in sound)}] under {slice_limit[0]:g}; control "
              f"(plain path, points binned by true division) "
              f"[{', '.join(f'{r:.3e}' for r in ctrl_r)}] caught", flush=True)
        del got, want, ctrl, ckpt, ebatch, eplain
    torch.cuda.empty_cache()
    print(f"lifecycle: phase 14 took {time.perf_counter() - t14:.1f} s", flush=True)

    # 15. deploy: sweep rings and city-raster maps on the card, the full-width
    # ViT served on them, and data parallel at world size 1 in a child process
    from intentbev_torch.bev.city_raster import (build_city_raster, warp_city_to_ego,
                                                 warp_city_to_ego_device)
    from intentbev_torch.bev.rasterize import parse_map_json
    from intentbev_torch.data.streaming import (SweepRing, batched_voxelize_rings, make_ring,
                                                push_sweep, stack_rings)
    from intentbev_torch.geometry import se3_from_quat_translation

    t15 = time.perf_counter()
    n_streams, n_slots, n_pts, n_push = batch, g.lidar_sweeps, 65536, g.lidar_sweeps + 2
    srng = np.random.default_rng(15)

    def stream_pose(b_, i_):
        """Stream b_'s world pose at sweep i_: down the corridor, turning."""
        yaw_ = 0.15 * b_ - 0.5 + 0.01 * i_
        return se3_from_quat_translation(
            [0.0, 0.0, np.sin(yaw_ / 2), np.cos(yaw_ / 2)],
            [12.0 + 13.0 * b_ + 1.3 * i_, -4.0 + b_ + 0.05 * i_, 0.02 * i_]).astype(np.float32)

    rings = stack_rings([make_ring(n_slots, n_pts, dev) for _ in range(n_streams)])
    host_sweeps = []  # the last n_slots pushes: (points, valid, poses), oldest first
    for i_ in range(n_push):
        pts_ = np.zeros((n_streams, n_pts, 4), np.float32)
        pts_[..., 0] = srng.uniform(g.bev_x_min - 3, g.bev_x_max + 3, (n_streams, n_pts))
        pts_[..., 1] = srng.uniform(g.bev_y_min - 3, g.bev_y_max + 3, (n_streams, n_pts))
        pts_[..., 2] = srng.uniform(-2.5, 4.2, (n_streams, n_pts))
        pts_[..., 3] = np.round(srng.uniform(0, 255, (n_streams, n_pts)))
        vld_ = srng.uniform(size=(n_streams, n_pts)) < 0.95
        poses_ = np.stack([stream_pose(b_, i_) for b_ in range(n_streams)])
        rings = push_sweep(rings, torch.from_numpy(pts_).to(dev), torch.from_numpy(vld_).to(dev),
                           torch.from_numpy(poses_).to(dev))
        host_sweeps = (host_sweeps + [(pts_, vld_, poses_)])[-n_slots:]
    check(rings.head.tolist() == [n_push % n_slots] * n_streams
          and rings.count.tolist() == [n_slots] * n_streams,
          f"ring head {rings.head.tolist()}, count {rings.count.tolist()}")
    currents = np.stack([stream_pose(b_, n_push - 1) for b_ in range(n_streams)])
    cur_dev = torch.from_numpy(currents).to(dev)
    ring_bev = batched_voxelize_rings(rings, cur_dev, g)
    torch.cuda.synchronize()
    cpu_bev = batched_voxelize_rings(SweepRing(*(t_.cpu() for t_ in rings)),
                                     torch.from_numpy(currents), g)
    # the host's re-projection in f64 (oldest sweep first), and the points
    # whose exact bins lie within 1e-3 of a cell or slice boundary
    inv_v = float(np.float32(1.0) / np.float32(g.voxel_size_m))
    z_scale = float(np.float32(np.float32(1.0) / np.float32(g.z_max - g.z_min))
                    * np.float32(g.lidar_height_channels))
    host_pts = np.zeros((n_streams, n_slots, n_pts, 4), np.float32)
    host_vld = np.zeros((n_streams, n_slots, n_pts), bool)
    n_near = 0
    for b_ in range(n_streams):
        inv_cur = np.linalg.inv(currents[b_].astype(np.float64))
        for a_, (pts_, vld_, poses_) in enumerate(host_sweeps):
            rel = inv_cur @ poses_[b_].astype(np.float64)
            xyz = pts_[b_, :, :3].astype(np.float64) @ rel[:3, :3].T + rel[:3, 3]
            host_pts[b_, a_, :, :3] = xyz
            host_pts[b_, a_, :, 3] = pts_[b_, :, 3]
            host_vld[b_, a_] = vld_[b_]
            near = np.zeros(n_pts, bool)
            for v_ in (g.pixel_offset_x + xyz[:, 1] * inv_v, g.pixel_offset_y - xyz[:, 0] * inv_v,
                       (xyz[:, 2] - g.z_min) * z_scale):
                near |= np.abs(v_ - np.round(v_)) < 1e-3
            n_near += int((near & vld_[b_]).sum())
    host_bev = voxelize_packed(torch.from_numpy(host_pts).to(dev),
                               torch.from_numpy(host_vld).to(dev), g)
    diff_cpu = int((ring_bev.cpu() != cpu_bev).sum())
    diff_host = int((ring_bev != host_bev).sum())
    occupied = int((ring_bev > 0).sum())
    check(diff_cpu <= 2 * n_near and diff_host <= 2 * n_near and occupied > 1_000_000,
          f"ring BEVs: {diff_cpu} cells differ from the CPU's, {diff_host} from the host "
          f"re-projection's, {n_near} points near a boundary (limit 2 cells each), "
          f"{occupied} occupied")
    print(f"deploy: {n_streams} rings x {n_slots} sweeps x {n_pts} points, {n_push} pushes; "
          f"batched_voxelize_rings on the card vs on the CPU: {diff_cpu} cells differ, vs "
          f"voxelize_packed over the host's f64 re-projection: {diff_host} (limit 2 a point "
          f"within 1e-3 of a boundary: {n_near} such points); {occupied} occupied cells",
          flush=True)

    (map_json,) = (next(split.iterdir()) / "map").glob("log_map_archive_*.json")
    city = build_city_raster(parse_map_json(str(map_json)), g)
    raster = torch.from_numpy(city.raster).to(dev)
    xy_yaw = np.stack([[p_[0, 3], p_[1, 3], np.arctan2(p_[1, 0], p_[0, 0])] for p_ in currents])
    xy_yaw_dev = torch.from_numpy(xy_yaw.astype(np.float32)).to(dev)
    maps = warp_city_to_ego_device(raster, city.origin_xy, xy_yaw_dev, g)
    host_maps = []
    for tx_, ty_, yaw_ in xy_yaw.astype(np.float32).tolist():
        host_maps.append(warp_city_to_ego(city, {"tx_m": tx_, "ty_m": ty_, "qx": 0.0, "qy": 0.0,
                                                 "qz": np.sin(yaw_ / 2), "qw": np.cos(yaw_ / 2)},
                                          g))
    map_share = float((maps.cpu().numpy() != np.stack(host_maps)).mean())
    # JAX's own test holds its device warp to its host warp at a 0.002 share
    check(map_share < 2e-3 and float(maps[..., 0].sum()) > 0,
          f"the device warp differs from the host warp in a share {map_share} of its pixels")
    print(f"deploy: city raster {tuple(city.raster.shape)} of the log's map; "
          f"warp_city_to_ego_device of {n_streams} poses against the host warp: a share "
          f"{map_share:.3e} of the values differ (limit 2e-3)", flush=True)

    ring_ms = cuda_ms(lambda: batched_voxelize_rings(rings, cur_dev, g, torch.bfloat16), 10)
    warp_ms = cuda_ms(lambda: warp_city_to_ego_device(raster, city.origin_xy, xy_yaw_dev, g),
                      10)
    print(f"deploy: per batch of {n_streams} streams: ring voxelize {ring_ms:.3f} ms, map warp "
          f"{warp_ms:.3f} ms [{card}]", flush=True)

    lidar15 = ring_bev.to(torch.bfloat16)
    sinf = StreamingInferencer(cfg, params, "cuda", gelu="sigmoid")
    with torch.inference_mode():
        sinf.model(lidar15, maps)  # warm-up
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        got = sinf.model(lidar15, maps)
        det15 = sinf.fetch(sinf.postprocess(*got))
        torch.cuda.synchronize()
        stream_counts = dict(_build.launches)
        want = StreamingInferencer(cfg, params, "cuda", gelu="sigmoid",
                                   plain_ops=True).model(lidar15, maps)
        ctrl = StreamingInferencer(cfg, params, "cuda", gelu="erf",
                                   plain_ops=True).model(lidar15, maps)
    want_counts = {k_: {"flash_packed": 2 * v.depth, "fused_ln_mlp": 2 * v.depth,
                        "layernorm": 4}.get(k_, 0) for k_ in stream_counts}
    check(stream_counts == want_counts,
          f"ring + map serving launch counts {stream_counts} != {want_counts}")
    sound, ctrl_r = compare("ring + map logits", got, want, ctrl, (rel_l2,) * 3, slice_limit,
                            "erf GELU in the blocks")
    check(det15.boxes_xywha.shape == (n_streams, cfg.eval.max_detections, 5)
          and np.isfinite(det15.boxes_xywha).all() and np.isfinite(det15.scores).all(),
          "ring + map detections: shape or non-finite values")
    print(f"deploy: the ViT on the ring BEVs and warped maps: launches "
          f"{ {k_: n_ for k_, n_ in stream_counts.items() if n_} }; logits "
          f"kernel vs plain path, relative L2 (cls, box, intent) "
          f"[{', '.join(f'{r:.3e}' for r in sound)}] under {slice_limit[0]:g}; control "
          f"(plain path, erf GELU) [{', '.join(f'{r:.3e}' for r in ctrl_r)}] caught; valid "
          f"detections per stream {det15.valid.sum(1).tolist()}", flush=True)
    del rings, ring_bev, cpu_bev, host_bev, maps, lidar15, sinf, got, want, ctrl, raster
    torch.cuda.empty_cache()

    # data parallel at world size 1: one NCCL rank in a child process
    dp_dir = root / "dp"
    dp_dir.mkdir()
    torch.save({"params": params, "batch": {k_: t_.cpu() for k_, t_ in tbatch.items()},
                "draws": StepDraws(type(draws.dropout)(*(t_.cpu() for t_ in draws.dropout)),
                                   draws.intent_u.cpu())}, dp_dir / "inputs.pt")
    t0 = time.perf_counter()
    try:
        child = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--dp-child", str(dp_dir),
             str(run_dir), str(split)], capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired as e:
        fail(f"deploy: the data-parallel child did not finish within 600 s: {e.stdout}")
    for line in child.stdout.splitlines():
        print(f"deploy: child | {line}", flush=True)
    check(child.returncode == 0, f"deploy: the data-parallel child exited "
          f"{child.returncode}: {child.stderr[-4000:]}")
    dp = json.loads((dp_dir / "result.json").read_text())
    dp_grads = torch.load(dp_dir / "grads.pt", weights_only=True)
    dp_step_counts, dp_eval_counts = dp["step_counts"], dp["eval_counts"]
    check(dp_step_counts == {k_: vit_per_step.get(k_, 0) for k_ in dp_step_counts},
          f"DP step launch counts {dp_step_counts} != phase 5's {vit_per_step}")
    check(dp_eval_counts == eval_counts,
          f"distributed eval launch counts {dp_eval_counts} != phase 14's {eval_counts}")
    # the rule of phase 5's kernel step against its plain step: loss terms within 1e-2
    # relative (here 1e-3), gradients' relative L2 under 6e-3 overall and 0.4 the worst tensor
    m_rel = {k_: abs(dp["metrics"][k_] - p5_metrics[k_]) / max(abs(p5_metrics[k_]), 1e-30)
             for k_ in p5_metrics}
    dp_g = grad_readings(dp_grads, p5_grads)
    check(all(r_ < 1e-3 for r_ in m_rel.values())
          and dp["metrics"]["num_pos_anchors"] == p5_metrics["num_pos_anchors"]
          and dp_g[0] < grad_limit and dp_g[1] < worst_limit,
          f"DP step at world 1 vs phase 5's step: metrics {dp['metrics']} vs {p5_metrics} "
          f"(relative {m_rel}), gradients {dp_g}")
    p14_counts = {k_: results[k_] for k_ in ("num_samples", "pre_nms_overflow", "det_overflow",
                                            "gt_overflow")}
    dp_counts = {k_: dp["eval"][k_] for k_ in p14_counts}
    check(dp_counts == p14_counts and dp["confusion"] == p14_confusion[-1]
          and set(dp["eval"]) == set(results),
          f"distributed eval: {dp['eval']} vs {results}, confusion {dp['confusion']} vs "
          f"{p14_confusion[-1]}")
    map_diff = max(abs(dp["eval"][k_] - results[k_]) for k_ in results
                   if k_.startswith(("mAP@", "intention_")))
    print(f"deploy: DP at world size 1 (NCCL): the sharded step on phase 5's batch and draws, "
          f"metrics {dp['metrics']} (largest relative difference to phase 5's "
          f"{max(m_rel.values()):.3e}, limit 1e-3), gradients relative L2 all {dp_g[0]:.3e}, "
          f"worst {dp_g[1]:.3e} ({dp_g[2]}); launches "
          f"{ {k_: n_ for k_, n_ in dp_step_counts.items() if n_} }; distributed eval of "
          f"phase 14's checkpoint: counts {dp_counts} and the confusion matrix equal phase "
          f"14's, mAPs and intention metrics within {map_diff:.3e}; launches "
          f"{ {k_: n_ for k_, n_ in dp_eval_counts.items() if n_} }; "
          f"the child took {time.perf_counter() - t0:.1f} s", flush=True)
    del dp_grads
    print(f"deploy: phase 15 took {time.perf_counter() - t15:.1f} s", flush=True)

    # 16. tensor parallelism: phase 5's step at model_parallel=2, two ranks on
    # the one card over gloo, each in its own process (tp_child)
    import socket

    t16 = time.perf_counter()
    tp_dir = root / "tp"
    tp_dir.mkdir()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        tp_port = sock.getsockname()[1]
    torch.cuda.empty_cache()
    logs = [open(tp_dir / f"rank{r_}.log", "w") for r_ in range(2)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--tp-child",
                               str(tp_dir), str(dp_dir / "inputs.pt"), str(r_), str(tp_port)],
                              stdout=logs[r_], stderr=subprocess.STDOUT)
             for r_ in range(2)]
    try:
        for p_ in procs:
            p_.wait(timeout=TP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        for p_ in procs:
            p_.kill()
            p_.wait()
        fail(f"tp: the tensor-parallel ranks did not finish within {TP_TIMEOUT_S} s")
    finally:
        for f_ in logs:
            f_.close()
    for r_, p_ in enumerate(procs):
        text = (tp_dir / f"rank{r_}.log").read_text()
        check(p_.returncode == 0, f"tp: rank {r_} exited {p_.returncode}: {text[-4000:]}")
    tp = [json.loads((tp_dir / f"result_rank{r_}.json").read_text()) for r_ in range(2)]
    per_rank = {  # launches a rank makes in one step, the model axis of 2
        "default": {"flash_attention": 2 * v.depth, "flash_attention_bwd": 2 * v.depth,
                    "fused_mlp_train": 2 * v.depth, "fused_mlp_bwd": 2 * v.depth,
                    "layernorm_train": 2 * (2 * v.depth + 2),
                    "layernorm_bwd": 2 * (2 * v.depth + 2)},
        "ln_dense": {"fused_ln_dense": 2 * v.depth + 2, "fused_ln_dense_bwd": 2 * v.depth + 2,
                     "flash_attention": 2 * v.depth, "flash_attention_bwd": 2 * v.depth,
                     "fused_mlp_train": 2 * v.depth, "fused_mlp_bwd": 2 * v.depth,
                     "layernorm_train": 2 * v.depth + 2, "layernorm_bwd": 2 * v.depth + 2}}
    refs16 = {"default": (p5_metrics, p5_grads), "ln_dense": kernel_steps["B fuse_ln_dense"]}
    for r_, res_ in enumerate(tp):
        check(res_["backend"] == "gloo" and res_["default"]["model_axis"] == [r_, 2],
              f"tp: rank {r_}: backend {res_['backend']}, model axis "
              f"{res_['default']['model_axis']}")
        for variant in TP_VARIANTS:
            got_c = res_[variant]["counts"]
            want_c = {k_: per_rank[variant].get(k_, 0) for k_ in got_c}
            check(got_c == want_c, f"tp {variant}: rank {r_} launch counts {got_c} != {want_c}")
    # The rule: TP runs other kernels (norm2 apart, row 13 on the hidden slice,
    # row 16 on 3 heads) and sums bf16 partials, so it is held as phase 5
    # holds its kernel step against its plain step: loss terms within 1e-2
    # relative, num_pos equal, gradients' relative L2 under 6e-3 overall and
    # 0.4 the worst tensor (phase 15's DP step, the same kernels at world 1,
    # is held within 1e-3)
    def tp_readings(metrics_, grads_, ref_):
        m_rel_ = {k_: abs(metrics_[k_] - ref_[0][k_]) / max(abs(ref_[0][k_]), 1e-30)
                  for k_ in ref_[0] if k_ != "num_pos_anchors"}
        g_ = grad_readings(grads_, ref_[1]) if grads_ is not None else (0.0, 0.0, "")
        ok_ = (max(m_rel_.values()) < loss_limit and g_[0] < grad_limit and g_[1] < worst_limit
               and metrics_["num_pos_anchors"] == ref_[0]["num_pos_anchors"])
        return ok_, m_rel_, g_

    tp_said = {}
    for variant in TP_VARIANTS:
        check(tp[0][variant]["metrics"] == tp[1][variant]["metrics"],
              f"tp {variant}: the ranks' metrics differ: {tp[0][variant]['metrics']} vs "
              f"{tp[1][variant]['metrics']}")
        grads16 = torch.load(tp_dir / f"grads_{variant}.pt", weights_only=True)
        ok, m_rel, g16 = tp_readings(tp[0][variant]["metrics"], grads16, refs16[variant])
        # read, not checked: against phase 5's f32 plain step, as phase 5 reads
        # its one-device kernel step
        tp_said[variant] = (m_rel, g16, grad_readings(grads16, p5_ref)
                            if variant == "default" else None)
        check(ok, f"tp {variant} step vs the one-device kernel step: metrics "
                  f"{tp[0][variant]['metrics']} vs {refs16[variant][0]} (relative {m_rel}), "
                  f"gradients {g16}")
        del grads16
    grads16 = torch.load(tp_dir / "grads_control.pt", weights_only=True)
    ok, m_rel_c, g_c16 = tp_readings(tp[0]["default"]["control"], grads16, refs16["default"])
    del grads16
    check(not ok, f"tp: the control (the MLP's reduce_from_model skipped) stays inside the "
                  f"rule: metrics {tp[0]['default']['control']}, relative {m_rel_c}, "
                  f"gradients {g_c16}")
    tp_ms = [sum(t_["default"]["step_ms"]) / 3 for t_ in tp]
    tp_gloo = [sum(t_["default"]["gloo_ms"]) / 3 for t_ in tp]
    for variant in TP_VARIANTS:
        m_rel, g16, g32 = tp_said[variant]
        f32 = "" if g32 is None else (f"; read, not checked: against the f32 plain step "
                                      f"all {g32[0]:.3e}, worst {g32[1]:.3e} ({g32[2]})")
        print(f"tp {variant}: mesh {tp[0][variant]['mesh']}, gloo; the step at "
              f"model_parallel=2 on {'phase 5' if variant == 'default' else 'phase 9 B'}'s "
              f"batch, weights and draws vs the one-device kernel step: loss terms within "
              f"{max(m_rel.values()):.3e} relative (limit {loss_limit:g}), gradients "
              f"relative L2 all {g16[0]:.3e} (limit {grad_limit:g}), worst {g16[1]:.3e} "
              f"({g16[2]}; limit {worst_limit:g}){f32}; launches a rank "
              f"{ {k_: n_ for k_, n_ in tp[0][variant]['counts'].items() if n_} }", flush=True)
    print(f"tp: control (both ranks skip the MLP's reduce_from_model) caught: loss terms "
          f"{max(m_rel_c.values()):.3e} relative, gradients relative L2 all {g_c16[0]:.3e}, "
          f"worst {g_c16[1]:.3e} ({g_c16[2]})", flush=True)
    print(f"tp: two ranks on one card over gloo (not TP's speed): "
          f"{tp_ms[0]:.2f} / {tp_ms[1]:.2f} ms a step on ranks 0 / 1 (steps "
          f"{[round(t_, 2) for t_ in tp[0]['default']['step_ms']]}), gloo's all-reduces "
          f"{tp_gloo[0]:.2f} / {tp_gloo[1]:.2f} ms of it ({tp_gloo[0] / tp_ms[0]:.3f} / "
          f"{tp_gloo[1] / tp_ms[1]:.3f}), peak device memory "
          f"{tp[0]['default']['peak_gib']:.2f} / {tp[1]['default']['peak_gib']:.2f} GiB a rank; "
          f"phase 5's one-device step {vit_step_ms:.2f} ms [{card}]", flush=True)
    del p5_grads, p5_ref, kernel_steps
    print(f"tp: phase 16 took {time.perf_counter() - t16:.1f} s", flush=True)

    # 17. the last modules: reference checkpoints imported through the CLI and
    # served through the kernels, a train step over the image-space
    # augmentation, and the example and tool twins through their entry points
    from intentbev_torch.bev.augment import draw_image_aug
    from intentbev_torch.import_torch import import_cnn_state_dict, import_vit_state_dict

    t17 = time.perf_counter()
    tmp17 = tempfile.TemporaryDirectory(prefix="smoke17_")
    root17, repo = Path(tmp17.name), Path(__file__).resolve().parent

    def reference_state_dict(rcfg, seed):
        """A reference-schema state dict of ``rcfg``'s family at its widths:
        the port's names mapped back (timm's interiors keep theirs; the patch
        embed is a conv [D, C, P, P]), every value a numpy draw from ``seed``
        (timm's std 0.02 for the ViT's weights, fan-in scaled convolutions)."""
        rng = np.random.default_rng(seed)
        sd = {}
        for key, t_ in init_params(rcfg).items():
            shape, vit_part = tuple(t_.shape), ".vit_" in key
            if vit_part and "patch_embed" in key:
                key = key.replace("patch_embed", "patch_embed.proj")
                shape = shape[::-1][:2] + shape[:2] if len(shape) == 4 else shape
            elif not vit_part:
                key = (key.replace("fusion.blocks.", "fusion_block.").replace(".blocks.", ".")
                       .replace("proj_conv", "downsample.0").replace("proj_bn", "downsample.1")
                       .replace("_norm.", ".0.").replace("_proj.", ".1."))
            if key.endswith("num_batches_tracked"):
                sd[key] = torch.tensor(0)
                continue
            if key.endswith("running_var"):
                a_ = 0.5 + rng.uniform(size=shape)
            elif len(shape) == 4 and not vit_part:
                a_ = rng.normal(0.0, np.prod(shape[1:]) ** -0.5, shape)
            elif len(shape) >= 2:
                a_ = rng.normal(0.0, 0.02, shape)
            elif key.endswith("weight"):  # LayerNorm and BatchNorm scales
                a_ = 1.0 + 0.1 * rng.normal(size=shape)
            else:
                a_ = 0.02 * rng.normal(size=shape)
            sd[key] = torch.from_numpy(a_.astype(np.float32))
        return sd

    def faulty_reference(sd):
        """The control's fault: the ViT's packed qkv rows taken k-first
        (k, q, v); the CNN's conv1 kernels with their two spatial axes swapped."""
        out = dict(sd)
        for key, t_ in sd.items():
            if key.endswith(("attn.qkv.weight", "attn.qkv.bias")):
                d_ = t_.shape[0] // 3
                out[key] = torch.cat([t_[d_:2 * d_], t_[:d_], t_[2 * d_:]])
            elif key.endswith("conv1.weight") and ".vit_" not in key:
                out[key] = t_.transpose(2, 3).contiguous()
        return out

    imports17 = {  # name: (config, --model, timm model name, launches per request)
        "import CNN": (default_cnn_config(), "cnn", None, {"voxel_fill": 1}),
        "import ViT-S": (cfg, "vit", "vit_small_patch8_224", per_request),
        "import ViT-Ti": (tcfg, "vit", "vit_tiny_patch8_224",
                          {"voxel_embed": 1, "layernorm": 4, "fused_ln_mlp": 2 * v.depth,
                           "flash_attention": 2 * v.depth})}
    ref_sds, procs = {}, {}
    for seed, (name, (rcfg, family, timm_name, _)) in enumerate(imports17.items()):
        ref_sds[name] = reference_state_dict(rcfg, 100 + seed)
        pth = root17 / f"{family}{seed}.pth"
        torch.save({"epoch": 3, "model_state_dict": ref_sds[name], "optimizer_state_dict": {},
                    "backbone_cfg": {"vit_model_name_lidar": timm_name,
                                     "img_size": list(rcfg.vit.img_size)} if timm_name else {}},
                   pth)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "intentbev_torch.import_torch", str(pth),
             str(root17 / name.replace(" ", "_")), "--model", family],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():  # the three CLIs ran side by side
        out, err = proc.communicate(timeout=300)
        check(proc.returncode == 0 and "imported -> " in out,
              f"{name}: the import CLI exited {proc.returncode}: {out[-2000:]} {err[-2000:]}")
    t_import = time.perf_counter() - t17

    def start_twin(*argv):
        """Start one entry point of the repo in a child process."""
        return (subprocess.Popen([sys.executable, *map(str, argv)], cwd=repo, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE),
                argv[0], time.perf_counter())

    def finish_twin(started, timeout=300):
        """Wait for a started child: its stdout and seconds."""
        proc, name, t0_ = started
        out_, err_ = proc.communicate(timeout=timeout)
        check(proc.returncode == 0, f"{name} exited {proc.returncode}: {out_[-2000:]} "
                                    f"{err_[-3000:]}")
        return out_, time.perf_counter() - t0_

    # the four twins, side by side with each other and with the checks
    # below: the synthetic twin (host only), score_range_torch on phase 14's
    # checkpoint and split, serve_chunks_torch, soak_loader_torch on phase
    # 14's split. Their rates are read side by side: a sanity check that each
    # runs, not a measurement of it
    synth17 = root17 / "synth"
    twins = {
        "synth": start_twin("examples/make_synthetic_dataset_torch.py", "--out", synth17,
                            "--train_logs", 1, "--val_logs", 1, "--frames", 10),
        "score_range": start_twin("tools/score_range_torch.py", "--ckpt_dir", run_dir,
                                  "--data_dir", split, "--batch", 2),
        "serve_chunks": start_twin("examples/serve_chunks_torch.py", "--batches", 2),
        "soak_loader": start_twin("tools/soak_loader_torch.py", "--data", split,
                                  "--samples", 200, "--workers", 4)}

    def stop_twins():
        """Kill a twin still running when the smoke exits (a failed check)."""
        for proc_, _, _ in twins.values():
            if proc_.poll() is None:
                proc_.kill()
                proc_.wait()

    atexit.register(stop_twins)
    failures17 = []
    for name, (rcfg, family, timm_name, per_req) in imports17.items():
        state, icfg = load_checkpoint(root17 / name.replace(" ", "_"))
        check(icfg.model_family == family and (family == "cnn" or (
            icfg.vit.embed_dim, icfg.vit.num_heads, icfg.vit.depth)
            == (rcfg.vit.embed_dim, rcfg.vit.num_heads, rcfg.vit.depth)),
            f"{name}: the imported config reads {icfg.vit if family == 'vit' else icfg.cnn}")
        bad = faulty_reference(ref_sds[name])
        ctrl_params = (import_cnn_state_dict(bad, icfg.cnn) if family == "cnn" else
                       import_vit_state_dict(bad, fusion_layers=icfg.vit.fusion_layers))
        serve_config(
            name, icfg, "chunks", per_req, failures17, state["model"], requests[:1],
            control=(ctrl_params, "plain, the qkv rows imported k-first" if family == "vit"
                     else "plain, conv1's kernels imported with kh and kw swapped"))
        del state, ctrl_params, bad
    check(not failures17, "; ".join(failures17))
    del ref_sds
    print(f"last modules: 3 reference checkpoints (CNN, ViT-S, ViT-Ti at full width) "
          f"imported by python -m intentbev_torch.import_torch in {t_import:.1f} s (three "
          f"processes side by side, the .pth writes included) and served through the "
          f"kernels [{card}]", flush=True)

    # the image-space augmentation: phase 5's batch without aug_params, every
    # sample flipped, rotated by 5 degrees and scaled by 1.03, no dropout
    fixed = dataclasses.replace(cfg.augment, flip_prob=1.0, rotate_prob=1.0,
                                rotate_range_deg=(5.0, 5.0), scale_prob=1.0,
                                scale_range=(1.03, 1.03), dropout_prob=0.0)
    acfg = dataclasses.replace(cfg, augment=fixed)
    lbatch = {k_: t_ for k_, t_ in tbatch.items() if k_ != "aug_params"}
    lgen = torch.Generator(device="cuda").manual_seed(3)
    ldraws = StepDraws(draw_dropout(fixed, g.height_px, g.width_px, batch, lgen, dev),
                       draws.intent_u, draw_image_aug(fixed, batch, lgen, dev))
    im = ldraws.image
    check(bool(im.do_flip.all() and im.do_rot.all() and im.do_scale.all())
          and not bool(ldraws.dropout.do_drop.any()), f"fixed draws: {im}")
    lnet = IntentNetViT(cfg.vit, cfg.heads, dtype=torch.bfloat16, param_dtype=torch.float32)
    lnet.load_state_dict(params)
    lnet.to(dev)
    _build.reset_launch_counts()
    m_k, g_k = loss_and_grads(False, lnet, acfg, lbatch, ldraws)
    legacy_counts = dict(_build.launches)
    check(legacy_counts == {k_: vit_per_step.get(k_, 0) for k_ in legacy_counts},
          f"image-space augmentation step: launch counts {legacy_counts} != {vit_per_step}")
    check(all(np.isfinite(val) for val in m_k.values()) and all(
        bool(torch.isfinite(t_).all()) for t_ in g_k.values()), f"non-finite step {m_k}")
    m_p, g_p = loss_and_grads(True, lnet, acfg, lbatch, ldraws)
    m_c, g_c = loss_and_grads(True, lnet, acfg, lbatch,
                              ldraws._replace(image=im._replace(angle_deg=-im.angle_deg)))
    del lnet
    sound_g, ctrl_g = grad_readings(g_k, g_p), grad_readings(g_c, g_p)
    loss_rel = abs(m_k["loss"] - m_p["loss"]) / abs(m_p["loss"])
    ctrl_loss = abs(m_c["loss"] - m_p["loss"]) / abs(m_p["loss"])
    said = (f"sound {sound_g[:2]} (worst {sound_g[2]}), loss {loss_rel:.3e}; control "
            f"{ctrl_g[:2]} (worst {ctrl_g[2]}), loss {ctrl_loss:.3e}; limits {grad_limit}, "
            f"{worst_limit}, {loss_limit}")
    check(sound_g[0] < grad_limit and sound_g[1] < worst_limit and loss_rel < loss_limit,
          f"image-space augmentation step: kernel vs plain reaches a limit: {said}")
    check(ctrl_g[0] >= grad_limit or ctrl_g[1] >= worst_limit or ctrl_loss >= loss_limit,
          f"image-space augmentation step: the control stays under the limits: {said}")
    print(f"last modules: train step without aug_params (image-space augmentation: flip, "
          f"5 degrees, x1.03), kernel vs plain: loss {m_k['loss']:.6f} vs {m_p['loss']:.6f} "
          f"(rel {loss_rel:.3e} < {loss_limit:g}); gradients relative L2 all "
          f"{sound_g[0]:.3e} < {grad_limit:g}, worst {sound_g[1]:.3e} ({sound_g[2]}) < "
          f"{worst_limit:g}; control (plain, theta with the wrong sign) all {ctrl_g[0]:.3e}, "
          f"worst {ctrl_g[1]:.3e}, loss {ctrl_loss:.3e} caught; launches {legacy_counts}",
          flush=True)
    del g_k, g_p, g_c, lbatch, ldraws
    torch.cuda.empty_cache()

    # bench_torch's CNN chunk line with INTENTBEV_CNN_FILL_LAYOUT=f32's fill
    _build.reset_launch_counts()
    fill_line = bench_torch.run_mode("bev_frames_per_sec_per_chip_cnn_chunks", "cnn", iters=2,
                                     voxembed=True, fill_dtype=torch.float32)
    check(np.isfinite(fill_line["value"]) and fill_line["value"] > 0
          and _build.launches["voxel_fill"] == 3, f"f32 fill line {fill_line}, "
          f"{_build.launches['voxel_fill']} voxel_fill launches")
    torch.cuda.empty_cache()

    out, secs = finish_twin(twins["score_range"])
    found = re.search(r"global score range over (\d+) attention calls: \[([+-][\d.]+), "
                      r"([+-][\d.]+)\]", out)
    check(found is not None and int(found[1]) == 2 * v.depth
          and max(abs(float(found[2])), abs(float(found[3]))) < 88.0, f"score_range: {out}")
    print(f"last modules: score_range_torch on phase 14's checkpoint and split ({secs:.1f} s): "
          f"{found[0]}; {out.strip().splitlines()[-1]}", flush=True)
    out, secs = finish_twin(twins["synth"])
    labelled = sorted(synth17.glob("*/*/annotations_with_intent.feather"))
    check(len(labelled) == 2 and "done in" in out, f"synthetic twin: {labelled} {out[-500:]}")
    print(f"last modules: the synthetic twin wrote 1 + 1 logs of 10 frames with labels in "
          f"{secs:.1f} s", flush=True)
    out, secs = finish_twin(twins["serve_chunks"])
    rates = {k_: float(re.search(rf"^{k_}: .*?([\d.]+) (?:samples|frames)/s", out, re.M)[1])
             for k_ in ("host chunk build", "device inference", "sustained pipeline")}
    check(all(np.isfinite(r_) and r_ > 0 for r_ in rates.values()), f"serve_chunks: {out}")
    print(f"last modules: serve_chunks_torch --batches 2 ({secs:.1f} s): host chunk build "
          f"{rates['host chunk build']:g} samples/s, device {rates['device inference']:g} "
          f"frames/s, sustained {rates['sustained pipeline']:g} frames/s [{card}]", flush=True)
    out, secs = finish_twin(twins["soak_loader"])
    soak = json.loads(out.strip().splitlines()[-1])
    check(soak["samples"] >= 200 and np.isfinite(soak["value"]) and soak["value"] > 0
          and 0 < soak["rss_start_mb"] <= soak["rss_peak_mb"], f"soak_loader: {soak}")
    print(f"last modules: soak_loader_torch on phase 14's split ({secs:.1f} s): "
          f"{soak['value']} samples/s over {soak['samples']} samples, RSS "
          f"{soak['rss_start_mb']} -> {soak['rss_peak_mb']} MB (4 threads) [{card}]", flush=True)
    tmp17.cleanup()
    tmp14.cleanup()  # phases 15 to 17 read phase 14's run and phase 15's inputs there
    print(f"last modules: phase 17 took {time.perf_counter() - t17:.1f} s", flush=True)

    serving_runs = (serve_counts, *config_counts.values())
    lifecycle_runs = (loop_counts, chunk_loop_counts, eval_counts)  # phase 14
    deploy_runs = (stream_counts, dp_step_counts, dp_eval_counts)  # phase 15
    tp_runs = tuple(t_[v_]["counts"] for t_ in tp for v_ in TP_VARIANTS)  # phase 16, both ranks
    # B's fused_ln_dense launches under TP: the 2 adapters (one-process shape) a
    # rank, the rest its qkv shard (Dout 576)
    tp_adapters = tuple({"fused_ln_dense": 2, "fused_ln_dense_bwd": 2} for _ in tp)
    tp_qkv = tuple({k_: t_["ln_dense"]["counts"][k_] - 2
                    for k_ in ("fused_ln_dense", "fused_ln_dense_bwd")} for t_ in tp)
    tiny_runs = (tiny_serve_counts, tiny_train_counts)
    kernels = []
    for name, src, replaces, runs in (
            ("voxel_embed", "voxel_embed.cu", "intentbev/ops/voxel_embed.py:417", serving_runs),
            ("flash_packed", "flash_packed.cu", "intentbev/ops/flash_packed.py:122",
             (*serving_runs, train_counts, train_b, train_c, form_counts["split"],
              form_counts["chunked"], *lifecycle_runs, *deploy_runs)),
            # the forward's fixed max (bench.py's serving form: the bench lines)
            # and chunked safe form (phase 11)
            ("flash_packed_fixed", "flash_packed.cu",
             "intentbev/ops/flash_packed.py:157 (safe=False)", (bench_counts,)),
            ("flash_packed_chunked", "flash_packed.cu",
             "intentbev/ops/flash_packed.py:157 (safe=True)",
             (chunked_serve_counts,)),
            ("fused_ln_mlp", "fused_ln_mlp.cu", "intentbev/ops/fused_ln_mlp.py:116",
             (*serving_runs, eval_counts, *deploy_runs)),
            ("layernorm", "layernorm.cu", "intentbev/ops/layernorm.py:39",
             (*serving_runs, eval_counts, *deploy_runs)),
            ("flash_packed_bwd", "flash_packed.cu", "intentbev/ops/flash_packed.py:523",
             (train_counts, train_b, train_c, *lifecycle_runs, *deploy_runs)),
            ("fused_ln_mlp_train", "fused_ln_mlp.cu", "intentbev/ops/fused_ln_mlp.py:135",
             (train_counts, *config_counts.values(), train_b, *lifecycle_runs, *deploy_runs)),
            ("fused_ln_mlp_bwd", "fused_ln_mlp.cu", "intentbev/ops/fused_ln_mlp.py:215",
             (train_counts, train_b, *lifecycle_runs, *deploy_runs)),
            ("layernorm_train", "layernorm.cu", "intentbev/ops/layernorm.py:53",
             (train_counts, train_b, *lifecycle_runs, *deploy_runs, *tp_runs)),
            ("layernorm_bwd", "layernorm.cu", "intentbev/ops/layernorm.py:66",
             (train_counts, train_b, *lifecycle_runs, *deploy_runs, *tp_runs)),
            ("voxel_fill", "voxel_fill.cu", "intentbev/ops/voxel_embed.py:507",
             (cnn_serve_counts, cnn_train_counts, vit_chunk_counts, chunk_loop_counts)),
            ("fused_mlp_int8", "fused_mlp_int8.cu", "intentbev/ops/fused_mlp_int8.py:42",
             serving_runs),
            ("fused_mlp", "fused_ln_mlp.cu", "intentbev/ops/fused_mlp.py:103", serving_runs),
            ("fused_ln_dense", "fused_ln_dense.cu", "intentbev/ops/fused_ln_dense.py:56",
             (*serving_runs, train_b, *tp_adapters)),
            ("patch_embed", "patch_embed.cu", "intentbev/ops/patch_embed.py:51",
             serving_runs),
            ("fused_mlp_train", "fused_ln_mlp.cu", "intentbev/ops/fused_mlp.py:103",
             (train_c,)),
            ("fused_mlp_bwd", "fused_ln_mlp.cu", "intentbev/ops/fused_mlp.py:148",
             (train_c,)),
            ("fused_ln_dense_bwd", "fused_ln_dense.cu", "intentbev/ops/fused_ln_dense.py:94",
             (train_b, *tp_adapters)),
            # row 16: ViT-Ti's 3 heads of 64, and a rank's under TP (phase 16)
            ("flash_attention", "flash_packed.cu", "intentbev/ops/flash_attention.py:66",
             (*tiny_runs, *tp_runs)),
            ("flash_attention_bwd", "flash_packed.cu",
             "intentbev/ops/flash_attention.py:128 (dq), :152 (dk/dv)", (*tiny_runs, *tp_runs)),
            # the shard shapes of tensor parallelism (phase 16, both ranks)
            ("fused_mlp_train[TP,hidden=768]", "fused_ln_mlp.cu",
             "intentbev/ops/fused_mlp.py:103", tp_runs),
            ("fused_mlp_bwd[TP,hidden=768]", "fused_ln_mlp.cu", "intentbev/ops/fused_mlp.py:148",
             tp_runs),
            ("fused_ln_dense[TP,Dout=576]", "fused_ln_dense.cu",
             "intentbev/ops/fused_ln_dense.py:56", tp_qkv),
            ("fused_ln_dense_bwd[TP,Dout=576]", "fused_ln_dense.cu",
             "intentbev/ops/fused_ln_dense.py:94", tp_qkv),
            # the D=192 instances the ViT-Ti path runs
            ("voxel_embed[D=192]", "voxel_embed.cu", "intentbev/ops/voxel_embed.py:417",
             tiny_runs),
            ("fused_ln_mlp[D=192]", "fused_ln_mlp.cu", "intentbev/ops/fused_ln_mlp.py:116",
             tiny_runs),
            ("layernorm[D=192]", "layernorm.cu", "intentbev/ops/layernorm.py:39", tiny_runs),
            ("fused_ln_mlp_train[D=192]", "fused_ln_mlp.cu",
             "intentbev/ops/fused_ln_mlp.py:135", tiny_runs),
            ("fused_ln_mlp_bwd[D=192]", "fused_ln_mlp.cu", "intentbev/ops/fused_ln_mlp.py:215",
             tiny_runs),
            ("layernorm_train[D=192]", "layernorm.cu", "intentbev/ops/layernorm.py:53",
             tiny_runs),
            ("layernorm_bwd[D=192]", "layernorm.cu", "intentbev/ops/layernorm.py:66",
             tiny_runs),
            ("fused_ln_dense[D=192]", "fused_ln_dense.cu", "intentbev/ops/fused_ln_dense.py:56",
             (tiny_b_serve_counts, tiny_b_train_counts)),
            ("fused_ln_dense_bwd[D=192]", "fused_ln_dense.cu",
             "intentbev/ops/fused_ln_dense.py:94", (tiny_b_train_counts,)),
            ("fused_mlp_int8[D=192]", "fused_mlp_int8.cu", "intentbev/ops/fused_mlp_int8.py:42",
             (tiny_a_serve_counts,)),
            ("patch_embed[D=192]", "patch_embed.cu", "intentbev/ops/patch_embed.py:51",
             (tiny_d_serve_counts,)),
            ("fused_mlp[D=192]", "fused_ln_mlp.cu", "intentbev/ops/fused_mlp.py:103",
             (tiny_c_serve_counts,)),
            ("fused_mlp_train[D=192]", "fused_ln_mlp.cu", "intentbev/ops/fused_mlp.py:103",
             (tiny_c_train_counts,)),
            ("fused_mlp_bwd[D=192]", "fused_ln_mlp.cu", "intentbev/ops/fused_mlp.py:148",
             (tiny_c_train_counts,)),
            # row 11, and the packed path at head dim 32 (phase 11)
            ("flash_packed_bwd_split", "flash_packed.cu",
             "intentbev/ops/flash_packed.py:350 (dq), :377 (dk/dv)", (form_counts["split"],)),
            ("flash_packed_bwd_chunked", "flash_packed.cu",
             "intentbev/ops/flash_packed.py:414 (dq), :467 (dk/dv)", (form_counts["chunked"],)),
            ("flash_packed[D=32]", "flash_packed.cu", "intentbev/ops/flash_packed.py:122",
             tuple(form_counts[f"{f}[D=32]"] for f in forms)),
            ("flash_packed_bwd[D=32]", "flash_packed.cu", "intentbev/ops/flash_packed.py:523",
             (form_counts["fused[D=32]"],)),
            ("flash_packed_bwd_split[D=32]", "flash_packed.cu",
             "intentbev/ops/flash_packed.py:350 (dq), :377 (dk/dv)",
             (form_counts["split[D=32]"],)),
            ("flash_packed_bwd_chunked[D=32]", "flash_packed.cu",
             "intentbev/ops/flash_packed.py:414 (dq), :467 (dk/dv)",
             (form_counts["chunked[D=32]"],)),
            # rows 18 and 19, the library ops of ops.experimental (phase 13)
            ("flash_int8", "flash_int8.cu", "intentbev/ops/experimental/flash_int8.py:49",
             (exp_counts["flash_int8"],)),
            ("flash_int8[D=32]", "flash_int8.cu", "intentbev/ops/experimental/flash_int8.py:49",
             (exp_counts["flash_int8[D=32]"],)),
            ("flash_int8[D=16]", "flash_int8.cu", "intentbev/ops/experimental/flash_int8.py:49",
             (exp_counts["flash_int8[D=16]"],)),
            ("flash_int8[D=128]", "flash_int8.cu", "intentbev/ops/experimental/flash_int8.py:49",
             (exp_counts["flash_int8[D=128]"],)),
            ("flash_int8[f32]", "flash_int8.cu", "intentbev/ops/experimental/flash_int8.py:49",
             (exp_counts["flash_int8[f32]"],)),
            ("fused_proj", "fused_proj.cu", "intentbev/ops/experimental/fused_proj.py:32",
             (exp_counts["fused_proj"],)),
            ("fused_proj_bwd", "fused_proj.cu", "intentbev/ops/experimental/fused_proj.py:40",
             (exp_counts["fused_proj_bwd"],))):
        r = record[name]
        counter = name.split("[")[0]
        kernels.append({"name": name, "route": "cuda", "source": f"intentbev_torch/csrc/{src}",
                        "replaces": replaces, "launches": sum(c[counter] for c in runs),
                        **r})
    check(len(kernels) == 52 and all(k_["launches"] > 0 for k_ in kernels),
          f"a kernel of the paths never launched: {[(k_['name'], k_['launches']) for k_ in kernels]}")
    print(f"smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-child"]:
        dp_child(Path(sys.argv[2]), sys.argv[3], sys.argv[4])
    elif sys.argv[1:2] == ["--tp-child"]:
        tp_child(Path(sys.argv[2]), sys.argv[3], int(sys.argv[4]), int(sys.argv[5]))
    else:
        main()
