"""Card checks of the kernels on ViT-B's paths (D=768, 12 heads of 64):
serving, the serving variants A-D and the training step.

1. The compiler's report: each kernel source of the paths compiled with
   ``-Xptxas -v``; for the D=768 instances (rows 4 and 6, the
   ``ln_mlp_wide_kernel`` with each GELU, chained and gated, and row 13,
   the same kernel without its LN; row 7's two row kernels,
   ``ln_mlp_dh_kernel<768>`` and ``ln_mlp_bwd_wide_kernel<768, *>``, the
   latter also without its LN for row 13's backward; row 1's
   ``voxel_gather_kernel<768>``; rows 5, 8 and 9, ``layernorm_kernel<768>``,
   ``layernorm_train_kernel<768>`` and ``layernorm_bwd_kernel<768>``; row
   14's ``ln_dense_fwd_kernel<768, *>`` and ``ln_dense_bwd_wide_kernel<768,
   *>``, row 15's ``patch_embed_kernel<768>``
   and row 17's ``mlp_int8_fwd_kernel<768, *>``) the registers, the spill
   stores and loads,
   and any ptxas line of code C75xx that names them. A spill or a C7514 /
   C7520 warning (wgmma serialised) fails the run; other C75xx lines are
   printed (C7519: a warpgroup.arrive injected before a wgmma that reads
   registers, a note the narrow backwards carry too).
2. Each kernel against its plain version at the shapes ViT-B's paths give
   it (batch 8 x 4501 tokens = 36008 rows, hidden 3072; the chunks of 8
   frames of 16384 points, ``serving_batch`` seed 0; a per-sample drop-path
   gate with sample 0 dropped), in bf16: the relative L2 and the share of
   elements that differ, under the limits of ``chip_smoke.py`` phase 3, and
   a control with one fault that must reach a limit (rows 4 and 6: the
   other GELU or the gate ignored, h kept in f32 before fc2; row 7: the gate
   ignored, dg kept in f32 before dxn; rows 5 and 8: the variance over N-1;
   row 9: no mean(dyg*xhat) term; row 1: the last chunk of each band
   skipped; rows 2 and 3 at [8, 4501, 768] in 12 heads of 64: another
   softmax form's plain version; rows 10 and 11, the fused, split and
   chunked backwards: delta left out; row 13: h kept in f32 before fc2;
   row 14, qkv (Dout 2304) and the adapter (Dout 192) with each GELU: xn
   kept in f32 before the product; row 15 on the bench's dense BEV [8, 400,
   720, 290]: the sum rounded to bf16 before the bias; row 17 with each
   GELU: one h scale per 32-row block; the training variants' backwards,
   row 13 gated: the gate ignored, dg kept in f32 before dh = dg W1, dh's
   share under a limit of its own; row 14 for qkv: no mean(dyg*xhat) term,
   dxn rounded before the LN backward, and for the adapter with the erf
   GELU: GELU' skipped, dg kept in f32). Then CUDA-event times of kernel,
   plain version, the library call where one exists (``F.layer_norm`` and
   its backward, SDPA and its backward, ``F.conv2d``) and, for rows 4, 6,
   7, 13, 14 and 15, the same function as a chain of PyTorch calls in bf16
   (the backwards of rows 7, 13 and 14: autograd through that chain; row
   15: ``PatchEmbed.dense``),
   beside each bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s
   bf16, 1979 TOP/s int8).

    python3 tools/vit_base_checks_torch.py [--no-times]

It builds into ``intentbev_torch/_build/checks`` and imports no JAX. A
failed check exits nonzero.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "intentbev_torch" / "csrc"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xptxas", "-v")
# source -> the mangled-name pieces of its D=768 instances
INSTANCES = {"fused_ln_mlp.cu": ("ln_mlp_wide_kernelILi768ELi0ELb1ELb1E",
                                 "ln_mlp_wide_kernelILi768ELi1ELb1ELb1E",
                                 "ln_mlp_wide_kernelILi768ELi0ELb1ELb0E",
                                 "ln_mlp_wide_kernelILi768ELi1ELb1ELb0E",
                                 "ln_mlp_wide_kernelILi768ELi0ELb0ELb0E",
                                 "ln_mlp_wide_kernelILi768ELi1ELb0ELb0E",
                                 "ln_mlp_dh_kernelILi768E", "ln_mlp_bwd_wide_kernelILi768ELb1E",
                                 "ln_mlp_bwd_wide_kernelILi768ELb0E"),
             "fused_ln_dense.cu": ("ln_dense_fwd_kernelILi768E",
                                   "ln_dense_bwd_wide_kernelILi768ELb0E",
                                   "ln_dense_bwd_wide_kernelILi768ELb1E"),
             "patch_embed.cu": ("patch_embed_kernelILi768E",),
             "fused_mlp_int8.cu": ("mlp_int8_fwd_kernelILi768E",),
             "voxel_embed.cu": ("voxel_gather_kernelILi768E",),
             "layernorm.cu": ("layernorm_kernelILi768E", "layernorm_train_kernelILi768E",
                              "layernorm_bwd_kernelILi768E")}
HBM_BYTES_PER_S, BF16_FLOPS_PER_S, INT8_OPS_PER_S = 3.35e12, 989e12, 1979e12


def ptxas_report(nvcc: str, out: Path) -> list[str]:
    """Compile each source with -Xptxas -v; returns the problems found."""
    procs = {src: subprocess.Popen([nvcc, *FLAGS, "-c", "-o", str(out / f"{src}.o"),
                                    str(CSRC / src)], stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for src in INSTANCES}
    problems = []
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc {src} failed:\n{log}")
        for part in log.split("Compiling entry function '")[1:]:
            name = part.split("'", 1)[0]
            if not any(k in name for k in INSTANCES[src]):
                continue
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
            stores, loads = (int(spill[1]), int(spill[2])) if spill else (-1, -1)
            print(json.dumps({"source": src, "function": name,
                              "registers": int(regs[1]) if regs else None,
                              "spill_stores": stores, "spill_loads": loads}), flush=True)
            if stores or loads:
                problems.append(f"{name}: spills {stores} / {loads} bytes")
        for line in log.splitlines():
            if re.search(r"C75\d\d", line) and any(k in line for k in INSTANCES[src]):
                print(f"ptxas: {line.strip()}", flush=True)
                # C7514 / C7520: wgmma serialised; other C75xx lines are
                # notes (C7519, a warpgroup.arrive injected before a wgmma
                # that reads registers, which the narrow backwards carry too)
                if re.search(r"C7514|C7520", line):
                    problems.append(line.strip())
        found = [k for k in INSTANCES[src] if k in log]
        if len(found) != len(INSTANCES[src]):
            problems.append(f"{src}: instances {INSTANCES[src]} not all compiled ({found})")
    return problems


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-times", action="store_true", help="only the compiler's report and checks")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("vit_base_checks_torch: needs a CUDA card")
    from intentbev_torch.configs import default_vit_config
    from intentbev_torch.ops import (flash_attention_packed, flash_attention_packed_bwd,
                                     flash_attention_packed_bwd_plain,
                                     flash_attention_packed_plain, fused_ln_dense,
                                     fused_ln_dense_bwd, fused_ln_dense_bwd_plain,
                                     fused_ln_dense_plain, fused_ln_mlp, fused_ln_mlp_bwd,
                                     fused_ln_mlp_bwd_plain, fused_ln_mlp_plain,
                                     fused_ln_mlp_train, fused_ln_mlp_train_plain, fused_mlp,
                                     fused_mlp_bwd, fused_mlp_bwd_plain, fused_mlp_int8,
                                     fused_mlp_int8_plain, fused_mlp_plain,
                                     layernorm, layernorm_bwd, layernorm_bwd_plain,
                                     layernorm_plain, layernorm_train, layernorm_train_plain,
                                     patch_embed, patch_embed_plain, quantize_linear,
                                     voxel_embed_tokens, voxel_embed_tokens_plain)
    from intentbev_torch.ops.int8 import int_matmul, quantize_rows
    from intentbev_torch.ops._build import BUILD_DIR, _nvcc
    from intentbev_torch.ops.fused_ln_mlp import gelu, gelu_erf_grad
    from intentbev_torch.ops.voxel_embed import chunks_to_device, decode_chunk_transport
    from intentbev_torch.parallel.inference import build_chunk_transport
    from intentbev_torch.synthetic import serving_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    out = BUILD_DIR / "checks"
    out.mkdir(parents=True, exist_ok=True)
    problems = ptxas_report(_nvcc(), out)

    cfg = default_vit_config()
    g, v = cfg.grid, cfg.vit
    batch, d, heads = 8, 768, 12
    hidden, tokens = 4 * d, 1 + v.num_patches
    rows = batch * tokens
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, std, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def rel_l2(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    def share(a, b):
        return float((a != b).float().mean())

    def cuda_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def h_f32(x_, ln_, w1_, b1_, w2_, b2_, mode):  # the control's fault: h kept in f32
        xn = layernorm_plain(x_.float(), *ln_[:2]).to(x_.dtype).float()
        y_ = gelu(xn @ w1_.float().t() + b1_, mode) @ w2_.float().t() + b2_ + x_.float()
        return y_.to(x_.dtype), layernorm_plain(y_, *ln_[2:]).to(x_.dtype)

    def unbiased(x_, g_, b_):  # the control's fault: the variance over N-1
        xf = x_.float()
        inv = torch.rsqrt(xf.var(-1, keepdim=True, correction=1) + 1e-6)
        return ((xf - xf.mean(-1, keepdim=True)) * inv * g_ + b_).to(x_.dtype)

    def _sig(h):  # the serving GELU, x * sigmoid(1.702 x)
        return h * torch.sigmoid(1.702 * h)

    def twice(r):  # each output by relative L2, then by its share of differing elements
        r = r if isinstance(r, tuple) else (r,)
        return r + r

    def o_twice(r):  # a flash forward's o by both metrics
        return r[0], r[0]

    x = randn((rows, d), 1.0)
    ln = [randn((d,), 0.2, torch.float32) + (1 - i % 2) for i in range(4)]
    w1, b1 = randn((hidden, d), d ** -0.5), randn((hidden,), 0.1, torch.float32)
    w2, b2 = randn((d, hidden), hidden ** -0.5), randn((d,), 0.1, torch.float32)
    mlp = (x, *ln[:2], w1, b1, w2, b2, *ln[2:])
    qkv = randn((batch, tokens, 3 * d), 1.0)
    q, k, vv = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    pts, valid, _ = serving_batch(g, batch, 16384, seed=0)
    chunks = decode_chunk_transport(chunks_to_device(
        build_chunk_transport(pts, valid, g, v.patch_size, 512), dev))
    w_pe = randn((v.patch_size, v.patch_size, v.lidar_input_channels, d), 0.02)
    b_pe = randn((d,), 0.02, torch.float32)
    hw = tuple(v.img_size)
    skipped = chunks._replace(count=(chunks.count - 1).clamp(min=0))
    used = torch.arange(chunks.wid.shape[-1], device=dev) < chunks.count[..., None]
    cells = int(((chunks.val != 0) & used[..., None, None]).sum())
    gl, bl = ln[0].bfloat16(), ln[1].bfloat16()
    bhtd = [t.reshape(batch, tokens, heads, 64).transpose(1, 2).contiguous() for t in (q, k, vv)]
    flash_bytes = nbytes(q, k, vv) + rows * d * 2 + batch * heads * tokens * 4
    flash_flops = 4 * batch * tokens * tokens * d
    MLP_LIMITS, FWD_LIMITS = (1e-3, 1e-3, 2e-2, 2e-2), (1e-3, 2e-2)

    def chain():  # row 4 as a chain of PyTorch calls in bf16 (timed only)
        xn = F.layer_norm(x, (d,), gl, bl, 1e-6)
        h = F.linear(xn, w1, b1.bfloat16())
        y_ = x + F.linear(h * torch.sigmoid(1.702 * h), w2, b2.bfloat16())
        return y_, F.layer_norm(y_, (d,), ln[2].bfloat16(), ln[3].bfloat16(), 1e-6)

    # the training step's inputs: a per-sample drop-path gate (0 or 1/0.9,
    # sample 0 dropped) over the tokens, upstream gradients, the saved LN
    # forward, the attention's o and lse
    keep = torch.rand(batch, generator=gen, device=dev) < 0.7
    keep[0] = False
    gate = (keep.float() / 0.9)[:, None].expand(batch, tokens).reshape(rows).contiguous()
    dy = randn((rows, d), 1.0)
    train = (x, ln[0], ln[1], w1, b1, w2)
    _, xhat, inv = layernorm_train_plain(x, ln[0], ln[1])
    o, lse = flash_attention_packed(q, k, vv, heads)
    do = randn((batch, tokens, d), 1.0)
    mlp_flops = 4 * rows * d * hidden

    def unbiased_train(x_, g_, b_):  # the control's fault: the variance over N-1
        xf = x_.float()
        inv_ = torch.rsqrt(xf.var(-1, keepdim=True, correction=1) + 1e-6)
        xh = (xf - xf.mean(-1, keepdim=True)) * inv_
        return (xh * g_ + b_).to(x_.dtype), xh.to(x_.dtype), inv_[..., 0]

    def no_m2(dy_, xhat_, inv_, g_):  # the control's fault: no mean(dyg*xhat) term
        dyg = dy_.float() * g_
        dx_ = inv_[..., None] * (dyg - dyg.mean(-1, keepdim=True))
        return dx_.to(dy_.dtype), (dy_.float() * xhat_.float()).sum(0), dy_.float().sum(0)

    def train_h_f32():  # the control's fault: h kept in f32 before fc2 (gated)
        xn = layernorm_plain(x.float(), *ln[:2]).to(x.dtype).float()
        m = gelu(xn @ w1.float().t() + b1, "erf") @ w2.float().t() + b2
        return (m * gate[:, None] + x.float()).to(x.dtype)

    def dg_f32():  # the control's fault: dg kept in f32 before the dxn product
        xf, dyf = x.float(), dy.float()
        xc = xf - xf.mean(-1, keepdim=True)
        inv_ = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-6)
        xh = xc * inv_
        xn = (xh * ln[0] + ln[1]).to(x.dtype).float()
        dg = ((dyf * gate[:, None]).to(x.dtype).float() @ w2.float()) * gelu_erf_grad(
            xn @ w1.float().t() + b1)
        dyg = (dg @ w1.float()) * ln[0]
        dx_ = inv_ * (dyg - dyg.mean(-1, keepdim=True)
                      - xh * (dyg * xh).mean(-1, keepdim=True)) + dyf
        rest = fused_ln_mlp_bwd_plain(*train, gate, dy)[1:]
        return (dx_.to(x.dtype),) * 2 + tuple(rest)

    def dx_twice(r):  # a backward's dx by relative L2 and share, the rest by relative L2
        return (r[0],) + tuple(r)

    def parts(t):  # a packed gradient [B, T, 3 * d] as dq, dk, dv
        return tuple(t[..., i * d:(i + 1) * d] for i in range(3))

    forms = {"fused": (True, 0), "split": (False, 0), "chunked": (False, 1152)}

    def flash_bwd(fn, form, o_=None):
        return lambda: parts(fn(q, k, vv, o if o_ is None else o_, lse, do, heads, None,
                                *forms[form]))

    # library calls of the backwards (autograd through F.layer_norm and SDPA)
    xl = x.detach().clone().requires_grad_(True)
    gll, bll = (t.detach().clone().requires_grad_(True) for t in (gl, bl))
    y_ln = F.layer_norm(xl, (d,), gll, bll, 1e-6)
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in bhtd)
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs)
    do_h = do.reshape(batch, tokens, heads, 64).transpose(1, 2).contiguous()

    def lib_ln_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(y_ln, (xl, gll, bll), dy, retain_graph=True)

    def lib_sdpa_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(o_sdpa, (qs, ks, vs), do_h, retain_graph=True)

    def train_chain():  # row 6 as a chain of PyTorch calls in bf16 (timed only)
        xn = F.layer_norm(x, (d,), gl, bl, 1e-6)
        return x + F.linear(F.gelu(F.linear(xn, w1, b1.bfloat16())), w2,
                            b2.bfloat16()) * gate.bfloat16()[:, None]

    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, gl, bl, w1, b1.bfloat16(), w2, b2.bfloat16())]
    with torch.enable_grad():
        xn_c = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-6)
        y_c = leaves[0] + F.linear(F.gelu(F.linear(xn_c, leaves[3], leaves[4])), leaves[5],
                                   leaves[6]) * gate.bfloat16()[:, None]

    def bwd_chain():  # row 7: autograd through that chain (timed only)
        with torch.enable_grad():
            return torch.autograd.grad(y_c, leaves, dy, retain_graph=True)

    bwd_bytes = (3 * nbytes(x) + nbytes(w1, b1, w2, ln[0], ln[1], gate)
                 + 4 * (3 * d + hidden + 2 * d * hidden))

    # the serving variants' rows: 13 (C), 14 (B: qkv and the adapter), 15
    # (D, on the bench's dense BEV) and 17 (A: rows of varied scale, the
    # codes of f32 weights)
    x8 = (torch.randn(rows, d, generator=gen, device=dev)
          * torch.exp(0.5 * torch.randn(rows, 1, generator=gen, device=dev))).bfloat16()
    w1q, s1 = quantize_linear(w1.float())
    w2q, s2 = quantize_linear(w2.float())
    int8_args = (x8, w1q, s1, b1, w2q, s2, b2, x)
    w_qkv, b_qkv = randn((3 * d, d), d ** -0.5), randn((3 * d,), 0.1, torch.float32)
    a_out = v.adapter_out_channels
    x_ad = randn((batch * v.num_patches, d), 1.0)
    w_ad, b_ad = randn((a_out, d), d ** -0.5), randn((a_out,), 0.1, torch.float32)
    x_pe = randn((batch, g.height_px, g.width_px, v.lidar_input_channels), 1.0)
    w_conv = w_pe.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    pe_flops = 2 * batch * v.num_patches * v.patch_size ** 2 * v.lidar_input_channels * d

    def mlp_h_f32():  # the control's fault: h kept in f32 before fc2 (no LN)
        y_ = gelu(x8.float() @ w1.float().t() + b1, "sigmoid") @ w2.float().t() + b2
        return (y_ + x.float()).to(x.dtype)

    def xn_f32(x_, w_, b_, mode):  # the control's fault: xn kept in f32 before the product
        y_ = layernorm_plain(x_.float(), ln[0], ln[1]) @ w_.float().t() + b_
        return (gelu(y_, mode) if mode else y_).to(x_.dtype)

    def ln_dense_chain(x_, w_, b_, mode):  # row 14 as a chain of PyTorch calls (timed only)
        y_ = F.linear(F.layer_norm(x_, (d,), gl, bl, 1e-6), w_, b_.bfloat16())
        return (F.gelu(y_) if mode == "erf" else y_ * torch.sigmoid(1.702 * y_)) if mode else y_

    def pe_rounded():  # the control's fault: the f32 sum rounded to bf16 before the bias
        return (patch_embed_plain(x_pe, w_pe, torch.zeros_like(b_pe), v.patch_size).float()
                + b_pe).bfloat16()

    def pe_dense_chain():  # row 15 as PatchEmbed.dense: a permute copy, one matmul
        p_ = v.patch_size
        xp = x_pe.reshape(batch, g.height_px // p_, p_, g.width_px // p_, p_, -1)
        xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(batch, v.num_patches, -1)
        return torch.matmul(xp, w_pe.reshape(-1, d)) + b_pe.bfloat16()

    def int8_block_scale(mode):  # the control's fault: one h scale per 32-row block
        xq, xs = quantize_rows(x8)
        h = gelu(int_matmul(xq, w1q.t()) * xs * s1 + b1, mode)
        amax = F.pad(h.abs().amax(-1), (0, -rows % 32)).reshape(-1, 32).amax(-1)
        hs = amax.repeat_interleave(32)[:rows, None].clamp(min=1e-8) / 127.0
        hq = torch.clamp(torch.round(h / hs), -127, 127)
        return (int_matmul(hq, w2q.t()) * hs * s2 + b2 + x.float()).to(x.dtype)

    def ln_dense_case(x_, w_, b_, mode, ref):
        n_ = x_.shape[0] * w_.shape[0]
        return (lambda: twice(fused_ln_dense(x_, ln[0], ln[1], w_, b_, gelu_mode=mode)),
                lambda: twice(fused_ln_dense_plain(x_, ln[0], ln[1], w_, b_, gelu_mode=mode)),
                [(lambda: twice(xn_f32(x_, w_, b_, mode)), "xn kept in f32")],
                (rel_l2, share), (1e-3, 2e-2),
                nbytes(x_, ln[0], ln[1], w_, b_) + n_ * 2, 2 * n_ * d, None,
                torch.no_grad()(lambda: ln_dense_chain(x_, w_, b_, mode)) if ref else None)
    flash_bwd_bytes = nbytes(q, k, vv, o, do, lse) + nbytes(qkv)

    # the training variants' backwards: row 13 (C; on x8, gated) and row 14
    # (B; qkv on x and the adapter on x_ad), each as the smoke holds it
    dy_qkv, dy_ad = randn((rows, 3 * d), 1.0), randn((x_ad.shape[0], a_out), 1.0)

    def mlp_dg_f32():  # the control's fault: dg kept in f32 before dh = dg W1
        dg = ((dy.float() * gate[:, None]).to(x.dtype).float() @ w2.float()) * gelu_erf_grad(
            x8.float() @ w1.float().t() + b1)
        return dx_twice(((dg @ w1.float()).to(x.dtype),)
                        + tuple(fused_mlp_bwd_plain(x8, w1, b1, w2, gate, dy)[1:]))

    def dense_no_m2():  # the control's fault (qkv): the LN backward without its m2 term
        dxn = dy_qkv.float() @ w_qkv.float()
        return dx_twice((no_m2(dxn, xhat, inv, ln[0])[0],) + tuple(
            fused_ln_dense_bwd_plain(x, ln[0], ln[1], w_qkv, b_qkv, dy_qkv)[1:]))

    def dense_dx_moved(x_, w_, b_, dy_, mode):
        # the control's fault for dx's share: with the GELU dg kept in f32
        # before dxn, without it dxn rounded to bf16 before the LN backward
        xf = x_.float()
        xc = xf - xf.mean(-1, keepdim=True)
        inv_ = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-6)
        xh = xc * inv_
        dg = dy_.float()
        if mode:
            xn = (xh * ln[0] + ln[1]).to(x_.dtype).float()
            dg = dg * gelu_erf_grad(xn @ w_.float().t() + b_)
        dxn = dg @ w_.float()
        if not mode:
            dxn = dxn.to(x_.dtype).float()
        dyg = dxn * ln[0]
        dx_ = inv_ * (dyg - dyg.mean(-1, keepdim=True) - xh * (dyg * xh).mean(-1, keepdim=True))
        return dx_twice((dx_.to(x_.dtype),) + tuple(
            fused_ln_dense_bwd_plain(x_, ln[0], ln[1], w_, b_, dy_, gelu_mode=mode)[1:]))

    def dense_no_gelu_grad():  # the control's fault (adapter): GELU' taken as 1
        mod = importlib.import_module("intentbev_torch.ops.fused_ln_dense")
        sound = mod.gelu_erf_grad
        mod.gelu_erf_grad = torch.ones_like
        try:
            return dx_twice(fused_ln_dense_bwd_plain(x_ad, ln[0], ln[1], w_ad, b_ad, dy_ad,
                                                     gelu_mode="erf"))
        finally:
            mod.gelu_erf_grad = sound

    def autograd_chain(leaf_ts, fn, dy_):  # a backward's reference: autograd through fn
        leaves_ = [t.detach().clone().requires_grad_(True) for t in leaf_ts]
        with torch.enable_grad():
            out_ = fn(*leaves_)

        def run():
            with torch.enable_grad():
                return torch.autograd.grad(out_, leaves_, dy_, retain_graph=True)
        return run

    mlp_chain_bwd = autograd_chain(
        (x8, w1, b1.bfloat16(), w2, b2.bfloat16()),
        lambda h_, w1_, b1_, w2_, b2_: F.linear(F.gelu(F.linear(h_, w1_, b1_)), w2_, b2_)
        * gate.bfloat16()[:, None], dy)

    def dense_chain_bwd(x_, w_, b_, dy_, mode):
        return autograd_chain(
            (x_, gl, bl, w_, b_.bfloat16()),
            lambda x2, g2, b2_, w2_, bb: (lambda y_: F.gelu(y_) if mode else y_)(
                F.linear(F.layer_norm(x2, (d,), g2, b2_, 1e-6), w2_, bb)), dy_)
    cases = {  # name: (kernel, plain, [(control, fault)], metrics, limits, bytes, flops, library, reference)
        "fused_ln_mlp[D=768]": (
            lambda: twice(fused_ln_mlp(*mlp, gelu_mode="sigmoid")),
            lambda: twice(fused_ln_mlp_plain(*mlp, gelu_mode="sigmoid")),
            [(lambda: twice(fused_ln_mlp_plain(*mlp, gelu_mode="erf")), "erf GELU"),
             (lambda: twice(h_f32(x, ln, w1, b1, w2, b2, "sigmoid")), "h kept in f32")],
            (rel_l2, rel_l2, share, share), MLP_LIMITS,
            nbytes(x, w1, b1, w2, b2, *ln) + 2 * nbytes(x), 4 * rows * d * hidden, None, chain),
        "fused_ln_mlp[erf,D=768]": (
            lambda: twice(fused_ln_mlp(*mlp, gelu_mode="erf")),
            lambda: twice(fused_ln_mlp_plain(*mlp, gelu_mode="erf")),
            [(lambda: twice(fused_ln_mlp_plain(*mlp, gelu_mode="sigmoid")), "sigmoid GELU"),
             (lambda: twice(h_f32(x, ln, w1, b1, w2, b2, "erf")), "h kept in f32")],
            (rel_l2, rel_l2, share, share), MLP_LIMITS,
            nbytes(x, w1, b1, w2, b2, *ln) + 2 * nbytes(x), 4 * rows * d * hidden, None, None),
        "layernorm[D=768]": (
            lambda: (layernorm(x, ln[0], ln[1]),), lambda: (layernorm_plain(x, ln[0], ln[1]),),
            [(lambda: (unbiased(x, ln[0], ln[1]),), "variance over N-1")], (rel_l2,), (3e-4,),
            2 * nbytes(x) + nbytes(ln[0], ln[1]), 0,
            torch.no_grad()(lambda: F.layer_norm(x, (d,), gl, bl, 1e-6)), None),
        "voxel_embed[D=768]": (
            lambda: twice(voxel_embed_tokens(chunks, w_pe, b_pe, v.patch_size, hw)),
            lambda: twice(voxel_embed_tokens_plain(chunks, w_pe, b_pe, v.patch_size, hw)),
            [(lambda: twice(voxel_embed_tokens_plain(skipped, w_pe, b_pe, v.patch_size, hw)),
              "last chunk of each band skipped")], (rel_l2, share), (3e-3, 2e-2),
            nbytes(*chunks, w_pe, b_pe) + batch * v.num_patches * d * 2, 2 * cells * d, None,
            None),
        "flash_packed[12x64]": (
            lambda: o_twice(flash_attention_packed(q, k, vv, heads)),
            lambda: o_twice(flash_attention_packed_plain(q, k, vv, heads)),
            [(lambda: o_twice(flash_attention_packed_plain(q, k, vv, heads, None, 0, True)),
              "P rounded against the fixed max")], (rel_l2, share), FWD_LIMITS, flash_bytes,
            flash_flops, torch.no_grad()(lambda: F.scaled_dot_product_attention(*bhtd)), None),
        "flash_packed_fixed[12x64]": (
            lambda: o_twice(flash_attention_packed(q, k, vv, heads, None, 1152, True)),
            lambda: o_twice(flash_attention_packed_plain(q, k, vv, heads, None, 1152, True)),
            [(lambda: o_twice(flash_attention_packed_plain(q, k, vv, heads)),
              "P rounded against the row max")], (rel_l2, share), FWD_LIMITS, flash_bytes,
            flash_flops, torch.no_grad()(lambda: F.scaled_dot_product_attention(*bhtd)), None),
        # the training step's rows at ViT-B's shapes
        "layernorm_train[D=768]": (
            lambda: layernorm_train(x, ln[0], ln[1]),
            lambda: layernorm_train_plain(x, ln[0], ln[1]),
            [(lambda: unbiased_train(x, ln[0], ln[1]), "variance over N-1")], (rel_l2,) * 3,
            (3e-4, 3e-4, 1e-5), 3 * nbytes(x) + nbytes(inv, ln[0], ln[1]), 0,
            torch.no_grad()(lambda: F.layer_norm(x, (d,), gl, bl, 1e-6)), None),
        "layernorm_bwd[D=768]": (
            lambda: dx_twice(layernorm_bwd(dy, xhat, inv, ln[0])),
            lambda: dx_twice(layernorm_bwd_plain(dy, xhat, inv, ln[0])),
            [(lambda: dx_twice(no_m2(dy, xhat, inv, ln[0])), "no mean(dyg*xhat) term")],
            (rel_l2, share, rel_l2, rel_l2), (1e-3, 2e-2, 1e-3, 1e-3),
            3 * nbytes(x) + nbytes(inv, ln[0]) + 2 * d * 4, 0, lib_ln_bwd, None),
        "fused_ln_mlp_train[D=768]": (
            lambda: twice(fused_ln_mlp_train(*train, b2, gate)),
            lambda: twice(fused_ln_mlp_train_plain(*train, b2, gate)),
            [(lambda: twice(fused_ln_mlp_train_plain(*train, b2)), "gate ignored"),
             (lambda: twice(train_h_f32()), "h kept in f32")], (rel_l2, share), (1e-3, 2e-2),
            nbytes(x, w1, b1, w2, b2, ln[0], ln[1], gate) + nbytes(x), mlp_flops, None,
            train_chain),
        "fused_ln_mlp_bwd[D=768]": (
            lambda: dx_twice(fused_ln_mlp_bwd(*train, gate, dy)),
            lambda: dx_twice(fused_ln_mlp_bwd_plain(*train, gate, dy)),
            [(lambda: dx_twice(fused_ln_mlp_bwd_plain(*train, None, dy)), "gate ignored"),
             (dg_f32, "dg kept in f32")], (rel_l2, share) + (rel_l2,) * 6,
            (2e-3, 2e-2) + (2e-3,) * 6, bwd_bytes, 5 * mlp_flops // 2, None, bwd_chain),
        **{f"flash_packed_bwd{'' if f == 'fused' else '_' + f}[12x64,D=768]": (
            flash_bwd(flash_attention_packed_bwd, f),
            flash_bwd(flash_attention_packed_bwd_plain, f),
            [(flash_bwd(flash_attention_packed_bwd_plain, f, torch.zeros_like(o)),
              "delta = rowsum(dO*O) left out")], (rel_l2,) * 3, (1e-2,) * 3 if f == "fused"
            else (7e-4,) * 3, flash_bwd_bytes, 5 * flash_flops // 2, lib_sdpa_bwd, None)
           for f in forms},
        # the serving variants' rows
        "fused_mlp[D=768]": (
            lambda: twice(fused_mlp(x8, w1, b1, w2, b2, x, gelu_mode="sigmoid")),
            lambda: twice(fused_mlp_plain(x8, w1, b1, w2, b2, x, gelu_mode="sigmoid")),
            [(lambda: twice(mlp_h_f32()), "h kept in f32")], (rel_l2, share), (1e-3, 2e-2),
            nbytes(x8, w1, b1, w2, b2, x) + nbytes(x), mlp_flops, None,
            lambda: x + F.linear(_sig(F.linear(x8, w1, b1.bfloat16())), w2, b2.bfloat16())),
        "fused_ln_dense[D=768]": ln_dense_case(x, w_qkv, b_qkv, None, True),
        "fused_ln_dense[adapter,D=768]": ln_dense_case(x_ad, w_ad, b_ad, "sigmoid", True),
        "fused_ln_dense[adapter,erf,D=768]": ln_dense_case(x_ad, w_ad, b_ad, "erf", True),
        "patch_embed[D=768]": (
            lambda: twice(patch_embed(x_pe, w_pe, b_pe, v.patch_size)),
            lambda: twice(patch_embed_plain(x_pe, w_pe, b_pe, v.patch_size)),
            [(lambda: twice(pe_rounded()), "sum rounded to bf16 before the bias")],
            (rel_l2, share), (1e-3, 5e-2),
            nbytes(x_pe, w_pe, b_pe) + batch * v.num_patches * d * 2, pe_flops,
            torch.no_grad()(lambda: F.conv2d(x_pe.permute(0, 3, 1, 2), w_conv, b_pe.bfloat16(),
                                             stride=v.patch_size)), pe_dense_chain),
        # the training variants' backwards (rows 13 and 14)
        "fused_mlp_bwd[D=768]": (
            lambda: dx_twice(fused_mlp_bwd(x8, w1, b1, w2, gate, dy)),
            lambda: dx_twice(fused_mlp_bwd_plain(x8, w1, b1, w2, gate, dy)),
            [(lambda: dx_twice(fused_mlp_bwd_plain(x8, w1, b1, w2, None, dy)), "gate ignored"),
             (mlp_dg_f32, "dg kept in f32")], (rel_l2, share) + (rel_l2,) * 4,
            (2e-3, 5e-2) + (2e-3,) * 4,
            3 * nbytes(x8) + nbytes(w1, b1, w2, gate) + 4 * (d + hidden + 2 * d * hidden),
            5 * mlp_flops // 2, None, mlp_chain_bwd),
        "fused_ln_dense_bwd[D=768]": (
            lambda: dx_twice(fused_ln_dense_bwd(x, ln[0], ln[1], w_qkv, b_qkv, dy_qkv)),
            lambda: dx_twice(fused_ln_dense_bwd_plain(x, ln[0], ln[1], w_qkv, b_qkv, dy_qkv)),
            [(dense_no_m2, "no mean(dyg*xhat) term"),
             (lambda: dense_dx_moved(x, w_qkv, b_qkv, dy_qkv, None),
              "dxn rounded before the LN backward")], (rel_l2, share) + (rel_l2,) * 4,
            (2e-3, 2e-2) + (2e-3,) * 4,
            2 * nbytes(x) + nbytes(dy_qkv, ln[0], ln[1], w_qkv, b_qkv)
            + 4 * (2 * d + 3 * d * d + 3 * d), 2 * 2 * rows * d * 3 * d, None,
            dense_chain_bwd(x, w_qkv, b_qkv, dy_qkv, None)),
        "fused_ln_dense_bwd[adapter,D=768]": (
            lambda: dx_twice(fused_ln_dense_bwd(x_ad, ln[0], ln[1], w_ad, b_ad, dy_ad,
                                                gelu_mode="erf")),
            lambda: dx_twice(fused_ln_dense_bwd_plain(x_ad, ln[0], ln[1], w_ad, b_ad, dy_ad,
                                                      gelu_mode="erf")),
            [(dense_no_gelu_grad, "GELU' skipped"),
             (lambda: dense_dx_moved(x_ad, w_ad, b_ad, dy_ad, "erf"), "dg kept in f32")],
            (rel_l2, share) + (rel_l2,) * 4, (2e-3, 2e-2) + (2e-3,) * 4,
            2 * nbytes(x_ad) + nbytes(dy_ad, ln[0], ln[1], w_ad, b_ad)
            + 4 * (2 * d + a_out * d + a_out), 3 * 2 * x_ad.shape[0] * d * a_out, None,
            dense_chain_bwd(x_ad, w_ad, b_ad, dy_ad, "erf")),
        **{f"fused_mlp_int8[{'erf,' if m == 'erf' else ''}D=768]": (
            (lambda m=m: twice(fused_mlp_int8(*int8_args, m))),
            (lambda m=m: twice(fused_mlp_int8_plain(*int8_args, m))),
            [((lambda m=m: twice(int8_block_scale(m))), "one h scale per 32-row block")],
            (rel_l2, share), (5e-4, 1e-3), nbytes(*int8_args) + nbytes(x),
            (mlp_flops, INT8_OPS_PER_S), None, None) for m in ("sigmoid", "erf")},
    }
    with torch.no_grad():
        for name, (kern, plain, controls, metrics, limits, n_bytes, flops, lib, ref) in \
                cases.items():
            got, want = kern(), plain()
            sound = [m(a, b) for m, a, b in zip(metrics, got, want)]
            line = {"kernel": name, "readings": sound, "limits": list(limits)}
            if not all(torch.isfinite(a).all() for a in got) or not all(
                    r < lim for r, lim in zip(sound, limits)):
                problems.append(f"{name}: readings {sound} reach the limits {limits}")
            for ctl, fault in controls:
                ctrl = [m(a, b) for m, a, b in zip(metrics, got, ctl())]
                line[f"control ({fault})"] = ctrl
                if not any(r >= lim for r, lim in zip(ctrl, limits)):
                    problems.append(f"{name}: control ({fault}) {ctrl} under every limit")
            del got, want
            if not args.no_times:
                line["ms"] = cuda_ms(kern, 10)
                line["plain_ms"] = cuda_ms(plain, 2)
                line["library_ms"] = cuda_ms(lib, 10) if lib is not None else None
                if ref is not None:
                    line["reference_ms"] = cuda_ms(ref, 10)
                ops, rate = flops if isinstance(flops, tuple) else (flops, BF16_FLOPS_PER_S)
                t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
                line["bound_ms"], line["bound_by"] = max(
                    (t_bytes, "bytes"), (t_ops, "operations"))
            line["card"] = card
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    if problems:
        sys.exit("vit_base_checks_torch: " + "; ".join(problems))
    print("vit_base_checks_torch: every check passed", flush=True)


if __name__ == "__main__":
    main()
