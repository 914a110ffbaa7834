"""Card checks of the kernels on ViT-B's serving path (D=768, 12 heads of 64).

1. The compiler's report: each kernel source of the path compiled with
   ``-Xptxas -v``; for the D=768 instances (row 4's ``ln_mlp_wide_kernel``
   with each GELU, row 1's ``voxel_gather_kernel<768>``, row 5's
   ``layernorm_kernel<768>``) the registers, the spill stores and loads,
   and any ptxas warning that names them (C7514 / C7520: wgmma serialised).
   A spill or such a warning fails the run.
2. Each kernel against its plain version at the shapes ViT-B's serving path
   gives it (batch 8 x 4501 tokens = 36008 rows, hidden 3072; the chunks of
   8 frames of 16384 points, ``serving_batch`` seed 0), in bf16: the
   relative L2 and the share of elements that differ, under the limits of
   ``chip_smoke.py`` phase 3, and a control with one fault that must reach a
   limit (row 4: the erf GELU, h kept in f32 before fc2; row 5: the
   variance over N-1; row 1: the last chunk of each band skipped; rows 2
   and 3 at [8, 4501, 768] in 12 heads of 64: another softmax form's
   plain version). Then CUDA-event times of kernel, plain version, the
   library call where one exists (``F.layer_norm``, SDPA) and, for row 4,
   the same function as a chain of PyTorch calls in bf16, beside each
   bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s).

    python3 tools/vit_base_checks_torch.py [--no-times]

It builds into ``intentbev_torch/_build/checks`` and imports no JAX. A
failed check exits nonzero.
"""

from __future__ import annotations

import argparse
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
INSTANCES = {"fused_ln_mlp.cu": ("ln_mlp_wide_kernelILi768ELi0E", "ln_mlp_wide_kernelILi768ELi1E"),
             "voxel_embed.cu": ("voxel_gather_kernelILi768E",),
             "layernorm.cu": ("layernorm_kernelILi768E",)}
HBM_BYTES_PER_S, BF16_FLOPS_PER_S = 3.35e12, 989e12


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
    from intentbev_torch.ops import (flash_attention_packed, flash_attention_packed_plain,
                                     fused_ln_mlp, fused_ln_mlp_plain, layernorm,
                                     layernorm_plain, voxel_embed_tokens,
                                     voxel_embed_tokens_plain)
    from intentbev_torch.ops._build import BUILD_DIR, _nvcc
    from intentbev_torch.ops.fused_ln_mlp import gelu
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
                t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
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
