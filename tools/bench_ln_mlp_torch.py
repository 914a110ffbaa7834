"""Times the port's LN+MLP forward kernels at the main paths' shapes, on one CUDA card.

The three forward entries of ``intentbev_torch.ops`` (``csrc/fused_ln_mlp.cu``)
on the tensors the ViT gives them, at batch 8 x 4501 tokens = 36008 rows:
ViT-S (D=384, hidden 1536) and ViT-Ti (D=192, hidden 768).

- ``fused_ln_mlp``: the serving block tail with the next block's LN (both
  GELUs; the bench lines serve the sigmoid one);
- ``fused_ln_mlp_train``: the training forward with a per-sample drop-path
  gate, and the unchained serving tail without one;
- ``fused_mlp``: the MLP without LN (configuration C) at D=384, serving.

and the backward entries on the same tensors (``--only bwd``):

- ``fused_ln_mlp_bwd``: row 7, the LN+MLP backward, with the per-sample
  gate, at D=384 and 192;
- ``fused_mlp_bwd``: row 13's backward, the MLP without LN (configuration
  C), gated, at D=384.

and row 14, the LN + dense pair (``--only ln_dense``; configuration B), at
D=384 and 192: ``fused_ln_dense`` as the qkv projection (Dout 3D, no GELU;
36008 rows) and as an adapter (Dout 192, 36000 rows; the serving sigmoid and
the training erf GELU), and ``fused_ln_dense_bwd`` for both (the adapter's
with the erf GELU).

and row 17, the W8A8 serving MLP (``--only int8``; configuration A),
``fused_mlp_int8`` at D=384 (hidden 1536) and D=192 (hidden 768), 36008 rows
of varied scale as a residual stream's, the codes of f32 weights, both
GELUs: beside its plain version, with the int8 operations' bound (1979
TOP/s) and a SHA-256 digest of y on the seeded inputs, so that one call on
two trees shows whether their kernels give the same bits.

and the two patch-embed kernels (``--only embed``; the ViT's lidar embed,
conv8x8,s8 + bias from one [8, 8, 290, D] weight), at D=384 and 192: row
15, ``patch_embed`` over a dense bf16 BEV [8, 400, 720, 290] (configuration
D), beside ``F.conv2d`` with input and weight in channels_last strides (the
input a permuted view of the NHWC BEV) and over contiguous NCHW copies, and
the ``PatchEmbed.dense`` chain (a permute copy and one matmul) as its
reference; and row 1, ``voxel_embed_tokens`` over the flagship line's
chunks (8 frames of 16384 points each, ``serving_batch`` seed 0, 512 chunks
a band), split by kernel (the hit list, the gather), with the bytes of W's
rows its occupied cells read from L2. Both print a SHA-256 of the tokens.

and the row LayerNorms (``--only ln``; rows 5, 8 and 9 of ``PERF.md``),
``layernorm``, ``layernorm_train`` and ``layernorm_bwd`` over 36008 rows at
D=384 and 192, beside ``F.layer_norm`` (forward, and its backward through
``torch.autograd.grad``); and the residual projection (``--only proj``; row
19, a library op), ``fused_proj_fwd`` and ``fused_proj_bwd`` over 36864 rows
(8 x 4608, the attention sublayer's padded rows) with a per-sample gate at
(d_in, d_out) = (384, 384) and (192, 384), beside ``torch.addmm``, the
model's unfused Linear, gate and residual, and that chain's backward
kernels. Both read each call's device time from a profiler trace
(``device_ms``: the sum of its kernels' durations, split by kernel), since
the host's launch rate bounds a loop of these short calls, and check that
two calls give the same bits.

For each case: CUDA-event ms per call (``--iters`` calls after one), TFLOP/s
of its operations (forward 4*N*D*H; backward the 5 products, 10*N*D*H; row
14 2*N*D*Dout a product: one forward, two or three backward), the bound (at
989 TFLOP/s bf16 or, for row 14 where it is larger, its bytes at 3.35
TB/s), the plain version's ms, and the ms of the same function as a chain
of PyTorch calls in bf16 (``F.layer_norm``, ``F.linear``, the GELU,
``F.linear``, the residual; cuBLAS's GEMMs; for a backward,
``torch.autograd.grad`` through that chain), a yardstick the port never
calls; then each output's relative L2 and share of differing elements
against the plain version. A backward's line also splits its device time by
kernel from a profiler trace: the row kernel, the dW products and the
partial sums. A case the tree's kernels refuse (row 14 at D=192 before
they took it) prints its error in place of its numbers.

    python3 tools/bench_ln_mlp_torch.py [--iters 20] [--only fwd|bwd|ln_dense|int8|embed|ln|proj]   # a JSON line a case

It imports no JAX and runs as it stands on an older checkout of the port
(the entries' signatures are unchanged), so that one call can time two
trees in turn: copy it into the other tree's ``tools/`` and run it there.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
INT8_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
ROWS = 8 * 4501  # flagship batch 8 x 4501 tokens


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("fwd", "bwd", "ln_dense", "int8", "embed", "ln", "proj"),
                    default=None,
                    help="only the LN+MLP forward or backward cases, or only row 14's, 17's, "
                    "the patch embeds' (rows 15 and 1), the LayerNorms' (rows 5, 8, 9) or the "
                    "residual projection's (row 19)")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from intentbev_torch.ops import (fused_ln_dense, fused_ln_dense_bwd,
                                     fused_ln_dense_bwd_plain, fused_ln_dense_plain,
                                     fused_ln_mlp, fused_ln_mlp_bwd, fused_ln_mlp_bwd_plain,
                                     fused_ln_mlp_plain, fused_ln_mlp_train,
                                     fused_ln_mlp_train_plain, fused_mlp, fused_mlp_bwd,
                                     fused_mlp_bwd_plain, fused_mlp_int8, fused_mlp_int8_plain,
                                     fused_mlp_plain, layernorm, layernorm_bwd,
                                     layernorm_bwd_plain, layernorm_plain, layernorm_train,
                                     layernorm_train_plain, patch_embed, patch_embed_plain,
                                     quantize_linear, voxel_embed_tokens,
                                     voxel_embed_tokens_plain)
    from intentbev_torch.ops.experimental import (fused_proj_bwd, fused_proj_bwd_plain,
                                                  fused_proj_fwd, fused_proj_fwd_plain)

    if not torch.cuda.is_available():
        sys.exit("bench_ln_mlp_torch: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, std, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    def event_ms(fn):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    def tup(r):
        return r if isinstance(r, tuple) else (r,)

    def gelu16(t, mode):  # the GELU in bf16, as the unfused model would run it
        return F.gelu(t) if mode == "erf" else t * torch.sigmoid(1.702 * t)

    bwd_kinds = (("dW", ("dw_gemm", "gemm_at_b")),
                 ("rows", ("bwd_rows", "ln_mlp_bwd_kernel", "ln_dense_bwd_kernel",
                           "proj_bwd_kernel")),
                 ("sums", ("sum",)))

    def by_kernel(fn, kinds, iters=3):
        """Device ms per call of fn's kernels from a profiler trace, by
        ``kinds`` ((part, name substrings), the first match wins; the rest
        is "other"), as ``bwd_kinds``: the backward's row kernel, dW
        products and partial sums."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        parts = {**{k: 0.0 for k, _ in kinds}, "other": 0.0}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            key = next((k for k, subs in kinds if any(x in ev.key for x in subs)), "other")
            parts[key] += ev.device_time_total / 1e3 / iters
        return {k: round(v, 4) for k, v in parts.items()}

    def report(name, kern, plain, reference, flops, split=None, n_bytes=0,
               rate=BF16_FLOPS_PER_S, digest=False, library=None, extra=None, repeat=False):
        try:
            got = tup(kern())
        except ValueError as e:  # a case this tree's kernels refuse (`require`)
            print(json.dumps({"name": name, "error": str(e), "card": card}), flush=True)
            return
        want = tup(plain())
        readings = {"rel_l2": [float((a.double() - b.double()).norm() / b.double().norm())
                               for a, b in zip(got, want)],
                    "share_differing": [float((a != b).float().mean())
                                        for a, b in zip(got, want)]}
        if digest:  # the kernel's bits, to hold against another tree's
            readings["sha256"] = [hashlib.sha256(a.cpu().view(torch.int16).numpy().tobytes())
                                  .hexdigest()[:16] for a in got]
        if repeat:  # a second call gives the same bits
            readings["same_bits_twice"] = all(torch.equal(a, b) for a, b in zip(got, tup(kern())))
        del got, want
        ms = event_ms(kern)
        bounds = {"operations": flops / rate, "bytes": n_bytes / HBM_BYTES_PER_S}
        by = max(bounds, key=bounds.get)
        line = {"name": name, "ms": round(ms, 4), "tflops": round(flops / ms / 1e9, 1),
                "bound_ms": round(bounds[by] * 1e3, 4), "bound_by": by,
                "plain_ms": round(event_ms(plain), 4),
                "reference_ms": None if reference is None else round(event_ms(reference), 4),
                **readings, "card": card}
        for label, fn in (library or {}).items():  # one PyTorch call each
            line[f"library_ms[{label}]"] = round(event_ms(fn), 4)
        line.update(extra or {})
        if split:
            line["ms_by_kernel"] = by_kernel(kern, split)
            line["device_ms"] = round(sum(line["ms_by_kernel"].values()), 4)
        print(json.dumps(line), flush=True)

    def forward_cases(d, tag, x, res, ln, w1, b1, w2, b2, ln16, b1_16, b2_16, flops,
                      mlp_args, train_args, chain):
        with torch.no_grad():
            for mode in ("sigmoid", "erf"):
                report(f"fused_ln_mlp[{mode}]{tag}",
                       lambda mode=mode: fused_ln_mlp(*mlp_args, gelu_mode=mode),
                       lambda mode=mode: fused_ln_mlp_plain(*mlp_args, gelu_mode=mode),
                       lambda mode=mode: F.layer_norm(x + chain(x, mode), (d,), ln16[2], ln16[3],
                                                      1e-6), flops)
            report(f"fused_ln_mlp_train[gated]{tag}",
                   lambda: fused_ln_mlp_train(*train_args, gate),
                   lambda: fused_ln_mlp_train_plain(*train_args, gate),
                   lambda: x + chain(x, "erf") * gate[:, None].bfloat16(), flops)
            report(f"fused_ln_mlp_train[no gate, sigmoid]{tag}",
                   lambda: fused_ln_mlp_train(*train_args, gelu_mode="sigmoid"),
                   lambda: fused_ln_mlp_train_plain(*train_args, gelu_mode="sigmoid"),
                   lambda: x + chain(x, "sigmoid"), flops)
            if d == 384:
                report("fused_mlp[sigmoid]",
                       lambda: fused_mlp(x, w1, b1, w2, b2, res, gelu_mode="sigmoid"),
                       lambda: fused_mlp_plain(x, w1, b1, w2, b2, res, gelu_mode="sigmoid"),
                       lambda: res + chain(x, "sigmoid", ln_in=False), flops)

    def backward_cases(d, tag, x, res, ln, w1, b1, w2, b2, ln16, b1_16, b2_16, flops):
        """Row 7 (and, at D=384, row 13's backward) against the plain
        backward and autograd through the bf16 chain (erf GELU, the gate)."""
        dy = randn((ROWS, d), 1.0)
        gate16 = gate[:, None].bfloat16()

        def chain_grads(ln_in):
            leaves = [t.detach().clone().requires_grad_(True) for t in
                      (x, w1, b1_16, w2, b2_16, *(ln16[:2] if ln_in else ()))]
            xr, w1r, b1r, w2r, b2r = leaves[:5]
            xn = F.layer_norm(xr, (d,), leaves[5], leaves[6], 1e-6) if ln_in else xr
            out = F.linear(F.gelu(F.linear(xn, w1r, b1r)), w2r, b2r) * gate16
            out = xr + out if ln_in else res + out
            return lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)

        bwd_args = (x, ln[0], ln[1], w1, b1, w2, gate, dy)
        report(f"fused_ln_mlp_bwd[gated]{tag}", lambda: fused_ln_mlp_bwd(*bwd_args),
               lambda: fused_ln_mlp_bwd_plain(*bwd_args), chain_grads(True), 5 * flops // 2,
               split=bwd_kinds)
        if d == 384:
            mlp_args_ = (x, w1, b1, w2, gate, dy)
            report("fused_mlp_bwd[gated]", lambda: fused_mlp_bwd(*mlp_args_),
                   lambda: fused_mlp_bwd_plain(*mlp_args_), chain_grads(False),
                   5 * flops // 2, split=bwd_kinds)

    def ln_dense_cases(d, tag):
        """Row 14 at width d: qkv and an adapter, forward and backward."""
        g, b = randn((d,), 0.2, torch.float32) + 1, randn((d,), 0.2, torch.float32)
        g16, b16 = g.bfloat16(), b.bfloat16()
        for case, n, dout, modes, bwd_mode in (("qkv", ROWS, 3 * d, (None,), None),
                                               ("adapter", 8 * 4500, 192, ("sigmoid", "erf"),
                                                "erf")):
            x = randn((n, d), 1.0)
            w, bias = randn((dout, d), d ** -0.5), randn((dout,), 0.1, torch.float32)
            bias16 = bias.bfloat16()
            flops = 2 * n * d * dout

            def chain(xr, wr, br, mode, g_=g16, b_=b16):  # [GELU](F.linear(F.layer_norm(x)))
                y = F.linear(F.layer_norm(xr, (d,), g_, b_, 1e-6), wr, br)
                return gelu16(y, mode) if mode else y

            with torch.no_grad():
                for mode in modes:
                    report(f"fused_ln_dense[{case}, {mode or 'no GELU'}]{tag}",
                           lambda mode=mode: fused_ln_dense(x, g, b, w, bias, gelu_mode=mode),
                           lambda mode=mode: fused_ln_dense_plain(x, g, b, w, bias,
                                                                  gelu_mode=mode),
                           lambda mode=mode: chain(x, w, bias16, mode), flops,
                           n_bytes=2 * (n * d + n * dout + dout * d) + 4 * (2 * d + dout))
            dy = randn((n, dout), 1.0)
            leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, bias16, g16, b16)]
            out = chain(leaves[0], leaves[1], leaves[2], bwd_mode, leaves[3], leaves[4])
            bwd_args = (x, g, b, w, bias, dy)
            report(f"fused_ln_dense_bwd[{case}, {bwd_mode or 'no GELU'}]{tag}",
                   lambda: fused_ln_dense_bwd(*bwd_args, gelu_mode=bwd_mode),
                   lambda: fused_ln_dense_bwd_plain(*bwd_args, gelu_mode=bwd_mode),
                   lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True),
                   (3 if bwd_mode else 2) * flops, split=bwd_kinds,
                   n_bytes=2 * (2 * n * d + n * dout + dout * d) + 4 * (dout * d + dout + 2 * d))
            del x, dy, out, leaves
            torch.cuda.empty_cache()

    def int8_cases(d):
        """Row 17 at width d, hidden 4d: rows of varied scale, the codes of
        f32 weights, f32 biases; the residual another bf16 stream."""
        hid = 4 * d
        x = (torch.randn(ROWS, d, generator=gen, device="cuda")
             * torch.exp(0.5 * torch.randn(ROWS, 1, generator=gen, device="cuda"))).bfloat16()
        res = randn((ROWS, d), 1.0)
        w1q, s1 = quantize_linear(randn((hid, d), d ** -0.5, torch.float32))
        w2q, s2 = quantize_linear(randn((d, hid), hid ** -0.5, torch.float32))
        b1, b2 = randn((hid,), 0.1, torch.float32), randn((d,), 0.1, torch.float32)
        args8 = (x, w1q, s1, b1, w2q, s2, b2, res)
        with torch.no_grad():
            for mode in ("sigmoid", "erf"):
                report(f"fused_mlp_int8[{mode}]" + ("" if d == 384 else f"[D={d}]"),
                       lambda mode=mode: fused_mlp_int8(*args8, mode),
                       lambda mode=mode: fused_mlp_int8_plain(*args8, mode), None,
                       4 * ROWS * d * hid, n_bytes=2 * 3 * ROWS * d + 2 * d * hid
                       + 4 * (2 * hid + 2 * d), rate=INT8_OPS_PER_S, digest=True)

    def embed_cases(d):
        """Rows 15 and 1 at width d: the patch embed over a dense BEV and
        over the flagship's chunks, from one [8, 8, 290, d] weight."""
        from intentbev_torch.configs import default_vit_config
        from intentbev_torch.ops.voxel_embed import chunks_to_device, decode_chunk_transport
        from intentbev_torch.parallel.inference import build_chunk_transport
        from intentbev_torch.synthetic import serving_batch

        tag = "" if d == 384 else f"[D={d}]"
        grid = default_vit_config().grid
        h, w, c, p = grid.height_px, grid.width_px, grid.lidar_total_channels, 8
        n_tok = 8 * (h // p) * (w // p)
        kern, bias = randn((p, p, c, d), 0.02), randn((d,), 0.1, torch.float32)
        bias16 = bias.bfloat16()
        x = randn((8, h, w, c), 1.0)
        w_cl = kern.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        x_nchw, w_nchw = x.permute(0, 3, 1, 2).contiguous(), kern.permute(3, 2, 0, 1).contiguous()

        def dense_chain():  # PatchEmbed.dense: a permute copy, one matmul, the bias
            xp = x.reshape(8, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
            xp = xp.reshape(8, n_tok // 8, p * p * c)
            return torch.matmul(xp, kern.reshape(p * p * c, d)) + bias16

        with torch.no_grad():
            report(f"patch_embed{tag}", lambda: patch_embed(x, kern, bias, p),
                   lambda: patch_embed_plain(x, kern, bias, p), dense_chain,
                   2 * n_tok * p * p * c * d,
                   n_bytes=2 * (x.numel() + kern.numel() + n_tok * d) + 4 * d, digest=True,
                   library={"conv2d channels_last": lambda: F.conv2d(
                                x.permute(0, 3, 1, 2), w_cl, bias16, stride=p),
                            "conv2d NCHW": lambda: F.conv2d(x_nchw, w_nchw, bias16, stride=p)})
        del x, x_nchw, w_cl, w_nchw
        torch.cuda.empty_cache()
        pts, valid, _ = serving_batch(grid, 8, 16384, 0)
        chunks = decode_chunk_transport(chunks_to_device(
            build_chunk_transport(pts, valid, grid, p, 512), "cuda"))
        used = torch.arange(chunks.wid.shape[-1], device="cuda") < chunks.count[..., None]
        cells = int(((chunks.val != 0) & used[..., None, None]).sum())
        in_bytes = sum(t.numel() * t.element_size() for t in chunks)
        with torch.no_grad():
            report(f"voxel_embed{tag}", lambda: voxel_embed_tokens(chunks, kern, bias, p, (h, w)),
                   lambda: voxel_embed_tokens_plain(chunks, kern, bias, p, (h, w)), None,
                   2 * cells * d, n_bytes=in_bytes + 2 * kern.numel() + 4 * d + 2 * n_tok * d,
                   digest=True, split=(("hits", ("voxel_hits",)), ("gather", ("voxel_gather",)),
                                       ("kernel", ("voxel_embed",))),
                   extra={"occupied_cells": cells, "w_row_bytes_from_l2": cells * d * 2})

    def ln_cases(d, tag):
        """Rows 5, 8 and 9 at width d over ROWS rows, beside F.layer_norm."""
        x, dy = randn((ROWS, d), 1.0), randn((ROWS, d), 1.0)
        g, b = randn((d,), 0.2, torch.float32) + 1, randn((d,), 0.2, torch.float32)
        _, xhat, inv = layernorm_train_plain(x, g, b)
        xl = x.detach().clone().requires_grad_(True)
        g16, b16 = (p.bfloat16().requires_grad_(True) for p in (g, b))
        y_ln = F.layer_norm(xl, (d,), g16, b16, 1e-6)
        rows_n = ROWS * d * 2  # bytes of one [ROWS, d] bf16 tensor
        kinds = (("rows", ("layernorm",)), ("sums", ("sum",)))
        with torch.no_grad():
            report(f"layernorm{tag}", lambda: layernorm(x, g, b), lambda: layernorm_plain(x, g, b),
                   None, 0, split=kinds, n_bytes=2 * rows_n + 8 * d, repeat=True,
                   library={"F.layer_norm": lambda: F.layer_norm(x, (d,), g16, b16, 1e-6)})
            report(f"layernorm_train{tag}", lambda: layernorm_train(x, g, b),
                   lambda: layernorm_train_plain(x, g, b), None, 0, split=kinds,
                   n_bytes=3 * rows_n + 4 * ROWS + 8 * d, repeat=True,
                   library={"F.layer_norm": lambda: F.layer_norm(x, (d,), g16, b16, 1e-6)})
        report(f"layernorm_bwd{tag}", lambda: layernorm_bwd(dy, xhat, inv, g),
               lambda: layernorm_bwd_plain(dy, xhat, inv, g), None, 0, split=kinds,
               n_bytes=3 * rows_n + 4 * ROWS + 4 * d + 8 * d, repeat=True,
               library={"F.layer_norm backward": lambda: torch.autograd.grad(
                   y_ln, (xl, g16, b16), dy, retain_graph=True)})
        del x, dy, xhat, inv, xl, y_ln
        torch.cuda.empty_cache()

    def proj_cases(d_in, d_out):
        """Row 19 over 8 x 4608 rows with a per-sample gate, beside addmm,
        the unfused chain and that chain's backward kernels."""
        n = 8 * 4608
        tag = "" if (d_in, d_out) == (384, 384) else f"[{d_in}x{d_out}]"
        x, r, dy = randn((n, d_in), 1.0), randn((n, d_out), 1.0), randn((n, d_out), 1.0)
        w, bias = randn((d_in, d_out), d_in ** -0.5), randn((d_out,), 0.1, torch.float32)
        keep_p = (torch.rand(8, 1, generator=gen, device="cuda") < 0.9).float() / 0.9
        gate_p = keep_p.repeat_interleave(4608, 0).contiguous()  # [n, 1]
        w_lin, b16, g16 = w.t().contiguous(), bias.bfloat16(), keep_p.view(8, 1, 1).bfloat16()
        r2b = (r.float() + bias).bfloat16()
        x3, r3 = x.view(8, 4608, d_in), r.view(8, 4608, d_out)
        flops = 2 * n * d_in * d_out

        @torch.no_grad()
        def unfused_bwd():  # the kernels autograd launches for the unfused chain
            dyg = (dy.view(8, 4608, d_out) * g16).view(n, d_out)
            return torch.matmul(dyg, w_lin), torch.matmul(dyg.t(), x), dyg.sum(0)

        with torch.no_grad():
            report(f"fused_proj{tag}", lambda: fused_proj_fwd(x, w, bias, r, gate_p),
                   lambda: fused_proj_fwd_plain(x, w, bias, r, gate_p),
                   lambda: r3 + F.linear(x3, w_lin, b16) * g16, flops,
                   split=(("rows", ("proj",)),), repeat=True,
                   n_bytes=2 * (n * d_in + 2 * n * d_out + d_in * d_out) + 4 * (d_out + n),
                   library={"addmm (gate 1, bias in residual)": lambda: torch.addmm(r2b, x, w)})
        report(f"fused_proj_bwd{tag}", lambda: fused_proj_bwd(x, w, dy, gate_p),
               lambda: fused_proj_bwd_plain(x, w, dy, gate_p), unfused_bwd, 2 * flops,
               split=bwd_kinds, repeat=True,
               n_bytes=2 * (2 * n * d_in + n * d_out + d_in * d_out) + 4 * (
                   n + d_in * d_out + d_out))
        del x, r, dy, x3, r3, r2b
        torch.cuda.empty_cache()

    keep = (torch.rand(8, 1, generator=gen, device="cuda") < 0.9).float() / 0.9
    gate = keep.expand(8, ROWS // 8).reshape(ROWS).contiguous()  # per sample, as drop-path
    if args.only == "proj":
        for d_in, d_out in ((384, 384), (192, 384)):
            proj_cases(d_in, d_out)
        return
    for d, tag in ((384, ""), (192, "[D=192]")):
        if args.only == "ln":
            ln_cases(d, tag)
            continue
        if args.only == "embed":
            embed_cases(d)
            continue
        if args.only == "int8":
            int8_cases(d)
            continue
        if args.only == "ln_dense":
            ln_dense_cases(d, tag)
            continue
        hid = 4 * d
        x, res = randn((ROWS, d), 1.0), randn((ROWS, d), 1.0)
        ln = [randn((d,), 0.2, torch.float32) + (1 - i % 2) for i in range(4)]
        w1, b1 = randn((hid, d), d ** -0.5), randn((hid,), 0.1, torch.float32)
        w2, b2 = randn((d, hid), hid ** -0.5), randn((d,), 0.1, torch.float32)
        ln16, b1_16, b2_16 = [p.bfloat16() for p in ln], b1.bfloat16(), b2.bfloat16()
        flops = 4 * ROWS * d * hid
        mlp_args = (x, ln[0], ln[1], w1, b1, w2, b2, ln[2], ln[3])
        train_args = (x, ln[0], ln[1], w1, b1, w2, b2)

        def chain(inp, mode, ln_in=True):  # fc2(GELU(fc1(LN(inp)))) in bf16
            xn = F.layer_norm(inp, (d,), ln16[0], ln16[1], 1e-6) if ln_in else inp
            return F.linear(gelu16(F.linear(xn, w1, b1_16), mode), w2, b2_16)

        if args.only != "bwd":
            forward_cases(d, tag, x, res, ln, w1, b1, w2, b2, ln16, b1_16, b2_16, flops,
                          mlp_args, train_args, chain)
        if args.only != "fwd":
            backward_cases(d, tag, x, res, ln, w1, b1, w2, b2, ln16, b1_16, b2_16, flops)
        del x, res, w1, w2
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
