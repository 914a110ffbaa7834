"""Times the port's attention kernels at the main paths' shapes, on one CUDA card.

Every flash entry of ``intentbev_torch.ops`` that the training and serving
paths call, on the tensors they are called with: the packed layout at
[8, 4501, 384] in 6 heads of 64 and 12 heads of 32 (column slices of one
qkv projection output; the forward in its three softmax forms, monolithic
safe, fixed max and chunked safe at 1152 keys, and the backward in its
three forms, fused, split and chunked), and the BHTD layout on ViT-Ti's
[8, 4501, 3*192] qkv output in 3 heads of 64. For each: CUDA-event ms per
call (10 calls after one), the device time split by kernel from a profiler
trace (for a backward: the dk/dv kernel, the dq kernel and the wrapper's own
kernels), TFLOP/s of the work the bound counts (forward 2 products,
backward 5), the bound at 989 TFLOP/s bf16, for a forward also the bound of
its B*H*T*T exponentials at 16 a clock per SM on every SM at the SM clock
``nvidia-smi`` reads over half a second of its calls, and the same
function's time through
``scaled_dot_product_attention`` (forward, or forward saved and backward
through autograd) on contiguous [B, H, T, D] copies, as a yardstick only.

The library op ``flash_attention_packed_int8`` (row 18) at the attention
sublayer's shapes, [8, 4608, 384] with 4501 real keys, in 6 heads of 64, 12
of 32, 24 of 16 and 3 of 128 (bf16) and 6 of 64 in f32: CUDA-event ms, the
device time of its pre-pass (``quant_k_kernel`` + ``quant_v_kernel``) and of
its attention kernel from a profiler trace, its bounds (the int8 ops of its
two products at 1979 TOP/s, its B*H*T*seq_len exponentials at 16 a clock per
SM at the measured SM clock, its bytes at 3.35 TB/s), and as yardsticks
only the bf16 packed forward in its safe form (head dims 32 and 64) and
SDPA on the same q, k, v. A shape the tree's entry refuses prints its error.

    python3 tools/bench_flash_torch.py              # one JSON line per entry
    python3 tools/bench_flash_torch.py --only int8  # the int8 op's lines only

It imports no JAX, and runs as it stands on an older checkout of the port
whose packed forward takes its softmax forms, so that one call can time two
trees in turn.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
HBM_BYTES_PER_S = 3.35e12
EX2_PER_CLOCK_PER_SM = 16  # H100 special-function units
B, T = 8, 4501
FORMS = {"fused": (True, 0), "split": (False, 0), "chunked": (False, 1152)}
# the forward's softmax forms: (kv_chunk, unsafe_softmax)
FWD_FORMS = {"safe": (0, False), "fixed": (1152, True), "chunked": (1152, False)}
# the int8 op's cases: (heads over 384 lanes, dtype name); rows and real keys
INT8_CASES = ((6, "bfloat16"), (12, "bfloat16"), (24, "bfloat16"), (3, "bfloat16"),
              (6, "float32"))
INT8_T, INT8_SEQ = 4608, 4501


class SmClock:
    """Median SM clock (MHz) that ``nvidia-smi`` reads about every 50 ms while
    the block runs."""

    def __enter__(self):
        self.samples, self.stop = [], threading.Event()

        def sample():
            while not self.stop.is_set():
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                    capture_output=True, text=True).stdout.split()
                self.samples.extend(float(s) for s in out[:1])
                self.stop.wait(0.05)

        self.thread = threading.Thread(target=sample, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=10)
        mhz = sorted(self.samples)
        self.mhz = mhz[len(mhz) // 2] if mhz else float("nan")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("int8",), help="time only the int8 op's lines")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from intentbev_torch.ops import (flash_attention_bwd, flash_attention_fwd,
                                     flash_attention_packed, flash_attention_packed_bwd)
    from intentbev_torch.ops.experimental import flash_attention_packed_int8
    from intentbev_torch.ops.flash_attention import flash_attention_packed_layout, heads_view

    if not torch.cuda.is_available():
        sys.exit("bench_flash_torch: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    def event_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def kernel_ms(fn, iters=3):
        """Device ms per call by kernel part, from a profiler trace (an empty
        dict where the trace held no device event)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        parts = {}
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                part = ("dk/dv" if "flash_bwd_dkdv" in ev.key else "dq" if "flash_bwd_dq" in ev.key
                        else "forward" if "flash_fwd" in ev.key
                        else "pre-pass" if "quant_k_kernel" in ev.key or "quant_v_kernel" in ev.key
                        else "attention" if "flash_int8_kernel" in ev.key else "wrapper")
                parts[part] = parts.get(part, 0.0) + ev.device_time_total / 1e3 / iters
        return parts

    def sdpa(q_, k_, v_, do_, h):
        """SDPA forward and backward on contiguous [B, H, T, D] copies of
        packed [B, T, H*D] (or [B, H, T, D] view) tensors."""
        def bhtd(x):
            x = x if x.dim() == 4 else x.unflatten(-1, (h, x.shape[-1] // h)).transpose(1, 2)
            return x.contiguous()
        qs, ks, vs = (bhtd(x).requires_grad_(True) for x in (q_, k_, v_))
        dos = bhtd(do_)
        out = F.scaled_dot_product_attention(qs, ks, vs)
        return (torch.no_grad()(lambda: F.scaled_dot_product_attention(qs, ks, vs)),
                lambda: torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True))

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def report(name, fn, products, d_model, library, heads=None):
        ms = event_ms(fn)
        if heads is not None:  # the clock under this load, over half a second of calls
            with SmClock() as clock:
                event_ms(fn, max(10, int(500 / ms)))
        flops = 2 * products * B * T * T * d_model
        line = {"name": name, "ms": round(ms, 4), "parts_ms": {
                    k: round(t, 4) for k, t in kernel_ms(fn).items()},
                "tflops": round(flops / ms / 1e9, 1),
                "bound_ms": round(flops / BF16_FLOPS_PER_S * 1e3, 4)}
        if heads is not None:  # a forward: its exponentials at the measured clock
            ex2_per_s = EX2_PER_CLOCK_PER_SM * sms * clock.mhz * 1e6
            line.update(exp_bound_ms=round(B * heads * T * T / ex2_per_s * 1e3, 4),
                        sm_clock_mhz=clock.mhz)
        sdpa_ms = event_ms(library)
        line.update(sdpa_ms=round(sdpa_ms, 4), vs_sdpa=round(ms / sdpa_ms, 3), card=card)
        print(json.dumps(line), flush=True)

    d = 384

    def int8_lines():
        qkv8 = torch.randn(B, INT8_T, 3 * d, generator=gen, device="cuda")
        for heads, dt_name in INT8_CASES:
            dt = getattr(torch, dt_name)
            x = qkv8.to(dt)
            q8, k8, v8 = (x[..., i * d:(i + 1) * d] for i in range(3))
            name = f"flash_int8 {heads}x{d // heads} {dt_name}"

            def fn(h_=heads, a=(q8, k8, v8)):
                return flash_attention_packed_int8(*a, h_, INT8_SEQ)
            try:
                fn()
            except ValueError as exc:  # a shape this tree's entry refuses
                print(json.dumps({"name": name, "raises": str(exc), "card": card}), flush=True)
                continue
            ms = event_ms(fn)
            with SmClock() as clock:
                event_ms(fn, max(10, int(500 / ms)))
            scores = B * heads * INT8_T * INT8_SEQ
            ex2_per_s = EX2_PER_CLOCK_PER_SM * sms * clock.mhz * 1e6
            n_bytes = 4 * B * INT8_T * d * x.element_size()  # q, k, v read, o written
            line = {"name": name, "ms": round(ms, 4),
                    "parts_ms": {k_: round(t_, 4) for k_, t_ in kernel_ms(fn).items()},
                    "int8_ops_bound_ms": round(4 * scores * (d // heads) / INT8_OPS_PER_S * 1e3, 4),
                    "exp_bound_ms": round(scores / ex2_per_s * 1e3, 4),
                    "bytes_bound_ms": round(n_bytes / HBM_BYTES_PER_S * 1e3, 4),
                    "sm_clock_mhz": clock.mhz}
            if dt == torch.bfloat16 and d // heads in (32, 64):
                line["bf16_safe_forward_ms"] = round(event_ms(
                    lambda h_=heads: flash_attention_packed(q8, k8, v8, h_, INT8_SEQ)), 4)
            qs, ks, vs = (t_[:, :INT8_SEQ].unflatten(-1, (heads, d // heads)).transpose(1, 2)
                          .contiguous() for t_ in (q8, k8, v8))
            line["sdpa_ms"] = round(event_ms(torch.no_grad()(
                lambda: F.scaled_dot_product_attention(qs, ks, vs))), 4)
            line["card"] = card
            print(json.dumps(line), flush=True)
            del x, q8, k8, v8, qs, ks, vs
            torch.cuda.empty_cache()

    if args.only == "int8":
        int8_lines()
        return
    qkv = randn(B, T, 3 * d)
    q, k, v = (qkv[..., i * d:(i + 1) * d] for i in range(3))
    do = randn(B, T, d)
    forms = FWD_FORMS
    for h in (6, 12):
        tag = f"{h}x{d // h}"
        o, lse = flash_attention_packed(q, k, v, h)
        lib_fwd, lib_bwd = sdpa(q, k, v, do, h)
        for form, args in forms.items():
            report(f"flash_packed {form} {tag}",
                   lambda h=h, args=args: flash_attention_packed(q, k, v, h, None, *args), 2, d,
                   lib_fwd, h)
        for form, (fused, chunk) in FORMS.items():
            report(f"flash_packed_bwd {form} {tag}",
                   lambda h=h, o=o, lse=lse, fused=fused, chunk=chunk: flash_attention_packed_bwd(
                       q, k, v, o, lse, do, h, None, fused, chunk), 5, d, lib_bwd)
        del o, lse, lib_fwd, lib_bwd
    dt = d // 2
    qkv_t = randn(B, T, 3 * dt)
    parts = [qkv_t[..., i * dt:(i + 1) * dt] for i in range(3)]
    views = [heads_view(x, 3) for x in parts]
    o_t, lse_t = flash_attention_packed_layout(*parts, 3)
    o_v, do_v = heads_view(o_t, 3), heads_view(randn(B, T, dt), 3)
    lib_fwd, lib_bwd = sdpa(*views, do_v, 3)
    report("flash_attention 3x64", lambda: flash_attention_fwd(*views, out=o_v), 2, dt, lib_fwd,
           3)
    report("flash_attention_bwd 3x64",
           lambda: flash_attention_bwd(*views, o_v, lse_t, do_v), 5, dt, lib_bwd)
    del qkv, q, k, v, do, qkv_t, parts, views, o_t, lse_t, o_v, do_v, lib_fwd, lib_bwd
    torch.cuda.empty_cache()
    int8_lines()


if __name__ == "__main__":
    main()
