"""A/B variants of row 18's attention kernel (``csrc/flash_int8.cu``) on one
CUDA card: each variant is a copy of the source with one design choice
reverted, built with nvcc into ``intentbev_torch/_build/variants`` (one nvcc
a variant, all started together) and called through its own C entry. The
library's kernel and the variants are timed in turns (CUDA events, 10
calls after one, two rounds) at [8, 4608, 384] with 4501 real keys in 6
heads of 64, 12 of 32 and 3 of 128 (bf16), and each variant's o is held
against the library's bit for bit.

- ``two_consumers_at_64``: 2 consumer warpgroups of 64 query rows at head
  dim 64 (the kernel takes 3 up to head dim 64);
- ``mantissa_i2f``: a score's int32 -> f32 through the mantissa of 1.5 *
  2^23 (an integer add and an f32 subtract) in place of one conversion;
- ``four_stages``: a ring of 4 slots in place of 3;
- ``fast_exp``: ``__expf`` (ex2.approx of x * log2(e)) in place of ``expf``:
  not the same function, so its o differs; printed with the share of o's
  elements that differ from the library's.

    python3 tools/int8_attention_variants.py

It imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "intentbev_torch" / "csrc"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC")
B, T, SEQ, D = 8, 4608, 4501, 384
BK = 128  # keys a tile

VARIANTS = {  # name -> (text of the kernel source, its replacement)
    "two_consumers_at_64": ("static constexpr int CONSUMERS = DH <= 64 ? 3 : 2;",
                            "static constexpr int CONSUMERS = DH <= 32 ? 3 : 2;"),
    "mantissa_i2f": ("__fmul_rn(__fmul_rn(__int2float_rn(acc), qsc), ks)",
                     "__fmul_rn(__fmul_rn(__fsub_rn(__int_as_float(0x4B400000 + acc), "
                     "12582912.f), qsc), ks)"),
    "four_stages": ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;"),
    "fast_exp": ("expf(__fsub_rn(", "__expf(__fsub_rn("),
}


def main() -> None:
    import torch

    from intentbev_torch.ops._build import BUILD_DIR, _nvcc
    from intentbev_torch.ops.experimental import flash_attention_packed_int8
    from intentbev_torch.ops.flash_packed import pad_len

    if not torch.cuda.is_available():
        sys.exit("int8_attention_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    nvcc, out = _nvcc(), BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "flash_int8.cu").read_text()
    procs = {}
    for name, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            sys.exit(f"int8_attention_variants: the kernel source has changed near {old!r}")
        (out / f"{name}.cu").write_text(src.replace(old, new))
        procs[name] = subprocess.Popen(
            [nvcc, *FLAGS, f"-I{CSRC}", "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    flash_attention_packed_int8(*[torch.zeros(1, 8, 128, device="cuda").bfloat16()] * 3, 2)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        p_, i_ = ctypes.c_void_p, ctypes.c_int
        lib.ibk_flash_int8.argtypes = [p_] * 9 + [i_] * 6 + [ctypes.c_longlong] * 2 + [
            ctypes.c_float, p_]
        libs[name] = lib

    def variant(lib, q, k, v, heads):
        """The wrapper's call of ``ibk_flash_int8`` through another library."""
        dh, tk = D // heads, pad_len(T, BK)
        ws = [torch.empty(B, heads, tk, max(dh, 64), dtype=torch.int8, device="cuda"),
              torch.empty(B, heads, dh, tk, dtype=torch.int8, device="cuda"),
              torch.empty(B, heads, tk, device="cuda"),
              torch.empty(B, heads, tk // BK, device="cuda"),
              torch.empty(B, heads, device="cuda")]
        o = torch.empty(B, T, D, dtype=q.dtype, device="cuda")
        err = lib.ibk_flash_int8(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                 *[w.data_ptr() for w in ws], B, T, SEQ, heads, dh, 0,
                                 q.stride(1), q.stride(0), dh ** -0.5,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"int8_attention_variants: launch failed ({err})")
        return o

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

    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(B, T, 3 * D, generator=gen, device="cuda").bfloat16()
    q, k, v = (qkv[..., i * D:(i + 1) * D] for i in range(3))
    for heads in (6, 12, 3):
        ref = flash_attention_packed_int8(q, k, v, heads, SEQ)
        calls = {"kernel": lambda h=heads: flash_attention_packed_int8(q, k, v, h, SEQ),
                 **{n: (lambda lib=lib, h=heads: variant(lib, q, k, v, h))
                    for n, lib in libs.items()}}
        ms = {n: [] for n in calls}
        for _ in range(2):  # in turns
            for n, fn in calls.items():
                ms[n].append(round(event_ms(fn), 4))
        differ = {n: float((variant(lib, q, k, v, heads) != ref).float().mean())
                  for n, lib in libs.items()}
        print(json.dumps({"shape": f"{heads}x{D // heads}", "ms": ms,
                          "share_of_o_differing": differ}), flush=True)


if __name__ == "__main__":
    main()
