"""Card checks of row 18, the int8 attention kernel (``csrc/flash_int8.cu``),
beyond its comparison with the plain version.

1. The elementwise bound: the SASS (``cuobjdump``) of each instance of
   ``flash_int8_kernel``, the instructions of pass 1's main loop (no
   exponential) and of pass 2's (the exponentials), without the blocks the
   loops jump over on every tile but the last (the key mask), each over the
   scores a thread converts in it (its I2F instructions): instructions a
   score, and their time at the card's issue rate (132 SMs x 4 schedulers x
   32 lanes at the maximum SM clock) for B * H * T * seq_len scores at the
   attention sublayer's shape.
2. Where a block's time goes: a copy of the kernel with ``clock64`` stamps
   (thread 0 of each consumer warpgroup) after q's codes, pass 1, pass 2
   and the epilogue, run at [8, 4608, 384] with 4501 real keys in 6 heads of
   64, 12 of 32, 24 of 16 and 3 of 128 (bf16): the mean cycles of each phase
   a warpgroup, the cycles of a 128-key tile in each pass (all consumers
   together), and their share of the issue slots the loops' instructions
   need (pass 1 and 2 instructions a score x the scores of a tile).

    python3 tools/int8_attention_checks_torch.py

It builds with nvcc into ``intentbev_torch/_build/checks`` and imports no
JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "intentbev_torch" / "csrc"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
B, T, SEQ, D = 8, 4608, 4501, 384
HEADS = (6, 12, 24, 3)  # head dims 64, 32, 16, 128
BK = 128  # keys a tile

# (anchor, text, insert before the anchor) of the stamped copy
STAMPS = (
    ("namespace {\n", "__device__ long long* g_stamps = nullptr;\n"
     "extern \"C\" int ibk_set_stamps(void* p) {\n"
     "  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n\n", True),
    ("  const int row_g = q0 + 64 * wg + 16 * warp + g;  // rows row_g and row_g + 8\n",
     "  long long* stp = g_stamps ? g_stamps + (((size_t)(blockIdx.z * gridDim.y + blockIdx.y) *\n"
     "      gridDim.x + blockIdx.x) * CONSUMERS + wg) * 8 : nullptr;\n"
     "  auto stamp = [&](int k_) { if (stp && tid % 128 == 0) stp[k_] = clock64(); };\n"
     "  stamp(0);\n", False),
    ("  // 2. pass 1: the row max", "  stamp(1);\n", True),
    ("  // 3. pass 2: the same scores", "  stamp(2);\n", True),
    ("  // 4. o = (f32(pq.vq)", "  stamp(3);\n", True),
)


def stamped_source() -> str:
    s = (CSRC / "flash_int8.cu").read_text()
    for anchor, text, before in STAMPS:
        if s.count(anchor) != 1:
            sys.exit(f"int8_attention_checks_torch: the kernel source has changed near {anchor!r}")
        s = s.replace(anchor, text + anchor if before else anchor + text)
    # the epilogue's end: after the last store loop of the kernel
    tail = "          *reinterpret_cast<const uint4*>(ost + r * L::OLD + c);\n  }\n}\n"
    if s.count(tail) != 1:
        sys.exit("int8_attention_checks_torch: the kernel's epilogue has changed")
    return s.replace(tail, tail[:-2] + "  stamp(4);\n}\n")


def loop_counts(nvcc: str, out: Path) -> dict[int, tuple[float, float]]:
    """Head dim -> (pass 1, pass 2) SASS instructions a score, bf16 instances."""
    obj = out / "flash_int8.o"
    subprocess.run([nvcc, *FLAGS, "-c", "-o", str(obj), str(CSRC / "flash_int8.cu")],
                   check=True, capture_output=True)
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(obj)],
                          check=True, capture_output=True, text=True).stdout
    per = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"flash_int8_kernelILi(\d+)E13__nv_bfloat16", func.split("\n")[0])
        if not m:
            continue
        lines = [ln for ln in func.split("\n") if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
        addr = [int(re.match(r"\s*/\*([0-9a-f]+)\*/", ln).group(1), 16) for ln in lines]
        at = {a: i for i, a in enumerate(addr)}
        loops = []  # (instructions run on a tile but the last, scores, has exponentials)
        for i, ln in enumerate(lines):
            b = re.search(r"@!?U?P\w+\s+BRA\s+0x([0-9a-f]+)", ln)
            if not b or int(b.group(1), 16) >= addr[i] or int(b.group(1), 16) not in at:
                continue
            body = range(at[int(b.group(1), 16)], i + 1)
            if not any("IGMMA" in lines[j] for j in body):
                continue
            run, j = 0, body[0]
            while j <= body[-1]:
                f = re.search(r"@!?U?P\w+\s+BRA\s+0x([0-9a-f]+)", lines[j])
                t = int(f.group(1), 16) if f else -1
                if t in at and j < at[t] <= body[-1] and at[t] - j > 32:  # the mask, skipped
                    run, j = run + 1, at[t]
                    continue
                run, j = run + 1, j + 1
            scores = sum("I2F" in lines[j] for j in body)
            loops.append((run, scores, any("MUFU.EX2" in lines[j] for j in body)))
        p1 = max((lp for lp in loops if not lp[2]), key=lambda lp: lp[1])
        p2 = max((lp for lp in loops if lp[2]), key=lambda lp: lp[1])
        per[int(m.group(1))] = (p1[0] / p1[1], p2[0] / p2[1])
        cvt = sorted({re.search(r"(I2F\S*)", ln).group(1) for ln in lines if "I2F" in ln})
        print(json.dumps({"head_dim": int(m.group(1)), "pass1_loop": p1[:2], "pass2_loop": p2[:2],
                          "conversions": cvt,
                          "instructions_a_score": [round(p1[0] / p1[1], 2),
                                                   round(p2[0] / p2[1], 2)]}), flush=True)
    return per


def main() -> None:
    import torch

    from intentbev_torch.ops._build import BUILD_DIR, _nvcc
    from intentbev_torch.ops.flash_packed import pad_len

    if not torch.cuda.is_available():
        sys.exit("int8_attention_checks_torch: needs a CUDA card")
    nvcc = _nvcc()
    out = BUILD_DIR / "checks"
    out.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    clock = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, check=True).stdout.split()[0])
    (out / "flash_int8_stamped.cu").write_text(stamped_source())
    lib_path = out / "libflash_int8_stamped.so"
    build = subprocess.Popen([nvcc, *FLAGS, "-shared", f"-I{CSRC}", "-o", str(lib_path),
                              str(out / "flash_int8_stamped.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    per = loop_counts(nvcc, out)  # while the stamped copy builds
    log, _ = build.communicate()
    if build.returncode != 0:
        sys.exit(f"nvcc of the stamped copy failed:\n{log}")
    issue = 132 * 4 * 32 * clock * 1e6  # thread-instructions a second
    lib = ctypes.CDLL(str(lib_path))
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.ibk_flash_int8.argtypes = [p_] * 9 + [i_] * 6 + [ctypes.c_longlong] * 2 + [
        ctypes.c_float, p_]
    lib.ibk_set_stamps.argtypes = [p_]
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(B, T, 3 * D, generator=gen, device="cuda").bfloat16()
    q, k, v = (qkv[..., i * D:(i + 1) * D] for i in range(3))
    tk = pad_len(T, BK)
    for heads in HEADS:
        dh = D // heads
        cons = 3 if dh <= 64 else 2  # the kernel's consumer warpgroups (Shape<DH>)
        ws = [torch.empty(B, heads, tk, max(dh, 64), dtype=torch.int8, device="cuda"),
              torch.empty(B, heads, dh, tk, dtype=torch.int8, device="cuda"),
              torch.empty(B, heads, tk, device="cuda"),
              torch.empty(B, heads, tk // BK, device="cuda"),
              torch.empty(B, heads, device="cuda")]
        o = torch.empty(B, T, D, dtype=torch.bfloat16, device="cuda")
        blocks = B * heads * -(-T // (64 * cons))
        st = torch.zeros(blocks * cons * 8, dtype=torch.int64, device="cuda")
        lib.ibk_set_stamps(st.data_ptr())
        err = lib.ibk_flash_int8(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                 *[w.data_ptr() for w in ws], B, T, SEQ, heads, dh, 0,
                                 q.stride(1), q.stride(0), dh ** -0.5,
                                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        lib.ibk_set_stamps(None)
        if err:
            sys.exit(f"int8_attention_checks_torch: launch failed ({err})")
        s = st.view(-1, 8)[:, :5].double()
        phase = (s[:, 1:] - s[:, :-1]).mean(0).tolist()
        tiles = -(-SEQ // BK)
        p1, p2 = per[dh]
        need = [p * 64 * BK / 32 / 4 for p in (p1, p2)]  # a warpgroup's issue cycles a tile
        tile_cycles = [phase[1] / tiles, phase[2] / tiles]
        print(json.dumps({
            "shape": f"{heads}x{dh}", "consumers": cons,
            "cycles_a_warpgroup": {n: round(c) for n, c in zip(
                ("q codes", "pass 1", "pass 2", "epilogue"), phase)},
            "cycles_a_tile": [round(c, 1) for c in tile_cycles],
            "issue_share": [round(cons * n / c, 3) for n, c in zip(need, tile_cycles)],
            "elementwise_bound_ms": round(B * heads * T * SEQ * (p1 + p2) / issue * 1e3, 4),
            "clock_mhz": clock}), flush=True)


if __name__ == "__main__":
    main()
