"""Card checks of row 17, the W8A8 MLP kernel (``csrc/fused_mlp_int8.cu``),
beyond its comparison with the plain version.

1. Its arithmetic against the IEEE forms it stands in for, bit for bit,
   over 2**32 hashed samples: the fast quotient (``div_fast``) against
   ``__fdiv_rn``; the codes (``quant``: the fast quotient of a row scale
   split by a power of 2, rounded by an add of 1.5 * 2**23) against the
   replaced kernel's ``rintf``, clamp and conversion, ties included; the
   sigmoid GELU's fast form against ``gelu<1>`` of ``common.cuh`` (where it
   gives 0 the exact value must be under 1.5e-11); and the premise of pass
   1's filter: on g >= 0 a value more than 2**-16 below another has no
   larger f32 GELU (either form), and on g < 0 |GELU| < 0.171.
2. The elementwise bound: the kernel's SASS (``cuobjdump``), the
   instructions of pass 1's loop (without the branch that takes every
   value's GELU, which the filter rarely enters) and of pass 2's, each over
   the hidden values a thread handles in it: instructions a hidden element,
   and their time at the card's issue rate (132 SMs x 4 schedulers x 32
   lanes at the maximum SM clock) for 36008 rows and hidden 4D: the
   function's bound (one pass 2), and at D=768, where pass 2 runs once a
   half of the output columns, the kernel's own issue time.
3. Where a block's time goes: a copy of the kernel with ``clock64`` stamps
   at its phases (x landed, the first row and the rest of x's codes, pass
   1, pass 2, the residual's wait, the epilogue, y's store), run at 36008
   rows, D=768, 384 and 192, both GELUs, on random codes; the mean cycles a
   block, and the stamped kernel's ms (CUDA events, 20 calls). At D=768
   "pass 2" spans both column passes and the first one's epilogue, and "y
   store" the second's (the residual read and y written in device memory).

    python3 tools/int8_mlp_checks_torch.py [--no-stamps]

It builds them with nvcc into ``intentbev_torch/_build/checks`` and imports
no JAX. A mismatch exits nonzero.
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
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")

DIVCHECK = r"""
#include <cstdio>
#include KERNEL_SRC

typedef unsigned long long u64;

__device__ u64 mix(u64 z) {  // splitmix64
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}
// a random sign, mantissa and exponent in [lo, hi)
__device__ float rand_exp(u64 h, float lo, float hi) {
  const float u = (h & 0xffffff) / 16777216.f;
  const float m = 1.f + ((h >> 24) & 0x7fffff) / 8388608.f;
  const float v = exp2f(lo + (hi - lo) * u) * m;
  return (h >> 63) ? -v : v;
}
__device__ float unit(u64 h) { return (h >> 40) / 16777216.f; }  // in [0, 1)

__global__ void check(u64 n, u64 seed, u64* bad) {
  u64 local[4] = {0, 0, 0, 0};
  const u64 step = (u64)gridDim.x * blockDim.x;
  for (u64 i = blockIdx.x * (u64)blockDim.x + threadIdx.x; i < n; i += step) {
    const u64 h1 = mix(seed ^ (2 * i)), h2 = mix(seed ^ (2 * i + 1));
    // 1. quotients with |a| in [2^-40, 2^47], b in [2^-34, 2^40]
    const float a = rand_exp(h1, -40.f, 47.f), b = fabsf(rand_exp(h2, -34.f, 40.f));
    if (__float_as_uint(div_fast(a, b, recip(b))) != __float_as_uint(__fdiv_rn(a, b))) ++local[0];
    // 2. the codes of |a| <= 128 s, s in [2^-34, 2^100], against the
    //    replaced kernel's form (IEEE quotient, rintf, clamp, F2I), ties too
    const float s = fabsf(rand_exp(h2 ^ 0x5555, -34.f, 100.f));
    const float a2 = (h1 & 3) == 0
                         ? s * ((float)((int)(h1 % 255) - 127) + 0.5f)
                         : fminf(fmaxf(rand_exp(h1 ^ h2, -60.f, 8.f) * (s * 0x1p-8f), -128.f * s),
                                 128.f * s);
    const unsigned want =
        (unsigned)__float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(a2, s)), -127.f), 127.f)) & 0xFFu;
    if (quant(a2, row_scale(s)) != want) ++local[1];
    // 3. the sigmoid GELU on g in [-64, 64] (uniform) and near 0 (log-uniform)
    const float g = (h2 & 1) ? (unit(h1) - 0.5f) * 128.f : rand_exp(h1 >> 1, -50.f, 6.f);
    const float hf = gelu_fast<1>(g), he = gelu<1>(g);
    if (hf == 0.f ? fabsf(he) >= 1.5e-11f : __float_as_uint(hf) != __float_as_uint(he)) ++local[2];
    if (hf == 0.f && he != 0.f) ++local[3];  // replaced by 0 (counted, allowed)
    // 4. pass 1's filter: on g >= 0 a value more than 2^-16 below g2 has no
    //    larger f32 GELU (either form); on g < 0 |GELU| < 0.171
    const float g2 = (h1 & 1) ? unit(h2) * 64.f : fabsf(rand_exp(h2 >> 1, -45.f, 6.f));
    const float thr = g2 - fabsf(g2) * 0x1p-16f;
    const float g1 = (h1 & 2) ? nextafterf(thr, 0.f) : thr * unit(h1);
    if (g1 < thr && g1 >= 0.f &&
        (gelu_fast<1>(g1) > gelu_fast<1>(g2) || gelu_fast<0>(g1) > gelu_fast<0>(g2)))
      ++local[2];
    const float gn = -fabsf(rand_exp(h1 >> 2, -40.f, 7.f));
    if (fabsf(gelu_fast<1>(gn)) >= 0.171f || fabsf(gelu_fast<0>(gn)) >= 0.171f) ++local[2];
  }
  for (int k = 0; k < 4; ++k) atomicAdd(&bad[k], local[k]);
}

int main() {
  u64* bad;
  cudaMallocManaged(&bad, 4 * sizeof(u64));
  for (int k = 0; k < 4; ++k) bad[k] = 0;
  const u64 n = 1ull << 32;
  check<<<132 * 16, 256>>>(n, 12345, bad);
  const cudaError_t e = cudaDeviceSynchronize();
  printf("divcheck: %llu samples, err %d; quotient mismatches %llu, code mismatches %llu, "
         "GELU mismatches or filter faults %llu (zeroed where allowed %llu)\n",
         n, (int)e, bad[0], bad[1], bad[2], bad[3]);
  return (e != cudaSuccess || bad[0] || bad[1] || bad[2]) ? 1 : 0;
}
"""

HARNESS = r"""
#include <cstdio>
__device__ unsigned long long g_stamp[1024][2][10];  // block, consumer, stamp
#define STAMP(i)                                                         \
  do {                                                                   \
    if (threadIdx.x % 128 == 0 && threadIdx.x < 256)                     \
      g_stamp[blockIdx.x][threadIdx.x / 128][i] = clock64();             \
  } while (0)
#include KERNEL_SRC

__device__ float uhash(size_t z) {  // in [0, 1)
  z = (z ^ (z >> 31)) * 0x7fb5d329728ea185ull;
  z = (z ^ (z >> 27)) * 0x81dadef4bc2dd44dull;
  return ((z ^ (z >> 33)) & 0xffffff) / 16777216.f;
}

// rows of varied scale, uniform codes in [-127, 127], small scales and biases
__global__ void fill(bf16* x, bf16* res, int8_t* w1, int8_t* w2, float* s1, float* b1,
                     float* s2, float* b2, int rows, int d, int hid) {
  const size_t i0 = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = i0; i < (size_t)rows * d; i += step) {
    const float scale = expf(2.f * (uhash(i / d * 7 + 1) - 0.5f));
    x[i] = __float2bfloat16((uhash(3 * i) - 0.5f) * 3.4f * scale);
    res[i] = __float2bfloat16((uhash(3 * i + 1) - 0.5f) * 3.4f);
  }
  for (size_t i = i0; i < (size_t)hid * d; i += step) {
    w1[i] = (int8_t)(int)(254.f * uhash(5 * i + 2) - 127.f);
    w2[i] = (int8_t)(int)(254.f * uhash(5 * i + 3) - 127.f);
  }
  for (size_t i = i0; i < (size_t)hid; i += step) {
    s1[i] = 1e-3f * (1 + uhash(7 * i));
    b1[i] = 0.1f * (uhash(7 * i + 1) - 0.5f);
  }
  for (size_t i = i0; i < (size_t)d; i += step) {
    s2[i] = 5e-4f * (1 + uhash(11 * i));
    b2[i] = 0.1f * (uhash(11 * i + 1) - 0.5f);
  }
}

int main() {
  const int rows = 36008, nb = (rows + 63) / 64;
  const char* names[9] = {"x landed", "row 0", "rows 1-7", "x sync", "pass 1", "pass 2",
                          "residual wait", "epilogue math", "y store"};
  static unsigned long long st[1024][2][10];
  for (int d : {768, 384, 192}) {
    const int hid = 4 * d;
    bf16 *x, *res, *y;
    int8_t *w1, *w2;
    float *s1, *b1, *s2, *b2;
    cudaMalloc(&x, rows * d * 2);
    cudaMalloc(&res, rows * d * 2);
    cudaMalloc(&y, rows * d * 2);
    cudaMalloc(&w1, hid * d);
    cudaMalloc(&w2, hid * d);
    cudaMalloc(&s1, hid * 4);
    cudaMalloc(&b1, hid * 4);
    cudaMalloc(&s2, d * 4);
    cudaMalloc(&b2, d * 4);
    fill<<<1024, 256>>>(x, res, w1, w2, s1, b1, s2, b2, rows, d, hid);
    for (int mode : {1, 0}) {
      auto call = [&]() {
        return ibk_fused_mlp_int8(x, w1, s1, b1, w2, s2, b2, res, y, rows, d, hid, mode, 0);
      };
      const int err = call();
      cudaDeviceSynchronize();
      cudaEvent_t a, b;
      cudaEventCreate(&a);
      cudaEventCreate(&b);
      cudaEventRecord(a);
      for (int it = 0; it < 20; ++it) call();
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      printf("D=%d %s: %.4f ms (err %d, %s)\n", d, mode ? "sigmoid" : "erf", ms / 20, err,
             cudaGetErrorString(cudaGetLastError()));
      cudaMemcpyFromSymbol(st, g_stamp, sizeof(st));
      printf("   cycles a block (mean):");
      for (int k = 0; k < 9; ++k) {
        double t = 0;
        for (int bi = 0; bi < nb; ++bi)
          for (int c = 0; c < 2; ++c) t += (double)(st[bi][c][k + 1] - st[bi][c][k]) / (2 * nb);
        printf(" %s %.0f;", names[k], t);
      }
      printf("\n");
    }
    cudaFree(x);
    cudaFree(res);
    cudaFree(y);
    cudaFree(w1);
    cudaFree(w2);
    cudaFree(s1);
    cudaFree(b1);
    cudaFree(s2);
    cudaFree(b2);
  }
  return 0;
}
"""


# (anchor in the kernel source, text, before or after it): the stamps
STAMPS = (
    ("  hopper::setmaxnreg_inc<CONSUMER_REGS>();\n", "  STAMP(0);\n", False),
    ("  hopper::mbar_wait(xfull, 0);\n", "  STAMP(1);\n", False),
    ("      if (lane == 0) xsc[r] = sc;\n", "      if (rr == 0) STAMP(2);\n", False),
    ("  // xq is read by wgmma, and TMA writes over the rows of x once every warp\n",
     "  STAMP(3);\n", True),
    ("  const float xs_a = xsc[ra], xs_b = xsc[rb];\n", "  STAMP(4);\n", False),
    ("  // 3. pass 2, once a column pass:", "  STAMP(5);\n", True),
    ("    // 4. epilogue of the column pass:", "    STAMP(6);\n", True),
    ("      hopper::mbar_wait(rfull, 0);\n", "      STAMP(7);\n", False),
    ("      hopper::fence_proxy_async();\n      both();\n      if (tid == 0) {",
     "      STAMP(8);\n", True),
    ("        hopper::bulk_wait_read();  // the stores have read the tile\n",
     "      }\n      {\n        STAMP(9);\n", False),
    # two column passes (D=768): the epilogue in device memory
    ("      const bool in_a = row0 + ra < n_rows", "      STAMP(7);\n      STAMP(8);\n", True),
    ("    }\n  }\n}\n\n// W1q [hidden, D]", "      STAMP(9);\n", True),
)


def stamped_source() -> str:
    """The kernel source with clock64 stamps at its phases."""
    s = (CSRC / "fused_mlp_int8.cu").read_text()
    for anchor, text, before in STAMPS:
        if s.count(anchor) != 1:
            sys.exit(f"int8_mlp_checks_torch: the kernel source has changed near {anchor!r}")
        s = s.replace(anchor, text + anchor if before else anchor + text)
    return s


def elementwise_bound(nvcc: str, out: Path, clock_mhz: float) -> None:
    """Instructions a hidden element from the SASS of each instance, and the
    time at the issue rate."""
    obj = out / "kernel.o"
    subprocess.run([nvcc, *FLAGS, "-c", "-o", str(obj), str(CSRC / "fused_mlp_int8.cu")],
                   check=True, capture_output=True)
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(obj)],
                          check=True, capture_output=True, text=True).stdout
    issue = 132 * 4 * 32 * clock_mhz * 1e6  # thread-instructions a second
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"mlp_int8_fwd_kernelILi(\d+)ELi(\d)", func.split("\n")[0])
        if not m:
            continue
        d, gelu = int(m.group(1)), ("erf", "sigmoid")[int(m.group(2))]
        lines = [ln for ln in func.split("\n") if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
        addr = [int(re.match(r"\s*/\*([0-9a-f]+)\*/", ln).group(1), 16) for ln in lines]
        at = {a: i for i, a in enumerate(addr)}
        loops = []  # (instructions, in the all-values branch) of each loop with fc1
        for i, ln in enumerate(lines):
            b = re.search(r"@!?U?P\w+\s+BRA\s+0x([0-9a-f]+)", ln)
            if not b or int(b.group(1), 16) >= addr[i] or int(b.group(1), 16) not in at:
                continue
            body = range(at[int(b.group(1), 16)], i + 1)
            if not any("IGMMA.64x32x32" in lines[j] for j in body):
                continue
            skipped, j = 0, body[0]
            while j <= body[-1]:  # the branch past the vote on the filter
                f = re.search(r"@!?U?P\w+\s+BRA\s+0x([0-9a-f]+)", lines[j])
                if f and "VOTE" in "".join(lines[max(0, j - 4):j]):
                    t = int(f.group(1), 16)
                    if t > addr[j] and t in at:
                        skipped += at[t] - j - 1
                        j = at[t]
                        continue
                j += 1
            loops.append((len(body), skipped))
        # two tiles a loop, 16 values a thread a tile (32 columns x 64 rows / 128)
        per = [(n - k) / 32 for n, k in loops[:2]]
        elems = 36008 * 4 * d
        passes2 = 2 if d == 768 else 1  # the kernel's column passes of pass 2
        print(json.dumps({"D": d, "gelu": gelu, "pass1_loop": loops[0], "pass2_loop": loops[1],
                          "instructions_a_hidden_element": [round(v, 1) for v in per],
                          "total": round(sum(per), 1),
                          "elementwise_bound_ms": round(elems * sum(per) / issue * 1e3, 4),
                          "kernel_issue_ms": round(
                              elems * (per[0] + passes2 * per[1]) / issue * 1e3, 4),
                          "clock_mhz": clock_mhz}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-stamps", action="store_true", help="only the arithmetic checks")
    args = ap.parse_args()

    from intentbev_torch.ops._build import BUILD_DIR, _nvcc

    nvcc = _nvcc()
    out = BUILD_DIR / "checks"
    out.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    clock = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, check=True).stdout.split()[0])
    jobs = {"divcheck": (DIVCHECK, CSRC / "fused_mlp_int8.cu")}
    if not args.no_stamps:
        (out / "mlp_int8_stamped.cu.inc").write_text(stamped_source())
        jobs["stamps"] = (HARNESS, out / "mlp_int8_stamped.cu.inc")
    procs = {}
    for name, (src, kernel) in jobs.items():
        (out / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *FLAGS, f"-I{CSRC}", f'-DKERNEL_SRC="{kernel}"', "-o",
             str(out / name), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    elementwise_bound(nvcc, out, clock)  # while those build
    failed = False
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc {name} failed:\n{log}")
        run = subprocess.run([str(out / name)], capture_output=True, text=True, timeout=600)
        print(run.stdout, end="", flush=True)
        failed |= run.returncode != 0
    if failed:
        sys.exit("int8_mlp_checks_torch: a check failed")


if __name__ == "__main__":
    main()
