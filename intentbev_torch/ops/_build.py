"""Build and load the port's CUDA kernel library; count kernel launches.

Every source in ``intentbev_torch/csrc`` compiles in its own ``nvcc``
process, all started together, and one more ``nvcc`` call links the
objects into one shared library with a plain C interface, loaded with
ctypes. The library is built at first CUDA use into
``intentbev_torch/_build`` (listed in ``.gitignore``), under a directory
keyed by a hash of the sources and flags, so a fresh checkout builds it
once and an edited source rebuilds. Nothing here includes PyTorch's
headers, so the build takes seconds.

Each kernel wrapper in ``intentbev_torch.ops`` adds one to its entry of
:data:`launches` where it launches its kernel, and nowhere else; a run can
reset the counts, drive the model and read which kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libintentbev_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

KERNELS = ("voxel_embed", "flash_packed", "fused_ln_mlp", "layernorm",
           "flash_packed_bwd", "fused_ln_mlp_train", "fused_ln_mlp_bwd",
           "layernorm_train", "layernorm_bwd", "voxel_fill", "fused_mlp_int8", "fused_mlp",
           "fused_ln_dense", "patch_embed", "fused_mlp_train", "fused_mlp_bwd",
           "fused_ln_dense_bwd", "flash_attention", "flash_attention_bwd",
           "flash_packed_bwd_split", "flash_packed_bwd_chunked", "flash_int8", "fused_proj",
           "fused_proj_bwd", "flash_packed_fixed", "flash_packed_chunked", "voxel_hits")
launches: dict[str, int] = {name: 0 for name in KERNELS}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
build_seconds: float | None = None  # wall time of this process's nvcc runs


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (
        Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None,
        shutil.which("nvcc"),
    ):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> tuple[list[Path], str]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no kernel sources under {CSRC_DIR}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if this source hash has no build yet;
    returns the library's path."""
    global build_seconds
    srcs, key = _sources()
    out_dir = BUILD_DIR / f"kernels-{key}"
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [out_dir / f"{src.stem}.{pid}.o" for src in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(srcs, objs)]
    failed = []
    for src, proc in zip(srcs, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)  # atomic against a concurrent builder
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "ibk_layernorm": (_P, _P, _P, _P, _I, _I, _F, _P),
    "ibk_fused_ln_mlp": (_P,) * 11 + (_I, _I, _I, _F, _I, _P),
    "ibk_flash_fwd": (_P,) * 5 + (_I,) * 5 + (_L, _L, _F, _I, _I, _P),
    "ibk_voxel_embed": (_P,) * 10 + (_I,) * 8 + (_P,),
    "ibk_voxel_hits": (_P,) * 7 + (_I,) * 7 + (_P,),
    "ibk_layernorm_train": (_P,) * 6 + (_I, _I, _F, _P),
    "ibk_layernorm_bwd": (_P,) * 8 + (_I, _I, _P),
    "ibk_fused_ln_mlp_train": (_P,) * 9 + (_I, _I, _I, _F, _I, _P),
    "ibk_fused_ln_mlp_bwd": (_P,) * 20 + (_I, _I, _I, _F, _I, _P),
    "ibk_flash_bwd": (_P,) * 7 + (_I,) * 5 + (_L, _L, _F, _F, _I, _P),
    "ibk_voxel_fill": (_P,) * 6 + (_I,) * 6 + (_P,),
    "ibk_fused_mlp_int8": (_P,) * 9 + (_I, _I, _I, _I, _P),
    "ibk_fused_mlp": (_P,) * 8 + (_I, _I, _I, _P),
    "ibk_fused_mlp_bwd": (_P,) * 15 + (_I, _I, _I, _P),
    "ibk_fused_ln_dense": (_P,) * 6 + (_I, _I, _I, _F, _I, _P),
    "ibk_fused_ln_dense_bwd": (_P,) * 14 + (_I, _I, _I, _F, _I, _I, _P),
    "ibk_patch_embed": (_P,) * 4 + (_I,) * 6 + (_P,),
    "ibk_flash_attn_fwd": (_P,) * 5 + (_I,) * 5 + (_L,) * 6 + (_F, _P),
    "ibk_flash_attn_bwd": (_P,) * 9 + (_I,) * 5 + (_L,) * 9 + (_F, _P),
    "ibk_flash_int8": (_P,) * 9 + (_I,) * 6 + (_L, _L, _F, _P),
    "ibk_fused_proj": (_P,) * 6 + (_I,) * 3 + (_P,),
    "ibk_fused_proj_bwd": (_P,) * 9 + (_I,) * 4 + (_P,),
}


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            lib.ibk_error_string.argtypes = [ctypes.c_int]
            lib.ibk_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error; else count the launch."""
    if err != 0:
        msg = kernels().ibk_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    launches[name] += 1


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
