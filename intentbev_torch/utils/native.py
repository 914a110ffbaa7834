"""ctypes binding of the C++ host library's chunk builder.

Builds ``cpp/intentbev_host.cpp`` with g++ into ``intentbev_torch/_build``
(keyed by a hash of the source) on first use and binds ``ib_build_chunks``.
The port has no numpy fallback for the chunk builder, so a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

HOST_SRC = Path(__file__).resolve().parents[2] / "cpp" / "intentbev_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def build() -> Path:
    """Compile the host library if this source hash has no build yet."""
    if not HOST_SRC.is_file():
        raise RuntimeError(f"host library source missing: {HOST_SRC}")
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + HOST_SRC.read_bytes())
    out_dir = BUILD_DIR / f"host-{h.hexdigest()[:16]}"
    lib = out_dir / "libintentbev_host.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libintentbev_host.so.{os.getpid()}.tmp"
    res = subprocess.run(["g++", *GXX_FLAGS, str(HOST_SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)  # atomic against a concurrent builder
    return lib


def host_lib() -> ctypes.CDLL:
    """The loaded host library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, f64, ptr = ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
            lib.ib_build_chunks.restype = i64
            lib.ib_build_chunks.argtypes = [
                ptr, ptr, i64, i64, i64, i64, i64,
                f64, f64, f64, f64, f64, i64, i64, i64, i64,
                ptr, ptr, ptr, ptr, ptr]
            _lib = lib
    return _lib


def build_chunks_native(points: np.ndarray, valid: np.ndarray, grid, *,
                        window: int, cap: int, nb: int, nc: int):
    """One sample's points f32[S, P, 4] + valid bool[S, P] -> (wid, sl, ch,
    val, count, needed_nc); the C++ twin of the numpy chunk builder in
    ``intentbev/ops/voxel_embed.py``."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    vld = np.ascontiguousarray(valid, dtype=np.uint8)
    if pts.ndim != 3 or pts.shape[-1] != 4 or vld.shape != pts.shape[:2]:
        raise ValueError(f"points {pts.shape} / valid {vld.shape}: want [S, P, 4] / [S, P]")
    s, p = vld.shape
    if s != grid.lidar_sweeps:
        raise ValueError(f"{s} sweeps, grid has {grid.lidar_sweeps}")
    wid = np.zeros((nb, nc), np.int32)
    sl = np.zeros((nb, nc, 1, cap), np.int32)
    ch = np.zeros((nb, nc, 1, cap), np.int32)
    val = np.zeros((nb, nc, 1, cap), np.float32)
    count = np.zeros((nb,), np.int32)
    needed = host_lib().ib_build_chunks(
        pts.ctypes.data, vld.ctypes.data, s, p,
        grid.height_px, grid.width_px, grid.lidar_height_channels,
        float(grid.voxel_size_m), float(grid.pixel_offset_x),
        float(grid.pixel_offset_y), float(grid.z_min), float(grid.z_max),
        window, cap, nb, nc,
        wid.ctypes.data, sl.ctypes.data, ch.ctypes.data, val.ctypes.data,
        count.ctypes.data)
    return wid, sl, ch, val, count, int(needed)
