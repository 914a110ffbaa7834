"""ctypes binding of the C++ host library.

Builds ``cpp/intentbev_host.cpp`` with g++ into ``intentbev_torch/_build``
(keyed by a hash of the source) on first use and binds the chunk build
``ib_build_chunks`` and the loader's raster and pose primitives
``ib_fill_polygon``, ``ib_draw_polyline`` and ``ib_transform_points`` (the
counterparts of ``intentbev/utils/native.py``). The port has no numpy
fallback for the chunk build, so a failed build raises; the rasterizer
keeps its numpy forms (``bev.rasterize``), and the loader its numpy pose
transform (``geometry.transform_points``).
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
            for name in ("ib_fill_polygon", "ib_draw_polyline"):
                getattr(lib, name).restype = None
                getattr(lib, name).argtypes = [ptr, i64, i64, ptr, i64]
            lib.ib_transform_points.restype = None
            lib.ib_transform_points.argtypes = [ptr, i64, ptr, ptr]
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


def _mask_call(fn, mask: np.ndarray, pts: np.ndarray) -> None:
    mask_c = np.ascontiguousarray(mask, dtype=np.uint8)
    pts_c = np.ascontiguousarray(pts, dtype=np.int32)
    fn(mask_c.ctypes.data, mask.shape[0], mask.shape[1], pts_c.ctypes.data, pts_c.shape[0])
    if mask_c is not mask:
        mask[...] = mask_c


def fill_polygon_native(mask: np.ndarray, pts: np.ndarray) -> None:
    """Even-odd scanline fill of int (col, row) vertices [K, 2] into the
    u8 mask [H, W], in place (``ib_fill_polygon``; fewer than 3 vertices
    draw nothing)."""
    if pts.shape[0] >= 3:
        _mask_call(host_lib().ib_fill_polygon, mask, pts)


def draw_polyline_native(mask: np.ndarray, pts: np.ndarray) -> None:
    """1-px polyline through int (col, row) vertices [K, 2] into the u8
    mask [H, W], in place (``ib_draw_polyline``)."""
    if pts.shape[0] >= 2:
        _mask_call(host_lib().ib_draw_polyline, mask, pts)


def transform_points_native(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """Points [N, >=3] (their xyz in f64) through a 4x4 transform -> f32
    [N, 3] (``ib_transform_points``)."""
    pts = np.ascontiguousarray(points[:, :3], dtype=np.float64)
    m = np.ascontiguousarray(transform, dtype=np.float64)
    out = np.empty((pts.shape[0], 3), dtype=np.float32)
    host_lib().ib_transform_points(pts.ctypes.data, pts.shape[0], m.ctypes.data,
                                   out.ctypes.data)
    return out
