"""The port's copies of the host layer and its box post-processing against
the JAX package's originals, on the same numpy inputs."""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from intentbev.bev import rasterize as jras  # noqa: E402
from intentbev.boxes import anchors as janchors  # noqa: E402
from intentbev.boxes import codec as jcodec  # noqa: E402
from intentbev.boxes import nms as jnms  # noqa: E402
from intentbev.configs import GridConfig, default_vit_config, tiny_test_config  # noqa: E402
from intentbev.bev.voxelize import quantize_points_cm  # noqa: E402
from intentbev.ops import voxel_embed as jve  # noqa: E402
from intentbev.parallel.inference import StreamingInferencer as JStreamingInferencer  # noqa: E402
from intentbev_torch.bev import rasterize as tras  # noqa: E402
from intentbev_torch.boxes import (batched_postprocess, decode_boxes,  # noqa: E402
                                   generate_anchors)
from intentbev_torch.configs import tiny_test_config as t_tiny_test_config  # noqa: E402
from intentbev_torch.models import init_params  # noqa: E402
from intentbev_torch.ops import voxel_embed as tve  # noqa: E402
from intentbev_torch.parallel import StreamingInferencer  # noqa: E402
from intentbev_torch.parallel.inference import build_chunk_transport  # noqa: E402
from intentbev_torch.synthetic import serving_batch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GRID = GridConfig(height_px=80, width_px=96, lidar_height_channels=4, lidar_sweeps=2)
PATCH = 8


def _points(rng, p=1500):
    s = GRID.lidar_sweeps
    pts = np.empty((s, p, 4), np.float32)
    pts[..., 0] = rng.uniform(-8, 14, (s, p))   # spans out of the grid
    pts[..., 1] = rng.uniform(-12, 12, (s, p))
    pts[..., 2] = rng.uniform(-3, 5, (s, p))
    pts[..., 3] = rng.integers(0, 256, (s, p))
    pts[:, 1] = pts[:, 0]  # duplicate cell, other intensity
    pts[:, 1, 3] = 7.0
    return pts, rng.uniform(size=(s, p)) < 0.9


@pytest.mark.parametrize("num_chunks,on_overflow", [(64, "raise"), (8, "drop")])
def test_chunk_build_identical(rng, num_chunks, on_overflow):
    pts, valid = _points(rng)
    want, _ = jve.build_voxel_chunks(pts, valid, GRID, PATCH, num_chunks=num_chunks,
                                     on_overflow=on_overflow, use_native=False)
    got = tve.build_voxel_chunks(pts, valid, GRID, PATCH, num_chunks,
                                 on_overflow=on_overflow)
    for name, a, b in zip(tve.VoxelChunks._fields, got, want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_chunk_overflow_raises(rng):
    pts, valid = _points(rng)
    with pytest.raises(ValueError, match="chunks"):
        tve.build_voxel_chunks(pts, valid, GRID, PATCH, 8)


@pytest.mark.parametrize("integral", [True, False])
def test_pack_and_decode_match_jax(rng, integral):
    pts, valid = _points(rng)
    if not integral:
        pts[..., 3] += 0.25
    samples = [tve.build_voxel_chunks(pts, valid, GRID, PATCH, 64),
               tve.build_voxel_chunks(pts[:, :100], valid[:, :100], GRID, PATCH, 32)]
    stacked = tve.stack_voxel_chunks(samples)
    want_stack = jve.stack_voxel_chunks(samples)
    packed = tve.pack_chunk_transport(stacked)
    want_packed = jve.pack_chunk_transport(want_stack)
    for name, a, b in zip(tve.VoxelChunks._fields, packed, want_packed):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    got = tve.decode_chunk_transport(tve.chunks_to_device(packed, "cpu"))
    want = jve.decode_chunk_transport(jve.VoxelChunks(*(jnp.asarray(a) for a in want_packed)))
    for name, a, b, orig in zip(tve.VoxelChunks._fields, got, want, stacked):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        np.testing.assert_array_equal(a.numpy(), orig, err_msg=name)


def test_i16_points_build_the_same_chunks_as_jax():
    """The loader's i16 points (cm, raw intensity) through the JAX
    inferencer's ``build_chunks`` and the port's ``build_chunk_transport``
    and ``StreamingInferencer.build_chunks``: identical, non-empty chunks
    (the port dequantizes before the host build, as JAX does)."""
    cfg = t_tiny_test_config()
    pts, valid, _ = serving_batch(cfg.grid, 2, 600, seed=3)
    pts16 = quantize_points_cm(pts)
    assert pts16.dtype == np.int16
    want = JStreamingInferencer.build_chunks(
        SimpleNamespace(cfg=tiny_test_config(), num_chunks=64), pts16, valid)
    inf = StreamingInferencer(cfg, init_params(cfg, seed=0), "cpu", transport="chunks",
                              num_chunks=64)
    assert int(np.asarray(want.count).sum()) > 0
    for got in (build_chunk_transport(pts16, valid, cfg.grid, cfg.vit.patch_size, 64),
                inf.build_chunks(pts16, valid)):
        for name in want._fields:
            np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                          err_msg=name)


def test_pack_rejects_channels_past_ten_bits(rng):
    pts, valid = _points(rng)
    chunks = tve.build_voxel_chunks(pts, valid, GRID, PATCH, 64)
    ch = np.asarray(chunks.ch).copy()
    ch[0, 0, 0, 0, 0] = 1 << 10
    with pytest.raises(ValueError, match="u16"):
        tve.pack_chunk_transport(chunks._replace(ch=ch))
    with pytest.raises(ValueError, match="packed"):  # unpacked chunks have no decoder
        tve.decode_chunk_transport(tve.chunks_to_device(chunks, "cpu"))


def test_map_transport_matches_jax(rng):
    m = rng.uniform(size=(2, 16, 24, 9)) < 0.3
    packed = tras.pack_map_channels(m)
    np.testing.assert_array_equal(packed, jras.pack_map_channels(m))
    for enc in (packed, m.astype(np.uint8), m.astype(np.float32)):
        got = tras.decode_map_transport(torch.from_numpy(enc), 9, torch.float32)
        want = jras.decode_map_transport(jnp.asarray(enc), 9, jnp.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), m.astype(np.float32))


@pytest.mark.parametrize("cfg", [default_vit_config(), tiny_test_config()])
def test_generate_anchors_identical(cfg):
    np.testing.assert_array_equal(generate_anchors(cfg.grid, cfg.anchors),
                                  janchors.generate_anchors(cfg.grid, cfg.anchors))


def test_decode_boxes_matches_jax(rng):
    anchors = generate_anchors(tiny_test_config().grid, tiny_test_config().anchors)
    deltas = rng.normal(0, 0.5, (anchors.shape[0], 6)).astype(np.float32)
    got = decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors))
    want = jcodec.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("logit_mean,few", [(-1.0, False), (-6.0, True)])
def test_batched_postprocess_matches_jax(rng, logit_mean, few):
    """Many confident anchors (caps bind) and few (top-k fill slots tie)."""
    cfg = tiny_test_config()
    anchors = generate_anchors(cfg.grid, cfg.anchors)
    n = anchors.shape[0]
    cls_l = rng.normal(logit_mean, 1.5, (3, n, 1)).astype(np.float32)
    box = rng.normal(0, 0.3, (3, n, 6)).astype(np.float32)
    intent = rng.normal(0, 1, (3, n, 8)).astype(np.float32)
    kw = dict(confidence_threshold=0.1, nms_iou_threshold=0.2,
              max_pre_nms=cfg.eval.max_pre_nms, max_detections=cfg.eval.max_detections)
    got = batched_postprocess(*(torch.from_numpy(a) for a in (cls_l, box, intent, anchors)),
                              **kw)
    want = jnms.batched_postprocess(*(jnp.asarray(a) for a in (cls_l, box, intent, anchors)),
                                    **kw)
    for name in ("valid", "intentions", "num_conf", "num_kept"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.boxes_xywha.numpy(), np.asarray(want.boxes_xywha),
                               atol=1e-5)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6)
    assert got.valid.any()
    assert bool((got.num_conf < kw["max_detections"]).all()) == few


def test_port_imports_no_jax():
    code = ("import sys, intentbev_torch, intentbev_torch.models, "
            "intentbev_torch.parallel, intentbev_torch.weights; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax')]; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
