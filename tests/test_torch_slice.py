"""The port's serving slice against the JAX package, end to end on the CPU.

The tiny config with ``use_flash_attention=True`` (the JAX model then pads
its tokens to the flash block and masks keys by ``kv_len``; the port pads
nothing). The JAX model is initialised with its own ``init``, its head
kernels are scaled up so that neighbouring scores differ by far more than
the tolerance, and the same parameters go through ``from_flax`` into the
port. Both sides serve the same points and bit-packed map: the JAX forward
over ``VoxelChunks`` runs its voxel-embed Pallas kernel in interpret mode.
Logits agree to 1e-4 (f32, summation order); the Detections are identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev.bev.rasterize import decode_map_transport  # noqa: E402
from intentbev.boxes.anchors import generate_anchors  # noqa: E402
from intentbev.boxes.nms import batched_postprocess  # noqa: E402
from intentbev.configs import tiny_test_config  # noqa: E402
from intentbev.models import build_model  # noqa: E402
from intentbev.ops import voxel_embed as jve  # noqa: E402
from intentbev_torch.models import IntentNetViT  # noqa: E402
from intentbev_torch.parallel import StreamingInferencer  # noqa: E402
from intentbev_torch.synthetic import serving_batch  # noqa: E402
from intentbev_torch.weights import from_flax  # noqa: E402

NUM_CHUNKS = 64


def serve_setup(cfg):
    """JAX init of ``cfg``'s model (head kernels scaled up), two samples of
    points and map, the JAX logits over chunks and its Detections."""
    g = cfg.grid
    model = build_model(cfg)
    bev0 = jnp.zeros((1, g.height_px, g.width_px, g.lidar_total_channels))
    map0 = jnp.zeros((1, g.height_px, g.width_px, g.map_channels))
    variables = jax.tree_util.tree_map(np.asarray, model.init(jax.random.key(0), bev0, map0))
    for head in ("det_head", "intention_head"):
        variables["params"][head]["conv"]["kernel"] = (
            variables["params"][head]["conv"]["kernel"] * 20.0)
    pts, valid, mp = serving_batch(g, 2, 600, seed=1)

    chunks = jve.stack_voxel_chunks([
        jve.build_voxel_chunks(pts[i], valid[i], g, cfg.vit.patch_size,
                               num_chunks=NUM_CHUNKS, on_overflow="drop")[0]
        for i in range(2)])
    with pltpu.force_tpu_interpret_mode():
        want = model.apply(variables, jve.VoxelChunks(*map(jnp.asarray, chunks)),
                           decode_map_transport(jnp.asarray(mp), g.map_channels,
                                                jnp.float32))
    ev = cfg.eval
    det = batched_postprocess(
        *want, jnp.asarray(generate_anchors(g, cfg.anchors)),
        confidence_threshold=ev.confidence_threshold,
        nms_iou_threshold=ev.nms_iou_threshold,
        max_pre_nms=ev.max_pre_nms, max_detections=ev.max_detections)
    return cfg, variables, pts, valid, mp, [np.asarray(w) for w in want], det


@pytest.fixture(scope="module")
def slice_setup():
    base = tiny_test_config()
    return serve_setup(dataclasses.replace(
        base, vit=dataclasses.replace(base.vit, use_flash_attention=True)))


def check_from_flax(cfg, variables):
    model = IntentNetViT(cfg.vit, cfg.heads)
    state = from_flax(variables)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)  # shapes match


def check_serving(cfg, variables, pts, valid, mp, want, want_det, box_rtol=0.0):
    """The port's StreamingInferencer (CPU, plain versions) against the JAX
    logits and Detections (decoded boxes also to ``box_rtol``)."""
    inf = StreamingInferencer(cfg, from_flax(variables), "cpu", num_chunks=NUM_CHUNKS)
    got = inf.logits(inf.build_chunks(pts, valid), mp)
    for name, a, b in zip(("cls", "box", "intent"), got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-4, err_msg=name)

    det = inf(pts, valid, mp)
    for name in ("valid", "intentions", "num_conf", "num_kept"):
        np.testing.assert_array_equal(getattr(det, name),
                                      np.asarray(getattr(want_det, name)), err_msg=name)
    np.testing.assert_allclose(det.boxes_xywha, np.asarray(want_det.boxes_xywha), atol=1e-4,
                               rtol=box_rtol)
    np.testing.assert_allclose(det.scores, np.asarray(want_det.scores), atol=1e-5)
    assert det.valid.any() and (det.num_kept < det.num_conf).all()  # NMS acted


def test_from_flax_covers_the_model(slice_setup):
    check_from_flax(*slice_setup[:2])


def test_slice_matches_jax(slice_setup):
    check_serving(*slice_setup)
