"""The port's IntentNetCNN family and chunk train transport against the JAX
package, on the CPU.

Same inputs from a numpy seed on both sides, on ``tiny_test_config()`` and
its 64 x 96 grid (which bands at one patch row, the other banding branch
from the full grid's five). Tolerances:

- ``voxel_fill_bev_plain`` against the Pallas ``voxel_fill_bev`` in
  interpret mode, the host copies (``augment_points_np``,
  ``quantize_points_cm``) and ``stack_chunk_batch`` against the originals:
  identical (the same placements and IEEE operations);
- the fill of the chunk transport against the device voxelizer of the
  points transport: identical cells under identity and flip, at most 8
  boundary cells under rotation (cos/sin of two libraries), as the JAX
  package's own test holds;
- the tiny CNN's logits in eval mode: 1e-4 of each output's largest value
  (f32 convolutions summed in another order); Detections identical in
  their selection, classes and counts, boxes to 1e-4 (relative where the
  decode's exp makes them large), scores to 1e-5;
- whole tiny train steps (CNN over points and chunks, ViT over chunks):
  loss terms, every gradient and the new BatchNorm statistics to 1e-4 of
  each tensor's largest value, as ``tests/test_torch_train.py`` holds the
  ViT step.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev import configs as jcfg  # noqa: E402
from intentbev import train as jtrain  # noqa: E402
from intentbev.bev import augment as jaug  # noqa: E402
from intentbev.bev import voxelize as jvox  # noqa: E402
from intentbev.bev.rasterize import decode_map_transport as jdecode_map  # noqa: E402
from intentbev.boxes.anchors import generate_anchors  # noqa: E402
from intentbev.boxes.nms import batched_postprocess as jpostprocess  # noqa: E402
from intentbev.data.pipeline import _stack_chunks as jstack_chunks  # noqa: E402
from intentbev.losses import detection_intention_loss as jloss  # noqa: E402
from intentbev.models import build_model as jbuild_model  # noqa: E402
from intentbev.ops import voxel_embed as jve  # noqa: E402
from intentbev.parallel.inference import StreamingInferencer as JStreamingInferencer  # noqa: E402
from intentbev.parallel.mesh import create_mesh  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.bev import augment as taug  # noqa: E402
from intentbev_torch.bev import voxelize as tvox  # noqa: E402
from intentbev_torch.data.pipeline import (chunk_batch_to_device,  # noqa: E402
                                           stack_chunk_batch)
from intentbev_torch.models import IntentNetCNN, build_model  # noqa: E402
from intentbev_torch.ops import voxel_embed as tve  # noqa: E402
from intentbev_torch.parallel import StreamingInferencer  # noqa: E402
from intentbev_torch.synthetic import serving_batch  # noqa: E402
from intentbev_torch.train import (StepDraws, chunk_patch_for, make_optimizer,  # noqa: E402
                                   make_train_step)
from intentbev_torch.weights import from_flax  # noqa: E402
from test_torch_train import _close, _gt, _jax_dropout_draws, _t  # noqa: E402

GRID_KW = dict(height_px=64, width_px=96, lidar_height_channels=4, lidar_sweeps=2)
JGRID, TGRID = jcfg.GridConfig(**GRID_KW), tcfg.GridConfig(**GRID_KW)
PATCH = tve.CNN_CHUNK_PATCH
NUM_CHUNKS = 64
AUG_CASES = {
    "identity": [1.0, 0.0, 1.0],
    "flip": [-1.0, 0.0, 1.0],
    "rotate": [1.0, 0.2, 1.0],
    "all": [-1.0, -0.15, 1.03],
}


def _points(rng, s=2, p=2000):
    pts = np.empty((s, p, 4), np.float32)
    pts[..., 0] = rng.uniform(-15, 10, (s, p))
    pts[..., 1] = rng.uniform(-10, 10, (s, p))
    pts[..., 2] = rng.uniform(-2, 3.7, (s, p))
    pts[..., 3] = rng.integers(0, 256, (s, p)).astype(np.float32)
    return pts, rng.uniform(size=(s, p)) < 0.95


def _decoded(chunks_np):
    """numpy chunks -> (JAX decoded chunks, the port's decoded tensors)."""
    packed = tve.pack_chunk_transport(chunks_np)
    j = jve.decode_chunk_transport(jve.VoxelChunks(*map(jnp.asarray, packed)))
    return j, tve.decode_chunk_transport(tve.chunks_to_device(packed, "cpu"))


def _pallas_fill(chunks, dtype):
    """The Pallas fill in interpret mode, under jit (its host-side channel
    assert then sees a tracer, so an out-of-range channel reaches the
    kernel, whose one-hot compare drops it)."""
    fill = jax.jit(lambda c: jve.voxel_fill_bev(
        c, (JGRID.height_px, JGRID.width_px), JGRID.lidar_total_channels, PATCH, dtype=dtype))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fill(chunks).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["two_samples", "full_band", "channel_out_of_range"])
def test_voxel_fill_plain_matches_pallas(rng, case, dtype):
    pts, valid = _points(rng)
    if case == "full_band":  # a dense strip overflows its band: count == nc
        pts[:, :1500, 0] = rng.uniform(0.0, 1.5, 1500)
    nc = 16 if case == "full_band" else NUM_CHUNKS
    samples = [tve.build_voxel_chunks(pts, valid, TGRID, PATCH, nc, on_overflow="drop")]
    if case == "two_samples":
        p2, v2 = _points(rng, p=700)
        samples.append(tve.build_voxel_chunks(p2, v2, TGRID, PATCH, nc, on_overflow="drop"))
    chunks = tve.stack_voxel_chunks(samples)
    if case == "full_band":
        assert (chunks.count == nc).any() and (chunks.count < nc).any()
    c = TGRID.lidar_total_channels
    if case == "channel_out_of_range":  # two real cells whose channel is >= C
        ch = chunks.ch.copy()
        orig = ch[0, 0, 0, 0, :2].copy()
        ch[0, 0, 0, 0, :2] = [c, c + 5]
        chunks = chunks._replace(ch=ch)
    j, t = _decoded(chunks)
    want = _pallas_fill(j, getattr(jnp, dtype))
    got = tve.voxel_fill_bev(t, (TGRID.height_px, TGRID.width_px), c, PATCH,
                             getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert np.count_nonzero(want) > 1000
    if case == "channel_out_of_range":  # dropped: their cells stay empty
        px = int(t.wid[0, 0, 0]) * tve.WINDOW + t.sl[0, 0, 0, 0, :2].numpy()
        assert (t.val[0, 0, 0, 0, :2] > 0).all()
        assert not want[0].reshape(-1, c)[px, orig].any()


@pytest.mark.parametrize("aug", list(AUG_CASES.values()), ids=list(AUG_CASES))
def test_host_copies_identical(rng, aug):
    pts, _ = _points(rng)
    aug = np.asarray(aug, np.float32)
    np.testing.assert_array_equal(taug.augment_points_np(pts, aug),
                                  jaug.augment_points_np(pts, aug))
    far = pts * 500.0  # beyond the i16 range: clipped
    for p in (pts, far):
        q = tvox.quantize_points_cm(p)
        assert q.dtype == np.int16
        np.testing.assert_array_equal(q, jvox.quantize_points_cm(p))


def _samples(rng, n, g):
    out = []
    for _ in range(n):
        pts, valid = _points(rng)
        boxes, intents, gt_valid = _gt(rng, 1, 8)
        out.append(SimpleNamespace(
            points=pts, points_valid=valid,
            map_bev=(rng.uniform(size=(g.height_px, g.width_px, g.map_channels))
                     < 0.1).astype(np.uint8),
            gt_boxes=boxes[0], gt_intentions=intents[0], gt_valid=gt_valid[0]))
    return out


def _port_stack(samples, aug, grid, patch, capacity):
    return stack_chunk_batch(*([getattr(s, f) for s in samples] for f in (
        "points", "points_valid", "map_bev", "gt_boxes", "gt_intentions", "gt_valid")),
        aug, grid, patch, capacity)


def test_stack_chunk_batch_matches_jax(rng):
    samples = _samples(rng, 3, JGRID)
    aug = [np.asarray(a, np.float32) for a in list(AUG_CASES.values())[1:]]
    want = jstack_chunks(samples, aug, JGRID, PATCH, 8)
    got = _port_stack(samples, aug, TGRID, PATCH, 8)
    assert got._fields == want._fields
    for name, a, b in zip(got._fields[1:], got[1:], want[1:]):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name, a, b in zip(tve.VoxelChunks._fields, got.chunks, want.chunks):
        assert a.dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert (np.asarray(want.chunks.count) == 8).all()  # bands of 12 chunks cut to 8


@pytest.mark.parametrize("aug", list(AUG_CASES.values()), ids=list(AUG_CASES))
def test_fill_matches_points_transport(rng, aug):
    """Chunk transport (cm round trip, host augmentation, C++ build, pack,
    fill) against the points transport (i16 points, device augmentation,
    scatter-max voxelizer), cell for cell."""
    samples = _samples(rng, 2, TGRID)
    aug = np.tile(np.asarray(aug, np.float32), (2, 1))
    batch = chunk_batch_to_device(_port_stack(samples, aug, TGRID, PATCH, NUM_CHUNKS), "cpu")
    bev = tve.voxel_fill_bev(tve.decode_chunk_transport(tve.VoxelChunks(*batch["chunks"])),
                             (TGRID.height_px, TGRID.width_px), TGRID.lidar_total_channels,
                             PATCH, torch.float32)
    q = _t(np.stack([tvox.quantize_points_cm(s.points) for s in samples]))
    pts, _, _ = taug.augment_points_gt(tvox.dequantize_points(q), batch["gt_boxes"],
                                       batch["gt_intentions"], batch["gt_valid"], _t(aug))
    want = tvox.voxelize_packed(pts, _t(np.stack([s.points_valid for s in samples])), TGRID)
    mismatch = int((bev != want).sum())
    assert int((want > 0).sum()) > 1000
    assert mismatch == 0 if aug[0, 1] == 0.0 else mismatch <= 8, mismatch


def _cnn_configs(**train_kw):
    jc, tc = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    return (dataclasses.replace(jc, model_family="cnn",
                                train=dataclasses.replace(jc.train, **train_kw)),
            dataclasses.replace(tc, model_family="cnn",
                                train=dataclasses.replace(tc.train, **train_kw)))


@pytest.fixture(scope="module")
def cnn_setup():
    """The tiny JAX CNN with BN running statistics taken from the serving
    batch (as a trained model has them; at init the activations grow
    through every block and saturate the scores) and head kernels scaled up
    so that neighbouring scores differ by far more than the tolerance, and
    the serving batch."""
    jc, tc = _cnn_configs()
    g = jc.grid
    model = jbuild_model(jc)
    pts, valid, mp = serving_batch(tc.grid, 2, 600, seed=1)
    bev = jnp.stack([jvox.voxelize_packed(jnp.asarray(p), jnp.asarray(v), g)
                     for p, v in zip(pts, valid)])
    m = jdecode_map(jnp.asarray(mp), g.map_channels, jnp.float32)
    variables = model.init(jax.random.key(0), bev, m)
    update = jax.jit(lambda v: model.apply(v, bev, m, train=True, mutable=["batch_stats"])[1])
    for _ in range(40):  # running averages (momentum 0.9) to the batch's statistics
        variables = {"params": variables["params"], **update(variables)}
    variables = jax.tree_util.tree_map(np.asarray, variables)
    for head in ("det_head", "intention_head"):
        variables["params"][head]["conv"]["kernel"] = (
            variables["params"][head]["conv"]["kernel"] * 4.0)
    return jc, tc, model, variables, pts, valid, mp


def test_from_flax_covers_the_cnn(cnn_setup):
    _, tc, _, variables = cnn_setup[:4]
    model = IntentNetCNN(tc.cnn, tc.heads)
    state = from_flax(variables)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)  # shapes match


def _assert_same_detections(got, want):
    for name in ("valid", "intentions", "num_conf", "num_kept"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.boxes_xywha, np.asarray(want.boxes_xywha), atol=1e-4,
                               rtol=1e-4)  # exp(box deltas) carries the logits' 1e-4
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-5)
    assert got.valid.any() and (got.num_kept < got.num_conf).all()  # NMS acted


def _jax_logits(model, variables, lidar, mp, g):
    return [np.asarray(a) for a in model.apply(
        variables, lidar, jdecode_map(jnp.asarray(mp), g.map_channels, jnp.float32))]


def test_cnn_forward_matches_jax(cnn_setup):
    """Eval mode on one dense BEV, NHWC and NCHW."""
    jc, tc, model, variables, pts, valid, mp = cnn_setup
    g = jc.grid
    bev = np.stack([np.asarray(jvox.voxelize_packed(jnp.asarray(p), jnp.asarray(v), g))
                    for p, v in zip(pts, valid)])
    want = _jax_logits(model, variables, jnp.asarray(bev), mp, g)
    port = IntentNetCNN(tc.cnn, tc.heads)
    port.load_state_dict(from_flax(variables))
    port.eval()
    with torch.no_grad():
        for lidar in (_t(bev), _t(bev).permute(0, 3, 1, 2)):
            got = port(lidar, _t(mp))
            for name, a, b in zip(("cls", "box", "intent"), got, want):
                _close(a.numpy(), b, 1e-4, name)


def test_cnn_serving_points_matches_jax_inferencer(cnn_setup):
    jc, tc, _, variables, pts, valid, mp = cnn_setup
    want = JStreamingInferencer(jc, variables, mesh=create_mesh(jc.mesh, jax.devices()[:1]),
                                transport="points")(pts, valid, mp)
    inf = StreamingInferencer(tc, from_flax(variables), "cpu", transport="points")
    _assert_same_detections(inf(pts, valid, mp), want)


def test_cnn_serving_chunks_matches_bench_fill(cnn_setup):
    """The chunk transport against ``bench.py``'s CNN chunk line: chunks at
    CNN_CHUNK_PATCH, the Pallas fill, the model, post-processing."""
    jc, tc, model, variables, pts, valid, mp = cnn_setup
    g = jc.grid
    chunks = jve.pack_chunk_transport(jve.stack_voxel_chunks([
        jve.build_voxel_chunks(p, v, g, jve.CNN_CHUNK_PATCH, num_chunks=NUM_CHUNKS,
                               on_overflow="drop")[0] for p, v in zip(pts, valid)]))
    dec = jve.decode_chunk_transport(jve.VoxelChunks(*map(jnp.asarray, chunks)))
    with pltpu.force_tpu_interpret_mode():
        lidar = jve.voxel_fill_bev(dec, (g.height_px, g.width_px), g.lidar_total_channels,
                                   jve.CNN_CHUNK_PATCH, dtype=jnp.float32)
    want = _jax_logits(model, variables, lidar, mp, g)
    ev = jc.eval
    want_det = jpostprocess(*map(jnp.asarray, want), jnp.asarray(generate_anchors(g, jc.anchors)),
                            confidence_threshold=ev.confidence_threshold,
                            nms_iou_threshold=ev.nms_iou_threshold,
                            max_pre_nms=ev.max_pre_nms, max_detections=ev.max_detections)
    inf = StreamingInferencer(tc, from_flax(variables), "cpu", num_chunks=NUM_CHUNKS)
    host = inf.build_chunks(pts, valid)
    for name, a, b in zip(tve.VoxelChunks._fields, host, chunks):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name, a, b in zip(("cls", "box", "intent"), inf.logits(host, mp), want):
        _close(a.numpy(), b, 1e-4, name)
    _assert_same_detections(inf(pts, valid, mp), want_det)


# The tiny CNN's lidar stream has ~3e5 ReLU inputs, and f32 sums in another
# order move them by ~1e-6; an input that close to 0 switches its ReLU on one
# side only, which moves a weight gradient by a few percent. The data of seed
# 0 has one such input (of the 24576 at the last lidar stage's output, 6.7e-7
# in the port, not positive in JAX); seeds 3 and 5 fail too. The data of this
# seed has none, so the step is held to 1e-4.
STEP_SEED = 1


def _step_configs(family, transport):
    kw = dict(model_family=family)
    out = []
    for m in (jcfg, tcfg):
        c = m.tiny_test_config()
        out.append(dataclasses.replace(
            c, **kw, vit=dataclasses.replace(c.vit, drop_path_rate=0.0),
            augment=dataclasses.replace(c.augment, dropout_prob=1.0),
            train=dataclasses.replace(c.train, transport=transport)))
    return out


@pytest.mark.parametrize("family,transport", [("cnn", "points"), ("cnn", "chunks"),
                                              ("vit", "chunks")])
def test_train_step_matches_jax(family, transport):
    """One step on tiny_test_config (patch dropout always on, ViT drop-path
    0): the loss terms, every gradient and the new BatchNorm statistics
    against the JAX step's math. The chunk batches carry a flip, a rotation
    and a scale, applied to the points on the host and to the GT on the
    device."""
    jc, tc = _step_configs(family, transport)
    g = jc.grid
    b = 2
    rng = np.random.default_rng(STEP_SEED)
    samples = _samples(rng, b, g)
    for s in samples:  # integral intensities: the u8 chunk transport is exact
        s.points[..., 3] = np.round(s.points[..., 3])
    common = {
        "map_bev": np.stack([s.map_bev for s in samples]).astype(np.float32),
        "gt_boxes": np.stack([s.gt_boxes for s in samples]),
        "gt_intentions": np.stack([s.gt_intentions for s in samples]),
        "gt_valid": np.stack([s.gt_valid for s in samples]),
    }
    if transport == "chunks":
        aug = [np.asarray(a, np.float32) for a in ([-1, 0.2, 1.04], [1, -0.1, 0.97])]
        cb = jstack_chunks(samples, aug, g, jtrain.chunk_patch_for(jc), NUM_CHUNKS)
        jbatch = {**{k: jnp.asarray(v) for k, v in common.items()},
                  "chunks": jve.VoxelChunks(*map(jnp.asarray, cb.chunks)),
                  "aug_params": jnp.asarray(cb.aug_params)}
        tb = chunk_batch_to_device(_port_stack(samples, aug, tc.grid, chunk_patch_for(tc),
                                               NUM_CHUNKS), "cpu")
        tbatch = {**tb, "map_bev": _t(common["map_bev"])}
    else:
        batch = {**common, "points": np.stack([s.points for s in samples]),
                 "points_valid": np.stack([s.points_valid for s in samples]),
                 "aug_params": np.array([[-1, 0, 1.04], [1, 0, 0.96]], np.float32)}
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        tbatch = {k: _t(v) for k, v in batch.items()}
    anchors = generate_anchors(g, jc.anchors)

    model = jbuild_model(jc, train_mode=True)
    tx = jtrain.make_optimizer(jc)
    state = jtrain.init_train_state(model, jc, tx, jax.random.key(0))
    r = jax.random.fold_in(jax.random.key(1), state.step)
    rng_aug, rng_loss, rng_drop = jax.random.split(r, 3)
    with pltpu.force_tpu_interpret_mode():
        lidar, map_bev, gtb, gti = jtrain._augmented_inputs(
            jbatch, rng_aug, jc.augment, g, jnp.float32, chunk_patch=jtrain.chunk_patch_for(jc))

    def loss_fn(params):
        out, upd = model.apply({"params": params, "batch_stats": state.batch_stats}, lidar,
                               map_bev, train=True, mutable=["batch_stats"],
                               rngs={"dropout": rng_drop})
        lo = jloss(*out, jnp.asarray(anchors), gtb, gti, jbatch["gt_valid"], jc.loss, rng_loss)
        return lo["loss"], (lo, upd["batch_stats"])

    (_, (want, want_bs)), want_g = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})

    draws = StepDraws(
        _jax_dropout_draws(jax.random.split(rng_aug, b), jc.augment, g.height_px, g.width_px),
        _t(np.asarray(jax.random.uniform(rng_loss, (b * anchors.shape[0],)))))
    port = build_model(tc)
    port.load_state_dict(from_flax(variables))
    step = make_train_step(port, tc, _t(anchors), make_optimizer(port.parameters(), tc))
    got = step(tbatch, draws=draws)

    assert float(want["num_pos_anchors"]) > 0
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    named = dict(port.named_parameters())
    want_grads = from_flax({"params": want_g})
    assert set(want_grads) == set(named)
    for k, v in want_grads.items():
        _close(named[k].grad.numpy(), v.numpy(), 1e-4, k)
    state_dict = port.state_dict()
    for k, v in from_flax({"batch_stats": want_bs}).items():
        if k.endswith(("running_mean", "running_var")):
            _close(state_dict[k].numpy(), v.numpy(), 1e-4, k)
