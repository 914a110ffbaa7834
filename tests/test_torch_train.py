"""The port's training step and its parts against the JAX package, on the CPU.

Same inputs from a numpy seed on both sides, f32. Tolerances:

- voxelize, dropout mask, host augmentation copies, target assignment:
  identical (same IEEE operations, integer results);
- point/GT augmentation and ``encode_boxes``: 1e-5 absolute (cos, sin,
  atan2 and log of two libraries differ in the last ulp);
- loss terms, BatchNorm output and statistics, AdamW: 1e-5 relative;
- an encoder block's output and gradients with injected drop-path gates,
  and the whole step (loss terms, every gradient mapped through
  ``from_flax``, the new BatchNorm statistics): 1e-4 of each tensor's
  largest value (f32 sums in another order through 2 blocks, the fusion
  stage and the loss). Both run under the kernel switches whose training
  structures differ (``fuse_ln_dense``, ``use_fused_layernorm=False``,
  ``use_fused_mlp=False``) and with none, on the flash path (where the
  JAX model pads the tokens to its flash block and masks the padded keys).

The step's random draws cannot be matched across frameworks, so the test
re-derives the JAX step's ``rng_aug``/``rng_loss`` split, computes the patch
dropout's and the intention drop's draws from it, and passes them to the
port's step; drop-path rates are 0 there, and the gates are tested at block
level with injected gate vectors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from intentbev import configs as jcfg  # noqa: E402
from intentbev import train as jtrain  # noqa: E402
from intentbev.bev import augment as jaug  # noqa: E402
from intentbev.bev.voxelize import dequantize_points as jdequant  # noqa: E402
from intentbev.bev.voxelize import voxelize_packed as jvoxelize  # noqa: E402
from intentbev.boxes.anchors import generate_anchors  # noqa: E402
from intentbev.boxes.codec import encode_boxes as jencode  # noqa: E402
from intentbev.losses import assign_targets as jassign  # noqa: E402
from intentbev.losses import detection_intention_loss as jloss  # noqa: E402
from intentbev.models import build_model  # noqa: E402
from intentbev.models.blocks import ResidualStage as JResidualStage  # noqa: E402
from intentbev.models.vit import EncoderBlock as JEncoderBlock  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.bev import augment as taug  # noqa: E402
from intentbev_torch.bev.voxelize import dequantize_points, voxelize_packed  # noqa: E402
from intentbev_torch.boxes.codec import encode_boxes  # noqa: E402
from intentbev_torch.losses import assign_targets, detection_intention_loss  # noqa: E402
from intentbev_torch.models import IntentNetViT  # noqa: E402
from intentbev_torch.models.blocks import ResidualStage  # noqa: E402
from intentbev_torch.models.vit import EncoderBlock, train_ops  # noqa: E402
from intentbev_torch.train import (PlateauScheduler, StepDraws, make_optimizer,  # noqa: E402
                                   make_train_step)
from intentbev_torch.weights import from_flax  # noqa: E402

GRID_KW = dict(height_px=64, width_px=96, lidar_height_channels=4, lidar_sweeps=2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel, name):
    """max|got - want| <= rel * max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * max(np.abs(want).max(), 1e-30), \
        f"{name}: max|d| {err} vs max|want| {np.abs(want).max()}"


def _points(rng, b, s, p, grid):
    pts = np.zeros((b, s, p, 4), np.float32)
    pts[..., 0] = rng.uniform(grid.bev_x_min - 3, grid.bev_x_max + 3, (b, s, p))
    pts[..., 1] = rng.uniform(grid.bev_y_min - 3, grid.bev_y_max + 3, (b, s, p))
    pts[..., 2] = rng.uniform(-2.5, 4.2, (b, s, p))
    pts[..., 3] = rng.uniform(-5, 255, (b, s, p))
    return pts, rng.uniform(size=(b, s, p)) < 0.9


def _gt(rng, b, g):
    boxes = np.zeros((b, g, 5), np.float32)
    boxes[..., 0] = rng.uniform(-2, 10, (b, g))
    boxes[..., 1] = rng.uniform(-8, 8, (b, g))
    boxes[..., 2] = rng.uniform(1.5, 3, (b, g))
    boxes[..., 3] = rng.uniform(3, 6, (b, g))
    boxes[..., 4] = rng.uniform(-3, 3, (b, g))
    return boxes, rng.integers(0, 8, (b, g)).astype(np.int32), rng.uniform(size=(b, g)) < 0.7


def test_voxelize_matches_jax(rng):
    """Points in and out of the grid and the z range, invalid ones, and the
    i16 transport encoding."""
    grid = jcfg.GridConfig(**GRID_KW)
    pts, valid = _points(rng, 2, 2, 3000, grid)
    want = np.stack([np.asarray(jvoxelize(jnp.asarray(p), jnp.asarray(v), grid))
                     for p, v in zip(pts, valid)])
    got = voxelize_packed(_t(pts), _t(valid), tcfg.GridConfig(**GRID_KW)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 1000
    q = np.clip(np.round(pts * [100, 100, 100, 1]), -32767, 32767).astype(np.int16)
    np.testing.assert_array_equal(dequantize_points(_t(q)).numpy(),
                                  np.asarray(jdequant(jnp.asarray(q))))


def test_augment_points_gt_matches_jax(rng):
    b = 4
    pts, _ = _points(rng, b, 2, 500, jcfg.GridConfig(**GRID_KW))
    boxes, intents, valid = _gt(rng, b, 8)
    aug = np.array([[-1, 0.2, 1.03], [1, -0.25, 0.97], [-1, 0, 1], [1, 0, 1]], np.float32)
    want = jax.vmap(jaug.augment_points_gt)(*map(jnp.asarray, (pts, boxes, intents, valid, aug)))
    got = taug.augment_points_gt(*map(_t, (pts, boxes, intents, valid, aug)))
    _close(got[0].numpy(), want[0], 1e-6, "points")  # |p| <= 80 m: 1e-6 * 80
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_host_augmentation_copies_identical():
    cfg = jcfg.AugmentConfig()
    a = jaug.draw_aug_params(cfg, np.random.default_rng(3), 64)
    b = taug.draw_aug_params(tcfg.AugmentConfig(), np.random.default_rng(3), 64)
    np.testing.assert_array_equal(a, b)
    for row in a[:8]:
        np.testing.assert_array_equal(jaug.aug_linear_matrix(row), taug.aug_linear_matrix(row))
    np.testing.assert_array_equal(jaug.IDENTITY_AUG, taug.IDENTITY_AUG)
    np.testing.assert_array_equal(jaug._FLIP_INTENT_TABLE_NP, taug.FLIP_INTENT_TABLE)


def _jax_dropout_draws(keys, cfg, h, w):
    """The random numbers ``intentbev.bev.augment.dropout_keep_mask`` draws
    from each key, as the port's DropoutDraws."""
    m = cfg.dropout_num_patches[1]
    lo, hi = cfg.dropout_patch_px
    rows = []
    for key in keys:
        kd = jax.random.split(key, 2 + 5 * 4)
        do = bool(jax.random.bernoulli(kd[0], float(cfg.dropout_prob)))
        num = int(jax.random.randint(kd[1], (), cfg.dropout_num_patches[0], m + 1))
        per = []
        for j in range(m):
            kj = kd[2 + j * 4: 2 + (j + 1) * 4]
            ph = int(jax.random.randint(kj[0], (), lo, hi + 1))
            pw = int(jax.random.randint(kj[1], (), lo, hi + 1))
            r0 = int(jax.random.randint(kj[2], (), 0, max(1, h - ph + 1)))
            c0 = int(jax.random.randint(kj[3], (), 0, max(1, w - pw + 1)))
            per.append((ph, pw, r0, c0))
        rows.append((do, num, per))
    per = torch.tensor([r[2] for r in rows], dtype=torch.long)  # [B, m, 4]
    return taug.DropoutDraws(torch.tensor([r[0] for r in rows]),
                             torch.tensor([r[1] for r in rows], dtype=torch.long),
                             *per.unbind(-1))


def jax_image_draws(key, cfg, b, h, w):
    """The random numbers ``intentbev.bev.augment.batched_augment_bev`` draws
    from ``key`` for a batch of ``b``, as the port's (ImageAugDraws,
    DropoutDraws): each sample's key split six ways, flip, rotation
    (Bernoulli, then the angle), scale (Bernoulli, then the factor), then
    the dropout's key."""
    rows, drop_keys = [], []
    for k in jax.random.split(key, b):
        k_flip, k_rot_p, k_rot_a, k_scl_p, k_scl_s, k_drop = jax.random.split(k, 6)
        rows.append((bool(jax.random.bernoulli(k_flip, float(cfg.flip_prob))),
                     bool(jax.random.bernoulli(k_rot_p, float(cfg.rotate_prob))),
                     np.float32(jax.random.uniform(k_rot_a, (), minval=cfg.rotate_range_deg[0],
                                                   maxval=cfg.rotate_range_deg[1])),
                     bool(jax.random.bernoulli(k_scl_p, float(cfg.scale_prob))),
                     np.float32(jax.random.uniform(k_scl_s, (), minval=cfg.scale_range[0],
                                                   maxval=cfg.scale_range[1]))))
        drop_keys.append(k_drop)
    cols = list(zip(*rows))
    image = taug.ImageAugDraws(torch.tensor(cols[0]), torch.tensor(cols[1]),
                               torch.tensor(np.array(cols[2])), torch.tensor(cols[3]),
                               torch.tensor(np.array(cols[4])))
    return image, _jax_dropout_draws(drop_keys, cfg, h, w)


def test_dropout_mask_from_jax_draws():
    cfg = jcfg.AugmentConfig(dropout_prob=0.7)
    h, w = 64, 96
    keys = jax.random.split(jax.random.key(5), 6)
    want = np.stack([np.asarray(jaug.dropout_keep_mask(k, cfg, h, w)) for k in keys])
    got = taug.dropout_keep_mask(_jax_dropout_draws(keys, cfg, h, w), h, w).numpy()
    np.testing.assert_array_equal(got, want)
    assert (~got).any() and got.all(axis=(1, 2)).any()  # some drop, some keep all
    draws = taug.draw_dropout(tcfg.AugmentConfig(dropout_prob=1.0), h, w, 4,
                              torch.Generator().manual_seed(0), "cpu")
    assert ((draws.ph >= 20) & (draws.ph <= 50) & (draws.r0 + draws.ph <= h)).all()
    assert (~taug.dropout_keep_mask(draws, h, w)).any(axis=(1, 2)).all()


def test_encode_boxes_matches_jax(rng):
    gt, _, _ = _gt(rng, 3, 50)
    anchors, _, _ = _gt(rng, 3, 50)
    np.testing.assert_allclose(encode_boxes(_t(gt), _t(anchors)).numpy(),
                               np.asarray(jencode(jnp.asarray(gt), jnp.asarray(anchors))),
                               atol=1e-5, rtol=0)


def _loss_case(rng):
    """Sample 0 has no GT; in sample 1 a 3.4 m square GT box sits on an
    anchor centre (best IoU 0.54, between the thresholds: force-matched),
    the rest random."""
    cfg = jcfg.tiny_test_config()
    anchors = generate_anchors(cfg.grid, cfg.anchors)
    b, g, n = 2, 8, anchors.shape[0]
    boxes, intents, valid = _gt(rng, b, g)
    valid[0] = False
    boxes[1, 0] = [*anchors[n // 2, :2], 3.4, 3.4, 0.0]
    valid[1, 0] = True
    intents[1, :3] = [0, 6, 2]  # a dominant class, another, a kept one
    logits = [rng.normal(0, 1, (b, n, k)).astype(np.float32) for k in (1, 6, 8)]
    u = rng.uniform(size=b * n).astype(np.float32)
    return cfg, anchors, boxes, intents, valid, logits, u


def test_loss_matches_jax(rng):
    cfg, anchors, boxes, intents, valid, logits, u = _loss_case(rng)
    ja = jassign(*map(jnp.asarray, (anchors, boxes, intents, valid)), cfg.loss)
    ta = assign_targets(*map(_t, (anchors, boxes, intents, valid)), tcfg.tiny_test_config().loss)
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja.cls_targets))
    np.testing.assert_array_equal(ta[2].numpy(), np.asarray(ja.intent_targets))
    np.testing.assert_allclose(ta[1].numpy(), np.asarray(ja.box_targets), atol=1e-5, rtol=0)
    assert not (np.asarray(ja.cls_targets)[0] == 1).any()  # no GT: all negative
    assert (np.asarray(ja.cls_targets)[1] == 1).any()      # force-match acted

    key = jax.random.key(7)
    jax_u = np.asarray(jax.random.uniform(key, (u.size,)))

    def jl(*lg):
        return jloss(*lg, *map(jnp.asarray, (anchors, boxes, intents, valid)), cfg.loss, key)

    want = jl(*map(jnp.asarray, logits))
    want_g = jax.grad(lambda *lg: jl(*lg)["loss"], argnums=(0, 1, 2))(*map(jnp.asarray, logits))
    leaves = [_t(a).requires_grad_(True) for a in logits]
    got = detection_intention_loss(*leaves, *map(_t, (anchors, boxes, intents, valid)),
                                   tcfg.tiny_test_config().loss, _t(jax_u))
    got["loss"].backward()
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k].detach()), float(v), rtol=1e-5, err_msg=k)
    for name, leaf, w in zip(("cls", "box", "intent"), leaves, want_g):
        _close(leaf.grad.numpy(), w, 1e-5, name)


def test_loss_with_intention_weights_matches_jax(rng):
    """Random intention class weights with the dominant-class drop off: the
    loss terms and the logits' gradients against JAX's (f32, 1e-6); the
    same call without the weights must differ (the control)."""
    cfg, anchors, boxes, intents, valid, logits, u = _loss_case(rng)
    jl_cfg = dataclasses.replace(cfg.loss, apply_intention_downsampling=False)
    tl_cfg = dataclasses.replace(tcfg.tiny_test_config().loss,
                                 apply_intention_downsampling=False)
    w = rng.uniform(0.05, 1.0, 8).astype(np.float32)
    w /= w.sum()
    key = jax.random.key(7)

    def jl(*lg):
        return jloss(*lg, *map(jnp.asarray, (anchors, boxes, intents, valid)), jl_cfg, key,
                     intention_class_weights=jnp.asarray(w))

    want = jl(*map(jnp.asarray, logits))
    want_g = jax.grad(lambda *lg: jl(*lg)["loss"], argnums=(0, 1, 2))(*map(jnp.asarray, logits))
    leaves = [_t(a).requires_grad_(True) for a in logits]
    args = (*map(_t, (anchors, boxes, intents, valid)), tl_cfg, _t(u))
    got = detection_intention_loss(*leaves, *args, intention_class_weights=_t(w))
    got["loss"].backward()
    assert float(want["num_pos_anchors"]) > 0
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k].detach()), float(v), rtol=1e-6, err_msg=k)
    for name, leaf, g in zip(("cls", "box", "intent"), leaves, want_g):
        _close(leaf.grad.numpy(), g, 1e-6, name)
    unweighted = detection_intention_loss(*map(_t, logits), *args)
    assert abs(float(unweighted["intent_loss"]) - float(want["intent_loss"])) \
        > 1e-2 * abs(float(want["intent_loss"]))
    # with the drop on, the weights are ignored, as in JAX
    on = detection_intention_loss(*map(_t, logits), *map(_t, (anchors, boxes, intents, valid)),
                                  tcfg.tiny_test_config().loss, _t(u),
                                  intention_class_weights=_t(w))
    off = detection_intention_loss(*map(_t, logits), *map(_t, (anchors, boxes, intents, valid)),
                                   tcfg.tiny_test_config().loss, _t(u))
    assert float(on["intent_loss"]) == float(off["intent_loss"])


def test_bn_training_statistics(rng):
    """A fusion stage in training mode: output and the new batch stats."""
    x = rng.normal(0.3, 1.5, (2, 6, 10, 12)).astype(np.float32)
    model = JResidualStage(planes=16, num_blocks=2, stride=1, kernel_size=3)
    variables = model.init(jax.random.key(0), jnp.asarray(x), train=True)
    bs = jax.tree_util.tree_map(lambda a: a + 0.5, variables["batch_stats"])
    want, upd = model.apply({"params": variables["params"], "batch_stats": bs},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
    stage = ResidualStage(12, 16, 2, 1, 3)
    stage.load_state_dict(from_flax({"params": variables["params"], "batch_stats": bs}))
    stage.train()
    got = stage(_t(x))
    _close(got.detach().numpy(), want, 1e-5, "output")
    state = stage.state_dict()
    for k, v in from_flax({"batch_stats": upd["batch_stats"]}).items():
        if k.endswith(("running_mean", "running_var")):
            _close(state[k].numpy(), v.numpy(), 1e-5, k)


def test_adamw_matches_optax(rng):
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in (("w", (5, 7)), ("b", (7,)))}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    cfg = jcfg.default_vit_config()
    tx = optax.adamw(cfg.train.learning_rate, weight_decay=cfg.train.weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    opt = make_optimizer(list(tp.values()), tcfg.default_vit_config())
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = _t(g[k])
        opt.step()
    for k in params:
        _close(tp[k].detach().numpy(), jp[k], 1e-6, k)


def test_plateau_scheduler_matches_jax():
    metrics = [3.0, 2.5, 2.6, 2.6, 2.7, 2.8, 2.4, 2.5, 2.5, 2.5, 2.5, 2.5]
    a, b = jtrain.PlateauScheduler(1e-4, 0.1, 3), PlateauScheduler(1e-4, 0.1, 3)
    assert [a.step(m) for m in metrics] == [b.step(m) for m in metrics]
    a.start_phase(2e-5)
    b.start_phase(2e-5)
    assert [a.step(m) for m in metrics] == [b.step(m) for m in metrics]
    assert a.state() == b.state()


# name: ViTBackboneConfig switches of the training structures
SWITCHES = {"default": {}, "ln_dense": dict(fuse_ln_dense=True),
            "unfused_ln": dict(use_fused_layernorm=False),
            "unfused_mlp": dict(use_fused_mlp=False)}


def _vit_switches(vit, name):
    return dataclasses.replace(vit, use_flash_attention=True, **SWITCHES[name])


@pytest.mark.parametrize("name", list(SWITCHES))
def test_encoder_block_with_gates_matches_jax(rng, monkeypatch, name):
    """Injected per-sample drop-path gates (0 or 1/keep) for the attention
    and the MLP branch; forward and every gradient."""
    b, t, d = 3, 40, 32
    x = rng.normal(0, 1, (b, t, d)).astype(np.float32)
    dy = rng.normal(0, 1, (b, t, d)).astype(np.float32)
    gates = [np.array(g, np.float32) / 0.9 for g in ([1, 0, 1], [0, 1, 1])]
    calls = iter(gates)
    monkeypatch.setattr(JEncoderBlock, "_drop_path_gate",
                        lambda self, x_: jnp.broadcast_to(jnp.asarray(next(calls))[:, None],
                                                          x_.shape[:-1]))
    cfg = _vit_switches(tcfg.tiny_test_config().vit, name)
    blk = JEncoderBlock(dim=d, num_heads=2, mlp_ratio=4.0, qkv_bias=True,
                        drop_path_rate=0.1, use_flash=True, fused_ln=cfg.use_fused_layernorm,
                        fuse_ln_dense=cfg.fuse_ln_dense, fused_mlp=cfg.use_fused_mlp)
    params = blk.init(jax.random.key(0), jnp.asarray(x), True)["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.key(1), a.shape), params)

    def loss(p, x_):
        return jnp.sum(blk.apply({"params": p}, x_, False) * jnp.asarray(dy))

    calls = iter(gates)
    want = blk.apply({"params": params}, jnp.asarray(x), False)
    calls = iter(gates)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    port = EncoderBlock(d, 2, 4.0, True, torch.float32)
    port.load_state_dict(from_flax({"params": params}))
    xt = _t(x).requires_grad_(True)
    y = port.forward_unchained(xt, train_ops(False), "erf", cfg, tuple(_t(g) for g in gates))
    _close(y.detach().numpy(), want, 1e-5, "y")
    (y * _t(dy)).sum().backward()
    _close(xt.grad.numpy(), gx, 1e-4, "dx")
    named = dict(port.named_parameters())
    for k, v in from_flax({"params": gp}).items():
        _close(named[k].grad.numpy(), v.numpy(), 1e-4, k)


def _step_configs(name):
    jc = jcfg.tiny_test_config()
    kw = dict(vit=dataclasses.replace(_vit_switches(jc.vit, name), drop_path_rate=0.0),
              augment=dataclasses.replace(jc.augment, dropout_prob=1.0))
    tc = tcfg.tiny_test_config()
    return (dataclasses.replace(jc, **kw),
            dataclasses.replace(
                tc, vit=dataclasses.replace(_vit_switches(tc.vit, name), drop_path_rate=0.0),
                augment=dataclasses.replace(tc.augment, dropout_prob=1.0)))


@pytest.mark.parametrize("name", list(SWITCHES))
def test_train_step_matches_jax(rng, name):
    """One step on tiny_test_config (drop-path 0, patch dropout always on):
    the loss terms, every gradient and the new BatchNorm statistics against
    the JAX step's math; the JAX step's own metrics and batch stats too."""
    check_train_step(rng, *_step_configs(name))


def check_train_step(rng, jc, tc, port_kw=None, jax_cache=None, aug_params=True):
    """One step of the JAX config ``jc`` and its port copy ``tc`` (the
    checks of :func:`test_train_step_matches_jax`); ``port_kw``: more
    arguments of the port's ``IntentNetViT``. ``jax_cache``: a dict, filled
    and reused, of what the JAX side computes alike for one config and
    batch whatever the flash backward's form: the initial train state and
    the jitted step's metrics (forward values; each is a compile of its
    own). ``aug_params=False``: the batch carries none, so both steps take
    the image-space augmentation (the port's with JAX's draws)."""
    g = jc.grid
    b, s, p, n_gt = 2, g.lidar_sweeps, 1500, jc.loss.max_gt_boxes
    pts, valid = _points(rng, b, s, p, g)
    pts[..., 3] = np.round(pts[..., 3])
    boxes, intents, gt_valid = _gt(rng, b, n_gt)
    batch = {
        "points": pts, "points_valid": valid,
        "map_bev": (rng.uniform(size=(b, g.height_px, g.width_px, g.map_channels))
                    < 0.05).astype(np.float32),
        "gt_boxes": boxes, "gt_intentions": intents, "gt_valid": gt_valid,
        "aug_params": np.array([[-1, 0, 1.04], [1, 0, 0.96]], np.float32),
    }
    if not aug_params:
        del batch["aug_params"]
    anchors = generate_anchors(g, jc.anchors)

    model = build_model(jc, train_mode=True)
    tx = jtrain.make_optimizer(jc)
    cache = {} if jax_cache is None else jax_cache
    key = ("state", repr(jc))
    if key not in cache:  # a host copy: the jitted step donates its state
        cache[key] = jax.tree_util.tree_map(
            np.asarray, jtrain.init_train_state(model, jc, tx, jax.random.key(0)))
    state = jax.tree_util.tree_map(jnp.asarray, cache[key])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng_step = jax.random.key(1)

    # the JAX step's math, with the gradients it does not return
    r = jax.random.fold_in(rng_step, state.step)
    rng_aug, rng_loss, rng_drop = jax.random.split(r, 3)
    lidar, map_bev, gtb, gti = jtrain._augmented_inputs(
        jbatch, rng_aug, jc.augment, g, jnp.float32)

    def loss_fn(params):
        out, upd = model.apply({"params": params, "batch_stats": state.batch_stats}, lidar,
                               map_bev, train=True, mutable=["batch_stats"],
                               rngs={"dropout": rng_drop})
        lo = jloss(*out, jnp.asarray(anchors), gtb, gti, jbatch["gt_valid"], jc.loss, rng_loss)
        return lo["loss"], (lo, upd["batch_stats"])

    (_, (want, want_bs)), want_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    variables = jax.tree_util.tree_map(np.asarray, variables)
    key = ("metrics", repr(jc), *(v.tobytes() for v in batch.values()))
    if key not in cache:
        cache[key] = jtrain.make_train_step(model, jc, jnp.asarray(anchors), tx)(
            state, jbatch, rng_step)[1]
    step_metrics = cache[key]

    intent_u = _t(np.asarray(jax.random.uniform(rng_loss, (b * anchors.shape[0],))))
    if aug_params:
        draws = StepDraws(_jax_dropout_draws(jax.random.split(rng_aug, b), jc.augment,
                                             g.height_px, g.width_px), intent_u)
    else:
        image, dropout = jax_image_draws(rng_aug, jc.augment, b, g.height_px, g.width_px)
        draws = StepDraws(dropout, intent_u, image)
    port = IntentNetViT(tc.vit, tc.heads, dtype=torch.float32, **(port_kw or {}))
    port.load_state_dict(from_flax(variables))
    step = make_train_step(port, tc, _t(anchors), make_optimizer(port.parameters(), tc))
    got = step({k: _t(v) for k, v in batch.items()}, draws=draws)

    assert float(want["num_pos_anchors"]) > 0
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(got[k]), float(step_metrics[k]), rtol=1e-4, err_msg=k)
    named = dict(port.named_parameters())
    want_grads = from_flax({"params": want_g})
    assert set(want_grads) == set(named)
    for k, v in want_grads.items():
        _close(named[k].grad.numpy(), v.numpy(), 1e-4, k)
    state_dict = port.state_dict()
    for k, v in from_flax({"batch_stats": want_bs}).items():
        if k.endswith(("running_mean", "running_var")):
            _close(state_dict[k].numpy(), v.numpy(), 1e-4, k)
