"""The port's image-space augmentation against the JAX package's, on the CPU.

``intentbev_torch/bev/augment.py::augment_bev`` is JAX's
``batched_augment_bev`` as a function of its draws; the port's train step
takes it for a points batch without ``aug_params``, as
``intentbev/train.py::_augmented_inputs`` does. The port is given the draws
JAX's function makes from a key (``test_torch_train.jax_image_draws``
repeats its splits, Bernoullis and uniforms). Readings, batch of 4 on the
tiny grid (64 x 96, 8 lidar channels, 9 map channels):

- lidar and map in f32 by their relative L2, limit ``F32_REL`` = 2e-5
  (sound readings 0 without a warp, 2.4e-6-3.7e-6 with one: cos and sin of
  two libraries differ in the last ulp, and an ulp of a source row or
  column, ~8e-6 at 64 px, moves the bilinear weights by as much); in bf16
  by the share of elements that differ, limit ``BF16_SHARE`` = 3e-3 (sound
  0-6.3e-4: a tap weight an ulp apart rounds the sample to the other bf16
  neighbour);
- boxes to 1e-6 absolute (sound <= 9.6e-7), intentions exactly.

The control, the rotation applied with the wrong sign of theta, must exceed
both image limits (it reads a relative L2 of 1.16-1.30 and a share of
0.30-0.46). One train step of the tiny ViT on a batch without
``aug_params`` then matches JAX's step (loss terms, every gradient and the
BatchNorm statistics to 1e-4 of each tensor's largest value, as
``tests/test_torch_train.py`` holds the points step), with flip, rotation
and scale each drawn with probability 1 from one-value ranges.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from intentbev import configs as jcfg  # noqa: E402
from intentbev.bev import augment as jaug  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.bev import augment as taug  # noqa: E402
from intentbev_torch.train import takes_image_aug  # noqa: E402
from test_torch_train import (_gt, _vit_switches, check_train_step,  # noqa: E402
                              jax_image_draws)

F32_REL, BF16_SHARE = 2e-5, 3e-3
GRID_KW = dict(height_px=64, width_px=96, lidar_height_channels=4, lidar_sweeps=2)
JGRID, TGRID = jcfg.GridConfig(**GRID_KW), tcfg.GridConfig(**GRID_KW)
B = 4
CASES = {  # AugmentConfig fields; the dropout off unless named
    "identity": dict(flip_prob=0.0, rotate_prob=0.0, scale_prob=0.0),
    "flip": dict(flip_prob=1.0, rotate_prob=0.0, scale_prob=0.0),
    "rotate_scale": dict(flip_prob=0.0, rotate_prob=1.0, scale_prob=1.0, dropout_prob=1.0),
    "mixed": dict(dropout_prob=0.5),  # the default probabilities: some samples warp
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    h, w, c = JGRID.height_px, JGRID.width_px, JGRID.lidar_total_channels
    lidar = ((rng.uniform(size=(B, h, w, c)) < 0.1) * rng.uniform(0.5, 250, (B, h, w, c)))
    mp = (rng.uniform(size=(B, h, w, JGRID.map_channels)) < 0.2).astype(np.float32)
    boxes, intents, valid = _gt(rng, B, 12)
    return lidar.astype(np.float32), mp, boxes, intents, valid


def _jax(case, dtype, seed=0):
    cfg = jcfg.AugmentConfig(**{"dropout_prob": 0.0, **CASES[case]})
    lidar, mp, boxes, intents, valid = _inputs(seed)
    key = jax.random.key(11 + seed)
    out = jaug.batched_augment_bev(jnp.asarray(lidar, dtype), jnp.asarray(mp, dtype),
                                   jnp.asarray(boxes), jnp.asarray(intents),
                                   jnp.asarray(valid), key, cfg, JGRID)
    return [np.asarray(jnp.asarray(o, jnp.float32)) for o in out], key, cfg


def _port(case, dtype, key, jc, flip_theta=False, seed=0):
    lidar, mp, boxes, intents, valid = _inputs(seed)
    image, dropout = jax_image_draws(key, jc, B, TGRID.height_px, TGRID.width_px)
    if flip_theta:  # the control's fault: the rotation's sign
        image = image._replace(angle_deg=-image.angle_deg)
    keep = taug.dropout_keep_mask(dropout, TGRID.height_px, TGRID.width_px)
    out = taug.augment_bev(torch.tensor(lidar).to(dtype), torch.tensor(mp).to(dtype),
                           torch.tensor(boxes), torch.tensor(intents), torch.tensor(valid),
                           image, keep, TGRID)
    return [o.float().numpy() for o in out], image


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _share_bf16(a, b):
    def bf(x):
        return torch.tensor(x).bfloat16()
    return float((bf(a) != bf(b)).float().mean())


@pytest.mark.parametrize("case", list(CASES))
def test_augment_bev_matches_jax(case):
    want, key, jc = _jax(case, jnp.float32)
    got, image = _port(case, torch.float32, key, jc)
    for name, g_, w_ in zip(("lidar", "map"), got[:2], want[:2]):
        assert g_.shape == w_.shape and _rel(g_, w_) < F32_REL, (name, _rel(g_, w_))
    np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[3], want[3])
    warps = image.do_rot | image.do_scale
    if case == "identity":
        assert not warps.any() and not image.do_flip.any()
        np.testing.assert_array_equal(got[0], _inputs(0)[0])
    elif case == "flip":
        assert image.do_flip.all() and not warps.any()
    elif case == "rotate_scale":
        assert warps.all()
    else:
        assert warps.any() and not warps.all()  # identity and warped samples in one batch


@pytest.mark.parametrize("case", ["flip", "rotate_scale", "mixed"])
def test_augment_bev_bf16_matches_jax(case):
    """bf16 lidar and map (the train step's compute dtype): the share of
    the bf16 values that differ."""
    want, key, jc = _jax(case, jnp.bfloat16, seed=1)
    got, _ = _port(case, torch.bfloat16, key, jc, seed=1)
    for name, g_, w_ in zip(("lidar", "map"), got[:2], want[:2]):
        assert _share_bf16(g_, w_) <= BF16_SHARE, (name, _share_bf16(g_, w_))
    np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[3], want[3])


def test_the_control_exceeds_the_limits():
    """theta with the wrong sign moves both readings past their limits."""
    want, key, jc = _jax("rotate_scale", jnp.float32)
    got, _ = _port("rotate_scale", torch.float32, key, jc, flip_theta=True)
    assert _rel(got[0], want[0]) >= F32_REL and _rel(got[1], want[1]) >= F32_REL
    want, key, jc = _jax("rotate_scale", jnp.bfloat16, seed=1)
    got, _ = _port("rotate_scale", torch.bfloat16, key, jc, flip_theta=True, seed=1)
    assert _share_bf16(got[0], want[0]) > BF16_SHARE


def test_draws_follow_the_config():
    cfg = tcfg.AugmentConfig(flip_prob=1.0, rotate_prob=0.0, rotate_range_deg=(5.0, 5.0),
                             scale_prob=0.5, scale_range=(0.9, 1.1))
    d = taug.draw_image_aug(cfg, 400, torch.Generator().manual_seed(0), "cpu")
    assert d.do_flip.all() and not d.do_rot.any() and (d.angle_deg == 5.0).all()
    assert 0.4 < float(d.do_scale.float().mean()) < 0.6
    assert float(d.s.min()) >= 0.9 and float(d.s.max()) < 1.1
    assert takes_image_aug({"points": 0}) and not takes_image_aug({"points": 0, "aug_params": 0})
    assert not takes_image_aug({"chunks": 0})


def test_train_step_without_aug_params_matches_jax(rng):
    """One step of the tiny ViT on a points batch without aug_params:
    flip, a 5 degree rotation and a scale of 1.03 on every sample."""
    fixed = dict(flip_prob=1.0, rotate_prob=1.0, rotate_range_deg=(5.0, 5.0), scale_prob=1.0,
                 scale_range=(1.03, 1.03), dropout_prob=0.0)

    def step_cfg(c):
        return dataclasses.replace(
            c, vit=dataclasses.replace(_vit_switches(c.vit, "default"), drop_path_rate=0.0),
            augment=dataclasses.replace(c.augment, **fixed))

    check_train_step(rng, step_cfg(jcfg.tiny_test_config()), step_cfg(tcfg.tiny_test_config()),
                     aug_params=False)
