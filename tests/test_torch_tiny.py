"""The ViT-Ti width (embed 192, 3 heads of 64, MLP ratio 4), the width
``intentbev/import_torch.py:235`` reads for a timm ``vit_tiny`` checkpoint,
at depth 2 on the tiny grid, against the JAX package on the CPU.

Its 3 heads of 64 do not pair into 128 lanes, so every attention takes the
BHTD entries (``intentbev_torch/ops/flash_attention.py``) where the JAX
model's flash path falls back to ``intentbev/ops/flash_attention.py``. The
JAX parameters cross by ``from_flax``; the model is served end to end as
``tests/test_torch_slice.py`` serves the tiny config (logits 1e-4, f32
summation order; the same Detections, boxes to 1e-4 or 1e-5 relative) and
takes one train step as ``tests/test_torch_train.py`` does (every gradient
to 1e-4 of its largest value). Which entries it reaches is counted.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from intentbev import configs as jcfg  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.models import IntentNetViT, init_params  # noqa: E402
from test_torch_slice import check_from_flax, check_serving, serve_setup  # noqa: E402
from test_torch_train import _vit_switches, check_train_step  # noqa: E402

TINY = dict(embed_dim=192, num_heads=3)  # ViT-Ti's width; depth 2 from the tiny config


def _tiny(cfgmod, **vit_kw):
    base = cfgmod.tiny_test_config()
    return dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, use_flash_attention=True, **TINY, **vit_kw))


@pytest.fixture(scope="module")
def tiny_setup():
    return serve_setup(_tiny(jcfg))


def test_tiny_from_flax_covers_the_model(tiny_setup):
    check_from_flax(*tiny_setup[:2])


def test_tiny_serves_like_jax(tiny_setup):
    # the random heads decode boxes of up to ~200 px (exp of the deltas),
    # where f32 summation noise through 192-wide blocks reaches 6e-4
    # absolute, 4e-6 relative: boxes also to 1e-5 relative
    check_serving(*tiny_setup, box_rtol=1e-5)


def test_tiny_train_step_matches_jax(rng):
    def step_cfg(c):
        return dataclasses.replace(
            c, vit=dataclasses.replace(_vit_switches(c.vit, "default"), drop_path_rate=0.0,
                                       **TINY),
            augment=dataclasses.replace(c.augment, dropout_prob=1.0))

    check_train_step(rng, step_cfg(jcfg.tiny_test_config()), step_cfg(tcfg.tiny_test_config()))


def test_tiny_attention_takes_the_bhtd_entries(rng, monkeypatch):
    """Counted: a serving forward runs the BHTD forward once per block and
    stream, a training step also its backward; the packed entries never."""
    tfa = importlib.import_module("intentbev_torch.ops.flash_attention")
    tfp = importlib.import_module("intentbev_torch.ops.flash_packed")
    calls = {}
    for mod, name in ((tfa, "flash_attention_fwd_plain"), (tfa, "flash_attention_bwd_plain"),
                      (tfp, "flash_attention_packed_plain"),
                      (tfp, "flash_attention_packed_bwd_plain")):
        def wrap(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrap)
    cfg = _tiny(tcfg)
    g = cfg.grid
    model = IntentNetViT(cfg.vit, cfg.heads)
    model.load_state_dict(init_params(cfg, seed=0))
    bev = torch.from_numpy(
        rng.uniform(0, 1, (2, g.height_px, g.width_px, g.lidar_total_channels)).astype(np.float32))
    mp = torch.from_numpy(
        (rng.uniform(size=(2, g.height_px, g.width_px, g.map_channels)) < 0.05)
        .astype(np.float32))
    blocks = 2 * cfg.vit.depth
    with torch.no_grad():
        model.eval()(bev, mp)
    assert calls == {"flash_attention_fwd_plain": blocks}
    calls.clear()
    out = model.train()(bev, mp, torch.Generator().manual_seed(0))
    sum(o.sum() for o in out).backward()
    assert calls == {"flash_attention_fwd_plain": blocks, "flash_attention_bwd_plain": blocks}
