"""The ViT at two head layouts whose head dims the port's flash kernels took
only with their head-dim-128 instance and zero-filled head columns, at depth
2 on the tiny grid, against the JAX package on the CPU:

- D=96 in 2 heads of 48: the heads do not pair into 128 lanes, so the
  attention takes the BHTD entries (JAX's packed entry falls back to its
  BHTD kernels);
- D=128 in 1 head of 128: the packed entries (one head fills the 128 lanes).

The JAX parameters cross by ``from_flax``; the model is served end to end as
``tests/test_torch_slice.py`` serves the tiny config (logits 1e-4, f32
summation order; the same Detections, boxes to 1e-4 and 1e-5 relative) and
takes one train step as ``tests/test_torch_train.py`` does (every gradient
to 1e-4 of its largest value). Which entries it reaches is counted. The
kernels themselves at these head dims are held against JAX's in
``tests/test_torch_flash_head_dims.py``.
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

# (embed, heads, the entries the attention takes)
LAYOUTS = {"2x48": (96, 2, "bhtd"), "1x128": (128, 1, "packed")}


def _cfg(cfgmod, layout):
    base = cfgmod.tiny_test_config()
    embed, heads, _ = LAYOUTS[layout]
    return dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, use_flash_attention=True, embed_dim=embed, num_heads=heads))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_serves_like_jax(layout):
    setup = serve_setup(_cfg(jcfg, layout))
    check_from_flax(*setup[:2])
    check_serving(*setup, box_rtol=1e-5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_train_step_matches_jax(rng, layout):
    def step_cfg(c):
        embed, heads, _ = LAYOUTS[layout]
        return dataclasses.replace(
            c, vit=dataclasses.replace(_vit_switches(c.vit, "default"), drop_path_rate=0.0,
                                       embed_dim=embed, num_heads=heads),
            augment=dataclasses.replace(c.augment, dropout_prob=1.0))

    check_train_step(rng, step_cfg(jcfg.tiny_test_config()), step_cfg(tcfg.tiny_test_config()))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_attention_takes_the_entries_of_its_layout(rng, monkeypatch, layout):
    """Counted: a serving forward runs one forward of the layout's family a
    block and stream, a training pass also its backward; the other
    family's entries never."""
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
    cfg = _cfg(tcfg, layout)
    g = cfg.grid
    model = IntentNetViT(cfg.vit, cfg.heads)
    model.load_state_dict(init_params(cfg, seed=0))
    bev = torch.from_numpy(
        rng.uniform(0, 1, (2, g.height_px, g.width_px, g.lidar_total_channels)).astype(np.float32))
    mp = torch.from_numpy(
        (rng.uniform(size=(2, g.height_px, g.width_px, g.map_channels)) < 0.05)
        .astype(np.float32))
    blocks = 2 * cfg.vit.depth
    fwd, bwd = {"bhtd": ("flash_attention_fwd_plain", "flash_attention_bwd_plain"),
                "packed": ("flash_attention_packed_plain",
                           "flash_attention_packed_bwd_plain")}[LAYOUTS[layout][2]]
    with torch.no_grad():
        model.eval()(bev, mp)
    assert calls == {fwd: blocks}
    calls.clear()
    out = model.train()(bev, mp, torch.Generator().manual_seed(0))
    sum(o.sum() for o in out).backward()
    assert calls == {fwd: blocks, bwd: blocks}
