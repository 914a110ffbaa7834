"""The ViT at two head layouts whose head dims the port's flash kernels take
since their chunked and padded-row forms, at depth 2 on the tiny grid,
against the JAX package on the CPU, and the importer at two such head
counts:

- D=256 in 1 head of 256: above 128, the BHTD entries' chunked kernels on
  CUDA (two chunks of 128 output columns);
- D=96 in 8 heads of 12: off a multiple of 8, the BHTD entries over rows
  padded to 16 columns on CUDA (the heads do not pair into 128 lanes).

The JAX parameters cross by ``from_flax``; the model is served end to end as
``tests/test_torch_flash_head_dims_slice.py`` serves it (logits 1e-4; the
same Detections, boxes to 1e-4 and 1e-5 relative) and takes one train step
as ``tests/test_torch_train.py`` does (every gradient to 1e-4 of its largest
value); which entries it reaches is counted. The reference-schema importer
at ``--num_heads 3`` (ViT-B widths: heads of 256) and ``--num_heads 32``
(ViT-S widths: heads of 12) gives JAX's config and parameters, and block
0's attention on the imported qkv weights splits the heads as JAX's does.
The kernels themselves are held against JAX's in
``tests/test_torch_flash_wide_heads.py``.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev import configs as jcfg  # noqa: E402
from intentbev import import_torch as jimp  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch import import_torch as timp  # noqa: E402
from intentbev_torch.models import IntentNetViT, init_params  # noqa: E402
from intentbev_torch.models import vit as tvit  # noqa: E402
from intentbev_torch.weights import from_flax  # noqa: E402
from test_torch_flash_head_dims import LIMITS, _differ  # noqa: E402
from test_torch_import import _cli_configs, _vit_pth  # noqa: E402
from test_torch_slice import check_from_flax, check_serving, serve_setup  # noqa: E402
from test_torch_train import _vit_switches, check_train_step  # noqa: E402

jfp = importlib.import_module("intentbev.ops.flash_packed")

# (embed, heads, the entries the attention takes)
LAYOUTS = {"1x256": (256, 1, "bhtd"), "8x12": (96, 8, "bhtd")}


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
    """Counted: a serving forward runs one BHTD forward a block and stream,
    a training pass also its backward; the packed entries never."""
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
    with torch.no_grad():
        model.eval()(bev, mp)
    assert calls == {"flash_attention_fwd_plain": blocks}
    calls.clear()
    out = model.train()(bev, mp, torch.Generator().manual_seed(0))
    sum(o.sum() for o in out).backward()
    assert calls == {"flash_attention_fwd_plain": blocks, "flash_attention_bwd_plain": blocks}


@pytest.mark.parametrize("model_name,embed,heads", [("vit_base_patch8_224", 768, 3),
                                                    ("vit_small_patch8_224", 384, 32)])
def test_importer_takes_the_head_count_as_jax_does(tmp_path, model_name, embed, heads):
    """A reference-schema checkpoint at the family's widths (depth 1, numpy
    draws) through both CLIs with ``--num_heads``: the same config.json; the
    port's import equals ``from_flax`` of JAX's bit for bit; and block 0's
    attention on its imported qkv weights (x of [1, 16, embed]) splits the
    heads as JAX's Attention does: the port's model entry against JAX's
    ``flash_attention_packed`` (its BHTD kernels in interpret mode) on JAX's
    Dense output, f32, 1e-5 of the largest value."""
    pth = _vit_pth(tmp_path, "ckpt", model_name, embed_dim=embed, depth=1)
    want_cfg, got_cfg = _cli_configs(tmp_path, pth, "--model", "vit", "--num_heads",
                                     str(heads))
    assert got_cfg == want_cfg and got_cfg["vit"]["num_heads"] == heads
    sd = torch.load(pth, weights_only=False)["model_state_dict"]
    layers = tcfg.tiny_test_config().vit.fusion_layers
    jax_vars = jimp.import_vit_state_dict(sd, fusion_layers=layers)
    port_sd = timp.import_vit_state_dict(sd, fusion_layers=layers)
    want = from_flax(jax_vars)
    assert set(port_sd) == set(want)
    for key, val in want.items():
        assert torch.equal(port_sd[key], val), key
    vit_cfg = timp.vit_config_from_state_dict(sd, tcfg.tiny_test_config().vit, num_heads=heads)
    assert (vit_cfg.embed_dim, vit_cfg.num_heads) == (embed, heads)
    x = np.random.default_rng(1).normal(0, 1, (1, 16, embed)).astype(np.float32)
    dense = jax_vars["params"]["backbone"]["vit_lidar"]["block0"]["attn"]["qkv"]
    qkv_j = jnp.asarray(x) @ jnp.asarray(dense["kernel"]) + jnp.asarray(dense["bias"])
    with pltpu.force_tpu_interpret_mode():
        o_j = np.asarray(jfp.flash_attention_packed(*jnp.split(qkv_j, 3, axis=-1), heads))
    w = port_sd["backbone.vit_lidar.blocks.0.attn.qkv.weight"]
    b = port_sd["backbone.vit_lidar.blocks.0.attn.qkv.bias"]
    o_t = tvit.KERNEL_OPS.flash(torch.from_numpy(x) @ w.t() + b, heads, 0, False).numpy()
    _differ(o_t, o_j, "o", *LIMITS["f32"])
    # the control: the heads read as contiguous thirds of qkv's columns per
    # head (q, k, v interleaved a head) instead of q | k | v
    inter = (torch.from_numpy(x) @ w.t() + b).reshape(1, 16, heads, 3, embed // heads)
    o_c = tvit.KERNEL_OPS.flash(inter.transpose(2, 3).reshape(1, 16, 3 * embed), heads, 0,
                                False).numpy()
    with pytest.raises(AssertionError):
        _differ(o_c, o_j, "o", *LIMITS["f32"])
