"""The port's reference-checkpoint importer against the JAX package's, on the CPU.

``intentbev_torch/import_torch.py`` maps a reference state dict to the
port's state dict directly; ``intentbev/import_torch.py`` maps it to flax
trees, which ``weights.from_flax`` maps to the port's. The reference
state dicts are built here, without the reference repo and without timm:
the ViT's timm interiors take the key schema and shapes of
``tests/vit_twin.py::TwinViT``, the other parts the names that JAX's
import reads, and every value is a numpy draw from a seed. Held:

- the port's import equals ``from_flax`` of JAX's, key for key and bit for
  bit (the CNN at small and at default widths, the ViT at 2 narrow blocks);
- the port's model loads it with ``strict=True``;
- the port's forward (eval mode, f32, plain versions) on the imported
  weights matches the JAX model's on JAX's import: 1e-4 of each output's
  largest value (f32 sums in another order);
- the two CLIs on one ``.pth`` write equal ``config.json`` dicts (the
  grid adjustment's two branches included) and raise the same errors;
- a ``vit_base`` checkpoint (D=768) imports, serves and takes a train step
  on the CPU through the plain versions.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev import configs as jcfg  # noqa: E402
from intentbev import import_torch as jimp  # noqa: E402
from intentbev.models import build_model as jbuild_model  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch import import_torch as timp  # noqa: E402
from intentbev_torch.checkpoint import load_checkpoint  # noqa: E402
from intentbev_torch.models import build_model, init_params  # noqa: E402
from intentbev_torch.parallel import StreamingInferencer  # noqa: E402
from intentbev_torch.synthetic import serving_batch  # noqa: E402
from intentbev_torch.weights import from_flax  # noqa: E402
from test_torch_train import _close  # noqa: E402
from vit_twin import TwinViT  # noqa: E402

SMALL_CNN = dict(lidar_planes=(16, 24, 32), map_planes=(8, 8, 16), fusion_planes=48)


def _reference_name(port_key: str) -> str:
    """The reference repo's name of a port key of the non-timm parts (the
    inverse of the name map JAX's import reads)."""
    key = port_key.replace("backbone.fusion.blocks.", "backbone.fusion_block.")
    key = key.replace(".blocks.", ".").replace("proj_conv", "downsample.0")
    key = key.replace("proj_bn", "downsample.1")
    for stream in ("lidar", "map"):
        key = key.replace(f"adapter_{stream}_norm", f"adapter_{stream}.0")
        key = key.replace(f"adapter_{stream}_proj", f"adapter_{stream}.1")
    return key


def _draw(rng, name: str, shape) -> torch.Tensor:
    """A seeded value for a reference tensor: fan-in-scaled weights, LN and
    BN scales near 1, positive running variances, small biases and means."""
    if name.endswith("num_batches_tracked"):
        return torch.tensor(7)
    if name.endswith("running_var"):
        a = 0.5 + rng.uniform(size=shape)
    elif len(shape) >= 2 and not name.endswith(("cls_token", "pos_embed")):
        a = rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[1:]))
    elif name.endswith("weight"):  # LayerNorm / BatchNorm scale
        a = 1.0 + 0.1 * rng.normal(size=shape)
    else:
        a = 0.1 * rng.normal(size=shape)
    return torch.tensor(a, dtype=torch.float32)


def reference_state_dict(cfg, seed: int) -> dict:
    """A reference-schema state dict of ``cfg``'s model family (numpy draws
    from ``seed``)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, t in init_params(cfg).items():
        if cfg.model_family == "vit" and key.startswith("backbone.vit_"):
            continue
        sd[_reference_name(key)] = _draw(rng, key, tuple(t.shape))
    if cfg.model_family == "vit":
        v = cfg.vit
        for stream, chans in (("lidar", v.lidar_input_channels), ("map", v.map_input_channels)):
            twin = TwinViT(v.img_size, v.patch_size, chans, v.embed_dim, v.depth, v.num_heads,
                           v.mlp_ratio)
            for key, t in twin.state_dict().items():
                sd[f"backbone.vit_{stream}.{key}"] = _draw(rng, key, tuple(t.shape))
    return sd


def _cnn_cfg(mod, widths):
    base = mod.tiny_test_config()
    kw = SMALL_CNN if widths == "small" else {}
    cnn = mod.CNNBackboneConfig(lidar_input_channels=base.grid.lidar_total_channels, **kw)
    return dataclasses.replace(base, model_family="cnn", cnn=cnn)


def _vit_cfg(mod, **kw):
    base = mod.tiny_test_config()
    return dataclasses.replace(base, vit=dataclasses.replace(base.vit, **kw))


def _jax_import(cfg, sd):
    if cfg.model_family == "cnn":
        return jimp.import_cnn_state_dict(sd, cfg.cnn)
    return jimp.import_vit_state_dict(sd, fusion_layers=cfg.vit.fusion_layers)


def _port_import(cfg, sd):
    if cfg.model_family == "cnn":
        return timp.import_cnn_state_dict(sd, cfg.cnn)
    return timp.import_vit_state_dict(sd, fusion_layers=cfg.vit.fusion_layers)


CASES = {"cnn_small": lambda m: _cnn_cfg(m, "small"),
         "cnn_default": lambda m: _cnn_cfg(m, "default"),
         "vit": lambda m: _vit_cfg(m, embed_dim=48, num_heads=2)}


@functools.lru_cache(maxsize=None)
def _imported(name):
    """(JAX config, port config, JAX's import, the port's import) of a case."""
    jc, tc = CASES[name](jcfg), CASES[name](tcfg)
    sd = reference_state_dict(tc, seed=3)
    return jc, tc, _jax_import(jc, sd), _port_import(tc, sd)


@pytest.mark.parametrize("name", list(CASES))
def test_import_equals_from_flax_of_the_jax_import(name):
    _, _, jax_vars, port_sd = _imported(name)
    want = from_flax(jax_vars)
    assert list(port_sd) and set(port_sd) == set(want)
    for k, v in want.items():
        assert port_sd[k].dtype == v.dtype and torch.equal(port_sd[k], v), k


@pytest.mark.parametrize("name", list(CASES))
def test_import_loads_strictly(name):
    _, tc, _, port_sd = _imported(name)
    model = build_model(tc)
    model.load_state_dict(port_sd, strict=True)


@pytest.mark.parametrize("name", ["cnn_small", "vit"])
def test_forward_matches_jax_on_the_import(name):
    jc, tc, jax_vars, port_sd = _imported(name)
    g = tc.grid
    rng = np.random.default_rng(5)
    bev = (rng.uniform(size=(2, g.height_px, g.width_px, g.lidar_total_channels)) < 0.05
           ).astype(np.float32) * rng.uniform(0.5, 2.0, (2, g.height_px, g.width_px, 1))
    bev = bev.astype(np.float32)
    mp = (rng.uniform(size=(2, g.height_px, g.width_px, g.map_channels)) < 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(a) for a in jbuild_model(jc).apply(
            jax.tree_util.tree_map(jnp.asarray, jax_vars), jnp.asarray(bev), jnp.asarray(mp))]
    model = build_model(tc)
    model.load_state_dict(port_sd, strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(bev), torch.from_numpy(mp))
    for out, a, b in zip(("cls", "box", "intent"), got, want):
        _close(a.numpy(), b, 1e-4, out)


def _save_pth(path, sd, backbone_cfg=None, epoch=4):
    torch.save({"epoch": epoch, "model_state_dict": sd, "optimizer_state_dict": {},
                "backbone_cfg": backbone_cfg or {}}, path)
    return str(path)


def _vit_pth(tmp_path, name, model_name, seed=7, **vit_kw):
    """A tiny ViT's reference checkpoint with its backbone_cfg (img_size,
    fusion widths, the timm model name)."""
    cfg = _vit_cfg(tcfg, **vit_kw)
    v = cfg.vit
    backbone_cfg = {"img_size": list(v.img_size), "vit_model_name_lidar": model_name,
                    "fusion_block_planes": v.fusion_planes,
                    "fusion_block_layers": v.fusion_layers}
    return _save_pth(tmp_path / f"{name}.pth", reference_state_dict(cfg, seed), backbone_cfg)


def _cli_configs(tmp_path, pth, *flags):
    """Both CLIs on one .pth -> (JAX's config.json, the port's)."""
    out = {}
    for side, main in (("jax", jimp.main), ("port", timp.main)):
        main([pth, str(tmp_path / side), *flags])
        out[side] = json.loads((tmp_path / side / "config.json").read_text())
    return out["jax"], out["port"]


@pytest.mark.parametrize("case", ["cnn", "vit_tiny_one_sweep", "vit_small_two_sweeps"])
def test_clis_write_the_same_config(tmp_path, case):
    if case == "cnn":  # the CNN import reads no width: the default config's
        pth = _save_pth(tmp_path / "cnn.pth", reference_state_dict(tcfg.default_cnn_config(), 1))
        flags = ()
    elif case == "vit_tiny_one_sweep":  # 8 input channels: one sweep of 8 heights
        pth = _vit_pth(tmp_path, case, "vit_tiny_patch8_224", embed_dim=48)
        flags = ("--model", "vit")
    else:  # 58 = 2 sweeps of the default 29 heights
        pth = _vit_pth(tmp_path, case, "vit_small_patch8_224", embed_dim=48,
                       lidar_input_channels=58)
        flags = ("--model", "vit")
    want, got = _cli_configs(tmp_path, pth, *flags)
    assert got == want
    state, cfg = load_checkpoint(tmp_path / "port")
    assert list(state) == ["model"] and len(list((tmp_path / "port").glob("step_00000004")))
    build_model(cfg).load_state_dict(state["model"], strict=True)
    if case != "cnn":
        assert cfg.vit.num_heads == (3 if "tiny" in case else 6)
        assert cfg.grid.lidar_total_channels == cfg.vit.lidar_input_channels
        assert (cfg.grid.lidar_sweeps, cfg.grid.lidar_height_channels) == (
            (1, 8) if "one_sweep" in case else (2, 29))


@pytest.mark.parametrize("fault", ["unknown_name", "num_heads_flag", "grid", "heads_divide"])
def test_clis_raise_the_same_errors(tmp_path, fault):
    """``vit_config_from_state_dict``'s refusals, through both CLIs: a model
    name outside the head table (and the same checkpoint with --num_heads),
    a pos_embed whose tokens the img_size does not give, an embed width the
    head count does not divide."""
    name = {"unknown_name": "deit_patch8", "num_heads_flag": "deit_patch8",
            "heads_divide": "vit_tiny_patch8_224"}.get(fault, "vit_small_patch8_224")
    pth = _vit_pth(tmp_path, fault, name, embed_dim=32)
    if fault == "grid":
        raw = torch.load(pth, weights_only=False)
        raw["backbone_cfg"]["img_size"] = [72, 96]
        torch.save(raw, pth)
    if fault == "num_heads_flag":
        want, got = _cli_configs(tmp_path, pth, "--model", "vit", "--num_heads", "4")
        assert got == want and got["vit"]["num_heads"] == 4
        return
    errors = []
    for main in (jimp.main, timp.main):
        with pytest.raises(SystemExit) as e:
            main([pth, str(tmp_path / "out"), "--model", "vit"])
        errors.append(str(e.value))
    assert errors[0] == errors[1] and errors[0]


def test_vit_base_imports_serves_and_trains_on_the_cpu(tmp_path):
    """ViT-B's width (768, 12 heads of 64) at depth 1 on the tiny grid: the
    kernels are not built for it (on the card they raise), the plain
    versions serve it and train it here."""
    from intentbev_torch.boxes import generate_anchors
    from intentbev_torch.train import make_optimizer, make_train_step

    pth = _vit_pth(tmp_path, "vit_base", "vit_base_patch8_224", embed_dim=768, depth=1)
    timp.main([pth, str(tmp_path / "base"), "--model", "vit"])
    state, cfg = load_checkpoint(tmp_path / "base")
    # the tiny grid holds fewer anchors than the default eval's pre-NMS top-k
    cfg = dataclasses.replace(cfg, eval=tcfg.tiny_test_config().eval, train=dataclasses.replace(
        cfg.train, compute_dtype="float32"))
    assert (cfg.vit.embed_dim, cfg.vit.num_heads, cfg.vit.depth) == (768, 12, 1)
    g = cfg.grid
    pts, valid, mp = serving_batch(g, 2, 600, seed=1)
    det = StreamingInferencer(cfg, state["model"], "cpu", transport="points")(pts, valid, mp)
    assert np.isfinite(det.scores).all() and np.isfinite(det.boxes_xywha).all()

    model = build_model(cfg)
    model.load_state_dict(state["model"], strict=True)
    anchors = torch.as_tensor(generate_anchors(g, cfg.anchors))
    step = make_train_step(model, cfg, anchors, make_optimizer(model.parameters(), cfg))
    rng = np.random.default_rng(0)
    n_gt = cfg.loss.max_gt_boxes
    batch = {"points": torch.as_tensor(pts), "points_valid": torch.as_tensor(valid),
             "map_bev": torch.as_tensor(mp),
             "gt_boxes": torch.as_tensor(np.tile([[5.0, 2.0, 2.0, 4.5, 0.3]], (2, n_gt, 1)),
                                         dtype=torch.float32),
             "gt_intentions": torch.zeros(2, n_gt, dtype=torch.int32),
             "gt_valid": torch.as_tensor(rng.uniform(size=(2, n_gt)) < 0.5),
             "aug_params": torch.tensor([[1.0, 0.0, 1.0]] * 2)}
    metrics = step(batch, torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(m)) for m in metrics.values())
