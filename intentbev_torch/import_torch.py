"""Import reference PyTorch checkpoints into the port's checkpoints.

Counterpart of ``intentbev/import_torch.py``, the migration path for users
of the reference repo: a checkpoint saved by ``train_cnn.py`` /
``train_vit.py`` (``{epoch, model_state_dict, optimizer_state_dict,
backbone_cfg}``) becomes a checkpoint of the port's ``checkpoint.py``
(``{"model": state dict}`` and ``config.json``) that ``evaluate`` and
``StreamingInferencer`` load as they are. Both sides are PyTorch, so the
reference state dict maps to the port's state dict directly, with the JAX
module's name map and none of its flax layout changes:

- Conv2d and Linear weights keep PyTorch's layout, except the ViT patch
  embed: ``patch_embed.proj.weight`` [D, C, P, P] -> ``patch_embed.weight``
  [P, P, C, D], the layout of the voxel-embed kernel and the patch matmul;
- BatchNorm ``weight``, ``bias``, ``running_mean``, ``running_var`` keep
  their names (``num_batches_tracked`` starts at 0);
- ``backbone.{lidar,map}_stage{k}.{i}.*`` -> ``....blocks.{i}.*``;
  ``....downsample.0/1`` -> ``....proj_conv, proj_bn``;
- ``backbone.fusion_block.{i}.*`` -> ``backbone.fusion.blocks.{i}.*``;
- ``det_head.conv``, ``intention_head.conv`` keep their names;
- the ViT's timm interiors (``backbone.vit_{lidar,map}``: ``cls_token``,
  ``pos_embed``, ``blocks.N.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
  mlp.fc2}``, ``norm``) keep their names. timm's packed qkv is (3, heads,
  head_dim), q first and head-major, as the port's attention reads it, so
  it needs no permutation;
- ``backbone.adapter_{lidar,map}.0/1`` -> ``backbone.adapter_{lidar,map}_norm
  / _proj``.

The state dict is f32; a ViT built with ``serving_int8`` quantizes its MLPs
when it loads it (``weights.py``). The import does no device work.

    python -m intentbev_torch.import_torch CKPT OUT_DIR [--model vit] [--num_heads N]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .configs import CNNBackboneConfig, ExperimentConfig, ViTBackboneConfig


def _f32(t) -> torch.Tensor:
    """An f32 CPU copy of a tensor or numpy array."""
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
    return t.detach().to("cpu", torch.float32, copy=True)


def _copy(sd: Mapping[str, Any], src: str, dst: str, out: dict, leaves=("weight", "bias")):
    for leaf in leaves:
        out[f"{dst}.{leaf}"] = _f32(sd[f"{src}.{leaf}"])


def _bn(sd: Mapping[str, Any], src: str, dst: str, out: dict) -> None:
    _copy(sd, src, dst, out, ("weight", "bias", "running_mean", "running_var"))
    out[f"{dst}.num_batches_tracked"] = torch.tensor(0)


def _basic_block(sd: Mapping[str, Any], src: str, dst: str, out: dict) -> None:
    """One reference BasicBlock (model_cnn.py:14-33) -> the port's BasicBlock."""
    _copy(sd, f"{src}.conv1", f"{dst}.conv1", out, ("weight",))
    _bn(sd, f"{src}.bn1", f"{dst}.bn1", out)
    _copy(sd, f"{src}.conv2", f"{dst}.conv2", out, ("weight",))
    _bn(sd, f"{src}.bn2", f"{dst}.bn2", out)
    if f"{src}.downsample.0.weight" in sd:
        _copy(sd, f"{src}.downsample.0", f"{dst}.proj_conv", out, ("weight",))
        _bn(sd, f"{src}.downsample.1", f"{dst}.proj_bn", out)


def _stage(sd: Mapping[str, Any], src: str, dst: str, num_blocks: int, out: dict) -> None:
    for i in range(num_blocks):
        _basic_block(sd, f"{src}.{i}", f"{dst}.blocks.{i}", out)


def _heads(sd: Mapping[str, Any], out: dict) -> None:
    for head in ("det_head", "intention_head"):
        _copy(sd, f"{head}.conv", f"{head}.conv", out)


def import_cnn_state_dict(sd: Mapping[str, Any],
                          cfg: CNNBackboneConfig = CNNBackboneConfig()) -> dict[str, torch.Tensor]:
    """Reference ``IntentNetCNN.state_dict()`` -> the state dict of the port's
    :class:`~intentbev_torch.models.IntentNetCNN`."""
    out: dict[str, torch.Tensor] = {}
    for stream in ("lidar", "map"):
        for k in range(1, 4):
            name = f"backbone.{stream}_stage{k}"
            _stage(sd, name, name, cfg.num_blocks_per_stage, out)
    _stage(sd, "backbone.fusion_block", "backbone.fusion", cfg.fusion_layers, out)
    _heads(sd, out)
    return out


def vit_encoder_depth(sd: Mapping[str, Any], prefix: str) -> int:
    """Number of transformer blocks under ``{prefix}.blocks.N`` in a timm
    ViT state dict."""
    depth = 0
    while f"{prefix}.blocks.{depth}.norm1.weight" in sd:
        depth += 1
    return depth


def import_vit_encoder(sd: Mapping[str, Any], prefix: str,
                       out: dict | None = None) -> dict[str, torch.Tensor]:
    """One timm ``VisionTransformer`` state dict subtree (``prefix``) -> the
    port's ``ViTEncoder`` entries under the same prefix (added to ``out``,
    which is returned)."""
    out = {} if out is None else out
    out[f"{prefix}.cls_token"] = _f32(sd[f"{prefix}.cls_token"])
    out[f"{prefix}.pos_embed"] = _f32(sd[f"{prefix}.pos_embed"])
    out[f"{prefix}.patch_embed.weight"] = _f32(
        sd[f"{prefix}.patch_embed.proj.weight"]).permute(2, 3, 1, 0).contiguous()
    out[f"{prefix}.patch_embed.bias"] = _f32(sd[f"{prefix}.patch_embed.proj.bias"])
    depth = vit_encoder_depth(sd, prefix)
    if depth == 0:
        raise KeyError(f"no transformer blocks found under {prefix}.blocks")
    for i in range(depth):
        b = f"{prefix}.blocks.{i}"
        for part in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"):
            _copy(sd, f"{b}.{part}", f"{b}.{part}", out)
    _copy(sd, f"{prefix}.norm", f"{prefix}.norm", out)
    return out


def import_vit_nontimm(sd: Mapping[str, Any], fusion_layers: int = 2,
                       out: dict | None = None) -> dict[str, torch.Tensor]:
    """The ViT model's reference-defined (non-timm) components
    (model_vit.py:82-92, heads.py:6-43): the adapters, the fusion stage and
    the heads (added to ``out``, which is returned)."""
    out = {} if out is None else out
    for stream in ("lidar", "map"):
        name = f"backbone.adapter_{stream}"
        _copy(sd, f"{name}.0", f"{name}_norm", out)
        _copy(sd, f"{name}.1", f"{name}_proj", out)
    _stage(sd, "backbone.fusion_block", "backbone.fusion", fusion_layers, out)
    _heads(sd, out)
    return out


def import_vit_state_dict(sd: Mapping[str, Any],
                          fusion_layers: int = 2) -> dict[str, torch.Tensor]:
    """Full reference ``IntentNetViT.state_dict()`` (model_vit.py:145-185)
    -> the state dict of the port's :class:`~intentbev_torch.models.IntentNetViT`:
    both timm interiors and the reference-defined components."""
    out: dict[str, torch.Tensor] = {}
    for stream in ("lidar", "map"):
        import_vit_encoder(sd, f"backbone.vit_{stream}", out)
    return import_vit_nontimm(sd, fusion_layers, out)


# embed_dim / head-count table for the timm families the reference can name
# (model_vit.py:42-43 default and the size variants)
NAME_HEADS = {"vit_tiny": 3, "vit_small": 6, "vit_base": 12}


def vit_config_from_state_dict(sd: Mapping[str, Any], base: ViTBackboneConfig,
                               num_heads: int | None = None,
                               model_name: str = "vit_small_patch8_224") -> ViTBackboneConfig:
    """A :class:`ViTBackboneConfig` whose shapes match a reference ViT state
    dict. Everything but the head count is read off the weights (patch,
    embed, depth, input channels and grid from ``patch_embed.proj`` and
    ``pos_embed``); the head count comes from the timm model name (the
    reference stores it in its checkpoint's ``backbone_cfg``) or
    ``num_heads``."""
    if num_heads is None:
        for fam, h in NAME_HEADS.items():
            if model_name.startswith(fam):
                num_heads = h
                break
        else:
            raise SystemExit(
                f"cannot infer the attention head count from model name "
                f"{model_name!r}; pass --num_heads")

    embed_dim, in_ch, p, _ = sd["backbone.vit_lidar.patch_embed.proj.weight"].shape
    n_tokens = sd["backbone.vit_lidar.pos_embed"].shape[1] - 1
    map_in = sd["backbone.vit_map.patch_embed.proj.weight"].shape[1]
    depth = vit_encoder_depth(sd, "backbone.vit_lidar")
    adapter_out = sd["backbone.adapter_lidar.1.weight"].shape[0]
    fc1 = sd["backbone.vit_lidar.blocks.0.mlp.fc1.weight"].shape[0]

    gh, gw = base.img_size[0] // p, base.img_size[1] // p
    if gh * gw != n_tokens:
        raise SystemExit(
            f"pos_embed carries {n_tokens} patch tokens but img_size "
            f"{base.img_size} / patch {p} gives {gh}x{gw}={gh * gw}; "
            "pass the img_size the checkpoint was trained at")
    if embed_dim % num_heads:
        raise SystemExit(
            f"embed_dim {embed_dim} not divisible by num_heads {num_heads}")
    return dataclasses.replace(
        base, lidar_input_channels=int(in_ch), map_input_channels=int(map_in),
        patch_size=int(p), embed_dim=int(embed_dim), depth=depth, num_heads=num_heads,
        mlp_ratio=int(fc1) / int(embed_dim), adapter_out_channels=int(adapter_out))


def _vit_experiment_config(sd: Mapping[str, Any], backbone_cfg: Mapping[str, Any],
                           num_heads: int | None) -> ExperimentConfig:
    """The ExperimentConfig of an imported ViT: the backbone read off the
    weights and ``backbone_cfg``, and the grid made consistent with the
    model's input (eval rebuilds model and loader geometry from it)."""
    cfg = ExperimentConfig(model_family="vit")
    base = cfg.vit
    if backbone_cfg.get("img_size"):
        base = dataclasses.replace(base, img_size=tuple(backbone_cfg["img_size"]))
    vit_cfg = vit_config_from_state_dict(
        sd, base, num_heads=num_heads,
        model_name=backbone_cfg.get("vit_model_name_lidar", "vit_small_patch8_224"))
    for key, field_name in (("fusion_block_planes", "fusion_planes"),
                            ("fusion_block_layers", "fusion_layers"),
                            ("fusion_block_kernel_size", "fusion_kernel_size"),
                            ("fusion_block_stride", "fusion_stride")):
        if key in backbone_cfg:
            vit_cfg = dataclasses.replace(vit_cfg, **{field_name: backbone_cfg[key]})
    grid = cfg.grid
    in_ch = vit_cfg.lidar_input_channels
    if in_ch != grid.lidar_total_channels:
        if in_ch % grid.lidar_height_channels == 0:
            grid = dataclasses.replace(grid, lidar_sweeps=in_ch // grid.lidar_height_channels)
        else:
            grid = dataclasses.replace(grid, lidar_height_channels=in_ch, lidar_sweeps=1)
    grid = dataclasses.replace(grid, height_px=vit_cfg.img_size[0],
                               width_px=vit_cfg.img_size[1],
                               map_channels=vit_cfg.map_input_channels)
    return dataclasses.replace(cfg, vit=vit_cfg, grid=grid)


def import_reference_checkpoint(ckpt_path: str, out_dir: str, model_family: str = "cnn",
                                num_heads: int | None = None) -> str:
    """Convert a reference ``torch.save`` checkpoint file into a checkpoint
    directory of the port (``checkpoint.save_checkpoint``: step = the
    reference's epoch, state ``{"model": state dict}``); returns its path."""
    from .checkpoint import save_checkpoint

    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = raw.get("model_state_dict", raw) if isinstance(raw, dict) else raw
    epoch = int(raw.get("epoch", 0)) if isinstance(raw, dict) else 0
    backbone_cfg = raw.get("backbone_cfg", {}) if isinstance(raw, dict) else {}

    if model_family == "cnn":
        cfg = ExperimentConfig(model_family="cnn")
        state = import_cnn_state_dict(sd, cfg.cnn)
    else:
        cfg = _vit_experiment_config(sd, backbone_cfg, num_heads)
        state = import_vit_state_dict(sd, fusion_layers=cfg.vit.fusion_layers)
    path = save_checkpoint(out_dir, step=epoch, state={"model": state}, config=cfg)
    return str(path)


def main(argv=None):
    """``python -m intentbev_torch.import_torch CKPT OUT_DIR [--model vit]``."""
    p = argparse.ArgumentParser(
        description="Import a reference PyTorch checkpoint into a checkpoint of the "
        "PyTorch port (intentbev_torch.evaluate and StreamingInferencer load it).")
    p.add_argument("ckpt", help="reference .pth file (train_*.py output)")
    p.add_argument("out_dir", help="checkpoint directory to create")
    p.add_argument("--model", default="cnn", choices=["cnn", "vit"])
    p.add_argument(
        "--num_heads", type=int, default=None,
        help="attention head count when the timm model name in the "
        "checkpoint is not one of the known vit_{tiny,small,base} families "
        "(the head count is not recoverable from the weights)")
    args = p.parse_args(argv)
    path = import_reference_checkpoint(args.ckpt, args.out_dir, args.model,
                                       num_heads=args.num_heads)
    print(f"imported -> {path}")


if __name__ == "__main__":
    main()
