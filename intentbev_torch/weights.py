"""JAX (flax) parameters -> the port's IntentNetViT or IntentNetCNN state
dict.

The inverse of the layout map in ``intentbev/import_torch.py``, the same
rules for both families (the port's modules carry the flax names):

- flax Conv kernel [kh, kw, in, out] -> torch Conv2d weight [out, in, kh, kw]
  (except the patch embeds, which keep [P, P, C, D] for the voxel-embed
  kernel and the patch matmul);
- flax Dense kernel [in, out] -> weight [out, in];
- LayerNorm/BatchNorm ``scale`` -> ``weight``; BatchNorm ``batch_stats``
  ``mean``/``var`` -> ``running_mean``/``running_var``;
- ``block{i}`` -> ``blocks.{i}``; every other name is the same.

The state dict is f32 and carries no int8 codes: a ViT built with
``serving_int8`` quantizes its block MLPs (per output channel, as the JAX
``quantize_cols`` of the f32 parameters) when it loads the state dict, and
keeps the codes and scales as buffers.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_LEAF = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for name, sub in tree.items():
        path = prefix + (name,)
        if isinstance(sub, Mapping):
            yield from _walk(sub, path)
        else:
            yield path, np.asarray(sub)


def _key(path: tuple[str, ...]) -> str:
    parts = []
    for p in path[:-1]:
        parts.append(f"blocks.{p[5:]}" if p.startswith("block") and p[5:].isdigit() else p)
    leaf = path[-1]
    parts.append("weight" if leaf == "kernel" else _LEAF.get(leaf, leaf))
    return ".".join(parts)


def from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of ``intentbev.models.IntentNetViT``
    or ``IntentNetCNN`` (nested dicts of arrays) -> an f32 state dict for
    the port's model of the same family."""
    state: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _walk(variables.get(collection, {})):
            if path[-1] == "kernel" and path[-2] != "patch_embed":
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                elif arr.ndim == 2:
                    arr = arr.T
            state[_key(path)] = torch.tensor(arr, dtype=torch.float32)
    for key in [k for k in state if k.endswith(".running_var")]:
        state[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return state
