"""Checkpoints with the embedded config, as ``intentbev/checkpoint.py`` keeps
them.

Layout and semantics are the JAX package's: one ``step_{N:08d}`` directory
a checkpoint, ``config.json`` beside them (the whole ExperimentConfig
through :func:`configs.config_to_dict`, so eval rebuilds the model from the
checkpoint alone), the newest ``keep`` (3) kept. Orbax is not on the
card's host: the state goes through ``torch.save`` into
``step_{N:08d}/state.pt``. The state is a dict: ``model`` (the model's
state dict), ``optimizer`` (the AdamW ``state_dict()``), ``step`` and
``loop`` (``lr``, ``best``, ``bad_epochs``, ``epoch``, ``epoch_batch``).

The JAX loop still reads checkpoints written before ``loop.epoch_batch``
existed (``intentbev/train.py:420-423``); the port has no such
checkpoints, so its loop requires the key.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import torch

from .configs import ExperimentConfig, config_from_dict, config_to_dict

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str | Path, step: int, state: dict, config: ExperimentConfig,
                    keep: int = 3) -> Path:
    """Write ``state`` as checkpoint ``step`` (the directory written whole
    under a temporary name, then renamed) and ``config.json``; prune to the
    newest ``keep``."""
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(state, tmp / STATE_FILE)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    with open(ckpt_dir / "config.json", "w") as f:
        json.dump(config_to_dict(config), f, indent=2)
    _prune(ckpt_dir, keep)
    return path


def _prune(ckpt_dir: Path, keep: int) -> None:
    for old in sorted(ckpt_dir.glob("step_*"))[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> int | None:
    steps = sorted(Path(ckpt_dir).glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def load_config(ckpt_dir: str | Path) -> ExperimentConfig:
    """The ExperimentConfig embedded beside the checkpoints."""
    with open(Path(ckpt_dir).absolute() / "config.json") as f:
        return config_from_dict(json.load(f))


def load_checkpoint(ckpt_dir: str | Path, step: int | None = None,
                    map_location="cpu") -> tuple[dict, ExperimentConfig]:
    """-> (state dict as saved, tensors on ``map_location``; the embedded
    ExperimentConfig). ``step``: a retained step (default: the latest)."""
    ckpt_dir = Path(ckpt_dir).absolute()
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    config = load_config(ckpt_dir)
    state = torch.load(ckpt_dir / f"step_{step:08d}" / STATE_FILE, map_location=map_location,
                       weights_only=True)
    return state, config
