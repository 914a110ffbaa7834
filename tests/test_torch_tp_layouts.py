"""Which tensor-parallel layouts the port takes, held against JAX's sharded
step, and the uneven whole-head shards of the layouts the named ViTs run.

- ``mesh.check_model_parallel`` against JAX's ``make_sharded_train_step``
  on the 8 host devices ``tests/conftest.py`` forces: for each (embed,
  heads, MLP hidden, model axis) layout both run or both raise. JAX's step
  takes the tiny config at depth 1 with those widths (a global batch of 8,
  the data axis the devices the model axis leaves) and runs where its
  sharding rules' split dimensions (qkv's output, proj's input, fc1's and
  fc2's hidden units) divide over the model axis; the head count does not
  matter to it. The list holds head counts the axis does not divide and a
  refusal by each of the two widths.
- ``utils.distributed.head_share`` against ``numpy.array_split`` of the
  heads.
- ``shard_state_dict`` then ``gather_state_dict`` is the identity at every
  layout of ViT-B (768, 12 heads of 64, hidden 3072) and ViT-Ti (192, 3 of
  64, 768) that JAX takes up to 12 ranks, each rank's qkv rows are its
  heads' rows of q, k and v, its proj columns theirs, and ``full_tensor``'s
  padding for the gather (shards of unequal size) gives each rank's shard
  back.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.models import init_params  # noqa: E402
from intentbev_torch.parallel.mesh import check_model_parallel  # noqa: E402
from intentbev_torch.parallel.sharding import (gather_state_dict, model_dim,  # noqa: E402
                                               shard_state_dict, split_sizes)
from intentbev_torch.utils.distributed import head_share  # noqa: E402

# (embed, heads, MLP ratio, model axis): JAX runs the first three (3 heads
# at mp 2, 4 and 8: shares 2+1, 1+1+1+0 and three ranks of one head beside
# five of none)
# and refuses the last two (embed 36 at mp 8; hidden 132 at mp 8)
JAX_LAYOUTS = [(48, 3, 4.0, 2), (48, 3, 4.0, 4), (48, 3, 4.0, 8), (36, 3, 4.0, 8),
               (48, 3, 2.75, 8)]
NAMED = {"vit_base": (768, 12), "vit_tiny": (192, 3)}  # embed, heads (hidden 4x)


def _tiny(m, embed, heads, ratio, mp, depth=1):
    c = m.tiny_test_config()
    return dataclasses.replace(
        c, vit=dataclasses.replace(c.vit, embed_dim=embed, num_heads=heads, mlp_ratio=ratio,
                                   depth=depth),
        mesh=dataclasses.replace(c.mesh, model_parallel=mp))


@functools.lru_cache(maxsize=None)
def _named_params(model):
    """The depth-1 state dict of a named ViT's widths (one draw a model)."""
    embed, heads = NAMED[model]
    return init_params(_tiny(tcfg, embed, heads, 4.0, 1), seed=1)


def _jax_sharded_step_runs(embed, heads, ratio, mp) -> tuple[bool, str]:
    """Whether JAX's sharded step takes this layout: state sharded, batch
    put, one step run to finite metrics (False and its error where it
    raises)."""
    import jax
    import jax.numpy as jnp

    from intentbev import configs as jcfg
    from intentbev.boxes.anchors import generate_anchors as jgenerate_anchors
    from intentbev.models import build_model as jbuild_model
    from intentbev.parallel import (batch_sharding, create_mesh, make_sharded_train_step,
                                    shard_train_state)
    from intentbev.train import init_train_state, make_optimizer
    from test_parallel import _make_batch

    cfg = _tiny(jcfg, embed, heads, ratio, mp)
    cfg = dataclasses.replace(cfg, augment=dataclasses.replace(
        cfg.augment, flip_prob=0, rotate_prob=0, scale_prob=0, dropout_prob=0))
    model = jbuild_model(cfg, train_mode=True)
    tx = make_optimizer(cfg)
    state = init_train_state(model, cfg, tx, jax.random.key(0))
    anchors = jnp.asarray(jgenerate_anchors(cfg.grid, cfg.anchors))
    try:
        mesh = create_mesh(cfg.mesh)
        sharded = shard_train_state(state, mesh, cfg)
        step = make_sharded_train_step(model, cfg, anchors, tx, mesh)(sharded)
        batch = jax.device_put(_make_batch(cfg), batch_sharding(mesh, cfg.mesh))
        _, metrics = step(sharded, batch, jax.random.key(1))
        loss = float(metrics["loss"])
    except ValueError as e:
        return False, str(e)
    return bool(np.isfinite(loss)), f"loss {loss}"


@pytest.mark.parametrize("embed,heads,ratio,mp", JAX_LAYOUTS)
def test_layout_check_agrees_with_jax(embed, heads, ratio, mp):
    """The port's check admits a layout exactly where JAX's sharded step
    runs it; its refusal names the numbers."""
    jax_runs, said = _jax_sharded_step_runs(embed, heads, ratio, mp)
    cfg = _tiny(tcfg, embed, heads, ratio, mp)
    hidden = int(embed * ratio)
    if jax_runs:
        check_model_parallel(cfg)
    else:
        assert "divisible" in said, said  # JAX's own refusal, not another fault
        with pytest.raises(ValueError, match=rf"model_parallel={mp} .*embed_dim={embed} "
                                             rf".*{hidden}"):
            check_model_parallel(cfg)


@pytest.mark.parametrize("heads", [1, 2, 3, 6, 12])
def test_head_share_is_array_split(heads):
    for mp in range(1, 13):
        runs = np.array_split(np.arange(heads), mp)
        for r, run in enumerate(runs):
            first, n = head_share(heads, mp, r)
            assert n == len(run) and (n == 0 or first == run[0]), (heads, mp, r)


def _named_layouts():
    out = []
    for name, (embed, heads) in NAMED.items():
        for mp in range(2, 13):
            if embed % mp == 0 and (4 * embed) % mp == 0:
                out.append((name, mp))
    return out


@pytest.mark.parametrize("model,mp", _named_layouts())
def test_shard_then_gather_at_the_named_layouts(model, mp):
    """At depth 1: the round trip is the identity; a rank's qkv rows are
    q[h], k[h], v[h] of its run of heads and its proj columns those heads'
    (an empty shard where it holds none); the MLP splits evenly."""
    embed, heads = NAMED[model]
    cfg = _tiny(tcfg, embed, heads, 4.0, mp)
    full = _named_params(model)
    shards = [shard_state_dict(full, r, mp, cfg) for r in range(mp)]
    back = gather_state_dict(shards, cfg)
    assert set(back) == set(full)
    for k, v in full.items():
        assert torch.equal(back[k], v), k
    dh = embed // heads
    blk = "backbone.vit_lidar.blocks.0."
    w_qkv, w_proj = full[blk + "attn.qkv.weight"], full[blk + "attn.proj.weight"]
    for r, sd in enumerate(shards):
        first, n = head_share(heads, mp, r)
        rows = [j * embed + (first + h) * dh + c for j in range(3) for h in range(n)
                for c in range(dh)]
        assert torch.equal(sd[blk + "attn.qkv.weight"], w_qkv[rows]), r
        assert torch.equal(sd[blk + "attn.proj.weight"],
                           w_proj[:, first * dh:(first + n) * dh]), r
        assert sd[blk + "mlp.fc1.weight"].shape == (4 * embed // mp, embed)
        assert sd[blk + "mlp.fc2.weight"].shape == (embed, 4 * embed // mp)


@pytest.mark.parametrize("model,mp", [("vit_tiny", 2), ("vit_tiny", 4), ("vit_base", 8)])
def test_split_sizes_pad_and_cut_back(model, mp):
    """``full_tensor``'s gather pads each shard to the largest of
    ``split_sizes`` and cuts it back: the sizes are the shards' own."""
    embed, heads = NAMED[model]
    cfg = _tiny(tcfg, embed, heads, 4.0, mp)
    full = _named_params(model)
    shards = [shard_state_dict(full, r, mp, cfg) for r in range(mp)]
    for k, v in full.items():
        dim = model_dim(k, v.dim())
        if dim is None:
            continue
        sizes = split_sizes(k, v.shape[dim], mp, heads)
        assert sizes == [s[k].shape[dim] for s in shards], k
        top = max(sizes)
        for s, n in zip(shards, sizes):
            pad = [0, 0] * (v.dim() - 1 - dim) + [0, top - n]
            assert torch.equal(torch.nn.functional.pad(s[k], pad).narrow(dim, 0, n), s[k])
