"""The port's tensor parallelism over the mesh's model axis (the ViT train
step with each rank on its heads and hidden units) against the port's
one-process step and JAX's single-device step on the global batch, on the
CPU.

The tiny config (embed 32, 2 heads of 16, MLP hidden 128) at mp=2 puts 1
head and 64 hidden units on a rank; the attention runs through the flash
entries' plain versions (1 head of 16 does not pair: the BHTD entry). The
multi-process half follows ``tests/test_torch_parallel.py``: one launch of
gloo ranks per mesh (2 ranks at mp=2; 4 ranks at dp=2 x mp=2), started from
this file's ``__main__`` block, each rank running every check; a 60 s group
timeout, and the test kills the ranks when they are not done within 120 s.
The references are computed in the test process (the workers import no
JAX) and the inputs pass through ``tmp_path``.

Readings and tolerances:

- each case's step (the default switches with flash on, B
  ``fuse_ln_dense``, C ``use_fused_layernorm=False``, flash off, the MLP
  without its kernel, ``remat_vit_blocks``, drop-path 0.1 and the patch
  dropout from one generator seed) on every rank, its gradients and its
  parameters after AdamW gathered to full tensors, against the port's
  one-process step on the global batch: the loss terms rtol 1e-5, every
  gradient 1e-5 of its tensor's largest value, the parameters atol 1e-5
  (f32 sums in another order);
- the default switches, B, C and flash off against JAX's single-device
  ``make_train_step`` on the global batch with JAX's draws: the loss terms
  rtol 2e-4 and every parameter after the step atol 5e-4, the bounds of
  JAX's own mp=2 test (``tests/test_parallel.py``);
- bf16 compute (f32 master weights) against the one-process bf16 step:
  the loss terms rtol 2e-3, the gradients' relative L2 over all parameters
  under 2e-2 (one more bf16 rounding at each partial sum, in a model at
  initialisation; the readings in the assertion messages);
- every replicated parameter's gradient is the same, bit for bit, on the
  ranks of one data index; a rank's qkv output is its heads' columns of
  the full output; ``shard_state_dict`` then ``gather_state_dict`` is the
  identity; the layout check raises naming the numbers where JAX's
  sharding refuses the layout, and takes ViT-Ti's 3 heads at mp=2;
- ``train()`` at mp=2: its checkpoints hold full tensors in the
  one-process layout; a TP checkpoint resumes in one process, a
  one-process checkpoint under TP, and a TP checkpoint under TP, each to
  the one-process run's parameters (atol 5e-4: AdamW's steps lift the
  summation noise of a gradient near 0 to the learning rate) and AdamW
  moments (1e-4 of their tensor's largest value).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "tests"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.boxes.anchors import generate_anchors  # noqa: E402
from intentbev_torch.models import build_model, init_params  # noqa: E402
from intentbev_torch.train import make_optimizer, make_train_step  # noqa: E402
from test_torch_parallel import (GLOBAL, _batch, _free_port, _jax_draws,  # noqa: E402
                                 _tensors)

WORKER_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
METRICS = ("loss", "cls_loss", "box_loss", "intent_loss", "num_pos_anchors")
MESHES = {"mp2": (2, 2), "dp2mp2": (4, 2)}  # name: (world size, model axis)
# case: (ViT switches, train switches, generator seed or None for JAX's draws)
CASES = {
    "default": ({}, {}, None),
    "ln_dense": (dict(fuse_ln_dense=True), {}, None),
    "unfused_ln": (dict(use_fused_layernorm=False), {}, None),
    "no_flash": (dict(use_flash_attention=False), {}, None),
    "unfused_mlp": (dict(use_fused_mlp=False), {}, None),
    "remat": ({}, dict(remat_vit_blocks=True), None),
    "drop_path": (dict(drop_path_rate=0.1), {}, 5),
    "bf16": ({}, dict(compute_dtype="bfloat16"), None),
}
JAX_CASES = ("default", "ln_dense", "unfused_ln", "no_flash")


def _configs(m, vit=None, train=None, mp=1):
    """The tiny config of module ``m`` (the JAX or the port configs) with
    flash on, drop-path 0, the patch dropout always on, a global batch of
    4, the ViT switches ``vit`` and train switches ``train``, and a model
    axis of ``mp``."""
    c = m.tiny_test_config()
    return dataclasses.replace(
        c, vit=dataclasses.replace(c.vit, **{"use_flash_attention": True,
                                             "drop_path_rate": 0.0, **(vit or {})}),
        augment=dataclasses.replace(c.augment, dropout_prob=1.0),
        train=dataclasses.replace(c.train, batch_size=GLOBAL, **(train or {})),
        mesh=dataclasses.replace(c.mesh, model_parallel=mp))


def _case_config(name, mp=1):
    vit, train, _ = CASES[name]
    return _configs(tcfg, vit, train, mp)


def _one_process(cfg, state, batch, draws=None, seed=None):
    """One step of the port in one process: (metrics, gradients, state
    dict after the step)."""
    dtype = torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32
    model = build_model(cfg, dtype=dtype, param_dtype=torch.float32)
    model.load_state_dict(state)
    anchors = torch.from_numpy(generate_anchors(cfg.grid, cfg.anchors))
    step = make_train_step(model, cfg, anchors, make_optimizer(model.parameters(), cfg))
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    m = step(_tensors(batch), gen, draws)
    return ({k: float(v) for k, v in m.items()},
            {k: p.grad.clone() for k, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()})


def _jax_step(cfg_vit, batch):
    """JAX's single-device step of the tiny ViT under ``cfg_vit``'s switches
    on the global batch -> (initial variables as a port state dict, the
    step's draws, metrics, state dict after)."""
    import jax
    import jax.numpy as jnp

    from intentbev import configs as jcfg
    from intentbev import train as jtrain
    from intentbev.models import build_model as jbuild_model
    from intentbev_torch.weights import from_flax

    jc = _configs(jcfg, cfg_vit)
    model = jbuild_model(jc, train_mode=True)
    tx = jtrain.make_optimizer(jc)
    state = jtrain.init_train_state(model, jc, tx, jax.random.key(0))
    init = from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    rng = jax.random.key(1)
    rng_aug, rng_loss, _ = jax.random.split(jax.random.fold_in(rng, state.step), 3)
    tc = _configs(tcfg)
    anchors = generate_anchors(tc.grid, tc.anchors)
    draws = _jax_draws(rng_aug, rng_loss, jc, anchors.shape[0])
    new_state, metrics = jtrain.make_train_step(model, jc, jnp.asarray(anchors), tx)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    after = from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    return init, draws, {k: float(v) for k, v in metrics.items()}, after


# ---------------------------------------------------------------------------
# the workers (gloo ranks; no JAX)
# ---------------------------------------------------------------------------

def _worker(rank: int, world: int, port: int, work: Path) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        inp = torch.load(work / "inputs.pt", weights_only=False)
        torch.save(_worker_run(rank, inp), work / f"out_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _worker_run(rank: int, inp: dict) -> dict:
    import torch.distributed as dist

    from intentbev_torch.parallel import create_mesh, make_sharded_train_step, shard_train_state
    from intentbev_torch.parallel.mesh import data_group, model_group
    from intentbev_torch.parallel.sharding import model_dim
    from intentbev_torch.parallel.train_dp import full_tensor, gather_train_state
    from intentbev_torch.train import train

    mp = inp["mp"]
    out: dict = {"cases": {}}
    mesh_cfg = _configs(tcfg, mp=mp).mesh
    mesh = create_mesh(mesh_cfg, "cpu")
    dg, mg = data_group(mesh, mesh_cfg), model_group(mesh, mesh_cfg)
    n = GLOBAL // dg.size
    rows = slice(dg.rank * n, (dg.rank + 1) * n)
    for name, case in inp["cases"].items():
        cfg = _case_config(name, mp)
        dtype = torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32
        model = build_model(cfg, dtype=dtype, param_dtype=torch.float32)
        model.load_state_dict(case["state"])
        opt = make_optimizer(model.parameters(), cfg)
        shard_train_state(model, opt, mesh, cfg)
        anchors = torch.from_numpy(generate_anchors(cfg.grid, cfg.anchors))
        step = make_sharded_train_step(model, cfg, anchors, opt, mesh)
        gen = None if case["seed"] is None else torch.Generator().manual_seed(case["seed"])
        m = step(_tensors(case["batch"], rows), gen, case["draws"])
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        full_grads = {k: full_tensor(k, g, mg, cfg) for k, g in grads.items()}
        full_state = gather_train_state(model, opt, mesh, cfg)[0]
        replicated = {k: g for k, g in grads.items() if model_dim(k, g.dim()) is None}
        out["cases"][name] = ({k: float(v) for k, v in m.items()}, full_grads, full_state,
                              replicated, (dg.rank, mg.rank))

    if "train" in inp:  # train() at mp=2: TP checkpoints, resumes both ways
        tr = inp["train"]
        cfg = _configs(tcfg, mp=mp)
        kw = dict(num_workers=1, log_fn=lambda *_: None, device="cpu", distributed=True)
        train(cfg, tr["data_dir"], tr["tp_dir"], max_steps=2, **kw)
        if dist.get_rank() == 0:
            shutil.copytree(tr["tp_dir"], tr["tp_copy_dir"])
        dist.barrier()
        train(cfg, tr["data_dir"], tr["tp_dir"], max_steps=3, resume=True, **kw)
        train(cfg, tr["data_dir"], tr["from_one_dir"], max_steps=3, resume=True, **kw)
    return out


def _run_workers(work: Path, world: int) -> list[dict]:
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(port),
                               str(work)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the gloo workers did not finish within {WORKER_TIMEOUT_S} s")
    failed = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode]
    assert not failed, failed
    return [torch.load(work / f"out_rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the references (JAX and one process) and one launch per mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """JAX's steps, the one-process steps and train() runs, and the case
    inputs the workers read."""
    from intentbev_torch.data.synthetic import write_synthetic_log
    from intentbev_torch.precompute_labels import run as precompute_labels
    from intentbev_torch.train import train

    work = tmp_path_factory.mktemp("tp")
    g = _configs(tcfg).grid
    batch = _batch(0, g, _configs(tcfg).loss.max_gt_boxes)
    jax_ref, cases = {}, {}
    for name in JAX_CASES:
        init, draws, metrics, after = _jax_step(CASES[name][0], batch)
        jax_ref[name] = (metrics, after)
        cases[name] = {"state": init, "batch": batch, "draws": draws, "seed": None}
    for name in CASES:
        if name not in cases:
            seed = CASES[name][2]
            cases[name] = {**cases["default"], "seed": seed,
                           "draws": None if seed is not None else cases["default"]["draws"]}
    one = {name: _one_process(_case_config(name), c["state"], batch, c["draws"], c["seed"])
           for name, c in cases.items()}

    split = work / "data" / "train"
    for k in range(2):
        write_synthetic_log(split, log_id=f"tplog{k}", num_frames=g.lidar_sweeps + 4,
                            points_per_sweep=400, seed=k,
                            vehicles=[{"start": (4.0 + 2 * k, 1.0), "velocity": (1.0, 0.0)},
                                      {"start": (-2.0, -4.0), "velocity": (0.0, 0.5)}])
    precompute_labels(str(work / "data"), ["train"], force=True)
    dirs = {k: str(work / k) for k in ("one", "one_copy", "tp", "tp_copy", "from_one")}
    cfg = _configs(tcfg, mp=2)
    kw = dict(num_workers=1, log_fn=lambda *_: None, device="cpu")
    train(cfg, str(split), dirs["one"], max_steps=2, **kw)
    shutil.copytree(dirs["one"], dirs["from_one"])  # a one-process checkpoint for TP
    train(cfg, str(split), dirs["one"], max_steps=3, resume=True, **kw)
    torch.save({"cases": cases, "mp": 2,
                "train": {"data_dir": str(split), "tp_dir": dirs["tp"],
                          "tp_copy_dir": dirs["tp_copy"], "from_one_dir": dirs["from_one"]}},
               work / "inputs.pt")
    return {"jax": jax_ref, "one": one, "cases": cases, "work": work, "dirs": dirs,
            "split": str(split)}


@pytest.fixture(scope="module")
def ranks(refs):
    """One launch of each mesh's gloo ranks: {mesh name: [rank outputs]}."""
    out = {}
    for mesh, (world, mp) in MESHES.items():
        work = refs["work"] / mesh
        work.mkdir()
        inp = torch.load(refs["work"] / "inputs.pt", weights_only=False)
        if world != 2:  # the train() runs take the 2-rank mesh
            inp.pop("train")
        inp["mp"] = mp
        torch.save(inp, work / "inputs.pt")
        out[mesh] = _run_workers(work, world)
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _close(got, want, rel, name):
    """max|got - want| <= rel * max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * max(np.abs(want).max(), 1e-30), \
        f"{name}: max|d| {err} vs max|want| {np.abs(want).max()}"


def _rel_l2(a: dict, b: dict) -> float:
    num = sum(float((a[k].double() - b[k].double()).norm() ** 2) for k in b)
    den = sum(float(b[k].double().norm() ** 2) for k in b)
    return (num / den) ** 0.5


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", [c for c in CASES if c != "bf16"])
def test_tp_step_matches_one_process(refs, ranks, mesh, case):
    m1, g1, s1 = refs["one"][case]
    assert m1["num_pos_anchors"] > 0
    for r in ranks[mesh]:
        m, grads, state = r["cases"][case][:3]
        for k in METRICS:
            np.testing.assert_allclose(m[k], m1[k], rtol=1e-5, err_msg=k)
        assert set(grads) == set(g1) and set(state) == set(s1)
        for k, v in g1.items():
            _close(grads[k].numpy(), v.numpy(), 1e-5, f"grad {k}")
        for k, v in s1.items():
            assert state[k].shape == v.shape, k
            if v.is_floating_point():
                np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", JAX_CASES)
def test_tp_step_matches_jax_single_device(refs, ranks, mesh, case):
    mj, sj = refs["jax"][case]
    assert mj["num_pos_anchors"] > 0
    for r in ranks[mesh]:
        m, _, state = r["cases"][case][:3]
        for k in METRICS:
            np.testing.assert_allclose(m[k], mj[k], rtol=2e-4, err_msg=k)
        for k, v in sj.items():
            if k.endswith(("running_mean", "running_var")):
                _close(state[k].numpy(), v.numpy(), 1e-4, k)
            elif v.is_floating_point():
                np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=5e-4, err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_step_bf16_matches_one_process(refs, ranks, mesh):
    """bf16 compute: the TP step's loss terms against the one-process bf16
    step's, and its gradients no further from the f32 step's than the
    one-process bf16 step's are (the bf16 noise of the tiny model at
    initialisation is itself 5e-2 to 8e-2 in relative L2)."""
    m1, g1, _ = refs["one"]["bf16"]
    g32 = refs["one"]["default"][1]  # the same inputs in f32
    floor = _rel_l2(g1, g32)
    for r in ranks[mesh]:
        m, grads = r["cases"]["bf16"][:2]
        rel = {k: abs(m[k] - m1[k]) / abs(m1[k]) for k in METRICS[:4]}
        assert m["num_pos_anchors"] == m1["num_pos_anchors"]
        assert max(rel.values()) < 2e-3, rel
        said = (f"TP bf16 vs f32 {_rel_l2(grads, g32)}, one-process bf16 vs f32 {floor}, "
                f"TP bf16 vs one-process bf16 {_rel_l2(grads, g1)}")
        assert _rel_l2(grads, g32) < 1.25 * floor, said


@pytest.mark.parametrize("mesh", list(MESHES))
def test_replicated_gradients_equal_across_the_model_axis(ranks, mesh):
    for case in CASES:
        by_data: dict = {}
        for r in ranks[mesh]:
            rep, (d, _) = r["cases"][case][3], r["cases"][case][4]
            by_data.setdefault(d, []).append(rep)
        for reps in by_data.values():
            assert len(reps) == MESHES[mesh][1]
            for other in reps[1:]:
                assert set(other) == set(reps[0])
                for k, v in reps[0].items():
                    np.testing.assert_array_equal(other[k].numpy(), v.numpy(),
                                                  err_msg=f"{case} {k}")


def test_shard_then_gather_is_the_identity():
    from intentbev_torch.parallel.sharding import gather_state_dict, shard_state_dict

    for mp, cfg in ((2, _configs(tcfg)), (3, tcfg.default_vit_config())):
        cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, depth=1))
        full = init_params(cfg, seed=1)
        shards = [shard_state_dict(full, r, mp, cfg) for r in range(mp)]
        sharded = [k for k in full if shards[0][k].shape != full[k].shape]
        assert len(sharded) == 2 * 6  # qkv w/b, proj w, fc1 w/b, fc2 w: 2 streams x 1 block
        back = gather_state_dict(shards, cfg)
        assert set(back) == set(full)
        for k, v in full.items():
            assert torch.equal(back[k], v), k


@pytest.mark.parametrize("mp", [1, 2])
def test_qkv_shard_is_its_heads_columns(mp):
    """A rank's qkv output is (q | k | v) of its own heads: the full
    output's columns of those heads, in the layout the attention reads."""
    from intentbev_torch.parallel.sharding import shard_tensor

    d, heads = 32, 2
    g = torch.Generator().manual_seed(0)
    w, b = torch.randn(3 * d, d, generator=g), torch.randn(3 * d, generator=g)
    x = torch.randn(5, 7, d, generator=g)
    full = torch.nn.functional.linear(x, w, b)
    name = "backbone.vit_map.blocks.0.attn.qkv."
    dh, h = d // heads, heads // mp
    for r in range(mp):
        got = torch.nn.functional.linear(x, shard_tensor(name + "weight", w, r, mp, heads),
                                         shard_tensor(name + "bias", b, r, mp, heads))
        cols = [j * d + r * h * dh + c for j in range(3) for c in range(h * dh)]
        torch.testing.assert_close(got, full[..., cols], rtol=1e-6, atol=1e-6)


def test_layout_check_names_the_numbers():
    """The check refuses where JAX's sharding does (a model axis that does
    not divide the embed width or the MLP hidden width), naming the
    numbers; a head count the axis does not divide is taken, as JAX takes
    it (``tests/test_torch_tp_layouts.py`` holds the rule against JAX's
    sharded step)."""
    from intentbev_torch.parallel.mesh import check_model_parallel

    with pytest.raises(ValueError, match=r"model_parallel=3 .*embed_dim=32 .*128"):
        check_model_parallel(_configs(tcfg, mp=3))
    vit_s = tcfg.default_vit_config()
    vit_ti = dataclasses.replace(vit_s, vit=dataclasses.replace(vit_s.vit, embed_dim=192,
                                                                 num_heads=3))
    with pytest.raises(ValueError, match=r"model_parallel=5 .*embed_dim=192 .*768"):
        check_model_parallel(dataclasses.replace(vit_ti, mesh=tcfg.MeshConfig(model_parallel=5)))
    check_model_parallel(dataclasses.replace(vit_ti, mesh=tcfg.MeshConfig(model_parallel=2)))
    check_model_parallel(dataclasses.replace(vit_s, mesh=tcfg.MeshConfig(model_parallel=2)))
    check_model_parallel(_configs(tcfg, mp=2))
    check_model_parallel(dataclasses.replace(_configs(tcfg, mp=3), model_family="cnn"))


@pytest.mark.parametrize("mode", ["serving", "serving_int8"])
def test_tp_covers_training_only(mode):
    """Under a model axis wider than 1 the serving paths (the LN chain, the
    W8A8 MLP) raise before any collective, as JAX has no TP serving."""
    from intentbev_torch.models import IntentNetViT
    from intentbev_torch.utils.distributed import ModelGroup

    cfg = _configs(tcfg, dict(serving_int8=mode == "serving_int8"))
    model = IntentNetViT(cfg.vit, cfg.heads)
    model.set_model_group(ModelGroup(None, 0, 2))
    model.train(mode == "serving_int8")
    g = cfg.grid
    with pytest.raises(NotImplementedError):
        model(torch.zeros(1, g.height_px, g.width_px, g.lidar_total_channels),
              torch.zeros(1, g.height_px, g.width_px, g.map_channels))


def _ckpt(path, step=None):
    from intentbev_torch.checkpoint import load_checkpoint

    return load_checkpoint(path, step=step)[0]


def _ckpt_close(got, want):
    """Full tensors in the one-process layout; the parameters within JAX's
    mp=2 bound (AdamW's steps lift the f32 summation noise of a gradient
    near 0 to its learning rate), the moments within 1e-4 of their tensor's
    largest value."""
    assert got["step"] == want["step"]
    assert set(got["model"]) == set(want["model"])
    for k, v in want["model"].items():
        assert got["model"][k].shape == v.shape, k
        np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(), atol=5e-4, err_msg=k)
    assert set(got["optimizer"]["state"]) == set(want["optimizer"]["state"])
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert got["optimizer"]["state"][i][k].shape == v.shape, (i, k)
            _close(got["optimizer"]["state"][i][k].numpy(), v.numpy(), 1e-4, f"{i} {k}")


def test_tp_checkpoints_cross_to_one_process_and_back(refs, ranks):
    """train() at mp=2 writes full tensors in the one-process layout (step
    2); one process resumes from it, mp=2 resumes from a one-process
    checkpoint and from its own, and all reach the one-process run's step
    3."""
    from intentbev_torch.train import train

    d = refs["dirs"]
    tp2, one2 = _ckpt(d["tp"], 2), _ckpt(d["one"], 2)
    _ckpt_close(tp2, one2)
    model = build_model(_configs(tcfg))
    model.load_state_dict(tp2["model"])  # the one-process layout, as it is
    make_optimizer(model.parameters(), _configs(tcfg)).load_state_dict(tp2["optimizer"])
    train(_configs(tcfg, mp=2), refs["split"], d["tp_copy"], max_steps=3, resume=True,
          num_workers=1, log_fn=lambda *_: None, device="cpu")
    one3 = _ckpt(d["one"], 3)
    for name in ("tp_copy", "tp", "from_one"):
        _ckpt_close(_ckpt(d[name], 3), one3)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
