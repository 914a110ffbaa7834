"""The port's data-parallel paths (mesh, sharding rules, the DP train step,
distributed eval, the meshed inferencer) against the JAX package and
against one process, on the CPU.

The multi-process half runs two gloo ranks on the CPU, started from this
file's own ``__main__`` block; the JAX references and the one-process
port results are computed once in the test process (the workers import no
JAX) and the inputs pass through ``tmp_path``. Each worker joins its group
on a free port with a 60 s group timeout, and the test kills both when
they are not done within 120 s: no test can hang.

Readings and tolerances:

- the mesh's shapes and errors against JAX's ``create_mesh`` on the fake
  CPU devices, ``shard_sequences_for_process`` against JAX's (exact);
- the sharding rules by parameter name, through ``from_flax``'s names and
  the [out, in] layout (exact);
- the DP step of the tiny ViT and of the tiny CNN (BatchNorm over the
  global batch) at 2 ranks x 2 samples, with the global batch's draws:
  against JAX's single-device step on the global batch, the loss terms
  rtol 2e-4 and every parameter after the AdamW step atol 5e-4 (as
  ``tests/test_parallel.py``), the CNN's running statistics 1e-4 of their
  largest value; against the port's one-process step, the loss terms rtol
  1e-5 and every gradient (summed over the ranks) 1e-4 of its tensor's
  largest value (f32 sums of two halves against one), the parameters atol
  5e-4;
- the ViT step with drop-path 0.1 and the patch dropout drawn from one
  generator seed (every draw made for the global batch and cut to the
  rank): the same readings against one process's step from that seed;
- the intention class weights under DP: intent loss rtol 2e-4 against one
  process, and different from the unweighted loss;
- distributed ``evaluate()`` (10 samples of 2 synthetic logs, eval batch 4
  split 2 + 2, a tail batch whose second half is padding) against one
  process's: counts and the confusion matrix exact, mAPs within 1e-6;
- the meshed ``StreamingInferencer`` (``__call__`` and ``stream()`` on each
  rank's half of two global batches): the gathered Detections against one
  process's on the global batches, valid masks and intentions exact, boxes
  and scores within 1e-5.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.bev.augment import DropoutDraws  # noqa: E402
from intentbev_torch.boxes.anchors import generate_anchors  # noqa: E402
from intentbev_torch.models import build_model  # noqa: E402
from intentbev_torch.train import StepDraws, make_optimizer, make_train_step  # noqa: E402

WORLD, LOCAL = 2, 2
GLOBAL = WORLD * LOCAL
WORKER_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
METRICS = ("loss", "cls_loss", "box_loss", "intent_loss", "num_pos_anchors")


def _configs(m, family="vit", **loss_kw):
    """The tiny config of module ``m`` (the JAX or the port configs): drop-path
    0, the patch dropout always on, a global batch of 4, eval batch 4 with
    the caps open."""
    c = m.tiny_test_config()
    return dataclasses.replace(
        c, model_family=family, vit=dataclasses.replace(c.vit, drop_path_rate=0.0),
        augment=dataclasses.replace(c.augment, dropout_prob=1.0),
        loss=dataclasses.replace(c.loss, **loss_kw),
        train=dataclasses.replace(c.train, batch_size=GLOBAL),
        eval=dataclasses.replace(c.eval, batch_size=GLOBAL, max_pre_nms=192,
                                 max_detections=64))


def _batch(seed, grid, max_gt):
    """A global batch of GLOBAL samples in the points transport (f32)."""
    rng = np.random.default_rng(seed)
    b, s, p = GLOBAL, grid.lidar_sweeps, 1200
    pts = np.zeros((b, s, p, 4), np.float32)
    pts[..., 0] = rng.uniform(grid.bev_x_min - 3, grid.bev_x_max + 3, (b, s, p))
    pts[..., 1] = rng.uniform(grid.bev_y_min - 3, grid.bev_y_max + 3, (b, s, p))
    pts[..., 2] = rng.uniform(-2.5, 4.2, (b, s, p))
    pts[..., 3] = np.round(rng.uniform(0, 255, (b, s, p)))
    boxes = np.zeros((b, max_gt, 5), np.float32)
    boxes[..., 0] = rng.uniform(-2, 10, (b, max_gt))
    boxes[..., 1] = rng.uniform(-8, 8, (b, max_gt))
    boxes[..., 2] = rng.uniform(1.5, 3, (b, max_gt))
    boxes[..., 3] = rng.uniform(3, 6, (b, max_gt))
    boxes[..., 4] = rng.uniform(-3, 3, (b, max_gt))
    return {
        "points": pts, "points_valid": rng.uniform(size=(b, s, p)) < 0.9,
        "map_bev": (rng.uniform(size=(b, grid.height_px, grid.width_px, grid.map_channels))
                    < 0.05).astype(np.float32),
        "gt_boxes": boxes, "gt_intentions": rng.integers(0, 8, (b, max_gt)).astype(np.int32),
        "gt_valid": rng.uniform(size=(b, max_gt)) < 0.7,
        "aug_params": np.array([[-1, 0, 1.04], [1, 0, 0.96], [1, 0.1, 1.0], [-1, -0.2, 1.02]],
                               np.float32),
    }


def _tensors(batch, rows=slice(None)):
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in batch.items()}


def _port_step(cfg, state, batch, draws=None, seed=None, weights=None):
    """One step of the port on one process: (metrics, gradients, state
    after the step)."""
    model = build_model(cfg)
    model.load_state_dict(state)
    anchors = torch.from_numpy(generate_anchors(cfg.grid, cfg.anchors))
    step = make_train_step(model, cfg, anchors, make_optimizer(model.parameters(), cfg),
                           weights)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    m = step(_tensors(batch), gen, draws)
    return ({k: float(v) for k, v in m.items()},
            {k: p.grad.clone() for k, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()})


# ---------------------------------------------------------------------------
# the workers (two gloo ranks; no JAX)
# ---------------------------------------------------------------------------

def _worker(rank: int, world: int, port: int, work: Path) -> None:
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        torch.save(_worker_run(rank, torch.load(work / "inputs.pt", weights_only=False)),
                   work / f"out_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _worker_run(rank: int, inp: dict) -> dict:
    from intentbev_torch.evaluate import evaluate
    from intentbev_torch.parallel import (StreamingInferencer, create_mesh, local_batch_slice,
                                          make_sharded_train_step, param_shardings,
                                          shard_train_state)

    out: dict = {}
    mesh = create_mesh(tcfg.MeshConfig(), "cpu")
    out["mesh"] = (tuple(mesh.shape), mesh.mesh_dim_names)
    mesh_tp = create_mesh(tcfg.MeshConfig(model_parallel=2), "cpu")
    shardings = param_shardings(build_model(_configs(tcfg)), mesh_tp, tcfg.MeshConfig())
    out["mesh_tp"] = tuple(mesh_tp.shape)
    out["placements"] = {k: tuple(p.dim if p.is_shard() else None for p in v)
                         for k, v in shardings.items()}

    rows = slice(rank * LOCAL, (rank + 1) * LOCAL)
    for name, case in inp["steps"].items():
        cfg = case["cfg"]
        model = build_model(cfg)
        model.load_state_dict(case["state"])
        if rank:  # rank 0's state reaches every rank
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        opt = make_optimizer(model.parameters(), cfg)
        shard_train_state(model, opt, mesh, cfg)
        anchors = torch.from_numpy(generate_anchors(cfg.grid, cfg.anchors))
        step = make_sharded_train_step(model, cfg, anchors, opt, mesh, case.get("weights"))
        gen = None if case.get("seed") is None else torch.Generator().manual_seed(case["seed"])
        local = local_batch_slice({k: v[rows] for k, v in case["batch"].items()}, "cpu")
        m = step(local, gen, case.get("draws"))
        out[name] = ({k: float(v) for k, v in m.items()},
                     {k: p.grad.clone() for k, p in model.named_parameters()},
                     model.state_dict())

    ev = inp["eval"]
    out["eval"] = evaluate(ev["ckpt_dir"], ev["data_dir"], num_workers=1, log_fn=lambda *_: None,
                           device="cpu", distributed=True)

    sv = inp["serve"]
    inf = StreamingInferencer(sv["cfg"], sv["params"], "cpu", mesh=mesh)
    out["batch_multiple"] = inf.batch_multiple
    local = [{k: v[rows] for k, v in b.items()} for b in sv["batches"]]
    out["call"] = inf(local[0]["points"], local[0]["points_valid"], local[0]["map_bev"])
    out["stream"] = list(inf.stream(local))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(work: Path) -> list[dict]:
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(WORLD), str(port), str(work)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(WORLD)]
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
    return [torch.load(work / f"out_rank{r}.pt", weights_only=False) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# the references (JAX and one process) and the one launch of the workers
# ---------------------------------------------------------------------------

def _jax_draws(rng_aug, rng_loss, jc, n_anchors) -> StepDraws:
    """The random numbers JAX's step draws from its keys for the global
    batch (its patch dropout per sample, its intention drop's uniforms), as
    the port's StepDraws."""
    import jax

    g, a = jc.grid, jc.augment
    m = a.dropout_num_patches[1]
    lo, hi = a.dropout_patch_px
    rows = []
    for key in jax.random.split(rng_aug, GLOBAL):
        kd = jax.random.split(key, 2 + 5 * 4)
        per = []
        for j in range(m):
            kj = kd[2 + j * 4: 2 + (j + 1) * 4]
            ph = int(jax.random.randint(kj[0], (), lo, hi + 1))
            pw = int(jax.random.randint(kj[1], (), lo, hi + 1))
            per.append((ph, pw, int(jax.random.randint(kj[2], (), 0, max(1, g.height_px - ph + 1))),
                        int(jax.random.randint(kj[3], (), 0, max(1, g.width_px - pw + 1)))))
        rows.append((bool(jax.random.bernoulli(kd[0], float(a.dropout_prob))),
                     int(jax.random.randint(kd[1], (), a.dropout_num_patches[0], m + 1)), per))
    per = torch.tensor([r[2] for r in rows], dtype=torch.long)
    dropout = DropoutDraws(torch.tensor([r[0] for r in rows]),
                           torch.tensor([r[1] for r in rows], dtype=torch.long), *per.unbind(-1))
    u = torch.from_numpy(np.array(jax.random.uniform(rng_loss, (GLOBAL * n_anchors,))))
    return StepDraws(dropout, u)


def _jax_step(family, batch):
    """JAX's single-device step on the global batch -> (initial variables
    as a port state dict, the step's draws, metrics, state dict after)."""
    import jax
    import jax.numpy as jnp

    from intentbev import configs as jcfg
    from intentbev import train as jtrain
    from intentbev.models import build_model as jbuild_model
    from intentbev_torch.weights import from_flax

    jc = _configs(jcfg, family)
    model = jbuild_model(jc, train_mode=True)
    tx = jtrain.make_optimizer(jc)
    state = jtrain.init_train_state(model, jc, tx, jax.random.key(0))
    init = from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    rng = jax.random.key(1)
    rng_aug, rng_loss, _ = jax.random.split(jax.random.fold_in(rng, state.step), 3)
    anchors = generate_anchors(_configs(tcfg).grid, _configs(tcfg).anchors)
    draws = _jax_draws(rng_aug, rng_loss, jc, anchors.shape[0])
    new_state, metrics = jtrain.make_train_step(model, jc, jnp.asarray(anchors), tx)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    after = from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    return init, draws, {k: float(v) for k, v in metrics.items()}, after


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The references, then one launch of the two gloo workers over the same
    inputs: {"jax": ..., "one": ..., "ranks": [rank 0's outputs, rank 1's]}."""
    from intentbev_torch.checkpoint import save_checkpoint
    from intentbev_torch.data.synthetic import write_synthetic_log
    from intentbev_torch.evaluate import evaluate
    from intentbev_torch.models import init_params
    from intentbev_torch.parallel import StreamingInferencer
    from intentbev_torch.precompute_labels import run as precompute_labels

    work = tmp_path_factory.mktemp("dp")
    cfg = _configs(tcfg)
    g, max_gt = cfg.grid, cfg.loss.max_gt_boxes
    jax_ref, one, steps = {}, {}, {}
    for family, seed in (("vit", 0), ("cnn", 1)):
        batch = _batch(seed, g, max_gt)
        init, draws, metrics, after = _jax_step(family, batch)
        fcfg = _configs(tcfg, family)
        jax_ref[family] = (metrics, after)
        one[family] = _port_step(fcfg, init, batch, draws)
        steps[family] = {"cfg": fcfg, "state": init, "batch": batch, "draws": draws}
    vit_init, vit_batch = steps["vit"]["state"], steps["vit"]["batch"]
    # every draw from one generator seed: drop-path 0.1 and the patch dropout
    gcfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, drop_path_rate=0.1))
    one["vit_gen"] = _port_step(gcfg, vit_init, vit_batch, seed=5)
    steps["vit_gen"] = {"cfg": gcfg, "state": vit_init, "batch": vit_batch, "seed": 5}
    # the intention class weights (read where the dominant-class drop is off)
    wcfg = _configs(tcfg, apply_intention_downsampling=False)
    weights = torch.linspace(0.01, 0.5, 8)
    one["weights"] = _port_step(wcfg, vit_init, vit_batch, steps["vit"]["draws"], weights=weights)
    one["unweighted"] = _port_step(wcfg, vit_init, vit_batch, steps["vit"]["draws"])
    steps["weights"] = {"cfg": wcfg, "state": vit_init, "batch": vit_batch,
                        "draws": steps["vit"]["draws"], "weights": weights}

    # eval: 2 logs x 5 sequences, a tiny checkpoint of random weights
    split = work / "data" / "train"
    for k in range(2):
        write_synthetic_log(split, log_id=f"dplog{k}", num_frames=g.lidar_sweeps + 4,
                            points_per_sweep=400, seed=k,
                            vehicles=[{"start": (4.0 + 2 * k, 1.0), "velocity": (1.0, 0.0)},
                                      {"start": (-2.0, -4.0), "velocity": (0.0, 0.5)}])
    precompute_labels(str(work / "data"), ["train"], force=True)
    params = init_params(cfg, seed=3)
    save_checkpoint(work / "run", 1, {"model": params}, cfg)
    one["eval"] = evaluate(str(work / "run"), str(split), num_workers=1, log_fn=lambda *_: None,
                           device="cpu")
    serve_batches = [{k: v for k, v in _batch(s, g, max_gt).items()
                      if k in ("points", "points_valid", "map_bev")} for s in (7, 8)]
    inf = StreamingInferencer(cfg, params, "cpu")
    one["serve"] = [inf(b["points"], b["points_valid"], b["map_bev"]) for b in serve_batches]

    torch.save({"steps": steps,
                "eval": {"ckpt_dir": str(work / "run"), "data_dir": str(split)},
                "serve": {"cfg": cfg, "params": params, "batches": serve_batches}},
               work / "inputs.pt")
    return {"jax": jax_ref, "one": one, "ranks": _run_workers(work)}


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


@pytest.mark.parametrize("n,mp,dp", [(8, 1, -1), (8, 2, -1), (8, 3, -1), (4, 2, 2), (8, 2, 2),
                                     (2, 1, -1), (1, 1, -1), (6, 2, -1), (8, 4, 1)])
def test_mesh_shapes_and_errors_match_jax(n, mp, dp):
    import jax

    from intentbev import configs as jcfg
    from intentbev.parallel.mesh import create_mesh as jcreate_mesh
    from intentbev_torch.parallel.mesh import mesh_shape

    jc, tc = (m.MeshConfig(model_parallel=mp, data_parallel=dp) for m in (jcfg, tcfg))
    try:
        want = jcreate_mesh(jc, jax.devices()[:n]).devices.shape
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split()[0]):
            mesh_shape(tc, n)
        return
    assert mesh_shape(tc, n) == want


def test_shard_sequences_for_process_matches_jax():
    from intentbev.parallel.mesh import shard_sequences_for_process as jshard
    from intentbev_torch.parallel.mesh import shard_sequences_for_process as tshard

    seqs = [f"seq{i}" for i in range(23)]
    for n, bs in ((1, 8), (2, 8), (4, 8), (8, 8), (3, 6)):
        for p in range(n):
            assert tshard(seqs, p, n, bs) == jshard(seqs, p, n, bs)
    for args in ((seqs, 0, 0, 8), (seqs, 2, 2, 8), (seqs, 0, 3, 8), (seqs, -1, 2, 8)):
        with pytest.raises(ValueError) as want:
            jshard(*args)
        with pytest.raises(ValueError, match=str(want.value).split()[0]):
            tshard(*args)


def test_sharding_rules_by_parameter_name(runs):
    import jax

    from intentbev import configs as jcfg
    from intentbev.models import build_model as jbuild_model
    from intentbev.parallel import create_mesh as jcreate_mesh
    from intentbev.parallel import param_shardings as jparam_shardings
    from intentbev_torch.parallel.sharding import param_spec
    from intentbev_torch.weights import _key

    jc = jcfg.tiny_test_config()
    g = jc.grid
    params = jax.eval_shape(  # shapes are all the rules read
        jbuild_model(jc).init, jax.random.key(0),
        np.zeros((1, g.height_px, g.width_px, g.lidar_total_channels), np.float32),
        np.zeros((1, g.height_px, g.width_px, g.map_channels), np.float32))["params"]
    specs = jparam_shardings(params, jcreate_mesh(jcfg.MeshConfig(model_parallel=2)),
                             jc.mesh)
    port = dict(build_model(_configs(tcfg)).named_parameters())
    seen = 0
    for path, sharding in jax.tree_util.tree_flatten_with_path(specs)[0]:
        names = tuple(k.key for k in path)
        name = _key(names)
        want = tuple(sharding.spec) + (None,) * (port[name].dim() - len(sharding.spec))
        if names[-1] == "kernel" and port[name].dim() == 2:
            want = want[::-1]  # flax [in, out] -> the port's [out, in]
        got = param_spec(name, port[name].dim())
        assert got + (None,) * (port[name].dim() - len(got)) == want, name
        seen += any(want)
    assert seen == 2 * 2 * 6  # qkv w/b, proj w, fc1 w/b, fc2 w: 2 streams x 2 blocks
    placements = runs["ranks"][0]["placements"]
    assert runs["ranks"][0]["mesh_tp"] == (1, 2)
    # (data, model) placements: the dimension split over each, None replicated
    assert placements["backbone.vit_lidar.blocks.0.attn.qkv.weight"] == (None, 0)
    assert placements["backbone.vit_lidar.blocks.0.attn.qkv.bias"] == (None, 0)
    assert placements["backbone.vit_map.blocks.1.mlp.fc2.weight"] == (None, 1)
    assert placements["backbone.vit_map.blocks.1.mlp.fc2.bias"] == (None, None)
    assert placements["det_head.conv.weight"] == (None, None)


def test_mesh_over_two_ranks(runs):
    for r in runs["ranks"]:
        assert r["mesh"] == ((2, 1), ("data", "model"))
        assert r["batch_multiple"] == 2


def _check_step(got, want_one, want_jax=None):
    m, grads, state = got
    m1, g1, s1 = want_one
    for k in METRICS:
        np.testing.assert_allclose(m[k], m1[k], rtol=1e-5, err_msg=k)
    for k, v in g1.items():
        _close(grads[k].numpy(), v.numpy(), 1e-4, f"grad {k}")
    for k, v in s1.items():
        if v.is_floating_point():
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=5e-4, err_msg=k)
    if want_jax is not None:
        mj, sj = want_jax
        assert mj["num_pos_anchors"] > 0
        for k in METRICS:
            np.testing.assert_allclose(m[k], mj[k], rtol=2e-4, err_msg=k)
        for k, v in sj.items():
            if k.endswith(("running_mean", "running_var")):
                _close(state[k].numpy(), v.numpy(), 1e-4, k)
            elif v.is_floating_point():
                np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=5e-4, err_msg=k)


@pytest.mark.parametrize("family", ["vit", "cnn"])
def test_dp_step_matches_jax_and_one_process(runs, family):
    for r in runs["ranks"]:
        _check_step(r[family], runs["one"][family], runs["jax"][family])
    if family == "cnn":  # BatchNorm's statistics are the global batch's on every rank
        a, b = (r[family][2] for r in runs["ranks"])
        for k in a:
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())


def test_dp_step_draws_for_the_global_batch(runs):
    """Drop-path 0.1 and the patch dropout from generator seed 5: two ranks
    take the step one process takes from that seed."""
    for r in runs["ranks"]:
        _check_step(r["vit_gen"], runs["one"]["vit_gen"])


def test_intention_weights_under_dp(runs):
    for r in runs["ranks"]:
        _check_step(r["weights"], runs["one"]["weights"])
        assert abs(r["weights"][0]["intent_loss"] - runs["one"]["unweighted"][0]["intent_loss"]) \
            > 1e-6


def test_distributed_eval_matches_one_process(runs):
    want = runs["one"]["eval"]
    assert want["num_samples"] == 10
    for r in runs["ranks"]:
        got = r["eval"]
        assert set(got) == set(want)
        for k, v in want.items():
            if k.startswith("mAP@") or k.startswith("intention_"):
                assert abs(got[k] - v) <= 1e-6, (k, got[k], v)
            else:
                assert got[k] == v, (k, got[k], v)


def test_meshed_inferencer_matches_one_process(runs):
    want = runs["one"]["serve"]
    for r in runs["ranks"]:
        for got, ref in ((r["call"], want[0]), *zip(r["stream"], want)):
            for name, a, b in zip(got._fields, got, ref):
                assert a.shape == b.shape and a.dtype == b.dtype, name
                if a.dtype.kind == "f":
                    np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=name)
        assert r["call"].valid.any()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
