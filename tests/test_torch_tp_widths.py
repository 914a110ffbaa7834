"""The port's tensor parallelism at the named ViTs' widths, against the
port's one-process step and JAX's single-device step on the CPU.

ViT-B's widths (768, 12 heads of 64, MLP hidden 3072) and ViT-Ti's (192, 3
heads of 64, 768) at depth 1 on the tiny grid, flash on (the plain versions
of the attention entries: the packed ones where a rank's heads pair, the
BHTD ones where they do not), each at two model axes:

- ViT-B at mp=2 (6 heads a rank) and mp=8 (the uneven split: 2, 2, 2, 2,
  1, 1, 1, 1 heads);
- ViT-Ti at mp=2 (2 and 1 heads) and mp=4 (1, 1, 1 and a rank with none,
  which runs no qkv product and no attention and adds a zero partial).

One launch of 8 gloo ranks runs every case, each over its own (data,
model) mesh of the 8 ranks: (4, 2), (1, 8), (4, 2) and (2, 4); the global
batch of 4 is the ranks' local batches in order. The harness is
``tests/test_torch_tp.py``'s: the references are computed in the test
process, the inputs pass through ``tmp_path``, the workers (started from
this file's ``__main__`` block; a worker by hand: ``python
tests/test_torch_tp_widths.py RANK 8 PORT DIR``) import no JAX, a 60 s group
timeout, and the test kills them when they are not done within 240 s.

Readings and tolerances (``tests/test_torch_tp.py``'s):

- each case's step, its gradients and its parameters after AdamW gathered
  to full tensors (``full_tensor`` pads the uneven shards for the gather),
  on every rank, against the port's one-process step on the global batch:
  the loss terms rtol 1e-5, every gradient 1e-5 of its tensor's largest
  value, the parameters atol 5e-4 (AdamW's first step moves a parameter by
  about the learning rate times the sign of its gradient, so the f32
  summation noise of a gradient near 0 reaches the learning rate: at
  ViT-B's widths 6 of 1769472 qkv weights differ by up to 2.8e-5);
- against JAX's single-device ``make_train_step`` with JAX's draws: the
  loss terms rtol 2e-4 and every parameter after the step atol 5e-4, the
  bounds of JAX's own mp=2 test (``tests/test_parallel.py``);
- every replicated parameter's gradient is the same, bit for bit, on the
  ranks of one data index;
- ``train()`` at ViT-Ti's widths over mp=8 (1, 1, 1 heads and five ranks
  without) writes, at step 2, checkpoints of full tensors in the
  one-process layout that match the one-process run's, and one process
  resumes from one to step 3 as the one-process run does (atol 5e-4 on the
  parameters, 1e-4 of their tensor's largest value on the AdamW moments).
"""

from __future__ import annotations

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
from intentbev_torch.models import build_model  # noqa: E402
from intentbev_torch.train import make_optimizer  # noqa: E402
from test_torch_parallel import GLOBAL, _batch, _free_port, _tensors  # noqa: E402
from test_torch_tp import (METRICS, _ckpt, _ckpt_close, _close, _configs,  # noqa: E402
                           _jax_step, _one_process)

WORLD = 8
WORKER_TIMEOUT_S = 240
GROUP_TIMEOUT_S = 60
WIDTHS = {"vit_base": dict(embed_dim=768, num_heads=12, depth=1),
          "vit_tiny": dict(embed_dim=192, num_heads=3, depth=1)}
CASES = [("vit_base", 2), ("vit_base", 8), ("vit_tiny", 2), ("vit_tiny", 4)]
TRAIN_MP = 8  # train() at ViT-Ti's widths: 3 heads over 8 ranks


def _case_id(model, mp):
    return f"{model}-mp{mp}"


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
        torch.save(_worker_run(inp), work / f"out_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _worker_run(inp: dict) -> dict:
    from intentbev_torch.parallel import create_mesh, make_sharded_train_step, shard_train_state
    from intentbev_torch.parallel.mesh import data_group, model_group
    from intentbev_torch.parallel.sharding import model_dim
    from intentbev_torch.parallel.train_dp import full_tensor, gather_train_state
    from intentbev_torch.train import train

    out: dict = {}
    for (model_name, mp), case in inp["cases"].items():
        cfg = _configs(tcfg, WIDTHS[model_name], mp=mp)
        mesh = create_mesh(cfg.mesh, "cpu")
        dg, mg = data_group(mesh, cfg.mesh), model_group(mesh, cfg.mesh)
        n = GLOBAL // dg.size
        model = build_model(cfg, dtype=torch.float32, param_dtype=torch.float32)
        model.load_state_dict(case["state"])
        opt = make_optimizer(model.parameters(), cfg)
        shard_train_state(model, opt, mesh, cfg)
        anchors = torch.from_numpy(generate_anchors(cfg.grid, cfg.anchors))
        step = make_sharded_train_step(model, cfg, anchors, opt, mesh)
        m = step(_tensors(case["batch"], slice(dg.rank * n, (dg.rank + 1) * n)), None,
                 case["draws"])
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        out[model_name, mp] = (
            {k: float(v) for k, v in m.items()},
            {k: full_tensor(k, g, mg, cfg) for k, g in grads.items()},
            gather_train_state(model, opt, mesh, cfg)[0],
            {k: g for k, g in grads.items() if model_dim(k, g.dim()) is None},
            (dg.rank, mg.rank))
    tr = inp["train"]
    cfg = _configs(tcfg, WIDTHS["vit_tiny"], mp=TRAIN_MP)
    train(cfg, tr["data_dir"], tr["tp_dir"], max_steps=2, num_workers=1,
          log_fn=lambda *_: None, device="cpu", distributed=True)
    return out


def _run_workers(work: Path) -> list[dict]:
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(WORLD), str(port),
                               str(work)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
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
# the references (JAX and one process) and one launch of the ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's steps and the one-process steps of each width, the
    one-process train() run, and the ranks' outputs."""
    from intentbev_torch.data.synthetic import write_synthetic_log
    from intentbev_torch.precompute_labels import run as precompute_labels
    from intentbev_torch.train import train

    work = tmp_path_factory.mktemp("tp_widths")
    g = _configs(tcfg).grid
    batch = _batch(1, g, _configs(tcfg).loss.max_gt_boxes)
    jax_ref, one, inputs = {}, {}, {}
    for model_name, vit in WIDTHS.items():
        init, draws, metrics, after = _jax_step(vit, batch)
        jax_ref[model_name] = (metrics, after)
        one[model_name] = _one_process(_configs(tcfg, vit), init, batch, draws)
        inputs[model_name] = {"state": init, "batch": batch, "draws": draws}

    split = work / "data" / "train"
    for k in range(2):
        write_synthetic_log(split, log_id=f"tpwlog{k}", num_frames=g.lidar_sweeps + 4,
                            points_per_sweep=400, seed=k,
                            vehicles=[{"start": (4.0 + 2 * k, 1.0), "velocity": (1.0, 0.0)},
                                      {"start": (-2.0, -4.0), "velocity": (0.0, 0.5)}])
    precompute_labels(str(work / "data"), ["train"], force=True)
    dirs = {k: str(work / k) for k in ("one", "tp", "tp_resumed")}
    cfg = _configs(tcfg, WIDTHS["vit_tiny"])
    kw = dict(num_workers=1, log_fn=lambda *_: None, device="cpu")
    train(cfg, str(split), dirs["one"], max_steps=2, **kw)
    train(cfg, str(split), dirs["one"], max_steps=3, resume=True, **kw)
    torch.save({"cases": {(m, mp): inputs[m] for m, mp in CASES},
                "train": {"data_dir": str(split), "tp_dir": dirs["tp"]}}, work / "inputs.pt")
    ranks = _run_workers(work)
    return {"jax": jax_ref, "one": one, "ranks": ranks, "dirs": dirs, "split": str(split)}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,mp", CASES, ids=[_case_id(*c) for c in CASES])
def test_tp_step_matches_one_process(runs, model, mp):
    m1, g1, s1 = runs["one"][model]
    assert m1["num_pos_anchors"] > 0
    for r in runs["ranks"]:
        m, grads, state = r[model, mp][:3]
        for k in METRICS:
            np.testing.assert_allclose(m[k], m1[k], rtol=1e-5, err_msg=k)
        assert set(grads) == set(g1) and set(state) == set(s1)
        for k, v in g1.items():
            _close(grads[k].numpy(), v.numpy(), 1e-5, f"grad {k}")
        for k, v in s1.items():
            assert state[k].shape == v.shape, k
            if v.is_floating_point():
                np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=5e-4, err_msg=k)


@pytest.mark.parametrize("model,mp", CASES, ids=[_case_id(*c) for c in CASES])
def test_tp_step_matches_jax_single_device(runs, model, mp):
    mj, sj = runs["jax"][model]
    assert mj["num_pos_anchors"] > 0
    for r in runs["ranks"]:
        m, _, state = r[model, mp][:3]
        for k in METRICS:
            np.testing.assert_allclose(m[k], mj[k], rtol=2e-4, err_msg=k)
        for k, v in sj.items():
            if k.endswith(("running_mean", "running_var")):
                _close(state[k].numpy(), v.numpy(), 1e-4, k)
            elif v.is_floating_point():
                np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=5e-4, err_msg=k)


@pytest.mark.parametrize("model,mp", CASES, ids=[_case_id(*c) for c in CASES])
def test_replicated_gradients_equal_across_the_model_axis(runs, model, mp):
    by_data: dict = {}
    for r in runs["ranks"]:
        rep, (d, _) = r[model, mp][3], r[model, mp][4]
        by_data.setdefault(d, []).append(rep)
    assert all(len(reps) == mp for reps in by_data.values())
    for reps in by_data.values():
        for other in reps[1:]:
            assert set(other) == set(reps[0])
            for k, v in reps[0].items():
                np.testing.assert_array_equal(other[k].numpy(), v.numpy(), err_msg=k)


def test_uneven_tp_checkpoint_resumes_in_one_process(runs):
    """train() over mp=8 at ViT-Ti's widths (three ranks of one head, five
    of none): its step-2 checkpoint holds the one-process run's full
    tensors; one process resumes from it to the one-process run's step 3."""
    from intentbev_torch.train import train

    d = runs["dirs"]
    _ckpt_close(_ckpt(d["tp"], 2), _ckpt(d["one"], 2))
    shutil.copytree(d["tp"], d["tp_resumed"])
    train(_configs(tcfg, WIDTHS["vit_tiny"]), runs["split"], d["tp_resumed"], max_steps=3,
          resume=True, num_workers=1, log_fn=lambda *_: None, device="cpu")
    _ckpt_close(_ckpt(d["tp_resumed"], 3), _ckpt(d["one"], 3))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
