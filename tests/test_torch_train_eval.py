"""The port's loop, checkpoints and eval against the JAX package, on the CPU.

One module-scoped split of two synthetic logs of 10 frames, written and
labelled by the port (``data.synthetic``, ``precompute_labels``): 16
sequences of 3 sweeps on the tiny config.

- Eval functions: ``rotated_iou`` against JAX's at 1e-5 absolute on random
  boxes with a contained pair and a disjoint one, and in the loss's
  rotated target assignment (identical targets);
  ``sample_average_precision`` (AP within 1e-6, TP flags and matches
  identical), ``match_intentions`` and the confusion matrix (exact) on the
  same detections, axis-aligned and rotated.
- The loop and its checkpoints, as ``tests/test_train_eval.py`` holds the
  JAX loop: the self-describing checkpoint (its parameters equal the live
  model's bit for bit), keep-3, the round trip, eval of a run, resume
  (the global step, the schedule, the epoch), the mid-epoch interrupt (the
  position kept, the schedule untouched), the intention-weight cache (the
  weights JAX's counting pass gives), the CLIs (on the CPU only when
  asked for).
- ``StreamingInferencer.stream`` over ``batch_iterator`` batches gives
  ``__call__``'s Detections.
- End to end: a JAX train state (``init_train_state`` + orbax
  ``save_checkpoint``) and its parameters through ``weights.from_flax`` in a
  port checkpoint; both ``evaluate()``s on the split give the same sample
  count, cap audits and confusion matrix, and every mAP within 1e-4, at an
  operating point where the caps cannot bind (``max_pre_nms`` and
  ``max_detections`` at the anchor count) and in the flood of the
  untrained head under the tiny caps (every sample above ``max_pre_nms``).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from intentbev import configs as jcfg  # noqa: E402
from intentbev.boxes.iou import rotated_iou as jrotated  # noqa: E402
from intentbev.losses import assign_targets as jassign  # noqa: E402
from intentbev import metrics as jmetrics  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch import metrics as tmetrics  # noqa: E402
from intentbev_torch.boxes.iou import rotated_iou  # noqa: E402
from intentbev_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint  # noqa: E402
from intentbev_torch.data.synthetic import write_synthetic_log  # noqa: E402
from intentbev_torch.losses import assign_targets  # noqa: E402
from intentbev_torch.precompute_labels import run as precompute_run  # noqa: E402
from intentbev_torch.train import train  # noqa: E402

VEHICLES = [
    {"start": (12.0, 1.75), "velocity": (6.0, 0.0), "yaw_rate": 0.35},
    {"start": (4.0, -1.75), "velocity": (4.0, 0.0), "accel": -3.0},
    {"start": (9.0, 5.25), "velocity": (0.0, 0.0)},
]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_eval")
    write_synthetic_log(root / "train", log_id="traininglog01", num_frames=10, seed=0)
    write_synthetic_log(root / "train", log_id="traininglog02", num_frames=10, seed=1,
                        vehicles=VEHICLES)
    assert precompute_run(str(root), ["train"], force=True)["ok"] == 2
    return root / "train"


def _tiny(mod):
    cfg = mod.tiny_test_config()
    grid = dataclasses.replace(cfg.grid, lidar_sweeps=3)
    vit = dataclasses.replace(cfg.vit, lidar_input_channels=grid.lidar_total_channels)
    tr = dataclasses.replace(cfg.train, batch_size=2, num_epochs=1, log_every_steps=2,
                             checkpoint_every_steps=1000)
    return dataclasses.replace(cfg, grid=grid, vit=vit, train=tr)


@pytest.fixture(scope="module")
def tiny_cfg():
    return _tiny(tcfg)


def _quiet(*_):
    pass


def _run(cfg, split, out, **kw):
    kw.setdefault("num_workers", 1)
    kw.setdefault("log_fn", _quiet)
    return train(cfg, str(split), str(out), device="cpu", **kw)


# ---------------------------------------------------------------- IoU, metrics

def _boxes(rng, n, spread=4.0):
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(0.5, 3.0, n)
    b[:, 3] = rng.uniform(1.0, 6.0, n)
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_rotated_iou_matches_jax(rng):
    a, b = _boxes(rng, 60), _boxes(rng, 45)
    a[0], b[0] = [0, 0, 1, 1, 0.3], [0, 0, 4, 4, 0.1]      # a inside b
    a[1], b[1] = [50, 50, 2, 4, 0.2], [-50, 0, 2, 4, 1.0]  # no overlap with anything
    a[2] = b[2] = [1, 2, 2, 4.5, 0.7]                       # the same box
    a[3] = [0, 0, 0, 2, 0]                                  # zero area
    want = np.asarray(jrotated(jnp.asarray(a), jnp.asarray(b)))
    got = rotated_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert 0.05 < (want > 0).mean() < 0.9
    assert abs(want[0, 0] - 1 / 16) < 1e-6 and want[1].max() == 0 and want[3].max() == 0
    assert abs(want[2, 2] - 1.0) < 1e-6
    batched = rotated_iou(torch.from_numpy(np.stack([a, a[::-1]])),
                          torch.from_numpy(np.stack([b, b]))).numpy()
    np.testing.assert_array_equal(batched[0], got)
    np.testing.assert_array_equal(batched[1], got[::-1])


def test_rotated_target_assignment_matches_jax(rng):
    jc, tc = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    from intentbev.boxes.anchors import generate_anchors

    anchors = generate_anchors(jc.grid, jc.anchors)
    b, g = 2, 8
    boxes = _boxes(rng, b * g, 6.0).reshape(b, g, 5)
    boxes[..., 2], boxes[..., 3] = 2.0, 4.5
    boxes[1, 0] = [*anchors[200, :2], 2.1, 4.4, 0.05]  # a near-anchor box: positives
    intents = rng.integers(0, 8, (b, g)).astype(np.int32)
    valid = rng.uniform(size=(b, g)) < 0.8
    valid[1, 0] = True
    lj = dataclasses.replace(jc.loss, use_rotated_iou=True)
    lt = dataclasses.replace(tc.loss, use_rotated_iou=True)
    want = jassign(*map(jnp.asarray, (anchors, boxes, intents, valid)), lj)
    got = assign_targets(*map(torch.from_numpy, (anchors, boxes, intents, valid)), lt)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want.cls_targets))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want.intent_targets))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want.box_targets), atol=1e-5, rtol=0)
    assert (np.asarray(want.cls_targets) == 1).sum() >= 1


def _detections(rng, b=6, p=24, g=8):
    pred = _boxes(rng, b * p, 6.0).reshape(b, p, 5)
    gt = np.concatenate([pred[:, :g // 2] + rng.normal(0, 0.25, (b, g // 2, 5)),
                         _boxes(rng, b * (g - g // 2), 6.0).reshape(b, -1, 5)], 1)
    gt = gt.astype(np.float32)
    pv = rng.uniform(size=(b, p)) < 0.75
    gv = rng.uniform(size=(b, g)) < 0.8
    pv[0], gv[1], pv[2], gv[2] = False, False, False, False  # the edge rules
    pi = rng.integers(0, 8, (b, p)).astype(np.int32)
    gi = rng.integers(0, 8, (b, g)).astype(np.int32)
    return pred, pv, pi, gt, gv, gi


@pytest.mark.parametrize("rotated", [False, True], ids=["axis_aligned", "rotated"])
def test_metrics_match_jax(rng, rotated):
    pred, pv, pi, gt, gv, gi = _detections(rng)
    j = jax.vmap(lambda *a: jmetrics.sample_average_precision(*a, use_rotated_iou=rotated))(
        *map(jnp.asarray, (pred, pv, gt, gv)))
    t = tmetrics.sample_average_precision(*map(torch.from_numpy, (pred, pv, gt, gv)),
                                          use_rotated_iou=rotated)
    np.testing.assert_allclose(t.ap.numpy(), np.asarray(j.ap), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t.tp_flags.numpy(), np.asarray(j.tp_flags))
    np.testing.assert_array_equal(t.matched_gt.numpy(), np.asarray(j.matched_gt))
    ap = np.asarray(j.ap)
    assert ap[0].max() == 0 and (ap[2] == 1).all() and ap[3:].max() > 0  # edges, and TPs
    jm = jax.vmap(lambda *a: jmetrics.match_intentions(*a, use_rotated_iou=rotated))(
        *map(jnp.asarray, (pred, pv, pi, gt, gv, gi)))
    tm = tmetrics.match_intentions(*map(torch.from_numpy, (pred, pv, pi, gt, gv, gi)),
                                   use_rotated_iou=rotated)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jconf = jmetrics.IntentionConfusion.zeros(8).update(*(x.reshape(-1) for x in jm))
    tconf = tmetrics.IntentionConfusion.zeros(8).update(*tm)
    np.testing.assert_array_equal(tconf.matrix.numpy(), np.asarray(jconf.matrix))
    assert int(tconf.matrix.sum()) > 0
    for m in (tconf.matrix, torch.eye(8, dtype=torch.int64) * 3, torch.zeros(8, 8)):
        want = jmetrics.confusion_to_metrics(jnp.asarray(m.numpy()))
        got = tmetrics.confusion_to_metrics(m)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6,
                                       err_msg=k)
    recall, precision = np.array([0.2, 0.4, 0.4, 0.8]), np.array([1.0, 0.5, 0.66, 0.5])
    assert tmetrics.calculate_ap_np(recall, precision) == jmetrics.calculate_ap_np(
        recall, precision)


# ------------------------------------------------------- the loop, checkpoints

class TestTrainLoop:
    def test_train_saves_selfdescribing_checkpoint(self, split, tiny_cfg, tmp_path):
        out = tmp_path / "run"
        live = {}
        metrics = _run(tiny_cfg, split, out, num_workers=2, max_steps=3, state_out=live)
        assert metrics["loss"] > 0
        cfg_json = json.loads((out / "config.json").read_text())
        assert cfg_json["__dataclass__"] == "ExperimentConfig"
        assert cfg_json == jcfg.config_to_dict(_tiny(jcfg))  # the JAX package reads it
        assert list(out.glob("step_*"))
        state, cfg2 = load_checkpoint(out)
        assert cfg2 == tiny_cfg and state["step"] == live["step"] == 3
        sd = live["model"].state_dict()
        assert set(sd) == set(state["model"])
        for k, v in sd.items():
            assert torch.equal(state["model"][k], v), k
        assert (out / "metrics.jsonl").read_text().count("\n") == 1  # step 2 of 3

    def test_checkpoint_roundtrip_and_keep3(self, split, tiny_cfg, tmp_path):
        out = tmp_path / "run2"
        cfg = dataclasses.replace(tiny_cfg, train=dataclasses.replace(
            tiny_cfg.train, checkpoint_every_steps=1))
        _run(cfg, split, out, max_steps=5)
        state, cfg2 = load_checkpoint(out)
        assert cfg2.grid.lidar_sweeps == tiny_cfg.grid.lidar_sweeps
        assert cfg2.model_family == tiny_cfg.model_family
        assert {"model", "optimizer", "step", "loop", "generator"} <= set(state)
        assert state["step"] == 5 and latest_step(out) == 5
        assert sorted(p.name for p in out.glob("step_*")) == \
            ["step_00000003", "step_00000004", "step_00000005"]
        older, _ = load_checkpoint(out, step=4)
        assert older["step"] == 4 and older["loop"]["epoch_batch"] == 4

    def test_eval_of_a_run(self, split, tiny_cfg, tmp_path):
        from intentbev_torch.evaluate import evaluate

        out = tmp_path / "run3"
        _run(tiny_cfg, split, out, max_steps=2)
        logs = []
        results = evaluate(str(out), str(split), num_workers=1, log_fn=logs.append,
                           device="cpu")
        assert results["num_samples"] == 16  # 2 logs x (10 frames - 3 + 1)
        for t in (0.5, 0.6, 0.7, 0.8, 0.9):
            assert 0.0 <= results[f"mAP@{t:.1f}"] <= 1.0
        joined = "\n".join(logs)
        assert "mAP @ IoU=0.5" in joined
        # 2 steps in, the objectness head floods: every sample above the cap
        assert results["pre_nms_overflow"] == 16 and "caps bound" in joined
        few = evaluate(str(out), str(split), num_workers=1, log_fn=_quiet, device="cpu",
                       max_batches=1)
        assert few["num_samples"] == 8


class TestFaithfulResume:
    def test_resume_continues_lr_epoch_and_step(self, split, tiny_cfg, tmp_path):
        out = tmp_path / "resume_run"
        cfg1 = dataclasses.replace(tiny_cfg, train=dataclasses.replace(
            tiny_cfg.train, num_epochs=2, checkpoint_every_steps=1))
        _run(cfg1, split, out)
        state1, _ = load_checkpoint(out)
        step1 = state1["step"]
        assert step1 == 16 and state1["loop"]["epoch"] == 2
        lr1, best1 = state1["loop"]["lr"], state1["loop"]["best"]
        assert np.isfinite(best1)

        logs = []
        cfg2 = dataclasses.replace(cfg1, train=dataclasses.replace(cfg1.train, num_epochs=3))
        _run(cfg2, split, out, log_fn=logs.append, resume=True)
        assert any(f"resumed from step {step1}" in str(line) for line in logs)
        state2, _ = load_checkpoint(out)
        assert state2["step"] == 24 and state2["loop"]["epoch"] == 3
        assert state2["loop"]["best"] <= best1 and state2["loop"]["lr"] <= lr1

    def test_mid_epoch_interrupt_saves_position_not_next_epoch(self, split, tiny_cfg,
                                                               tmp_path):
        out = tmp_path / "midresume_run"
        cfg = dataclasses.replace(tiny_cfg, train=dataclasses.replace(
            tiny_cfg.train, num_epochs=2, checkpoint_every_steps=100))
        _run(cfg, split, out, max_steps=2)  # 16 sequences / batch 2 = 8 a epoch
        state1, _ = load_checkpoint(out)
        assert state1["loop"]["epoch"] == 0 and state1["loop"]["epoch_batch"] == 2
        assert state1["loop"]["lr"] == float(np.float32(cfg.train.learning_rate))
        assert not np.isfinite(state1["loop"]["best"])
        logs = []
        _run(cfg, split, out, log_fn=logs.append, resume=True)
        assert any("epoch 0 batch 2" in str(line) for line in logs)
        state2, _ = load_checkpoint(out)
        assert state2["loop"]["epoch"] == 2 and state2["loop"]["epoch_batch"] == 0
        assert state2["step"] == 2 + 6 + 8

    def test_intention_weight_cache_reused_on_resume(self, split, tiny_cfg, tmp_path):
        from intentbev.data.argoverse import ArgoverseSampleLoader, ScenarioValidator
        from intentbev.data.argoverse import build_sequence_index
        from intentbev.train import compute_intention_class_weights

        out = tmp_path / "wcache_run"
        cfg = dataclasses.replace(tiny_cfg, loss=dataclasses.replace(
            tiny_cfg.loss, apply_intention_downsampling=False))
        logs1: list = []
        _run(cfg, split, out, max_steps=1, log_fn=logs1.append, use_intention_weights=True)
        assert any("computing intention class weights" in str(x) for x in logs1)
        cache = json.loads((out / "intent_weights.json").read_text())
        assert len(cache["weights"]) == 8
        jc = _tiny(jcfg)
        seqs = build_sequence_index(ScenarioValidator(str(split), verbose=False)
                                    .find_valid_scenarios(), 3)
        want = compute_intention_class_weights(
            seqs, ArgoverseSampleLoader(jc.grid, max_gt=jc.loss.max_gt_boxes, verbose=False))
        np.testing.assert_array_equal(np.asarray(cache["weights"], np.float32), want)
        assert want.max() > 2 * want.min()  # the classes are not balanced

        logs2: list = []
        _run(cfg, split, out, max_steps=2, log_fn=logs2.append, use_intention_weights=True,
             resume=True)
        assert any("(cached)" in str(x) for x in logs2)
        assert not any("computing intention class weights" in str(x) for x in logs2)


def test_clis_take_the_card_unless_asked(split, tmp_path, monkeypatch):
    """``python -m intentbev_torch.train`` / ``.evaluate``: without a CUDA
    device they raise unless ``--device cpu`` is given."""
    from intentbev_torch import evaluate as tevaluate
    from intentbev_torch import train as ttrain

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "cli"
    args = ["--data_dir", str(split), "--out_dir", str(out), "--tiny-smoke", "--max_steps",
            "1", "--num_workers", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(args)
    ttrain.main(args + ["--device", "cpu"])
    assert latest_step(out) == 1
    eargs = ["--ckpt_dir", str(out), "--data_dir", str(split), "--max_batches", "1",
             "--num_workers", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tevaluate.main(eargs)
    tevaluate.main(eargs + ["--device", "cpu", "--rotated_iou"])


def test_stream_matches_call(split, tiny_cfg):
    from intentbev_torch.data.argoverse import ArgoverseSampleLoader, ScenarioValidator
    from intentbev_torch.data.argoverse import build_sequence_index
    from intentbev_torch.data.pipeline import batch_iterator
    from intentbev_torch.models import init_params
    from intentbev_torch.parallel import StreamingInferencer

    seqs = build_sequence_index(ScenarioValidator(str(split), verbose=False)
                                .find_valid_scenarios(), 3)
    loader = ArgoverseSampleLoader(tiny_cfg.grid, max_gt=8, verbose=False)
    batches = list(batch_iterator(seqs[:8], loader, 4, num_workers=1))
    assert len(batches) == 2
    for transport in ("points", "chunks"):
        inf = StreamingInferencer(tiny_cfg, init_params(tiny_cfg, seed=3), "cpu",
                                  transport=transport, num_chunks=64)
        if transport == "points":
            assert StreamingInferencer(tiny_cfg, init_params(tiny_cfg), "cpu").transport \
                == "points"  # the default, as in JAX
        streamed = list(inf.stream(b._asdict() for b in batches))
        assert len(streamed) == 2
        for det, b in zip(streamed, batches):
            want = inf(b.points, b.points_valid, b.map_bev)
            for name, x, y in zip(det._fields, det, want):
                assert isinstance(x, np.ndarray), name
                np.testing.assert_array_equal(x, y, err_msg=name)
            assert det.valid.shape == (4, tiny_cfg.eval.max_detections)


# ------------------------------------------------------------------ end to end

def _jax_checkpoint(jc, out, cls_bias_shift: float):
    """JAX's train state at init (seed 0), its detection head's objectness
    biases shifted, saved by the JAX package; -> its flax variables."""
    from intentbev import train as jtrain
    from intentbev.checkpoint import save_checkpoint as jsave
    from intentbev.models import build_model

    model = build_model(jc, train_mode=True)
    tx = jtrain.make_optimizer(jc)
    state = jtrain.init_train_state(model, jc, tx, jax.random.key(0))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    bias = params["det_head"]["conv"]["bias"].copy()
    bias[:: 1 + jc.heads.num_box_params] += cls_bias_shift
    params["det_head"]["conv"]["bias"] = bias
    variables = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}
    jsave(out, 0, {"params": params, "batch_stats": variables["batch_stats"],
                   "step": np.int32(0)}, jc)
    return variables


def _capture_confusion(monkeypatch, module):
    seen = []
    real = module.confusion_to_metrics

    def spy(matrix):
        seen.append(np.asarray(matrix))
        return real(matrix)

    monkeypatch.setattr(module, "confusion_to_metrics", spy)
    return seen


@pytest.mark.parametrize("point", ["caps_open", "flood"])
def test_eval_end_to_end_matches_jax(split, tmp_path, monkeypatch, point):
    from intentbev import evaluate as jeval_mod
    from intentbev_torch import evaluate as teval_mod
    from intentbev_torch.weights import from_flax

    jc, tc = _tiny(jcfg), _tiny(tcfg)
    n_anchor = jc.anchors.num_total_anchors(jc.grid)
    if point == "caps_open":  # the caps cannot bind: every anchor may pass
        shift = -1.5
        jc, tc = (dataclasses.replace(c, eval=dataclasses.replace(
            c.eval, max_pre_nms=n_anchor, max_detections=n_anchor)) for c in (jc, tc))
    else:
        shift = 0.0
    variables = _jax_checkpoint(jc, tmp_path / "jax", shift)
    save_checkpoint(tmp_path / "port", 0, {"model": from_flax(variables), "step": 0}, tc)
    jconf = _capture_confusion(monkeypatch, jeval_mod)
    tconf = _capture_confusion(monkeypatch, teval_mod)
    want = jeval_mod.evaluate(str(tmp_path / "jax"), str(split), num_workers=1, log_fn=_quiet)
    got = teval_mod.evaluate(str(tmp_path / "port"), str(split), num_workers=1, log_fn=_quiet,
                             device="cpu")
    assert set(got) == set(want)
    for k in ("num_samples", "pre_nms_overflow", "det_overflow", "gt_overflow"):
        assert got[k] == want[k], (k, got[k], want[k])
    np.testing.assert_array_equal(tconf[0], jconf[0])
    for k in want:
        if k.startswith(("mAP", "intention")):
            assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert want["num_samples"] == 16
    if point == "caps_open":
        assert want["pre_nms_overflow"] == want["det_overflow"] == 0
        assert want["mAP@0.5"] > 0 and jconf[0].sum() > 0  # matches to agree on
    else:
        assert want["pre_nms_overflow"] == 16
