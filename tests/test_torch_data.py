"""The port's host data path against the JAX package's, on the CPU.

Two synthetic logs of 10 frames (3 sweeps a sample, 8 sequences a log)
are written by each package's ``write_synthetic_log`` from the same seeds
into separate splits, and each split is labelled by its package's
``precompute_labels.run`` (one module-scoped fixture). Everything below is
held identical, bit for bit:

- the written logs: the map JSON byte for byte; the pose, annotation,
  label and sweep tables column by column, except ``track_uuid``, which
  both writers draw from ``uuid.uuid4()`` (not from the seed): it is held
  by its pattern of repeats;
- ``parse_map_json`` -> ``rasterize_map_ego_centric`` at the tiny and the
  default grid, with and without an augmentation transform, the port's
  native (C++) and numpy forms both;
- ``label_log_annotations`` on one annotation table;
- the loader's ``Sample`` arrays for every sequence (with an augmentation
  transform too) and its GT-overflow count;
- ``batch_iterator`` with shuffle, augmentation and ``skip_batches=1`` over
  both transports, ``pad_batch``.

The pipeline's threads: a producer error surfaces in the consumer, and
after an early stop no thread the iterator started is alive within 5 s.
"""

import dataclasses
import json
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from intentbev import configs as jcfg  # noqa: E402
from intentbev.bev import rasterize as jras  # noqa: E402
from intentbev.bev.augment import aug_linear_matrix, draw_aug_params  # noqa: E402
from intentbev.data import argoverse as jarg  # noqa: E402
from intentbev.data import pipeline as jpipe  # noqa: E402
from intentbev.data.synthetic import write_synthetic_log as jwrite  # noqa: E402
from intentbev.labeling.heuristic import MapContext as JMapContext  # noqa: E402
from intentbev.labeling.heuristic import label_log_annotations as jlabel  # noqa: E402
from intentbev.precompute_labels import run as jrun  # noqa: E402
from intentbev.utils.featherio import read_ipc_dataframe  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.bev import rasterize as tras  # noqa: E402
from intentbev_torch.data import argoverse as targ  # noqa: E402
from intentbev_torch.data import pipeline as tpipe  # noqa: E402
from intentbev_torch.data.synthetic import write_synthetic_log as twrite  # noqa: E402
from intentbev_torch.labeling.heuristic import MapContext  # noqa: E402
from intentbev_torch.labeling.heuristic import label_log_annotations  # noqa: E402
from intentbev_torch.precompute_labels import run as trun  # noqa: E402

LOGS = (("synthlog00", 0), ("synthlog01", 1))
VEHICLES = [  # a turning car, a stopping one, one that leaves mid-log, a parked one
    {"start": (12.0, 1.75), "velocity": (6.0, 0.0), "yaw_rate": 0.35},
    {"start": (8.0, -1.75), "velocity": (4.0, 0.0), "accel": -3.0},
    {"start": (20.0, 5.25), "velocity": (5.0, 0.0), "frames": (0, 6)},
    {"start": (6.0, 9.0), "velocity": (0.0, 0.0), "category": "LARGE_VEHICLE"},
]


def _grid(jax_side: bool):
    mod = jcfg if jax_side else tcfg
    return dataclasses.replace(mod.tiny_test_config().grid, lidar_sweeps=3)


def _write(write, split: Path):
    for log_id, seed in LOGS:
        kw = dict(vehicles=VEHICLES, num_clutter=3, occlusion_drop=0.5) if seed else {}
        write(split, log_id=log_id, num_frames=10, seed=seed, **kw)


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    for side, write, run in (("jax", jwrite, jrun), ("port", twrite, trun)):
        _write(write, root / side / "train")
        assert run(str(root / side), ["train"], force=True)["ok"] == len(LOGS)
    return root / "jax" / "train", root / "port" / "train"


def _tables(log_dir: Path):
    names = ["city_SE3_egovehicle.feather", "annotations.feather",
             "annotations_with_intent.feather"]
    names += sorted(str(p.relative_to(log_dir)) for p in (log_dir / "sensors/lidar").iterdir())
    return names


@pytest.mark.parametrize("log", [name for name, _ in LOGS])
def test_synthetic_logs_identical(splits, log):
    jdir, tdir = (s / log for s in splits)
    name = f"map/log_map_archive_{log}.json"
    assert (jdir / name).read_bytes() == (tdir / name).read_bytes()
    names = _tables(jdir)
    assert names == _tables(tdir) and len(names) == 13
    for name in names:
        a, b = read_ipc_dataframe(jdir / name), read_ipc_dataframe(tdir / name)
        assert list(a.columns) == list(b.columns), name
        for col in a.columns:
            if col == "track_uuid":  # uuid4 draws: the same pattern of repeats
                np.testing.assert_array_equal(pd.factorize(a[col])[0], pd.factorize(b[col])[0],
                                              err_msg=name)
                assert not set(a[col]) & set(b[col])  # drawn anew, not seeded
                continue
            np.testing.assert_array_equal(a[col].to_numpy(), b[col].to_numpy(),
                                          err_msg=f"{name}:{col}")


def test_labels_identical_on_one_table(splits):
    jdir = splits[0] / LOGS[1][0]
    df = read_ipc_dataframe(jdir / "annotations.feather")
    map_path = jdir / f"map/log_map_archive_{LOGS[1][0]}.json"
    want = jlabel(df, jcfg.HeuristicConfig(), JMapContext(jras.parse_map_json(map_path)))
    got = label_log_annotations(df, tcfg.HeuristicConfig(),
                                MapContext(tras.parse_map_json(map_path)))
    np.testing.assert_array_equal(got["heuristic_intent"].to_numpy(),
                                  want["heuristic_intent"].to_numpy())
    # the scripted tracks reach several classes, and -1 stays off vehicles
    labels = set(want["heuristic_intent"].tolist())
    assert len(labels - {-1}) >= 3, labels
    nolabel = label_log_annotations(df, tcfg.HeuristicConfig(), None)
    np.testing.assert_array_equal(nolabel["heuristic_intent"].to_numpy(),
                                  jlabel(df, jcfg.HeuristicConfig(), None)[
                                      "heuristic_intent"].to_numpy())


def _poses(log_dir: Path):
    df = read_ipc_dataframe(log_dir / "city_SE3_egovehicle.feather")
    return [row._asdict() for row in df.itertuples(index=False)][::3]


@pytest.mark.parametrize("grid_name", ["tiny", "default"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_rasterize_identical(splits, grid_name, native):
    jdir = splits[0] / LOGS[1][0]
    map_path = jdir / f"map/log_map_archive_{LOGS[1][0]}.json"
    jgrid = _grid(True) if grid_name == "tiny" else jcfg.default_vit_config().grid
    tgrid = _grid(False) if grid_name == "tiny" else tcfg.default_vit_config().grid
    jel, tel = jras.parse_map_json(map_path), tras.parse_map_json(map_path)
    assert len(tel.lanes) == len(jel.lanes) and len(tel.crosswalks) == len(jel.crosswalks)
    augs = [None] + [aug_linear_matrix(p) for p in draw_aug_params(
        jcfg.AugmentConfig(flip_prob=1.0, rotate_prob=1.0, scale_prob=1.0),
        np.random.default_rng(4), 2)]
    drawn = 0
    for pose in _poses(jdir):
        for aug in augs:
            want = jras.rasterize_map_ego_centric(jel, pose, jgrid, aug_linear=aug,
                                                  out_dtype=np.uint8)
            got = tras.rasterize_map_ego_centric(tel, pose, tgrid, aug_linear=aug,
                                                 out_dtype=np.uint8, native=native)
            np.testing.assert_array_equal(got, want)
            drawn += int(want.sum())
    assert drawn > 1000


def _loaders(grid_j, grid_t, **kw):
    return (jarg.ArgoverseSampleLoader(grid_j, max_gt=8, verbose=False, **kw),
            targ.ArgoverseSampleLoader(grid_t, max_gt=8, verbose=False, **kw))


def _sequences(split: Path, mod):
    return mod.build_sequence_index(mod.ScenarioValidator(str(split), verbose=False)
                                    .find_valid_scenarios(), 3)


@pytest.mark.parametrize("aug", [False, True], ids=["identity", "augmented"])
def test_loader_samples_identical(splits, aug):
    jseq, tseq = _sequences(splits[0], jarg), _sequences(splits[0], targ)
    assert len(jseq) == 16 and [dataclasses.astuple(s) for s in jseq] == \
        [dataclasses.astuple(s) for s in tseq]
    jl, tl = _loaders(_grid(True), _grid(False), max_points_per_sweep=1500)
    params = draw_aug_params(jcfg.AugmentConfig(), np.random.default_rng(2), len(jseq))
    n_gt = 0
    for k, (js, ts) in enumerate(zip(jseq, tseq)):
        lin = aug_linear_matrix(params[k]) if aug else None
        want, got = jl.load(js, lin), tl.load(ts, lin)
        assert type(got).__name__ == "Sample" and got._fields == want._fields
        for name, a, b in zip(want._fields, got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        n_gt += int(want.gt_valid.sum())
    assert n_gt > 20
    assert tl.gt_overflow_samples == jl.gt_overflow_samples


def test_loader_gt_overflow_and_city_raster(splits):
    """max_gt below a frame's box count: the same truncation and the same
    overflow count; the city raster cache is not ported and raises."""
    seqs = _sequences(splits[0], targ)
    jl = jarg.ArgoverseSampleLoader(_grid(True), max_gt=2, verbose=False)
    tl = targ.ArgoverseSampleLoader(_grid(False), max_gt=2, verbose=False)
    for s in seqs:
        np.testing.assert_array_equal(tl.load(s).gt_boxes, jl.load(s).gt_boxes)
    assert tl.gt_overflow_samples == jl.gt_overflow_samples > 0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        targ.ArgoverseSampleLoader(_grid(False), use_city_raster_cache=True)
    missing = targ.ArgoverseSampleLoader(_grid(False), verbose=False)
    bad = dataclasses.replace(seqs[0], log_id="nolabels", log_dir=str(splits[0] / "nope"))
    assert missing.load(bad) is None


def _flatten(batch):
    out = {}
    for name, v in batch._asdict().items():
        if isinstance(v, tuple):
            for sub, a in v._asdict().items():
                out[f"{name}.{sub}"] = a
        else:
            out[name] = v
    return out


@pytest.mark.parametrize("transport", ["points", "chunks"])
def test_batch_iterator_identical(splits, transport):
    """Shuffle, then the augmentation draws, from one seeded rng; the
    last batch short; ``skip_batches=1`` gives the full run's tail."""
    jseq, tseq = _sequences(splits[0], jarg), _sequences(splits[0], targ)
    jl, tl = _loaders(_grid(True), _grid(False), max_points_per_sweep=1500)
    kw = dict(batch_size=5, shuffle=True, seed=3, num_workers=1, transport=transport,
              chunk_patch=8, chunk_capacity=64)
    want = list(jpipe.batch_iterator(jseq, jl, augment=jcfg.AugmentConfig(), **kw))
    got = list(tpipe.batch_iterator(tseq, tl, augment=tcfg.AugmentConfig(), **kw))
    tail = list(tpipe.batch_iterator(tseq, tl, augment=tcfg.AugmentConfig(), skip_batches=1,
                                     **kw))
    assert len(want) == len(got) == 4 and len(tail) == 3
    assert type(got[0]).__name__ == type(want[0]).__name__
    for w, g in zip(want, got):
        wf, gf = _flatten(w), _flatten(g)
        assert list(wf) == list(gf)
        for name in wf:
            assert gf[name].dtype == wf[name].dtype, name
            np.testing.assert_array_equal(gf[name], wf[name], err_msg=name)
    for a, b in zip(tail, got[1:]):
        for name, x in _flatten(a).items():
            np.testing.assert_array_equal(x, _flatten(b)[name], err_msg=name)
    assert not np.all(_flatten(got[0])["aug_params"] == [1, 0, 1])
    padded, valid = tpipe.pad_batch(got[-1], 5)
    jpadded, jvalid = jpipe.pad_batch(want[-1], 5)
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.sum() == 1
    for name, x in _flatten(jpadded).items():
        np.testing.assert_array_equal(_flatten(padded)[name], np.asarray(x), err_msg=name)
    dev = tpipe.batch_to_device(padded, "cpu")
    assert all(isinstance(v, torch.Tensor) or isinstance(v, tuple) for v in dev.values())


def test_prefetch_propagates_producer_errors():
    def boom():
        yield np.zeros(3)
        raise RuntimeError("loader crashed")

    it = tpipe.device_prefetch(boom(), size=2, put=lambda x: x)
    next(it)
    with pytest.raises(RuntimeError, match="loader crashed"):
        next(it)


def _wait_for(threads_before, seconds=5.0):
    deadline = time.time() + seconds
    while time.time() < deadline:
        extra = [t for t in threading.enumerate() if t not in threads_before and t.is_alive()]
        if not extra:
            return []
        time.sleep(0.05)
    return extra


@pytest.mark.parametrize("stop", ["break", "exception", "close"])
def test_early_stop_leaves_no_thread(splits, stop):
    """A consumer that stops after one batch (of 8 in the epoch) while the
    producer waits on a full queue: the producer and the loader pool (2
    workers) are gone within 5 s."""
    seqs = _sequences(splits[0], targ)
    loader = targ.ArgoverseSampleLoader(_grid(False), max_gt=8, verbose=False,
                                        max_points_per_sweep=1500)
    loader.load(seqs[0])  # the loader's own pinned arrow thread, started once
    before = set(threading.enumerate())
    it = tpipe.batch_iterator(seqs, loader, 2, shuffle=True, num_workers=2,
                              augment=tcfg.AugmentConfig())
    batches = tpipe.device_prefetch(it, size=1, device="cpu")
    if stop == "close":
        first = next(batches)
        time.sleep(0.2)  # the producer fills the queue and blocks
        batches.close()
    else:
        try:
            for first in batches:
                time.sleep(0.2)
                if stop == "exception":
                    raise KeyError("consumer failed")
                break
        except KeyError:
            pass
        del batches  # what a loop that drops its iterator does
    assert first["points"].shape[0] == 2
    extra = _wait_for(before)
    assert not extra, [t.name for t in extra]


def test_copies_name_their_originals():
    """Each copied host module names its JAX original, and the native
    binding exports the three loader primitives."""
    import intentbev_torch.geometry as geometry
    import intentbev_torch.utils.featherio as featherio
    from intentbev_torch.utils import native

    for mod, original in ((geometry, "intentbev/geometry.py"),
                          (featherio, "intentbev/utils/featherio.py")):
        assert original in mod.__doc__
    quad = np.array([[1, 1], [6, 2], [5, 6], [2, 5]])
    masks = [np.zeros((8, 8), np.uint8) for _ in range(3)]
    tras.fill_polygon(masks[0], quad, native=True)
    tras.fill_polygon(masks[1], quad, native=False)
    jras.fill_polygon(masks[2], quad)
    for m in masks[1:]:
        np.testing.assert_array_equal(masks[0], m)
    assert 16 < masks[0].sum() < 36
    pts = np.random.default_rng(0).normal(size=(50, 3))
    tf = np.eye(4)
    tf[:3, 3] = (1.0, -2.0, 0.5)
    np.testing.assert_allclose(native.transform_points_native(pts, tf),
                               (pts + tf[:3, 3]).astype(np.float32), rtol=1e-6)
    assert json.loads(json.dumps(dataclasses.asdict(tcfg.HeuristicConfig()))) == \
        dataclasses.asdict(jcfg.HeuristicConfig())


@pytest.mark.parametrize("grid_name", ["tiny", "default"])
def test_voxelize_lattice_points_match_jax(grid_name):
    """Points on the i16-centimetre lattice of the transport, many exactly
    on a cell boundary: the port's bins are the jitted JAX voxelizer's
    (a product with the f32 reciprocal fused with the offset), cell for
    cell; a true division puts some of them into the neighbouring cell."""
    from intentbev.bev.voxelize import voxelize_packed as jvoxelize
    from intentbev_torch.bev.voxelize import voxelize_packed

    jg = (_grid(True) if grid_name == "tiny" else jcfg.default_vit_config().grid)
    tg = (_grid(False) if grid_name == "tiny" else tcfg.default_vit_config().grid)
    rng = np.random.default_rng(1)
    shape = (2, jg.lidar_sweeps, 20000)
    cm = np.stack([rng.integers(int(jg.bev_x_min * 100) - 300, int(jg.bev_x_max * 100) + 300,
                                shape),
                   rng.integers(int(jg.bev_y_min * 100) - 300, int(jg.bev_y_max * 100) + 300,
                                shape),
                   rng.integers(-250, 420, shape), rng.integers(0, 256, shape)], -1)
    pts = cm.astype(np.float32) * np.array([0.01, 0.01, 0.01, 1.0], np.float32)
    valid = rng.uniform(size=shape) < 0.95
    want = np.stack([np.asarray(jvoxelize(jnp.asarray(p), jnp.asarray(v), jg))
                     for p, v in zip(pts, valid)])
    got = voxelize_packed(torch.from_numpy(pts), torch.from_numpy(valid), tg).numpy()
    np.testing.assert_array_equal(got, want)
    # control: the bins by true division move points across boundaries
    x = pts[..., 0]
    row_div = np.floor(np.float32(jg.pixel_offset_y) - x / np.float32(jg.voxel_size_m))
    inv = np.float64(np.float32(1.0) / np.float32(jg.voxel_size_m))
    row_fma = np.floor((np.float64(jg.pixel_offset_y) - x.astype(np.float64) * inv)
                       .astype(np.float32))
    assert (row_div != row_fma).sum() > 100
