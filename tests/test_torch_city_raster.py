"""The port's city-frame map raster, its two warps and the loader's cache
path against the JAX package, on the CPU.

Same map and poses on both sides (a synthetic log's 4-lane corridor with
its marks and a crosswalk, and for the raster one more lane that is an
intersection bus lane; the tiny 64 x 96 grid). Tolerances:

- ``build_city_raster``: the raster and its origin bit for bit (both draw
  with the same C++ primitives; the port's numpy primitives too);
- ``warp_city_to_ego`` (host, f64 coordinates): bit for bit, three poses,
  with and without an ``aug_linear``;
- ``warp_city_to_ego_device`` (f32, the port batched over the three poses
  on CPU tensors, JAX's function called per pose as its own tests call
  it): bit for bit;
- the loader with ``use_city_raster_cache=True``: the same map as JAX's
  loader for the same samples, with and without augmentation, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from intentbev import configs as jcfg  # noqa: E402
from intentbev.bev import city_raster as jcity  # noqa: E402
from intentbev.bev import rasterize as jras  # noqa: E402
from intentbev.data import argoverse as jargo  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.bev import city_raster as tcity  # noqa: E402
from intentbev_torch.bev import rasterize as tras  # noqa: E402
from intentbev_torch.bev.augment import aug_linear_matrix  # noqa: E402
from intentbev_torch.data import argoverse as targo  # noqa: E402
from intentbev_torch.data.synthetic import multi_lane_map_data, write_synthetic_log  # noqa: E402

GRID_KW = dict(height_px=64, width_px=96, lidar_height_channels=4, lidar_sweeps=2)
JGRID, TGRID = jcfg.GridConfig(**GRID_KW), tcfg.GridConfig(**GRID_KW)
POSES = [(3.0, 0.5, 0.0), (41.3, -2.2, 0.37), (120.7, 4.1, -2.6)]  # (tx, ty, yaw)
AUGS = [None, aug_linear_matrix((-1.0, 0.21, 1.04)), aug_linear_matrix((1.0, -0.33, 0.95))]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """One synthetic log whose map has every channel's element."""
    root = tmp_path_factory.mktemp("city_raster") / "train"
    write_synthetic_log(root, log_id="cityraster", num_frames=4, points_per_sweep=300,
                        seed=3, map_data=multi_lane_map_data(crosswalk_x=30.0))
    log_dir = next(root.iterdir())
    (map_json,) = (log_dir / "map").glob("log_map_archive_*.json")
    return root, map_json


def _pose_row(tx, ty, yaw):
    return {"tx_m": tx, "ty_m": ty, "qx": 0.0, "qy": 0.0,
            "qz": float(np.sin(yaw / 2)), "qw": float(np.cos(yaw / 2))}


def _rasters(map_json):
    jel, tel = jras.parse_map_json(str(map_json)), tras.parse_map_json(str(map_json))
    return jcity.build_city_raster(jel, JGRID), tcity.build_city_raster(tel, TGRID)


def test_build_city_raster_matches_jax(split):
    jel, tel = jras.parse_map_json(str(split[1])), tras.parse_map_json(str(split[1]))
    xs = np.linspace(60.0, 75.0, 7)
    for pkg, el in ((jras, jel), (tras, tel)):  # an intersection bus lane: channels 4, 5
        el.lanes.append(pkg.LaneSegment(
            left_boundary=np.stack([xs, np.full(7, 10.5)], 1),
            right_boundary=np.stack([xs, np.full(7, 7.0)], 1), is_intersection=True,
            lane_type="BUS", left_mark_type="SOLID_WHITE"))
    want, got = jcity.build_city_raster(jel, JGRID), tcity.build_city_raster(tel, TGRID)
    assert got.origin_xy == want.origin_xy and got.voxel_size == want.voxel_size
    assert got.raster.dtype == want.raster.dtype == np.float32
    np.testing.assert_array_equal(got.raster, want.raster)
    for ch in range(9):  # every channel is drawn
        assert got.raster[..., ch].sum() > 0, ch
    numpy_form = tcity.build_city_raster(tel, TGRID, native=False)
    np.testing.assert_array_equal(numpy_form.raster, want.raster)
    empty_j = jcity.build_city_raster(jras.MapElements(), JGRID)
    empty_t = tcity.build_city_raster(tras.MapElements(), TGRID)
    np.testing.assert_array_equal(empty_t.raster, empty_j.raster)
    assert empty_t.origin_xy == empty_j.origin_xy


@pytest.mark.parametrize("aug", range(len(AUGS)))
def test_host_warp_matches_jax(split, aug):
    want_city, got_city = _rasters(split[1])
    for pose in POSES:
        row = _pose_row(*pose)
        want = jcity.warp_city_to_ego(want_city, row, JGRID, aug_linear=AUGS[aug])
        got = tcity.warp_city_to_ego(got_city, row, TGRID, aug_linear=AUGS[aug])
        assert got.dtype == want.dtype and got.shape == (64, 96, 9)
        np.testing.assert_array_equal(got, want)
        assert got[..., 0].sum() > 0


def test_device_warp_matches_jax(split):
    want_city, got_city = _rasters(split[1])
    poses = np.array(POSES, np.float32)
    got = tcity.warp_city_to_ego_device(torch.from_numpy(got_city.raster), got_city.origin_xy,
                                        torch.from_numpy(poses), TGRID).numpy()
    assert got.shape == (3, 64, 96, 9)
    for k in range(3):
        want = np.asarray(jcity.warp_city_to_ego_device(
            jnp.asarray(want_city.raster), want_city.origin_xy, jnp.asarray(poses[k]), JGRID))
        np.testing.assert_array_equal(got[k], want)
        assert got[k, ..., 0].sum() > 0 and got[k, ..., 1].sum() > 0
    one = tcity.warp_city_to_ego_device(torch.from_numpy(got_city.raster), got_city.origin_xy,
                                        torch.from_numpy(poses[1]), TGRID).numpy()
    np.testing.assert_array_equal(one, got[1])


def test_loader_cache_path_matches_jax(split):
    root, _ = split
    jseqs = jargo.build_sequence_index(
        jargo.ScenarioValidator(str(root), verbose=False).find_valid_scenarios(), 2)
    tseqs = targo.build_sequence_index(
        targo.ScenarioValidator(str(root), verbose=False).find_valid_scenarios(), 2)
    kw = dict(max_points_per_sweep=512, max_gt=8, require_intent_labels=False, verbose=False,
              use_city_raster_cache=True)
    jload = jargo.ArgoverseSampleLoader(JGRID, **kw)
    tload = targo.ArgoverseSampleLoader(TGRID, **kw)
    assert len(tseqs) == len(jseqs) == 3
    for k, (js, ts) in enumerate(zip(jseqs, tseqs)):
        aug = AUGS[k % len(AUGS)]
        want, got = jload.load(js, aug_linear=aug), tload.load(ts, aug_linear=aug)
        assert got.map_bev.dtype == want.map_bev.dtype == np.float32
        np.testing.assert_array_equal(got.map_bev, want.map_bev)
        np.testing.assert_array_equal(got.points, want.points)
        assert got.map_bev[..., 0].sum() > 0 and got.map_bev[..., 1].sum() > 0
