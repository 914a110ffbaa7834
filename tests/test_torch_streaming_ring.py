"""The port's sweep rings against the JAX package's, on the CPU.

Same sweeps, poses and pushes on both sides (numpy seeds; the tiny 64 x 96
grid with 4 height slices). Tolerances:

- pushing, wrapping and stacking: the ring's points, valid mask, poses,
  head and count equal JAX's exactly;
- the cold ring: slots never written contribute nothing (exact);
- the voxelized BEVs (``voxelize_ring``, ``batched_voxelize_rings``)
  against JAX's ``voxelize_ring``: the re-projection ``rel = inv(current) @
  pose`` and the point transform are f32 products summed in another order
  than JAX's einsums, which can move a point lying within rounding of a
  cell boundary into the neighbouring cell. The rule: the number of cells
  that differ is at most 2 per point whose exact (f64) bin coordinates lie
  within 1e-3 of a cell or height-slice boundary (each such point can take
  its value out of one cell and into another), so where no point is that
  near, the BEVs are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from intentbev import configs as jcfg  # noqa: E402
from intentbev.data import streaming as jstream  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.data import streaming as tstream  # noqa: E402
from intentbev_torch.geometry import se3_from_quat_translation  # noqa: E402

GRID_KW = dict(height_px=64, width_px=96, lidar_height_channels=4, lidar_sweeps=3)
JGRID, TGRID = jcfg.GridConfig(**GRID_KW), tcfg.GridConfig(**GRID_KW)
NEAR = 1e-3  # cell units


def _pose(x, y, yaw):
    return se3_from_quat_translation([0, 0, np.sin(yaw / 2), np.cos(yaw / 2)],
                                      [x, y, 0.1 * x]).astype(np.float32)


def _sweeps(rng, n, p):
    """n sweeps of p points in their own frames, and their world poses (the
    ego driving forward and turning)."""
    pts = np.stack([rng.uniform(-10, 12, (n, p)), rng.uniform(-9, 9, (n, p)),
                    rng.uniform(-2.5, 4.2, (n, p)), rng.uniform(0, 255, (n, p))],
                   -1).astype(np.float32)
    valid = rng.uniform(size=(n, p)) < 0.9
    poses = np.stack([_pose(30.0 + 1.1 * i, -4.0 + 0.3 * i, 0.4 + 0.05 * i) for i in range(n)])
    return pts, valid, poses


def _push_both(pts, valid, poses, s, p):
    jring, tring = jstream.make_ring(s, p), tstream.make_ring(s, p, "cpu")
    for k in range(len(pts)):
        jring = jstream.push_sweep(jring, jnp.asarray(pts[k]), jnp.asarray(valid[k]),
                                   jnp.asarray(poses[k]))
        tring = tstream.push_sweep(tring, torch.from_numpy(pts[k]), torch.from_numpy(valid[k]),
                                   torch.from_numpy(poses[k]))
    return jring, tring


def _assert_rings_equal(jring, tring):
    for name in jstream.SweepRing._fields:
        np.testing.assert_array_equal(getattr(tring, name).numpy(),
                                      np.asarray(getattr(jring, name)), err_msg=name)


def _near_boundary(pts, valid, poses, head, count, current, grid):
    """How many valid in-range points of a ring lie within NEAR of a bin
    boundary, from f64 transforms of the same f32 inputs."""
    s = len(pts)
    inv = np.linalg.inv(current.astype(np.float64))
    inv_v = float(np.float32(1.0) / np.float32(grid.voxel_size_m))
    z_scale = float(np.float32(np.float32(1.0) / np.float32(grid.z_max - grid.z_min))
                    * np.float32(grid.lidar_height_channels))
    n = 0
    for age in range(s):
        slot = (head + age) % s
        if age < s - count:
            continue
        rel = inv @ poses[slot].astype(np.float64)
        xyz = pts[slot, :, :3].astype(np.float64) @ rel[:3, :3].T + rel[:3, 3]
        col = grid.pixel_offset_x + xyz[:, 1] * inv_v
        row = grid.pixel_offset_y - xyz[:, 0] * inv_v
        zb = (xyz[:, 2] - grid.z_min) * z_scale
        near = np.zeros(len(xyz), bool)
        for v in (col, row, zb):
            near |= np.abs(v - np.round(v)) < NEAR
        n += int((near & valid[slot]).sum())
    return n


def _check_bev(got, want, n_near):
    assert got.shape == want.shape
    n_diff = int((got != want).sum())
    assert n_diff <= 2 * n_near, f"{n_diff} cells differ, {n_near} points near a boundary"
    assert (want > 0).sum() > 50


def test_push_wrap_and_stack_match_jax():
    rng = np.random.default_rng(0)
    s, p = 3, 64
    pts, valid, poses = _sweeps(rng, s + 2, p)  # wraps twice past the first slot
    jring, tring = _push_both(pts, valid, poses, s, p)
    _assert_rings_equal(jring, tring)
    assert int(tring.head) == (s + 2) % s and int(tring.count) == s
    jring2, tring2 = _push_both(pts[:1], valid[:1], poses[:1], s, p)  # a cold ring
    _assert_rings_equal(jring2, tring2)
    assert int(tring2.count) == 1
    import jax

    stacked_j = jax.tree.map(lambda *xs: jnp.stack(xs), jring, jring2)
    _assert_rings_equal(stacked_j, tstream.stack_rings([tring, tring2]))


def test_cold_ring_masks_unwritten_slots():
    rng = np.random.default_rng(1)
    s, p = 3, 200
    pts, valid, poses = _sweeps(rng, 1, p)
    ring = tstream.make_ring(s, p, "cpu")
    ring = tstream.push_sweep(ring, torch.from_numpy(pts[0]), torch.from_numpy(valid[0]),
                              torch.from_numpy(poses[0]))
    bev = tstream.voxelize_ring(ring, torch.from_numpy(poses[0]), TGRID).numpy()
    z = TGRID.lidar_height_channels
    assert bev[..., (s - 1) * z:].max() > 0  # only the newest slot carries data
    assert bev[..., :(s - 1) * z].max() == 0
    want = np.asarray(jstream.voxelize_ring(
        jstream.push_sweep(jstream.make_ring(s, p), jnp.asarray(pts[0]), jnp.asarray(valid[0]),
                           jnp.asarray(poses[0])), jnp.asarray(poses[0]), JGRID))
    _check_bev(bev, want, _near_boundary(pts, valid, poses, 1, 1, poses[0], TGRID))


@pytest.mark.parametrize("pushes", [3, 5])
def test_voxelize_ring_matches_jax(pushes):
    rng = np.random.default_rng(10 + pushes)
    s, p = 3, 1500
    pts, valid, poses = _sweeps(rng, pushes, p)
    jring, tring = _push_both(pts, valid, poses, s, p)
    cur = poses[-1]
    got = tstream.voxelize_ring(tring, torch.from_numpy(cur), TGRID).numpy()
    want = np.asarray(jstream.voxelize_ring(jring, jnp.asarray(cur), JGRID))
    slots = np.asarray(jring.points), np.asarray(jring.valid), np.asarray(jring.poses)
    _check_bev(got, want, _near_boundary(*slots, int(tring.head), int(tring.count), cur, TGRID))


def test_batched_rings_match_jax():
    """Three streams with their own poses, one of them cold, in one pass."""
    rng = np.random.default_rng(7)
    s, p = 3, 800
    jrings, trings, currents, near = [], [], [], 0
    for b, pushes in enumerate((3, 4, 1)):
        pts, valid, poses = _sweeps(rng, pushes, p)
        poses[:, 0, 3] += 25.0 * b  # the streams drive elsewhere
        jr, tr = _push_both(pts, valid, poses, s, p)
        jrings.append(jr)
        trings.append(tr)
        currents.append(poses[-1])
        near += _near_boundary(np.asarray(jr.points), np.asarray(jr.valid), np.asarray(jr.poses),
                               int(tr.head), int(tr.count), poses[-1], TGRID)
    got = tstream.batched_voxelize_rings(tstream.stack_rings(trings),
                                         torch.from_numpy(np.stack(currents)), TGRID).numpy()
    assert got.shape == (3, 64, 96, s * 4)
    want = np.stack([np.asarray(jstream.voxelize_ring(jr, jnp.asarray(c), JGRID))
                     for jr, c in zip(jrings, currents)])
    _check_bev(got, want, near)
    for b in range(3):  # each stream against itself alone
        alone = tstream.voxelize_ring(trings[b], torch.from_numpy(currents[b]), TGRID).numpy()
        np.testing.assert_array_equal(got[b], alone)
