"""A copy of ``intentbev/data/synthetic.py`` (the port imports nothing of
the JAX package): ``tests/test_torch_data.py`` holds the logs it writes
against the original's, column by column. Track ids come from
``uuid.uuid4()`` there too, not from the seed. The scene scripts of
``examples/make_synthetic_dataset.py`` (``stopper_track``,
``scripted_vehicles``, ``curved_scripted_vehicles``, ``ego_profile``) are
copied at the end, for its twin ``examples/make_synthetic_dataset_torch.py``
(``tests/test_torch_tools.py`` holds the splits the two write).

Synthetic Argoverse-2-layout log generator for tests and CI.

Writes a fake AV2 sensor log directory exactly where the real dataset layout
is consumed (reference dataset.py:101-127, README.md:147-166):

    <root>/<log_id>/
        sensors/lidar/<ts>.feather          (x, y, z, intensity)
        annotations.feather                 (AV2 cuboid schema)
        city_SE3_egovehicle.feather         (timestamp_ns, q*, t*)
        map/log_map_archive_<log_id>.json   (lane_segments, crossings)

This replaces the reference's hard dependency on the real dataset for
integration testing (SURVEY.md §4 item 2). Scenes contain an ego moving
at constant velocity plus a handful of scripted vehicle tracks whose
ground-truth intentions are known by construction.
"""

from __future__ import annotations

import json
import uuid
from pathlib import Path

import numpy as np


def _pose_row(ts, x, y, yaw):
    return {
        "timestamp_ns": int(ts),
        "qw": float(np.cos(yaw / 2)),
        "qx": 0.0,
        "qy": 0.0,
        "qz": float(np.sin(yaw / 2)),
        "tx_m": float(x),
        "ty_m": float(y),
        "tz_m": 0.0,
    }


def _integrate_track(v: dict, num_frames: int) -> np.ndarray:
    """[num_frames, 3] (x, y, yaw) world-frame track for one vehicle spec.

    Straight tracks (no ``yaw_rate``/``accel``) reproduce the legacy
    constant-velocity motion exactly; otherwise speed and heading integrate
    at 10 Hz so turning vehicles curve and decelerating ones stop.
    """
    dt = 0.1
    x, y = float(v["start"][0]), float(v["start"][1])
    yaw = float(v.get("yaw", 0.0))
    yaw_rate = float(v.get("yaw_rate", 0.0))
    accel = float(v.get("accel", 0.0))
    vel = v.get("velocity", (0.0, 0.0))
    if yaw_rate == 0.0 and accel == 0.0:
        t = np.arange(num_frames) * dt
        return np.stack(
            [x + vel[0] * t, y + vel[1] * t, np.full(num_frames, yaw)], axis=1
        )
    speed = float(np.hypot(vel[0], vel[1]))
    out = np.empty((num_frames, 3))
    for i in range(num_frames):
        out[i] = (x, y, yaw)
        x += speed * np.cos(yaw) * dt
        y += speed * np.sin(yaw) * dt
        # heading only turns while moving; speed floors at zero
        if speed > 1e-3:
            yaw += yaw_rate * dt
        speed = max(0.0, speed + accel * dt)
    return out


def multi_lane_map_data(
    x_min: float = -40.0, x_max: float = 220.0, crosswalk_x: float | None = None,
) -> dict:
    """A 4-lane corridor map (two lanes each side of y=0, boundaries at
    y in {-7, -3.5, 0, 3.5, 7}) with varied mark types, plus an optional
    crosswalk spanning the roadway at ``crosswalk_x``. Richer than the
    single-lane default map: off-lane positions (|y| > 7) are visibly
    outside every lane fill in the rasterized BEV, giving parked vehicles
    a map-stream cue, and lane centers sit at y in {+-1.75, +-5.25}."""
    xs = np.arange(x_min, x_max, 5.0)

    def boundary(yy):
        return [{"x": float(x), "y": float(yy), "z": 0.0} for x in xs]

    def lane(lid, left_y, right_y, left_mark, right_mark):
        return {
            "id": lid,
            "is_intersection": False,
            "lane_type": "VEHICLE",
            "left_lane_boundary": boundary(left_y),
            "right_lane_boundary": boundary(right_y),
            "left_lane_mark_type": left_mark,
            "right_lane_mark_type": right_mark,
            "successors": [],
            "predecessors": [],
        }

    map_data = {
        "lane_segments": {
            "101": lane(101, 3.5, 0.0, "DASHED_WHITE", "SOLID_YELLOW"),
            "102": lane(102, 7.0, 3.5, "SOLID_WHITE", "DASHED_WHITE"),
            "103": lane(103, 0.0, -3.5, "SOLID_YELLOW", "DASHED_WHITE"),
            "104": lane(104, -3.5, -7.0, "DASHED_WHITE", "SOLID_WHITE"),
        },
        "pedestrian_crossings": {},
        "drivable_areas": {},
    }
    if crosswalk_x is not None:
        cw = float(crosswalk_x)
        map_data["pedestrian_crossings"]["200"] = {
            "id": 200,
            "polygon": [
                {"x": cw, "y": -8.0, "z": 0.0},
                {"x": cw + 2.5, "y": -8.0, "z": 0.0},
                {"x": cw + 2.5, "y": 8.0, "z": 0.0},
                {"x": cw, "y": 8.0, "z": 0.0},
            ],
            "edge1": [{"x": cw, "y": -8.0, "z": 0.0}, {"x": cw, "y": 8.0, "z": 0.0}],
            "edge2": [{"x": cw + 2.5, "y": -8.0, "z": 0.0},
                      {"x": cw + 2.5, "y": 8.0, "z": 0.0}],
        }
    return map_data


def curved_arc_point(radius: float, t: float, d: float,
                     sign: float = 1.0) -> tuple[float, float, float]:
    """World-frame (x, y, yaw) on a circular corridor.

    The corridor centerline is the arc of ``radius`` through the origin,
    tangent to +x there, curving toward +y (``sign``=+1, left) or -y
    (-1, right); ``t`` is the arc-length parameter (meters along the
    centerline), ``d`` the signed lateral offset (+ = toward the arc
    center, i.e. the inside of the curve). yaw is the forward tangent."""
    a = t / radius
    r = radius - d
    x = r * np.sin(a)
    y = sign * (radius - r * np.cos(a))
    return float(x), float(y), float(sign * a)


def curved_multi_lane_map_data(
    radius: float, sign: float = 1.0,
    t_min: float = -40.0, t_max: float = 220.0,
) -> dict:
    """The 4-lane corridor of :func:`multi_lane_map_data` bent onto a
    circular arc (``curved_arc_point`` geometry). Same lane widths,
    boundary offsets (d in {-7, -3.5, 0, 3.5, 7}) and mark types; lane
    centers at d in {+-1.75, +-5.25}. On a curve the kinematic
    keep-lane/lane-change distinction stops being a local property (every
    keep-laner has nonzero yaw rate ~ v/R), so a model must read the
    lane geometry from the MAP stream to separate them — the hard
    benchmark's map-context cue (docs/TRAINING.md)."""
    ts = np.arange(t_min, t_max, 4.0)

    def boundary(d):
        return [
            {"x": p[0], "y": p[1], "z": 0.0}
            for p in (curved_arc_point(radius, float(t), d, sign) for t in ts)
        ]

    def lane(lid, left_d, right_d, left_mark, right_mark):
        # "left" boundary = larger +y for sign=+1 driving +x, which is
        # the SMALLER radius side (toward center): d=+7 is innermost
        ld, rd = (left_d, right_d) if sign > 0 else (-left_d, -right_d)
        return {
            "id": lid,
            "is_intersection": False,
            "lane_type": "VEHICLE",
            "left_lane_boundary": boundary(ld),
            "right_lane_boundary": boundary(rd),
            "left_lane_mark_type": left_mark,
            "right_lane_mark_type": right_mark,
            "successors": [],
            "predecessors": [],
        }

    return {
        "lane_segments": {
            "101": lane(101, 3.5, 0.0, "DASHED_WHITE", "SOLID_YELLOW"),
            "102": lane(102, 7.0, 3.5, "SOLID_WHITE", "DASHED_WHITE"),
            "103": lane(103, 0.0, -3.5, "SOLID_YELLOW", "DASHED_WHITE"),
            "104": lane(104, -3.5, -7.0, "DASHED_WHITE", "SOLID_WHITE"),
        },
        "pedestrian_crossings": {},
        "drivable_areas": {},
    }


def inject_label_noise(split_dir: str | Path, rate: float, seed: int = 0,
                       num_classes: int = 8) -> dict:
    """Flip each precomputed vehicle intent label to a DIFFERENT uniform
    class with probability ``rate`` (train-split corruption for the hard
    benchmark — real heuristic labels carry exactly this kind of error on
    boundary tracks; the reference trains through it unexamined). Edits
    ``annotations_with_intent.feather`` in place; labels of -1
    (non-vehicle rows) are never touched. Returns flip counts per log."""
    from ..utils.featherio import read_ipc_dataframe, write_ipc_dataframe

    rng = np.random.default_rng(seed)
    out = {}
    for f in sorted(Path(split_dir).glob("*/annotations_with_intent.feather")):
        df = read_ipc_dataframe(f)
        lab = df["heuristic_intent"].to_numpy().astype(np.int32)
        veh = lab >= 0
        flip = veh & (rng.uniform(size=len(lab)) < rate)
        # uniform over the OTHER classes: draw from [0, C-1) and skip past
        # the current label so the result is never a no-op flip
        draw = rng.integers(0, num_classes - 1, size=len(lab)).astype(np.int32)
        new = np.where(draw >= lab, draw + 1, draw)
        lab = np.where(flip, new, lab)
        df["heuristic_intent"] = lab
        write_ipc_dataframe(df, f)
        out[f.parent.name] = int(flip.sum())
    return out


def _apply_occlusion(
    pts: np.ndarray,
    occluders: list[tuple[float, float, float]],
    rng: np.random.Generator,
    drop_prob: float,
) -> np.ndarray:
    """Ray-shadow model: points angularly behind an occluder (from the
    ego at the origin) survive only with ``1 - drop_prob``.

    ``occluders``: (x, y, radius) ego-frame discs (vehicle footprints).
    For each disc the shadow is the angular interval it subtends widened
    to its far edge; any point inside the interval and beyond the disc is
    shadowed. Real AV2 sweeps carry exactly this structure (annotations
    persist while the object's points vanish behind closer traffic), and
    it is the cue that separates global-context models from local ones:
    an occluded car's extent must be inferred from the visible sliver +
    scene context. Vectorised: one [V, N] angular test per sweep."""
    if not occluders or drop_prob <= 0.0 or len(pts) == 0:
        return pts
    az = np.arctan2(pts[:, 1], pts[:, 0])
    rr = np.hypot(pts[:, 0], pts[:, 1])
    shadowed = np.zeros(len(pts), dtype=bool)
    for ox, oy, orad in occluders:
        d = float(np.hypot(ox, oy))
        if d < orad + 0.5:  # ego inside/next to the disc: no shadow
            continue
        half = float(np.arcsin(min(1.0, orad / d)))
        ang = np.abs(((az - np.arctan2(oy, ox)) + np.pi) % (2 * np.pi) - np.pi)
        shadowed |= (ang < half) & (rr > d + orad)
    keep = ~shadowed | (rng.uniform(size=len(pts)) >= drop_prob)
    return pts[keep]


def clutter_points(
    rng: np.random.Generator,
    num_objects: int,
    x_range: tuple[float, float] = (-15.0, 55.0),
    arc: tuple[float, float] | None = None,
) -> np.ndarray:
    """Unannotated static obstacles (ego-frame world offsets are applied
    by the caller): poles (thin tall clusters), bushes (car-scale blobs)
    and wall segments, placed in the off-lane band (|y| in [7.5, 14]) so
    they overlap where parked cars live. Bushes are the adversarial
    distractor — curb-side blobs at parked-car scale that carry NO
    annotation, so a detector keying on 'dense off-lane cluster' pays in
    false positives.

    ``arc``: optional (radius, sign) — object centers are drawn in
    corridor coordinates (t along the centerline, d lateral) and mapped
    through :func:`curved_arc_point`, so clutter follows a curved
    corridor's off-lane band instead of straddling the outer lane."""
    groups = []
    for _ in range(num_objects):
        kind = rng.choice(["pole", "bush", "wall"], p=[0.35, 0.45, 0.2])
        cx = float(rng.uniform(*x_range))
        cy = float(rng.choice([-1.0, 1.0])) * float(rng.uniform(7.5, 14.0))
        if arc is not None:
            radius, sign = arc
            cx, cy, _ = curved_arc_point(radius, cx, sign * cy, sign)
        if kind == "pole":
            n = 40
            g = np.stack([
                cx + rng.normal(0, 0.15, n),
                cy + rng.normal(0, 0.15, n),
                rng.uniform(-1.6, 3.0, n),
            ], axis=1)
        elif kind == "bush":
            n = 90
            g = np.stack([
                cx + rng.uniform(-2.2, 2.2, n),
                cy + rng.uniform(-1.0, 1.0, n),
                rng.uniform(-1.6, 0.4, n),
            ], axis=1)
        else:  # wall segment along x
            n = 120
            length = float(rng.uniform(6.0, 14.0))
            g = np.stack([
                cx + rng.uniform(0.0, length, n),
                cy + rng.normal(0, 0.08, n),
                rng.uniform(-1.6, 1.4, n),
            ], axis=1)
        groups.append(g)
    if not groups:
        return np.zeros((0, 3), np.float64)
    return np.concatenate(groups, axis=0)


def write_synthetic_log(
    root: str | Path,
    log_id: str | None = None,
    num_frames: int = 20,
    points_per_sweep: int = 2000,
    seed: int = 0,
    ego_speed: float = 5.0,
    vehicles: list[dict] | None = None,
    map_data: dict | None = None,
    ego_xs: np.ndarray | None = None,
    occlusion_drop: float = 0.0,
    num_clutter: int = 0,
    clutter_arc: tuple[float, float] | None = None,
) -> Path:
    """Create one synthetic log; returns its directory.

    ``vehicles``: list of dicts with keys ``start`` (xy), ``velocity`` (xy),
    ``yaw``, ``category``, optional ``frames`` — a half-open ``(start, stop)``
    frame range outside which the vehicle has no annotation rows and sheds
    no lidar points (models tracks that appear/disappear mid-log, the way
    real AV2 annotations drop occluded or out-of-range objects; frames where
    NO vehicle is present become genuinely empty-GT frames) — plus optional
    curved/decelerating motion:
    ``yaw_rate`` (rad/s; the track integrates heading so turning vehicles
    actually curve) and ``accel`` (m/s^2 along heading, clamped at 0 speed;
    gives STOPPING tracks). A vehicle may instead carry an explicit
    ``track`` array [num_frames, 3] of world-frame (x, y, yaw) rows for
    motion profiles the integrator can't express (e.g. multi-phase stops).
    Defaults to two cars: one keeping lane ahead of ego, one parked to
    the side.

    ``map_data``: optional full log-map-archive dict (lane_segments /
    pedestrian_crossings / drivable_areas) replacing the default
    single-lane map — see ``multi_lane_map_data``.

    ``occlusion_drop``: probability that a point angularly shadowed by a
    closer vehicle (ray model, :func:`_apply_occlusion`) is dropped —
    annotations for the shadowed vehicles REMAIN, as in real AV2, so a
    detector must infer occluded extent from partial evidence.
    ``num_clutter``: unannotated static obstacles per log
    (:func:`clutter_points` — poles/bushes/walls in the off-lane band
    where parked cars live). Both power the hard ViT-vs-CNN benchmark
    (docs/TRAINING.md; VERDICT r4 missing #4).

    ``ego_xs``: optional per-frame ego x positions (world frame, y=0,
    yaw=0) overriding the default constant-velocity ego. A (mostly)
    stationary ego matters for label quality: AV2 annotations are
    ego-frame per timestamp and the heuristic labeler consumes them
    as-is (reference preprocess_intent_labels.py:46-48,
    heuristic_labeling.py:40-46), so labels encode ego-RELATIVE motion;
    with the ego stopped, relative == absolute and the scripted class
    cues survive labeling intact.
    """
    import pandas as pd

    from ..utils.featherio import write_ipc_dataframe

    rng = np.random.default_rng(seed)
    log_id = log_id or uuid.uuid4().hex[:16]
    log_dir = Path(root) / log_id
    lidar_dir = log_dir / "sensors" / "lidar"
    map_dir = log_dir / "map"
    lidar_dir.mkdir(parents=True, exist_ok=True)
    map_dir.mkdir(parents=True, exist_ok=True)

    dt_ns = 100_000_000  # 10 Hz
    ts0 = 315_970_000_000_000_000
    timestamps = [ts0 + i * dt_ns for i in range(num_frames)]

    # --- ego poses: straight along world +x (or the scripted ego_xs)
    if ego_xs is None:
        ego_xs = np.array([ego_speed * i * 0.1 for i in range(num_frames)])
    else:
        ego_xs = np.asarray(ego_xs, dtype=np.float64)
        assert len(ego_xs) == num_frames
    poses = [_pose_row(ts, ego_xs[i], 0.0, 0.0) for i, ts in enumerate(timestamps)]
    write_ipc_dataframe(pd.DataFrame(poses),
                        log_dir / "city_SE3_egovehicle.feather")

    # --- vehicles
    if vehicles is None:
        vehicles = [
            {"start": (15.0, 0.0), "velocity": (5.0, 0.0), "yaw": 0.0,
             "category": "REGULAR_VEHICLE"},
            {"start": (10.0, 6.0), "velocity": (0.0, 0.0), "yaw": 0.0,
             "category": "REGULAR_VEHICLE"},
        ]
    trajs = [
        np.asarray(v["track"], dtype=np.float64) if "track" in v
        else _integrate_track(v, num_frames)
        for v in vehicles
    ]
    for traj in trajs:
        # ValueError (not assert): explicit-track inputs are user data, and
        # a wrong-length track under `python -O` would silently truncate
        if traj.shape != (num_frames, 3):
            raise ValueError(
                f"explicit track must be [{num_frames}, 3] (x, y, yaw) rows, "
                f"got {traj.shape}"
            )
    ann_rows = []
    track_ids = []
    frame_ranges = [v.get("frames", (0, num_frames)) for v in vehicles]
    for v, traj, (f0, f1) in zip(vehicles, trajs, frame_ranges):
        tid = uuid.uuid4().hex
        track_ids.append(tid)
        for i, ts in enumerate(timestamps):
            if not (f0 <= i < f1):
                continue
            x, y, yaw = traj[i]
            ann_rows.append({
                "timestamp_ns": int(ts),
                "track_uuid": tid,
                "category": v.get("category", "REGULAR_VEHICLE"),
                "length_m": v.get("length", 4.5),
                "width_m": v.get("width", 2.0),
                "height_m": 1.6,
                "qw": float(np.cos(yaw / 2)), "qx": 0.0, "qy": 0.0,
                "qz": float(np.sin(yaw / 2)),
                # annotations are in the ego frame at each timestamp (AV2
                # convention; reference utils.py:204-216 uses them directly)
                "tx_m": float(x - ego_xs[i]),
                "ty_m": float(y),
                "tz_m": 0.5,
                "num_interior_pts": 50,
            })
    write_ipc_dataframe(pd.DataFrame(ann_rows), log_dir / "annotations.feather")

    # --- lidar sweeps: ground plane + boxes around each vehicle (world frame
    # shifted into per-sweep ego frame; reference transforms sweeps between
    # ego frames via poses, dataset.py:298-341)
    clutter_world = (clutter_points(rng, num_clutter, arc=clutter_arc)
                     if num_clutter else None)
    for i, ts in enumerate(timestamps):
        ex = float(ego_xs[i])
        ground = np.stack([
            rng.uniform(-20, 60, points_per_sweep // 2),
            rng.uniform(-40, 40, points_per_sweep // 2),
            rng.uniform(-1.9, -1.6, points_per_sweep // 2),
        ], axis=1)
        vpts = []
        occluders: list[tuple[float, float, float]] = []
        for v, traj, (f0, f1) in zip(vehicles, trajs, frame_ranges):
            if not (f0 <= i < f1):
                continue
            vx, vy, vyaw = traj[i]
            vx -= ex
            half_l = v.get("length", 4.5) / 2.0
            half_w = v.get("width", 2.0) / 2.0
            occluders.append(
                (vx, vy, float(np.hypot(half_l, half_w))))
            # points in the vehicle frame, rotated by the track heading
            lx = rng.uniform(-half_l, half_l, 120)
            ly = rng.uniform(-half_w, half_w, 120)
            c, s = np.cos(vyaw), np.sin(vyaw)
            vpts.append(np.stack([
                vx + c * lx - s * ly,
                vy + s * lx + c * ly,
                rng.uniform(-1.2, 0.6, 120),
            ], axis=1))
        if clutter_world is not None:
            cl = clutter_world.copy()
            cl[:, 0] -= ex
            vpts.append(cl)
        pts = np.concatenate([ground] + vpts, axis=0)
        if occlusion_drop > 0.0:
            pts = _apply_occlusion(pts, occluders, rng, occlusion_drop)
        pts = pts.astype(np.float32)
        df = pd.DataFrame({
            "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
            # AV2 stores intensity as uint8 (the reference reads this
            # column, dataset.py:311); integral values also let the chunk
            # transport ship val as u8 exactly (pack_chunk_transport)
            "intensity": rng.integers(0, 256, len(pts)).astype(np.uint8),
            "laser_number": np.zeros(len(pts), dtype=np.uint8),
            "offset_ns": np.zeros(len(pts), dtype=np.int32),
        })
        write_ipc_dataframe(df, lidar_dir / f"{ts}.feather")

    # --- map: one straight lane along world x + a crosswalk (default),
    # or the caller-provided map_data
    xs = np.arange(-30.0, 120.0, 5.0)
    def boundary(yy):
        return [{"x": float(x), "y": float(yy), "z": 0.0} for x in xs]

    map_data = map_data or {
        "lane_segments": {
            "100": {
                "id": 100,
                "is_intersection": False,
                "lane_type": "VEHICLE",
                "left_lane_boundary": boundary(3.5),
                "right_lane_boundary": boundary(-3.5),
                "left_lane_mark_type": "SOLID_YELLOW",
                "right_lane_mark_type": "SOLID_WHITE",
                "successors": [],
                "predecessors": [],
            }
        },
        "pedestrian_crossings": {
            "200": {
                "id": 200,
                "polygon": [
                    {"x": 30.0, "y": -5.0, "z": 0.0},
                    {"x": 32.0, "y": -5.0, "z": 0.0},
                    {"x": 32.0, "y": 5.0, "z": 0.0},
                    {"x": 30.0, "y": 5.0, "z": 0.0},
                ],
                "edge1": [{"x": 30.0, "y": -5.0, "z": 0.0}, {"x": 30.0, "y": 5.0, "z": 0.0}],
                "edge2": [{"x": 32.0, "y": -5.0, "z": 0.0}, {"x": 32.0, "y": 5.0, "z": 0.0}],
            }
        },
        "drivable_areas": {},
    }
    with open(map_dir / f"log_map_archive_{log_id}.json", "w") as f:
        json.dump(map_data, f)

    return log_dir


def ego_pos(frame_idx: int, ego_speed: float) -> tuple[float, float]:
    return (ego_speed * frame_idx * 0.1, 0.0)


# ---------------------------------------------------------------------------
# The scene scripts of examples/make_synthetic_dataset.py
# ---------------------------------------------------------------------------

def stopper_track(
    rng: np.random.Generator,
    stop_x: float,
    y: float,
    direction: float,
    num_frames: int,
    start_dist: float,
) -> np.ndarray:
    """World-frame [num_frames, 3] track for a 3-phase stop at ``stop_x``:
    approach at cruise speed, brisk brake to a creep, creep to the line,
    halt. The phase design targets the heuristic's bands (3 s future
    window, avg-speed thresholds 0.5 / 1.0 m/s): a uniform-decel stop
    spends as many rows in the [0.5, 1.0) m/s dead zone (labeled OTHER)
    as in the STOPPING band, and the two look visually identical — the
    creep phase instead crosses the dead zone in <1 s at cruise speed and
    stretches the STOPPING band to ~2-3 s of track (docs/TRAINING.md).
    ``direction`` +1 drives +x (yaw 0), -1 drives -x (yaw pi);
    ``start_dist`` is the initial distance to the stop line."""
    dt = 0.1
    cruise = float(rng.uniform(1.8, 2.6))
    creep = float(rng.uniform(0.30, 0.45))
    creep_dist = float(rng.uniform(1.0, 1.3))
    brake = 2.0  # m/s^2, cruise -> creep
    brake_dist = (cruise * cruise - creep * creep) / (2.0 * brake)
    yaw = 0.0 if direction > 0 else float(np.pi)
    out = np.empty((num_frames, 3))
    r = float(start_dist)  # distance still to go
    for i in range(num_frames):
        out[i] = (stop_x - direction * r, y, yaw)
        if r <= 0.02:
            v = 0.0
        elif r <= creep_dist:
            v = creep
        elif r <= creep_dist + brake_dist:
            v = min(cruise, float(np.sqrt(creep * creep + 2.0 * brake * (r - creep_dist))))
        else:
            v = cruise
        r = max(0.0, r - v * dt)
    return out


def scripted_vehicles(
    rng: np.random.Generator, crosswalk_x: float, num_frames: int = 60
) -> list[dict]:
    """A scene mix covering the intent taxonomy with SEPARABLE cues for
    every class (ego moves +x at 5 m/s; BEV covers x in [-20, 60],
    y in [-72, 72] ego-relative; map = ``multi_lane_map_data``: 4 lanes
    with centers y in {+-1.75, +-5.25}, fills covering |y| <= 7).

    Class-cue design (what the MODEL can see in the 10-sweep BEV + map):
    - KEEP_LANE: fast in-lane movers, long motion smear across sweeps.
    - PARKED (off-lane): |y| in [8.8, 10.5] — outside every lane fill in
      the map stream — zero motion smear. Plus one stopped-in-lane car
      (the heuristic labels any fully-stopped car PARKED, reference
      heuristic_labeling.py:54-55), so PARKED must be learned from the
      zero-motion cue, with the map cue as support.
    - STOPPING: gentle decelerations (a = v0^2/2d chosen to stop 1.5-3 m
      short of the crosswalk) — the labeler's STOPPING band (future
      displacement in [0.5, 1.5] m at future avg speed < 0.5 m/s,
      heuristic thresholds) then covers ~1 s of track instead of the
      ~0.4 s a hard 2-5 m/s^2 stop gives; the visible cues are a short
      motion smear + proximity to the crosswalk channel.
    - TURN / LANE_CHANGE: yaw-rate-integrated curved tracks (>20 deg and
      5-20 deg heading change over the 3 s horizon respectively).
    - OTHER: two scripted signatures for the heuristic's escape branch —
      diagonal drifters (heading fixed, lateral velocity: future leaves
      the lane polygons at dh ~ 0) and off-road movers (driving in the
      off-lane parked band). Before these, OTHER was only the track-end
      rows (< 5 future annotation steps) — pure label noise with no
      coherent signature, which capped its F1 at ~0.08 (docs/TRAINING.md).
    """
    vehicles: list[dict] = []

    def center_y(side: str = "any") -> float:
        if side == "fwd":
            choices = [1.75, 5.25]
        elif side == "onc":
            choices = [-1.75, -5.25]
        else:
            choices = [1.75, 5.25, -1.75, -5.25]
        return float(rng.choice(choices)) + float(rng.normal(0, 0.15))

    # 4 forward keep-lane movers
    for _ in range(4):
        vehicles.append({
            "start": (float(rng.uniform(5.0, 50.0)), center_y("fwd")),
            "velocity": (float(rng.uniform(3.0, 8.0)), 0.0), "yaw": 0.0,
        })
    # 2 oncoming keep-lane movers (heading -x in the y<0 lanes)
    for _ in range(2):
        v = float(rng.uniform(3.0, 8.0))
        vehicles.append({
            "start": (float(rng.uniform(35.0, 55.0)), center_y("onc")),
            "velocity": (-v, 0.0), "yaw": float(np.pi),
        })
    # 2 parked off-lane (curbside rows, outside the lane fills)
    for _ in range(2):
        side = float(rng.choice([-1.0, 1.0]))
        vehicles.append({
            "start": (float(rng.uniform(5.0, 45.0)),
                      side * float(rng.uniform(8.8, 10.5))),
            "velocity": (0.0, 0.0),
            "yaw": 0.0 if side > 0 else float(np.pi),
        })
    # 1 stopped-in-lane (zero motion, in-lane -> also PARKED per heuristic)
    vehicles.append({
        "start": (float(rng.uniform(10.0, 45.0)), center_y()),
        "velocity": (0.0, 0.0), "yaw": 0.0,
    })
    # 6 stopping: 3-phase stops (see ``stopper_track``) queued short of
    # the crosswalk. Start distances are STAGGERED so the labeler's
    # STOPPING band is populated somewhere in the scene at every frame
    # of the log, not just in one early burst.
    for i in range(6):
        # distinct queue slot per stopper (~6 m pitch) so same-lane cars
        # halt like a queue at a light, never overlapping GT boxes
        gap = 1.5 + 6.0 * (i // 2) + float(rng.uniform(0.0, 1.5))
        start_dist = 1.5 + 3.2 * i / 2 + float(rng.uniform(0.0, 1.8))
        if i % 3 != 2:  # forward lanes, approaching from -x
            vehicles.append({"track": stopper_track(
                rng, crosswalk_x - gap, center_y("fwd"), +1.0,
                num_frames, start_dist)})
        else:      # oncoming lane, approaching from +x
            vehicles.append({"track": stopper_track(
                rng, crosswalk_x + 2.5 + gap, center_y("onc"), -1.0,
                num_frames, start_dist)})
    # 2 turners (>20 deg heading change within the 3 s horizon)
    for sign in (1.0, -1.0):
        vehicles.append({
            "start": (float(rng.uniform(10.0, 45.0)), center_y("fwd")),
            "velocity": (float(rng.uniform(3.0, 6.0)), 0.0), "yaw": 0.0,
            "yaw_rate": sign * float(rng.uniform(0.25, 0.45)),
        })
    # 4 lane changers (5-20 deg drift over the horizon). Three cue
    # decisions target the classes' F1 plateau at ~0.35 (docs/TRAINING.md
    # — LEFT/RIGHT_CHANGE were the weakest non-OTHER classes):
    # (a) yaw_rate 0.075-0.11 rad/s -> dh over the 3 s horizon is
    #     12.9-18.9 deg: max margin from BOTH label boundaries (5 deg
    #     KEEP_LANE, 20 deg TURN) and ~2.5x the old band's lower edge, so
    #     the visible curvature separates further from keep-laners;
    # (b) speeds 5-9 m/s: a faster car sweeps a longer 10-sweep motion
    #     smear, making the same curvature visibly larger (lateral offset
    #     grows ~ v*w*t^2/2);
    # (c) a random maneuver PHASE (initial heading 0-8 deg into the
    #     drift, with the matching lateral offset off the lane center):
    #     mid-maneuver cars straddle the dashed boundary — the map-
    #     relative cue a real lane change shows — instead of every
    #     example starting dead-center. dh is phase-invariant (constant
    #     yaw rate), so labels stay LANE_CHANGE throughout.
    for i in range(4):
        sign = 1.0 if i % 2 == 0 else -1.0
        phase = float(rng.uniform(0.0, 0.14))  # rad, 0-8 deg
        vehicles.append({
            "start": (float(rng.uniform(5.0, 45.0)),
                      center_y("fwd") + sign * phase * 12.0),
            "velocity": (float(rng.uniform(5.0, 9.0)), 0.0),
            "yaw": sign * phase,
            "yaw_rate": sign * float(rng.uniform(0.075, 0.11)),
        })
    # 1 diagonal drifter: heading fixed but velocity has a lateral
    # component (crab-walk). dh stays ~0 so the labeler reaches the
    # lane-containment check, and the future escapes the current-lane(+
    # successor) polygons -> OTHER (reference heuristic_labeling.py:112-117).
    # Visual signature: motion smear diagonal to the box heading.
    vehicles.append({
        "start": (float(rng.uniform(5.0, 40.0)), center_y("fwd")),
        "velocity": (float(rng.uniform(3.0, 6.0)),
                     float(rng.choice([-1.0, 1.0]))
                     * float(rng.uniform(1.2, 1.8))),
        "yaw": 0.0,
    })
    # 1 off-road mover: driving along x where only parked cars sit
    # (|y| in [8.8, 10.5], outside every lane fill). A lane is still
    # within the 5 m map-search radius but never contains it -> OTHER.
    # Visual signature: motion smear in the off-lane band of the map.
    side = float(rng.choice([-1.0, 1.0]))
    vehicles.append({
        "start": (float(rng.uniform(5.0, 40.0)),
                  side * float(rng.uniform(8.8, 10.5))),
        "velocity": ((1.0 if side > 0 else -1.0)
                     * float(rng.uniform(2.5, 5.0)), 0.0),
        "yaw": 0.0 if side > 0 else float(np.pi),
    })
    return vehicles


def curved_scripted_vehicles(
    rng: np.random.Generator, radius: float, sign: float,
    num_frames: int = 60,
) -> list[dict]:
    """Scene mix on the curved 4-lane corridor
    (``curved_multi_lane_map_data``). Every vehicle is expressed through
    the integrator API: start/yaw from ``curved_arc_point`` and
    yaw_rate = v/(R-d) (the EXACT lane circle — same center, same radius
    — so a 'keep-laner' follows its lane indefinitely), plus the class's
    extra rate on top. The kinematic label bands (3 s horizon dh
    thresholds 5/20 deg) constrain the speed/rate envelopes:

    - KEEP_LANE: v <= 6.5, R >= 250 -> dh = 3v/R <= 4.5 deg < 5 ✓; but
      visually every keep-laner now CURVES, so curvature alone no longer
      separates them from lane-changers — the map's lane geometry does.
    - LANE_CHANGE: extra rate 0.06-0.085 at v in [3.5, 6]: total dh in
      [8.2, 18.7] deg for both drift directions — inside (5, 20) ✓.
    - TURN: extra 0.25-0.45 dominates the lane term -> > 20 deg ✓.
    - STOPPING: integrator decel to rest (no crosswalk on curved logs;
      the band is kinematic).
    - PARKED: off-lane band d = +-[8.8, 10.5] (outside every lane fill).
    - OTHER: off-road mover driving the off-lane band along the arc.
    """
    vehicles: list[dict] = []

    def arc_vehicle(t0, d, speed, extra_rate=0.0, oncoming=False,
                    accel=0.0):
        x, y, yaw = curved_arc_point(radius, t0, d, sign)
        r = radius - d
        if oncoming:
            yaw += float(np.pi)
            rate = -sign * speed / r + extra_rate
        else:
            rate = sign * speed / r + extra_rate
        return {
            "start": (x, y), "yaw": yaw,
            "velocity": (speed * float(np.cos(yaw)),
                         speed * float(np.sin(yaw))),
            "yaw_rate": rate, "accel": accel,
        }

    def lane_d(side: str) -> float:
        if side == "fwd":
            choices = [1.75, 5.25]
        else:
            choices = [-1.75, -5.25]
        return sign * (float(rng.choice(choices)) + float(rng.normal(0, 0.15)))

    # 5 forward + 2 oncoming keep-laners (dense -> occlusion chains)
    for _ in range(5):
        vehicles.append(arc_vehicle(
            float(rng.uniform(5.0, 50.0)), lane_d("fwd"),
            float(rng.uniform(3.0, 6.5))))
    for _ in range(2):
        vehicles.append(arc_vehicle(
            float(rng.uniform(35.0, 55.0)), lane_d("onc"),
            float(rng.uniform(3.0, 6.5)), oncoming=True))
    # 3 parked off-lane + 1 stopped-in-lane
    for _ in range(3):
        d = float(rng.choice([-1.0, 1.0])) * float(rng.uniform(8.8, 10.5))
        x, y, yaw = curved_arc_point(radius, float(rng.uniform(5.0, 45.0)),
                                     d, sign)
        vehicles.append({"start": (x, y), "yaw": yaw,
                         "velocity": (0.0, 0.0)})
    x, y, yaw = curved_arc_point(radius, float(rng.uniform(10.0, 45.0)),
                                 lane_d("fwd"), sign)
    vehicles.append({"start": (x, y), "yaw": yaw, "velocity": (0.0, 0.0)})
    # 3 stoppers: decelerate to rest mid-corridor
    for _ in range(3):
        v0 = float(rng.uniform(1.8, 2.6))
        vehicles.append(arc_vehicle(
            float(rng.uniform(8.0, 40.0)), lane_d("fwd"), v0,
            accel=-float(rng.uniform(0.55, 0.85))))
    # 2 turners
    for turn_sign in (1.0, -1.0):
        vehicles.append(arc_vehicle(
            float(rng.uniform(10.0, 45.0)), lane_d("fwd"),
            float(rng.uniform(3.0, 6.0)),
            extra_rate=turn_sign * float(rng.uniform(0.25, 0.45))))
    # 4 lane changers (see envelope in the docstring)
    for i in range(4):
        drift = (1.0 if i % 2 == 0 else -1.0) * float(rng.uniform(0.06, 0.085))
        vehicles.append(arc_vehicle(
            float(rng.uniform(5.0, 45.0)), lane_d("fwd"),
            float(rng.uniform(3.5, 6.0)), extra_rate=drift))
    # 1 off-road mover (OTHER): drives the off-lane band along the arc
    d = float(rng.choice([-1.0, 1.0])) * float(rng.uniform(8.8, 10.5))
    vehicles.append(arc_vehicle(
        float(rng.uniform(5.0, 40.0)), d, float(rng.uniform(2.5, 5.0))))
    return vehicles


def ego_profile(rng: np.random.Generator, mode: str, num_frames: int,
                ego_speed: float = 5.0) -> np.ndarray:
    """Per-frame ego x positions. ``stopped``: red light — ego stationary at
    x=0 the whole log, so ego frame == world frame and the heuristic's
    ego-relative labels (see data.synthetic.write_synthetic_log) equal the
    scripted absolute behaviors. ``cruise``: constant-velocity ego — labels
    pick up the reference's ego-relative semantics (a same-speed car labels
    PARKED, a truly parked car labels as moving), which is EXACTLY the
    noise real AV2 labels carry; kept as a minority so training still sees
    it and multi-sweep ego-compensation stays exercised."""
    if mode == "stopped":
        return np.zeros(num_frames)
    return np.arange(num_frames) * 0.1 * ego_speed
