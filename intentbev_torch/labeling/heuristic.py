"""A copy of ``intentbev/labeling/heuristic.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_data.py`` holds the labels it
writes against the original's.

Heuristic vehicle-intention labeling from future trajectories + map context.

Semantics-parity rebuild of the reference's per-row decision tree
(heuristic_labeling.py:10-124), vectorised per track: the reference
re-filters the full annotations dataframe for EVERY row (its line 31),
making label precompute O(rows^2) per log; here each track is sliced once
and all of its rows are labelled with one pass of numpy array ops.

Decision tree (thresholds from configs.HeuristicConfig = reference
constants.py:50-61):
  future window = next <= 30 annotation steps, >= 5 required, else OTHER;
  avg speed < 0.5 m/s       -> PARKED if total displacement < 0.5 m
                               else STOPPING_STOPPED;
  |heading change| > 20 deg (and speed >= 1.0)  -> TURN_LEFT / TURN_RIGHT;
  in intersection (map) and |dh| <= 5 deg        -> KEEP_LANE (else OTHER);
  5 deg < |dh| < 20 deg outside intersections    -> LANE_CHANGE L/R;
  |dh| <= 5 deg: future points all inside current-lane+successor polygons
      -> KEEP_LANE; without polygons, lateral drift < 0.5 m -> KEEP_LANE;
  otherwise OTHER.

Deliberate fix (SURVEY.md §2 'known latent defects'): the reference's
lane-containment expression requires every future point to be inside
EVERY candidate polygon (heuristic_labeling.py:112-113); the intended —
and implemented — semantics is every point inside SOME candidate polygon.

Map context comes from first-party ``MapElements`` (no av2/shapely
dependency): nearest lane by boundary-point distance within 5 m,
intersection flag, successor lookup, and point-in-polygon by even-odd
ray casting.
"""

from __future__ import annotations

import numpy as np

from ..configs import INTENTIONS_MAP, HeuristicConfig, VEHICLE_CATEGORIES
from ..geometry import quat_to_yaw, wrap_angle


def _points_in_polygon(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Even-odd ray-cast containment, vectorised over points [N, 2]."""
    if len(poly) < 3 or len(points) == 0:
        return np.zeros(len(points), dtype=bool)
    x, y = points[:, 0], points[:, 1]
    x1, y1 = poly[:, 0], poly[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    inside = np.zeros(len(points), dtype=bool)
    for i in range(len(poly)):
        cond = (y1[i] <= y) != (y2[i] <= y)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (y - y1[i]) / (y2[i] - y1[i])
        xi = x1[i] + t * (x2[i] - x1[i])
        inside ^= cond & (x < xi)
    return inside


class MapContext:
    """Nearest-lane queries over parsed MapElements (replaces the av2
    ``get_nearby_lane_segments`` + shapely usage in the reference)."""

    def __init__(self, elements):
        self.lanes = {lane.lane_id: lane for lane in elements.lanes}
        pts, ids = [], []
        for lane in elements.lanes:
            for b in (lane.left_boundary, lane.right_boundary):
                if len(b):
                    pts.append(b)
                    ids.append(np.full(len(b), lane.lane_id))
        if pts:
            self._pts = np.concatenate(pts, axis=0)
            self._ids = np.concatenate(ids, axis=0)
            from scipy.spatial import cKDTree

            self._tree = cKDTree(self._pts)
        else:
            self._tree = None

    def nearest_lane(self, xy: np.ndarray, radius: float):
        """-> (lane_id, dist) or (None, inf).

        av2's ``get_nearby_lane_segments`` distance (which the reference
        minimises over, heuristic_labeling.py:66-69) is the distance to the
        lane POLYGON — zero for a point inside the lane — not to sampled
        boundary points. A pure boundary-point KD-tree gets this wrong for
        in-lane points (a car at lane center is equidistant from its own
        and the adjacent lane's shared boundary, so the "nearest" lane is a
        coin flip and downstream containment fails ~half the time). So:
        query candidate lanes by boundary proximity, then prefer any lane
        that CONTAINS the point (distance 0), falling back to boundary
        distance.
        """
        if self._tree is None:
            return None, np.inf
        k = min(16, len(self._pts))
        dists, idxs = self._tree.query(xy, k=k)
        dists, idxs = np.atleast_1d(dists), np.atleast_1d(idxs)
        if dists[0] > radius:
            return None, np.inf
        pt = np.asarray(xy, dtype=np.float64).reshape(1, 2)
        seen: set[int] = set()
        for d, i in zip(dists, idxs):
            if d > radius:
                break
            lid = int(self._ids[i])
            if lid in seen:
                continue
            seen.add(lid)
            poly = self.lane_polygon(lid)
            if poly is not None and bool(_points_in_polygon(pt, poly)[0]):
                return lid, 0.0
        return int(self._ids[idxs[0]]), float(dists[0])

    def lane_polygon(self, lane_id: int) -> np.ndarray | None:
        lane = self.lanes.get(lane_id)
        if lane is None or len(lane.left_boundary) < 2 or len(lane.right_boundary) < 2:
            return None
        return np.vstack([lane.left_boundary, lane.right_boundary[::-1]])

    def successors(self, lane_id: int) -> tuple:
        lane = self.lanes.get(lane_id)
        return lane.successors if lane is not None else ()


def label_track(
    ts_ns: np.ndarray,
    xy: np.ndarray,
    quats: np.ndarray,
    cfg: HeuristicConfig,
    map_ctx: MapContext | None = None,
) -> np.ndarray:
    """Label every row of one track (sorted by timestamp).

    ts_ns i64[T]; xy f64[T, 2]; quats f64[T, 4] as (qx, qy, qz, qw).
    Returns i32[T] intention ids.
    """
    T = len(ts_ns)
    out = np.full(T, INTENTIONS_MAP["OTHER"], dtype=np.int32)
    if T == 0:
        return out

    yaw = quat_to_yaw(quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3])

    idx = np.arange(T)
    end = np.minimum(idx + cfg.horizon_steps, T - 1)
    n_future = (T - 1) - idx  # rows strictly after i
    enough = n_future >= cfg.min_future_points

    disp = xy[end] - xy
    dist = np.linalg.norm(disp, axis=1)
    dt = (ts_ns[end] - ts_ns) * 1e-9 + 1e-9
    speed = dist / dt
    dh = wrap_angle(yaw[end] - yaw)

    stopped = enough & (speed < cfg.min_speed_stopped)
    out[stopped & (dist < cfg.parked_max_disp_m)] = INTENTIONS_MAP["PARKED"]
    out[stopped & (dist >= cfg.parked_max_disp_m)] = INTENTIONS_MAP["STOPPING_STOPPED"]

    moving = enough & ~stopped & (speed >= cfg.min_speed_moving)
    turn_l = moving & (dh > cfg.heading_change_thresh_turn)
    turn_r = moving & (dh < -cfg.heading_change_thresh_turn)
    out[turn_l] = INTENTIONS_MAP["TURN_LEFT"]
    out[turn_r] = INTENTIONS_MAP["TURN_RIGHT"]

    # remaining moving rows: map context decides between KEEP_LANE /
    # LANE_CHANGE / OTHER
    rest = moving & ~turn_l & ~turn_r
    small_dh = np.abs(dh) <= cfg.heading_change_thresh_lane_keep
    mid_dh = (~small_dh) & (np.abs(dh) < cfg.heading_change_thresh_turn)

    for i in np.where(rest)[0]:
        lane_id, in_intersection = None, False
        have_ctx = False
        if map_ctx is not None:
            lane_id, _ = map_ctx.nearest_lane(xy[i], cfg.map_search_radius)
            if lane_id is not None:
                have_ctx = True
                lane = map_ctx.lanes.get(lane_id)
                in_intersection = bool(lane.is_intersection) if lane else False

        if have_ctx and in_intersection:
            # reference heuristic_labeling.py:83-84
            out[i] = INTENTIONS_MAP["KEEP_LANE"] if small_dh[i] else INTENTIONS_MAP["OTHER"]
            continue

        if mid_dh[i]:
            out[i] = (
                INTENTIONS_MAP["LEFT_CHANGE_LANE"] if dh[i] > 0
                else INTENTIONS_MAP["RIGHT_CHANGE_LANE"]
            )
            continue

        if small_dh[i]:
            checked_polygons = False
            contained = False
            if have_ctx:
                polys = []
                cand = {lane_id, *map_ctx.successors(lane_id)}
                for lid in cand:
                    p = map_ctx.lane_polygon(lid)
                    if p is not None:
                        polys.append(p)
                if polys:
                    checked_polygons = True
                    fut = xy[i + 1 : end[i] + 1]
                    inside_any = np.zeros(len(fut), dtype=bool)
                    for p in polys:
                        inside_any |= _points_in_polygon(fut, p)
                    contained = bool(inside_any.all()) and len(fut) > 0
            if checked_polygons and contained:
                out[i] = INTENTIONS_MAP["KEEP_LANE"]
            elif not checked_polygons:
                # kinematic fallback (heuristic_labeling.py:118-122)
                hv = np.array([np.cos(yaw[i]), np.sin(yaw[i])])
                lat = np.linalg.norm(disp[i] - np.dot(disp[i], hv) * hv)
                if lat < cfg.keep_lane_max_lat_dist_fallback:
                    out[i] = INTENTIONS_MAP["KEEP_LANE"]
            # else: polygons checked but escaped -> OTHER
    return out


def label_log_annotations(
    annotations_df,
    cfg: HeuristicConfig,
    map_ctx: MapContext | None = None,
):
    """Add a ``heuristic_intent`` column to a log's annotations dataframe.

    Vehicle-category rows get a heuristic label, everything else -1
    (reference preprocess_intent_labels.py:41-57). One pass per track
    instead of one dataframe filter per row.
    """


    df = annotations_df
    intents = np.full(len(df), -1, dtype=np.int32)
    is_vehicle = df["category"].isin(VEHICLE_CATEGORIES).to_numpy()

    for track_id, group_idx in df.groupby("track_uuid").indices.items():
        gi = np.asarray(group_idx)
        if not is_vehicle[gi].any():
            continue
        gi = gi[np.argsort(df["timestamp_ns"].to_numpy()[gi], kind="stable")]
        sub = df.iloc[gi]
        labels = label_track(
            sub["timestamp_ns"].to_numpy(np.int64),
            sub[["tx_m", "ty_m"]].to_numpy(np.float64),
            sub[["qx", "qy", "qz", "qw"]].to_numpy(np.float64),
            cfg,
            map_ctx,
        )
        veh_rows = is_vehicle[gi]
        intents[gi[veh_rows]] = labels[veh_rows]

    out = df.copy()
    out["heuristic_intent"] = intents
    return out
