"""GT-consistent point-space BEV augmentation (the train step's path).

Counterpart of the point-space half of ``intentbev/bev/augment.py``:

- on the host, per sample (numpy): :func:`draw_aug_params` draws
  (flip_sign, theta, scale), :func:`aug_linear_matrix` gives the 2x2
  content transform and :func:`augment_points_np` applies it to the points
  of the chunk train transport, copies of the JAX package's functions;
- on the device: :func:`augment_points_gt` applies
  p' = s * R(theta) * diag(1, flip_sign) * p to the raw points and the same
  transform (with the L/R intention swap under a flip) to the GT boxes;
- patch dropout: :func:`draw_dropout` draws the random numbers, and
  :func:`dropout_keep_mask` is the function of them, so a test can feed
  the JAX package's draws;
- :func:`bilinear_sample`, JAX's ``_bilinear_sample``: the device map warp
  of ``bev/city_raster.py`` samples with it;
- the image-space path (``augment_bev`` / ``batched_augment_bev`` of the
  JAX module), which the train step takes for a points batch without
  ``aug_params``: :func:`draw_image_aug` draws the per-sample flip,
  rotation and scale with JAX's distributions, and :func:`augment_bev` is
  the function of those draws and the dropout's keep mask, JAX's math
  step by step (the flip, the inverse affine about the ego origin in f32,
  one bilinear sample over lidar and map concatenated, the map cast back
  to its dtype, the GT rotated, scaled and wrapped, the dropout mask,
  invalid GT kept as given).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..configs import INTENTIONS_MAP as IM

FLIP_INTENT_TABLE = np.array(
    [IM["KEEP_LANE"], IM["TURN_RIGHT"], IM["TURN_LEFT"], IM["RIGHT_CHANGE_LANE"],
     IM["LEFT_CHANGE_LANE"], IM["STOPPING_STOPPED"], IM["PARKED"], IM["OTHER"]],
    dtype=np.int32)

IDENTITY_AUG = np.array([1.0, 0.0, 1.0], dtype=np.float32)


def draw_aug_params(cfg, rng: np.random.Generator, n: int) -> np.ndarray:
    """Host draw of (flip_sign, theta_rad, scale) per sample, f32[n, 3];
    identity rows are (1, 0, 1)."""
    flip = np.where(rng.random(n) < cfg.flip_prob, -1.0, 1.0)
    theta = np.deg2rad(
        rng.uniform(cfg.rotate_range_deg[0], cfg.rotate_range_deg[1], n)
    ) * (rng.random(n) < cfg.rotate_prob)
    scale = np.where(
        rng.random(n) < cfg.scale_prob,
        rng.uniform(cfg.scale_range[0], cfg.scale_range[1], n),
        1.0,
    )
    return np.stack([flip, theta, scale], axis=1).astype(np.float32)


def aug_linear_matrix(params_row) -> np.ndarray:
    """2x2 content transform A = scale * R(theta) * diag(1, flip_sign) in
    ego-metric (x fwd, y left) coordinates."""
    fs, theta, s = (float(v) for v in params_row)
    c, si = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -si], [si, c]], dtype=np.float64)
    return s * rot @ np.array([[1.0, 0.0], [0.0, fs]], dtype=np.float64)


def augment_points_np(points: np.ndarray, aug_params) -> np.ndarray:
    """Host (numpy) twin of the point half of :func:`augment_points_gt`:
    p' = s * R(theta) * diag(1, flip_sign) * p on f32[..., 4] points, in
    the same f32 operation order."""
    fs, theta, s = (np.float32(aug_params[i]) for i in range(3))
    x = points[..., 0]
    y = points[..., 1] * fs
    ca, sa = np.cos(theta, dtype=np.float32), np.sin(theta, dtype=np.float32)
    out = points.copy()
    out[..., 0] = s * (x * ca - y * sa)
    out[..., 1] = s * (x * sa + y * ca)
    return out


def augment_gt(gt_boxes, gt_intentions, gt_valid, aug_params):
    """Flip/rotate/scale GT boxes f32[B, G, 5] and swap L/R intentions under
    a flip; padded GT stays as it was. aug_params f32[B, 3]."""
    fs, theta, s = (aug_params[:, i, None] for i in range(3))
    do_flip = fs < 0
    flipped = gt_boxes * torch.tensor([1.0, -1.0, 1.0, 1.0, -1.0], device=gt_boxes.device)
    boxes = torch.where(do_flip[..., None], flipped, gt_boxes)
    table = torch.as_tensor(FLIP_INTENT_TABLE, device=gt_intentions.device).long()
    intents = torch.where(do_flip, table[gt_intentions.long().clamp(min=0)].to(
        gt_intentions.dtype), gt_intentions)
    ca, sa = torch.cos(theta), torch.sin(theta)
    cx, cy, bw, bl, yaw = boxes.unbind(-1)
    yaw = yaw + theta
    boxes = torch.stack([(cx * ca - cy * sa) * s, (cx * sa + cy * ca) * s, bw * s, bl * s,
                         torch.atan2(torch.sin(yaw), torch.cos(yaw))], dim=-1)
    valid = gt_valid.bool()
    return (torch.where(valid[..., None], boxes, gt_boxes),
            torch.where(valid, intents, gt_intentions).int())


def augment_points_gt(points, gt_boxes, gt_intentions, gt_valid, aug_params):
    """Apply (flip -> rotate -> scale) to raw points f32[B, S, P, 4] and to
    the GT; returns (points, boxes, intentions)."""
    fs, theta, s = (aug_params[:, i, None, None] for i in range(3))
    x, y = points[..., 0], points[..., 1] * fs
    ca, sa = torch.cos(theta), torch.sin(theta)
    pts = torch.stack([s * (x * ca - y * sa), s * (x * sa + y * ca),
                       points[..., 2], points[..., 3]], dim=-1)
    boxes, intents = augment_gt(gt_boxes, gt_intentions, gt_valid, aug_params)
    return pts, boxes, intents


def bilinear_sample(img: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img [H, W, C] at float (rows, cols) [..., h, w] ->
    [..., h, w, C]; taps outside the image read 0. The four taps and their
    weights are summed in the JAX function's order."""
    h, w, _ = img.shape
    r0 = torch.floor(rows)
    c0 = torch.floor(cols)
    dr = (rows - r0)[..., None]
    dc = (cols - c0)[..., None]
    r0i = r0.long()
    c0i = c0.long()

    def gather(ri, ci):
        ok = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w)
        vals = img[ri.clamp(0, h - 1), ci.clamp(0, w - 1)]
        return torch.where(ok[..., None], vals, 0.0)

    v00 = gather(r0i, c0i)
    v01 = gather(r0i, c0i + 1)
    v10 = gather(r0i + 1, c0i)
    v11 = gather(r0i + 1, c0i + 1)
    return (v00 * (1 - dr) * (1 - dc) + v01 * (1 - dr) * dc
            + v10 * dr * (1 - dc) + v11 * dr * dc)


class DropoutDraws(NamedTuple):
    """Random numbers of the patch dropout, per sample: whether to drop,
    how many patches, and each patch's height, width and corner (the
    ``dropout_num_patches[1]`` slots of a sample beyond its count are
    unused)."""

    do_drop: torch.Tensor      # bool[B]
    num_patches: torch.Tensor  # i64[B]
    ph: torch.Tensor           # i64[B, max_patches]
    pw: torch.Tensor
    r0: torch.Tensor
    c0: torch.Tensor


def draw_dropout(cfg, h: int, w: int, batch: int, generator: torch.Generator,
                 device) -> DropoutDraws:
    """Draw the patch dropout's random numbers with the distributions of
    ``intentbev/bev/augment.py::dropout_keep_mask``: drop with
    ``dropout_prob``; a patch count, sizes and corners uniform over their
    inclusive/exclusive ranges."""
    def uniform_int(lo, hi_excl, shape):
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float64)
        return (lo + torch.floor(u * (hi_excl - lo))).long()

    m = cfg.dropout_num_patches[1]
    lo, hi = cfg.dropout_patch_px
    do_drop = torch.rand(batch, generator=generator, device=device) < cfg.dropout_prob
    num = uniform_int(cfg.dropout_num_patches[0], m + 1, (batch,))
    ph = uniform_int(lo, hi + 1, (batch, m))
    pw = uniform_int(lo, hi + 1, (batch, m))
    r0 = uniform_int(0, (h - ph + 1).clamp(min=1), (batch, m))
    c0 = uniform_int(0, (w - pw + 1).clamp(min=1), (batch, m))
    return DropoutDraws(do_drop, num, ph, pw, r0, c0)


def dropout_keep_mask(draws: DropoutDraws, h: int, w: int) -> torch.Tensor:
    """bool[B, h, w] keep mask: a cell is dropped when the sample drops and
    the cell lies in one of its first ``num_patches`` patches."""
    dev = draws.ph.device
    rows = torch.arange(h, device=dev)[None, None, :, None]
    cols = torch.arange(w, device=dev)[None, None, None, :]

    def e(t):
        return t[:, :, None, None]

    slot = torch.arange(draws.ph.shape[1], device=dev)[None, :]
    active = draws.do_drop[:, None] & (slot < draws.num_patches[:, None])
    in_patch = ((rows >= e(draws.r0)) & (rows < e(draws.r0 + draws.ph))
                & (cols >= e(draws.c0)) & (cols < e(draws.c0 + draws.pw)))
    return ~(in_patch & e(active)).any(1)


class ImageAugDraws(NamedTuple):
    """Random numbers of the image-space augmentation, per sample: flip or
    not, rotate or not and by how many degrees, scale or not and by what
    factor (``angle_deg`` and ``s`` are drawn whether or not they apply, as
    JAX draws them)."""

    do_flip: torch.Tensor   # bool[B]
    do_rot: torch.Tensor    # bool[B]
    angle_deg: torch.Tensor  # f32[B], uniform over rotate_range_deg
    do_scale: torch.Tensor  # bool[B]
    s: torch.Tensor         # f32[B], uniform over scale_range


def draw_image_aug(cfg, batch: int, generator: torch.Generator, device) -> ImageAugDraws:
    """Draw the image-space augmentation's random numbers with the
    distributions of ``intentbev/bev/augment.py::augment_bev``: Bernoulli
    flip, rotation and scale with their probabilities, the angle and the
    factor uniform over their ranges."""
    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(batch, generator=generator, device=device)

    return ImageAugDraws(u() < cfg.flip_prob, u() < cfg.rotate_prob, u(*cfg.rotate_range_deg),
                         u() < cfg.scale_prob, u(*cfg.scale_range))


def augment_bev(lidar_bev, map_bev, gt_boxes, gt_intentions, gt_valid, draws: ImageAugDraws,
                keep_mask, grid):
    """Image-space augmentation of a batch, JAX's ``batched_augment_bev`` as
    a function of its draws: lidar [B, H, W, CL], map [B, H, W, CM], GT
    boxes f32[B, G, 5], intentions [B, G], gt_valid [B, G], the dropout's
    keep mask bool[B, H, W]. Returns (lidar, map, boxes, intentions):
    lidar is f32, the dtype of the bilinear sample (as in JAX, whose
    ``where`` promotes it); the map is cast back to its dtype before the
    dropout mask, which has lidar's dtype."""
    dev = lidar_bev.device
    h, w = grid.height_px, grid.width_px
    oy, ox, vs = grid.pixel_offset_y, grid.pixel_offset_x, grid.voxel_size_m

    # flip: mirror the W axis, negate cy and yaw, swap left and right
    flip = draws.do_flip.to(dev)
    lidar_bev = torch.where(flip[:, None, None, None], lidar_bev.flip(2), lidar_bev)
    map_bev = torch.where(flip[:, None, None, None], map_bev.flip(2), map_bev)
    boxes = torch.where(flip[:, None, None],
                        gt_boxes * torch.tensor([1.0, -1.0, 1.0, 1.0, -1.0], device=dev),
                        gt_boxes)
    table = torch.as_tensor(FLIP_INTENT_TABLE, device=dev).long()
    intents = torch.where(flip[:, None], table[gt_intentions.long().clamp(min=0)].to(
        gt_intentions.dtype), gt_intentions)

    # rotate + scale as one inverse affine about the ego origin, in f32
    f32 = torch.float32
    do_rot, do_scale = draws.do_rot.to(dev), draws.do_scale.to(dev)
    deg = torch.tensor(np.float32(np.pi / 180.0), device=dev)
    theta = torch.where(do_rot, draws.angle_deg.to(dev, f32) * deg, torch.zeros((), device=dev))
    s = torch.where(do_scale, draws.s.to(dev, f32), torch.ones((), device=dev))
    rows = torch.arange(h, device=dev, dtype=f32)[:, None].expand(h, w)
    cols = torch.arange(w, device=dev, dtype=f32)[None, :].expand(h, w)
    x_out = (oy - rows) * vs
    y_out = (cols - ox) * vs
    ct, st = torch.cos(-theta)[:, None, None], torch.sin(-theta)[:, None, None]
    sb = s[:, None, None]
    x_src = (ct * x_out - st * y_out) / sb
    y_src = (st * x_out + ct * y_out) / sb
    src_rows = oy - x_src / vs
    src_cols = ox + y_src / vs
    identity = ~do_rot & ~do_scale

    # lidar and map warped as one tensor; a sample that neither rotates nor
    # scales keeps its values
    cl, map_dtype = lidar_bev.shape[-1], map_bev.dtype
    combined = torch.cat([lidar_bev, map_bev.to(lidar_bev.dtype)], dim=-1)
    sampled = torch.stack([bilinear_sample(combined[i], src_rows[i], src_cols[i])
                           for i in range(combined.shape[0])])
    warped = torch.where(identity[:, None, None, None], combined, sampled)
    lidar_bev = warped[..., :cl]
    map_bev = warped[..., cl:].to(map_dtype)

    # GT: rotate centres and heading, then scale cx, cy, w, l; wrap the yaw
    ca, sa = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    cx, cy, bw, bl, yaw = boxes.unbind(-1)
    yaw = yaw + theta[:, None]
    sg = s[:, None]
    boxes = torch.stack([(cx * ca - cy * sa) * sg, (cx * sa + cy * ca) * sg, bw * sg, bl * sg,
                         torch.atan2(torch.sin(yaw), torch.cos(yaw))], dim=-1)

    keep = keep_mask[..., None].to(lidar_bev.dtype)  # promotes the map, as in JAX
    lidar_bev = lidar_bev * keep
    map_bev = map_bev * keep

    valid = gt_valid.bool()
    return (lidar_bev, map_bev, torch.where(valid[..., None], boxes, gt_boxes),
            torch.where(valid, intents, gt_intentions).int())
