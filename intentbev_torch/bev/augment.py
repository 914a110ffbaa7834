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
  the JAX package's draws.
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
