"""Gripper collision checks and the antipodal score (JAX
``eval/collision.py``), every grasp at once, chunked over grasps to bound
the [g, N] workspace; on the device of `points`.

Regions in each grasp's frame (``eval_score/configs/config.py``):
  close plane    -bottom_length < x < depth, needs >= 16 points
  hand slab      |z| < half_hand_thickness
  back collision |y| < w/2 + fw, x < -margin, in the slab: none tolerated
  finger region  w/2 < |y| < w/2 + fw, in the slab: none tolerated
  close region   |y| < w/2, in the slab; >= 16 points (validate path)
  antipodal      the mean |n.y| over each finger's contact band, multiplied

Local coordinates are written out as JAX's CPU dot rounds them eagerly,
``fma(f2, r2, fma(f1, r1, f0 * r0))`` with each fused multiply-add taken
in f64 and rounded to f32 (no `einsum`, no TF32): the card and the CPU then
give the same bits, and no region count flips between them.  Sums of the
normals' |n.y| over a band are taken in f64, so that the chunk and the
device move them by about 1e-16 at most.  Padding grasps, where JAX pads
a chunk, are identity frames at the origin; here chunks are cut, which
gives the same results for the real grasps.
"""

from __future__ import annotations

import torch

from regnet_for_3d_grasping_torch.config import EvalConfig, GripperConfig
from regnet_for_3d_grasping_torch.geometry.codec import grasps_to_frames


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """f32 x*y + z rounded once (the f64 product is exact)."""
    return (x.double() * y.double() + z.double()).float()


def _rotate(frame: torch.Tensor, v: tuple) -> list:
    """frame [g, 3, 3], v three [g or 1, N] components -> the three [g, N]
    components of frame^T v: sum_j frame[:, j, i] * v_j."""
    f = frame[:, :, :, None]                               # [g, 3, 3, 1]
    return [_fma(f[:, 2, i], v[2], _fma(f[:, 1, i], v[1], f[:, 0, i] * v[0]))
            for i in range(3)]


def _local_coords(points: torch.Tensor, frame: torch.Tensor,
                  center: torch.Tensor) -> list:
    """points [N, 3], frame [g, 3, 3], center [g, 3] -> x, y, z [g, N] in
    each grasp's frame."""
    rel = [points[None, :, j] - center[:, j, None] for j in range(3)]
    return _rotate(frame, rel)


def _region_masks(local: list, depth: torch.Tensor, gripper: GripperConfig,
                  cfg: EvalConfig):
    x, y, z = local
    ay = torch.abs(y)
    close_plane = (x > -gripper.bottom_length) & (x < depth)
    slab = close_plane & (torch.abs(z) < gripper.half_hand_thickness)
    hw = gripper.hand_half_bottom_width
    hs = gripper.hand_half_bottom_space
    back = slab & (ay < hw) & (x < -cfg.back_collision_margin)
    finger = slab & (ay > hs) & (ay < hw)
    close_region = slab & (ay < hs)
    return close_plane, back, finger, close_region


def _prepare(grasps: torch.Tensor, depth, table_height, table_sign,
             cfg: EvalConfig):
    """Frames, centers, depths [G] and the fingertip-above-table test."""
    frames, centers = grasps_to_frames(grasps.float())
    G = grasps.shape[0]
    depth = torch.as_tensor(depth, dtype=torch.float32,
                            device=grasps.device).expand(G).contiguous()
    above = None
    if table_height is not None:
        tip_z = centers[:, 2] + frames[:, 2, 0] * depth
        above = tip_z >= table_height + table_sign * cfg.table_offset
    return frames, centers, depth, above


def _view_counts(points, frames, centers, depth, gripper, cfg, chunk):
    """Per grasp: (close-plane points >= threshold, no back collision, no
    finger collision, close-region points >= threshold)."""
    out = []
    for g in range(0, frames.shape[0], chunk):
        s = slice(g, g + chunk)
        masks = _region_masks(_local_coords(points, frames[s], centers[s]),
                              depth[s, None], gripper, cfg)
        cp, bk, fg, cr = (m.sum(-1) for m in masks)
        out.append(torch.stack([
            cp >= cfg.num_points_threshold,
            bk <= cfg.back_collision_threshold,
            fg <= cfg.finger_collision_threshold,
            cr >= cfg.close_region_min_points], -1))
    return torch.cat(out).unbind(-1)


def check_grasps_view(points: torch.Tensor, grasps: torch.Tensor,
                      table_height: float, depth, gripper: GripperConfig,
                      cfg: EvalConfig, require_close_region: bool,
                      table_sign: float = -1.0,
                      chunk: int = 256) -> torch.Tensor:
    """View-cloud collision filter (JAX ``collision.py:58``).

    points [N, 3], grasps [G, 8] (center, axis_y, theta, score), depth a
    scalar or [G].  `require_close_region`: at least 16 points in the
    closing region (the validate path).  The fingertip test is
    ``tip_z >= table_height + table_sign * table_offset``.  Returns [G]
    bool."""
    frames, centers, depth, above = _prepare(grasps, depth, table_height,
                                             table_sign, cfg)
    cp, bk, fg, cr = _view_counts(points.float(), frames, centers, depth,
                                  gripper, cfg, chunk)
    ok = cp & bk & fg
    if require_close_region:
        ok = ok & cr
    return ok & above


def view_check_funnel(points: torch.Tensor, grasps: torch.Tensor,
                      table_height: float, depth, gripper: GripperConfig,
                      cfg: EvalConfig, table_sign: float = +1.0,
                      chunk: int = 256) -> dict:
    """Which check of the view filter rejected each grasp (JAX
    ``collision.py:116``): [G] bool masks above_table, close_points,
    back_ok, finger_ok, close_region_ok, and survive (the test path's
    conjunction, without close_region_ok)."""
    frames, centers, depth, above = _prepare(grasps, depth, table_height,
                                             table_sign, cfg)
    cp, bk, fg, cr = _view_counts(points.float(), frames, centers, depth,
                                  gripper, cfg, chunk)
    return {"above_table": above, "close_points": cp, "back_ok": bk,
            "finger_ok": fg, "close_region_ok": cr,
            "survive": above & cp & bk & fg}


def check_grasps_scene(points: torch.Tensor, normals: torch.Tensor,
                       grasps: torch.Tensor, depth, gripper: GripperConfig,
                       cfg: EvalConfig, chunk: int = 64):
    """Dense-scene collision check and antipodal score (JAX
    ``collision.py:171``): points and normals [N, 3], grasps [G, 8] ->
    (collision_free [G] bool, antipodal [G] f32, 0 where not free)."""
    frames, centers, depth, _ = _prepare(grasps, depth, None, 0.0, cfg)
    points, normals = points.float(), normals.float()
    n = [normals[None, :, j] for j in range(3)]
    big = 1e9
    oks, scores = [], []
    for g in range(0, frames.shape[0], chunk):
        s = slice(g, g + chunk)
        local = _local_coords(points, frames[s], centers[s])
        close_plane, back, finger, close_region = _region_masks(
            local, depth[s, None], gripper, cfg)
        ok = ((close_plane.sum(-1) >= cfg.num_points_threshold)
              & (back.sum(-1) <= cfg.back_collision_threshold)
              & (finger.sum(-1) <= cfg.finger_collision_threshold)
              & (close_region.sum(-1) >= cfg.close_region_min_points))
        # the antipodal score over the closing region (reference
        # evaluation_data_generator.py:397-418)
        y = local[1]
        left_y = torch.where(close_region, y, -big).amax(-1)
        right_y = torch.where(close_region, y, big).amin(-1)
        nsd = torch.clamp((left_y - right_y) / 3.0, max=cfg.neighbor_depth)
        left_band = close_region & (y > (left_y - nsd)[:, None])
        right_band = close_region & (y < (right_y + nsd)[:, None])
        ny = torch.abs(_rotate(frames[s], n)[1])

        def band_mean(band):
            cnt = band.sum(-1)
            total = torch.where(band, ny.double(), 0.0).sum(-1).float()
            return torch.where(cnt > 0, total / torch.clamp(cnt, min=1), 0.0)

        score = band_mean(left_band) * band_mean(right_band)
        oks.append(ok)
        scores.append(torch.where(ok, score, 0.0))
    return torch.cat(oks), torch.cat(scores)
