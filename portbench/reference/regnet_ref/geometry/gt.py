"""Ground-truth grasp assignment for proposal centers (JAX
``geometry/gt.py``): each center takes its nearest ground-truth grasp."""

from __future__ import annotations

import math

import torch

from portbench.reference.regnet_ref.geometry.codec import frames_to_grasps
from portbench.reference.regnet_ref.ops.distances import bpdist2


def match_centers_to_gt(centers: torch.Tensor, gt_frames: torch.Tensor,
                        gt_scores: torch.Tensor, gt_valid: torch.Tensor,
                        match_dist2: float = 0.005):
    """centers [B, NC, 3], gt_frames [B, MG, 3, 4] (columns x, y, z,
    translation), gt_scores [B, MG, 3], gt_valid [B, MG] bool ->
    (grasp_gt [B, NC, 10] = (center, axis_y, theta, score, antipodal,
    center score), -1 in every channel of an unmatched center; matched
    [B, NC] bool).  `match_dist2` bounds the SQUARED distance."""
    d2 = bpdist2(centers, gt_frames[..., :3, 3])          # [B, NC, MG]
    d2 = torch.where(gt_valid[:, None, :], d2,
                     torch.full_like(d2, math.inf))
    best = torch.argmin(d2, dim=-1)
    best_d2 = torch.gather(d2, -1, best[..., None])[..., 0]
    matched = best_d2 <= match_dist2
    sel_frames = torch.gather(
        gt_frames, 1, best[..., None, None].expand(-1, -1, 3, 4))
    sel_scores = torch.gather(gt_scores, 1, best[..., None].expand(-1, -1, 3))
    grasp_gt = frames_to_grasps(sel_frames[..., :3], sel_frames[..., 3],
                                sel_scores)
    return torch.where(matched[..., None], grasp_gt,
                       torch.full_like(grasp_gt, -1.0)), matched
