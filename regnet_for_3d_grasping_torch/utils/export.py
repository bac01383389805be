"""Masked model outputs to the reference's compact grasp sets, and a
diverse short list of them (JAX ``utils/export.py``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from regnet_for_3d_grasping_torch.models.regnet import REGNetOutput
from regnet_for_3d_grasping_torch.utils import trace


def _np(t, where: str) -> np.ndarray:
    return trace.to_host(t.detach(), where).numpy()


def extract_grasp_sets(out: REGNetOutput,
                       stage2_mask: np.ndarray | torch.Tensor | None = None
                       ) -> List[Dict[str, np.ndarray]]:
    """Per batch element, the first 8 channels of:

      grasp_stage2          the stage-2 proposals in `stage2_mask` (all
                            with a non-empty region by default, the
                            reference's inference behaviour, grn:65)
      grasp_stage3          refined grasps the refine classifier accepts
      grasp_stage3_stage2   the stage-2 poses of those
      grasp_stage3_score    accepted grasps above the score threshold

    `stage2_mask` [B, NC] (e.g. the GT-matched mask during validation) is
    taken within the valid regions.  The span ``extract``; each read of
    the card a counted wait."""
    with trace.span("extract"):
        return _grasp_sets(out, stage2_mask)


def _grasp_sets(out, stage2_mask):
    proposals = _np(out.proposals, "extract.proposals")[..., :8]
    final = _np(out.final_grasps, "extract.final_grasps")[..., :8]
    m2 = _np(out.region_valid, "extract.region_valid")
    if stage2_mask is not None:
        m2 = m2 & (_np(stage2_mask, "extract.stage2_mask")
                   if isinstance(stage2_mask, torch.Tensor)
                   else np.asarray(stage2_mask, bool))
    m3 = m2 & _np(out.refine_accept, "extract.refine_accept")
    m3s = m2 & _np(out.score_accept, "extract.score_accept")
    return [{"grasp_stage2": proposals[b][m2[b]],
             "grasp_stage3": final[b][m3[b]],
             "grasp_stage3_stage2": proposals[b][m3[b]],
             "grasp_stage3_score": final[b][m3s[b]]}
            for b in range(proposals.shape[0])]


def select_diverse_grasps(grasps: np.ndarray, k: int,
                          min_center_dist: float = 0.03) -> np.ndarray:
    """Score-ordered spatial NMS (JAX ``utils/export.py:61``): the `k` best
    grasps (column 7) whose centers lie at least `min_center_dist` apart,
    greedily, best first.  grasps [G, 8] -> [<= k, 8]."""
    if len(grasps) == 0 or k <= 0:
        return grasps[:0]
    g = np.asarray(grasps)
    order = np.argsort(-g[:, 7])
    kept: list[int] = []
    centers = g[order, :3]
    for i in range(len(order)):
        c = centers[i]
        if all(np.dot(c - centers[j], c - centers[j])
               >= min_center_dist * min_center_dist for j in kept):
            kept.append(i)
            if len(kept) == k:
                break
    return g[order[kept]]
