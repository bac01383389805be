"""Masked model outputs to the reference's compact grasp sets (JAX
``utils/export.py:18-58``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from regnet_for_3d_grasping_torch.models.regnet import REGNetOutput


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def extract_grasp_sets(out: REGNetOutput) -> List[Dict[str, np.ndarray]]:
    """Per batch element, the first 8 channels of:

      grasp_stage2          all stage-2 proposals with a non-empty region
      grasp_stage3          refined grasps the refine classifier accepts
      grasp_stage3_stage2   the stage-2 poses of those
      grasp_stage3_score    accepted grasps above the score threshold
    """
    proposals = _np(out.proposals)[..., :8]
    final = _np(out.final_grasps)[..., :8]
    m2 = _np(out.region_valid)
    m3 = m2 & _np(out.refine_accept)
    m3s = m2 & _np(out.score_accept)
    return [{"grasp_stage2": proposals[b][m2[b]],
             "grasp_stage3": final[b][m3[b]],
             "grasp_stage3_stage2": proposals[b][m3[b]],
             "grasp_stage3_score": final[b][m3s[b]]}
            for b in range(proposals.shape[0])]
