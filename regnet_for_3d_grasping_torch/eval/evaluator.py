"""The evaluator's facade: VGR and antipodal-score records (JAX
``eval/evaluator.py``).  Numpy in, numpy out; the computation runs on
`device`, the card unless the caller asks for another.

Metrics (reference ``utils.py:374-388``):
  VGR        = nocoll_scene_num / nocoll_view_num
  vgr_before = nocoll_scene_num / formal_num
  score      = sum(antipodal) / nocoll_view_num
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from regnet_for_3d_grasping_torch.config import EvalConfig, GripperConfig
from regnet_for_3d_grasping_torch.eval.collision import (check_grasps_scene,
                                                         check_grasps_view)
from regnet_for_3d_grasping_torch.eval.normals import estimate_normals
from regnet_for_3d_grasping_torch.runtime import resolve_device

# camera positions per view index (evaluation_data_generator.py:34-39)
CAMERA_POSE = np.array([
    [0.8, 0.0, 1.7],
    [-0.8, 0.0, 1.6],
    [0.0, 0.75, 1.7],
    [0.0, -0.75, 1.6],
], np.float32)
DEFAULT_CAMERA = np.array([0.0, 0.0, 1.658], np.float32)  # test.py:103


class EvalRecord(NamedTuple):
    """The reference's record_data 4-tuple (nocoll_scene_num, total_score,
    nocoll_view_num, formal_num)."""

    vgr_count: float = 0.0
    score_sum: float = 0.0
    nocoll_view: float = 0.0
    formal: float = 0.0

    def add(self, other: "EvalRecord") -> "EvalRecord":
        return EvalRecord(*(a + b for a, b in zip(self, other)))

    @property
    def vgr(self) -> float:
        return self.vgr_count / max(self.nocoll_view, 1.0)

    @property
    def vgr_before(self) -> float:
        return self.vgr_count / max(self.formal, 1.0)

    @property
    def score(self) -> float:
        return self.score_sum / max(self.nocoll_view, 1.0)


def _camera_for_view(view_num: Optional[int]) -> np.ndarray:
    return DEFAULT_CAMERA if view_num is None else CAMERA_POSE[view_num]


def _with_width(gripper: Optional[GripperConfig],
                width: float) -> GripperConfig:
    base = gripper or GripperConfig()
    if width is not None and width != base.width:
        base = dataclasses.replace(base, width=float(width))
    return base


def _t(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _depth(depth, dev):
    return depth if np.ndim(depth) == 0 else _t(depth, dev)


def eval_test(points: np.ndarray, grasps: np.ndarray,
              view_num: Optional[int], table_height: float, depth,
              width: float, gripper: Optional[GripperConfig] = None,
              cfg: Optional[EvalConfig] = None,
              device: str | torch.device | None = None) -> np.ndarray:
    """The no-ground-truth path: the grasps that survive the view filter
    (JAX ``evaluator.py:70``)."""
    gripper = _with_width(gripper, width)
    cfg = cfg or EvalConfig()
    if len(grasps) == 0:
        return grasps
    dev = resolve_device(device)
    ok = check_grasps_view(
        _t(np.asarray(points)[:, :3], dev), _t(np.asarray(grasps)[:, :8], dev),
        table_height, _depth(depth, dev), gripper, cfg,
        require_close_region=False, table_sign=+1.0)
    return np.asarray(grasps)[ok.cpu().numpy()]


def eval_validate(data: dict, grasps: np.ndarray, view_num: int,
                  table_height: float, depth, width: float,
                  gripper: Optional[GripperConfig] = None,
                  cfg: Optional[EvalConfig] = None,
                  device: str | torch.device | None = None):
    """The ground-truth path (JAX ``evaluator.py:88``): (vgr_count,
    score_sum, nocoll_view_num, view_ok, scene_ok, antipodal per grasp,
    zero where scene_ok is False).  Scene normals are the scene's
    ``scene_normal`` where it has them, else moment normals toward the
    view's camera."""
    gripper = _with_width(gripper, width)
    cfg = cfg or EvalConfig()
    grasps = np.asarray(grasps, np.float32)
    if len(grasps) == 0:
        return (0.0, 0.0, 0, np.zeros(0, bool), np.zeros(0, bool),
                np.zeros(0, np.float32))
    dev = resolve_device(device)
    g = _t(grasps[:, :8], dev)
    depth = _depth(depth, dev)
    view_ok = check_grasps_view(
        _t(np.asarray(data["view_cloud"])[:, :3], dev), g, table_height,
        depth, gripper, cfg, require_close_region=True, table_sign=-1.0)
    scene_pts = _t(np.asarray(data["scene_cloud"])[:, :3], dev)
    if "scene_normal" in data:
        scene_n = _t(data["scene_normal"], dev)
    else:
        scene_n = estimate_normals(scene_pts,
                                   _t(_camera_for_view(view_num), dev),
                                   cfg.normal_radius, cfg.normal_max_nn,
                                   method="moment")
    scene_ok, antipodal = check_grasps_scene(scene_pts, scene_n, g, depth,
                                             gripper, cfg)
    view_ok = view_ok.cpu().numpy()
    scene_ok = scene_ok.cpu().numpy() & view_ok
    antipodal = antipodal.cpu().numpy() * scene_ok
    return (float(scene_ok.sum()), float(antipodal.sum()),
            int(view_ok.sum()), view_ok, scene_ok, antipodal)


def evaluate_scene_grasps(data: dict, grasps: np.ndarray, view_num: int,
                          table_height: float, depth, width: float,
                          gripper: Optional[GripperConfig] = None,
                          cfg: Optional[EvalConfig] = None,
                          pad_to: int = 256,
                          device: str | torch.device | None = None
                          ) -> EvalRecord:
    """One scene's EvalRecord (JAX ``evaluator.py:140``).  The grasps are
    padded to a multiple of `pad_to` with sentinels below the table (the
    fingertip check rejects them), as JAX pads them; `formal` is the true
    count."""
    grasps = np.asarray(grasps, np.float32)
    G = len(grasps)
    if pad_to and G:
        pad = (-G) % pad_to
        if pad:
            sentinel = np.zeros((pad, grasps.shape[1]), np.float32)
            sentinel[:, 2] = -10.0     # far below the table
            sentinel[:, 3] = 1.0       # unit axis_y
            grasps = np.concatenate([grasps, sentinel])
            if np.ndim(depth) == 1:
                depth = np.concatenate(
                    [np.asarray(depth, np.float32), np.ones(pad, np.float32)])
    vgr_count, score_sum, nocoll_view, _, _, _ = eval_validate(
        data, grasps, view_num, table_height, depth, width, gripper, cfg,
        device)
    return EvalRecord(vgr_count, score_sum, float(nocoll_view), float(G))


def evaluate_at_thresholds(data: dict, grasps: np.ndarray, thresholds,
                           view_num: int, table_height: float, depth,
                           width: float,
                           gripper: Optional[GripperConfig] = None,
                           cfg: Optional[EvalConfig] = None,
                           device: str | torch.device | None = None) -> dict:
    """{threshold: EvalRecord} over the grasps whose predicted score (column
    7) exceeds each threshold, from one collision pass (JAX
    ``evaluator.py:170``)."""
    grasps = np.asarray(grasps, np.float32)
    if len(grasps) == 0:
        return {t: EvalRecord() for t in thresholds}
    _, _, _, view_ok, scene_ok, antipodal = eval_validate(
        data, grasps, view_num, table_height, depth, width, gripper, cfg,
        device)
    out = {}
    pscore = grasps[:, 7]
    for t in thresholds:
        sel = pscore > t
        out[t] = EvalRecord(float((scene_ok & sel).sum()),
                            float(antipodal[sel].sum()),
                            float((view_ok & sel).sum()), float(sel.sum()))
    return out


def view_num_from_path(path: str) -> int:
    """The camera view index of a ``{scene}_view_{v}[_noise].p`` file name
    (reference ``utils.py:288-291``)."""
    parts = path.split("/")[-1].split(".")[0].split("_")
    return int(parts[-2]) if parts[-1] == "noise" else int(parts[-1])
