"""Many scenes' grasp sets in one call, spread over devices (JAX
``eval/parallel_eval.py``): the scenes are padded to common shapes and
their count to a multiple of the W devices, by repeating the last, as JAX
pads them for its mesh; device i evaluates scenes ``[i*S/W, (i+1)*S/W)``
one after another, each device from a host thread of its own.

Padding (each a no-op for the metrics, and kept exactly, since the padded
cloud is what the normals see):
  * grasps -> sentinels below the table, rejected by the fingertip check;
    `formal` counts the real ones;
  * clouds -> a point 1 m above the scene's bounding box, farther than any
    gripper dimension from every real grasp; where normals are estimated,
    these points shift the centroid the moment path centres on, as in JAX.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from regnet_for_3d_grasping_torch.config import EvalConfig, GripperConfig
from regnet_for_3d_grasping_torch.eval.collision import (check_grasps_scene,
                                                         check_grasps_view)
from regnet_for_3d_grasping_torch.eval.evaluator import (EvalRecord,
                                                         _camera_for_view,
                                                         _with_width)
from regnet_for_3d_grasping_torch.eval.normals import estimate_normals
from regnet_for_3d_grasping_torch.runtime import resolve_device


def _pad_cloud(pts: np.ndarray, n: int) -> np.ndarray:
    """Pad [N, 3] -> [n, 3] with a far-but-O(1 m) sentinel point."""
    if len(pts) >= n:
        return pts[:n]
    sentinel = pts.max(axis=0) + 1.0
    return np.concatenate(
        [pts, np.broadcast_to(sentinel, (n - len(pts), 3)).copy()])


def _pad_grasps(grasps: np.ndarray, depths: np.ndarray, g: int):
    """Pad to `g` rows with below-table sentinels (always rejected)."""
    G = len(grasps)
    if G >= g:
        return grasps[:g], depths[:g]
    sentinel = np.zeros((g - G, grasps.shape[1]), np.float32)
    sentinel[:, 2] = -10.0
    sentinel[:, 3] = 1.0
    return (np.concatenate([grasps, sentinel]),
            np.concatenate([depths, np.ones(g - G, np.float32)]))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def make_scene_eval_body(gripper: GripperConfig, cfg: EvalConfig,
                         with_normals: bool):
    """The per-scene body over stacked scene tensors -> per-scene
    (vgr_count, score_sum, nocoll_view) f64 [S] (JAX
    ``parallel_eval.py:78``); the table height is a per-scene input."""

    def body(view_pts, scene_pts, scene_n, camera, grasps, depths,
             table_heights):
        out = []
        for vp, sp, sn, cam, g, dp, th in zip(view_pts, scene_pts, scene_n,
                                              camera, grasps, depths,
                                              table_heights):
            view_ok = check_grasps_view(vp, g, th, dp, gripper, cfg,
                                        require_close_region=True,
                                        table_sign=-1.0)
            if not with_normals:
                sn = estimate_normals(sp, cam, cfg.normal_radius,
                                      cfg.normal_max_nn, method="moment")
            scene_ok, antip = check_grasps_scene(sp, sn, g, dp, gripper, cfg)
            scene_ok = scene_ok & view_ok
            out.append(torch.stack([scene_ok.double().sum(),
                                    (antip.double() * scene_ok).sum(),
                                    view_ok.double().sum()]))
        return torch.stack(out).unbind(-1)

    return body


def evaluate_scenes_sharded(
        devices: Sequence, scenes: Sequence[dict],
        grasps_list: Sequence[np.ndarray],
        view_nums: Sequence[int], table_height,
        depths_list: Sequence[np.ndarray], width: float,
        gripper: Optional[GripperConfig] = None,
        cfg: Optional[EvalConfig] = None,
        grasp_pad: int = 256) -> List[EvalRecord]:
    """One EvalRecord per scene (JAX ``parallel_eval.py:115``, with a list
    of torch `devices` where JAX takes a mesh): as `evaluate_scene_grasps`
    per scene, with one `width` for all and `table_height` a scalar or one
    per scene."""
    gripper = _with_width(gripper, width)
    cfg = cfg or EvalConfig()
    devs = [resolve_device(d) for d in devices]
    S = len(scenes)
    assert S == len(grasps_list) == len(view_nums) == len(depths_list)
    formals = [float(len(g)) for g in grasps_list]
    Nv = max(len(np.asarray(s["view_cloud"])) for s in scenes)
    Ns = max(len(np.asarray(s["scene_cloud"])) for s in scenes)
    G = _round_up(max(max(len(g) for g in grasps_list), 1), grasp_pad)
    with_normals = all("scene_normal" in s for s in scenes)

    vps, sps, sns, cams, gs, dps = [], [], [], [], [], []
    for s, g, vn, dp in zip(scenes, grasps_list, view_nums, depths_list):
        vps.append(_pad_cloud(
            np.asarray(s["view_cloud"], np.float32)[:, :3], Nv))
        sps.append(_pad_cloud(
            np.asarray(s["scene_cloud"], np.float32)[:, :3], Ns))
        if with_normals:
            sn = np.asarray(s["scene_normal"], np.float32)[:, :3]
            pad = np.zeros((Ns - len(sn), 3), np.float32)
            pad[:, 2] = 1.0                    # sentinel normal +z
            sns.append(np.concatenate([sn[:Ns], pad]))
        else:
            sns.append(np.zeros((Ns, 3), np.float32))
        cams.append(_camera_for_view(vn))
        g = np.asarray(g, np.float32)
        dp = np.broadcast_to(np.asarray(dp, np.float32), (len(g),))
        gp, dpp = _pad_grasps(g[:, :8], np.asarray(dp, np.float32), G)
        gs.append(gp)
        dps.append(dpp)
    ths = list(np.broadcast_to(np.asarray(table_height, np.float32), (S,)))
    Sp = _round_up(S, len(devs))
    for arr in (vps, sps, sns, cams, gs, dps, ths):
        arr.extend([arr[-1]] * (Sp - S))
    stack = [np.stack(a) for a in (vps, sps, sns, cams, gs, dps, ths)]
    body = make_scene_eval_body(gripper, cfg, with_normals)
    per = Sp // len(devs)

    def shard(i):
        dev = devs[i]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)      # this thread's card
        part = [torch.as_tensor(a[i * per:(i + 1) * per], device=dev)
                for a in stack]
        return [r.cpu().numpy() for r in body(*part)]

    with ThreadPoolExecutor(len(devs)) as pool:
        parts = list(pool.map(shard, range(len(devs))))
    vgr_count, score_sum, nocoll_view = (np.concatenate(r)
                                         for r in zip(*parts))
    return [EvalRecord(float(vgr_count[i]), float(score_sum[i]),
                       float(nocoll_view[i]), formals[i]) for i in range(S)]
