"""Grasp visualization without a display server (JAX ``vis/vis_grasp.py``,
the reference's ``vis/vis_grasp.py`` and ``visualization_utils.py``).

A prediction pickle (the infer CLI's) is decoded and each grasp drawn as
the gripper's three boxes (back hand and two fingers) in a coloured ASCII
PLY: the cloud's points and the boxes' edges, viewable in MeshLab,
CloudCompare or Blender.  The highest-scoring grasp is red, the rest
green.

Usage: python -m regnet_for_3d_grasping_torch.vis.vis_grasp PICKLE [STAGE]
"""

from __future__ import annotations

import pickle
from typing import List, Optional, Tuple

import numpy as np
import torch

from regnet_for_3d_grasping_torch.config import GripperConfig

_BOX_EDGES = np.array([
    [0, 1], [0, 2], [1, 3], [2, 3],
    [4, 5], [4, 6], [5, 7], [6, 7],
    [0, 4], [1, 5], [2, 6], [3, 7]])


def _box_corners(center, size) -> np.ndarray:
    cx, cy, cz = center
    sx, sy, sz = size
    return np.array([[cx + dx * sx, cy + dy * sy, cz + dz * sz]
                     for dx in (-0.5, 0.5) for dy in (-0.5, 0.5)
                     for dz in (-0.5, 0.5)])


def gripper_hand_boxes(frame: np.ndarray, center: np.ndarray,
                       gripper: GripperConfig
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The gripper as 3 wireframe boxes in world coordinates, [(corners
    [8, 3], edges [12, 2])]: a back hand behind x = 0 and two fingers over
    the closing depth (the reference's ``get_hand_geometry``)."""
    w, h, d = gripper.width, gripper.height, gripper.depth
    fw = gripper.finger_width
    boxes_local = [
        (np.array([-fw / 2, 0, 0]), np.array([fw, w + 2 * fw, h])),
        (np.array([d / 2, (w + fw) / 2, 0]), np.array([d, fw, h])),
        (np.array([d / 2, -(w + fw) / 2, 0]), np.array([d, fw, h])),
    ]
    return [(_box_corners(c, size) @ frame.T + center, _BOX_EDGES)
            for c, size in boxes_local]


def write_ply(path: str, points: np.ndarray, colors: np.ndarray,
              boxes: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]
              ) -> None:
    """ASCII PLY of the points (colours in [0, 1]) and the boxes' vertices
    and edges; boxes: [(corners [8, 3], edges [12, 2], rgb [3] in
    0..255)]."""
    box_verts, box_edges, box_colors = [], [], []
    off = len(points)
    for corners, edges, rgb in boxes:
        box_edges.append(edges + off)
        box_verts.append(corners)
        box_colors.append(np.tile(rgb, (len(corners), 1)))
        off += len(corners)
    all_pts = np.concatenate([points] + box_verts) if boxes else points
    pt_colors = np.clip(colors * 255, 0, 255).astype(np.uint8)
    all_colors = np.concatenate(
        [pt_colors] + box_colors).astype(np.uint8) if boxes else pt_colors
    edges = np.concatenate(box_edges) if boxes else np.zeros((0, 2), int)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(all_pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\nend_header\n")
        for p, c in zip(all_pts, all_colors):
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} "
                    f"{c[0]} {c[1]} {c[2]}\n")
        for e in edges:
            f.write(f"{e[0]} {e[1]}\n")


def show_grasp(path: str, stage: str = "grasp_stage2",
               score_thre: Optional[float] = None,
               out_path: Optional[str] = None,
               gripper: Optional[GripperConfig] = None) -> str:
    """Draw one prediction pickle's `stage` grasps (those scoring above
    `score_thre`, where given) into a PLY beside it; returns its path."""
    from regnet_for_3d_grasping_torch.geometry.codec import grasps_to_frames
    gripper = gripper or GripperConfig()
    with open(path, "rb") as f:
        data = pickle.load(f)
    points = np.asarray(data["points"], np.float32)
    colors = np.asarray(data.get("colors", np.ones_like(points) * 0.6),
                        np.float32)
    grasps = np.asarray(data[stage], np.float32)
    if score_thre is not None and len(grasps):
        grasps = grasps[grasps[:, 7] > score_thre]
    boxes = []
    if len(grasps):
        frames, centers = grasps_to_frames(torch.from_numpy(grasps[:, :8]))
        frames, centers = frames.numpy(), centers.numpy()
        best = int(np.argmax(grasps[:, 7]))
        for i in range(len(grasps)):
            rgb = np.array([255, 0, 0]) if i == best \
                else np.array([0, 180, 0])
            for corners, edges in gripper_hand_boxes(frames[i], centers[i],
                                                     gripper):
                boxes.append((corners, edges, rgb))
    out_path = out_path or path.replace(".p", f"_{stage}.ply")
    write_ply(out_path, points, colors, boxes)
    return out_path


if __name__ == "__main__":
    import sys
    print(show_grasp(sys.argv[1],
                     sys.argv[2] if len(sys.argv) > 2 else "grasp_stage2"))
