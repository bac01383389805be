"""Host data pipeline: scene pickles -> fixed-shape device batches.

Re-design of the reference ``dataset_utils/scoredataset.py`` with the key
structural fix from SURVEY §7.6: the per-scene ground-truth grasp arrays are
loaded ONCE here and shipped to the device as padded tensors, instead of
being re-np.load-ed from disk inside every training step
(get_regiondataset.py:66).  The center->GT matching then runs on-device
(geometry/gt.py).

Matches reference semantics:
  * seeded 80/20 train/val split over the sorted file list
    (scoredataset.py:25-50);
  * resample every cloud to exactly `num_points` with/without replacement
    (scoredataset.py:68-75);
  * per-class color jitter: table channels scaled by U(0,1), object channels
    by 1-U(0,1)/5 (scoredataset.py:52-58);
  * scores tanh-squashed (scoredataset.py:80).
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np

from regnet_for_3d_grasping_torch.utils import trace


class SceneBatch(NamedTuple):
    """One host-side batch, everything fixed-shape."""

    pc: np.ndarray          # [B, N, 6] xyz + jittered rgb
    score: np.ndarray       # [B, N] tanh(raw score)
    label: np.ndarray       # [B, N] object id (0 = table)
    gt_frames: np.ndarray   # [B, MG, 3, 4]
    gt_scores: np.ndarray   # [B, MG, 3] (score, antipodal, center)
    gt_valid: np.ndarray    # [B, MG] bool
    paths: list             # data paths (for the evaluator)
    width: np.ndarray       # [B] gripper width per sample


def load_scene(path: str) -> dict:
    """The scene pickle at `path`; its bytes add to the counter
    ``read_bytes``."""
    with open(path, "rb") as f:
        data = pickle.load(f)
        trace.count("read_bytes", f.tell())
    return data


def width_from_path(path: str, default: float = 0.08) -> float:
    """Parse the per-dataset gripper width from the data path.

    The reference stores datasets under a directory named after the
    gripper width and re-parses it at eval time:
    ``width = float(cur_data_path.split('/')[-3])`` guarded by a ``'0' in
    parts[-3]`` check (utils.py:286-287), e.g.
    ``.../0.080/training_data/4080_view_1.p`` -> 0.08.  Here the guard is
    an actual float parse instead of the substring test.
    """
    parts = os.path.abspath(path).split(os.sep)
    if len(parts) >= 3:
        try:
            w = float(parts[-3])
            if 0.0 < w < 1.0:    # metres; rejects year-like directories
                return w
        except ValueError:
            pass
    return default


def pad_gt_grasps(data: dict, max_grasps: int):
    """Extract + pad the GT grasp arrays from a scene dict.

    Supports both reference label schemas (get_regiondataset.py:67-86):
    old ``frame``/``antipodal_score`` and new ``select_frame``/+scores.
    """
    if "frame" in data:
        frames = np.asarray(data["frame"], np.float32)
        a = np.asarray(data["antipodal_score"], np.float32)
        scores = np.stack([a, a, a], axis=-1)
    else:
        frames = np.asarray(data["select_frame"], np.float32)
        a = np.asarray(data["select_antipodal_score"], np.float32)
        c = np.asarray(data["select_center_score"], np.float32)
        # label channel order (score, antipodal, center) — grn labels 7:10
        scores = np.stack([a, a, c], axis=-1)

    g = min(len(frames), max_grasps)
    out_frames = np.zeros((max_grasps, 3, 4), np.float32)
    out_scores = np.zeros((max_grasps, 3), np.float32)
    valid = np.zeros(max_grasps, bool)
    out_frames[:g] = frames[:g, :3, :4]
    out_scores[:g] = scores[:g]
    valid[:g] = True
    return out_frames, out_scores, valid


class GraspDataset:
    """File-list dataset with the reference's split semantics."""

    def __init__(self, base_path: str, tag: str = "train",
                 num_points: int = 25600, max_gt_grasps: int = 512,
                 seed: int = 1, width: float | None = None):
        """`width=None` parses the gripper width from the dataset
        directory name like the reference (utils.py:286-287), falling
        back to the 0.08 default."""
        self.num_points = num_points
        self.max_gt_grasps = max_gt_grasps
        self.tag = tag

        sub = "training_data_test" if tag == "test" else "training_data"
        root = os.path.join(base_path, sub)
        if not os.path.isdir(root):
            root = base_path
        names = sorted(os.listdir(root))
        names = np.array([n for n in names if n.endswith(".p")])

        if tag == "test":
            selected = names
        else:
            rng = np.random.RandomState(seed)
            idx = rng.choice(len(names), int(len(names) * 0.8),
                             replace=False)
            if tag != "train":
                idx = np.array(sorted(set(range(len(names))) - set(idx)),
                               dtype=int)
            selected = names[idx]
        self.paths = [os.path.join(root, n) for n in selected]
        if width is None:
            probe = self.paths[0] if self.paths else os.path.join(
                root, "probe.p")
            width = width_from_path(probe)
        self.width = np.float32(width)

    def __len__(self):
        return len(self.paths)

    def _noise_color(self, rng, color, label):
        table_t = rng.rand(3)
        obj_t = 1 - rng.rand(3) / 5
        color = color.copy()
        color[label == 0] *= table_t
        color[label != 0] *= obj_t
        return color

    def _global_color_aug(self, rng, color):
        """Scene-level photometric augmentation: per-channel gain, gamma
        and a brightness offset.  The reference's per-class jitter
        (_noise_color, scoredataset.py:52-58) only ever scales colors
        DOWN; a model trained without upward/global shifts collapses on
        the brighter real Kinect clouds (+0.23 global brightness alone
        zeroes the score spread — docs/evidence/real_data_r4.json).
        Applied after _noise_color; rounds >= 4."""
        gain = rng.uniform(0.7, 1.3, 3).astype(np.float32)
        gamma = np.float32(rng.uniform(0.7, 1.4))
        offset = np.float32(rng.uniform(-0.25, 0.3))
        color = np.clip(color * gain, 0.0, 1.0) ** gamma
        return np.clip(color + offset, 0.0, 1.0)

    def get(self, index: int, rng: np.random.RandomState,
            augment: bool = True):
        """One scene: read (the span ``data.read``), resampled and
        augmented."""
        with trace.span("data.read"):
            data = load_scene(self.paths[index])
        view = data["view_cloud"].astype(np.float32)
        color = data["view_cloud_color"].astype(np.float32)
        score = data["view_cloud_score"].astype(np.float32)
        label = data["view_cloud_label"].astype(np.float32)

        n = len(view)
        sel = rng.choice(n, self.num_points, replace=n < self.num_points)
        view, color = view[sel], color[sel]
        score, label = score[sel], label[sel]
        if augment:
            color = self._noise_color(rng, color, label)
            color = self._global_color_aug(rng, color)

        frames, scores, valid = pad_gt_grasps(data, self.max_gt_grasps)
        return (np.c_[view, color], np.tanh(score), label,
                frames, scores, valid, self.paths[index])

    def batches(self, batch_size: int, seed: int = 0, shuffle: bool = True,
                augment: bool = True, drop_last: bool = True):
        """Yield SceneBatch objects for one epoch.  Each batch is made in
        the span ``data.prep`` (its scenes' reads the child spans
        ``data.read``), closed before it is yielded."""
        rng = np.random.RandomState(seed)
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        stop = len(order) - batch_size + 1 if drop_last else len(order)
        for start in range(0, max(stop, 0), batch_size):
            chunk = order[start:start + batch_size]
            with trace.span("data.prep"):
                items = [self.get(i, rng, augment) for i in chunk]
                batch = SceneBatch(
                    pc=np.stack([it[0] for it in items]),
                    score=np.stack([it[1] for it in items]),
                    label=np.stack([it[2] for it in items]),
                    gt_frames=np.stack([it[3] for it in items]),
                    gt_scores=np.stack([it[4] for it in items]),
                    gt_valid=np.stack([it[5] for it in items]),
                    paths=[it[6] for it in items],
                    width=np.full(len(items), self.width, np.float32),
                )
            yield batch
