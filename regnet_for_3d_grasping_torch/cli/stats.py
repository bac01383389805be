"""Dataset statistics (JAX ``cli/stats.py``, the reference's
``count.py``): the number of labelled scenes, the mean number of GT grasps
a scene and the mean antipodal score, over the ``*.p`` scenes under a
directory.

Usage: python -m regnet_for_3d_grasping_torch.cli.stats --data-path DIR
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from regnet_for_3d_grasping_torch.data.dataset import load_scene


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="dataset grasp statistics")
    p.add_argument("--data-path", type=str, required=True)
    args = p.parse_args(argv)

    paths = sorted(glob.glob(os.path.join(args.data_path, "**", "*.p"),
                             recursive=True))
    counts, scores = [], []
    for path in paths:
        try:
            data = load_scene(path)
        except Exception:
            continue
        if "select_frame" in data:
            counts.append(len(data["select_frame"]))
            scores.append(np.mean(data["select_antipodal_score"]))
        elif "frame" in data:
            counts.append(len(data["frame"]))
            scores.append(np.mean(data["antipodal_score"]))
    if not counts:
        raise SystemExit(f"no labelled scenes under {args.data_path}")
    print(f"scenes: {len(counts)}")
    print(f"mean grasps/scene: {np.mean(counts):.2f}")
    print(f"mean antipodal score: {np.mean(scores):.4f}")


if __name__ == "__main__":
    main()
