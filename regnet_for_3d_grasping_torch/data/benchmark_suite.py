"""The frozen benchmark scene suite (the port's copy of the JAX package's
``data/benchmark_suite.py``).

12 scenes x 2 regimes (sparse, clutter), generated deterministically from
versioned seeds by the port's ``data/synthetic.py``, with SHA-256
fingerprints committed in ``docs/evidence/benchmark_suite_v{N}.json``.  A
metrics file made on fingerprint-verified scenes compares with every other
one made on the same suite version: if the generator's code ever changes a
scene, `verify_scene` fails instead of silently moving the benchmark
(``cli/benchmark_eval.py --verify-only``).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List

import numpy as np

from regnet_for_3d_grasping_torch.data.synthetic import make_synthetic_scene

# v1: iid-uniform per-point colors (rounds 1-3).  v2 (round 4): coherent
# per-object colors — the realistic distribution the retrained models are
# gated on (data/synthetic.py color_mode docstring).  Both stay
# verifiable; metrics files name the suite version they were run on.
SUITE_VERSION = 2
NUM_VIEW = 25600

# Seeds live far outside every training range used so far (training
# datasets use 0..N with N <= a few hundred; holdout_eval used 7000+).
_SPARSE_SEEDS = list(range(9000, 9012))    # 2-3 objects: round-1 regime
_CLUTTER_SEEDS = list(range(9100, 9112))   # generator default 4-8 objects

_COLOR_MODE = {1: "iid", 2: "coherent"}


def _fingerprint_file(version: int) -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "docs", "evidence", f"benchmark_suite_v{version}.json")


def suite_specs(version: int = SUITE_VERSION) -> List[dict]:
    """The canonical scene list: name, generator seed and parameters."""
    cm = _COLOR_MODE[version]
    specs = []
    for i, seed in enumerate(_SPARSE_SEEDS):
        specs.append({"name": f"sparse_{i:02d}", "regime": "sparse",
                      "seed": seed, "num_objects": 2 + i % 2,
                      "view_index": i % 4, "num_view": NUM_VIEW,
                      "color_mode": cm})
    for i, seed in enumerate(_CLUTTER_SEEDS):
        specs.append({"name": f"clutter_{i:02d}", "regime": "clutter",
                      "seed": seed, "num_objects": None,
                      "view_index": i % 4, "num_view": NUM_VIEW,
                      "color_mode": cm})
    return specs


def generate_scene(spec: dict) -> dict:
    return make_synthetic_scene(
        spec["seed"], num_view=spec["num_view"],
        num_objects=spec["num_objects"], view_index=spec["view_index"],
        color_mode=spec.get("color_mode", "iid"))


def scene_fingerprint(scene: dict) -> str:
    """SHA-256 over the float32 bytes of the arrays the evaluator and the
    model consume — any generator drift that could move a metric changes
    this digest."""
    h = hashlib.sha256()
    for key in ("view_cloud", "view_cloud_color", "view_cloud_score",
                "scene_cloud", "scene_normal", "select_frame",
                "select_antipodal_score"):
        arr = np.ascontiguousarray(np.asarray(scene[key], np.float32))
        h.update(key.encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def load_fingerprints(version: int = SUITE_VERSION) -> dict:
    with open(_fingerprint_file(version)) as f:
        return json.load(f)


def write_fingerprints(version: int = SUITE_VERSION) -> dict:
    """Regenerate every suite scene and (re)write the committed digest
    file.  Only meant to be run when SUITE_VERSION is bumped."""
    out = {"suite_version": version, "num_view": NUM_VIEW,
           "scenes": {}}
    for spec in suite_specs(version):
        out["scenes"][spec["name"]] = {
            **{k: spec[k] for k in ("regime", "seed", "num_objects",
                                    "view_index", "color_mode")},
            "sha256": scene_fingerprint(generate_scene(spec)),
        }
    with open(_fingerprint_file(version), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    return out


def verify_scene(spec: dict, scene: dict, fingerprints: dict) -> None:
    """Raise if `scene` does not match the committed digest."""
    want = fingerprints["scenes"][spec["name"]]["sha256"]
    got = scene_fingerprint(scene)
    if got != want:
        raise RuntimeError(
            f"benchmark scene {spec['name']} drifted: generator output "
            f"{got[:16]}.. != committed {want[:16]}.. — the synthetic "
            f"generator changed; bump SUITE_VERSION and regenerate "
            f"fingerprints instead of silently moving the benchmark")
