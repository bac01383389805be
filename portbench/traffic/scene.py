"""Frozen copy of the port's ``utils/scene.py``: the synthetic tabletop
clouds that the serving cells send."""

from __future__ import annotations

import numpy as np


def tabletop_cloud(rng: np.random.RandomState, n: int = 32000):
    """A table plane at z = 0.75 (+-0.35 m) with boxes, cylinders and
    spheres on it: xyz [n, 3] and rgb [n, 3] in [0, 1]."""
    pts, cols = [], []
    n_table = n // 2
    pts.append(np.c_[rng.uniform(-0.35, 0.35, (n_table, 2)),
                     np.full(n_table, 0.75)])
    cols.append(0.5 + 0.05 * rng.randn(n_table, 3))
    n_obj = rng.randint(6, 10)
    per = (n - n_table) // n_obj
    for i in range(n_obj):
        c = np.r_[rng.uniform(-0.25, 0.25, 2), 0.75]
        size = rng.uniform(0.02, 0.06, 3)
        kind = i % 3
        if kind == 0:       # box surface
            p = rng.uniform(-1, 1, (per, 3))
            ax = rng.randint(0, 3, per)
            p[np.arange(per), ax] = np.sign(p[np.arange(per), ax])
            p = p * size + c + np.r_[0, 0, size[2]]
        elif kind == 1:     # cylinder side
            a = rng.uniform(0, 2 * np.pi, per)
            h = rng.uniform(0, 2 * size[2], per)
            p = np.c_[size[0] * np.cos(a), size[0] * np.sin(a), h] + c
        else:               # sphere
            v = rng.randn(per, 3)
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            p = v * size[0] + c + np.r_[0, 0, size[0]]
        pts.append(p)
        cols.append(np.clip(rng.rand(3) + 0.05 * rng.randn(per, 3), 0, 1))
    xyz = np.concatenate(pts)[:n]
    rgb = np.clip(np.concatenate(cols)[:n], 0, 1)
    return xyz, rgb
