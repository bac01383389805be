"""Minimal PCD point-cloud reader for real-sensor inputs (the port's copy
of the JAX package's numpy-only ``utils/pcd.py``).

Reads ASCII and binary .pcd files with x/y/z[/rgb] fields without open3d,
and applies the reference's fixed Kinect extrinsic, euler(-0.87pi, 0, 0).
"""

from __future__ import annotations

import math

import numpy as np


def read_pcd(path: str):
    """Returns (points [N,3] float64, colors [N,3] float64 in [0,1])."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if line.startswith("#") or not line:
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        types = header["TYPE"].split()
        counts = list(map(int, header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()))
        n = int(header["POINTS"])
        fmt = header["DATA"]

        np_types = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1",
                    ("U", 4): "u4", ("I", 4): "i4", ("U", 2): "u2",
                    ("I", 2): "i2", ("I", 1): "i1"}
        dtype = np.dtype([
            (name, np_types[(t, s)]) if c == 1
            else (name, np_types[(t, s)], (c,))
            for name, s, t, c in zip(fields, sizes, types, counts)])

        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
            arr = np.zeros(n, dtype)
            col = 0
            for name, c in zip(fields, counts):
                arr[name] = data[:, col] if c == 1 else data[:, col:col + c]
                col += c
        elif fmt == "binary":
            arr = np.frombuffer(f.read(n * dtype.itemsize), dtype, n)
        else:
            raise ValueError(f"unsupported PCD DATA format: {fmt}")

    pts = np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(
        np.float64)
    if "rgb" in fields:
        rgb = arr["rgb"]
        if rgb.dtype.kind == "f":
            rgb = rgb.astype(np.float32).view(np.uint32)
        r = (rgb >> 16) & 0xFF
        g = (rgb >> 8) & 0xFF
        b = rgb & 0xFF
        colors = np.stack([r, g, b], axis=1).astype(np.float64) / 255.0
    else:
        colors = np.ones_like(pts) * 0.5
    return pts, colors


def camera_to_global_transform(
        point=np.array([0.0, 0.0, 1.658])) -> np.ndarray:
    """The reference Kinect extrinsic: euler2quat(-0.87pi, 0, 0) rotation
    plus camera translation (utils.py:433-440), without transforms3d."""
    a = -0.87 * math.pi
    ca, sa = math.cos(a), math.sin(a)
    T = np.eye(4)
    T[:3, :3] = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    T[:3, 3] = point
    return T


def transform_points(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]
