"""Point-cloud preprocessing masks (JAX ``eval/pointcloud_ops.py``): the
fixed-shape forms of open3d's ``remove_radius_outlier`` and
``voxel_down_sample``, on the device of `points`."""

from __future__ import annotations

import torch

from regnet_for_3d_grasping_torch.ops.distances import bpdist2


def radius_outlier_mask(points: torch.Tensor, nb_points: int = 16,
                        radius: float = 0.04,
                        chunk: int = 4096) -> torch.Tensor:
    """[N] bool: points with at least `nb_points` neighbours within
    `radius`, the point itself included (JAX ``pointcloud_ops.py:19``).
    `chunk` queries at a time; it changes no result."""
    points = points.float()
    r2 = torch.tensor(radius * radius, dtype=torch.float32,
                      device=points.device)
    counts = torch.cat([
        (bpdist2(points[None, q:q + chunk], points[None])[0] <= r2).sum(-1)
        for q in range(0, len(points), chunk)])
    return counts >= nb_points


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 that two's-complement wrapping leaves."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v)


def voxel_downsample_mask(points: torch.Tensor, voxel_size: float = 0.005,
                          table_size: int = 1 << 20) -> torch.Tensor:
    """[N] bool: the lowest-index point of each occupied voxel, voxels told
    apart by a hash of `table_size` slots (JAX ``pointcloud_ops.py:42``:
    int32 products that wrap, a floor-mod, a scatter-min)."""
    points = points.float()
    N = points.shape[0]
    v = torch.floor(points / voxel_size).to(torch.int32).long()
    h = (_wrap32(v[:, 0] * 73856093) ^ _wrap32(v[:, 1] * 19349663)
         ^ _wrap32(v[:, 2] * 83492791))
    h = (h % table_size + table_size) % table_size
    idx = torch.arange(N, device=points.device)
    table = torch.full((table_size,), N, dtype=torch.int64,
                       device=points.device)
    table.scatter_reduce_(0, h, idx, "amin")
    return table[h] == idx
