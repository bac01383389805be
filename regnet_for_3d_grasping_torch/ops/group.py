"""Radius grouping of the proposal regions, the fused form (JAX
``ops/group_pallas.py``).

Kernel K11 (``csrc/group.cu``, the center-tiled bucket scan of
``csrc/bucket_scan.cuh`` with a radius test; grid by
`ops.bucket_scan.scan_grid`) and its plain version
`group_regions_fused_plain`.  For each center m and bucket b of L columns:
test ``d2 <= r2`` on exact differences, and pick the in-radius column with
the largest 23-bit counter-hash noise (first column on ties); the count of
in-radius columns is exact over all buckets.  The hash is the TPU kernel's
(``group_pallas.py:57-66``), keyed by the center's row in its own cloud,
the column and a u32 seed (the batch index is not mixed in), so the kernel
and the JAX package pick the same points.
"""

from __future__ import annotations

import numpy as np
import torch

from regnet_for_3d_grasping_torch.ops import _cuda, bucket_scan
from regnet_for_3d_grasping_torch.ops.sampling import fill_empty_buckets

_U32 = 0xFFFFFFFF


def radius2(radius: float) -> float:
    """The TPU kernel's threshold: the square taken in double, then
    rounded to f32 by the comparison (``group_pallas.py:120``)."""
    return float(np.float32(float(radius) ** 2))


def group_regions_fused(xyz: torch.Tensor, centers: torch.Tensor, seed: int,
                        radius: float, K: int, L: int):
    """Kernel K11: xyz [B, N, 3], centers [B, M, 3] f32, u32 seed ->
    (index [B, M, K] int32, 0 for a center with no point in radius; count
    [B, M] int32).  Bucket k covers columns [k*L, (k+1)*L).  CPU tensors
    take `group_regions_fused_plain`."""
    if xyz.device.type == "cpu":
        return group_regions_fused_plain(xyz, centers, seed, radius, K, L)
    B, N, _ = xyz.shape
    M = centers.shape[1]
    _cuda.check(xyz, "group_regions xyz", torch.float32, (B, N, 3))
    _cuda.check(centers, "group_regions centers", torch.float32, (B, M, 3))
    if K * L < N or M == 0:
        raise ValueError(f"group_regions: K*L={K * L} must cover N={N}")
    tile, rng, partial = bucket_scan.scan_args("group_regions", xyz, M, K, L)
    idx = torch.empty(B, M, K, dtype=torch.int32, device=xyz.device)
    count = torch.empty(B, M, dtype=torch.int32, device=xyz.device)
    _cuda.launch("group_regions", xyz.device, xyz, centers,
                 int(seed) & _U32, idx, count, partial, B, N, M, K, L, tile,
                 rng, radius2(radius))
    return idx, count


def group_regions_fused_plain(xyz, centers, seed, radius, K, L, chunk=256):
    """Plain PyTorch version of K11, chunked over centers: ``d2 = (dx*dx +
    dy*dy) + dz*dz`` with d = center - point, the hash in int64 masked to
    32 bits, the per-bucket argmax on the 23-bit key."""
    B, N, _ = xyz.shape
    r2 = radius2(radius)
    col = torch.arange(K * L, device=xyz.device)
    col_h = (col * 2654435761) & _U32
    idx, cnt = [], []
    for m0 in range(0, centers.shape[1], chunk):
        c = centers[:, m0:m0 + chunk]
        d = [c[:, :, None, i] - xyz[:, None, :, i] for i in range(3)]
        mask = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2] <= r2
        mask = torch.nn.functional.pad(mask, (0, K * L - N))
        rows = torch.arange(m0, m0 + c.shape[1], device=xyz.device)
        h = ((rows[:, None] * 0x9E3779B9 + (int(seed) & _U32)) & _U32
             ) + col_h[None, :]
        h = h & _U32
        h = h ^ (h >> 16)
        h = (h * 0x45D9F3B) & _U32
        h = h ^ (h >> 16)
        key = torch.where(mask, (h >> 9)[None], -1).reshape(B, -1, K, L)
        win = torch.arange(K, device=xyz.device) * L + torch.argmax(key, -1)
        any_b = key.amax(-1) >= 0
        idx.append(fill_empty_buckets(torch.where(any_b, win, -1), any_b))
        cnt.append(mask.sum(-1, dtype=torch.int32))
    return torch.cat(idx, 1), torch.cat(cnt, 1)
