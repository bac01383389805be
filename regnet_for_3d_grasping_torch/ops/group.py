"""Radius grouping of the proposal regions: the served form (K12, JAX
``geometry/region.py:160-185``) and the fused form (K11, JAX
``ops/group_pallas.py``).

Kernel K12 (``csrc/group.cu``, `group_regions_chunked`) computes what the
JAX package serves on every backend: centers in chunks, the expansion-form
``bpdist2(c, xyz) <= r2``, `hash_uniform` over each chunk's [B, chunk, N]
linear index with the chunk's seed, and `bucket_choice` over buckets of
``ceil(N / K)`` columns.  Its plain version is that chunked loop,
`group_regions_chunked_plain`.

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

import ctypes

import numpy as np
import torch

from regnet_for_3d_grasping_torch.ops import _cuda, bucket_scan
from regnet_for_3d_grasping_torch.ops.distances import bpdist2
from regnet_for_3d_grasping_torch.ops.sampling import (bucket_choice,
                                                       bucket_stride,
                                                       fill_empty_buckets,
                                                       hash_uniform)

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


def group_regions_chunked(xyz: torch.Tensor, centers: torch.Tensor,
                          seeds, radius: float, K: int, chunk: int):
    """Kernel K12: xyz [B, N, 3], centers [B, M, 3] f32, one u32 seed per
    `chunk` centers -> (index [B, M, K] int32, 0 for a center with no point
    in radius; count [B, M] int32, exact).  Bucket k covers columns [k*L,
    (k+1)*L), L = ceil(N / K).  CPU tensors take
    `group_regions_chunked_plain`."""
    B, N, _ = xyz.shape
    M = centers.shape[1]
    if len(seeds) != -(-M // chunk):
        raise ValueError(f"group_regions_chunked: {len(seeds)} seeds for "
                         f"{M} centers in chunks of {chunk}")
    if xyz.device.type == "cpu":
        return group_regions_chunked_plain(xyz, centers, seeds, radius, K,
                                           chunk)
    _cuda.check(xyz, "group_regions_chunked xyz", torch.float32, (B, N, 3))
    _cuda.check(centers, "group_regions_chunked centers", torch.float32,
                (B, M, 3))
    if B * chunk * N >= 1 << 32:
        raise ValueError(f"group_regions_chunked: {B * chunk * N} elements "
                         "a chunk overflow the hash's u32 counter")
    L = bucket_stride(N, K)
    # one launch takes at most `most` chunks (the seeds go by value); more
    # chunks take a launch for each `most` of them
    most = _cuda.constant("group_regions_chunked_max_chunks", xyz.device)
    span = most * chunk
    out = []
    for m0 in range(0, M, span):
        c = centers[:, m0:m0 + span].contiguous()
        m = c.shape[1]
        tile, rng, partial = bucket_scan.scan_args(
            "group_regions_chunked", xyz, m, K, L,
            bucket_scan.staged_width(L))
        part = seeds[m0 // chunk:(m0 + m + chunk - 1) // chunk]
        seed_arr = (ctypes.c_uint32 * len(part))(
            *(int(s) & _U32 for s in part))
        idx = torch.empty(B, m, K, dtype=torch.int32, device=xyz.device)
        count = torch.empty(B, m, dtype=torch.int32, device=xyz.device)
        _cuda.launch("group_regions_chunked", xyz.device, xyz, c, seed_arr,
                     chunk, len(part), idx, count, partial, B, N, m, K, L,
                     tile, rng, radius2(radius))
        out.append((idx, count))
    if len(out) == 1:
        return out[0]
    return (torch.cat([i for i, _ in out], 1),
            torch.cat([n for _, n in out], 1))


def group_regions_chunked_plain(xyz, centers, seeds, radius, K, chunk):
    """Plain PyTorch version of K12, the JAX package's chunked loop: the
    centers padded with far centers to whole chunks, then per chunk and
    seed `bucket_choice` over ``bpdist2 <= r2`` with `hash_uniform`
    noise."""
    return chunked_picks(xyz, centers, chunk, [(K, radius, seeds)])[0]


def chunked_picks(xyz, centers, chunk, scales) -> list:
    """The chunked loop over one distance matrix for several scales
    ``(K, radius, seeds)``, one seed a chunk each -> [(index [B, M, K]
    int32, 0 where a center has no point in radius; count [B, M] int32)]
    by scale (JAX ``region.py:160-185`` and, with two scales,
    ``:188-240``)."""
    B, N, _ = xyz.shape
    M = centers.shape[1]
    pad = (-M) % chunk
    if pad:
        centers = torch.cat([centers, torch.full(
            (B, pad, 3), 1e10, dtype=centers.dtype, device=centers.device)],
            1)
    out = [([], []) for _ in scales]
    for j, c in enumerate(torch.split(centers, chunk, dim=1)):
        d2 = bpdist2(c, xyz)
        for (K, radius, seeds), (idx, cnt) in zip(scales, out):
            mask = d2 <= radius2(radius)
            noise = hash_uniform(seeds[j], tuple(mask.shape),
                                 device=mask.device)
            i, any_valid, count = bucket_choice(mask, K, score=noise)
            idx.append(torch.where(any_valid[..., None], i, 0))
            cnt.append(count)
    return [(torch.cat(idx, 1)[:, :M], torch.cat(cnt, 1)[:, :M])
            for idx, cnt in out]
