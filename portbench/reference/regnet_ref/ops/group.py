"""Radius grouping of the proposal regions: the served form (K12, JAX
``geometry/region.py:160-185``) and the fused form (K11, JAX
``ops/group_pallas.py``).

Kernel K12 (``csrc/grid_group.cu``, `group_regions_chunked`) computes what
the JAX package serves on every backend: centers in chunks, the
expansion-form ``bpdist2(c, xyz) <= r2``, `hash_uniform` over each chunk's
[B, chunk, N] linear index with the chunk's seed, and `bucket_choice` over
buckets of ``ceil(N / K)`` columns.  Its plain version is that chunked
loop, `group_regions_chunked_plain`.  The kernel's grid pass sorts each
cloud into a cell grid and tests a center only against the cells within
its reach: the radius widened by a bound on the expansion form's rounding
(``csrc/grid_group.cu`` proves it); a call of few pairs takes one direct
pass that tests every pair (`route`).  `grid_plan`, `grid_cells` and
`grid_visits` are the kernel's grid, cells and visit boxes, computed with
the same arithmetic: the tests emulate the kernel with them, and
``chip_smoke.py`` holds the kernel's grid against them and counts what a
center tests (`grid_candidates`).

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

from portbench.reference.regnet_ref.ops.distances import bpdist2
from portbench.reference.regnet_ref.ops.sampling import (
    bucket_choice, hash_uniform)

_U32 = 0xFFFFFFFF


def radius2(radius: float) -> float:
    """The TPU kernel's threshold: the square taken in double, then
    rounded to f32 by the comparison (``group_pallas.py:120``)."""
    return float(np.float32(float(radius) ** 2))


# csrc/grid_group.cu: the cells of a grid (kMaxCells), the words of a
# cloud's grid in the scratch (kGridWords), the most seeds a query launch
# takes by value (kMaxChunks; more chunks take more launches), the shared
# memory a direct pass block may give its centers' bucket keys
# (kMaxDirectSmem)
GRID_CELLS = 1 << 15
GRID_WORDS = 16
MAX_CHUNKS = 64
DIRECT_KEY_BYTES = 200 * 1024
# calls of at most this many (center, point) pairs take the direct pass: on
# an H100 at 12 x 64 x 25,600 = 19.7 M pairs it took 0.0286 ms and the grid
# 0.0374, at 4,000 x 25,600 = 102.4 M the grid 0.0282 and it 0.0978
# (chip_smoke.py phase 3, PERF.md)
DIRECT_PAIRS = 1 << 25
# centers a direct pass block holds (the kernel's instances): the fewer where
# it keeps the blocks within two an SM (1 at a validation forward's 64
# centers, 4 at a training batch's 12 x 64)
DIRECT_PER_BLOCK = (1, 4)


def group_regions_chunked(xyz: torch.Tensor, centers: torch.Tensor,
                          seeds, radius: float, K: int, chunk: int):
    """Kernel K12: xyz [B, N, 3], centers [B, M, 3] f32, one u32 seed per
    `chunk` centers -> (index [B, M, K] int32, 0 for a center with no point
    in radius; count [B, M] int32, exact).  Bucket k covers columns [k*L,
    (k+1)*L), L = ceil(N / K).  The pass is `route`'s; the grid pass builds
    in a new `grid_scratch`.  CPU tensors take
    `group_regions_chunked_plain`."""
    B, N, _ = xyz.shape
    M = centers.shape[1]
    if M == 0 or len(seeds) != -(-M // chunk):
        raise ValueError(f"group_regions_chunked: {len(seeds)} seeds for "
                         f"{M} centers in chunks of {chunk}")
    return group_regions_chunked_plain(xyz, centers, seeds, radius, K,
                                       chunk)


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
