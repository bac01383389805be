"""Radius neighbourhood query with fixed output shape (JAX
``ops/ball_query.py`` + ``ops/ball_query_pallas.py``).

Two paths choose different points, so the port dispatches as the JAX
package does on the TPU: kernel K2 (``csrc/ball_query.cu``, the
center-tiled bucket scan of ``csrc/bucket_scan.cuh`` with a strict radius
test and the first pick, grid by `ops.bucket_scan.scan_grid`; buckets of
`pallas_bucket_stride` = 512 at SA1) where `use_kernel` holds, else the
plain bucket path (buckets of ``ceil(N/K)``).  ``method="exact"`` is the
first K in-radius points in index order (JAX ``ball_query.py:116-163``),
which the JAX package computes in XLA: plain PyTorch on every device.

The JAX ops package exports the function under this module's name, and so
does the port's (``ops.ball_query(...)``): the module is callable, and
``ops.ball_query.KERNEL_MIN_WORK`` and the rest stay its attributes.
"""

from __future__ import annotations

import sys
import types

import numpy as np
import torch

from portbench.reference.regnet_ref.ops.distances import bpdist2
from portbench.reference.regnet_ref.ops.sampling import (bucket_choice,
                                                       fill_empty_buckets,
                                                       pallas_bucket_stride)

# M*N at or above which the JAX package runs the Pallas ball query
# (regnet_for_3d_grasping_tpu/ops/ball_query.py:75); K must be a multiple
# of 8 (ball_query.py:79-80)
KERNEL_MIN_WORK = 1 << 25


def use_kernel(m: int, n: int, k: int) -> bool:
    return m * n >= KERNEL_MIN_WORK and k % 8 == 0


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               num_neighbours: int, chunk: int = 4096,
               method: str = "bucket"):
    """xyz [B, N, 3], centers [B, M, 3] -> (index [B, M, K] int32, short
    rows padded with the first hit, 0 when no hit; count [B, M] int32
    capped at K).  `method`: "bucket" (stratified) or "exact" (the first K
    in index order)."""
    xyz = xyz.float().contiguous()
    centers = centers.float().contiguous()
    r2 = float(np.float32(radius * radius))
    M, N = centers.shape[1], xyz.shape[1]
    if method == "exact":
        return _ball_query_exact(xyz, centers, r2, num_neighbours)
    if method != "bucket":
        raise ValueError(f"unknown ball query method {method!r}")
    if use_kernel(M, N, num_neighbours):
        return ball_query_bucketed(xyz, centers, r2, num_neighbours,
                                   pallas_bucket_stride(N, num_neighbours))
    return _ball_query_bucket(xyz, centers, r2, num_neighbours, chunk)


def _ball_query_exact(xyz, centers, r2, K, work=1 << 23):
    """The first K points with ``d2 < r2`` (`bpdist2`) in index order,
    short rows padded with the first hit, the count capped at K (JAX
    ``ball_query.py:116-163``, whose chunks over the points and top-K
    merge give this).  Chunked over centers, `work` pairs a chunk."""
    B, N, _ = xyz.shape
    k = min(K, N)
    ids = torch.arange(N, device=xyz.device)
    idx, cnt = [], []
    for c in torch.split(centers, max(1, work // N), dim=1):
        mask = bpdist2(c, xyz) < r2
        first = torch.topk(torch.where(mask, ids, N), k, dim=-1,
                           largest=False, sorted=True).values
        if k < K:
            first = torch.nn.functional.pad(first, (0, K - k), value=N)
        hit = first < N
        head = torch.where(hit[..., :1], first[..., :1], 0)
        idx.append(torch.where(hit, first, head).to(torch.int32))
        cnt.append(hit.sum(-1, dtype=torch.int32))
    return torch.cat(idx, 1), torch.cat(cnt, 1)


def _ball_query_bucket(xyz, centers, r2, K, chunk):
    """The plain bucket path (JAX ``ball_query.py:88-113``): expansion-form
    distances, ``d2 < r2``, smallest in-radius index per bucket."""
    idx, cnt = [], []
    for c in torch.split(centers, chunk, dim=1):
        mask = bpdist2(c, xyz) < r2
        i, any_valid, count = bucket_choice(mask, K)
        idx.append(torch.where(any_valid[..., None], i, 0))
        cnt.append(torch.clamp(count, max=K))
    return torch.cat(idx, 1), torch.cat(cnt, 1)


def ball_query_bucketed(xyz: torch.Tensor, centers: torch.Tensor, r2: float,
                        K: int, L: int):
    """Kernel K2: bucket k of each center holds its smallest in-radius
    point index in [k*L, (k+1)*L); count = min(in-radius total, K).  A
    scan and a fill, 2 launches counted as one.  CPU tensors take
    `ball_query_bucketed_plain`."""
    return ball_query_bucketed_plain(xyz, centers, r2, K, L)


def _bucket_winners(mask: torch.Tensor, K: int, L: int):
    """mask [B, m, N] -> per-bucket first True index [B, m, K], empty
    buckets filled by `fill_empty_buckets`."""
    B, m, N = mask.shape
    mp = torch.nn.functional.pad(mask, (0, K * L - N)).reshape(B, m, K, L)
    any_b = mp.any(-1)
    col = torch.argmax(mp.to(torch.uint8), dim=-1)
    win = torch.where(any_b, torch.arange(K, device=mask.device) * L + col,
                      -1)
    return fill_empty_buckets(win, any_b)


def ball_query_bucketed_plain(xyz, centers, r2, K, L, chunk=512):
    """Plain PyTorch version of K2: diff-square distances summed as
    ((dx^2 + dy^2) + dz^2), ``d2 < r2``."""
    idx, cnt = [], []
    for c in torch.split(centers, chunk, dim=1):
        d = [xyz[:, None, :, i] - c[:, :, None, i] for i in range(3)]
        mask = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2] < r2
        idx.append(_bucket_winners(mask, K, L))
        cnt.append(torch.clamp(mask.sum(-1, dtype=torch.int32), max=K))
    return torch.cat(idx, 1), torch.cat(cnt, 1)


class _CallableModule(types.ModuleType):
    """``ops.ball_query(...)`` calls `ball_query`, as the JAX ops package's
    export of that name does."""

    def __call__(self, *args, **kwargs):
        return ball_query(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
