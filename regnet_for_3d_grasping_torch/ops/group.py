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

import ctypes
import math
from typing import NamedTuple

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


class GridPlan(NamedTuple):
    """Each cloud's grid, as K12's build derives it."""
    lo: torch.Tensor      # [B, 3] f32, the least finite coordinate (0: none)
    hi: torch.Tensor      # [B, 3] f32, the largest
    inv_h: torch.Tensor   # [B] f32, 1 / the cell side
    dims: torch.Tensor    # [B, 3] int64, cells on each axis
    p_norm: torch.Tensor  # [B] f64, the largest finite point norm
    points: torch.Tensor  # [B] int64, finite points


def reach(a: torch.Tensor, p: torch.Tensor, r2: float) -> torch.Tensor:
    """f32 half-width of the box that a center of norm `a` (f64) visits in
    a cloud of largest point norm `p` (f64): every point that passes the
    expansion test lies within it (``csrc/grid_group.cu``, `reach`)."""
    s = a + p
    rho2 = r2 * (1 + 2.0 ** -22) + 2.0 ** -21 * (s * s) + 2.0 ** -120
    rho = torch.sqrt(rho2).float()
    return torch.nextafter(rho, torch.full_like(rho, math.inf))


def grid_plan(xyz: torch.Tensor, r2: float) -> GridPlan:
    """The grid of each cloud of xyz [B, N, 3] f32: cells of side h, at
    least the reach of a center of the cloud's largest norm, widened by
    1.25 until at most `GRID_CELLS` cells cover the finite points' extent
    (the double arithmetic of the kernel's `make_grid`)."""
    finite = torch.isfinite(xyz).all(-1)
    points = finite.sum(1)
    some = (points > 0)[:, None]
    inf = torch.tensor(math.inf, device=xyz.device)
    lo = torch.where(finite[..., None], xyz, inf).amin(1)
    hi = torch.where(finite[..., None], xyz, -inf).amax(1)
    lo, hi = torch.where(some, lo, 0.0), torch.where(some, hi, 0.0)
    d = xyz.double()
    p2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    p_norm = torch.sqrt(torch.where(finite, p2, 0.0).amax(1))
    rho = reach(p_norm, p_norm, r2)
    inv_h, dims = [], []
    for lo_b, hi_b, rho_b, n_b in zip(lo.tolist(), hi.tolist(), rho.tolist(),
                                      points.tolist()):
        if n_b == 0:
            inv_h.append(1.0)
            dims.append([1, 1, 1])
            continue
        ext = [h - l for l, h in zip(lo_b, hi_b)]
        h = max(rho_b, max(0.0, *ext) / GRID_CELLS)
        while True:
            g = [math.floor(e / h) + 1.0 for e in ext]
            if g[0] * g[1] * g[2] <= GRID_CELLS:
                break
            h *= 1.25
        inv_h.append(float(np.float32(1.0 / h)))
        dims.append([int(v) for v in g])
    dev = xyz.device
    return GridPlan(lo, hi, torch.tensor(inv_h, dtype=torch.float32,
                                         device=dev),
                    torch.tensor(dims, dtype=torch.int64, device=dev),
                    p_norm, points)


def _cell_axis(x, lo, inv_h, dims) -> torch.Tensor:
    """clamp(floor((x - lo) * inv_h), 0, dims - 1) in f32: the kernel's
    `cell_axis`, monotone in x."""
    f = torch.floor((x - lo) * inv_h)
    return torch.minimum(torch.clamp(f, min=0.0),
                         (dims - 1).to(f.dtype)).long()


def grid_cells(xyz: torch.Tensor, plan: GridPlan) -> torch.Tensor:
    """[B, N, 3] int64: each point's cell on each axis, -1 for a point with
    a non-finite coordinate (it has no record)."""
    finite = torch.isfinite(xyz).all(-1, keepdim=True)
    x = torch.where(finite, xyz, plan.lo[:, None])
    cell = _cell_axis(x, plan.lo[:, None], plan.inv_h[:, None, None],
                      plan.dims[:, None])
    return torch.where(finite, cell, -1)


def grid_visits(centers: torch.Tensor, plan: GridPlan, r2: float) -> tuple:
    """(box [B, M, 3, 2] int64, visits [B, M] bool): the first and last
    cell on each axis that a center visits (the kernel's `visit_box`: its
    reach around it, the ends rounded outward), and whether it visits any
    (a finite center whose box meets the cloud's extent; the box of one
    that does not is 0)."""
    d = centers.double()
    a = torch.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                   + d[..., 2] * d[..., 2])
    rho = reach(a, plan.p_norm[:, None], r2)[..., None]
    inf = torch.full_like(centers, math.inf)
    lo = torch.nextafter(centers - rho, -inf)
    hi = torch.nextafter(centers + rho, inf)
    visits = (torch.isfinite(centers).all(-1) & (plan.points[:, None] > 0)
              & ((hi >= plan.lo[:, None]) & (lo <= plan.hi[:, None])).all(-1))
    args = (plan.lo[:, None], plan.inv_h[:, None, None], plan.dims[:, None])
    box = torch.stack([_cell_axis(lo, *args), _cell_axis(hi, *args)], -1)
    return torch.where(visits[..., None, None], box, 0), visits


def grid_candidates(xyz: torch.Tensor, centers: torch.Tensor,
                    r2: float) -> tuple:
    """(pairs [B, M] int64, cells [B, M] int64): the records that each
    center tests (the points of the cells in its box) and the cells it
    visits, from 3-D prefix sums of the cells' counts."""
    plan = grid_plan(xyz, r2)
    cells = grid_cells(xyz, plan)
    box, visits = grid_visits(centers, plan, r2)
    B, M = centers.shape[:2]
    pairs = torch.zeros(B, M, dtype=torch.int64, device=xyz.device)
    ncell = torch.zeros_like(pairs)
    for b, (gx, gy, gz) in enumerate(plan.dims.tolist()):
        ok = cells[b, :, 0] >= 0
        lin = (cells[b, ok, 2] * gy + cells[b, ok, 1]) * gx + cells[b, ok, 0]
        cnt = torch.bincount(lin, minlength=gx * gy * gz).reshape(gz, gy, gx)
        S = torch.zeros(gz + 1, gy + 1, gx + 1, dtype=torch.int64,
                        device=xyz.device)
        S[1:, 1:, 1:] = cnt.cumsum(0).cumsum(1).cumsum(2)
        (x0, x1), (y0, y1), (z0, z1) = (
            (box[b, :, i, 0], box[b, :, i, 1] + 1) for i in range(3))
        total = (S[z1, y1, x1] - S[z0, y1, x1] - S[z1, y0, x1]
                 - S[z1, y1, x0] + S[z0, y0, x1] + S[z0, y1, x0]
                 + S[z1, y0, x0] - S[z0, y0, x0])
        pairs[b] = torch.where(visits[b], total, 0)
        ncell[b] = torch.where(visits[b], (x1 - x0) * (y1 - y0) * (z1 - z0),
                               0)
    return pairs, ncell


def grid_scratch(B: int, N: int, device) -> torch.Tensor:
    """K12's scratch for B clouds of N points, int32 words: see
    `grid_views`."""
    return torch.empty(B * (5 * N + GRID_WORDS + GRID_CELLS + 1),
                       dtype=torch.int32, device=device)


def grid_views(scratch: torch.Tensor, B: int, N: int) -> tuple:
    """(records [B, N, 4] f32: x, y, z and the column's bits in cell order;
    grids [B, GRID_WORDS] int32; starts [B, GRID_CELLS + 1] int32: cell
    c's records are [starts[c], starts[c + 1]); ranks [B, N] int32) in
    `scratch`, the records first (16-byte aligned), then the grids (8-byte
    aligned for their double)."""
    sizes = (B * N * 4, B * GRID_WORDS, B * (GRID_CELLS + 1), B * N)
    rec, grids, starts, ranks = torch.split(scratch[:sum(sizes)], sizes)
    return (rec.view(torch.float32).view(B, N, 4), grids.view(B, GRID_WORDS),
            starts.view(B, GRID_CELLS + 1), ranks.view(B, N))


def grid_read(grids: torch.Tensor) -> GridPlan:
    """The grids [B, GRID_WORDS] int32 that K12's build wrote, as a
    `GridPlan` (the kernel's struct Grid)."""
    f32 = grids.view(torch.float32)
    return GridPlan(f32[:, 0:3], f32[:, 10:13], f32[:, 3],
                    grids[:, 4:7].long(),
                    grids[:, 8:10].contiguous().view(torch.float64)[:, 0],
                    grids[:, 7].long())


def route(B: int, M: int, N: int, K: int, chunks: int, sms: int) -> tuple:
    """K12's pass for B clouds of N points, M centers each, K buckets and
    `chunks` seeds, on a card of `sms` SMs: ("direct", C), C centers a
    block, for at most `DIRECT_PAIRS` pairs (the grid's build would cost
    more than the pairs it saves), else ("grid", 0)."""
    if B * M * N <= DIRECT_PAIRS and chunks <= MAX_CHUNKS:
        for per in DIRECT_PER_BLOCK:
            if B * -(-M // per) <= 2 * sms or per == DIRECT_PER_BLOCK[-1]:
                if per * K * 8 <= DIRECT_KEY_BYTES:
                    return "direct", per
                break
    return "grid", 0


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
    if xyz.device.type == "cpu":
        return group_regions_chunked_plain(xyz, centers, seeds, radius, K,
                                           chunk)
    _cuda.check(xyz, "group_regions_chunked xyz", torch.float32, (B, N, 3))
    _cuda.check(centers, "group_regions_chunked centers", torch.float32,
                (B, M, 3))
    if B * chunk * N >= 1 << 32:
        raise ValueError(f"group_regions_chunked: {B * chunk * N} elements "
                         "a chunk overflow the hash's u32 counter")
    sms = _cuda.sm_count(xyz.device)
    kind, per = route(B, M, N, K, len(seeds), sms)
    # the seeds go by value (the query: at most MAX_CHUNKS a launch): a
    # call copies nothing to the card
    seed_arr = (ctypes.c_uint32 * len(seeds))(*(int(s) & _U32 for s in seeds))
    idx = torch.empty(B, M, K, dtype=torch.int32, device=xyz.device)
    count = torch.empty(B, M, dtype=torch.int32, device=xyz.device)
    if kind == "direct":
        views = (None,) * 4
    else:
        records, grids, starts, ranks = grid_views(
            grid_scratch(B, N, xyz.device), B, N)
        views = (records, starts, ranks, grids)
    _cuda.launch("group_regions_chunked", xyz.device, xyz, centers, seed_arr,
                 chunk, len(seeds), idx, count, *views, B, N, M, K,
                 bucket_stride(N, K), per, sms, radius2(radius))
    return idx, count


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
