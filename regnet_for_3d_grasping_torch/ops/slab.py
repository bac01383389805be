"""Sorted-slab selection, 3-NN and pooling (JAX ``ops/slab.py``).

One spatial sort per forward (`sort_cloud`: ascending x-cell, random within
a cell) lets every radius, box or nearest-neighbour test scan only the rows
whose x can pass it.  Queries are handled in tiles of 128 (256 for the
3-NN); `slab_bounds` gives each tile the 2,048-row blocks ``[start, stop)``
that hold every candidate, and the origin ``off`` of the block span in which
picks are made.  Counts stay exact; picks are stratified over the span's
windows, which is the structure `gather_max_slab` pools over.

Kernels (CUDA tensors) and their plain PyTorch versions (CPU tensors):

  K6 group_slab / ball_query_slab   csrc/slab_select.cu   group_slab_plain
  K7 crop_slab                      csrc/slab_select.cu   crop_slab_plain
  K8 three_nn_slab                  csrc/three_nn_slab.cu three_nn_slab_plain
     (and flat=True, K8 flat)
  K9 gather_max_slab                csrc/gather_max_slab.cu
                                                     gather_max_slab_plain

The JAX package runs K6 and K7 over two grid layouts (a full grid with
skipped steps and a flat grid of live steps) that scan the same blocks in
the same order; here one kernel over every ``(tile, scan block)`` stands
for both.  K8's two grids differ: the bounded one clamps every span to
`grid_span` blocks, the flat one (``flat=True``) scans the unclamped spans
where they sum to at most ``G = B*T*5 // 2`` (tile, block) pairs and falls
back to the bounded grid elsewhere, a choice that a CUDA call makes on
the card (`three_nn_slab_call`).  A K6 or K7 call
builds its span table, selects and fills its empty slots on the card in
three launches (``csrc/slab_select.cu``); `slab_bounds` and
`finish_select` are their plain versions.  So does a K8 call: span table,
scan, and merge with the exactness certificate, which sets a device flag
that the full-scan fallback (K3) reads on the card; `three_nn_spans`,
`three_nn_slab_plain` and `three_nn_certificate` are its plain versions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from regnet_for_3d_grasping_torch.ops import _cuda, knn
from regnet_for_3d_grasping_torch.ops.grouping import group_points
from regnet_for_3d_grasping_torch.ops.knn import _smallest_k
from regnet_for_3d_grasping_torch.ops.pooling import (DTYPES, kernel_name,
                                                    scatter_winner)
from regnet_for_3d_grasping_torch.utils import trace

_TM = 128      # queries per tile (selection and pooling)
_SCAN = 2048   # rows per scan block
_BIG = 1e38    # finite sentinel: "no neighbour" distance, pooled "nothing"

# selection window geometry: `spw` picks per `win`-row window
GROUP_WIN, GROUP_SPW = 128, 4
CROP_WIN, CROP_SPW = 256, 1
BALL_WIN, BALL_SPW = 256, 2

_SCAN_K = 1024  # keys per block (3-NN)
_TM_K = 256     # queries per tile (3-NN)
# the blocks a SM that K8's scan aims at, counting the ones past a span's
# stop: its grid sweep on the H100 (PERF.md) ran fastest at FP3 serving on
# 4 parts a key block (2,400 blocks, about 1,900 live)
NN_BLOCKS_PER_SM = 12

_U32 = 0xFFFFFFFF
# odd multipliers: h -> (h * odd) mod 2^23 permutes the 23-bit scores, one
# reshuffle of a single hash per selection stream
_STREAM_ODD = (1, 0x3779B1, 0x85EBCB, 0x27D4ED)


class SortedCloud(NamedTuple):
    """A point cloud in slab order (ascending x-cell, random within)."""

    xyz: torch.Tensor        # [B, N, 3] f32
    cell_row: torch.Tensor   # [B, N] int32 nondecreasing cell ids
    order: torch.Tensor      # [B, N] int32 original row of each sorted row


def _cell_id(x: torch.Tensor, cell: float) -> torch.Tensor:
    c = trace.to_device(torch.tensor(cell, dtype=torch.float32), x.device,
                        "slab.cell_id")
    return torch.clamp(torch.floor(x / c), -1e6, 1e6)


def sort_cloud(pc: torch.Tensor, cell: float, u: torch.Tensor | None = None,
               generator: torch.Generator | None = None):
    """Order points by (floor(x / cell), u): pc [B, N, C>=3] ->
    (pc_sorted, SortedCloud).  `u` [B, N] f32 in [0, 1) is the within-cell
    noise, drawn from `generator` when not passed.  The sort is stable, as
    the key ``cell id + u * 0.999`` is f32 and ties happen."""
    B, N, _ = pc.shape
    if u is None:
        if generator is None:
            raise ValueError("sort_cloud: pass the noise u or a generator")
        u = torch.rand(B, N, generator=generator, dtype=torch.float32)
    u = trace.to_device(u, pc.device, "slab.sort_noise").float()
    sortkey = _cell_id(pc[..., 0].float(), cell) + u * 0.999
    order = torch.sort(sortkey, dim=-1, stable=True).indices
    pc_sorted = torch.gather(pc, 1, order[..., None].expand_as(pc))
    xs = pc_sorted[..., :3].float().contiguous()
    # cell ids are a function of x: recomputed from the sorted x
    cell_row = _cell_id(xs[..., 0], cell).to(torch.int32)
    return pc_sorted, SortedCloud(xs, cell_row, order.to(torch.int32))


def n_scan_blocks(n: int) -> int:
    return -(-n // _SCAN)


def n_scan_blocks_k(n: int) -> int:
    return -(-n // _SCAN_K)


def span_blocks_for(k: int, win: int, spw: int) -> int:
    """Selection-span blocks for K output slots at (win, spw) geometry."""
    rps = spw * _SCAN // win
    if k % rps:
        raise ValueError(f"K={k} is not a multiple of {rps} slots per block "
                         f"(win={win}, spw={spw})")
    return k // rps


def group_span_blocks(group_num: int) -> int:
    return span_blocks_for(group_num, GROUP_WIN, GROUP_SPW)


def crop_span_blocks(gripper_num: int) -> int:
    return span_blocks_for(gripper_num, CROP_WIN, CROP_SPW)


def _tile_range(qt: torch.Tensor, bound: float):
    """qt [B, T, tile] query x (pad queries hold 1e10) -> per-tile
    (lo, hi) = x-range of the real queries widened by `bound`; 1e9 for a
    tile of pad queries only."""
    real = qt < 1e9
    inf = torch.tensor(math.inf, device=qt.device)
    lo = torch.where(real, qt, inf).amin(-1) - bound
    hi = torch.where(real, qt, -inf).amax(-1) + bound
    any_real = real.any(-1)
    far = torch.tensor(1e9, dtype=torch.float32, device=qt.device)
    return torch.where(any_real, lo, far), torch.where(any_real, hi, far)


def slab_bounds(cell_row: torch.Tensor, qx: torch.Tensor, bound: float,
                cell: float, nblk: int, span_blocks: int) -> torch.Tensor:
    """Per-tile scan range and selection-span origin.

    cell_row [B, N] sorted cell ids; qx [B, Mp] query x, Mp a multiple of
    128, pad queries at 1e10; `bound` the largest |px - qx| a passing point
    can have.  Returns [B, T, 3] int32 (start, stop, off): blocks
    [start, stop) hold every point within `bound` of the tile's queries;
    [off, off + span_blocks) is the selection span, the whole scan range
    when it fits and else centred on it."""
    B, Mp = qx.shape
    lo, hi = _tile_range(qx.reshape(B, Mp // _TM, _TM), bound)
    lo_c = _cell_id(lo, cell).to(torch.int32)
    hi_c = _cell_id(hi, cell).to(torch.int32)
    cell_row = cell_row.contiguous()
    srow = torch.searchsorted(cell_row, lo_c.contiguous(), right=False)
    erow = torch.searchsorted(cell_row, hi_c.contiguous(), right=True)
    start = torch.clamp(srow // _SCAN, 0, nblk - 1)
    stop = torch.minimum(torch.maximum(-(-erow // _SCAN), start + 1),
                         torch.tensor(nblk, device=qx.device))
    fits = (stop - start) <= span_blocks
    mid = (srow + erow) // (2 * _SCAN)
    off_fit = torch.clamp(start, max=nblk - span_blocks)
    off_ctr = torch.clamp(mid - span_blocks // 2, 0, nblk - span_blocks)
    off = torch.where(fits, off_fit, off_ctr)
    return torch.stack([start, stop, off], -1).to(torch.int32)


def _hash23(rows: torch.Tensor, cols: torch.Tensor, seed: int
            ) -> torch.Tensor:
    """23-bit tiebreak scores of (query row, cloud row, u32 seed): a
    lowbias32-style mix in uint32 arithmetic (int64 masked to 32 bits)."""
    h = (rows * 0x9E3779B9 + cols * 2654435761 + (int(seed) & _U32)) & _U32
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _U32
    h = h ^ (h >> 16)
    return h >> 9


def _pad_queries(t: torch.Tensor, tile: int, value: float) -> torch.Tensor:
    """Pad axis 1 of [B, M, C] to a multiple of `tile` rows."""
    pad = (-t.shape[1]) % tile
    if pad:
        t = torch.cat([t, torch.full((t.shape[0], pad, t.shape[2]), value,
                                     dtype=t.dtype, device=t.device)], 1)
    return t


def finish_select(idx, cnt, first, ss):
    """Raw picks (-1 = empty slot) -> the selectors' contract: empty slots
    take the row's first in-span pick (0 when there is none)."""
    sel_any = first >= 0
    fill = torch.clamp(first, min=0)
    idx = torch.where(idx >= 0, idx, fill[..., None])
    return idx, cnt, sel_any, ss[..., 2].contiguous()


def select_spans(sc: SortedCloud, centers: torch.Tensor, bound: float,
                 cell: float, K: int, win: int, spw: int) -> torch.Tensor:
    """The [B, T, 3] span table (`slab_bounds`) of a selection with K slots
    at (win, spw) geometry around `centers` [B, M, 3]; raises on shapes the
    selectors do not take."""
    span_b = check_select(sc, centers, K, win, spw)
    qx = _pad_queries(centers[..., :1], _TM, 1e10)[..., 0]
    return slab_bounds(sc.cell_row, qx, bound, cell,
                       n_scan_blocks(sc.xyz.shape[1]), span_b)


def check_select(sc: SortedCloud, centers: torch.Tensor, K: int, win: int,
                 spw: int) -> int:
    """Raise on a selection the selectors do not take; returns its
    selection span in blocks."""
    N, M = sc.xyz.shape[1], centers.shape[1]
    span_b = span_blocks_for(K, win, spw)
    nblk = n_scan_blocks(N)
    if _SCAN % win or not 1 <= spw <= len(_STREAM_ODD) or win % 32:
        raise ValueError(f"unsupported window geometry win={win} spw={spw}")
    if span_b > nblk:
        raise ValueError(f"selection span of {span_b} blocks exceeds the "
                         f"cloud's {nblk}")
    if M == 0:
        raise ValueError("no queries")
    return span_b


def group_slab(sc: SortedCloud, centers: torch.Tensor, seed: int,
               radius: float, group_num: int, cell: float,
               win: int = GROUP_WIN, spw: int = GROUP_SPW,
               distinct: bool = False):
    """Kernel K6: radius grouping over a sorted cloud.

    centers [B, M, 3] (x-sorted for tile locality; any order is correct),
    u32 seed.  `spw` picks per `win`-row window; `distinct` samples
    without replacement within a window.  Returns index [B, M, K] int32
    rows into sc.xyz (empty slots hold the query's first pick, 0 when
    nothing was selectable), count [B, M] int32 exact in-radius population,
    sel_any [B, M] bool, off_blk [B, T] int32 selection-span origins for
    `gather_max_slab`."""
    return group_slab_with_spans(sc, centers, seed, radius, group_num, cell,
                                 win, spw, distinct)[:4]


def group_slab_with_spans(sc: SortedCloud, centers: torch.Tensor, seed: int,
                          radius: float, group_num: int, cell: float,
                          win: int = GROUP_WIN, spw: int = GROUP_SPW,
                          distinct: bool = False):
    """`group_slab`, and its span table [B, T, 3] int32 (start, stop, off)
    last.  On the card one C call: span table, selection and fill (three
    launches).  CPU tensors take `slab_bounds`, `group_slab_plain` and
    `finish_select`."""
    c = centers[..., :3].float().contiguous()
    span_b = check_select(sc, c, group_num, win, spw)
    r2 = float(np.float32(float(radius) ** 2))
    if c.device.type == "cpu":
        ss = select_spans(sc, c, radius, cell, group_num, win, spw)
        return (*finish_select(*group_slab_plain(
            sc.xyz, c, ss, seed, r2, group_num, win, spw, distinct), ss), ss)
    out = _select_outputs(sc, c, group_num, "group_slab")
    _cuda.launch("group_slab", c.device, sc.xyz, sc.cell_row, c,
                 int(seed) & _U32, *out, *sc.xyz.shape[:2], c.shape[1],
                 group_num, span_b, win, spw, int(distinct), r2, radius, cell)
    return out


def _select_outputs(sc: SortedCloud, centers: torch.Tensor, K: int,
                    what: str) -> tuple:
    """Check K6/K7's cloud and allocate (index, count, sel_any, off_blk,
    span table) for M queries."""
    (B, N, _), M = sc.xyz.shape, centers.shape[1]
    _cuda.check(sc.xyz, f"{what} xyz", torch.float32, (B, N, 3))
    _cuda.check(sc.cell_row, f"{what} cell_row", torch.int32, (B, N))
    _cuda.check(centers, f"{what} centers", torch.float32, (B, M, 3))
    T = -(-M // _TM)
    dev = centers.device
    return (torch.empty(B, M, K, dtype=torch.int32, device=dev),
            torch.empty(B, M, dtype=torch.int32, device=dev),
            torch.empty(B, M, dtype=torch.bool, device=dev),
            torch.empty(B, T, dtype=torch.int32, device=dev),
            torch.empty(B, T, 3, dtype=torch.int32, device=dev))


def ball_query_slab(sc: SortedCloud, centers: torch.Tensor, seed: int,
                    radius: float, num_neighbours: int, cell: float):
    """SA-layer ball query over a sorted cloud: `group_slab` with two
    without-replacement picks per 256-row window.  Returns (index
    [B, M, K], count [B, M] capped at K)."""
    idx, cnt, _, _ = group_slab(sc, centers, seed, radius, num_neighbours,
                                cell, win=BALL_WIN, spw=BALL_SPW,
                                distinct=True)
    return idx, torch.clamp(cnt, max=num_neighbours)


def crop_bound(box: tuple) -> float:
    """Largest |px - cx| of a point inside the gripper box: its
    half-diagonal, with a margin."""
    xlo, xhi, yabs, zabs = box
    return math.sqrt(max(abs(xlo), abs(xhi)) ** 2 + yabs ** 2
                     + zabs ** 2) + 1e-4


def crop_slab(sc: SortedCloud, frame: torch.Tensor, center: torch.Tensor,
              seed: int, box: tuple, gripper_num: int, cell: float):
    """Kernel K7: closing-region crop over a sorted cloud.

    frame [B, M, 3, 3] (columns = gripper axes), center [B, M, 3], box
    (xlo, xhi, |y|max, |z|max).  One pick per 256-row window.  Returns
    (index, count, sel_any, off_blk) as `group_slab`."""
    return crop_slab_with_spans(sc, frame, center, seed, box, gripper_num,
                                cell)[:4]


def crop_slab_with_spans(sc: SortedCloud, frame: torch.Tensor,
                         center: torch.Tensor, seed: int, box: tuple,
                         gripper_num: int, cell: float):
    """`crop_slab`, and its span table [B, T, 3] last.  On the card one C
    call of three launches; CPU tensors take `slab_bounds`,
    `crop_slab_plain` and `finish_select`."""
    B, M = center.shape[:2]
    f = frame.float().reshape(B, M, 9).contiguous()
    c = center.float().contiguous()
    span_b = check_select(sc, c, gripper_num, CROP_WIN, CROP_SPW)
    box32 = tuple(float(np.float32(v)) for v in box)
    if c.device.type == "cpu":
        ss = select_spans(sc, c, crop_bound(box), cell, gripper_num,
                          CROP_WIN, CROP_SPW)
        return (*finish_select(*crop_slab_plain(
            sc.xyz, f, c, ss, seed, box32, gripper_num), ss), ss)
    out = _select_outputs(sc, c, gripper_num, "crop_slab")
    _cuda.check(f, "crop_slab frames", torch.float32, (B, M, 9))
    _cuda.launch("crop_slab", c.device, sc.xyz, sc.cell_row, f, c,
                 int(seed) & _U32, *out, B, sc.xyz.shape[1], M, gripper_num,
                 span_b, *box32, crop_bound(box), cell)
    return out


def _select_plain(xyz, ss, seed, M, K, win, spw, distinct, test):
    """The selection both plain versions share.  `test(b, q0, q1, x)` gives
    the pass mask [q1 - q0, rows] of tile queries q0..q1 against the rows x
    [rows, 3].  Walks each tile's blocks [start, stop) as the kernel does:
    exact count over all of them; per window `spw` hash-argmax picks (ties
    to the lowest row), kept only inside the span [off, off + span); slot
    order (block, window, stream); `first` = the first pick in that order.
    Returns raw (index with -1 for empty slots, count, first)."""
    B, N, _ = xyz.shape
    dev = xyz.device
    nwin = _SCAN // win
    rps = nwin * spw
    span_b = K // rps
    idx = torch.full((B, M, K), -1, dtype=torch.int64, device=dev)
    cnt = torch.zeros(B, M, dtype=torch.int32, device=dev)
    spans = ss.cpu().tolist()
    for b in range(B):
        for t, (start, stop, off) in enumerate(spans[b]):
            q0, q1 = t * _TM, min((t + 1) * _TM, M)
            if q0 >= M:
                break
            r0, r1 = start * _SCAN, min(stop * _SCAN, N)
            nb = stop - start
            cols = torch.arange(r0, stop * _SCAN, device=dev)
            mask = torch.zeros(q1 - q0, nb * _SCAN, dtype=torch.bool,
                               device=dev)
            mask[:, :r1 - r0] = test(b, q0, q1, xyz[b, r0:r1])
            cnt[b, q0:q1] = mask.sum(-1, dtype=torch.int32)
            rows = torch.arange(q0, q1, device=dev)
            h = _hash23(rows[:, None], cols[None, :], seed)
            shape = (q1 - q0, nb, nwin, win)
            mask = mask.reshape(shape)
            h = h.reshape(shape)
            val = torch.where(mask, h, -1)
            wbase = cols.reshape(nb, nwin, win)[None, :, :, 0]
            picks = []
            for s in range(spw):
                if distinct and s > 0:
                    # without replacement: drop the previous winner
                    val = val.scatter(-1, win_col[..., None], -1)
                elif s > 0:
                    val = torch.where(mask, (h * _STREAM_ODD[s]) & 0x7FFFFF,
                                      -1)
                win_col = torch.argmax(val, dim=-1)
                hit = val.amax(-1) >= 0
                picks.append(torch.where(hit, wbase + win_col, -1))
            picks = torch.stack(picks, -1).reshape(q1 - q0, nb, rps)
            lo, hi = max(start, off), min(stop, off + span_b)
            if lo < hi:
                idx[b, q0:q1, (lo - off) * rps:(hi - off) * rps] = \
                    picks[:, lo - start:hi - start].reshape(q1 - q0, -1)
    has = idx >= 0
    first_slot = torch.argmax(has.to(torch.uint8), dim=-1, keepdim=True)
    first = torch.where(has.any(-1), torch.gather(idx, -1, first_slot)[..., 0],
                        -1)
    return idx.to(torch.int32), cnt, first.to(torch.int32)


def group_slab_plain(xyz, centers, ss, seed, r2, K, win, spw, distinct):
    """Plain PyTorch version of K6: diff-square distances summed as
    ((dx^2 + dy^2) + dz^2), ``d2 <= r2``."""
    def test(b, q0, q1, x):
        d = [x[None, :, i] - centers[b, q0:q1, None, i] for i in range(3)]
        return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2] <= r2

    return _select_plain(xyz, ss, seed, centers.shape[1], K, win, spw,
                         distinct, test)


def crop_slab_plain(xyz, frames, centers, ss, seed, box, K):
    """Plain PyTorch version of K7: ``loc_j = (F0j*r0 + F1j*r1) + F2j*r2``
    with r = x - center, then the box test."""
    xlo, xhi, yabs, zabs = box

    def test(b, q0, q1, x):
        f = frames[b, q0:q1]
        r = [x[None, :, i] - centers[b, q0:q1, None, i] for i in range(3)]
        loc = [(f[:, j, None] * r[0] + f[:, 3 + j, None] * r[1])
               + f[:, 6 + j, None] * r[2] for j in range(3)]
        return ((loc[0] > xlo) & (loc[0] < xhi) & (loc[1].abs() < yabs)
                & (loc[2].abs() < zabs))

    return _select_plain(xyz, ss, seed, centers.shape[1], K, CROP_WIN,
                         CROP_SPW, False, test)


# ---------------------------------------------------------------------------
# Slab 3-NN (FP-layer interpolation search)
# ---------------------------------------------------------------------------


class SlabNN(NamedTuple):
    """K8's outputs: the 3-NN over each tile's span (`idx` [B, Nq, 3] int32,
    `d2` [B, Nq, 3] ascending), the certificate (`proven` [B] bool, and on
    the card `fallback` [1] int32, 1 where any cloud is unproven), the span
    table `ss` [B, T, 2] int32 and the certificate's x bounds `lr`
    [B, T, 2] f32 (the nearest unscanned key on the left and the right)."""
    idx: torch.Tensor
    d2: torch.Tensor
    proven: torch.Tensor
    fallback: torch.Tensor | None
    ss: torch.Tensor
    lr: torch.Tensor


def flat_steps(batch: int, tiles: int) -> int:
    """G, the (tile, block) pairs of K8's flat grid (JAX ``slab.py:899``)."""
    return batch * tiles * 5 // 2


def flat_grid_span(batch: int, tiles: int, cap: int, nkb: int) -> int:
    """The blocks a tile of K8 flat's scan grid: room for the longest span
    the flat grid can take (every other tile keeps one block of G) and for
    the clamped spans of its fallback."""
    return max(cap, min(nkb, flat_steps(batch, tiles) - batch * tiles + 1))


def three_nn_spans(query: torch.Tensor, key: torch.Tensor, bound: float,
                   grid_span: int = 3, flat: bool = False):
    """Plain PyTorch version of K8's span table: the key-block span
    [start, stop) of every 256-query tile, the keys with x within the
    tile's x-range widened by `bound`, clamped to `grid_span` blocks and
    recentred on the slab (JAX ``slab.py:805-835``); and the x of the
    nearest unscanned key on either side, -1e38 / 1e38 past the ends (the
    certificate's bounds, ``slab.py:904-915``).  With `flat` (K8 flat),
    the unclamped spans where their lengths sum to at most `flat_steps`
    and the clamp leaves out a block (JAX ``slab.py:892-901``), else the
    clamped ones.  Returns (ss [B, T, 2] int32, lr [B, T, 2] f32)."""
    B, Nq, _ = query.shape
    NK = key.shape[1]
    nkb = n_scan_blocks_k(NK)
    qt = _pad_queries(query[..., :1], _TM_K, 1e10)[..., 0]
    T = qt.shape[1] // _TM_K
    lo, hi = _tile_range(qt.reshape(B, T, _TM_K), bound)
    kx = key[..., 0].contiguous()
    srow = torch.searchsorted(kx, lo.contiguous(), right=False)
    erow = torch.searchsorted(kx, hi.contiguous(), right=True)
    start = torch.clamp(srow // _SCAN_K, 0, nkb - 1)
    stop = torch.clamp(torch.maximum(-(-erow // _SCAN_K), start + 1),
                       max=nkb)
    cap = min(grid_span, nkb)
    if cap < nkb and not (flat and int((stop - start).sum())
                          <= flat_steps(B, T)):
        mid = (srow + erow) // (2 * _SCAN_K)
        s_ctr = torch.clamp(mid - cap // 2, 0, nkb - cap)
        start_c = torch.where(stop - start > cap, s_ctr, start)
        stop = torch.minimum(stop, start_c + cap)
        start = start_c
    left_row = start * _SCAN_K - 1
    right_row = stop * _SCAN_K
    big = torch.full((), _BIG, dtype=torch.float32, device=kx.device)
    left_x = torch.where(left_row >= 0,
                         torch.gather(kx, 1, left_row.clamp(min=0)), -big)
    right_x = torch.where(right_row < NK,
                          torch.gather(kx, 1, right_row.clamp(max=NK - 1)),
                          big)
    return (torch.stack([start, stop], -1).to(torch.int32),
            torch.stack([left_x, right_x], -1))


def three_nn_certificate(query: torch.Tensor, d2: torch.Tensor,
                         lr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8's certificate -> proven [B]: every
    query's third distance is no larger than the squared x-gap to the
    nearest key outside its tile's span (`lr`), the gap clamped at 0 (a
    clamped span can leave a query outside its tile's window)."""
    tile = torch.arange(query.shape[1], device=query.device) // _TM_K
    qx = query[..., 0]
    margin = torch.minimum(qx - lr[:, tile, 0], lr[:, tile, 1] - qx)
    margin = margin.clamp(min=0.0)
    return (d2[..., 2] <= margin * margin).all(-1)


def three_nn_slab_grid(batch: int, tiles: int, cap: int, sms: int,
                       threads: int, max_per_thread: int) -> tuple:
    """(Q, parts): queries a thread and parts of a key block of K8's scan,
    for `batch` x `tiles` query tiles of 256 and spans of at most `cap`
    blocks, on a card of `sms` SMs and blocks of `threads` threads, Q up
    to `max_per_thread` (a power of 2).

    The rule of K3's `knn.split_grid`, counted over the span: Q is the
    most queries a thread whose blocks (256 / (threads * Q) a tile) alone
    put one on every SM, else 1; parts is the fewest of 1, 2 and 4 (at
    least `knn.MIN_RANGE_KEYS` keys each) that give `NN_BLOCKS_PER_SM`
    blocks a SM, counting `cap` blocks a tile (the span table is on the
    card, so the blocks past a span's stop are launched and return at
    once)."""
    if min(batch, tiles, cap) < 1:
        raise ValueError(f"three_nn_slab: empty grid {batch}, {tiles}, "
                         f"{cap}")
    q = max_per_thread
    while q > 1 and batch * tiles * (_TM_K // (threads * q)) < sms:
        q //= 2
    blocks = batch * tiles * (_TM_K // (threads * q)) * cap
    parts = 1
    while (parts < _SCAN_K // knn.MIN_RANGE_KEYS
           and blocks * parts < NN_BLOCKS_PER_SM * sms):
        parts *= 2
    return q, parts


def three_nn_slab(query: torch.Tensor, key: torch.Tensor,
                  bound: float = 0.06, grid_span: int = 3,
                  flat: bool = False):
    """Kernel K8: the 3 nearest keys per query among the keys of its
    tile's span (`three_nn_spans`); with `flat`, K8 flat: the unclamped
    spans where they are few enough (JAX's flat grid).

    query [B, Nq, 3] (x-sorted for tile locality), key [B, NK, 3] x-ascending.
    Returns (index [B, Nq, 3] int32 into key rows, d2 [B, Nq, 3] ascending
    diff-square distances, proven [B] bool).  `proven` certifies the result:
    every query's third distance is no larger than the squared x-gap to the
    nearest key outside the scanned span.  Where it is False the caller
    runs the full scan (`models/backbone.py` does so on the card without
    reading it).  CPU tensors take the plain versions."""
    r = three_nn_slab_call(query, key, bound, grid_span, flat=flat)
    return r.idx, r.d2, r.proven


def three_nn_slab_call(query: torch.Tensor, key: torch.Tensor,
                       bound: float = 0.06, grid_span: int = 3,
                       count: torch.Tensor | None = None,
                       flat: bool = False) -> SlabNN:
    """K8 with all its outputs (`SlabNN`).  On the card, three launches
    counted as one (span table; scan; merge and certificate) and no host
    sync; `count` (int64 [1] on the card) gains one where the call's
    certificate fails.  With `flat` and a clamp that leaves out a block,
    K8 flat (its own count): the span launch also adds up the unclamped
    spans, and the scan and merge read that total on the card and take
    the unclamped spans where it is at most `flat_steps`; `ss` and `lr`
    come back as the spans scanned.  CPU tensors take `three_nn_spans`,
    `three_nn_slab_plain` and `three_nn_certificate`."""
    query = query.float().contiguous()
    key = key.float().contiguous()
    B, Nq, _ = query.shape
    NK = key.shape[1]
    if Nq == 0 or NK == 0:
        raise ValueError(f"three_nn_slab: empty input {Nq}, {NK}")
    if query.device.type == "cpu":
        ss, lr = three_nn_spans(query, key, bound, grid_span, flat)
        idx, d2 = three_nn_slab_plain(query, key, ss)
        return SlabNN(idx, d2, three_nn_certificate(query, d2, lr), None, ss,
                      lr)
    _cuda.check(query, "three_nn_slab query", torch.float32, (B, Nq, 3))
    _cuda.check(key, "three_nn_slab key", torch.float32, (B, NK, 3))
    dev = query.device
    T = -(-Nq // _TM_K)
    nkb = n_scan_blocks_k(NK)
    cap = min(grid_span, nkb)
    flat = flat and cap < nkb          # JAX: flat does nothing otherwise
    gcap = flat_grid_span(B, T, cap, nkb) if flat else cap
    q, parts = three_nn_slab_grid(B, T, gcap, _cuda.sm_count(dev),
                                  *knn.limits(dev))
    ss = torch.empty(B, T, 2, dtype=torch.int32, device=dev)
    lr = torch.empty(B, T, 2, dtype=torch.float32, device=dev)
    pidx = torch.empty(B, gcap * parts, 3, T * _TM_K, dtype=torch.int32,
                       device=dev)
    pd2 = torch.empty(B, gcap * parts, 3, T * _TM_K, dtype=torch.float32,
                      device=dev)
    idx = torch.empty(B, Nq, 3, dtype=torch.int32, device=dev)
    d2 = torch.empty(B, Nq, 3, dtype=torch.float32, device=dev)
    proven = torch.empty(B, dtype=torch.bool, device=dev)
    fallback = torch.empty(1, dtype=torch.int32, device=dev)
    if flat:
        ssu = torch.empty(B, T, 2, dtype=torch.int32, device=dev)
        lru = torch.empty(B, T, 2, dtype=torch.float32, device=dev)
        total = torch.empty(1, dtype=torch.int32, device=dev)
        _cuda.launch("three_nn_slab_flat", dev, query, key, ss, lr, ssu, lru,
                     total, pidx, pd2, idx, d2, proven, fallback, count, B,
                     Nq, NK, bound, cap, gcap, q, parts)
    else:
        _cuda.launch("three_nn_slab", dev, query, key, ss, lr, pidx, pd2,
                     idx, d2, proven, fallback, count, B, Nq, NK, bound, cap,
                     q, parts)
    return SlabNN(idx, d2, proven, fallback, ss, lr)


def three_nn_slab_plain(query: torch.Tensor, key: torch.Tensor,
                        ss: torch.Tensor):
    """Plain PyTorch version of K8: per tile, the three smallest
    (diff-square distance, index) pairs over the span's keys; an empty slot
    holds (1e38, 0)."""
    B, Nq, _ = query.shape
    NK = key.shape[1]
    idx = torch.zeros(B, Nq, 3, dtype=torch.int32, device=query.device)
    d2 = torch.full((B, Nq, 3), _BIG, dtype=torch.float32,
                    device=query.device)
    big = torch.tensor(_BIG, dtype=torch.float32, device=query.device)
    spans = ss.cpu().tolist()
    for b in range(B):
        for t, (start, stop) in enumerate(spans[b]):
            q0, q1 = t * _TM_K, min((t + 1) * _TM_K, Nq)
            r0, r1 = start * _SCAN_K, min(stop * _SCAN_K, NK)
            k, q = key[b, r0:r1], query[b, q0:q1]
            d = [k[None, :, i] - q[:, None, i] for i in range(3)]
            dd = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
            if dd.shape[1] < 3:
                dd = torch.nn.functional.pad(dd, (0, 3 - dd.shape[1]),
                                             value=_BIG)
            i, v = _smallest_k(dd, 3, _BIG)
            found = v < big
            idx[b, q0:q1] = torch.where(found, i + r0, 0)
            d2[b, q0:q1] = torch.where(found, v, big)
    return idx, d2


# ---------------------------------------------------------------------------
# Gather + max over slab-structured indices
# ---------------------------------------------------------------------------


def gather_max_slab(fs: torch.Tensor, index: torch.Tensor,
                    off_blk: torch.Tensor, win: int, spw: int
                    ) -> torch.Tensor:
    """Kernel K9: ``max_k fs[b, index[b, s, k], c]`` over the covered
    slots.

    fs [B, N, C] features in slab order; index [B, S, K] from `group_slab`
    (win 128, spw 4) or `crop_slab` (win 256, spw 1); off_blk [B, T] their
    span origins.  Slot ``j = kc*rps + w*spw + s`` is covered when its row
    lies in its own window ``[(off + kc)*2048 + w*win, +win)``; every fill
    value is also some slot's own pick, so skipping uncovered slots changes
    no maximum.  A query with no covered slot pools to -1e38 in `fs`'s
    dtype (bf16(-1e38) for bf16 rows, as JAX's ``jnp.full(..., -_BIG,
    dtype)``).  bf16 rows take K9's bf16 form, ``gather_max_slab_bf16``.
    CPU tensors take the plain versions.

    When `fs` needs a gradient the argmax form runs and the backward adds
    each ``g[b, s, c]`` to the winner's row, the lowest covered slot holding
    the maximum (JAX ``gather_max_slab_vjp``, ``slab.py:1084-1110``).  A
    query with no covered slot sends its gradient to row 0: mask it, as the
    model does with ``torch.where``.  bf16 rows take the bf16 argmax form,
    ``gather_max_slab_argmax_bf16`` (JAX ``slab.py:996-1010``), and the
    bf16 backward of `pooling.scatter_winner`."""
    if torch.is_grad_enabled() and fs.requires_grad:
        return _GatherMaxSlab.apply(fs, index, off_blk, win, spw)
    off_blk = _check_gmax_slab(fs, index, off_blk, win, spw)
    if fs.device.type == "cpu":
        return gather_max_slab_plain(fs, index, off_blk, win, spw)
    (B, N, C), (S, K) = fs.shape, index.shape[1:]
    out = torch.empty(B, S, C, dtype=fs.dtype, device=fs.device)
    if fs.dtype == torch.float32:
        _cuda.launch("gather_max_slab", fs.device, fs, index, off_blk, out,
                     B, N, C, S, K, win, spw)
    else:    # 4 channels a thread, as the f32 form
        _cuda.launch("gather_max_slab_bf16", fs.device, fs, index, off_blk,
                     out, B, N, C, S, K, win, spw, 4)
    return out


def gather_max_slab_argmax(fs: torch.Tensor, index: torch.Tensor,
                           off_blk: torch.Tensor, win: int, spw: int):
    """K9's argmax form -> (pooled [B, S, C] in `fs`'s dtype, winner
    [B, S, C] int32, 0 for a query with no covered slot).  CPU tensors take
    `gather_max_slab_argmax_plain`.  No gradient: `gather_max_slab` is the
    differentiable entry."""
    off_blk = _check_gmax_slab(fs, index, off_blk, win, spw)
    if fs.device.type == "cpu":
        return gather_max_slab_argmax_plain(fs, index, off_blk, win, spw)
    (B, N, C), (S, K) = fs.shape, index.shape[1:]
    out = torch.empty(B, S, C, dtype=fs.dtype, device=fs.device)
    winner = torch.empty(B, S, C, dtype=torch.int32, device=fs.device)
    _cuda.launch(kernel_name("gather_max_slab_argmax", fs.dtype), fs.device,
                 fs, index, off_blk, out, winner, B, N, C, S, K, win, spw)
    return out, winner


class _GatherMaxSlab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fs, index, off_blk, win, spw):
        pooled, winner = gather_max_slab_argmax(fs, index, off_blk, win, spw)
        ctx.save_for_backward(winner)
        ctx.n = fs.shape[1]
        return pooled

    @staticmethod
    def backward(ctx, g):
        (winner,) = ctx.saved_tensors
        return scatter_winner(g, winner, ctx.n), None, None, None, None


def _check_gmax_slab(fs, index, off_blk, win, spw) -> torch.Tensor:
    """Validate K9's arguments (`fs` f32 or bf16 on the card); returns
    `off_blk` as contiguous int32."""
    B, N, C = fs.shape
    S, K = index.shape[1:]
    rps = (_SCAN // win) * spw
    if K % rps or K == 0 or S == 0:
        raise ValueError(f"gather_max_slab: K={K} slots for {rps} per block")
    T = -(-S // _TM)
    off_blk = off_blk.to(torch.int32).contiguous()
    if off_blk.shape != (B, T):
        raise ValueError(f"gather_max_slab: off_blk {tuple(off_blk.shape)}, "
                         f"expected {(B, T)}")
    if fs.device.type != "cpu":
        if fs.dtype not in DTYPES:
            raise ValueError(f"gather_max_slab fs: expected one of {DTYPES}, "
                             f"got {fs.dtype}")
        _cuda.check(fs, "gather_max_slab fs", fs.dtype, (B, N, C))
        _cuda.check(index, "gather_max_slab index", torch.int32, (B, S, K))
        align = 4 * fs.element_size()
        if C % 4 or fs.data_ptr() % align:
            raise ValueError(f"gather_max_slab: the kernel reads 4 channels "
                             f"a load: C={C} must be a multiple of 4 and fs "
                             f"{align}-byte aligned")
    return off_blk


def slab_cover(index: torch.Tensor, off_blk: torch.Tensor, win: int,
               spw: int) -> torch.Tensor:
    """[B, S, K] bool: the slots `gather_max_slab` pools over."""
    B, S, K = index.shape
    rps = (_SCAN // win) * spw
    j = torch.arange(K, device=index.device)
    off = off_blk.long().repeat_interleave(_TM, dim=1)[:, :S]
    base = ((off[..., None] + j // rps) * _SCAN + (j % rps) // spw * win)
    row = index.long()
    return (row >= base) & (row < base + win)


def gather_max_slab_plain(fs, index, off_blk, win, spw, chunk: int = 512):
    """Plain PyTorch version of K9: gather, mask the uncovered slots to
    -1e38, max over K."""
    cover = slab_cover(index, off_blk, win, spw)
    neg = torch.tensor(-_BIG, dtype=fs.dtype, device=fs.device)
    out = []
    for i, c in zip(torch.split(index, chunk, 1),
                    torch.split(cover, chunk, 1)):
        out.append(torch.where(c[..., None], group_points(fs, i),
                               neg).amax(2))
    return torch.cat(out, 1)


def gather_max_slab_argmax_plain(fs, index, off_blk, win, spw,
                                 chunk: int = 512):
    """Plain PyTorch version of K9's argmax form: the first maximal covered
    slot's row; (-1e38, 0) for a query with no covered slot."""
    cover = slab_cover(index, off_blk, win, spw)
    neg = torch.tensor(-_BIG, dtype=fs.dtype, device=fs.device)
    pooled, winner = [], []
    for i, c in zip(torch.split(index, chunk, 1),
                    torch.split(cover, chunk, 1)):
        g = torch.where(c[..., None], group_points(fs, i), neg)
        am = torch.argmax(g, dim=2, keepdim=True)
        rows = torch.gather(
            i.long()[..., None].expand(-1, -1, -1, g.shape[-1]), 2, am)
        pooled.append(torch.gather(g, 2, am)[:, :, 0])
        winner.append(torch.where(c.any(-1)[..., None], rows[:, :, 0], 0))
    return torch.cat(pooled, 1), torch.cat(winner, 1).to(torch.int32)
