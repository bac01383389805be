"""The grid of the center-tiled bucket scan that K11 (``ops/group.py``), K5
(``ops/crop.py``) and K2 (``ops/ball_query.py``) share
(``csrc/bucket_scan.cuh``).

A block of 8 warps owns a tile of centers, C per warp, and a range of
buckets whose columns it stages in shared memory; a fill pass then sums the
blocks' partial counts and fills the empty buckets.  `scan_grid` is the
pure rule that picks the tile and the range; `scan_args` applies it on a
card and allocates the partial counts.  C and the most columns a block may
stage are the kernel's own constants, read from its library (`limits`).
"""

from __future__ import annotations

import torch

from regnet_for_3d_grasping_torch.ops import _cuda

# blocks per SM the range aims at: enough that the last blocks of a call
# spread its tail thinly, few enough that a warp walks several buckets
BLOCKS_PER_SM = 8


def scan_grid(batch: int, m: int, n: int, k: int, bucket: int, sms: int,
              per_warp: int, stage_cols: int) -> tuple:
    """(tile, range): centers and buckets per block for `batch` clouds of
    `n` columns in `k` buckets of `bucket`, `m` centers each, `per_warp`
    centers per warp, on a card of `sms` SMs.  The largest tile (8 warps'
    worth, the least traffic: each tile reads the cloud once) whose grid
    fills every SM at least once, with as many buckets per block as still
    give about `BLOCKS_PER_SM` blocks per SM and fit `stage_cols` staged
    columns; where no tile fills the card, the smallest, one bucket a block
    (the most blocks).  A bucket wider than `stage_cols` takes a block of
    its own, which stages it in windows.  `bucket` must be a positive
    multiple of 32."""
    if k * bucket < n or bucket % 32 or bucket < 32:
        raise ValueError(f"bucket scan: K={k} buckets of L={bucket} must "
                         f"cover N={n}, L a positive multiple of 32")
    nb = -(-n // bucket)                 # buckets that hold a column
    r_max = max(1, min(nb, stage_cols // bucket))
    for groups in (8, 4, 2, 1):
        tile = groups * per_warp
        tiles = batch * -(-m // tile)
        rng = max(1, min(r_max, tiles * nb // (BLOCKS_PER_SM * sms)))
        if tiles * -(-nb // rng) >= sms:
            return tile, rng
    return per_warp, 1


def ranges(n: int, bucket: int, rng: int) -> int:
    """Bucket ranges of a grid: the partial counts per center."""
    return -(-(-(-n // bucket)) // rng)


def limits(kernel: str, device: torch.device) -> tuple:
    """(centers per warp, most staged columns) of `kernel` ("group_regions",
    "crop" or "ball_query"), from its library's uncounted queries."""
    return (_cuda.constant(f"{kernel}_per_warp", device),
            _cuda.constant(f"{kernel}_stage_cols", device))


def scan_args(kernel: str, xyz: torch.Tensor, m: int, k: int,
              bucket: int) -> tuple:
    """(tile, range, partial counts [B, m, ranges] int32) of one call of
    `kernel` on xyz's card."""
    B, N, _ = xyz.shape
    tile, rng = scan_grid(B, m, N, k, bucket, _cuda.sm_count(xyz.device),
                          *limits(kernel, xyz.device))
    partial = torch.empty(B, m, ranges(N, bucket, rng), dtype=torch.int32,
                          device=xyz.device)
    return tile, rng, partial
