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



# blocks per SM the range aims at: enough that the last blocks of a call
# spread its tail thinly, few enough that a warp walks several buckets
BLOCKS_PER_SM = 8


