"""Gripper closing-region crop, the fused form (JAX ``ops/crop_pallas.py``).

Kernel K5 (``csrc/crop.cu``, the center-tiled bucket scan of
``csrc/bucket_scan.cuh`` with a box test; grid by
`ops.bucket_scan.scan_grid`) and its plain version `crop_plain`.  For each
proposal m and bucket b of L points: move every point into the gripper
frame, test the closing box, and pick the inside point with the largest
23-bit counter-hash noise (first index on ties); the count of inside
points is exact.  The hash is the TPU kernel's (``crop_pallas.py:70-80``),
keyed by the proposal's row in its batch element, the point index and a
u32 seed, so the kernel and the JAX package pick the same points.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.regnet_ref.ops.sampling import fill_empty_buckets

_U32 = 0xFFFFFFFF


def closing_region_crop(xyz: torch.Tensor, frames: torch.Tensor,
                        centers: torch.Tensor, seed: int, box: tuple,
                        K: int, L: int):
    """Kernel K5: xyz [B, N, 3], frames [B, M, 3, 3] (columns = gripper
    axes), centers [B, M, 3] f32, u32 seed, box (xlo, xhi, |y|max, |z|max)
    -> (index [B, M, K] int32, 0 for a row with no inside point; count
    [B, M] int32).  CPU tensors take `crop_plain`."""
    return crop_plain(xyz, frames, centers, seed, box, K, L)


def crop_plain(xyz, frames, centers, seed, box, K, L, chunk=256):
    """Plain PyTorch version of K5: ``loc_j = (F0j*r0 + F1j*r1) + F2j*r2``
    with r = x - center, then the box test and the hash pick."""
    B, N, _ = xyz.shape
    xlo, xhi, yabs, zabs = (float(np.float32(v)) for v in box)
    col = torch.arange(K * L, device=xyz.device)
    col_h = (col * 2654435761) & _U32
    idx, cnt = [], []
    for m0 in range(0, frames.shape[1], chunk):
        f = frames[:, m0:m0 + chunk]
        c = centers[:, m0:m0 + chunk]
        r = [xyz[:, None, :, i] - c[:, :, None, i] for i in range(3)]
        loc = [(f[:, :, 0, j, None] * r[0] + f[:, :, 1, j, None] * r[1])
               + f[:, :, 2, j, None] * r[2] for j in range(3)]
        inside = ((loc[0] > xlo) & (loc[0] < xhi)
                  & (loc[1].abs() < yabs) & (loc[2].abs() < zabs))
        inside = torch.nn.functional.pad(inside, (0, K * L - N))
        rows = torch.arange(m0, m0 + f.shape[1], device=xyz.device)
        h = ((rows[:, None] * 0x9E3779B9 + (int(seed) & _U32)) & _U32
             ) + col_h[None, :]
        h = h & _U32
        h = h ^ (h >> 16)
        h = (h * 0x45D9F3B) & _U32
        h = h ^ (h >> 16)
        key = torch.where(inside, (h >> 9)[None], -1).reshape(
            B, -1, K, L)
        win = torch.arange(K, device=xyz.device) * L + torch.argmax(key, -1)
        any_b = key.amax(-1) >= 0
        idx.append(fill_empty_buckets(torch.where(any_b, win, -1), any_b))
        cnt.append(inside.sum(-1, dtype=torch.int32))
    return torch.cat(idx, 1), torch.cat(cnt, 1)
