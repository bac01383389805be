"""k-nearest-neighbour search and inverse-distance interpolation (JAX
``ops/knn.py`` + ``ops/knn_pallas.py``).

Large k=3 searches (FP3) go to kernel K3 (``csrc/three_nn.cu``, diff-square
distances, the keys split into ranges on the grid of `split_grid`) where
`use_kernel` holds, as the JAX package sends them to its Pallas kernel on
the TPU; the rest take the plain expansion-form path.
"""

from __future__ import annotations

import torch

from portbench.reference.regnet_ref.ops.distances import bpdist2
from portbench.reference.regnet_ref.ops.grouping import group_points

# N1*N2 at or above which the JAX package runs the Pallas 3-NN on the TPU
# (regnet_for_3d_grasping_tpu/ops/knn.py:44), for k == 3 only
KERNEL_MIN_WORK = 1 << 24

_INF = 3e38   # the TPU kernel's "no neighbour" distance

# K3's grid, from its grid sweeps on the H100 (PERF.md): the blocks per SM
# that the key split aims at, the fewest ranges for keys sorted in x, and
# the fewest keys a range holds
BLOCKS_PER_SM = 6
SORTED_MIN_RANGES = 6
MIN_RANGE_KEYS = 256


def use_kernel(n1: int, n2: int, k: int) -> bool:
    return k == 3 and n1 * n2 >= KERNEL_MIN_WORK


def three_nn(query: torch.Tensor, key: torch.Tensor, k: int = 3,
             chunk: int = 8192, sorted_keys: bool = False):
    """query [B, N1, 3], key [B, N2, 3] -> (index [B, N1, k] int32,
    squared distance [B, N1, k] ascending).  `sorted_keys`: the keys are
    sorted in x (K3's grid then splits them further)."""
    query = query.float().contiguous()
    key = key.float().contiguous()
    if use_kernel(query.shape[1], key.shape[1], k):
        return three_nn_kernel(query, key, sorted_keys)
    idx, dist = [], []
    for q in torch.split(query, chunk, dim=1):
        i, d = _smallest_k(bpdist2(q, key), k, torch.inf)
        idx.append(i)
        dist.append(d)
    return torch.cat(idx, 1), torch.cat(dist, 1)


def _smallest_k(d2: torch.Tensor, k: int, fill: float):
    """k first-index argmin extractions along the last axis (JAX
    ``knn.py:57-67``)."""
    out_i, out_d = [], []
    for _ in range(k):
        i = torch.argmin(d2, dim=-1, keepdim=True)
        out_i.append(i)
        out_d.append(torch.gather(d2, -1, i))
        d2 = d2.scatter(-1, i, fill)
    return (torch.cat(out_i, -1).to(torch.int32), torch.cat(out_d, -1))


def three_nn_kernel(query: torch.Tensor, key: torch.Tensor,
                    sorted_keys: bool = False,
                    fallback: torch.Tensor | None = None, out=None):
    """Kernel K3: the three smallest (diff-square distance, index) pairs
    per query, ascending, ties to the smaller index.  The keys split into
    the ranges of `split_grid` (`sorted_keys`: sorted in x), and a merge
    where there is more than one: 1 or 2 launches counted as one.

    With `fallback` (a device int32 [1], K8's flag) and `out` (idx, dist),
    the launches write `out` where the flag holds 1 and return at once
    where it holds 0, read on the card.  CPU tensors take
    `three_nn_plain`."""
    return three_nn_plain(query, key)


def three_nn_where(fallback: torch.Tensor, query: torch.Tensor,
                   key: torch.Tensor, idx: torch.Tensor, dist: torch.Tensor,
                   sorted_keys: bool = False):
    """`three_nn(query, key)` in place of (idx, dist) where the device
    flag `fallback` (int32 [1]) holds 1, with no host read: K3 where
    `use_kernel` holds, its launches reading the flag on the card; below
    it, the plain path's result chosen by ``torch.where``."""
    query = query.float().contiguous()
    key = key.float().contiguous()
    if use_kernel(query.shape[1], key.shape[1], 3):
        return three_nn_kernel(query, key, sorted_keys, fallback,
                               (idx, dist))
    full = three_nn(query, key)
    on = fallback.bool()
    return torch.where(on, full[0], idx), torch.where(on, full[1], dist)


def three_nn_plain(query: torch.Tensor, key: torch.Tensor,
                   chunk: int = 2048):
    """Plain PyTorch version of K3: diff-square distances summed as
    ((dx^2 + dy^2) + dz^2), three first-index argmin extractions."""
    idx, dist = [], []
    for q in torch.split(query, chunk, dim=1):
        d = [key[:, None, :, i] - q[:, :, None, i] for i in range(3)]
        i, dd = _smallest_k((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2], 3,
                            _INF)
        idx.append(i)
        dist.append(dd)
    return torch.cat(idx, 1), torch.cat(dist, 1)


def three_interpolate(feature: torch.Tensor, index: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """feature [B, N2, C], index/weight [B, N1, k] -> [B, N1, C]."""
    return (group_points(feature, index) * weight[..., None]).sum(2)


def interpolation_weights(distance: torch.Tensor,
                          eps: float = 1e-10) -> torch.Tensor:
    """Inverse squared-distance weights, normalized."""
    inv = 1.0 / torch.clamp(distance, min=eps)
    return inv / inv.sum(-1, keepdim=True)
