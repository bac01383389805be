"""k-nearest-neighbour search and inverse-distance interpolation (JAX
``ops/knn.py`` + ``ops/knn_pallas.py``).

Large k=3 searches (FP3) go to kernel K3 (``csrc/three_nn.cu``, diff-square
distances) where `use_kernel` holds, as the JAX package sends them to its
Pallas kernel on the TPU; the rest take the plain expansion-form path.
"""

from __future__ import annotations

import torch

from regnet_for_3d_grasping_torch.ops import _cuda
from regnet_for_3d_grasping_torch.ops.distances import bpdist2
from regnet_for_3d_grasping_torch.ops.grouping import group_points

# N1*N2 at or above which the JAX package runs the Pallas 3-NN on the TPU
# (regnet_for_3d_grasping_tpu/ops/knn.py:44), for k == 3 only
KERNEL_MIN_WORK = 1 << 24

_INF = 3e38   # the TPU kernel's "no neighbour" distance


def use_kernel(n1: int, n2: int, k: int) -> bool:
    return k == 3 and n1 * n2 >= KERNEL_MIN_WORK


def three_nn(query: torch.Tensor, key: torch.Tensor, k: int = 3,
             chunk: int = 8192):
    """query [B, N1, 3], key [B, N2, 3] -> (index [B, N1, k] int32,
    squared distance [B, N1, k] ascending)."""
    query = query.float().contiguous()
    key = key.float().contiguous()
    if use_kernel(query.shape[1], key.shape[1], k):
        return three_nn_kernel(query, key)
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


def three_nn_kernel(query: torch.Tensor, key: torch.Tensor):
    """Kernel K3: the three smallest (diff-square distance, index) pairs
    per query, ascending, ties to the smaller index.  CPU tensors take
    `three_nn_plain`."""
    if query.device.type == "cpu":
        return three_nn_plain(query, key)
    B, N1, _ = query.shape
    N2 = key.shape[1]
    _cuda.check(query, "three_nn query", torch.float32, (B, N1, 3))
    _cuda.check(key, "three_nn key", torch.float32, (B, N2, 3))
    if N1 == 0 or N2 < 3:
        raise ValueError(f"three_nn: need N1 > 0 and N2 >= 3, got {N1}, {N2}")
    idx = torch.empty(B, N1, 3, dtype=torch.int32, device=query.device)
    dist = torch.empty(B, N1, 3, dtype=torch.float32, device=query.device)
    _cuda.launch("three_nn", query.device, query, key, idx, dist, B, N1, N2)
    return idx, dist


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
