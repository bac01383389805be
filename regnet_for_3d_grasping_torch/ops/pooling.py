"""Max over gathered rows (JAX ``ops/pooling.py``), forward only.

Every call goes to kernel K4 (``csrc/gather_max.cu``) on a CUDA tensor: a
max is a max, so the JAX package's Pallas/XLA split (which keeps the f32
refine pool on XLA, ``pooling.py:53-54``) changes no value.  The bucket
structure the TPU kernel needs is not needed by a direct gather, so there
is no `stride` argument.
"""

from __future__ import annotations

import torch

from regnet_for_3d_grasping_torch.ops import _cuda
from regnet_for_3d_grasping_torch.ops.grouping import group_points


def gather_max(feature: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Kernel K4: feature [B, N, C] f32, index [B, S, K] with values in
    [0, N) -> [B, S, C] = max_k feature[b, index[b, s, k], c].  CPU tensors
    take `gather_max_plain`."""
    if feature.device.type == "cpu":
        return gather_max_plain(feature, index)
    B, N, C = feature.shape
    S, K = index.shape[1:]
    _cuda.check(feature, "gather_max feature", torch.float32, (B, N, C))
    _cuda.check(index, "gather_max index", torch.int32, (B, S, K))
    if K == 0 or S == 0:
        raise ValueError(f"gather_max: empty index {tuple(index.shape)}")
    out = torch.empty(B, S, C, dtype=feature.dtype, device=feature.device)
    _cuda.launch("gather_max", feature.device, feature, index, out, B, N, C,
                 S, K)
    return out


def gather_max_plain(feature: torch.Tensor, index: torch.Tensor,
                     chunk: int = 512) -> torch.Tensor:
    """Plain PyTorch version of K4: gather, then amax over K."""
    return torch.cat([group_points(feature, i).amax(dim=2)
                      for i in torch.split(index, chunk, dim=1)], dim=1)
