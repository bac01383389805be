"""Index gathers for point grouping (JAX ``ops/grouping.py``),
channels-last."""

from __future__ import annotations

import torch


def gather_points(points: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], index [B, S] -> [B, S, C]."""
    C = points.shape[-1]
    return torch.gather(points, 1,
                        index.long()[..., None].expand(-1, -1, C))


def group_points(points: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], index [B, S, K] -> [B, S, K, C]."""
    B, S, K = index.shape
    return gather_points(points, index.reshape(B, S * K)).reshape(
        B, S, K, -1)
