"""Index gathers for point grouping (JAX ``ops/grouping.py``),
channels-last."""

from __future__ import annotations

import torch


def gather_points(points: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], index [B, S] -> [B, S, C].

    Rows are picked by indexing, not by `torch.gather` on an index expanded
    over the channels: in deterministic mode (the train CLI) the backward
    then sorts B*S row indices and adds whole rows in order, where
    `gather`'s would sort all B*S*C entries."""
    batch = torch.arange(points.shape[0], device=points.device)[:, None]
    return points[batch, index.long()]


def group_points(points: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], index [B, S, K] -> [B, S, K, C]."""
    B, S, K = index.shape
    return gather_points(points, index.reshape(B, S * K)).reshape(
        B, S, K, -1)
