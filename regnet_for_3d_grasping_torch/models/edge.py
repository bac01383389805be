"""EdgeConv set abstraction and feature propagation (JAX
``models/edge.py``, the reference's EdgeSAModule and EdgeFPModule).  No
model path builds them; they complete the PointNet++ library.

Each neighbourhood feature goes to the MLP beside its difference from the
centroid's feature (SA) or from the interpolated feature (FP).  State
names are the JAX package's (``mlp.layer{j}``), so `weights.load_into`
carries flax variables across.  At a bf16 compute dtype the promotions
are the backbone's: the relative xyz and the 3-NN interpolation stay f32,
and a concatenation with them is f32 until the MLP rounds it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from regnet_for_3d_grasping_torch.nn.layers import SharedMLP
from regnet_for_3d_grasping_torch.ops.ball_query import ball_query
from regnet_for_3d_grasping_torch.ops.fps import farthest_point_sample
from regnet_for_3d_grasping_torch.ops.grouping import (gather_points,
                                                       group_points)
from regnet_for_3d_grasping_torch.ops.knn import (interpolation_weights,
                                                  three_interpolate, three_nn)


class EdgeSetAbstraction(nn.Module):
    """FPS -> ball query -> concat(relative xyz, neighbour feature,
    neighbour feature - centroid feature) -> MLP -> max over neighbours
    (JAX ``models/edge.py:31-66``)."""

    def __init__(self, in_channels: int, num_centroids: int, radius: float,
                 num_neighbours: int, mlp_channels: Sequence[int],
                 dtype: torch.dtype = torch.float32,
                 ball_query_method: str = "bucket"):
        super().__init__()
        self.num_centroids = num_centroids
        self.radius = radius
        self.num_neighbours = num_neighbours
        self.ball_query_method = ball_query_method
        self.mlp = SharedMLP(3 + 2 * in_channels, mlp_channels, dtype=dtype)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor | None):
        """xyz [B,N,3], feature [B,N,C] -> (new_xyz [B,S,3], [B,S,C'])."""
        idx = farthest_point_sample(xyz, self.num_centroids)
        new_xyz = gather_points(xyz, idx)
        nidx, _ = ball_query(xyz, new_xyz, self.radius, self.num_neighbours,
                             method=self.ball_query_method)
        group = group_points(xyz, nidx) - new_xyz[:, :, None, :]
        if feature is not None:
            neighbour = group_points(feature, nidx)
            edge = neighbour - gather_points(feature, idx)[:, :, None, :]
            group = torch.cat([group, neighbour, edge], -1)
        return new_xyz, self.mlp(group, max_over=2)


class EdgeFeaturePropagation(nn.Module):
    """3-NN interpolation, then per neighbour concat(interpolated,
    neighbour - interpolated[, skip]) -> MLP -> mean over the neighbours
    (JAX ``models/edge.py:69-101``)."""

    def __init__(self, in_channels: int, mlp_channels: Sequence[int],
                 num_neighbours: int = 3,
                 dtype: torch.dtype = torch.float32):
        """`in_channels`: the sparse features' channels twice, plus the
        skip's."""
        super().__init__()
        self.num_neighbours = num_neighbours
        self.mlp = SharedMLP(in_channels, mlp_channels, dtype=dtype)

    def forward(self, dense_xyz, sparse_xyz, dense_feature, sparse_feature):
        idx, d2 = three_nn(dense_xyz, sparse_xyz, self.num_neighbours)
        interp = three_interpolate(sparse_feature, idx,
                                   interpolation_weights(d2))
        neighbour = group_points(sparse_feature, idx)      # [B, N1, K, C2]
        interp = interp[:, :, None, :].expand(neighbour.shape)
        parts = [interp, neighbour - interp]
        if dense_feature is not None:
            parts.append(dense_feature[:, :, None, :].expand(
                *dense_feature.shape[:2], self.num_neighbours,
                dense_feature.shape[-1]))
        return self.mlp(torch.cat(parts, -1)).mean(dim=2)
