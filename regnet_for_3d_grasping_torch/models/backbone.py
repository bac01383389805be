"""PointNet++ segmentation backbone (JAX ``models/backbone.py``), the
full-scan (non-slab) paths, inference only."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from regnet_for_3d_grasping_torch.config import ModelConfig
from regnet_for_3d_grasping_torch.nn.layers import BatchNorm, SharedMLP
from regnet_for_3d_grasping_torch.ops.ball_query import ball_query
from regnet_for_3d_grasping_torch.ops.fps import farthest_point_sample
from regnet_for_3d_grasping_torch.ops.grouping import (gather_points,
                                                       group_points)
from regnet_for_3d_grasping_torch.ops.knn import (interpolation_weights,
                                                  three_interpolate, three_nn)


class SetAbstraction(nn.Module):
    """FPS -> ball-query grouping -> shared MLP -> max over neighbours."""

    def __init__(self, in_channels: int, num_centroids: int, radius: float,
                 num_neighbours: int, mlp_channels: Sequence[int]):
        super().__init__()
        self.num_centroids = num_centroids
        self.radius = radius
        self.num_neighbours = num_neighbours
        self.mlp = SharedMLP(in_channels + 3, mlp_channels)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor | None):
        """xyz [B,N,3], feature [B,N,C] -> (new_xyz [B,S,3], [B,S,C'])."""
        idx = farthest_point_sample(xyz, self.num_centroids)
        new_xyz = gather_points(xyz, idx)
        nidx, _ = ball_query(xyz, new_xyz, self.radius, self.num_neighbours)
        group_feat = group_points(xyz, nidx) - new_xyz[:, :, None, :]
        if feature is not None:
            group_feat = torch.cat([group_feat, group_points(feature, nidx)],
                                   -1)
        return new_xyz, self.mlp(group_feat).amax(dim=2)


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance interpolation -> concat skip -> shared MLP."""

    def __init__(self, in_channels: int, mlp_channels: Sequence[int],
                 num_neighbours: int = 3):
        super().__init__()
        self.num_neighbours = num_neighbours
        self.mlp = SharedMLP(in_channels, mlp_channels)

    def forward(self, dense_xyz, sparse_xyz, dense_feature, sparse_feature):
        idx, d2 = three_nn(dense_xyz, sparse_xyz, self.num_neighbours)
        interp = three_interpolate(sparse_feature, idx,
                                   interpolation_weights(d2))
        if dense_feature is not None:
            interp = torch.cat([interp, dense_feature], -1)
        return self.mlp(interp)


class PointNet2Seg(nn.Module):
    """points [B,N,6] -> (feature [B,N,C_feat], score [B,N] in [0,1])."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.input_channels = cfg.input_channels
        c_in = cfg.input_channels - 3
        skip = [c_in]
        for i, (s, r, k, ch) in enumerate(zip(
                cfg.num_centroids, cfg.radii, cfg.num_neighbours,
                cfg.sa_channels)):
            self.add_module(f"sa{i}", SetAbstraction(c_in, s, r, k, ch))
            c_in = ch[-1]
            skip.append(c_in)
        for i, (ch, k) in enumerate(zip(cfg.fp_channels,
                                        cfg.num_fp_neighbours)):
            self.add_module(f"fp{i}", FeaturePropagation(
                c_in + skip[-2 - i], ch, k))
            c_in = ch[-1]
        self.seg_mlp = SharedMLP(c_in, cfg.seg_channels)
        self.score_dense = nn.Linear(cfg.seg_channels[-1], 1, bias=False)
        self.score_bn = BatchNorm(1)
        self.n_sa = len(cfg.num_centroids)
        self.n_fp = len(cfg.fp_channels)

    def forward(self, points: torch.Tensor):
        xyz = points[..., :3]
        feature = points[..., 3:self.input_channels]
        if feature.shape[-1] == 0:
            feature = None
        inter_xyz, inter_feat = [xyz], [feature]
        for i in range(self.n_sa):
            xyz, feature = getattr(self, f"sa{i}")(xyz, feature)
            inter_xyz.append(xyz)
            inter_feat.append(feature)
        sparse_xyz, sparse_feat = xyz, feature
        for i in range(self.n_fp):
            dense_xyz = inter_xyz[-2 - i]
            sparse_feat = getattr(self, f"fp{i}")(
                dense_xyz, sparse_xyz, inter_feat[-2 - i], sparse_feat)
            sparse_xyz = dense_xyz
        x = self.score_bn(self.score_dense(self.seg_mlp(sparse_feat)))
        return sparse_feat, torch.sigmoid(x)[..., 0]
