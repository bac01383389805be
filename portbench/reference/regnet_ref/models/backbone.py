"""PointNet++ segmentation backbone (JAX ``models/backbone.py``).  The
sampling and grouping indices carry no gradient; the features do, through
the gathers, the shared MLPs and the max over neighbours (`amax` on the
CPU; on the card fused into the last BatchNorm + ReLU, kernels K13e and
K13f through `SharedMLP(..., max_over=2)`; either splits a tie's gradient
evenly as the JAX package's ``jnp.max`` does).
In training mode the seg head drops out with ``cfg.dropout_prob``.  Given a `SortedCloud` over its input rows and a slab
cell, SA1's ball query (kernel K6) and the last FP's 3-NN (kernel K8, with
its exactness certificate and full-scan fallback) run the sorted-slab
kernels; every other layer, and every layer without them, runs the
full-scan paths, whose ball query takes ``cfg.ball_query_method``
("exact": the first K in index order, in plain PyTorch; the slab ball
query ignores it).  `SetAbstractionMSG` and `SetAbstractionAvg` (JAX
``:115-175``) are the reference library's multi-scale and mean-pooled SA,
on no model path.

At a bf16 compute dtype the layers follow flax (`nn/layers.py`) and the
JAX package's promotions: the relative xyz stays f32 and, beside bf16
features, makes the MLP's f32 input, which its Dense rounds to bf16; the
max over neighbours is taken in bf16; the 3-NN weights are f32, so the
interpolated features and their concatenation with the bf16 skip are f32
until the MLP rounds them; the score is the sigmoid of the f32 logit.
All geometry stays f32.

With ``cfg.remat_backbone`` (the train CLI's ``--remat``, flax's
``nn.remat`` of SA and FP in JAX) each layer's grouping, MLP and max, or
interpolation and MLP, are recomputed in the backward (`nn.layers.remat`);
the sampling and neighbour indices (kernels K1-K3, K6, K8) are kept from
the forward, since they carry no gradient and a recompute gives the same
bits, and BatchNorm updates its running statistics once.  Gradients and
statistics equal the run without it."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from portbench.reference.regnet_ref.config import ModelConfig
from portbench.reference.regnet_ref.nn.layers import (BatchNorm, Dense,
                                                    SharedMLP, compute_dtype,
                                                    remat)
from portbench.reference.regnet_ref.ops import _cuda, slab
from portbench.reference.regnet_ref.ops.ball_query import ball_query
from portbench.reference.regnet_ref.ops.fps import farthest_point_sample
from portbench.reference.regnet_ref.ops.grouping import (gather_points,
                                                       group_points)
from portbench.reference.regnet_ref.ops.knn import (
    interpolation_weights, three_interpolate, three_nn)


class SetAbstraction(nn.Module):
    """FPS -> ball-query grouping -> shared MLP -> max over neighbours."""

    def __init__(self, in_channels: int, num_centroids: int, radius: float,
                 num_neighbours: int, mlp_channels: Sequence[int],
                 fps_groups: int = 1, dtype: torch.dtype = torch.float32,
                 remat: bool = False, ball_query_method: str = "bucket"):
        super().__init__()
        self.num_centroids = num_centroids
        self.radius = radius
        self.num_neighbours = num_neighbours
        self.fps_groups = fps_groups
        self.remat = remat
        self.ball_query_method = ball_query_method
        self.mlp = SharedMLP(in_channels + 3, mlp_channels, dtype=dtype)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor | None,
                sc: slab.SortedCloud | None = None, slab_cell: float = 0.0,
                seed: int = 0x5A1B):
        """xyz [B,N,3], feature [B,N,C] -> (new_xyz [B,S,3], [B,S,C']).
        `sc` (over the same rows as `xyz`) with ``slab_cell > 0`` switches
        the ball query to the slab kernel, seeded by the u32 `seed`."""
        idx = farthest_point_sample(xyz, self.num_centroids,
                                    groups=self.fps_groups)
        new_xyz = gather_points(xyz, idx)
        if sc is not None and slab_cell > 0.0:
            nidx = self._slab_ball_query(sc, new_xyz, slab_cell, seed)
        else:
            nidx, _ = ball_query(xyz, new_xyz, self.radius,
                                 self.num_neighbours,
                                 method=self.ball_query_method)
        args = (xyz, feature, new_xyz, nidx)
        return new_xyz, (remat(self._features, *args) if self.remat
                         else self._features(*args))

    def _features(self, xyz, feature, new_xyz, nidx):
        return self.mlp(_grouped(xyz, feature, new_xyz, nidx), max_over=2)

    def _slab_ball_query(self, sc, new_xyz, slab_cell, seed):
        """x-sort the centroids for tile locality (stably: FPS repeats
        picks, so equal x occur), query, and restore FPS order on the
        returned rows: the deeper layers' bucketed selection needs a
        spatially mixed index order."""
        c_ord = torch.sort(new_xyz[..., 0], dim=-1, stable=True).indices
        c_sorted = gather_points(new_xyz, c_ord)
        nidx_s, _ = slab.ball_query_slab(sc, c_sorted, seed, self.radius,
                                         self.num_neighbours, slab_cell)
        inv = torch.sort(c_ord, dim=-1, stable=True).indices
        return gather_points(nidx_s, inv)


def _grouped(xyz, feature, new_xyz, nidx):
    """The neighbourhood's xyz relative to its centroid, with the
    neighbours' features after it where there are features."""
    group = group_points(xyz, nidx) - new_xyz[:, :, None, :]
    if feature is None:
        return group
    return torch.cat([group, group_points(feature, nidx)], -1)


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance interpolation -> concat skip -> shared MLP."""

    def __init__(self, in_channels: int, mlp_channels: Sequence[int],
                 num_neighbours: int = 3, nn_bound: float = 0.06,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.num_neighbours = num_neighbours
        self.nn_bound = nn_bound
        self.remat = remat
        self.mlp = SharedMLP(in_channels, mlp_channels, dtype=dtype)

    def forward(self, dense_xyz, sparse_xyz, dense_feature, sparse_feature,
                use_slab: bool = False):
        """`use_slab` (only when `dense_xyz` is in slab order) takes the
        3-NN from the slab kernel."""
        if use_slab and self.num_neighbours == 3:
            idx, d2, sparse_feature = self._slab_three_nn(
                dense_xyz, sparse_xyz, sparse_feature)
        else:
            idx, d2 = three_nn(dense_xyz, sparse_xyz, self.num_neighbours)
        args = (sparse_feature, idx, d2, dense_feature)
        return (remat(self._features, *args) if self.remat
                else self._features(*args))

    def _features(self, sparse_feature, idx, d2, dense_feature):
        interp = three_interpolate(sparse_feature, idx,
                                   interpolation_weights(d2))
        if dense_feature is not None:
            interp = torch.cat([interp, dense_feature], -1)
        return self.mlp(interp)

    def _slab_three_nn(self, dense_xyz, sparse_xyz, sparse_feature):
        """x-sort the keys (stably), search the slab, and keep the result
        when its certificate holds for every query; else run the full scan
        over the sorted keys, so the result is always the exact 3-NN.  The
        indices address the sorted keys, and `sparse_feature` is permuted to
        match.  On the card nothing is read on the host: K8 sets a device
        flag that K3's launches read, and adds to the device count
        ``_cuda.fallbacks["fp3_slab"]`` (a count that keeps growing means
        `nn_bound` is mis-scaled for the cloud's units)."""
        k_ord = torch.sort(sparse_xyz[..., 0], dim=-1, stable=True).indices
        key_sorted = gather_points(sparse_xyz, k_ord)
        feat_sorted = gather_points(sparse_feature, k_ord)
        dev = dense_xyz.device
        idx, d2, proven = slab.three_nn_slab(dense_xyz, key_sorted,
                                             bound=self.nn_bound)
        if not bool(proven.all()):
            _cuda.fallbacks.add("fp3_slab")
            idx, d2 = three_nn(dense_xyz, key_sorted, 3, sorted_keys=True)
        return idx, d2, feat_sorted


class PointNet2Seg(nn.Module):
    """points [B,N,6] -> (feature [B,N,C_feat], score [B,N] in [0,1])."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.input_channels = cfg.input_channels
        dtype = compute_dtype(cfg.compute_dtype)
        c_in = cfg.input_channels - 3
        skip = [c_in]
        for i, (s, r, k, ch) in enumerate(zip(
                cfg.num_centroids, cfg.radii, cfg.num_neighbours,
                cfg.sa_channels)):
            # SA1 holds nearly all of the FPS work; the deeper layers' inputs
            # are FPS-ordered, not random, and stay exact
            self.add_module(f"sa{i}", SetAbstraction(
                c_in, s, r, k, ch, cfg.fps_groups if i == 0 else 1, dtype,
                cfg.remat_backbone, cfg.ball_query_method))
            c_in = ch[-1]
            skip.append(c_in)
        for i, (ch, k) in enumerate(zip(cfg.fp_channels,
                                        cfg.num_fp_neighbours)):
            self.add_module(f"fp{i}", FeaturePropagation(
                c_in + skip[-2 - i], ch, k, cfg.fp3_nn_bound, dtype,
                cfg.remat_backbone))
            c_in = ch[-1]
        self.seg_mlp = SharedMLP(c_in, cfg.seg_channels, cfg.dropout_prob,
                                 dtype)
        self.score_dense = Dense(cfg.seg_channels[-1], 1, dtype)
        self.score_bn = BatchNorm(1, momentum=cfg.bn_momentum)
        self.n_sa = len(cfg.num_centroids)
        self.n_fp = len(cfg.fp_channels)

    def forward(self, points: torch.Tensor,
                sc: slab.SortedCloud | None = None, slab_cell: float = 0.0,
                sa1_seed: int = 0x5A1B,
                dropout_generator: torch.Generator | None = None):
        """`sc` (over the same rows as `points`) with ``slab_cell > 0``
        switches SA1's ball query and the last FP's 3-NN to the slab
        kernels: only SA1's point set is the sorted cloud, and only the
        last FP's dense level is.  `dropout_generator` (on the points'
        device) draws the seg head's dropout masks in training mode."""
        use_slab = sc is not None and slab_cell > 0.0
        xyz = points[..., :3]
        feature = points[..., 3:self.input_channels]
        if feature.shape[-1] == 0:
            feature = None
        inter_xyz, inter_feat = [xyz], [feature]
        for i in range(self.n_sa):
            if use_slab and i == 0:
                xyz, feature = self.sa0(xyz, feature, sc, slab_cell, sa1_seed)
            else:
                xyz, feature = getattr(self, f"sa{i}")(xyz, feature)
            inter_xyz.append(xyz)
            inter_feat.append(feature)
        sparse_xyz, sparse_feat = xyz, feature
        for i in range(self.n_fp):
            dense_xyz = inter_xyz[-2 - i]
            sparse_feat = getattr(self, f"fp{i}")(
                dense_xyz, sparse_xyz, inter_feat[-2 - i], sparse_feat,
                use_slab and i == self.n_fp - 1)
            sparse_xyz = dense_xyz
        x = self.seg_mlp(sparse_feat, dropout_generator)
        x = self.score_bn(self.score_dense(x))
        # scores feed threshold comparisons: f32 whatever the compute dtype
        return sparse_feat, torch.sigmoid(x.float())[..., 0]
