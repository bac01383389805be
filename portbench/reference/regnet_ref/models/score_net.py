"""Stage 1 — per-point graspability (JAX ``models/score_net.py``)."""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.regnet_ref.config import ModelConfig
from portbench.reference.regnet_ref.models.backbone import PointNet2Seg


class ScoreNet(nn.Module):
    """The backbone under the name ``backbone``, so the weights keep the
    JAX package's paths; returns (feature [B,N,C], score [B,N])."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.backbone = PointNet2Seg(cfg)

    def forward(self, points: torch.Tensor, sc=None, slab_cell: float = 0.0,
                sa1_seed: int = 0x5A1B,
                dropout_generator: torch.Generator | None = None):
        return self.backbone(points, sc, slab_cell, sa1_seed,
                             dropout_generator)
