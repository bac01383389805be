"""Proposal and refinement heads (JAX ``models/heads.py``)."""

from __future__ import annotations

import torch
from torch import nn

from regnet_for_3d_grasping_torch.config import ModelConfig
from regnet_for_3d_grasping_torch.nn.layers import ConvBN


class TwoStageHead(nn.Module):
    """pooled [..., C] -> (anchor logits [..., A], residuals [..., A, R]),
    sigmoid on the score channels 7:."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.num_anchors, self.reg_channels = cfg.num_anchors, cfg.reg_channels
        self.stem = ConvBN(cfg.feature_channels, 1024)
        self.cls1 = ConvBN(1024, 256)
        self.cls2 = ConvBN(256, 128)
        self.cls3 = ConvBN(128, cfg.num_anchors, relu=False)
        self.reg1 = ConvBN(1024, 256)
        self.reg2 = ConvBN(256, 128)
        self.reg3 = ConvBN(128, cfg.num_anchors * cfg.reg_channels,
                           relu=False)

    def forward(self, pooled: torch.Tensor):
        x = self.stem(pooled)
        c = self.cls3(self.cls2(self.cls1(x)))
        r = self.reg3(self.reg2(self.reg1(x)))
        r = r.reshape(r.shape[:-1] + (self.num_anchors, self.reg_channels))
        return c, torch.cat([r[..., :7], torch.sigmoid(r[..., 7:])], -1)


class RefineHead(nn.Module):
    """(closing-region feature [..., C], group feature [..., C]) ->
    (valid/invalid logits [..., 2], residuals [..., R])."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.group_channels = cfg.refine_group_channels
        self.stem = ConvBN(cfg.feature_channels + cfg.refine_group_channels,
                           1024)
        self.cls1 = ConvBN(1024, 128)
        self.cls2 = ConvBN(128, 2, relu=False)
        self.reg1 = ConvBN(1024, 128)
        self.reg2 = ConvBN(128, cfg.reg_channels, relu=False)

    def forward(self, pooled: torch.Tensor, group_feature: torch.Tensor):
        x = self.stem(torch.cat(
            [pooled, group_feature[..., :self.group_channels]], -1))
        return self.cls2(self.cls1(x)), self.reg2(self.reg1(x))
