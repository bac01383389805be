"""Proposal and refinement heads (JAX ``models/heads.py``), at the model's
compute dtype: in bf16 the logits and residuals come out bf16."""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.regnet_ref.config import ModelConfig
from portbench.reference.regnet_ref.nn.layers import ConvBN, compute_dtype


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` at `x`'s dtype.  In bf16 it is written out as
    XLA expands the bf16 ``logistic``, 1 / (1 + exp(-x)) with every step
    rounded to bf16: torch's bf16 sigmoid rounds once and differs from it
    by one ulp on many entries."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return torch.reciprocal(1.0 + torch.exp(-x))


class TwoStageHead(nn.Module):
    """pooled [..., C] -> (anchor logits [..., A], residuals [..., A, R]),
    sigmoid on the score channels 7:."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.num_anchors, self.reg_channels = cfg.num_anchors, cfg.reg_channels
        dt = dict(dtype=compute_dtype(cfg.compute_dtype))
        self.stem = ConvBN(cfg.feature_channels, 1024, **dt)
        self.cls1 = ConvBN(1024, 256, **dt)
        self.cls2 = ConvBN(256, 128, **dt)
        self.cls3 = ConvBN(128, cfg.num_anchors, relu=False, **dt)
        self.reg1 = ConvBN(1024, 256, **dt)
        self.reg2 = ConvBN(256, 128, **dt)
        self.reg3 = ConvBN(128, cfg.num_anchors * cfg.reg_channels,
                           relu=False, **dt)

    def forward(self, pooled: torch.Tensor):
        x = self.stem(pooled)
        c = self.cls3(self.cls2(self.cls1(x)))
        r = self.reg3(self.reg2(self.reg1(x)))
        r = r.reshape(r.shape[:-1] + (self.num_anchors, self.reg_channels))
        return c, torch.cat([r[..., :7], sigmoid(r[..., 7:])], -1)


class RefineHead(nn.Module):
    """(closing-region feature [..., C], group feature [..., C]) ->
    (valid/invalid logits [..., 2], residuals [..., R])."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.group_channels = cfg.refine_group_channels
        dt = dict(dtype=compute_dtype(cfg.compute_dtype))
        self.stem = ConvBN(cfg.feature_channels + cfg.refine_group_channels,
                           1024, **dt)
        self.cls1 = ConvBN(1024, 128, **dt)
        self.cls2 = ConvBN(128, 2, relu=False, **dt)
        self.reg1 = ConvBN(1024, 128, **dt)
        self.reg2 = ConvBN(128, cfg.reg_channels, relu=False, **dt)

    def forward(self, pooled: torch.Tensor, group_feature: torch.Tensor):
        x = self.stem(torch.cat(
            [pooled, group_feature[..., :self.group_channels]], -1))
        return self.cls2(self.cls1(x)), self.reg2(self.reg1(x))
