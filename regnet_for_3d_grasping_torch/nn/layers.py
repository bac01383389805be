"""Pointwise layers, channels-last (JAX ``nn/layers.py``), inference only.

`ConvBN` is a bias-free Linear on the trailing axis, an eval-mode
BatchNorm and an optional ReLU.  The BatchNorm is written out in flax's
order, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, and keeps the
state_dict names of ``torch.nn.BatchNorm1d`` (without its batch counter),
so `weights.py` maps the JAX variables onto it one to one.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Eval-mode batch normalization over the trailing axis."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class ConvBN(nn.Module):
    """Pointwise dense layer + BatchNorm + optional ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 relu: bool = True):
        super().__init__()
        self.dense = nn.Linear(in_channels, out_channels, bias=False)
        self.bn = BatchNorm(out_channels)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.dense(x))
        return torch.relu(x) if self.relu else x


class SharedMLP(nn.Module):
    """Stack of ConvBN blocks named layer0, layer1, ... (dropout is a
    no-op at inference and is left out)."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        for i, ch in enumerate(channels):
            self.add_module(f"layer{i}", ConvBN(in_channels, ch))
            in_channels = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x
