"""Functional extras (JAX ``nn/functional.py``): one-hot encoding and the
label-smoothing cross entropy, plus the SmoothL1 and cross entropy of the
losses, re-exported."""

from __future__ import annotations

import torch

from regnet_for_3d_grasping_torch.train.losses import (  # noqa: F401
    cross_entropy,
    log_softmax,
    smooth_l1,
)


def encode_one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer labels [...] -> one-hot [..., C] f32."""
    return torch.nn.functional.one_hot(target.long(), num_classes).float()


def smooth_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                         label_smoothing: float = 0.0) -> torch.Tensor:
    """Label-smoothing cross entropy, mean-reduced."""
    num_classes = logits.shape[-1]
    one_hot = encode_one_hot(target, num_classes)
    if label_smoothing > 0:
        one_hot = one_hot * (1.0 - label_smoothing) \
            + label_smoothing / num_classes
    logp = log_softmax(logits)
    return -(one_hot * logp).sum(-1).mean()
