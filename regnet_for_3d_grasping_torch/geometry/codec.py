"""Grasp parameterization (JAX ``geometry/codec.py``).

A grasp is (center[3], axis_y[3], theta, scores...); its frame is the 3x3
rotation with columns (approach, axis_y, minor_normal).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def anchor_templates(device=None) -> torch.Tensor:
    """The 4 orientation anchors with theta 0 -> [4, 4] (rx, ry, rz,
    theta)."""
    s3 = math.sqrt(3.0) / 3.0
    return torch.tensor([[s3, s3, s3, 0.0], [s3, s3, -s3, 0.0],
                         [s3, -s3, -s3, 0.0], [s3, -s3, s3, 0.0]],
                        dtype=torch.float32, device=device)


def _safe_normalize(v: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(norm > _EPS, v / (norm + _EPS), fallback)


def grasps_to_frames(grasp: torch.Tensor):
    """grasp [..., >=7] -> (frame [..., 3, 3] columns (approach, axis_y,
    minor), center [..., 3])."""
    center = grasp[..., :3]
    axis_y = grasp[..., 3:6]
    theta = grasp[..., 6]
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    zeros, ones = torch.zeros_like(cos_t), torch.ones_like(cos_t)
    # rotation about y by theta
    r1 = torch.stack([
        torch.stack([cos_t, zeros, -sin_t], -1),
        torch.stack([zeros, ones, zeros], -1),
        torch.stack([sin_t, zeros, cos_t], -1),
    ], -2)

    def unit(i):
        e = torch.zeros(3, dtype=grasp.dtype, device=grasp.device)
        e[i] = 1.0
        return e.expand(axis_y.shape)

    axis_y = _safe_normalize(axis_y, unit(1))
    axis_x = torch.stack([axis_y[..., 1], -axis_y[..., 0], zeros], -1)
    axis_x = _safe_normalize(axis_x, unit(0))
    axis_z = _safe_normalize(torch.linalg.cross(axis_x, axis_y), unit(2))
    m = torch.stack([axis_x, axis_y, axis_z], -1)
    m = torch.einsum("...ij,...jk->...ik", m, r1)
    approach = _safe_normalize(m[..., 0], unit(0))
    minor = torch.linalg.cross(approach, axis_y)
    return torch.stack([approach, axis_y, minor], -1), center
