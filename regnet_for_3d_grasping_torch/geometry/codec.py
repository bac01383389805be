"""Grasp parameterization (JAX ``geometry/codec.py``).

A grasp is (center[3], axis_y[3], theta, scores...); its frame is the 3x3
rotation with columns (approach, axis_y, minor_normal).
"""

from __future__ import annotations

import math

import torch

from regnet_for_3d_grasping_torch.utils import trace

_EPS = 1e-12


def anchor_templates(device=None) -> torch.Tensor:
    """The 4 orientation anchors with theta 0 -> [4, 4] (rx, ry, rz,
    theta); made on the host and, given a `device`, uploaded (a counted
    wait)."""
    s3 = math.sqrt(3.0) / 3.0
    t = torch.tensor([[s3, s3, s3, 0.0], [s3, s3, -s3, 0.0],
                      [s3, -s3, -s3, 0.0], [s3, -s3, s3, 0.0]],
                     dtype=torch.float32)
    return t if device is None else trace.to_device(
        t, device, "codec.anchor_templates")


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
        # a Python value stored into a card's tensor: an upload that waits
        with trace.waiting("codec.unit"):
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


def cos_dissimilarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 - cos(a, b) along the last axis."""
    ab = (a * b).sum(-1)
    a2 = (a * a).sum(-1) + _EPS
    b2 = (b * b).sum(-1) + _EPS
    return 1.0 - ab / torch.sqrt(a2 * b2)


def frames_to_grasps(frame: torch.Tensor, center: torch.Tensor,
                     scores: torch.Tensor) -> torch.Tensor:
    """frame [..., 3, 3] columns (axis_x, axis_y, axis_z), center [..., 3],
    scores [..., S] -> [..., 7 + S] (center, axis_y, theta, scores), with
    axis_y flipped to x >= 0 and theta wrapped to (-pi, pi]."""
    axis_x, axis_y, axis_z = frame[..., 0], frame[..., 1], frame[..., 2]
    angle = torch.atan2(axis_x[..., 2], axis_z[..., 2])
    flip = axis_y[..., 0] < 0
    angle = torch.where(flip, math.pi - angle, angle)
    axis_y = torch.where(flip[..., None], -axis_y, axis_y)
    two_pi = 2 * math.pi
    angle = torch.where(angle >= two_pi, angle - two_pi, angle)
    angle = torch.where(angle <= -two_pi, angle + two_pi, angle)
    angle = torch.where(angle > math.pi, angle - two_pi, angle)
    angle = torch.where(angle <= -math.pi, angle + two_pi, angle)
    return torch.cat([center, axis_y, angle[..., None], scores], -1)
