"""Pairwise squared distances (JAX ``ops/distances.py``).

Expansion form ``|a|^2 - 2 a.b + |b|^2`` in f32.  The 3-wide cross term is
written out as the JAX package's CPU matrix product rounds it,
``fma(a2, b2, fma(a1, b1, a0*b0))``, each fused multiply-add taken in f64
and rounded to f32.  That makes the result the same bits on the CPU and on
the card: a matrix product there would round differently, and for the
coincident points that FPS subsets produce, the expansion form's
cancellation residue then changes the 3-NN interpolation weights.
"""

from __future__ import annotations

import torch


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """f32 x*y + z rounded once (the f64 product is exact)."""
    return (x.double() * y.double() + z.double()).float()


def bpdist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., N1, C], b [..., N2, C] -> [..., N1, N2] squared distances,
    clamped at 0 (C = 3 for points; the cross term is the chain of fused
    multiply-adds over the channels in order)."""
    cross = a[..., :, None, 0] * b[..., None, :, 0]
    for i in range(1, a.shape[-1]):
        cross = _fma(a[..., :, None, i], b[..., None, :, i], cross)
    a2 = _sq_norm(a)[..., :, None]
    b2 = _sq_norm(b)[..., None, :]
    return torch.clamp(a2 - 2.0 * cross + b2, min=0.0)


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    """((x*x + y*y) + z*z), the JAX CPU sum order, over any channels."""
    out = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        out = out + v[..., i] * v[..., i]
    return out
