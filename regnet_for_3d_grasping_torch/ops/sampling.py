"""Static-shape selection under a validity mask.

Counterpart of the JAX package's ``ops/sampling.py``.  `hash_uniform` is
bit-identical to the JAX counter hash when given the same u32 seed; the
hash runs in int64 masked to 32 bits, because PyTorch's CPU kernels do not
shift uint32 tensors.
"""

from __future__ import annotations

import math

import torch

from regnet_for_3d_grasping_torch.utils import trace

_U32 = 0xFFFFFFFF


def hash_uniform(seed: int, shape: tuple, device=None) -> torch.Tensor:
    """Counter-hash uniforms in [0, 1): a lowbias32-style mix of
    ``seed * 0x9E3779B9 + linear_index * 2654435761`` (JAX
    ``ops/sampling.py:21-39``).  `seed` is the u32 the JAX side reads from
    its key (``key_data(key)[-1]``)."""
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError(f"hash_uniform: {n} elements overflow the u32 "
                         "counter")
    x = torch.arange(n, dtype=torch.int64, device=device)
    x = (x * 2654435761 + (int(seed) & _U32) * 0x9E3779B9) & _U32
    for _ in range(2):
        x = x ^ (x >> 16)
        x = (x * 0x45D9F3B) & _U32
    x = x ^ (x >> 16)
    return (x.to(torch.float32) * (1.0 / 4294967296.0)).reshape(shape)


def bucket_stride(n: int, k: int) -> int:
    """`bucket_choice`'s window width over an n-long axis with k slots."""
    return -(-n // k)


def pallas_bucket_stride(n: int, k: int) -> int:
    """Window width of the bucketed kernels (ball query K2, crop K5): the
    bucket length rounded up to a multiple of 128, at least 128 — the TPU
    kernels' L, which fixes which points share a bucket."""
    return max(128, -(-bucket_stride(n, k) // 128) * 128)


def fill_empty_buckets(win: torch.Tensor,
                       any_b: torch.Tensor) -> torch.Tensor:
    """win [..., K] per-bucket picks (-1 where `any_b` is False) -> empty
    buckets take the first non-empty bucket's pick, 0 for an all-empty
    row: the bucketed kernels' epilogue (``ball_query_pallas.py:181-185``,
    ``crop_pallas.py:176-179``)."""
    first_b = torch.argmax(any_b.to(torch.uint8), dim=-1, keepdim=True)
    first = torch.clamp(torch.gather(win, -1, first_b), min=0)
    return torch.where(win >= 0, win, first).to(torch.int32)


def masked_random_choice(generator: torch.Generator | None,
                         mask: torch.Tensor, k: int,
                         noise: torch.Tensor | None = None):
    """k elements drawn uniformly from the True entries of each mask row
    (JAX ``ops/sampling.py:56-86``): uniform noise in [0.5, 1) from
    `generator` (on `mask`'s device), or `noise` [..., N] in its place,
    -1 where the mask is False, and the k best by a stable sort (ties to
    the lower index, as ``lax.top_k``).  A row with at least k entries
    gives a k-subset without replacement; fewer cycle through the drawn
    ones; none gives index 0 and `any_valid` False.

    Returns index [..., k] int32, any_valid [...] bool, count [...] int32
    (uncapped)."""
    if noise is None:
        noise = torch.rand(mask.shape, generator=generator,
                           device=mask.device) * 0.5 + 0.5
    score = torch.where(mask, noise, torch.tensor(-1.0, dtype=noise.dtype,
                                                  device=mask.device))
    idx = torch.sort(score, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k].to(torch.int32)
    count = mask.sum(dim=-1, dtype=torch.int32)
    denom = torch.clamp(count, min=1)[..., None]
    slots = torch.arange(k, device=mask.device)
    wrapped = torch.gather(idx, -1, (slots % denom).long())
    return torch.where(slots < denom, idx, wrapped), count > 0, count


def bucket_choice(mask: torch.Tensor, k: int,
                  score: torch.Tensor | None = None):
    """One-pass stratified selection of up to k valid elements per row
    (JAX ``ops/sampling.py:88-146``).

    The N axis is split into k buckets of `bucket_stride(n, k)`; each
    bucket yields its best-scoring valid element (first index on ties;
    smallest index when `score` is None).  Empty buckets repeat the first
    non-empty bucket's pick.

    Returns index [..., k] int32, any_valid [...] bool, count [...] int32
    (exact, uncapped).
    """
    n = mask.shape[-1]
    L = bucket_stride(n, k)
    pad = k * L - n
    if score is None:
        ids = torch.arange(n, dtype=torch.float32, device=mask.device)
        score = (-ids).expand(mask.shape)
    mask_p = torch.nn.functional.pad(mask, (0, pad))
    score_p = torch.nn.functional.pad(score, (0, pad))
    shape = mask_p.shape[:-1] + (k, L)
    m = mask_p.reshape(shape)
    s = torch.where(m, score_p.reshape(shape),
                    trace.to_device(torch.tensor(-math.inf), mask.device,
                                    "sampling.bucket_choice"))
    best = torch.argmax(s, dim=-1)
    idx = torch.arange(k, device=mask.device) * L + best
    bucket_valid = m.any(dim=-1)
    count = mask.sum(dim=-1, dtype=torch.int32)
    first_bucket = torch.argmax(bucket_valid.to(torch.int32), dim=-1)
    first_pick = torch.gather(idx, -1, first_bucket[..., None])
    index = torch.where(bucket_valid, idx, first_pick)
    index = torch.clamp(index, max=n - 1)
    return index.to(torch.int32), count > 0, count
