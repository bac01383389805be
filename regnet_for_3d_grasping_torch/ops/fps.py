"""Farthest point sampling (JAX ``ops/fps.py`` + ``ops/fps_pallas.py``).

Every call goes to a kernel of ``csrc/fps.cu`` on a CUDA tensor (K1 `fps`,
or K10 `fps_grouped` for the stratified ``groups > 1`` form) and to the
plain version `fps_plain` on a CPU tensor.  The JAX scan path and its
Pallas kernels agree bit for bit (``fps_pallas.py:80-82``, ``:189-191``),
so this routes every size through the kernels.

K1 runs each cloud on a thread-block cluster of R blocks, each holding a
contiguous chunk of the cloud in shared memory; `cluster_size` picks R.
K10 is the same kernel over the [B*G, N/G] view of the slices, with the
slice offsets added in the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from regnet_for_3d_grasping_torch.ops import _cuda
from regnet_for_3d_grasping_torch.utils import trace

_INF = 1e10
# shared memory a block can use on the H100, less the kernel's static part
_SMEM = 232448 - 2048
_MAX_BLOCK_POINTS = _SMEM // 16     # a chunk's x, y, z and distance
CLUSTER_SIZES = (16, 8, 4, 2, 1)    # 16 is the H100's non-portable size
# the least chunk a block takes: below it the step is the exchange, which
# grows with R (K10's 3,200-point slices: R = 4 beats R = 16 by 10-12 % on
# the H100, PERF.md)
MIN_CHUNK = 512
_max_clusters_cache: dict = {}


def dist_init(xyz: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Sentinel field: 1e10 for selectable points, -1 for masked ones (JAX
    ``fps.py:50-66``).  Rows with no valid point fall back to all-valid;
    NaN points are never selectable."""
    valid = torch.ones(xyz.shape[:2], dtype=torch.bool, device=xyz.device)
    if mask is not None:
        valid = torch.where(mask.any(dim=1, keepdim=True), mask, valid)
    valid = valid & ~torch.isnan(xyz[..., 0])
    return torch.where(
        valid,
        trace.to_device(torch.tensor(_INF), xyz.device, "fps.dist_init"),
        trace.to_device(torch.tensor(-1.0), xyz.device, "fps.dist_init"))


def farthest_point_sample(xyz: torch.Tensor, num_samples: int,
                          mask: torch.Tensor | None = None,
                          groups: int = 1) -> torch.Tensor:
    """xyz [B, N, 3], optional mask [B, N] -> [B, num_samples] int32.

    The first pick is the first valid point; masked points are picked only
    once every valid point has been (JAX ``fps.py:69-149``).

    ``groups = G > 1`` is the stratified form: exact FPS of S/G samples in
    each of the G contiguous slices of N/G points, independently, so a
    slice with no valid point falls back to all-valid on its own.  The
    indices come out slice-major."""
    xyz = xyz.float().contiguous()
    if groups == 1:
        return fps(xyz, dist_init(xyz, mask), num_samples)
    B, N, _ = xyz.shape
    if N % groups or num_samples % groups:
        raise ValueError(f"fps: N={N} and S={num_samples} must be multiples "
                         f"of groups={groups}")
    L = N // groups
    mg = None if mask is None else mask.reshape(B * groups, L)
    dist = dist_init(xyz.reshape(B * groups, L, 3), mg)
    return fps_grouped(xyz, dist.reshape(B, N), num_samples, groups)


def fps(xyz: torch.Tensor, dist: torch.Tensor,
        num_samples: int) -> torch.Tensor:
    """Kernel K1: xyz [B, N, 3] f32, dist [B, N] sentinel field ->
    [B, S] int32, each cloud on a cluster of `cluster_size` blocks.  CPU
    tensors take `fps_plain`."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, dist, num_samples)
    B, N, _ = xyz.shape
    _cuda.check(xyz, "fps xyz", torch.float32, (B, N, 3))
    _cuda.check(dist, "fps dist", torch.float32, (B, N))
    if N < 1 or num_samples < 1:
        raise ValueError(f"fps: N={N} and S={num_samples} must be positive")
    cluster = cluster_size(B, N, max_clusters(xyz.device, N))
    out = torch.empty(B, num_samples, dtype=torch.int32, device=xyz.device)
    _cuda.launch("fps", xyz.device, xyz, dist, out, B, N, num_samples,
                 cluster)
    return out


def max_clusters(device: torch.device, n: int) -> dict:
    """{R: how many K1 clusters of R blocks over `n` points the card holds
    at once}, from the CUDA occupancy calculator (minus the CUDA error for
    a size it refuses, as one whose chunk exceeds a block's shared memory);
    cached per device and `n`."""
    key = (device.index, n)
    if key not in _max_clusters_cache:
        _max_clusters_cache[key] = {
            r: _cuda.query("fps_max_clusters", device, n, r)
            for r in CLUSTER_SIZES}
    return _max_clusters_cache[key]


def cluster_size(batch: int, n: int, occupancy: dict) -> int:
    """K1's blocks per cloud for `batch` clouds of `n` points on a card that
    holds `occupancy` {R: clusters of R blocks at once}.  Of the sizes that
    launch (a chunk fits a block's shared memory, the card holds at least
    one cluster) and give a block at least `MIN_CHUNK` points (the smallest
    that launches where none does), the largest whose `batch` clusters are
    all co-resident, else the largest.  A block whose chunk is empty offers
    no candidate."""
    fits = [r for r in CLUSTER_SIZES
            if -(-n // r) <= _MAX_BLOCK_POINTS and occupancy.get(r, 0) > 0]
    if not fits:
        raise ValueError(f"fps: no cluster size launches {batch} clouds of "
                         f"N={n} points (occupancy {occupancy})")
    fits = [r for r in fits if -(-n // r) >= MIN_CHUNK] or fits[-1:]
    return next((r for r in fits if occupancy[r] >= batch), fits[0])


def fps_key(value, index) -> np.ndarray:
    """Twin of ``csrc/fps.cu`` `fps_key`: the uint64 key that orders
    (distance descending, index ascending) as K1's argmax does: the f32
    bits mapped to unsigned order above the complemented index."""
    u = np.asarray(value, np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(u & 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    low = ~np.asarray(index, np.int64) & 0xFFFFFFFF
    return (u << np.uint64(32)) | low.astype(np.uint64)


def fps_grouped(xyz: torch.Tensor, dist: torch.Tensor, num_samples: int,
                groups: int) -> torch.Tensor:
    """Kernel K10: xyz [B, N, 3] f32, dist [B, N] (each slice's own
    sentinel field) -> [B, S] int32, slice-major with the slice offsets
    added: K1's kernel over the [B*G, N/G] slices, each on a cluster of
    `cluster_size` blocks.  CPU tensors take `fps_grouped_plain`."""
    B, N, _ = xyz.shape
    if xyz.device.type == "cpu":
        return fps_grouped_plain(xyz, dist, num_samples, groups)
    _cuda.check(xyz, "fps_grouped xyz", torch.float32, (B, N, 3))
    _cuda.check(dist, "fps_grouped dist", torch.float32, (B, N))
    if N % groups or num_samples % groups or not 0 < groups <= min(
            N, num_samples):
        raise ValueError(f"fps_grouped: N={N}, S={num_samples} must be "
                         f"positive multiples of groups={groups}")
    L = N // groups
    cluster = cluster_size(B * groups, L, max_clusters(xyz.device, L))
    out = torch.empty(B, num_samples, dtype=torch.int32, device=xyz.device)
    _cuda.launch("fps_grouped", xyz.device, xyz, dist, out, B, N,
                 num_samples, groups, cluster)
    return out


def fps_grouped_plain(xyz: torch.Tensor, dist: torch.Tensor,
                      num_samples: int, groups: int) -> torch.Tensor:
    """Plain PyTorch version of K10: `fps_plain` over the [B*G, N/G] view,
    slice offsets added."""
    B, N, _ = xyz.shape
    L = N // groups
    idx = fps_plain(xyz.reshape(B * groups, L, 3),
                    dist.reshape(B * groups, L), num_samples // groups)
    offs = torch.arange(groups, dtype=torch.int32, device=xyz.device) * L
    return (idx.reshape(B, groups, -1)
            + offs[None, :, None]).reshape(B, num_samples)


def fps_plain(xyz: torch.Tensor, dist: torch.Tensor,
              num_samples: int) -> torch.Tensor:
    """Plain PyTorch version of K1, step for step the JAX scan
    (``fps.py:138-149``): diff-square distances summed as
    ((dx^2 + dy^2) + dz^2), running min over unmasked points, first-index
    argmax."""
    B = xyz.shape[0]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(B, device=xyz.device)
    far = torch.argmax(dist, dim=1)
    out = torch.empty(B, num_samples, dtype=torch.int64, device=xyz.device)
    for s in range(num_samples):
        out[:, s] = far
        c = xyz[rows, far]
        dx = x - c[:, 0:1]
        dy = y - c[:, 1:2]
        dz = z - c[:, 2:3]
        d = (dx * dx + dy * dy) + dz * dz
        dist = torch.where(dist < 0, dist, torch.minimum(dist, d))
        far = torch.argmax(dist, dim=1)
    return out.to(torch.int32)
