"""Proposal regions (JAX ``geometry/region.py``): center selection, radius
grouping and the closing-region crop, on the full-scan paths and, given a
`SortedCloud`, on the sorted-slab kernels (``ops/slab.py``) where the
shapes qualify (`_use_slab_group`, `_use_slab_crop`, `use_slab_backbone`).

Randomness enters as u32 seeds, the values the JAX package reads from its
keys.  On the full-scan paths `group_regions` takes one seed per chunk of
centers (``key_data(split(k_group, n_chunks))[:, -1]``), and
`closing_region_crop_dense` one on the kernel path (``key_data(key)[-1]``)
or one per chunk of proposals on the plain path; on the slab paths each
takes one.  `group_seed_count` and `crop_seed_count` say which.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from portbench.reference.regnet_ref.config import GripperConfig
from portbench.reference.regnet_ref.geometry.codec import grasps_to_frames
from portbench.reference.regnet_ref.ops import crop as crop_ops
from portbench.reference.regnet_ref.ops import group as group_ops
from portbench.reference.regnet_ref.ops import slab
from portbench.reference.regnet_ref.ops.fps import farthest_point_sample
from portbench.reference.regnet_ref.ops.grouping import (gather_points,
                                                       group_points)
from portbench.reference.regnet_ref.ops.sampling import (
    bucket_choice, hash_uniform, pallas_bucket_stride)

# NC*N at or above which the JAX package runs the Pallas crop on the TPU
# (regnet_for_3d_grasping_tpu/geometry/region.py:311, rule at :353-356);
# gripper_num must be a multiple of 8
CROP_KERNEL_MIN_WORK = 1 << 24
# Grouping on the full scan is the JAX package's chunked path at every
# shape: its Pallas grouping (K11 here, `ops/group.group_regions_fused`)
# is off on every backend (_PALLAS_GROUP_THRESHOLD = None,
# region.py:302-312), so no shape of the JAX package reaches it.  On the
# card the chunked path runs as kernel K12 (`group_regions_chunked`)
GROUP_CENTER_CHUNK = 1024
CROP_PROPOSAL_CHUNK = 512


def use_crop_kernel(m: int, n: int, gripper_num: int) -> bool:
    return m * n >= CROP_KERNEL_MIN_WORK and gripper_num % 8 == 0


def _use_slab_group(n: int, group_num: int) -> bool:
    return (group_num % 64 == 0
            and slab.group_span_blocks(group_num) <= slab.n_scan_blocks(n))


def use_slab_backbone(n: int, sa1_neighbours: int) -> bool:
    """Can SA1's ball query and the last FP's 3-NN run the slab kernels?
    SA1 selects with win 256 / spw 2: 16 slots per scan block.  The model
    sorts the cloud before the backbone when this holds, after it
    otherwise."""
    return (sa1_neighbours % 16 == 0
            and slab.span_blocks_for(sa1_neighbours, slab.BALL_WIN,
                                     slab.BALL_SPW) <= slab.n_scan_blocks(n))


def _use_slab_crop(n: int, gripper_num: int) -> bool:
    return (gripper_num % 8 == 0
            and slab.crop_span_blocks(gripper_num) <= slab.n_scan_blocks(n))


def select_score_centers(pc: torch.Tensor, score: torch.Tensor,
                         center_num: int, score_thre: float,
                         groups: int = 1, method: str = "fps",
                         min_z: float | None = None):
    """Centers among the points scoring above `score_thre` -> (centers
    [B, NC, C], index [B, NC] int32), as JAX ``geometry/region.py:36-83``.

    ``method="fps"``: masked FPS, stratified over `groups` slices (a row
    without a positive samples all points).  ``method="bucket"``:
    `bucket_choice`, the best score in each index bucket, over the
    positives, or over all points in a row without one.  `min_z` keeps
    the positives above that z; where a row has none, any point above
    it; where no point lies above it, the positives as they were."""
    positive = score > score_thre
    if min_z is not None:
        above = pc[..., 2] > min_z
        cand = positive & above
        cand = torch.where(cand.any(-1, keepdim=True), cand, above)
        positive = torch.where(cand.any(-1, keepdim=True), cand, positive)
    if method == "bucket":
        mask = positive | ~positive.any(-1, keepdim=True)
        idx, _, _ = bucket_choice(mask, center_num, score=score)
    else:
        idx = farthest_point_sample(pc[..., :3], center_num, mask=positive,
                                    groups=groups)
    return gather_points(pc, idx), idx


class RegionGroups(NamedTuple):
    index: torch.Tensor   # [B, NC, G] indices into N
    valid: torch.Tensor   # [B, NC] bool, region had >= 1 point in radius
    # selection-span origins [B, T] when the slab kernel made `index`
    # (what `slab.gather_max_slab` pools over); None on the full-scan path
    slab_off: torch.Tensor | None = None


def group_chunks(nc: int) -> int:
    return -(-nc // min(GROUP_CENTER_CHUNK, nc))


def group_seed_count(nc: int, n: int, group_num: int,
                     sorted_cloud: bool = False) -> int:
    """Seeds `group_regions` takes: 1 on the slab path, one per center
    chunk on the full scan (as JAX splits its key, ``region.py:172``)."""
    if sorted_cloud and _use_slab_group(n, group_num):
        return 1
    return group_chunks(nc)


def group_regions(seeds: Sequence[int], pc: torch.Tensor,
                  centers: torch.Tensor, group_num: int,
                  radius: float, sorted_cloud: slab.SortedCloud | None = None,
                  cell: float = 0.0) -> RegionGroups:
    """Stratified pick of `group_num` points with ``d2 <= r2`` around each
    center, with the random tiebreak from `hash_uniform` (JAX
    ``region.py:160-185``): centers in chunks of 1024, padded with far
    centers, one seed per chunk.  Kernel K12 on the card, its plain version
    on the CPU (`ops/group.group_regions_chunked`).

    With `sorted_cloud` (over the same rows as `pc`) and qualifying shapes,
    kernel K6 scans only each center tile's slab and the picks are
    stratified over the slab's windows; counts and validity stay exact."""
    N = pc.shape[1]
    NC = centers.shape[1]
    chunk = min(GROUP_CENTER_CHUNK, NC)
    want = group_seed_count(NC, N, group_num, sorted_cloud is not None)
    if len(seeds) != want:
        raise ValueError(f"group_regions: {len(seeds)} seeds, expected "
                         f"{want}")
    xyz = pc[..., :3].float()
    cxyz = centers[..., :3].float()
    if sorted_cloud is not None and _use_slab_group(N, group_num):
        idx, count, sel_any, off = slab.group_slab(
            sorted_cloud, cxyz, seeds[0], radius, group_num, cell)
        valid = (count > 0) & sel_any
        return RegionGroups(torch.where(valid[..., None], idx, 0), valid,
                            off)
    idx, count = group_ops.group_regions_chunked(
        xyz.contiguous(), cxyz.contiguous(), seeds, radius, group_num, chunk)
    return RegionGroups(idx, count > 0)


class ClosingRegion(NamedTuple):
    index_in_all: torch.Tensor   # [B, NC, K] indices into the cloud
    valid: torch.Tensor          # [B, NC] bool, > min_points inside
    slab_off: torch.Tensor | None = None   # see RegionGroups.slab_off
    # [B, NC, K, C] gripper-frame xyz and the colours (`closing_region_crop`
    # with `with_points`), else None
    points: torch.Tensor | None = None


def closing_region_crop(seed: int, pc: torch.Tensor,
                        group_index: torch.Tensor, grasp: torch.Tensor,
                        gripper: GripperConfig, gripper_num: int,
                        min_points: int = 5,
                        with_points: bool = True) -> ClosingRegion:
    """The crop from a wide region's points (JAX ``region.py:251-300``):
    the points of `group_index` [B, NC, GM] in each proposal's gripper
    frame, inside where x in (0, depth/2), |y| < width/2, |z| < height/2,
    `gripper_num` of them picked by `bucket_choice` over the GM slots with
    `hash_uniform` noise from the u32 `seed`; valid where more than
    `min_points` lie inside.  With `with_points`, the picks' gripper-frame
    xyz and their colours.  Plain PyTorch on every device."""
    frame, center = grasps_to_frames(grasp.float())
    rel = group_points(pc[..., :3].float(), group_index) - center[..., None, :]
    local = torch.einsum("...ij,...ki->...kj", frame, rel)
    inside = ((local[..., 0] > 0) & (local[..., 0] < gripper.depth / 2)
              & (local[..., 1].abs() < gripper.width / 2)
              & (local[..., 2].abs() < gripper.height / 2))
    noise = hash_uniform(seed, tuple(inside.shape), device=inside.device)
    idx, any_valid, count = bucket_choice(inside, gripper_num, score=noise)
    idx = torch.where(any_valid[..., None], idx, 0)
    index_in_all = torch.gather(group_index, -1, idx.long()).to(torch.int32)
    points = None
    if with_points:
        local_sel = torch.gather(local, -2, idx.long()[..., None].expand(
            *idx.shape, 3))
        points = torch.cat([local_sel, group_points(pc[..., 3:],
                                                    index_in_all)], -1)
    return ClosingRegion(index_in_all, count > min_points, points=points)


def crop_seed_count(nc: int, n: int, gripper_num: int,
                    sorted_cloud: bool = False) -> int:
    """Seeds `closing_region_crop_dense` takes: 1 on the slab and kernel
    paths, one per proposal chunk on the plain path."""
    if sorted_cloud and _use_slab_crop(n, gripper_num):
        return 1
    if use_crop_kernel(nc, n, gripper_num):
        return 1
    return -(-nc // min(CROP_PROPOSAL_CHUNK, nc))


def closing_region_crop_dense(seeds: Sequence[int], pc: torch.Tensor,
                              grasp: torch.Tensor, gripper: GripperConfig,
                              gripper_num: int, min_points: int = 5,
                              sorted_cloud: slab.SortedCloud | None = None,
                              cell: float = 0.0) -> ClosingRegion:
    """Crop the cloud points inside each proposal's closing box, tested
    against the full cloud (JAX ``region.py:365-442``): x in
    (0, depth/2), |y| < width/2, |z| < height/2 in the gripper frame.
    With `sorted_cloud` and qualifying shapes, kernel K7 scans only each
    proposal tile's slab."""
    B, N, _ = pc.shape
    NC = grasp.shape[1]
    want = crop_seed_count(NC, N, gripper_num, sorted_cloud is not None)
    if len(seeds) != want:
        raise ValueError(f"closing_region_crop_dense: {len(seeds)} seeds, "
                         f"expected {want}")
    frame, center = grasps_to_frames(grasp.float())
    xyz = pc[..., :3].float().contiguous()
    box = (0.0, gripper.depth / 2, gripper.width / 2, gripper.height / 2)

    if sorted_cloud is not None and _use_slab_crop(N, gripper_num):
        idx, count, sel_any, off = slab.crop_slab(
            sorted_cloud, frame, center, seeds[0], box, gripper_num, cell)
        valid = (count > min_points) & sel_any
        return ClosingRegion(torch.where(sel_any[..., None], idx, 0), valid,
                             off)

    if use_crop_kernel(NC, N, gripper_num):
        idx, count = crop_ops.closing_region_crop(
            xyz, frame.contiguous(), center.contiguous(), seeds[0], box,
            gripper_num, pallas_bucket_stride(N, gripper_num))
        idx = torch.where((count > 0)[..., None], idx, 0)
        return ClosingRegion(idx, count > min_points)

    chunk = min(CROP_PROPOSAL_CHUNK, NC)
    pad = (-NC) % chunk
    if pad:
        eye = torch.eye(3, device=frame.device).expand(B, pad, 3, 3)
        frame = torch.cat([frame, eye], 1)
        center = torch.cat([center, torch.full((B, pad, 3), 1e10,
                                               device=center.device)], 1)
    xlo, xhi, yabs, zabs = (float(np.float32(v)) for v in box)
    idx, count = [], []
    for fr, ce, seed in zip(torch.split(frame, chunk, 1),
                            torch.split(center, chunk, 1), seeds):
        rel = xyz[:, None] - ce[:, :, None]
        local = torch.einsum("bcij,bcni->bcnj", fr, rel)
        inside = ((local[..., 0] > xlo) & (local[..., 0] < xhi)
                  & (local[..., 1].abs() < yabs)
                  & (local[..., 2].abs() < zabs))
        noise = hash_uniform(seed, tuple(inside.shape), device=inside.device)
        i, any_valid, cnt = bucket_choice(inside, gripper_num, score=noise)
        idx.append(torch.where(any_valid[..., None], i, 0))
        count.append(cnt)
    idx = torch.cat(idx, 1)[:, :NC]
    count = torch.cat(count, 1)[:, :NC]
    return ClosingRegion(idx, count > min_points)
