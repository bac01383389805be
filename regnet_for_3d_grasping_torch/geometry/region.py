"""Proposal regions (JAX ``geometry/region.py``), full-scan paths.

Randomness enters as u32 seeds, the values the JAX package reads from its
keys: `group_regions` takes one seed per center chunk
(``key_data(split(k_group, n_chunks))[:, -1]``); `closing_region_crop_dense`
takes one seed on the kernel path (``key_data(k_it)[-1]``) and one per
proposal chunk on the plain path.  `crop_seed_count` says which.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from regnet_for_3d_grasping_torch.config import GripperConfig
from regnet_for_3d_grasping_torch.geometry.codec import grasps_to_frames
from regnet_for_3d_grasping_torch.ops import crop as crop_ops
from regnet_for_3d_grasping_torch.ops.distances import bpdist2
from regnet_for_3d_grasping_torch.ops.fps import farthest_point_sample
from regnet_for_3d_grasping_torch.ops.grouping import gather_points
from regnet_for_3d_grasping_torch.ops.sampling import (bucket_choice,
                                                       bucket_stride,
                                                       hash_uniform,
                                                       pallas_bucket_stride)

# NC*N at or above which the JAX package runs the Pallas crop on the TPU
# (regnet_for_3d_grasping_tpu/geometry/region.py:311, rule at :353-356);
# gripper_num must be a multiple of 8
CROP_KERNEL_MIN_WORK = 1 << 24
# grouping runs the plain path on the TPU too: its Pallas kernel is off
# there (region.py:312, _PALLAS_GROUP_THRESHOLD = None)
GROUP_CENTER_CHUNK = 1024
CROP_PROPOSAL_CHUNK = 512


def use_crop_kernel(m: int, n: int, gripper_num: int) -> bool:
    return m * n >= CROP_KERNEL_MIN_WORK and gripper_num % 8 == 0


def select_score_centers(pc: torch.Tensor, score: torch.Tensor,
                         center_num: int, score_thre: float):
    """Masked FPS over the points scoring above `score_thre` (all points
    when none does) -> (centers [B, NC, C], index [B, NC] int32)."""
    idx = farthest_point_sample(pc[..., :3], center_num,
                                mask=score > score_thre)
    return gather_points(pc, idx), idx


class RegionGroups(NamedTuple):
    index: torch.Tensor   # [B, NC, G] indices into N
    valid: torch.Tensor   # [B, NC] bool, region had >= 1 point in radius


def group_chunks(nc: int) -> int:
    return -(-nc // min(GROUP_CENTER_CHUNK, nc))


def group_stride(nc: int, n: int, group_num: int) -> int:
    """Bucket width of `group_regions`' index output."""
    return bucket_stride(n, group_num)


def dense_crop_stride(nc: int, n: int, gripper_num: int) -> int:
    """Bucket width of `closing_region_crop_dense`'s index output."""
    if use_crop_kernel(nc, n, gripper_num):
        return pallas_bucket_stride(n, gripper_num)
    return bucket_stride(n, gripper_num)


def group_regions(seeds: Sequence[int], pc: torch.Tensor,
                  centers: torch.Tensor, group_num: int,
                  radius: float) -> RegionGroups:
    """Stratified pick of `group_num` points with ``d2 <= r2`` around each
    center, random tiebreak from `hash_uniform` (JAX ``region.py:160-185``).
    Centers are processed in chunks of 1024, padded with far centers, one
    seed per chunk."""
    B, N, _ = pc.shape
    NC = centers.shape[1]
    chunk = min(GROUP_CENTER_CHUNK, NC)
    if len(seeds) != group_chunks(NC):
        raise ValueError(f"group_regions: {len(seeds)} seeds for "
                         f"{group_chunks(NC)} chunks")
    r2 = float(np.float32(radius * radius))
    xyz = pc[..., :3].float()
    cxyz = centers[..., :3].float()
    pad = (-NC) % chunk
    if pad:
        cxyz = torch.cat([cxyz, torch.full((B, pad, 3), 1e10,
                                           device=cxyz.device)], 1)
    idx, valid = [], []
    for c, seed in zip(torch.split(cxyz, chunk, dim=1), seeds):
        mask = bpdist2(c, xyz) <= r2
        noise = hash_uniform(seed, tuple(mask.shape), device=mask.device)
        i, any_valid, _ = bucket_choice(mask, group_num, score=noise)
        idx.append(torch.where(any_valid[..., None], i, 0))
        valid.append(any_valid)
    return RegionGroups(torch.cat(idx, 1)[:, :NC], torch.cat(valid, 1)[:, :NC])


class ClosingRegion(NamedTuple):
    index_in_all: torch.Tensor   # [B, NC, K] indices into the cloud
    valid: torch.Tensor          # [B, NC] bool, > min_points inside


def crop_seed_count(nc: int, n: int, gripper_num: int) -> int:
    """Seeds `closing_region_crop_dense` takes: 1 on the kernel path, one
    per proposal chunk on the plain path."""
    if use_crop_kernel(nc, n, gripper_num):
        return 1
    return -(-nc // min(CROP_PROPOSAL_CHUNK, nc))


def closing_region_crop_dense(seeds: Sequence[int], pc: torch.Tensor,
                              grasp: torch.Tensor, gripper: GripperConfig,
                              gripper_num: int,
                              min_points: int = 5) -> ClosingRegion:
    """Crop the cloud points inside each proposal's closing box, tested
    against the full cloud (JAX ``region.py:365-442``): x in
    (0, depth/2), |y| < width/2, |z| < height/2 in the gripper frame."""
    B, N, _ = pc.shape
    NC = grasp.shape[1]
    if len(seeds) != crop_seed_count(NC, N, gripper_num):
        raise ValueError(f"closing_region_crop_dense: {len(seeds)} seeds, "
                         f"expected {crop_seed_count(NC, N, gripper_num)}")
    frame, center = grasps_to_frames(grasp.float())
    xyz = pc[..., :3].float().contiguous()
    box = (0.0, gripper.depth / 2, gripper.width / 2, gripper.height / 2)

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
