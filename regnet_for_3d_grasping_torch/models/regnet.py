"""REGNet, the three-stage cascade (JAX ``models/regnet.py``).

ScoreNet scores every point; masked FPS picks the grasp centers; radius
groups around them are max-pooled (kernel K4) into the TwoStageHead, whose
anchor residuals decode into stage-2 proposals; the closing region of each
proposal is cropped (kernel K5), pooled again and refined by the
RefineHead.  Proposals stay on a fixed [B, center_num] grid with masks.

With ``region.slab_cell > 0`` the cloud is put into slab order once
(`ops/slab.sort_cloud`), and grouping, crop, both pools and, where SA1's
shape qualifies, the backbone's SA1 ball query and last 3-NN run the
sorted-slab kernels K6-K9.  Per-point outputs then come out in slab order,
and `point_order` gives each row's original row.

The randomness is explicit: u32 selection seeds and the sort noise `u` are
passed in (the tests pass the values the JAX package derives from its
keys), or drawn from a ``torch.Generator``.

``model.compute_dtype = "bfloat16"`` is the JAX package's
``REGNet(cfg, dtype=jnp.bfloat16)``: the network computes in bf16 (the
pools take K4's and K9's bf16 forms) and all geometry stays f32; the
refine step's ``refine_reg * depth`` rounds in bf16 and the acceptance
test subtracts the bf16 logits, as in JAX.  In training mode (the train
CLI's ``--bf16``) both pools take their bf16 argmax forms and the bf16
backward; the parameters stay f32, each Dense rounding its kernel at use.

The serving knobs of ``RegionConfig`` are JAX's: ``center_select`` and
``center_min_z`` pick the centers (`geometry/region.select_score_centers`),
``pose_search_k`` searches each proposal's theta (`pose_search_thetas`)
and ``refine_guard`` keeps stage-2 poses the refine stage broke
(`funnel_guard_refine`); both funnels are PyTorch on tensors, as JAX
computes them in XLA.

``model.train()`` / ``.eval()`` is the JAX package's ``train`` flag (batch
statistics and dropout).  The forward builds an autograd graph whenever
gradients are enabled: the selections carry none, both pools carry the
first-winner gradient of K4 / K9, and the refine stage sees the proposals
detached.  Serving entry points call it under ``torch.inference_mode()``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
from torch import nn

from regnet_for_3d_grasping_torch.config import (EvalConfig, GripperConfig,
                                                PipelineConfig)
from regnet_for_3d_grasping_torch.geometry.codec import anchor_templates
from regnet_for_3d_grasping_torch.geometry.region import (
    closing_region_crop_dense, crop_seed_count, group_regions,
    group_seed_count, select_score_centers, use_slab_backbone)
from regnet_for_3d_grasping_torch.models.heads import RefineHead, TwoStageHead
from regnet_for_3d_grasping_torch.models.score_net import ScoreNet
from regnet_for_3d_grasping_torch.nn.layers import compute_dtype
from regnet_for_3d_grasping_torch.ops import slab
from regnet_for_3d_grasping_torch.ops.grouping import gather_points
from regnet_for_3d_grasping_torch.ops.pooling import gather_max
from regnet_for_3d_grasping_torch.runtime import resolve_device
from regnet_for_3d_grasping_torch.utils import trace
from regnet_for_3d_grasping_torch.weights import load_into


class REGNetOutput(NamedTuple):
    """Shapes: B batch, N points, NC centers, A anchors, R reg channels."""

    score: torch.Tensor           # [B, N] per-point graspability
    centers: torch.Tensor         # [B, NC, 6] candidate centers
    center_index: torch.Tensor    # [B, NC]
    region_valid: torch.Tensor    # [B, NC] proposal region non-empty
    cls_logits: torch.Tensor      # [B, NC, A]
    reg: torch.Tensor             # [B, NC, A, R]
    anchor_index: torch.Tensor    # [B, NC]
    proposals: torch.Tensor       # [B, NC, R] stage-2 grasps
    crop_valid: torch.Tensor      # [B, NC] closing region had > min points
    refine_logits: torch.Tensor   # [B, NC, 2]
    refine_reg: torch.Tensor      # [B, NC, R]
    final_grasps: torch.Tensor    # [B, NC, R] stage-3 grasps
    refine_accept: torch.Tensor   # [B, NC]
    score_accept: torch.Tensor    # [B, NC] accepted and score > threshold
    # slab mode only: original row of each output row ([B, N], else None);
    # `score` is in slab order, everything else is addressed by value
    point_order: torch.Tensor | None = None


def weak(s: float, dtype: torch.dtype) -> float:
    """The Python float `s` as JAX's weak typing uses it beside an array
    of `dtype`: rounded to `dtype` first.  torch multiplies a bf16 tensor
    by the unrounded float, which rounds some products differently."""
    return float(torch.tensor(s, dtype=dtype))


def decode_proposals(reg: torch.Tensor, anchor_idx: torch.Tensor,
                     center_xyz: torch.Tensor, radius: float) -> torch.Tensor:
    """reg [B,NC,A,R], anchor_idx [B,NC], center_xyz [B,NC,3] -> [B,NC,R]
    (center, unit axis_y, theta, scores...), f32.  With bf16 residuals,
    as in JAX: ``sel * radius`` is a bf16 product (the radius rounded to
    bf16) before the f32 centers are added, and the f32 anchor templates
    promote the rest."""
    R = reg.shape[-1]
    sel = torch.gather(reg, -2, anchor_idx[..., None, None].expand(
        *anchor_idx.shape, 1, R))[..., 0, :]
    t = anchor_templates(reg.device)[anchor_idx]
    center = sel[..., :3] * weak(radius, sel.dtype) + center_xyz
    r_raw = sel[..., 3:6] + t[..., :3]
    axis_y = r_raw / torch.sqrt((r_raw * r_raw).sum(-1, keepdim=True)
                                + 1e-12)
    theta = math.pi * (sel[..., 6:7] + t[..., 3:4])
    return torch.cat([center, axis_y, theta, sel[..., 7:]], -1)


def _check_supported(cfg: PipelineConfig) -> None:
    r = cfg.region
    compute_dtype(cfg.model.compute_dtype)
    if r.refine_pose not in ("full", "center", "off"):
        raise ValueError(f"unknown refine_pose {r.refine_pose!r}")
    if r.center_select not in ("fps", "bucket"):
        raise ValueError(f"unknown center_select {r.center_select!r}")
    if cfg.model.ball_query_method not in ("bucket", "exact"):
        raise ValueError(f"unknown ball_query_method "
                         f"{cfg.model.ball_query_method!r}")


def pose_search_thetas(points: torch.Tensor, proposals: torch.Tensor,
                       k: int, subsample: int, table_height: float,
                       gripper: GripperConfig) -> torch.Tensor:
    """The serving pose search (JAX ``models/regnet.py:90-134``): for each
    stage-2 proposal, `k` theta variants ``theta + 2 pi i / k`` (variant 0
    the prediction) go through the view-collision funnel
    (`eval.collision.view_check_funnel`, the test path's settings) against
    ``points[:, ::subsample]``, and the surviving variant nearest the
    prediction on the circular grid is served (the first on a tie; the
    prediction where none survives).  Only theta (channel 6) changes.

    points [B, N, 3] in the order the model holds the cloud (slab order
    in slab mode), proposals [B, NC, R].  As in JAX, the variants' thetas
    are rounded to the proposals' dtype before the funnel sees them as
    f32, the served theta is the f32 one rounded to that dtype, and the
    funnel takes a fresh ``EvalConfig()`` (JAX ``:106``), not the
    pipeline's."""
    from regnet_for_3d_grasping_torch.eval.collision import view_check_funnel
    nc, dev = proposals.shape[1], proposals.device
    offs = torch.arange(k, dtype=torch.float32, device=dev) * torch.tensor(
        2.0 * math.pi / k, dtype=torch.float32, device=dev)
    steps = torch.arange(k, device=dev)
    circ = torch.minimum(steps, k - steps)
    out = []
    for pts, props in zip(points, proposals):
        theta = props[:, 6:7].float() + offs                     # [NC, k]
        var = props.detach()[:, None, :8].repeat(1, k, 1)
        var[..., 6] = theta.detach().to(var.dtype)
        surv = view_check_funnel(
            pts[::subsample].float(), var.reshape(nc * k, 8).float(),
            table_height, gripper.depth, gripper, EvalConfig(),
            table_sign=+1.0)["survive"].reshape(nc, k)
        pick = surv.to(torch.int64) * (2 * k) - circ
        kstar = torch.where(surv.any(-1), torch.argmax(pick, -1), 0)
        th = torch.gather(theta, 1, kstar[:, None])
        out.append(torch.cat([props[:, :6], th.to(props.dtype),
                              props[:, 7:]], -1))
    return torch.stack(out)


def funnel_guard_refine(points: torch.Tensor, refined: torch.Tensor,
                        stage2: torch.Tensor, subsample: int,
                        table_height: float,
                        gripper: GripperConfig) -> torch.Tensor:
    """The survivor-preserving refinement guard (JAX
    ``models/regnet.py:137-183``): the view-collision funnel on each
    refined pose and its stage-2 input; the stage-2 pose (channels 0-6)
    is served where the refined one fails and the stage-2 one survives,
    the refined pose everywhere else.  Channels 7: always come from the
    refined head.  With ``subsample == 1`` every stage-2 survivor is then a
    stage-3 survivor.  points [B, N, 3] in the model's row order; the
    funnel takes a fresh ``EvalConfig()`` (JAX ``:162``)."""
    from regnet_for_3d_grasping_torch.eval.collision import view_check_funnel
    nc = refined.shape[1]
    out = []
    for pts, ref, s2 in zip(points, refined, stage2):
        both = torch.cat([ref[:, :8], s2[:, :8]]).detach().float()
        surv = view_check_funnel(pts[::subsample].float(), both,
                                 table_height, gripper.depth, gripper,
                                 EvalConfig(), table_sign=+1.0)["survive"]
        use_s2 = ~surv[:nc] & surv[nc:]
        pose = torch.where(use_s2[:, None], s2[:, :7].to(ref.dtype),
                           ref[:, :7])
        out.append(torch.cat([pose, ref[:, 7:]], -1))
    return torch.stack(out)


def _draw(generator: torch.Generator | None, n: int) -> list:
    if generator is None:
        raise ValueError("pass a torch.Generator or all the randomness")
    return torch.randint(0, 1 << 32, (n,), generator=generator,
                         dtype=torch.int64).tolist()


def _pool(feature, index, valid, slab_off, win, spw):
    """Max over each row's gathered features: K4, or K9 where the slab
    kernels made `index`, whose rows without a pick are zeroed as the JAX
    model zeroes them (the `where` also keeps their gradient out of row
    0)."""
    if slab_off is None:
        return gather_max(feature, index)
    pooled = slab.gather_max_slab(feature, index, slab_off, win, spw)
    return torch.where(valid[..., None], pooled, torch.zeros_like(pooled))


class REGNet(nn.Module):
    """ScoreNet + GRN + RefineNet; module names follow the JAX variables
    (``score_net``, ``grn_head``, ``refine_head``)."""

    def __init__(self, cfg: PipelineConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.score_net = ScoreNet(cfg.model)
        self.grn_head = TwoStageHead(cfg.model)
        self.refine_head = RefineHead(cfg.model)
        # the JAX package's initial distribution (flax's lecun_normal): a
        # normal truncated at two standard deviations with variance
        # 1 / fan_in after truncation
        for m in self.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std)

    def forward(self, pc: torch.Tensor,
                generator: torch.Generator | None = None,
                group_seeds: Sequence[int] | None = None,
                crop_seeds: Sequence[Sequence[int]] | None = None,
                sort_u: torch.Tensor | None = None,
                sa1_seed: int | None = None,
                with_refine: bool = True,
                dropout_generator: torch.Generator | None = None
                ) -> REGNetOutput:
        """pc [B, N, 6] -> REGNetOutput.

        ``with_refine=False`` is the region pre-training configuration: the
        refine stage is skipped and its outputs are zero placeholders, with
        `final_grasps` the detached proposals.  `dropout_generator` (on
        `pc`'s device) draws the seg head's dropout masks in training mode.

        `group_seeds`: the u32 seeds `group_regions` takes
        (`group_seed_count`); `crop_seeds`: per refine iteration, the seeds
        `closing_region_crop_dense` takes (`crop_seed_count`).  Slab mode
        only: `sort_u` [B, N] f32 in [0, 1), the within-cell sort noise,
        and `sa1_seed`, the u32 seed of SA1's slab ball query.  What is not
        passed is drawn from `generator`."""
        with trace.span("regnet"):
            return self._stages(pc, generator, group_seeds, crop_seeds,
                                sort_u, sa1_seed, with_refine,
                                dropout_generator)

    def _stages(self, pc, generator, group_seeds, crop_seeds, sort_u,
                sa1_seed, with_refine, dropout_generator) -> REGNetOutput:
        """`forward`'s three stages, each a span timed on the card's stream:
        ``sn`` (ScoreNet, with the slab sort), ``grn`` (centers, grouping,
        pool, TwoStageHead, decode, pose search) and ``rn`` (the refine
        rounds, the guard, the acceptance)."""
        cfg, region = self.cfg, self.cfg.region
        B, N, _ = pc.shape
        NC = region.center_num
        iters = max(region.refine_iters, 1)
        cell = region.slab_cell
        slab_mode = cell > 0.0
        dev = pc.device
        if group_seeds is None:
            group_seeds = _draw(generator, group_seed_count(
                NC, N, region.group_num, slab_mode))
        if crop_seeds is None and with_refine:
            n_crop = crop_seed_count(NC, N, region.gripper_num, slab_mode)
            crop_seeds = [_draw(generator, n_crop) for _ in range(iters)]

        # slab mode: one sort by (x-cell, noise).  Where SA1's shape
        # qualifies, the sort comes before the backbone, which then runs its
        # slab kernels (with stratified FPS, SA1's slices are contiguous
        # ranges of the sorted cloud); otherwise the backbone sees the cloud
        # as given and its outputs are brought into slab order
        sc = None
        with trace.span("sn", dev):
            if not slab_mode:
                feature, score = self.score_net(
                    pc, dropout_generator=dropout_generator)
            elif use_slab_backbone(N, cfg.model.num_neighbours[0]):
                if sa1_seed is None:
                    sa1_seed = _draw(generator, 1)[0]
                pc, sc = slab.sort_cloud(pc, cell, sort_u, generator)
                feature, score = self.score_net(pc, sc, cell, sa1_seed,
                                                dropout_generator)
            else:
                feature, score = self.score_net(
                    pc, dropout_generator=dropout_generator)
                pc, sc = slab.sort_cloud(pc, cell, sort_u, generator)
                feature = gather_points(feature, sc.order)
                score = torch.gather(score, 1, sc.order.long())

        with trace.span("grn", dev):
            centers, center_idx = select_score_centers(
                pc, score, NC, region.score_thre, region.center_fps_groups,
                region.center_select, region.center_min_z)
            if sc is not None:
                # x-sort the centers (stably: masked FPS repeats picks) so
                # that each tile of 128 spans a narrow slab
                c_ord = torch.sort(centers[..., 0], dim=-1,
                                   stable=True).indices
                centers = gather_points(centers, c_ord)
                center_idx = torch.gather(center_idx, 1, c_ord)
            groups = group_regions(group_seeds, pc, centers,
                                   region.group_num, cfg.group_radius, sc,
                                   cell)
            pooled = _pool(feature, groups.index, groups.valid,
                           groups.slab_off, slab.GROUP_WIN, slab.GROUP_SPW)
            cls_logits, reg = self.grn_head(pooled)
            anchor_idx = torch.argmax(cls_logits, dim=-1)
            proposals = decode_proposals(reg, anchor_idx, centers[..., :3],
                                         cfg.gripper.depth)
            # the serving knobs run wherever they are set, in training mode
            # too, as in JAX (its `:289` reads no train flag), and stride
            # over the cloud in the model's row order (slab order in slab
            # mode)
            if region.pose_search_k > 0:
                proposals = pose_search_thetas(
                    pc[..., :3], proposals, region.pose_search_k,
                    region.pose_search_subsample, region.pose_search_table,
                    cfg.gripper)

        proposals_sg = proposals.detach()
        if with_refine:
            with trace.span("rn", dev):
                cur, crop_valid, refine_logits, refine_reg = self._refine(
                    pc, feature, pooled, proposals_sg, crop_seeds, sc)
                if region.refine_guard:
                    cur = funnel_guard_refine(
                        pc[..., :3], cur, proposals_sg,
                        region.refine_guard_subsample,
                        region.pose_search_table, cfg.gripper)
                refine_accept = ((refine_logits[..., 1]
                                  - refine_logits[..., 0]
                                  > weak(region.accept_margin,
                                         refine_logits.dtype)) & crop_valid)
                score_accept = refine_accept & (cur[..., 7]
                                                > region.grasp_score_thre)
        else:
            R = cfg.model.reg_channels
            cur = proposals_sg
            crop_valid = torch.zeros(B, NC, dtype=torch.bool, device=dev)
            refine_logits = proposals.new_zeros(B, NC, 2)
            refine_reg = proposals.new_zeros(B, NC, R)
            refine_accept = score_accept = crop_valid
        return REGNetOutput(
            score=score, centers=centers, center_index=center_idx,
            region_valid=groups.valid, cls_logits=cls_logits, reg=reg,
            anchor_index=anchor_idx, proposals=proposals,
            crop_valid=crop_valid, refine_logits=refine_logits,
            refine_reg=refine_reg, final_grasps=cur,
            refine_accept=refine_accept, score_accept=score_accept,
            point_order=None if sc is None else sc.order)

    def _refine(self, pc, feature, pooled, cur, crop_seeds, sc):
        """The refine stage on the detached proposals `cur`:
        `region.refine_iters` rounds of crop, pool and residual (the rounds
        after the first start from the detached result of the one before).
        -> (final grasps, crop_valid, refine_logits, refine_reg)."""
        cfg, region = self.cfg, self.cfg.region
        iters = max(region.refine_iters, 1)
        crop_valid = torch.ones(cur.shape[:2], dtype=torch.bool,
                                device=pc.device)
        for it in range(iters):
            crop = closing_region_crop_dense(
                crop_seeds[it], pc, cur, cfg.gripper, region.gripper_num,
                region.min_region_points, sc, region.slab_cell)
            pooled_grip = _pool(feature, crop.index_in_all, crop.valid,
                                crop.slab_off, slab.CROP_WIN, slab.CROP_SPW)
            refine_logits, refine_reg = self.refine_head(pooled_grip, pooled)
            depth = weak(cfg.gripper.depth, refine_reg.dtype)
            nxt = torch.cat(
                [cur[..., :3] + refine_reg[..., :3] * depth,
                 cur[..., 3:] + refine_reg[..., 3:]], -1)
            if region.refine_pose == "center":
                nxt = torch.cat([nxt[..., :3], cur[..., 3:7], nxt[..., 7:]],
                                -1)
            elif region.refine_pose == "off":
                nxt = torch.cat([cur[..., :7], nxt[..., 7:]], -1)
            crop_valid = crop_valid & crop.valid
            cur = nxt.detach() if it + 1 < iters else nxt
        return cur, crop_valid, refine_logits, refine_reg


def build_regnet(cfg: PipelineConfig, weights=None,
                 device: str | torch.device | None = None) -> REGNet:
    """Entry point: an eval-mode REGNet on `device` (``cuda`` unless the
    caller asks for another), with `weights` (an npz path, a JAX Orbax
    checkpoint directory or the JAX variable arrays, see
    `weights.load_into`) when given.  Serving
    callers run it under ``torch.inference_mode()``; the trainer switches
    it to ``.train()``."""
    dev = resolve_device(device)
    model = REGNet(cfg)
    if weights is not None:
        load_into(model, weights)
    return model.to(dev).eval()
