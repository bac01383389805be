"""Masked, fixed-shape training losses of the three stages (JAX
``train/losses.py``).

  * stage 1: MSE of the sigmoid scores against the tanh-squashed GT;
  * stage 2: anchor cross entropy, every GT-matched proposal weighted by
    ``min_count / count(its anchor)``, plus SmoothL1 residuals weighted
    10/5/1/1;
  * stage 3: valid/invalid cross entropy, the mean of the two class means,
    plus SmoothL1 residuals on the positives.

Each stage also gives the diagnostic "pre" losses (decoded prediction
against GT under the predicted anchor or class) under the JAX package's
metric names.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from portbench.reference.regnet_ref.config import PipelineConfig
from portbench.reference.regnet_ref.geometry.codec import (anchor_templates,
                                                         cos_dissimilarity)
from portbench.reference.regnet_ref.models.regnet import REGNetOutput


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """Elementwise SmoothL1."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the True entries of `mask`, which covers x's leading
    axes (trailing channel axes are averaged too); 0 for an empty mask."""
    m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
    m = m.expand(x.shape).to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


class _LogSoftmaxBF16(torch.autograd.Function):
    """``jax.nn.log_softmax`` over the last axis of bf16 logits, rounded
    where XLA's CPU rounds its fused computation (and its VJP), not once
    as torch's bf16 ``log_softmax``: ``sh = bf16(x - max)``, the exps in
    f32, their sum rounded to bf16, its log rounded to bf16, ``bf16(sh -
    log)``.  Backward: ``s = -g`` summed with a bf16 rounding at each add,
    ``q = bf16(s / sum)``, ``bf16(g + bf16(q * bf16(exp)))``.  Sums run in
    the axis' order.  (JAX's forward and VJP on the CPU, bit for bit but
    where the two f32 exps are an ulp apart across a bf16 rounding:
    tests/test_torch_port_train_bf16.py.)"""

    @staticmethod
    def forward(ctx, x):
        sh = (x.float() - x.amax(-1, keepdim=True).float()).to(x.dtype)
        e = torch.exp(sh.float())
        den = e[..., :1]
        for i in range(1, e.shape[-1]):
            den = den + e[..., i:i + 1]
        den = den.to(x.dtype)
        ctx.save_for_backward(e, den)
        return (sh.float() - torch.log(den.float()).to(x.dtype).float()
                ).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        e, den = ctx.saved_tensors
        s = -g[..., :1]
        for i in range(1, g.shape[-1]):
            s = (s.float() - g[..., i:i + 1].float()).to(g.dtype)
        q = (s.float() / den.float()).to(g.dtype)
        m = (q.float() * e.to(g.dtype).float()).to(g.dtype)
        return (g.float() + m.float()).to(g.dtype)


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax`` over the last axis at the logits' dtype."""
    if logits.dtype == torch.bfloat16:
        return _LogSoftmaxBF16.apply(logits)
    return torch.log_softmax(logits, dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross entropy over the last axis (integer labels), at
    the logits' dtype."""
    logp = log_softmax(logits)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def score_loss(pred_score: torch.Tensor,
               gt_score: torch.Tensor) -> torch.Tensor:
    return ((pred_score - gt_score) ** 2).mean()


class StageLosses(NamedTuple):
    loss: torch.Tensor
    metrics: Dict[str, torch.Tensor]


def _pick_anchor(reg: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    """reg [B, NC, A, R], anchor [B, NC] -> [B, NC, R]."""
    R = reg.shape[-1]
    return torch.gather(reg, -2, anchor[..., None, None].expand(
        *anchor.shape, 1, R))[..., 0, :]


def stage2_losses(out: REGNetOutput, grasp_gt: torch.Tensor,
                  matched: torch.Tensor, cfg: PipelineConfig) -> StageLosses:
    """Anchor classification and residual regression of the proposal head.
    grasp_gt [B, NC, 10] (-1 rows where unmatched), matched [B, NC]."""
    radius = cfg.gripper.depth
    templates = anchor_templates(grasp_gt.device)          # [A, 4]
    gmask = matched & out.region_valid
    gmask_f = gmask.float()

    gt_y = grasp_gt[..., 3:6]
    sim = cos_dissimilarity(templates[None, None, :, :3], gt_y[..., None, :])
    gt_anchor = torch.argmin(sim, dim=-1)                  # [B, NC]

    num_anchors = templates.shape[0]
    onehot = torch.nn.functional.one_hot(gt_anchor, num_anchors).float() \
        * gmask_f[..., None]
    counts = onehot.sum((0, 1))                            # [A]
    inf = torch.full_like(counts, math.inf)
    min_count = torch.where(counts > 0, counts, inf).min()
    min_count = torch.where(torch.isfinite(min_count), min_count,
                            torch.zeros_like(min_count))
    w = torch.where(gmask, min_count / counts[gt_anchor].clamp(min=1.0),
                    torch.zeros_like(gmask_f))
    ce = cross_entropy(out.cls_logits, gt_anchor)
    loss_cls = (ce * w).sum() / w.sum().clamp(min=1e-12)

    reg_gt = _pick_anchor(out.reg, gt_anchor)
    t = templates[gt_anchor]                               # [B, NC, 4]
    l1 = masked_mean(
        smooth_l1(reg_gt[..., :3],
                  (grasp_gt[..., :3] - out.centers[..., :3]) / radius), gmask)
    r_raw = reg_gt[..., 3:6] + t[..., :3]
    sum_r = torch.sqrt((r_raw * r_raw).sum(-1, keepdim=True) + 1e-12)
    delta_r = reg_gt[..., 3:6] * sum_r
    l2 = masked_mean(smooth_l1(delta_r, gt_y - t[..., :3]), gmask)
    l3 = masked_mean(
        smooth_l1(reg_gt[..., 6], (grasp_gt[..., 6] - t[..., 3]) / math.pi),
        gmask)
    l4 = masked_mean(smooth_l1(reg_gt[..., 7:], grasp_gt[..., 7:]), gmask)
    loss = 10.0 * l1 + 5.0 * l2 + l3 + l4 + loss_cls

    pred = out.proposals
    metrics = {
        "stage2_loss": loss,
        "stage2_loss_class": loss_cls,
        "stage2_loss_first1": l1,
        "stage2_loss_first2": l2,
        "stage2_loss_first3": l3,
        "stage2_loss_first4": l4,
        "stage2_anchor_acc": masked_mean(
            (gt_anchor == out.anchor_index).float(), gmask),
        "stage2_pre_loss_center": masked_mean(
            smooth_l1(pred[..., :3], grasp_gt[..., :3]), gmask),
        "stage2_pre_loss_cos_orientation": masked_mean(
            cos_dissimilarity(pred[..., 3:6], gt_y), gmask),
        "stage2_pre_loss_theta": masked_mean(
            smooth_l1(pred[..., 6], grasp_gt[..., 6]), gmask),
        "stage2_pre_loss_score": masked_mean(
            smooth_l1(pred[..., 7:], grasp_gt[..., 7:]), gmask),
        "stage2_matched": gmask_f.sum(),
    }
    return StageLosses(loss, metrics)


def stage3_losses(out: REGNetOutput, grasp_gt: torch.Tensor,
                  matched: torch.Tensor, cfg: PipelineConfig) -> StageLosses:
    """Valid/invalid classification and residual regression of the refine
    head; positives are GT-matched proposals whose stage-2 decode landed
    within 2.5 cm, cosine dissimilarity 0.5 and 1.047 rad of their GT."""
    radius = cfg.gripper.depth
    valid = matched & out.crop_valid & out.region_valid

    nxt = out.proposals.detach()
    center_d = torch.linalg.vector_norm(nxt[..., :3] - grasp_gt[..., :3],
                                        dim=-1)
    r_sim = cos_dissimilarity(nxt[..., 3:6], grasp_gt[..., 3:6])
    theta_d = (nxt[..., 6] - grasp_gt[..., 6]).abs()
    gt_class = ((center_d < 0.025) & (r_sim < 0.5) & (theta_d < 1.047)
                & valid)

    pos, neg = gt_class, valid & ~gt_class
    n_pos, n_neg = pos.float().sum(), neg.float().sum()
    has_both = (n_pos > 0) & (n_neg > 0)
    zero = torch.zeros_like(n_pos)

    ce = cross_entropy(out.refine_logits, gt_class.long())
    ce_pos = (ce * pos).sum() / n_pos.clamp(min=1.0)
    ce_neg = (ce * neg).sum() / n_neg.clamp(min=1.0)
    loss_cls = torch.where(has_both, 0.5 * (ce_pos + ce_neg), zero)

    reg = out.refine_reg
    l_center = masked_mean(
        smooth_l1(reg[..., :3], (grasp_gt[..., :3] - nxt[..., :3]) / radius),
        pos)
    l_r = masked_mean(
        smooth_l1(reg[..., 3:6], grasp_gt[..., 3:6] - nxt[..., 3:6]), pos)
    l_theta = masked_mean(
        smooth_l1(reg[..., 6], grasp_gt[..., 6] - nxt[..., 6]), pos)
    l_score = masked_mean(
        smooth_l1(reg[..., 7:], grasp_gt[..., 7:] - nxt[..., 7:]), pos)
    loss_reg = torch.where(has_both, l_center + l_r + l_theta + l_score, zero)
    loss = loss_cls + loss_reg

    pred_cls = out.refine_accept
    tp = (gt_class & pred_cls & valid).float().sum()
    tn = (~gt_class & ~pred_cls & valid).float().sum()
    fp = (~gt_class & pred_cls & valid).float().sum()
    fn = (gt_class & ~pred_cls & valid).float().sum()

    def pre(sel, grasp):
        return {
            "center": masked_mean(
                smooth_l1(grasp[..., :3], grasp_gt[..., :3]), sel),
            "cos_orientation": masked_mean(
                cos_dissimilarity(grasp[..., 3:6], grasp_gt[..., 3:6]), sel),
            "theta": masked_mean(
                smooth_l1(grasp[..., 6], grasp_gt[..., 6]), sel),
            "score": masked_mean(
                smooth_l1(grasp[..., 7:], grasp_gt[..., 7:]), sel),
        }

    final = out.final_grasps
    csel = pred_cls & valid
    ssel = out.score_accept & valid
    metrics = {
        "stage3_loss": loss,
        "stage3_loss_class": loss_cls,
        "stage3_loss_first1": l_center,
        "stage3_loss_first2": l_r,
        "stage3_loss_first3": l_theta,
        "stage3_loss_first4": l_score,
        "stage3_refine_acc": (tp + tn) / (tp + tn + fp + fn).clamp(min=1.0),
        "stage3_tp": tp, "stage3_tn": tn, "stage3_fp": fp, "stage3_fn": fn,
        "stage3_positives": n_pos,
    }
    for suffix, sel, grasp in (("", csel, final), ("_stage2", csel, nxt),
                               ("_score", ssel, final)):
        for k, v in pre(sel, grasp).items():
            metrics[f"stage3_pre_loss_{k}{suffix}"] = v
    return StageLosses(loss, metrics)


def regnet_losses(out: REGNetOutput, pc_score_gt: torch.Tensor,
                  grasp_gt: torch.Tensor, matched: torch.Tensor,
                  cfg: PipelineConfig, with_stage2: bool = True,
                  with_stage3: bool = True
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Joint loss: score + proposal + refine stages.

    In slab mode the model's per-point score comes out in slab order;
    `out.point_order` carries the permutation and the per-point GT is
    permuted to match.  Every other loss input is addressed by value."""
    if out.point_order is not None:
        pc_score_gt = torch.gather(pc_score_gt, 1, out.point_order.long())
    l1 = score_loss(out.score, pc_score_gt)
    metrics = {"stage1_loss_score": l1}
    total = l1
    if with_stage2:
        s2 = stage2_losses(out, grasp_gt, matched, cfg)
        total = total + s2.loss
        metrics.update(s2.metrics)
    if with_stage3:
        s3 = stage3_losses(out, grasp_gt, matched, cfg)
        total = total + s3.loss
        metrics.update(s3.metrics)
    metrics["loss_total"] = total
    return total, metrics
