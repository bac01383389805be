"""The numbers that decide ``correct``: the program's outputs against the
plain reference's (``reference/regnet_ref``), each number with its limit
from the cell's workload file (``check.limits``).

Serving (each sampled request, the reference run once over the same
clouds with the same seeds):
  score_gap       the widest gap of a per-point score (SA/FP backbone and
                  seg head), in score units;
  grasp_mismatch  the largest share, over the sampled requests, of the
                  centers at which the program and the reference disagree:
                  another center picked, another region or crop validity,
                  another accept mask, or a stage-2 proposal or stage-3
                  grasp (its first 8 channels) apart by more than
                  ``grasp_tol``.
Training (the first three steps, the reference from the same weights on
the same batches with the same seeds):
  loss_gap        the gap of the first step's total loss, over the
                  reference's (the later steps' are printed beside it);
  grad_gap        the worst leaf's gap of the first gradient's norm (from
                  Adam's first moment after one step), over the larger of
                  that leaf's reference norm and the median leaf's;
  update_gap      the same of the parameters' change after three steps,
                  over the leaves whose reference gradient is at least a
                  thousandth of the median leaf's.
"""

from __future__ import annotations

import torch

SERVED = ("score", "center_index", "region_valid", "proposals",
          "crop_valid", "final_grasps", "refine_accept", "score_accept",
          "point_order")


def served(out) -> dict:
    """What a serving check keeps of a REGNetOutput (on the device)."""
    return {k: getattr(out, k) for k in SERVED
            if getattr(out, k) is not None}


def serving_numbers(prog: dict, ref: dict, grasp_tol: float) -> dict:
    """-> {"score_gap", "grasp_mismatch"} of one request (any batch)."""
    score_p, score_r = prog["score"].float(), ref["score"].float()
    if "point_order" in prog:
        # slab mode: scores in each side's slab order; compare by row
        score_p = _by_row(score_p, prog["point_order"])
        score_r = _by_row(score_r, ref["point_order"])
    score_gap = float((score_p - score_r).abs().max())
    bad = prog["center_index"] != ref["center_index"]
    for k in ("region_valid", "crop_valid", "refine_accept",
              "score_accept"):
        bad |= prog[k] != ref[k]
    for k in ("proposals", "final_grasps"):
        gap = (prog[k][..., :8].float() - ref[k][..., :8].float()).abs()
        bad |= ~(gap <= grasp_tol).all(-1)      # a NaN counts as apart
    return {"score_gap": score_gap,
            "grasp_mismatch": float(bad.float().mean(-1).max())}


def _by_row(score: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(score)
    out.scatter_(1, order.long(), score)
    return out


class StepRecord:
    """The three steps' readings of one side: losses, each leaf's first
    gradient norm, each leaf's change norm after the three."""

    def __init__(self):
        self.losses = []
        self.grad_norms = {}
        self.change_norms = {}

    def after_step(self, step: int, loss: float, model, optimizer,
                   start: dict | None) -> None:
        self.losses.append(loss)
        if step == 0:
            beta1 = optimizer.adam.param_groups[0]["betas"][0]
            for name, p in model.named_parameters():
                # a parameter the optimizer never stepped reads 0
                m = optimizer.adam.state[p].get("exp_avg")
                self.grad_norms[name] = 0.0 if m is None else float(
                    m.double().norm()) / (1 - beta1)
        if step == 2:
            for name, p in model.named_parameters():
                self.change_norms[name] = float(
                    (p.detach().double() - start[name].double()).norm())


def _worst(values) -> float:
    """The largest of `values`; infinite where one is NaN."""
    values = list(values)
    return float("inf") if any(v != v for v in values) else max(values)


def _rel(a: float, b: float, base: float) -> float:
    """|a - b| over `base`; where `base` is 0, 0 if the two agree."""
    if base > 0:
        return abs(a - b) / base
    return 0.0 if a == b else float("inf")


def _median(values):
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1]
                                                    + v[len(v) // 2])


def training_numbers(prog: StepRecord, ref: StepRecord) -> dict:
    # the first step's: the later steps' losses swing with the centers
    # that masked FPS picks where a score lies at the threshold, which a
    # rounding of the first update moves (PERF.md)
    a, b = prog.losses[0], ref.losses[0]
    loss_gap = _rel(a, b, abs(b))
    g_med = _median(list(ref.grad_norms.values()))
    grad_gap = _worst(_rel(prog.grad_norms[k], g, max(g, g_med))
                      for k, g in ref.grad_norms.items())
    moved = [k for k, g in ref.grad_norms.items() if g >= 1e-3 * g_med]
    c_med = _median([ref.change_norms[k] for k in moved])
    update_gap = _worst(_rel(prog.change_norms[k], ref.change_norms[k],
                             max(ref.change_norms[k], c_med)) for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap}


def rank_gap(records: list) -> float:
    """Data parallelism: the worst gap of any rank's losses or parameter
    changes from rank 0's, over rank 0's (the larger of its leaf's and the
    median leaf's): every rank applies the same averaged update."""
    main = records[0]
    c_med = _median(list(main.change_norms.values()))
    gaps = [0.0]
    for r in records[1:]:
        gaps += [_rel(a, b, abs(b)) for a, b in zip(r.losses, main.losses)]
        gaps += [_rel(r.change_norms[k], c, max(c, c_med))
                 for k, c in main.change_norms.items()]
    return _worst(gaps)


def with_limits(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}}; a number that is not finite fails."""
    out = {}
    for k, v in numbers.items():
        v = float(v)
        out[k] = {"value": v if v == v else float("inf"),
                  "limit": float(limits[k])}
    return out
