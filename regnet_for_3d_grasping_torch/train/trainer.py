"""Optimizer, train step and eval step (JAX ``train/trainer.py``).

  * `make_optimizer`: one Adam with two parameter groups (``score_net.*``
    at ``lr_score``, the heads at ``lr_region``) and the epoch-granular
    decay ``lr * gamma ** (epoch // lr_step_epochs)``;
  * `train_step` / `eval_step`: forward, on-device GT matching
    (``geometry/gt.py``), the losses of the stage, and for training the
    backward and the update;
  * data parallelism (JAX's ``make_train_step(mesh=...)``, ``shard_map``
    over the batch): `train_step` with a `parallel.mesh.Mesh` runs on one
    rank's shard, its forward on train-mode BatchNorm statistics of that
    shard alone (unsynced, as JAX and the reference's ``nn.DataParallel``),
    then averages over the ranks, as JAX's three ``pmean``s do, the
    gradients, the new BatchNorm running statistics (each rank's
    ``0.9 * running + 0.1 * shard statistics``) and the metrics, and
    applies the same Adam update as every other rank
    (`average_over_mesh`).  `train_step_emulated` is the same step on one
    device, shard after shard.  Each rank's seed is the step's seed folded
    by its shard index (`parallel.mesh.fold_seed`), which seeds both its
    sampling and its dropout generator.

Stages mirror the CLI modes: ``"score"`` (stage-1 loss only), ``"region"``
(stages 1 and 2, refine stage skipped), ``"refine"`` (all three).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from regnet_for_3d_grasping_torch.config import PipelineConfig
from regnet_for_3d_grasping_torch.geometry.gt import match_centers_to_gt
from regnet_for_3d_grasping_torch.models.regnet import REGNet, REGNetOutput
from regnet_for_3d_grasping_torch.train.losses import regnet_losses
from regnet_for_3d_grasping_torch.utils import trace

STAGES = ("score", "region", "refine")


class DeviceBatch(NamedTuple):
    """Device-side view of `data.SceneBatch` (tensors only)."""

    pc: torch.Tensor          # [B, N, 6]
    score: torch.Tensor       # [B, N]
    gt_frames: torch.Tensor   # [B, MG, 3, 4]
    gt_scores: torch.Tensor   # [B, MG, 3]
    gt_valid: torch.Tensor    # [B, MG] bool


def device_batch(scene_batch, device) -> DeviceBatch:
    """Host SceneBatch -> DeviceBatch on `device` (drops host-only
    fields): the span ``data.upload``, each copy from pageable memory a
    counted wait, their bytes the counter ``upload_bytes``."""
    with trace.span("data.upload"):
        out = []
        for f in DeviceBatch._fields:
            a = getattr(scene_batch, f)
            trace.count("upload_bytes", a.nbytes)
            out.append(trace.to_device(torch.from_numpy(a), device,
                                       "data.upload"))
        return DeviceBatch(*out)


def learning_rates(cfg: PipelineConfig, epoch: int) -> Tuple[float, float]:
    """(score lr, region lr) at `epoch`."""
    tc = cfg.train
    decay = tc.lr_gamma ** (epoch // tc.lr_step_epochs)
    return tc.lr_score * decay, tc.lr_region * decay


class Optimizer:
    """Adam (eps 1e-8, no weight decay) over two parameter groups, with the
    learning rates set from the epoch before every update.  The epoch is
    ``resume_epoch + updates // steps_per_epoch``, counted in updates made
    by this object, as the JAX package's schedule counts them."""

    def __init__(self, model: REGNet, cfg: PipelineConfig,
                 steps_per_epoch: int, resume_epoch: int = 0):
        self.cfg = cfg
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.resume_epoch = resume_epoch
        self.updates = 0
        score, region = [], []
        # the parameters' names in the order of Adam's state_dict
        self.names: List[str] = []
        named = list(model.named_parameters())
        for group in (True, False):
            for name, p in named:
                if name.startswith("score_net.") == group:
                    (score if group else region).append(p)
                    self.names.append(name)
        lr_s, lr_r = learning_rates(cfg, resume_epoch)
        self.adam = torch.optim.Adam(
            [{"params": score, "lr": lr_s}, {"params": region, "lr": lr_r}],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)

    @property
    def epoch(self) -> int:
        return self.resume_epoch + self.updates // self.steps_per_epoch

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group, lr in zip(self.adam.param_groups,
                             learning_rates(self.cfg, self.epoch)):
            group["lr"] = lr
            # a stage that leaves a head out of the loss still counts the
            # update for it, with a zero gradient (as the JAX package's
            # optimizer does), so Adam's bias correction stays in step
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.adam.step()
        self.updates += 1


def make_optimizer(model: REGNet, cfg: PipelineConfig, steps_per_epoch: int,
                   resume_epoch: int = 0) -> Optimizer:
    return Optimizer(model, cfg, steps_per_epoch, resume_epoch)


def load_jax_opt_state(optimizer: Optimizer, opt_state: dict) -> None:
    """Take the JAX package's optax state, as an Orbax checkpoint restores
    it (``utils/checkpoint.restore_orbax``), into `optimizer`'s Adam.

    JAX's state is ``inner_states.{score,region}.inner_state[0]``, an
    ``optax.ScaleByAdamState(count, mu, nu)`` whose mu and nu mirror the
    params with None outside the group, and ``inner_state[1].count``, the
    schedule's count.  Each parameter takes its group's mu and nu at the
    variable `weights.variable_path` names it by (kernels transposed) as
    ``exp_avg`` and ``exp_avg_sq``, and its group's Adam count as ``step``.
    The schedule's count is not taken: the port sets the rate from the
    epoch resumed at and the updates made since (`Optimizer`), the
    schedule the JAX docstring and the reference's StepLR describe."""
    from regnet_for_3d_grasping_torch.weights import variable_path

    sd = optimizer.adam.state_dict()
    index = [i for g in sd["param_groups"] for i in g["params"]]
    params = [p for g in optimizer.adam.param_groups for p in g["params"]]
    state = {}
    for i, name, p in zip(index, optimizer.names, params):
        group = "score" if name.startswith("score_net.") else "region"
        try:
            adam = opt_state["inner_states"][group]["inner_state"][0]
        except (KeyError, IndexError, TypeError) as e:
            raise KeyError(f"no Adam state of the {group!r} group in the "
                           f"JAX optimizer state") from e
        coll, path = variable_path(name, p.ndim)
        moments = []
        for field in ("mu", "nu"):
            node = adam[field]
            for part in path.split("/"):
                node = node.get(part) if isinstance(node, dict) else None
            if node is None:
                raise KeyError(f"JAX {group} Adam {field} has no {path!r} "
                               f"(for {name})")
            t = torch.as_tensor(node).float()
            moments.append(t.T.contiguous() if p.ndim == 2 else t)
        if moments[0].shape != p.shape:
            raise ValueError(f"JAX Adam state of {path!r} has shape "
                             f"{tuple(moments[0].shape)}, {name} "
                             f"{tuple(p.shape)}")
        state[i] = {"step": torch.tensor(float(adam["count"])),
                    "exp_avg": moments[0], "exp_avg_sq": moments[1]}
    sd["state"] = state
    optimizer.adam.load_state_dict(sd)


def jax_opt_state(optimizer: Optimizer) -> Tuple[dict, int]:
    """`optimizer`'s Adam as the JAX package's optax state, the inverse of
    `load_jax_opt_state`, in the dicts and lists `utils/checkpoint.
    restore_orbax` gives back: ``inner_states.{score,region}.inner_state``
    is ``[{count, mu, nu}, {count}]``, mu and nu mirroring the params
    (kernels [in, out]) with None outside the group, zeros before the first
    update.  Both counts are the group's updates made, as a JAX run that
    made them would have written them.  Returns (the state, the updates
    made: TrainState's step)."""
    from regnet_for_3d_grasping_torch.weights import nest, variable_path

    counts = {"score": 0, "region": 0}
    moments = {g: {"mu": {}, "nu": {}} for g in counts}
    params = [p for g in optimizer.adam.param_groups for p in g["params"]]
    for name, p in zip(optimizer.names, params):
        group = "score" if name.startswith("score_net.") else "region"
        _, path = variable_path(name, p.ndim)
        adam = optimizer.adam.state.get(p, {})
        if "step" in adam:
            counts[group] = max(counts[group], int(adam["step"]))
        for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            a = (adam[key].detach().cpu().numpy() if key in adam
                 else np.zeros(tuple(p.shape), np.float32))
            a = np.ascontiguousarray(a.T if a.ndim == 2 else a)
            for g in moments:
                moments[g][field][path] = a if g == group else None
    state = {g: {"inner_state": [
        {"count": np.asarray(counts[g], np.int32),
         "mu": nest(moments[g]["mu"]), "nu": nest(moments[g]["nu"])},
        {"count": np.asarray(counts[g], np.int32)}]} for g in counts}
    return {"inner_states": state}, max(counts.values())


def _check_stage(cfg: PipelineConfig, stage: str) -> None:
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; one of {STAGES}")
    if stage == "refine" and cfg.region.refine_iters != 1:
        # the stage-3 residual loss targets (gt - stage-2 proposal); with
        # iterated refinement the last residual is relative to an
        # intermediate grasp
        raise ValueError("training requires region.refine_iters == 1 "
                         "(iterative refinement is inference-only)")


def forward_losses(model: REGNet, batch: DeviceBatch, stage: str,
                   **forward_kw) -> Tuple[REGNetOutput, torch.Tensor, Dict]:
    """Forward, GT matching and the losses of `stage` -> (output, total
    loss, metrics)."""
    cfg = model.cfg
    out = model(batch.pc, with_refine=stage == "refine", **forward_kw)
    grasp_gt, matched = match_centers_to_gt(
        out.centers[..., :3], batch.gt_frames, batch.gt_scores,
        batch.gt_valid, cfg.region.gt_match_dist2)
    total, metrics = regnet_losses(
        out, batch.score, grasp_gt, matched, cfg,
        with_stage2=stage in ("region", "refine"),
        with_stage3=stage == "refine")
    return out, total, metrics


def train_step(model: REGNet, optimizer: Optimizer, batch: DeviceBatch,
               stage: str = "refine", mesh=None,
               **forward_kw) -> Dict[str, torch.Tensor]:
    """One update in training mode; returns the (detached) metrics.
    `forward_kw` goes to `REGNet.forward`: the generators, or explicit
    seeds.  With a `mesh`, `batch` is this rank's shard and the update
    averages over the mesh (`average_over_mesh`).  The span ``step`` >
    ``forward``, ``backward`` and ``update``, each timed on the card's
    stream."""
    _check_stage(model.cfg, stage)
    dev = batch.pc.device
    with trace.span("step"):
        model.train()
        optimizer.zero_grad()
        with trace.span("forward", dev):
            _, total, metrics = forward_losses(model, batch, stage,
                                               **forward_kw)
        with trace.span("backward", dev):
            total.backward()
        if mesh is not None:
            metrics = average_over_mesh(model, metrics, mesh)
        with trace.span("update", dev):
            optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}


def _flat_grads(model: REGNet) -> Tuple[List[torch.nn.Parameter],
                                        torch.Tensor]:
    """Every parameter and its gradient in one flat tensor; a parameter
    the stage left out of the loss counts a zero gradient, as
    `Optimizer.step` gives it."""
    params = list(model.parameters())
    return params, torch.cat([
        (torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
        for p in params])


def _set_flat(tensors, flat: torch.Tensor, grads: bool) -> None:
    for x, v in zip(tensors, flat.split([x.numel() for x in tensors])):
        if grads:
            x.grad = v.view_as(x)
        else:
            x.copy_(v.view_as(x))


def _mean_metrics(metrics: Dict[str, torch.Tensor], mean_) -> Dict:
    """Each metric through `mean_` (in place, on a stack of the metrics of
    one dtype)."""
    out = {}
    # in one order on every rank (a set of dtypes iterates by hash)
    for dtype in sorted({v.dtype for v in metrics.values()}, key=str):
        keys = [k for k, v in metrics.items() if v.dtype == dtype]
        stack = torch.stack([metrics[k].detach() for k in keys])
        out.update(zip(keys, mean_(stack).unbind()))
    return out


def average_over_mesh(model: REGNet, metrics: Dict[str, torch.Tensor],
                      mesh) -> Dict[str, torch.Tensor]:
    """After this rank's backward: the gradients, the BatchNorm running
    statistics and the metrics averaged over `mesh` (JAX ``pmean`` of
    ``grads``, ``new_stats`` and ``metrics``, ``trainer.py:135-138``), one
    collective for each (one `Mesh.timed` block)."""
    with mesh.timed():
        params, flat = _flat_grads(model)
        _set_flat(params, mesh.all_mean_(flat), grads=True)
        buffers = list(model.buffers())
        with torch.no_grad():
            flat = torch.cat([b.reshape(-1) for b in buffers])
            _set_flat(buffers, mesh.all_mean_(flat), grads=False)
        return _mean_metrics(metrics, mesh.all_mean_)


def train_step_emulated(model: REGNet, optimizer: Optimizer,
                        shards: Sequence[DeviceBatch],
                        forward_kws: Sequence[dict],
                        stage: str = "refine") -> Dict[str, torch.Tensor]:
    """The data-parallel step of ``len(shards)`` ranks on one device: each
    shard's forward and backward from the same weights and running
    statistics (`forward_kws[i]` its seeds), then the gradients, the new
    running statistics and the metrics averaged (summed in shard order)
    and one update."""
    _check_stage(model.cfg, stage)
    model.train()
    start = [b.detach().clone() for b in model.buffers()]
    grads, stats, metrics = [], [], []
    for shard, kw in zip(shards, forward_kws):
        with torch.no_grad():
            for b, s in zip(model.buffers(), start):
                b.copy_(s)
        optimizer.zero_grad()
        _, total, m = forward_losses(model, shard, stage, **kw)
        total.backward()
        params, flat = _flat_grads(model)
        grads.append(flat)
        stats.append(torch.cat([b.detach().reshape(-1).clone()
                                for b in model.buffers()]))
        metrics.append({k: v.detach() for k, v in m.items()})
    n = len(shards)

    def mean(xs):
        total = xs[0].clone()
        for x in xs[1:]:
            total += x
        return total.div_(n)

    _set_flat(params, mean(grads), grads=True)
    with torch.no_grad():
        _set_flat(list(model.buffers()), mean(stats), grads=False)
    keys = metrics[0].keys()
    averaged = {k: mean([m[k] for m in metrics]) for k in keys}
    optimizer.step()
    return averaged


@torch.no_grad()
def eval_step(model: REGNet, batch: DeviceBatch, stage: str = "refine",
              **forward_kw) -> Tuple[REGNetOutput, Dict[str, torch.Tensor]]:
    """Forward and losses in eval mode, no update."""
    _check_stage(model.cfg, stage)
    model.eval()
    out, _, metrics = forward_losses(model, batch, stage, **forward_kw)
    return out, metrics
