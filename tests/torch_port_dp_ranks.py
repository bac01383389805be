"""The ranks of the data-parallel tests
(``tests/test_torch_port_parallel*.py``): functions that
`parallel.launch.run_ranks` runs in spawned processes.  They import torch
and the port only, so that a rank starts in a few seconds."""

import numpy as np
import torch

from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.models.regnet import REGNet
from regnet_for_3d_grasping_torch.parallel.mesh import (
    fold_seed, make_mesh, make_multislice_mesh, shard_batch)
from regnet_for_3d_grasping_torch.train import trainer

STEPS_PER_EPOCH = 2


def f64_model(cfg, variables) -> REGNet:
    model = REGNet(cfg)
    weights.load_into(model, variables)
    return model.double()


def f64_batch(batch) -> trainer.DeviceBatch:
    return trainer.DeviceBatch(*(
        x.double() if x.is_floating_point() else x
        for x in (torch.from_numpy(np.array(a)) for a in batch)))


def step_state(model: REGNet, optimizer, metrics) -> dict:
    """Parameters, running statistics, Adam's moments (by parameter name)
    and metrics, on the host."""
    adam = optimizer.adam.state
    return {
        "state": {k: v.detach().clone() for k, v in
                  model.state_dict().items()},
        "exp_avg": {n: adam[p]["exp_avg"].clone()
                    for n, p in model.named_parameters()},
        "exp_avg_sq": {n: adam[p]["exp_avg_sq"].clone()
                       for n, p in model.named_parameters()},
        "metrics": {k: float(v) for k, v in metrics.items()}}


def stage_steps(rank, device, cfg, variables, batch, seeds) -> dict:
    """On a 1-D mesh of every rank: for each stage of `seeds` ({stage:
    [forward kwargs of shard i]}, taken from a queue that holds them once
    for each rank: the caller draws them while the ranks start), one
    data-parallel step in f64 from `variables` on this rank's shard of
    `batch`."""
    seeds = seeds.get()
    if seeds is None:
        raise RuntimeError("the caller found no seeds")
    mesh = make_mesh()
    out = {"coords": mesh.coords, "shard": mesh.shard_index}
    for stage, kws in seeds.items():
        model = f64_model(cfg, variables)
        opt = trainer.make_optimizer(model, cfg, STEPS_PER_EPOCH)
        shard = shard_batch(f64_batch(batch), mesh.size, mesh.shard_index)
        metrics = trainer.train_step(model, opt, shard, stage, mesh,
                                     **kws[mesh.shard_index])
        out[stage] = step_state(model, opt, metrics)
    return out


def multislice_step(rank, device, cfg, variables, batch, seed) -> dict:
    """One refine step in f64 on a 2 x (W/2) multi-slice mesh, each shard
    seeded ``fold_seed(seed, shard)``."""
    mesh = make_multislice_mesh(2)
    model = f64_model(cfg, variables)
    opt = trainer.make_optimizer(model, cfg, STEPS_PER_EPOCH)
    shard = shard_batch(f64_batch(batch), mesh.size, mesh.shard_index)
    gen = torch.Generator().manual_seed(fold_seed(seed, mesh.shard_index))
    metrics = trainer.train_step(model, opt, shard, "refine", mesh,
                                 generator=gen)
    return {"coords": mesh.coords, "shard": mesh.shard_index,
            "axes": mesh.axis_names, **step_state(model, opt, metrics)}
