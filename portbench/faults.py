"""Faults planted in the program, for reading the comparison's numbers
on a broken program (``calibrate.py --fault``) and for the tests that see
``correct`` come out false.  Each patches the port's modules in the
calling process; on several ranks each rank's process calls it
(``patch["fault"]``, ``"portbench.faults:<name>"``).  The benchmark's own
runs never plant one."""

from __future__ import annotations


def answer_altered() -> None:
    """Serving: every stage-3 grasp a millimetre off along x, where the
    forward produces it."""
    from regnet_for_3d_grasping_torch.models import regnet
    forward = regnet.REGNet.forward

    def altered(self, *a, **k):
        out = forward(self, *a, **k)
        g = out.final_grasps.clone()
        g[..., 0] += 1e-3
        return out._replace(final_grasps=g)
    regnet.REGNet.forward = altered


def state_unchanged() -> None:
    """Training: a step that returns its state unchanged (the optimizer
    counts the update and applies none)."""
    from regnet_for_3d_grasping_torch.train import trainer

    def no_update(self):
        self.updates += 1
    trainer.Optimizer.step = no_update


def half_batch() -> None:
    """Training: half of the batch left out, the mean taken over the
    rest."""
    from regnet_for_3d_grasping_torch.train import trainer
    forward_losses = trainer.forward_losses

    def half(model, batch, stage, **kw):
        keep = batch.pc.shape[0] // 2
        return forward_losses(model, trainer.DeviceBatch(
            *(t[:keep] for t in batch)), stage, **kw)
    trainer.forward_losses = half


def no_exchange() -> None:
    """Data parallelism: the exchange between the chips left out (each
    rank keeps its own gradients, statistics and metrics)."""
    from regnet_for_3d_grasping_torch.train import trainer
    trainer.average_over_mesh = lambda model, metrics, mesh: metrics


def plant(spec: str | None) -> None:
    """Plant ``"portbench.faults:<name>"`` (or nothing for None)."""
    if spec:
        import importlib
        module, _, name = spec.partition(":")
        getattr(importlib.import_module(module), name)()
