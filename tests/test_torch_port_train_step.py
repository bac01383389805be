"""One training step per stage of the PyTorch port against the JAX package,
on the CPU at ``tiny_config()``: the f64 port against the f64 JAX package,
the f32 port against the f64 port.  The helpers, and the reason for f64,
are in ``tests/test_torch_port_train.py``.
"""

import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.models.regnet import REGNet
from regnet_for_3d_grasping_torch.train import trainer

from test_torch_port_train import (F64_TOL, SELECTIONS, assert_selections,
                                   assert_step_close, both_steps,
                                   build_scenario, full_scan_kernels, t)


@pytest.fixture(scope="module")
def scenario():
    return build_scenario()


@pytest.fixture(scope="module", params=["score", "region", "refine"])
def step_run(request, scenario):
    return (request.param,
            *both_steps(*scenario, request.param, full_scan_kernels)[1:])


def test_step_selections_exact(step_run):
    _, (rout, *_), (out64, *_), (out32, *_) = step_run
    assert_selections(out64, rout, SELECTIONS)
    assert_selections(out32, rout, SELECTIONS)
    s = rout.score
    assert np.abs(s - 0.5).min() > 1e-4 and 0.2 < (s > 0.5).mean() < 0.8


def test_step_f64_port_is_the_jax_formulas(step_run):
    stage, ref, got64, _ = step_run
    assert_step_close(got64, ref, F64_TOL, 1e-5, F64_TOL)
    metrics = got64[1]
    assert ("stage2_loss" in metrics) == (stage != "score")
    assert ("stage3_loss" in metrics) == (stage == "refine")
    if stage != "score":
        assert metrics["stage2_matched"] > 0
    if stage == "refine":
        # both stage-3 classes are present, so its loss is live
        assert metrics["stage3_positives"] > 0
        assert metrics["stage3_tn"] + metrics["stage3_fp"] > 0
        assert metrics["stage3_loss"] > 0


def test_step_f32_port_is_close_to_f64(step_run):
    """Loss and metrics rtol 1e-4, gradients 1e-3 of their block's largest
    entry, running statistics rtol 1e-4."""
    _, _, got64, got32 = step_run
    assert_step_close(got32, got64, dict(rtol=1e-4, atol=1e-6), 1e-3,
                      dict(rtol=1e-4, atol=1e-6))


def test_step_gradients_reach_the_stage_and_no_further(step_run):
    stage, (_, _, rgrads, _), (_, _, grads, _), _ = step_run
    live = {k.split("/")[1] for k, v in grads.items() if np.abs(v).max() > 0}
    want = {"score": {"score_net"}, "region": {"score_net", "grn_head"},
            "refine": {"score_net", "grn_head", "refine_head"}}[stage]
    assert live == want
    assert live == {k.split("/")[1] for k, v in rgrads.items()
                    if np.abs(v).max() > 0}


def test_pools_carry_gradient_into_the_backbone(scenario):
    """Of the proposal and refine losses alone, the backbone's gradient is
    what the two pools pass down (a wrapper that returned a fresh tensor would cut
    it without an error)."""
    _, cfg, variables, batch, _ = scenario
    model = REGNet(cfg)
    weights.load_into(model, variables)
    tb = trainer.DeviceBatch(*(t(np.asarray(x)) for x in batch))
    mp = pytest.MonkeyPatch()
    try:
        full_scan_kernels(mp)
        _, total, metrics = trainer.forward_losses(
            model.train(), tb, "refine", group_seeds=[1], crop_seeds=[[2]])
    finally:
        mp.undo()
    (metrics["stage2_loss"] + metrics["stage3_loss"]).backward()
    g = model.score_net.backbone.sa0.mlp.layer0.dense.weight.grad
    assert g is not None and float(g.abs().max()) > 0
    assert model.score_net.backbone.seg_mlp.layer0.dense.weight.grad is None


def test_train_step_updates_and_eval_step_does_not(scenario):
    """`trainer.train_step` moves the weights of the stage and the running
    statistics; `eval_step` moves nothing and builds no graph."""
    _, cfg, variables, batch, _ = scenario
    model = REGNet(cfg)
    weights.load_into(model, variables)
    tb = trainer.DeviceBatch(*(t(np.asarray(x)) for x in batch))
    opt = trainer.make_optimizer(model, cfg, 4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out, metrics = trainer.eval_step(model, tb, "refine",
                                     generator=torch.Generator().manual_seed(0))
    assert not out.score.requires_grad and not model.training
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    m = trainer.train_step(model, opt, tb, "region",
                           generator=torch.Generator().manual_seed(0),
                           dropout_generator=torch.Generator().manual_seed(0))
    assert model.training and np.isfinite(float(m["loss_total"]))
    after = model.state_dict()
    moved = {k.split(".")[0] for k in after
             if not torch.equal(after[k], before[k])}
    assert moved == {"score_net", "grn_head"}
    assert opt.updates == 1
