"""The reference-checkpoint converter (`utils/torch_import.
convert_torch_state_dicts`, JAX ``utils/torch_import.py``), on the CPU.

No reference checkpoint is in the repository, so the state_dicts come from
``tests/torch_refnet.py``, the repo's restatement of the reference network
under the reference's parameter names, randomly initialised (BatchNorm
statistics too).  They go into the port through its converter and into
the JAX package through its own; the three forwards are compared at the
value-parity configuration (``ball_query_method="exact"``, the reference
CUDA ball query's first K in index order).

Tolerances: the port against torch_refnet as the JAX package's own test
holds flax to it (features atol 2e-4, rtol 1e-3; scores atol 2e-5;
heads atol 2e-4, rtol 1e-3); the port against JAX rtol 1e-5, atol 1e-5
(the same f32 layers, products summed in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.models.heads import (
    RefineHead as JRefineHead, TwoStageHead as JTwoStageHead)
from regnet_for_3d_grasping_tpu.models.score_net import ScoreNet as JScoreNet
from regnet_for_3d_grasping_tpu.utils.config import (
    ModelConfig as JModelConfig)
from regnet_for_3d_grasping_tpu.utils.torch_import import (
    convert_torch_state_dicts as jconvert)

from regnet_for_3d_grasping_torch.config import ModelConfig, train_config
from regnet_for_3d_grasping_torch.models.heads import RefineHead, TwoStageHead
from regnet_for_3d_grasping_torch.models.regnet import REGNet
from regnet_for_3d_grasping_torch.models.score_net import ScoreNet
from regnet_for_3d_grasping_torch.utils.torch_import import (
    block_map, convert_torch_state_dicts)

from torch_refnet import (TorchRefine, TorchScoreNet, TorchTwoStage,
                          _randomize_bn)

PORT_TOL = dict(rtol=1e-5, atol=1e-5)

PARITY = dict(num_centroids=(48, 24, 12), radii=(0.25, 0.35, 0.6),
              num_neighbours=(8, 8, 8),
              sa_channels=((16, 16, 32), (32, 32, 64), (64, 64, 128)),
              fp_channels=((128, 128), (64, 64), (32, 32, 32)),
              seg_channels=(32, 32, 32, 32), feature_channels=32,
              refine_group_channels=16, ball_query_method="exact")


class _Shell(torch.nn.Module):
    """The reference heads under the reference GRN's attribute names."""

    def __init__(self, cfg):
        super().__init__()
        self.extrat_feature_region = TorchTwoStage(cfg)
        self.extrat_feature_refine = TorchRefine(cfg)


def jtrees(variables, name):
    return ({name: jax.tree.map(np.asarray, variables["params"])},
            {name: jax.tree.map(np.asarray, variables["batch_stats"])})


def test_score_net_through_the_converter_matches_torch_and_jax():
    cfg, jcfg = ModelConfig(**PARITY), JModelConfig(**PARITY)
    rng = np.random.RandomState(0)
    torch.manual_seed(0)
    tnet = TorchScoreNet(jcfg).eval()
    _randomize_bn(tnet, rng)
    with torch.no_grad():    # spread the sigmoid inputs away from 0
        tnet.extrat_featurePN2.conv_score.weight.mul_(40.0)
    pc = np.c_[rng.rand(192, 3), rng.rand(192, 3)].astype(np.float32)[None]
    with torch.no_grad():
        t_feat, t_score = tnet(torch.from_numpy(pc))

    port = torch.nn.ModuleDict({"score_net": ScoreNet(cfg)})
    sd = {f"module.{k}": v for k, v in tnet.state_dict().items()}
    report = convert_torch_state_dicts(sd, None, port)
    # every conv and BatchNorm of the 9 SA, 7 FP and 4 seg head blocks and
    # the score layer: 21 convs, 21 BatchNorms of 4 tensors
    assert len(report) == 21 + 21 * 4 and len(set(report)) == len(report)
    port.eval()
    with torch.no_grad():
        feat, score = port["score_net"](torch.from_numpy(pc))
    np.testing.assert_allclose(feat.numpy(), t_feat.numpy(), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(score.numpy(), t_score.numpy(), atol=2e-5)
    assert float(t_feat.std()) > 1e-2 and float(t_score.std()) > 1e-4

    jm = JScoreNet(jcfg)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(pc))
    params, stats, jreport = jconvert(tnet.state_dict(), None,
                                      *jtrees(variables, "score_net"))
    assert len(jreport) == 21 + 21 * 4
    ref_feat, ref_score = jm.apply({"params": params["score_net"],
                                    "batch_stats": stats["score_net"]},
                                   jnp.asarray(pc))
    np.testing.assert_allclose(feat.numpy(), np.asarray(ref_feat),
                               **PORT_TOL)
    np.testing.assert_allclose(score.numpy(), np.asarray(ref_score),
                               **PORT_TOL)


def test_heads_through_the_converter_match_torch_and_jax():
    cfg, jcfg = ModelConfig(**PARITY), JModelConfig(**PARITY)
    rng = np.random.RandomState(2)
    torch.manual_seed(2)
    shell = _Shell(jcfg).eval()
    _randomize_bn(shell, rng)
    group = rng.randn(2, 6, 16, 32).astype(np.float32)
    gripper = rng.randn(2, 6, 8, 32).astype(np.float32)
    with torch.no_grad():
        t_cls, t_reg, t_pooled = shell.extrat_feature_region(
            torch.from_numpy(group))
        t_rcls, t_rreg = shell.extrat_feature_refine(
            torch.from_numpy(gripper), t_pooled)

    port = torch.nn.ModuleDict({"grn_head": TwoStageHead(cfg),
                                "refine_head": RefineHead(cfg)})
    report = convert_torch_state_dicts(None, shell.state_dict(), port)
    assert len(report) == 12 * 5 and all(
        k.startswith(("grn_head.", "refine_head.")) for k in report)
    port.eval()
    pooled = torch.from_numpy(group).amax(-2)
    gpooled = torch.from_numpy(gripper).amax(-2)
    with torch.no_grad():
        cls, reg = port["grn_head"](pooled)
        rcls, rreg = port["refine_head"](gpooled, pooled)
    for got, want in ((cls, t_cls), (reg, t_reg), (rcls, t_rcls),
                      (rreg, t_rreg)):
        np.testing.assert_allclose(got.numpy(), want.numpy().reshape(
            got.shape), atol=2e-4, rtol=1e-3)

    grn, ref = JTwoStageHead(jcfg), JRefineHead(jcfg)
    gv = grn.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(pooled))
    rv = ref.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(gpooled),
                  jnp.asarray(pooled))
    params, stats, _ = jconvert(
        None, shell.state_dict(),
        {"grn_head": jax.tree.map(np.asarray, gv["params"]),
         "refine_head": jax.tree.map(np.asarray, rv["params"])},
        {"grn_head": jax.tree.map(np.asarray, gv["batch_stats"]),
         "refine_head": jax.tree.map(np.asarray, rv["batch_stats"])})
    jcls, jreg = grn.apply({"params": params["grn_head"],
                            "batch_stats": stats["grn_head"]},
                           jnp.asarray(pooled))
    jrcls, jrreg = ref.apply({"params": params["refine_head"],
                              "batch_stats": stats["refine_head"]},
                             jnp.asarray(gpooled), jnp.asarray(pooled))
    for got, want in ((cls, jcls), (reg, jreg), (rcls, jrcls),
                      (rreg, jrreg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **PORT_TOL)


def test_converter_fills_every_block_of_regnet_and_rejects_a_mismatch():
    """At the reference architecture every mapped block of REGNet is filled
    (a conv [Cout, Cin, 1] becomes the Dense [Cout, Cin] as it is, conv
    biases are skipped), and a wrong shape raises."""
    model = REGNet(train_config())
    state = model.state_dict()
    rng = np.random.RandomState(1)
    score_sd, region_sd = {}, {}
    for ours, (conv, bn) in block_map().items():
        sd = score_sd if ours.startswith("score_net") else region_sd
        if conv is not None:
            w = state[f"{ours}.dense.weight" if bn is not None
                      else f"{ours}.weight"]
            sd[f"{conv}.weight"] = rng.randn(*w.shape, 1).astype(np.float32)
            sd[f"{conv}.bias"] = rng.randn(w.shape[0]).astype(np.float32)
        if bn is not None:
            c = state[(ours if conv is None else f"{ours}.bn")
                      + ".weight"].shape[0]
            for k in ("weight", "bias", "running_mean", "running_var"):
                sd[f"{bn}.{k}"] = torch.from_numpy(
                    rng.rand(c).astype(np.float32))
    report = convert_torch_state_dicts(score_sd, region_sd, model)
    assert len(report) == len(state)       # every tensor of the model
    w = score_sd["extrat_featurePN2.sa_modules.0.mlp.0.conv.weight"]
    np.testing.assert_array_equal(
        model.state_dict()["score_net.backbone.sa0.mlp.layer0.dense.weight"]
        .numpy(), w[..., 0])
    np.testing.assert_array_equal(
        model.state_dict()["grn_head.reg3.bn.running_var"].numpy(),
        region_sd["extrat_feature_region.bn_reg4.running_var"].numpy())
    bad = dataclasses.replace(ModelConfig(**PARITY),
                              seg_channels=(32, 32, 32, 16))
    tnet = TorchScoreNet(JModelConfig(**PARITY))
    with pytest.raises(ValueError, match="shape"):
        convert_torch_state_dicts(tnet.state_dict(), None,
                                  torch.nn.ModuleDict(
                                      {"score_net": ScoreNet(bad)}))
