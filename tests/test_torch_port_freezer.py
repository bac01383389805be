"""The port's freezer (`nn/freezer.py`) against the JAX package's
``nn/freezer.py``, on the CPU: one pattern freezes the same parameters in
both packages (the port's names carried to JAX's through
`weights.variable_path`); a frozen parameter takes no update and holds no
Adam state; a frozen BatchNorm normalizes with its running statistics and
leaves them unchanged, as JAX's ``frozen_bn`` does (outputs rtol 1e-5,
statistics exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from regnet_for_3d_grasping_tpu.models import REGNet as JREGNet
from regnet_for_3d_grasping_tpu.nn import freezer as jfreezer
from regnet_for_3d_grasping_tpu.nn.layers import ConvBN as JConvBN
from regnet_for_3d_grasping_tpu.utils.config import tiny_config as jtiny

from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.config import tiny_config
from regnet_for_3d_grasping_torch.models.regnet import REGNet
from regnet_for_3d_grasping_torch.nn import freezer
from regnet_for_3d_grasping_torch.nn.layers import BatchNorm, ConvBN
from regnet_for_3d_grasping_torch.train import trainer

from test_torch_port_model import tiny_cloud

PATTERNS = [[r"^score_net"], [r"grn_head/.*/bn/"], [r"layer0/dense"],
            [r"^refine_head", r"sa2"], [r"no-such-module"]]


def path_of(kp) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in kp)


@pytest.fixture(scope="module")
def jax_params():
    """The shapes of JAX REGNet's params at tiny_config (no compile)."""
    return jax.eval_shape(JREGNet(jtiny()).init, {
        "params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.asarray(tiny_cloud(B=1)))["params"]


@pytest.mark.parametrize("patterns", PATTERNS, ids=str)
def test_masks_equal_jax(jax_params, patterns):
    jmask = jfreezer.freeze_mask(jax_params, patterns)
    want = {path_of(kp): bool(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(jmask)[0]}
    model = REGNet(tiny_config())
    got = freezer.freeze_mask(model, patterns)
    params = dict(model.named_parameters())
    assert {weights.variable_path(n, params[n].dim())[1]: v
            for n, v in got.items()} == want
    if patterns != [r"no-such-module"]:
        assert any(got.values()) and not all(got.values())


@pytest.fixture(scope="module")
def batch():
    """One tiny training batch from a synthetic scene."""
    from regnet_for_3d_grasping_torch.data import make_synthetic_scene
    from regnet_for_3d_grasping_torch.data.dataset import pad_gt_grasps
    cfg = tiny_config()
    s = make_synthetic_scene(3, num_view=cfg.region.num_points)
    frames, scores, valid = pad_gt_grasps(s, cfg.region.max_gt_grasps)
    pc = np.c_[s["view_cloud"], s["view_cloud_color"]].astype(np.float32)
    return trainer.DeviceBatch(
        torch.from_numpy(pc)[None],
        torch.from_numpy(np.tanh(s["view_cloud_score"]).astype(
            np.float32))[None],
        torch.from_numpy(frames)[None], torch.from_numpy(scores)[None],
        torch.from_numpy(valid)[None])


def train_step(model, opt, batch):
    return trainer.train_step(model, opt, batch, "refine",
                              generator=torch.Generator().manual_seed(1),
                              dropout_generator=torch.Generator()
                              .manual_seed(1))


def test_frozen_parameters_take_no_update_and_hold_no_state(batch):
    torch.manual_seed(0)
    model = REGNet(tiny_config(**{"model.dropout_prob": 0.0}))
    opt = trainer.make_optimizer(model, model.cfg, 1)
    patterns = [r"^score_net/backbone/sa0", r"refine_head/.*/kernel"]
    freezer.frozen_optimizer(opt.adam, model, patterns)
    mask = freezer.freeze_mask(model, patterns)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for _ in range(2):
        train_step(model, opt, batch)
    state_ids = {id(p) for p in opt.adam.state}
    moved = 0
    for n, p in model.named_parameters():
        if mask[n]:
            assert torch.equal(p, before[n]) and p.grad is None, n
        else:
            moved += not torch.equal(p, before[n])
        assert (id(p) in state_ids) != mask[n], n
    assert moved > 0.5 * (len(mask) - sum(mask.values()))
    with pytest.raises(ValueError, match="first step"):
        freezer.frozen_optimizer(opt.adam, model, [r"^grn_head"])


def test_frozen_bn_keeps_its_statistics_in_a_training_step(batch):
    torch.manual_seed(0)
    model = REGNet(tiny_config(**{"model.dropout_prob": 0.0}))
    opt = trainer.make_optimizer(model, model.cfg, 1)
    before = {n: b.clone() for n, b in model.named_buffers()}
    with freezer.frozen_bn(model, [r"score_net/backbone/sa[01]/"]):
        train_step(model, opt, batch)
    frozen = [m for n, m in model.named_modules()
              if isinstance(m, BatchNorm) and (".sa0." in n or ".sa1." in n)]
    assert len(frozen) == 6
    assert all(not m.frozen for m in frozen)          # restored on exit
    for n, b in model.named_buffers():
        hit = ".sa0." in n or ".sa1." in n
        assert torch.equal(b, before[n]) == hit, n


class TwoBlocks(fnn.Module):
    """The JAX package's frozen_bn test module (tests/test_nn_extras.py)."""

    @fnn.compact
    def __call__(self, x, train=False):
        return (JConvBN(4, name="block_a")(x, train=train)
                + JConvBN(4, name="block_b")(x, train=train))


class TorchTwoBlocks(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.block_a, self.block_b = ConvBN(3, 4), ConvBN(3, 4)

    def forward(self, x):
        return self.block_a(x) + self.block_b(x)


@pytest.mark.parametrize("patterns", [[r"block_a"], []], ids=str)
def test_frozen_bn_matches_jax(patterns):
    rng = np.random.RandomState(0)
    x = (rng.randn(8, 3) * 3 + 1).astype(np.float32)
    jm = TwoBlocks()
    variables = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0),
                                               jnp.asarray(x)))
    # running statistics away from their initial values
    for blk in ("block_a", "block_b"):
        variables["batch_stats"][blk]["bn"]["mean"] += 0.5
    want, mut = jfreezer.apply_with_frozen_bn(
        jm, variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
        bn_freeze_patterns=patterns)
    model = TorchTwoBlocks()
    weights.load_into(model, variables)
    model.train()
    with freezer.frozen_bn(model, patterns):
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for blk in ("block_a", "block_b"):
        bn = getattr(model, blk).bn
        for ours, theirs in (("running_mean", "mean"), ("running_var",
                                                        "var")):
            np.testing.assert_allclose(
                getattr(bn, ours).numpy(),
                np.asarray(mut["batch_stats"][blk]["bn"][theirs]),
                rtol=1e-6, atol=1e-7)
