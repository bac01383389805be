"""Parity of the PyTorch port's training path with the JAX package, on the
CPU.

Inputs are made with numpy from fixed seeds and fed to both packages.  The
JAX side runs op by op (not under ``jit``: XLA rounds ``bpdist2``
differently when it fuses), its Pallas kernels in interpret mode; the port
runs the kernels' plain PyTorch versions.  The seeds the JAX model draws
from its keys are captured by wrapping its functions and handed to the
port.  Parity configurations set ``model.dropout_prob = 0`` (a threefry
mask cannot be reproduced); dropout is tested apart.

Tolerances: indices, counts, winners, masks and data arrays exact; the
pools' gradients rtol 1e-6 (the same sums, possibly in another order);
layers rtol 1e-5; losses and metrics of given outputs rtol 1e-5; the
optimizer rtol 1e-6; a whole step: selections exact, loss and metrics rtol
1e-4, parameter gradients 1e-3 of their block's largest entry, running
statistics rtol 1e-4, for the f32 port against the f64 port, which is held
to the f64 JAX package at 1e-6 (see the note above the whole-step helpers;
those tests are in ``tests/test_torch_port_train_step.py`` and
``tests/test_torch_port_train_slab.py``).
"""

import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regnet_for_3d_grasping_tpu.data import (
    GraspDataset as JGraspDataset, make_synthetic_scene as jmake_scene,
    write_synthetic_dataset as jwrite_dataset)
from regnet_for_3d_grasping_tpu.geometry import codec as jcodec
from regnet_for_3d_grasping_tpu.geometry import gt as jgt
from regnet_for_3d_grasping_tpu.models import REGNet as JREGNet
from regnet_for_3d_grasping_tpu.models.regnet import (
    REGNetOutput as JREGNetOutput)
from regnet_for_3d_grasping_tpu.nn import functional as jfunctional
from regnet_for_3d_grasping_tpu.nn.layers import SharedMLP as JSharedMLP
from regnet_for_3d_grasping_tpu.ops import slab as jslab
from regnet_for_3d_grasping_tpu.ops.sampling import (
    bucket_choice as jbucket_choice, bucket_stride as jbucket_stride,
    hash_uniform as jhash_uniform)
from regnet_for_3d_grasping_tpu.train import losses as jlosses
from regnet_for_3d_grasping_tpu.train import trainer as jtrainer
from regnet_for_3d_grasping_tpu.utils import checkpoint as jckpt
from regnet_for_3d_grasping_tpu.utils.config import (
    EvalConfig as JEvalConfig, ModelConfig as JModelConfig,
    PipelineConfig as JPipelineConfig, RegionConfig as JRegionConfig,
    TrainConfig as JTrainConfig, tiny_config as jtiny,
    train_config as jtrain_config)

from regnet_for_3d_grasping_torch import config as pconfig
from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.cli import train as train_cli
from regnet_for_3d_grasping_torch.data import (GraspDataset,
                                               make_synthetic_scene)
from regnet_for_3d_grasping_torch.data.dataset import pad_gt_grasps
from regnet_for_3d_grasping_torch.geometry import codec, gt, region
from regnet_for_3d_grasping_torch.models.regnet import REGNet, REGNetOutput
from regnet_for_3d_grasping_torch.nn import functional
from regnet_for_3d_grasping_torch.nn.layers import (BatchNorm, SharedMLP,
                                                    dropout)
from regnet_for_3d_grasping_torch.ops import ball_query, group, pooling, slab
from regnet_for_3d_grasping_torch.train import losses, trainer
from regnet_for_3d_grasping_torch.utils import checkpoint as ckpt
from regnet_for_3d_grasping_torch.utils.logging import MetricLogger

jregion = importlib.import_module("regnet_for_3d_grasping_tpu.geometry.region")
jregnet = importlib.import_module("regnet_for_3d_grasping_tpu.models.regnet")
jpooling = importlib.import_module("regnet_for_3d_grasping_tpu.ops.pooling")
jgroup_pallas = importlib.import_module(
    "regnet_for_3d_grasping_tpu.ops.group_pallas")
jbq = importlib.import_module("regnet_for_3d_grasping_tpu.ops.ball_query")
jbq_pallas = importlib.import_module(
    "regnet_for_3d_grasping_tpu.ops.ball_query_pallas")
jcrop_pallas = importlib.import_module(
    "regnet_for_3d_grasping_tpu.ops.crop_pallas")

CELL = 0.04


def t(a):
    return torch.from_numpy(np.array(a))


def seed_of(key) -> int:
    return int(np.asarray(jax.random.key_data(key)).reshape(-1)[-1])


def flat(tree, prefix="") -> dict:
    """Nested dicts -> {'/'-joined path: numpy array}."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, p))
        else:
            out[p] = np.asarray(v)
    return out


# --- K11: fused radius grouping ----------------------------------------------

@pytest.fixture(scope="module")
def group_case():
    """B=2, N=1100 (K*L = 2048: buckets 9-15 hold no column), M=130 (not a
    multiple of 128), the last center far from every point."""
    rng = np.random.RandomState(21)
    xyz = (rng.rand(2, 1100, 3) * 0.1).astype(np.float32)
    centers = xyz[:, rng.choice(1100, 130, replace=False)].copy()
    centers[:, -1] = 5.0
    return xyz, centers


def test_k11_plain_matches_pallas(group_case):
    xyz, centers = group_case
    K, radius, seed = 16, 0.02, 0xC0FFEE11
    ri, rc = jgroup_pallas.group_regions_pallas(
        jnp.asarray(xyz), jnp.asarray(centers), jnp.uint32(seed), radius, K,
        interpret=True)
    L = region.pallas_bucket_stride(1100, K)
    assert L == 128
    gi, gc = group.group_regions_fused(t(xyz), t(centers), seed, radius, K, L)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    assert gi.dtype == gc.dtype == torch.int32
    cnt = gc.numpy()
    assert (cnt[:, -1] == 0).all() and (gi.numpy()[:, -1] == 0).all()
    assert (cnt[:, :-1] > 0).all() and cnt.max() > K
    # empty buckets repeat the first non-empty bucket's pick
    assert (gi.numpy()[..., 9:] == gi.numpy()[..., :1]).all()
    d2 = ((centers[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(cnt, (d2 <= np.float32(radius ** 2)).sum(-1))


def test_k11_seed_and_chunking_do_not_leak(group_case):
    """Another seed gives other picks and the same counts; the plain
    version's chunking over centers changes nothing; both clouds of a batch
    draw the same noise field."""
    xyz, centers = group_case
    a = group.group_regions_fused_plain(t(xyz), t(centers), 1, 0.02, 16, 128)
    b = group.group_regions_fused_plain(t(xyz), t(centers), 2, 0.02, 16, 128)
    c = group.group_regions_fused_plain(t(xyz), t(centers), 1, 0.02, 16, 128,
                                        chunk=7)
    assert torch.equal(a[1], b[1]) and not torch.equal(a[0], b[0])
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    twice = np.stack([xyz[0], xyz[0]]), np.stack([centers[0], centers[0]])
    d = group.group_regions_fused_plain(t(twice[0]), t(twice[1]), 1, 0.02,
                                        16, 128)
    assert torch.equal(d[0][0], d[0][1])


def test_group_regions_kernel_branch_matches_jax(group_case):
    """K11's entry point against the JAX package's Pallas grouping
    (interpret), with the index masked where a center has no point in
    radius as a caller masks it; and `region.group_regions`, which no
    longer takes K11 (JAX's Pallas grouping is off on every backend),
    against JAX's `group_regions` as it runs, nothing patched."""
    xyz, centers = group_case
    key = jax.random.PRNGKey(12)
    L = region.pallas_bucket_stride(1100, 16)
    ri, rc = jgroup_pallas.group_regions_pallas(
        jnp.asarray(xyz), jnp.asarray(centers), jnp.uint32(seed_of(key)),
        0.02, 16, interpret=True)
    gi, gc = group.group_regions_fused(t(xyz), t(centers), seed_of(key),
                                       0.02, 16, L)
    masked = torch.where((gc > 0)[..., None], gi, 0)
    np.testing.assert_array_equal(
        masked.numpy(), np.where((np.asarray(rc) > 0)[..., None],
                                 np.asarray(ri), 0))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    assert not (gc[:, -1] > 0).any()
    ref = jregion.group_regions(key, jnp.asarray(xyz), jnp.asarray(centers),
                                16, 0.02, with_points=False)
    assert region.group_seed_count(130, 1100, 16) == 1
    got = region.group_regions(
        [int(np.asarray(jax.random.key_data(jax.random.split(key, 1)))
             [0, -1])], t(xyz), t(centers), 16, 0.02)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert got.slab_off is None and not got.valid[:, -1].any()
    with pytest.raises(ValueError, match="seeds"):
        region.group_regions([1, 2], t(xyz), t(centers), 16, 0.02)


@pytest.mark.parametrize("m,n,k", [(64, 25600, 256), (4000, 25600, 256),
                                   (8, 512, 16), (128, 4096, 64),
                                   (64, 25600, 100), (40, 25600, 256),
                                   (41, 25600, 256)])
def test_use_group_kernel_is_the_jax_shape_rule(m, n, k):
    """The full-scan grouping's shape rule is the JAX package's as it
    runs, nothing patched: its Pallas grouping is off everywhere, so the
    stride is `bucket_choice`'s, and the seeds one per chunk of 1,024
    centers, as JAX splits its key."""
    assert not jregion._use_pallas_group(m, n, k)
    assert region.group_stride(m, n, k) == jregion.group_stride(m, n, k) \
        == jbucket_stride(n, k)
    assert region.group_seed_count(m, n, k) == -(-m // 1024)


def test_group_kernel_threshold_covers_training_and_serving():
    """No threshold sends the served grouping to K11 any more: at the
    training (64 x 25,600) and serving (4,000 x 25,600) shapes it is the
    chunked path, 1 and 4 seeds, buckets of 100 columns."""
    assert not hasattr(region, "GROUP_KERNEL_MIN_WORK")
    assert not hasattr(region, "use_group_kernel")
    assert region.group_seed_count(64, 25600, 256) == 1
    assert region.group_seed_count(4000, 25600, 256) == 4
    assert region.group_stride(4000, 25600, 256) == 100
    assert region.group_stride(8, 512, 16) == 32


# --- K4 / K9: argmax form and first-winner backward ---------------------------

@pytest.fixture(scope="module")
def pool_case():
    """Bucket-structured indices from sparse masks (duplicate fills), one
    row with no pick (all-zero indices), and feature values on a coarse
    grid with many zeros, so maxima tie across different rows."""
    rng = np.random.RandomState(3)
    B, N, C, S, K = 2, 700, 24, 40, 16
    feat = np.maximum(np.round(rng.randn(B, N, C) * 2) / 2, 0).astype(
        np.float32)
    mask = rng.rand(B, S, N) < 0.012
    mask[0, 0] = False
    noise = jhash_uniform(jax.random.PRNGKey(5), mask.shape)
    idx, any_valid, _ = jbucket_choice(jnp.asarray(mask), K, score=noise)
    idx = np.asarray(jnp.where(any_valid[..., None], idx, 0), np.int32)
    return feat, idx, jbucket_stride(N, K)


def test_k4_argmax_plain_matches_pallas(pool_case):
    feat, idx, stride = pool_case
    rp, rw = jpooling.gather_max_pallas(jnp.asarray(feat), jnp.asarray(idx),
                                        stride, with_argmax=True,
                                        interpret=True)
    gp, gw = pooling.gather_max_argmax(t(feat), t(idx))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(rw))
    assert gw.dtype == torch.int32
    xp, xw = jpooling._xla_pooled_argmax(jnp.asarray(feat), jnp.asarray(idx))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(xw))
    assert torch.equal(gp, pooling.gather_max_plain(t(feat), t(idx)))
    assert (idx[0, 0] == 0).all() and (gw.numpy()[0, 0] == 0).all()
    # the case does hold ties across different rows
    g = feat[np.arange(2)[:, None, None], idx]            # [B, S, K, C]
    tied = (g == g.max(2, keepdims=True)).sum(2) > 1
    assert tied.mean() > 0.2


def test_k4_backward_is_the_first_winner_rule(pool_case):
    feat, idx, stride = pool_case
    gout = np.random.RandomState(4).randn(2, 40, 24).astype(np.float32)
    ref = jax.grad(lambda f: jnp.sum(jpooling.gather_max(
        f, jnp.asarray(idx), stride) * gout))(jnp.asarray(feat))
    f = t(feat).requires_grad_()
    pooled = pooling.gather_max(f, t(idx))
    assert pooled.requires_grad
    (pooled * t(gout)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)
    # not the gradient of amax, which splits a tie evenly
    f2 = t(feat).requires_grad_()
    (pooling.gather_max_plain(f2, t(idx)) * t(gout)).sum().backward()
    assert not torch.allclose(f.grad, f2.grad)
    # the scatter alone, on both plain routes
    _, win = pooling.gather_max_argmax(t(feat), t(idx))
    np.testing.assert_allclose(
        pooling.scatter_winner(t(gout), win, 700).numpy(), np.asarray(ref),
        rtol=1e-6, atol=0)


def test_gather_max_without_grad_keeps_the_plain_forward(pool_case):
    feat, idx, _ = pool_case
    f = t(feat).requires_grad_()
    with torch.no_grad():
        assert not pooling.gather_max(f, t(idx)).requires_grad
    assert not pooling.gather_max(t(feat), t(idx)).requires_grad


@pytest.fixture(scope="module")
def slab_pool_case():
    """Slab-structured indices of both geometries over a sorted cloud of 2
    scan blocks, B=2, with far queries (no covered slot) and features that
    tie."""
    rng = np.random.RandomState(6)
    B, N, C = 2, 4096, 20
    pts = rng.uniform(-0.12, 0.12, (B, N, 3)).astype(np.float32)
    pts[..., 2] *= 0.1
    u = rng.rand(B, N).astype(np.float32)
    _, sc = slab.sort_cloud(t(pts), CELL, t(u))
    centers = []
    for b in range(B):
        c = sc.xyz[b, rng.choice(N, 150, replace=False)].numpy()
        c = c[np.argsort(c[:, 0], kind="stable")]
        c[-3:] += 9.0
        centers.append(c)
    centers = np.stack(centers)
    feat = np.maximum(np.round(rng.randn(B, N, C) * 2) / 2, 0).astype(
        np.float32)
    g_idx, g_cnt, g_sel, g_off = slab.group_slab(sc, t(centers), 5, 0.03, 64,
                                                 CELL)
    g_idx = torch.where((g_sel & (g_cnt > 0))[..., None], g_idx, 0)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 150, 3, 3)).copy()
    c_idx, _, c_sel, c_off = slab.crop_slab(
        sc, t(eye), t(centers), 9, (0.0, 0.03, 0.04, 0.005), 8, CELL)
    c_idx = torch.where(c_sel[..., None], c_idx, 0)
    return feat, {"group": (g_idx, g_off, slab.GROUP_WIN, slab.GROUP_SPW),
                  "crop": (c_idx, c_off, slab.CROP_WIN, slab.CROP_SPW)}


@pytest.mark.parametrize("geometry", ["group", "crop"])
def test_k9_argmax_plain_matches_pallas(slab_pool_case, geometry):
    feat, cases = slab_pool_case
    idx, off, win, spw = cases[geometry]
    rp, rw = jslab.gather_max_slab(
        jnp.asarray(feat), jnp.asarray(idx.numpy()), jnp.asarray(off.numpy()),
        win, spw, with_argmax=True, interpret=True)
    gp, gw = slab.gather_max_slab_argmax(t(feat), idx, off, win, spw)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(rw))
    assert torch.equal(gp, slab.gather_max_slab_plain(t(feat), idx, off, win,
                                                      spw))
    none = ~slab.slab_cover(idx, off, win, spw).any(-1)
    assert none.any() and not none.all()
    assert (gp[none] == -1e38).all() and (gw[none] == 0).all()


@pytest.mark.parametrize("geometry", ["group", "crop"])
def test_k9_backward_matches_the_jax_vjp(slab_pool_case, geometry):
    feat, cases = slab_pool_case
    idx, off, win, spw = cases[geometry]
    S = idx.shape[1]
    valid = slab.slab_cover(idx, off, win, spw).any(-1)
    gout = np.random.RandomState(7).randn(2, S, 20).astype(np.float32)

    def jloss(f):
        pooled = jslab.gather_max_slab_vjp(
            f, jnp.asarray(idx.numpy()), jnp.asarray(off.numpy()), win, spw,
            True)
        pooled = jnp.where(jnp.asarray(valid.numpy())[..., None], pooled, 0.0)
        return jnp.sum(pooled * gout)

    ref = jax.grad(jloss)(jnp.asarray(feat))
    f = t(feat).requires_grad_()
    pooled = slab.gather_max_slab(f, idx, off, win, spw)
    pooled = torch.where(valid[..., None], pooled, torch.zeros_like(pooled))
    (pooled * t(gout)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)
    assert f.grad.abs().sum() > 0


# --- train-mode layers ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 50, 12), (2, 7, 5, 12)])
def test_train_mode_shared_mlp_matches_flax(shape):
    """Output, input and parameter gradients, and the updated running
    statistics of a two-layer SharedMLP in training mode."""
    rng = np.random.RandomState(8)
    x = rng.randn(*shape).astype(np.float32)
    gout = rng.randn(*shape[:-1], 9).astype(np.float32)
    jm = JSharedMLP((16, 9))
    variables = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0),
                                               jnp.asarray(x)))
    for i, layer in enumerate(("layer0", "layer1")):
        bn = variables["params"][layer]["bn"]
        bn["scale"] = (1 + 0.3 * rng.randn(*bn["scale"].shape)).astype(
            np.float32)
        bn["bias"] = (0.2 * rng.randn(*bn["bias"].shape)).astype(np.float32)
        st = variables["batch_stats"][layer]["bn"]
        st["mean"] = (0.1 * rng.randn(*st["mean"].shape)).astype(np.float32)
        st["var"] = (1 + rng.rand(*st["var"].shape)).astype(np.float32)

    def jloss(params, xx):
        y, mut = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xx,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(y * gout), (y, mut["batch_stats"])

    (_, (ry, rstats)), (rgp, rgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"],
                                             jnp.asarray(x))
    m = SharedMLP(12, (16, 9))
    weights.load_into(m, variables)
    m.train()
    xt = t(x).requires_grad_()
    y = m(xt)
    (y * t(gout)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    # a gradient is a sum over up to 150 rows of O(1) terms that cancel:
    # its absolute error is that of the terms, not of the sum
    gtol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(rgx), **gtol)
    got = weights.state_dict_to_jax(
        {k: p.grad for k, p in m.named_parameters()})
    for k, v in flat(rgp, "params").items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **gtol)
    stats = weights.state_dict_to_jax(m.state_dict())
    for k, v in flat(rstats, "batch_stats").items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-5, err_msg=k)
    # eval mode reads the statistics just written and writes none
    m.eval()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    ref_eval = jm.apply({"params": variables["params"],
                         "batch_stats": rstats}, jnp.asarray(x))
    np.testing.assert_allclose(m(t(x)).detach().numpy(), np.asarray(ref_eval),
                               **tol)
    assert all(torch.equal(v, before[k]) for k, v in m.state_dict().items())


def test_batchnorm_running_update_takes_the_biased_variance():
    bn = BatchNorm(1).train()
    x = torch.tensor([[1.0], [3.0]])
    bn(x)
    assert torch.allclose(bn.running_mean, torch.tensor([0.2]))
    # biased variance 1.0 (torch's BatchNorm1d would feed the unbiased 2.0)
    assert torch.allclose(bn.running_var, torch.tensor([0.9 + 0.1 * 1.0]))
    # a constant input: E[x^2] - E[x]^2 may round below 0 and is clamped
    y = bn(torch.full((4, 1), 1e3))
    assert torch.isfinite(y).all() and float(bn.running_var) > 0


def test_dropout_rate_scale_generator_and_eval():
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(5)
    y = dropout(x, 0.5, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    assert torch.equal(dropout(x, 0.5, torch.Generator().manual_seed(5)), y)
    assert not torch.equal(dropout(x, 0.5, g), y)
    assert abs(float((dropout(x, 0.2, g) != 0).float().mean()) - 0.8) < 0.01
    m = SharedMLP(500, (8,), dropout_prob=0.5)
    with pytest.raises(ValueError, match="Generator"):
        m.train()(x)
    a = m(x, torch.Generator().manual_seed(1))
    b = m(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and (a == 0).float().mean() > 0.4
    m.eval()
    assert torch.equal(m(x), m(x, torch.Generator().manual_seed(1)))


# --- codec, GT matching, losses -------------------------------------------------

def random_frames(rng, *lead):
    q, _ = np.linalg.qr(rng.randn(*lead, 3, 3))
    return q.astype(np.float32)


def test_frames_to_grasps_and_cos_dissimilarity_match_jax():
    rng = np.random.RandomState(9)
    frame = random_frames(rng, 4, 60)
    # theta near +-pi and a flipped axis_y both occur
    frame[0, 0] = np.array([[0, 0, 1], [0, -1, 0], [1e-7, 0, 0]],
                           np.float32).T
    center = rng.randn(4, 60, 3).astype(np.float32)
    scores = rng.rand(4, 60, 3).astype(np.float32)
    ref = jcodec.frames_to_grasps(jnp.asarray(frame), jnp.asarray(center),
                                  jnp.asarray(scores))
    got = codec.frames_to_grasps(t(frame), t(center), t(scores))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    assert (got[..., 3] >= 0).all() and (frame[..., 0, 1] < 0).any()
    a, b = rng.randn(5, 7, 3).astype(np.float32), rng.randn(
        5, 7, 3).astype(np.float32)
    b[0, 0] = 0.0
    np.testing.assert_allclose(
        codec.cos_dissimilarity(t(a), t(b)).numpy(),
        np.asarray(jcodec.cos_dissimilarity(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)


def gt_case(rng, B=2, NC=24, MG=32, n_valid=20):
    centers = (rng.rand(B, NC, 3) * 0.2).astype(np.float32)
    gt_frames = np.zeros((B, MG, 3, 4), np.float32)
    gt_frames[..., :3] = random_frames(rng, B, MG)
    gt_frames[..., 3] = (rng.rand(B, MG, 3) * 0.2).astype(np.float32)
    # some centers sit on a GT grasp, the last two far from every one
    gt_frames[:, :8, :, 3] = centers[:, :8]
    centers[:, -2:] += 3.0
    gt_scores = rng.rand(B, MG, 3).astype(np.float32)
    gt_valid = np.zeros((B, MG), bool)
    gt_valid[:, :n_valid] = True
    return centers, gt_frames, gt_scores, gt_valid


def test_match_centers_to_gt_matches_jax():
    args = gt_case(np.random.RandomState(10))
    rg, rm = jgt.match_centers_to_gt(*map(jnp.asarray, args), 0.005)
    gg, gm = gt.match_centers_to_gt(*map(t, args), 0.005)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
    np.testing.assert_allclose(gg.numpy(), np.asarray(rg), atol=1e-6, rtol=0)
    assert gm.any() and not gm[:, -2:].any()
    assert (gg[~gm] == -1).all()
    # the threshold is on the squared distance: 7 cm away still matches
    c = np.zeros((1, 1, 3), np.float32)
    f = np.zeros((1, 1, 3, 4), np.float32)
    f[0, 0, :, :3] = np.eye(3)
    f[0, 0, 0, 3] = 0.07
    one = np.ones((1, 1), bool)
    assert gt.match_centers_to_gt(t(c), t(f), t(np.ones((1, 1, 3),
                                                        np.float32)),
                                  t(one), 0.005)[1].item()


def random_output(rng, B=3, NC=20, N=90, order=False):
    """A REGNetOutput-shaped set of random arrays whose stage-3 classes
    hold positives and negatives."""
    A, R = 4, 10
    grasp_gt = rng.randn(B, NC, 10).astype(np.float32)
    grasp_gt[..., 3:6] /= np.linalg.norm(grasp_gt[..., 3:6], axis=-1,
                                         keepdims=True)
    matched = rng.rand(B, NC) < 0.8
    grasp_gt[~matched] = -1.0
    proposals = grasp_gt + 0.3 * rng.randn(B, NC, R).astype(np.float32)
    close = rng.rand(B, NC) < 0.5            # near their GT: positives
    proposals[close] = (grasp_gt + 0.004 * rng.randn(B, NC, R))[close]
    fields = dict(
        score=rng.rand(B, N), centers=rng.randn(B, NC, 6) * 0.1,
        center_index=rng.randint(0, N, (B, NC)),
        region_valid=rng.rand(B, NC) < 0.9,
        cls_logits=rng.randn(B, NC, A), reg=rng.randn(B, NC, A, R),
        anchor_index=rng.randint(0, A, (B, NC)), proposals=proposals,
        crop_valid=rng.rand(B, NC) < 0.8,
        refine_logits=rng.randn(B, NC, 2), refine_reg=rng.randn(B, NC, R),
        final_grasps=proposals + 0.1 * rng.randn(B, NC, R),
        refine_accept=rng.rand(B, NC) < 0.5,
        score_accept=rng.rand(B, NC) < 0.3,
        point_order=(np.stack([rng.permutation(N) for _ in range(B)])
                     .astype(np.int32) if order else None))
    fields = {k: (v.astype(np.float32) if isinstance(v, np.ndarray)
                  and v.dtype == np.float64 else v)
              for k, v in fields.items()}
    score_gt = np.tanh(rng.rand(B, N) * 2).astype(np.float32)
    return fields, score_gt, grasp_gt, matched


@pytest.mark.parametrize("stage2,stage3,order", [
    (True, True, False), (True, True, True), (True, False, False),
    (False, False, True)])
def test_regnet_losses_match_jax(stage2, stage3, order):
    rng = np.random.RandomState(11)
    fields, score_gt, grasp_gt, matched = random_output(rng, order=order)
    jout = JREGNetOutput(**{k: None if v is None else jnp.asarray(v)
                            for k, v in fields.items()})
    diff = ("score", "cls_logits", "reg", "proposals", "refine_logits",
            "refine_reg")

    def jloss(d):
        total, metrics = jlosses.regnet_losses(
            jout._replace(**d), jnp.asarray(score_gt), jnp.asarray(grasp_gt),
            jnp.asarray(matched), jtiny(), stage2, stage3)
        return total, metrics

    (rtotal, rmetrics), rgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(fields[k]) for k in diff})
    tf = {k: None if v is None else t(v) for k, v in fields.items()}
    for k in diff:
        tf[k].requires_grad_()
    total, metrics = losses.regnet_losses(
        REGNetOutput(**tf), t(score_gt), t(grasp_gt), t(matched),
        pconfig.tiny_config(), stage2, stage3)
    total.backward()
    assert metrics.keys() == rmetrics.keys()
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(rmetrics[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(rtotal),
                               rtol=1e-5)
    for k in diff:
        g = tf[k].grad
        g = torch.zeros_like(tf[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(rgrads[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    if stage3:
        assert float(rmetrics["stage3_positives"]) > 0
        assert float(rmetrics["stage3_loss"]) > 0
        assert float(rmetrics["stage3_tn"] + rmetrics["stage3_fp"]) > 0


def test_stage_losses_with_nothing_matched_are_zero():
    rng = np.random.RandomState(12)
    fields, score_gt, grasp_gt, matched = random_output(rng)
    tf = {k: None if v is None else t(v) for k, v in fields.items()}
    none = torch.zeros_like(t(matched))
    total, metrics = losses.regnet_losses(
        REGNetOutput(**tf), t(score_gt), torch.full_like(t(grasp_gt), -1.0),
        none, pconfig.tiny_config())
    assert float(metrics["stage2_loss"]) == 0.0
    assert float(metrics["stage3_loss"]) == 0.0
    assert float(total) == float(metrics["stage1_loss_score"])


def test_functional_extras_match_jax():
    rng = np.random.RandomState(13)
    logits = rng.randn(6, 5).astype(np.float32)
    target = rng.randint(0, 5, 6)
    for ls in (0.0, 0.1):
        np.testing.assert_allclose(
            float(functional.smooth_cross_entropy(t(logits), t(target), ls)),
            float(jfunctional.smooth_cross_entropy(
                jnp.asarray(logits), jnp.asarray(target), ls)), rtol=1e-6)
    np.testing.assert_array_equal(
        functional.encode_one_hot(t(target), 5).numpy(),
        np.asarray(jfunctional.encode_one_hot(jnp.asarray(target), 5)))
    assert functional.smooth_l1 is losses.smooth_l1


# --- optimizer --------------------------------------------------------------------

class _TwoGroups(torch.nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.score_net = torch.nn.ParameterDict(
            {"w": torch.nn.Parameter(t(a))})
        self.grn_head = torch.nn.ParameterDict(
            {"w": torch.nn.Parameter(t(b))})


def test_optimizer_matches_optax_across_an_epoch_boundary():
    """The same gradients into optax and the port for 6 updates with 2
    steps per epoch from epoch 4: the decay steps in at epoch 5, and the two
    groups keep their own rates."""
    rng = np.random.RandomState(14)
    a, b = (rng.randn(7, 3).astype(np.float32),
            rng.randn(5).astype(np.float32))
    over = {"train.lr_score": 3e-3, "train.lr_region": 1e-3}
    jopt = jtrainer.make_optimizer(jtiny(**over), 2, resume_epoch=4)
    params = {"score_net": {"w": jnp.asarray(a)},
              "grn_head": {"w": jnp.asarray(b)}}
    state = jopt.init(params)
    model = _TwoGroups(a, b)
    cfg = pconfig.tiny_config(**over)
    opt = trainer.make_optimizer(model, cfg, 2, resume_epoch=4)
    assert [g["lr"] for g in opt.adam.param_groups] == [3e-3, 1e-3]
    lrs = []
    for i in range(6):
        ga = rng.randn(7, 3).astype(np.float32) * 10.0 ** rng.randint(-3, 2)
        gb = rng.randn(5).astype(np.float32)
        updates, state = jopt.update(
            {"score_net": {"w": jnp.asarray(ga)},
             "grn_head": {"w": jnp.asarray(gb)}}, state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        model.score_net["w"].grad = t(ga)
        model.grn_head["w"].grad = t(gb)
        opt.step()
        lrs.append([g["lr"] for g in opt.adam.param_groups])
        np.testing.assert_allclose(model.score_net["w"].detach().numpy(),
                                   np.asarray(params["score_net"]["w"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(model.grn_head["w"].detach().numpy(),
                                   np.asarray(params["grn_head"]["w"]),
                                   rtol=1e-6, atol=1e-7)
    assert lrs[1] == [3e-3, 1e-3] and lrs[2] == [1.5e-3, 5e-4]
    assert opt.epoch == 7 and trainer.learning_rates(cfg, 10) == (
        3e-3 * 0.25, 1e-3 * 0.25)


def test_optimizer_counts_an_update_for_a_head_left_out_of_the_loss():
    """A stage without a head's loss gives it a zero gradient, not none:
    its weights stay and its Adam step count moves on, as in optax."""
    model = _TwoGroups(np.ones((2, 2), np.float32), np.ones(3, np.float32))
    opt = trainer.make_optimizer(model, pconfig.tiny_config(), 2)
    opt.zero_grad()
    model.score_net["w"].grad = torch.ones(2, 2)
    opt.step()
    assert torch.equal(model.grn_head["w"].detach(), torch.ones(3))
    assert int(opt.adam.state[model.grn_head["w"]]["step"]) == 1
    assert not torch.equal(model.score_net["w"].detach(), torch.ones(2, 2))


def test_train_step_refuses_iterated_refinement():
    cfg = pconfig.tiny_config(**{"region.refine_iters": 2})
    with pytest.raises(ValueError, match="refine_iters"):
        trainer._check_stage(cfg, "refine")
    trainer._check_stage(cfg, "region")
    with pytest.raises(ValueError, match="stage"):
        trainer._check_stage(cfg, "all")


# --- helpers of the whole-step tests ------------------------------------------------
# (the tests are in tests/test_torch_port_train_step.py and _slab.py, so that
# they run beside this file's)
#
# In f32 the two packages cannot be held to a tight tolerance through a whole
# training step: a train-mode BatchNorm divides by the spread of each channel,
# so every layer magnifies the rounding differences of the one before, and the
# JAX package's f32 step on the CPU (XLA accumulates the batch statistics row
# by row) differs from its own f64 evaluation by 3 % in the SA1 gradients of
# the tiny model, where the port's f32 step differs from its f64 evaluation by
# 1e-4.  So the JAX package is run in f64 here (``jax.enable_x64``, variables
# and batch cast up; the selections stay in f32 inside both packages), the
# port in f64 against it at a tolerance that only identical formulas meet, and
# the port in f32 against its own f64 run at the tolerances a training step
# needs.  The f32 layers and losses are held against f32 JAX above.

F64_TOL = dict(rtol=1e-6, atol=1e-9)

# no dropout (its mask cannot be reproduced), and a gripper several times the
# real one, so that at 512 points a scene some closing boxes hold more than
# 5 points and others do not
TINY = {"model.dropout_prob": 0.0, "gripper.width": 0.3,
        "gripper.depth": 0.3, "gripper.height": 0.12}
SELECTIONS = ("center_index", "region_valid", "anchor_index", "crop_valid",
              "refine_accept", "score_accept")


def scene_cloud(B, N, seed=0):
    """Synthetic tabletop scenes at their real size: structured (table,
    objects, colors) at the scale of the SA radii, so the backbone's
    channels vary from point to point and their normalisation is well
    conditioned."""
    pcs = []
    for b in range(B):
        s = jmake_scene(seed + b, num_view=N)
        pcs.append(np.c_[s["view_cloud"], s["view_cloud_color"]])
    return np.stack(pcs).astype(np.float32)


def spread_scores_and_shrink_residuals(variables):
    """Train-mode scores are sigmoid(standardised logit * scale + bias):
    scale 4 spreads them away from score_thre = 0.5, where rounding would
    flip the FPS mask.  A small residual scale keeps the decoded proposals
    near their anchors, so GT built from them gives stage-3 positives."""
    bb = variables["params"]["score_net"]["backbone"]
    bb["score_bn"]["scale"] = np.full_like(bb["score_bn"]["scale"], 4.0)
    reg3 = variables["params"]["grn_head"]["reg3"]["bn"]
    reg3["scale"] = np.full_like(reg3["scale"], 0.02)


class Spies:
    """Wrap the JAX model's selection functions, recording the u32 seeds
    and the sort noise they derive from their keys."""

    def __init__(self, mp):
        self.seen = {"crop": []}
        orig = dict(group=jregion.group_regions,
                    crop=jregion.closing_region_crop_dense,
                    sort=jslab.sort_cloud, ball=jslab.ball_query_slab)

        def group_spy(key, pc_, centers, K, radius, **kw):
            if kw.get("sorted_cloud") is not None \
                    and jregion._use_slab_group(pc_.shape[1], K):
                self.seen["group"] = [seed_of(key)]
                return orig["group"](key, pc_, centers, K, radius, **kw)
            # the full scan's chunked path, one seed a chunk, compiled as
            # the JAX package trains (eagerly, lax.map folds the cloud's
            # norms as a constant at another rounding)
            keys = jax.random.split(key, region.group_chunks(centers.shape[1]))
            self.seen["group"] = [
                int(x) for x in np.asarray(jax.random.key_data(keys))[:, -1]]
            return jax.jit(functools.partial(
                orig["group"], group_num=K, radius=radius, **kw))(
                    key, pc_, centers)

        def crop_spy(key, *a, **kw):
            self.seen["crop"].append([seed_of(key)])
            return orig["crop"](key, *a, **kw)

        def sort_spy(key, pc_, cell):
            self.seen["u"] = np.asarray(jax.random.uniform(key,
                                                           pc_.shape[:2]))
            return orig["sort"](key, pc_, cell)

        def ball_spy(sc, centers, seed, *a, **kw):
            self.seen["sa1"] = int(seed)
            return orig["ball"](sc, centers, seed, *a, **kw)

        mp.setattr(jregnet, "group_regions", group_spy)
        mp.setattr(jregnet, "closing_region_crop_dense", crop_spy)
        mp.setattr(jslab, "sort_cloud", sort_spy)
        mp.setattr(jslab, "ball_query_slab", ball_spy)

    def forward_kw(self) -> dict:
        kw = dict(group_seeds=self.seen["group"],
                  crop_seeds=self.seen["crop"][-1:])
        if "u" in self.seen:
            kw.update(sort_u=t(self.seen["u"]), sa1_seed=self.seen.get("sa1"))
        return kw


def full_scan_kernels(mp):
    """Ball query and crop on their kernel semantics on both sides: Pallas
    in interpret mode there, thresholds at 0 here.  Grouping is the JAX
    package's chunked path on both sides, as it is at every shape (its
    Pallas grouping is off)."""
    mp.setattr(jbq, "_use_pallas_bq", lambda *a: True)
    mp.setattr(jregion, "_use_pallas_crop", lambda *a: True)
    for mod, name in ((jbq_pallas, "ball_query_pallas"),
                      (jcrop_pallas, "closing_region_crop_pallas")):
        mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                interpret=True))
    mp.setattr(ball_query, "KERNEL_MIN_WORK", 0)
    mp.setattr(region, "CROP_KERNEL_MIN_WORK", 0)


def jax_step(jcfg, variables, batch, key, stage):
    """`trainer._step_body`'s loss and gradient, op by op, in f64 (call
    under ``jax.enable_x64(True)``)."""
    jmodel = JREGNet(jcfg)
    k_sample, k_drop = jax.random.split(key)
    up = functools.partial(jax.tree.map, lambda a: jnp.asarray(
        a, jnp.float64 if np.issubdtype(np.asarray(a).dtype, np.floating)
        else None))
    variables, batch = up(variables), jtrainer.DeviceBatch(*up(tuple(batch)))

    def loss_fn(params):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch.pc, train=True, with_refine=stage == "refine",
            rngs={"sampling": k_sample, "dropout": k_drop},
            mutable=["batch_stats"])
        grasp_gt, matched = jgt.match_centers_to_gt(
            out.centers[..., :3], batch.gt_frames, batch.gt_scores,
            batch.gt_valid, jcfg.region.gt_match_dist2)
        total, metrics = jlosses.regnet_losses(
            out, batch.score, grasp_gt, matched, jcfg,
            with_stage2=stage in ("region", "refine"),
            with_stage3=stage == "refine")
        return total, (mutated["batch_stats"], metrics, out)

    (_, (stats, metrics, out)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    assert out.cls_logits.dtype == jnp.float64
    to_np = functools.partial(jax.tree.map, np.asarray)
    return (to_np(out), {k: float(v) for k, v in metrics.items()},
            flat(grads, "params"), flat(stats, "batch_stats"))


def port_step(cfg, variables, batch, stage, forward_kw, dtype):
    """Forward, losses and backward of the port in training mode in
    `dtype` (no update: the gradients are what is compared)."""
    model = REGNet(cfg)
    weights.load_into(model, variables)
    model.train().to(dtype)
    tb = trainer.DeviceBatch(*(
        x.to(dtype) if x.is_floating_point() else x
        for x in (t(np.asarray(x)) for x in batch)))
    out, total, metrics = trainer.forward_losses(model, tb, stage,
                                                 **forward_kw)
    assert out.cls_logits.dtype == dtype
    total.backward()
    grads = weights.state_dict_to_jax(
        {k: (torch.zeros_like(p) if p.grad is None else p.grad).double()
         for k, p in model.named_parameters()})
    stats = {k: v for k, v in weights.state_dict_to_jax(
        {k: v.double() for k, v in model.state_dict().items()}).items()
        if k.startswith("batch_stats/")}
    out = REGNetOutput(*(None if v is None else v.detach().numpy()
                         for v in out))
    return out, {k: float(v.detach()) for k, v in metrics.items()}, grads, stats


def both_steps(jcfg, cfg, variables, batch, key, stage, patch):
    """The step in f64 JAX, the f64 port and the f32 port, on the same
    seeds."""
    mp = pytest.MonkeyPatch()
    try:
        patch(mp)
        spies = Spies(mp)
        with jax.enable_x64(True):
            ref = jax_step(jcfg, variables, batch, key, stage)
        kw = spies.forward_kw()
        got64 = port_step(cfg, variables, batch, stage, kw, torch.float64)
        got32 = port_step(cfg, variables, batch, stage, kw, torch.float32)
    finally:
        mp.undo()
    return spies.seen, ref, got64, got32


def build_scenario():
    """Tiny model on two scenes, with GT grasps built from the model's own
    train-mode proposals: each center gets a GT grasp at its own position
    with the proposal's orientation, every other one turned by 2 rad (a
    stage-3 negative)."""
    jcfg = jtiny(**TINY)
    cfg = pconfig.tiny_config(**TINY)
    pc = scene_cloud(2, jcfg.region.num_points)
    rng = np.random.RandomState(15)
    variables = jax.jit(JREGNet(jcfg).init)(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.asarray(pc))
    variables = jax.tree.map(np.array, variables)
    spread_scores_and_shrink_residuals(variables)
    # the proposals the GT is built from: a train-mode forward of the port
    # with seeds of its own (any run's proposals lie near these)
    model = REGNet(cfg)
    weights.load_into(model, variables)
    mp = pytest.MonkeyPatch()
    try:
        full_scan_kernels(mp)
        with torch.no_grad():
            out0 = model.train()(t(pc), group_seeds=[1], crop_seeds=[[2]])
    finally:
        mp.undo()
    B, NC = out0.centers.shape[:2]
    MG = jcfg.region.max_gt_grasps
    grasp = out0.proposals[..., :7].clone()
    grasp[..., :3] = out0.centers[..., :3]
    grasp[:, 1::2, 6] += 2.0
    frame, center = codec.grasps_to_frames(grasp)
    gt_frames = np.zeros((B, MG, 3, 4), np.float32)
    gt_frames[:, :NC, :, :3] = frame.numpy()
    gt_frames[:, :NC, :, 3] = center.numpy()
    gt_valid = np.zeros((B, MG), bool)
    gt_valid[:, :NC] = True
    batch = jtrainer.DeviceBatch(
        pc=pc, score=np.tanh(rng.rand(B, pc.shape[1]) * 2).astype(np.float32),
        gt_frames=gt_frames,
        gt_scores=rng.rand(B, MG, 3).astype(np.float32), gt_valid=gt_valid)
    return jcfg, cfg, variables, batch, jax.random.PRNGKey(3)


def assert_selections(out, ref, fields):
    for field in fields:
        np.testing.assert_array_equal(getattr(out, field),
                                      getattr(ref, field), err_msg=field)


def assert_step_close(got, ref, metric_tol, grad_rtol, stat_tol):
    """Metrics and running statistics by value; each gradient array within
    `grad_rtol` of the largest gradient entry of its ConvBN block (dense
    kernel, scale, bias).  A BatchNorm bias that feeds another BatchNorm
    has a gradient that is a small remainder of large cancelling sums: its
    error is that of the sums, which the block's kernel gradient scales."""
    (_, rmetrics, rgrads, rstats), (_, metrics, grads, stats) = ref, got
    assert metrics.keys() == rmetrics.keys()
    for k in metrics:
        np.testing.assert_allclose(metrics[k], rmetrics[k], err_msg=k,
                                   **metric_tol)
    assert grads.keys() == rgrads.keys() and stats.keys() == rstats.keys()
    scale = {}
    for k, v in rgrads.items():
        block = k.rsplit("/", 2)[0]
        scale[block] = max(scale.get(block, 0.0), float(np.abs(v).max()))
    for k, v in rgrads.items():
        np.testing.assert_allclose(
            grads[k], v, rtol=0, err_msg=k,
            atol=grad_rtol * scale[k.rsplit("/", 2)[0]] + 1e-12)
    for k, v in rstats.items():
        np.testing.assert_allclose(stats[k], v, err_msg=k, **stat_tol)


# --- helpers of the slab training step ----------------------------------------------

def slab_cfgs():
    model = dict(num_centroids=(512, 128, 64), num_neighbours=(16, 8, 8),
                 sa_channels=((16, 16, 32), (32, 32, 64), (64, 64, 128)),
                 fp_channels=((128, 128), (64, 64), (32, 32, 32)),
                 seg_channels=(32, 32, 32, 32), feature_channels=32,
                 refine_group_channels=16, dropout_prob=0.0)
    reg = dict(num_points=4096, center_num=64, group_num=64, gripper_num=16,
               max_gt_grasps=32, slab_cell=CELL)
    jcfg = JPipelineConfig(
        model=JModelConfig(**model),
        region=JRegionConfig(group_num_more=128, **reg),
        eval=JEvalConfig(max_grasps=32), train=JTrainConfig(batch_size=1))
    cfg = pconfig.PipelineConfig(model=pconfig.ModelConfig(**model),
                                 region=pconfig.RegionConfig(**reg))
    return jcfg, cfg


def run_slab_step():
    """One refine-stage step through the slab kernels (interpret) at the
    shapes of the JAX package's own slab training test: 4,096 points, 64
    centers, one synthetic scene with its own GT."""
    jcfg, cfg = slab_cfgs()
    s = jmake_scene(0, num_view=4096)
    frames, gscores, valid = pad_gt_grasps(s, 32)
    batch = jtrainer.DeviceBatch(
        pc=np.c_[s["view_cloud"], s["view_cloud_color"]][None].astype(
            np.float32),
        score=np.tanh(s["view_cloud_score"])[None].astype(np.float32),
        gt_frames=frames[None], gt_scores=gscores[None], gt_valid=valid[None])
    plain = JPipelineConfig(model=jcfg.model, region=JRegionConfig(
        num_points=4096, center_num=64, group_num=64, group_num_more=128,
        gripper_num=16, max_gt_grasps=32))
    variables = jax.jit(JREGNet(plain).init)(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.asarray(batch.pc))
    variables = jax.tree.map(np.array, variables)
    spread_scores_and_shrink_residuals(variables)

    def patch(mp):
        mp.setattr(jregion, "SLAB_INTERPRET", True)
        assert jregion._use_slab_group(4096, 64)
        assert jregion._use_slab_crop(4096, 16)
        assert jregion.use_slab_backbone(4096, 16)

    seen, *runs = both_steps(jcfg, cfg, variables, batch,
                             jax.random.PRNGKey(0), "refine", patch)
    assert "u" in seen and "sa1" in seen
    return runs


# --- data, weights, checkpoints, CLI ------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(layout="randomized"),
                                dict(view_index=2, gt_robust=2)])
def test_synthetic_scene_equals_the_jax_package(kw):
    a = make_synthetic_scene(3, num_view=600, **kw)
    b = jmake_scene(3, num_view=600, **kw)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
        else:
            assert a[k] == b[k]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    jwrite_dataset(str(d), num_scenes=6, num_view=512)
    return str(d)


@pytest.mark.parametrize("tag", ["train", "validate"])
def test_dataset_batches_equal_the_jax_package(data_dir, tag):
    args = (data_dir, tag, 512, 32, 1)
    a, b = GraspDataset(*args), JGraspDataset(*args)
    assert a.paths == b.paths and len(a) == (4 if tag == "train" else 2)
    for x, y in zip(a.batches(2, seed=5), b.batches(2, seed=5)):
        for f in x._fields:
            u, v = getattr(x, f), getattr(y, f)
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype and u.tobytes() == v.tobytes(), f
            else:
                assert u == v
    tb = trainer.device_batch(next(a.batches(2, seed=5)), "cpu")
    assert tb.pc.shape == (2, 512, 6) and tb.gt_valid.dtype == torch.bool


def test_config_presets_match_the_jax_package():
    for mine, theirs in ((pconfig.train_config(), jtrain_config()),
                         (pconfig.tiny_config(), jtiny())):
        for section in ("gripper", "model", "region", "eval", "train"):
            a, b = getattr(mine, section), getattr(theirs, section)
            for f in a.__dataclass_fields__:
                assert getattr(a, f) == getattr(b, f), (section, f)
        assert mine.group_radius == theirs.group_radius
    assert pconfig.train_config().train.batch_size == 12
    assert pconfig.train_config().region.center_num == 64


def test_state_dict_to_jax_inverts_jax_to_state_dict(tmp_path):
    arrays, epoch = weights.read_npz("weights/r5_real_e100.npz")
    back = weights.state_dict_to_jax(weights.jax_to_state_dict(arrays))
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    # the npz the port writes loads into the JAX package
    model = REGNet(pconfig.infer_config())
    weights.load_into(model, arrays)
    weights.write_npz(tmp_path / "w.npz", model, epoch)
    variables, ep = jckpt.load_weights_npz(str(tmp_path / "w.npz"))
    assert ep == epoch
    got = {**flat(variables["params"], "params"),
           **flat(variables["batch_stats"], "batch_stats")}
    assert got.keys() == arrays.keys()
    assert all(np.array_equal(got[k], arrays[k]) for k in arrays)


def test_fresh_model_follows_the_flax_initial_distribution():
    torch.manual_seed(0)
    model = REGNet(pconfig.tiny_config())
    w = model.grn_head.stem.dense.weight
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.05
    assert float(w.abs().max()) <= 2 / 0.8796 / np.sqrt(w.shape[1]) + 1e-6
    a = train_cli.build_model(pconfig.tiny_config(), 3, "cpu")
    b = train_cli.build_model(pconfig.tiny_config(), 3, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


def cli_args(tmp_path, data_dir, *extra):
    return ["--tiny", "--device", "cpu", "--data-path", data_dir,
            "--model-path", str(tmp_path / "models"), "--log-path",
            str(tmp_path / "log"), "--batch-size", "2", *extra]


def test_train_cli_runs_saves_and_resumes(tmp_path, data_dir, capsys):
    res = train_cli.main(cli_args(tmp_path, data_dir, "--mode", "train",
                                  "--epoch", "1", "--lr-step-epochs", "1"))
    assert len(res["steps"]) == 2 and len(res["validation"]) == 2
    assert all(np.isfinite(s["loss"]) for s in res["steps"])
    assert ckpt.latest_epoch(str(tmp_path / "models" / "default")) == 0
    saved = ckpt.load_checkpoint(str(tmp_path / "models" / "default"))
    assert saved["epoch"] == 0 and "opt_state" in saved["jax"]
    assert (tmp_path / "models" / "default" / "ckpt_0" / "_METADATA").exists()
    first = {k: v.clone() for k, v in res["model"].state_dict().items()}
    assert all(torch.equal(saved["model"][k], v) for k, v in first.items())

    res2 = train_cli.main(cli_args(tmp_path, data_dir, "--mode", "train",
                                   "--epoch", "2", "--lr-step-epochs", "1",
                                   "--resume"))
    assert "resumed from epoch 0" in capsys.readouterr().out
    assert [s["epoch"] for s in res2["steps"]] == [1, 1]
    assert ckpt.latest_epoch(str(tmp_path / "models" / "default")) == 1
    after = res2["model"].state_dict()
    assert any(not torch.equal(after[k], first[k]) for k in first)
    with open(tmp_path / "log" / "default" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    tags = {r["tag"] for r in recs}
    assert {"batch_train_loss_total", "batch_validate_stage3_loss",
            "epoch_train_loss"} <= tags
    steps = [r["step"] for r in recs if r["tag"] == "batch_train_loss_total"]
    assert steps == [0, 1, 2, 3]
    # resumed at epoch 1 with lr_step_epochs 1: the rate has halved, and
    # the Adam moments came back with the checkpoint
    assert [g["lr"] for g in res2["optimizer"].adam.param_groups] == [
        5e-4, 5e-4]
    saved2 = ckpt.load_checkpoint(str(tmp_path / "models" / "default"))
    adam = saved2["jax"]["opt_state"]["inner_states"]["score"][
        "inner_state"]
    assert int(adam[0]["count"]) == int(adam[1]["count"]) == 4
    assert int(saved2["jax"]["step"]) == 4


@pytest.mark.parametrize("mode,extra", [
    ("pretrain_score", []), ("pretrain_region", ["--center-jitter", "8,16"]),
    ("train", ["--slab-cell", "0.04", "--fps-groups", "2",
               "--eval-center-num", "16"])])
def test_train_cli_modes_and_knobs(tmp_path, data_dir, mode, extra):
    res = train_cli.main(cli_args(tmp_path, data_dir, "--mode", mode,
                                  "--epoch", "1", *extra))
    assert len(res["steps"]) == 2
    assert all(np.isfinite(s["loss"]) for s in res["steps"])
    keys = res["validation"][0].keys()
    assert ("stage2_loss" in keys) == (mode != "pretrain_score")
    assert ("stage3_loss" in keys) == (mode == "train")
    # validation forwards keep the exact configuration
    assert res["eval_cfg"].region.slab_cell == 0.0
    assert res["eval_cfg"].model.fps_groups == 1
    assert res["cfg"].region.slab_cell == (0.04 if "--slab-cell" in extra
                                           else 0.0)
    if "--fps-groups" in extra:
        assert res["model"].score_net.backbone.sa0.fps_groups == 2


def test_validate_mode_and_partial_loads(tmp_path, data_dir, capsys):
    train_cli.main(cli_args(tmp_path, data_dir, "--mode", "pretrain_score",
                            "--epoch", "1", "--tag", "s"))
    res = train_cli.main(cli_args(tmp_path, data_dir, "--mode", "validate",
                                  "--tag", "s", "--resume"))
    assert res["steps"] == [] and len(res["validation"]) == 2
    res = train_cli.main(cli_args(
        tmp_path, data_dir, "--mode", "test_region", "--tag", "other",
        "--load-score-path", str(tmp_path / "models" / "s"),
        "--load-region-path", str(tmp_path / "models" / "s" / "ckpt_0")))
    assert "loaded" in capsys.readouterr().out
    saved = ckpt.load_checkpoint(str(tmp_path / "models" / "s"))["model"]
    got = res["model"].state_dict()
    assert all(torch.equal(got[k], saved[k]) for k in got)
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "models" / "missing"))


def test_train_cli_without_a_card_fails_and_rejects_unported_flags(
        tmp_path, data_dir):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_cli.main(["--mode", "train", "--tiny", "--data-path",
                            data_dir])
    # the flags once rejected as unported are all accepted now (their own
    # tests: tests/test_torch_port_train_eval.py, _augment, _native_loader,
    # _remat); the JAX CLI has no flag the parser refuses
    import importlib
    jparser = importlib.import_module(
        "regnet_for_3d_grasping_tpu.cli.train").build_parser()
    ours = {a for act in train_cli.build_parser()._actions
            for a in act.option_strings}
    assert {a for act in jparser._actions
            for a in act.option_strings} <= ours
    for flag in (["--eval-grasps"], ["--eval-every", "2"],
                 ["--native-loader"], ["--geom-aug", "1.0"],
                 ["--profile-dir", "x"], ["--remat"]):
        args = train_cli.build_parser().parse_args(
            cli_args(tmp_path, data_dir, "--mode", "train", *flag))
        assert args.mode == "train"
    with pytest.raises(SystemExit):
        train_cli.build_parser().parse_args(
            cli_args(tmp_path, data_dir, "--mode", "train", "--dp"))


@pytest.mark.parametrize("extra", [[], ["--slab-cell", "0.04",
                                         "--fps-groups", "2"]])
def test_train_cli_bf16_trains_on_the_cpu(tmp_path, data_dir, extra):
    """``--bf16 --device cpu`` (once rejected with the unported flags)
    trains: the train steps' network in bf16 with f32 parameters, the
    validation forwards f32 at exact geometry on a model of their own."""
    res = train_cli.main(cli_args(tmp_path, data_dir, "--mode", "train",
                                  "--epoch", "1", "--bf16", *extra))
    assert len(res["steps"]) == 2 and len(res["validation"]) == 2
    assert all(np.isfinite(s["loss"]) for s in res["steps"])
    assert all(np.isfinite(v["loss_total"]) for v in res["validation"])
    assert res["cfg"].model.compute_dtype == "bfloat16"
    assert res["eval_cfg"].model.compute_dtype == "float32"
    assert res["eval_cfg"].region.slab_cell == 0.0
    model = res["model"]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(m.running_mean.dtype == torch.float32 for m in model.modules()
               if isinstance(m, BatchNorm))
    fresh = train_cli.build_model(res["cfg"], 1, "cpu").state_dict()
    moved = {k.split(".")[0] for k, v in model.state_dict().items()
             if not torch.equal(v, fresh[k])}
    assert moved == {"score_net", "grn_head", "refine_head"}


def test_metric_logger_copies_tensors_once(tmp_path):
    with MetricLogger(str(tmp_path), "x") as log:
        log.scalars({"a": torch.tensor(1.5), "b": 2, "c": torch.tensor(3)},
                    7, "train")
        log.scalar("epoch_train_loss", 0.25, 1)
    with open(tmp_path / "x" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [(r["tag"], r["value"], r["step"]) for r in recs] == [
        ("batch_train_a", 1.5, 7), ("batch_train_b", 2.0, 7),
        ("batch_train_c", 3.0, 7), ("epoch_train_loss", 0.25, 1)]
