"""The op library's last functions (JAX ``ops/ball_query.py:116-163``,
``ops/distances.py:20-51``, ``ops/sampling.py:56-86``,
``geometry/region.py:188-300``), on the CPU, against the JAX package:
the exact ball query, `bpdist`, `pdist2`, `masked_random_choice` (fed
JAX's uniforms), two-scale grouping and the crop from the wide region,
and the ``ops`` and ``geometry`` exports.

The JAX functions built on ``lax.map`` run compiled (`jax.jit`), as the
JAX package runs them: op by op, ``lax.map`` traces its body with the
points as a constant, and XLA folds their norms at another rounding.

Tolerances: indices, counts and masks exact; distances bit-equal at 3
channels (the JAX CPU order of the products and sums), rtol 1e-6 at 6;
gripper-frame points atol 1e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.ops import distances as jdist
from regnet_for_3d_grasping_tpu.ops import sampling as jsamp
from regnet_for_3d_grasping_tpu.utils.config import (
    GripperConfig as JGripperConfig, infer_config as jinfer_config)

import regnet_for_3d_grasping_torch.geometry as pgeometry
import regnet_for_3d_grasping_torch.ops as pops
from regnet_for_3d_grasping_torch.config import GripperConfig, infer_config
from regnet_for_3d_grasping_torch.geometry import region
from regnet_for_3d_grasping_torch.ops import ball_query, distances, sampling

jbq = importlib.import_module("regnet_for_3d_grasping_tpu.ops.ball_query")
jregion = importlib.import_module("regnet_for_3d_grasping_tpu.geometry.region")


def t(a):
    return torch.from_numpy(np.array(a))


def key_seeds(key, n) -> list:
    return [int(s) for s in np.asarray(jax.random.key_data(
        jax.random.split(key, n)))[:, -1]]


@pytest.fixture(scope="module")
def cloud():
    """B=2, N=1100, M=130 in a 10 cm cube; the last center far from every
    point (an empty row)."""
    rng = np.random.RandomState(12)
    xyz = (rng.rand(2, 1100, 3) * 0.1).astype(np.float32)
    centers = xyz[:, rng.choice(1100, 130, replace=False)].copy()
    centers[:, -1] = 5.0
    return xyz, centers


@pytest.mark.parametrize("radius,K,chunk", [(0.012, 16, 256), (0.03, 32, 4096),
                                            (0.02, 1200, 512)])
def test_exact_ball_query_matches_jax(cloud, radius, K, chunk):
    """The first K in-radius points in index order: short rows (radius
    0.012: a few points), full rows capped at K, K past N, and an empty
    row; JAX's chunks over the points and top-K merge at 256 and 512."""
    xyz, centers = cloud
    ri, rc = jax.jit(lambda x, c: jbq.ball_query(
        x, c, radius, K, chunk=chunk, method="exact"))(
            jnp.asarray(xyz), jnp.asarray(centers))
    gi, gc = ball_query.ball_query(t(xyz), t(centers), radius, K,
                                   method="exact")
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    assert gi.dtype == gc.dtype == torch.int32
    cnt = gc.numpy()
    assert (cnt[:, -1] == 0).all() and (gi.numpy()[:, -1] == 0).all()
    assert (cnt < min(K, 1100)).any() and (cnt[:, :-1] > 0).all()
    # the rows are the first hits, ascending, padded with the first
    row = gi.numpy()[0, 0, :cnt[0, 0]]
    assert (np.diff(row) > 0).all()
    assert (gi.numpy()[0, 0, cnt[0, 0]:] == row[0]).all()
    with pytest.raises(ValueError, match="method"):
        ball_query.ball_query(t(xyz), t(centers), radius, K, method="knn")


@pytest.mark.parametrize("C", [3, 6])
def test_bpdist_and_pdist2_match_jax(cloud, C):
    rng = np.random.RandomState(C)
    a = (rng.rand(2, 70, C) * 0.3).astype(np.float32)
    b = (rng.rand(90, C) * 0.3).astype(np.float32)
    ref_self = np.asarray(jdist.bpdist(jnp.asarray(a)))
    ref_pair = np.asarray(jdist.pdist2(jnp.asarray(a[0]), jnp.asarray(b)))
    got_self = distances.bpdist(t(a)).numpy()
    got_pair = distances.pdist2(t(a[0]), t(b)).numpy()
    if C == 3:
        np.testing.assert_array_equal(got_self, ref_self)
        np.testing.assert_array_equal(got_pair, ref_pair)
    else:
        np.testing.assert_allclose(got_self, ref_self, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got_pair, ref_pair, rtol=1e-6, atol=1e-7)
    assert (got_self >= 0).all() and got_self.shape == (2, 70, 70)


def test_masked_random_choice_matches_jax():
    """Fed JAX's uniforms: rows with at least k entries (a subset without
    replacement), fewer (cycled) and none (index 0, not valid)."""
    rng = np.random.RandomState(3)
    mask = rng.rand(4, 6, 50) < np.array([0.6, 0.1, 0.02, 0.0])[:, None,
                                                                   None]
    key = jax.random.PRNGKey(9)
    ri, rv, rc = jsamp.masked_random_choice(key, jnp.asarray(mask), 12)
    noise = np.asarray(jax.random.uniform(key, mask.shape, minval=0.5,
                                          maxval=1.0))
    gi, gv, gc = sampling.masked_random_choice(None, t(mask), 12,
                                               noise=t(noise))
    for g, r in ((gi, ri), (gv, rv), (gc, rc)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (gc.numpy()[0] >= 12).all() and (gc.numpy()[3] == 0).all()
    assert ((gc.numpy()[1] > 0) & (gc.numpy()[1] < 12)).any()
    # its own draw: valid entries only, distinct where there are enough
    i, v, c = sampling.masked_random_choice(torch.Generator().manual_seed(1),
                                            t(mask), 12)
    picked = np.take_along_axis(mask, i.numpy().astype(np.int64), -1)
    assert picked[c.numpy() > 0].all()
    full = i.numpy()[0].reshape(-1, 12)
    assert all(len(set(r)) == 12 for r in full)


@pytest.fixture(scope="module")
def two_scales(cloud):
    """JAX's two-scale grouping at 2,100 centers (3 chunks, 6 keys) and
    the port's on the same seeds."""
    xyz, _ = cloud
    centers = (np.random.RandomState(13).rand(2, 2100, 3) * 0.1).astype(
        np.float32)
    centers[:, 7] = 5.0
    key = jax.random.PRNGKey(21)
    ra, rb = jax.jit(lambda k, p, c: jregion.group_regions_two_scales(
        k, p, c, 16, 0.01, 64, 0.025, with_points=False))(
            key, jnp.asarray(xyz), jnp.asarray(centers))
    seeds = key_seeds(key, 2 * region.group_chunks(2100))
    ga, gb = region.group_regions_two_scales(seeds, t(xyz), t(centers), 16,
                                             0.01, 64, 0.025)
    return xyz, centers, (ra, rb), (ga, gb)


def test_two_scale_grouping_matches_jax(two_scales):
    _, _, refs, gots = two_scales
    for ref, got in zip(refs, gots):
        np.testing.assert_array_equal(got.index.numpy(),
                                      np.asarray(ref.index))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(ref.valid))
    assert not gots[1].valid[:, 7].any() and gots[1].valid.sum() > 4000
    with pytest.raises(ValueError, match="seeds"):
        region.group_regions_two_scales([1, 2], t(two_scales[0]),
                                        t(two_scales[1]), 16, 0.01, 64,
                                        0.025)


@pytest.mark.parametrize("with_points", [True, False])
def test_closing_region_crop_matches_jax(two_scales, with_points):
    """The crop from the wide scale's indices, gripper-frame points and
    colours (JAX ``region.py:251-300``)."""
    xyz, centers, (_, rwide), _ = two_scales
    rng = np.random.RandomState(14)
    B, M = centers.shape[:2]
    axis = rng.randn(B, M, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    grasp = np.concatenate([centers, axis, rng.uniform(
        -np.pi, np.pi, (B, M, 1))], -1).astype(np.float32)
    pc = np.concatenate([xyz, rng.rand(*xyz.shape).astype(np.float32)], -1)
    key = jax.random.PRNGKey(5)
    ref = jregion.closing_region_crop(
        key, jnp.asarray(pc), rwide.index, jnp.asarray(grasp),
        JGripperConfig(), 16, with_points=with_points)
    seed = int(np.asarray(jax.random.key_data(key)).reshape(-1)[-1])
    got = region.closing_region_crop(seed, t(pc), t(rwide.index),
                                     t(grasp), GripperConfig(), 16,
                                     with_points=with_points)
    np.testing.assert_array_equal(got.index_in_all.numpy(),
                                  np.asarray(ref.index_in_all))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert got.valid.any() and not got.valid.all()
    if with_points:
        np.testing.assert_allclose(got.points.numpy(),
                                   np.asarray(ref.points), atol=1e-6)
    else:
        assert got.points is None and ref.points is None


def test_infer_config_wide_region_matches_jax():
    for cfg, jcfg in ((infer_config(), jinfer_config()),):
        assert cfg.region.r_time_group_more == jcfg.region.r_time_group_more
        assert cfg.group_radius_more == jcfg.group_radius_more
        assert cfg.region.group_num_more == jcfg.region.group_num_more
        assert (cfg.model.ball_query_method, cfg.model.bn_momentum,
                cfg.model.bn_epsilon) == (jcfg.model.ball_query_method,
                                          jcfg.model.bn_momentum,
                                          jcfg.model.bn_epsilon)


@pytest.mark.parametrize("pkg,port", [
    ("regnet_for_3d_grasping_tpu.ops", pops),
    ("regnet_for_3d_grasping_tpu.geometry", pgeometry)])
def test_exports_match_the_jax_package(pkg, port):
    jpkg = importlib.import_module(pkg)
    jnames = {n for n in dir(jpkg) if not n.startswith("_")
              and callable(getattr(jpkg, n))
              and not isinstance(getattr(jpkg, n), type(importlib))}
    pnames = {n for n in dir(port) if not n.startswith("_")
              and callable(getattr(port, n))}
    assert jnames <= pnames, jnames - pnames
    if pkg.endswith(".ops"):
        assert set(port.__all__) == set(jpkg.__all__)
        assert callable(port.ball_query)        # the function's name
        assert port.ball_query.KERNEL_MIN_WORK == 1 << 25
