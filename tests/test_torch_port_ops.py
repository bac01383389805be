"""Parity of the PyTorch port's point ops with the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages.  The
five CUDA kernels' plain PyTorch versions are held against the JAX Pallas
kernels run in interpret mode (the shapes of tests/test_pallas_interpret.py:
B=2, N=1100, M=130, unaligned on purpose), and the plain paths against the
JAX functions as they run on the CPU.

Tolerances: indices, counts and masks exact; the hash bit-exact; 3-NN
distances rtol 1e-6 (same f32 arithmetic, summation order may differ);
frames atol 1e-6.
"""

import functools
import importlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.geometry import codec as jcodec
from regnet_for_3d_grasping_tpu.geometry import region as jregion
from regnet_for_3d_grasping_tpu.ops import fps as jfps
from regnet_for_3d_grasping_tpu.ops import knn as jknn
from regnet_for_3d_grasping_tpu.ops import pooling as jpool
from regnet_for_3d_grasping_tpu.ops import sampling as jsamp
from regnet_for_3d_grasping_tpu.ops.ball_query_pallas import (
    ball_query_pallas)
from regnet_for_3d_grasping_tpu.ops.crop_pallas import (
    closing_region_crop_pallas)
from regnet_for_3d_grasping_tpu.ops.fps_pallas import fps_pallas
from regnet_for_3d_grasping_tpu.ops.knn_pallas import three_nn_pallas
from regnet_for_3d_grasping_tpu.utils.config import infer_config

from regnet_for_3d_grasping_torch import runtime
from regnet_for_3d_grasping_torch.geometry import codec, region
from regnet_for_3d_grasping_torch.ops import (_cuda, ball_query, crop, fps,
                                              knn, pooling, sampling)

# the JAX ops package exports a function under this module's name
jbq = importlib.import_module("regnet_for_3d_grasping_tpu.ops.ball_query")

B, N, M = 2, 1100, 130


def t(a):
    return torch.from_numpy(np.array(a))


def seed_of(key) -> int:
    return int(np.asarray(jax.random.key_data(key)).reshape(-1)[-1])


def chunk_seeds(key, n_chunks) -> list:
    keys = jax.random.split(key, n_chunks)
    return [int(s) for s in np.asarray(jax.random.key_data(keys))[:, -1]]


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.RandomState(3)
    return (rng.rand(B, N, 3).astype(np.float32),
            rng.rand(B, M, 3).astype(np.float32))


@pytest.fixture(scope="module")
def dense_cloud():
    """A 10 cm cube, so gripper boxes and 2 cm balls hold points."""
    rng = np.random.RandomState(5)
    xyz = (rng.rand(B, N, 3) * 0.1).astype(np.float32)
    centers = (rng.rand(B, M, 3) * 0.1).astype(np.float32)
    axis = rng.randn(B, M, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    theta = rng.uniform(-np.pi, np.pi, (B, M, 1))
    grasp = np.concatenate([centers, axis, theta], -1).astype(np.float32)
    return xyz, grasp


# --- K1 FPS ----------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_k1_fps_plain_matches_pallas(cloud, masked):
    xyz, _ = cloud
    mask = None
    if masked:
        mask = np.random.RandomState(4).rand(B, N) < 0.4
        mask[1] = False            # an all-masked row falls back to all
    S = 96
    dist = jfps._dist_init(jnp.asarray(xyz),
                           None if mask is None else jnp.asarray(mask))
    ref = np.asarray(fps_pallas(jnp.asarray(xyz), dist, S, version=2,
                                interpret=True))
    d = fps.dist_init(t(xyz), None if mask is None else t(mask))
    np.testing.assert_array_equal(d.numpy(), np.asarray(dist))
    np.testing.assert_array_equal(fps.fps_plain(t(xyz), d, S).numpy(), ref)
    got = fps.farthest_point_sample(
        t(xyz), S, None if mask is None else t(mask))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_k1_fps_masked_past_exhaustion(cloud):
    """More samples than valid points: masked points follow, as in JAX."""
    xyz, _ = cloud
    mask = np.zeros((B, N), bool)
    mask[:, 7:30] = True
    ref = np.asarray(jfps.farthest_point_sample(
        jnp.asarray(xyz), 40, jnp.asarray(mask)))
    got = fps.farthest_point_sample(t(xyz), 40, t(mask))
    np.testing.assert_array_equal(got.numpy(), ref)


# --- K2 ball query --------------------------------------------------------

@pytest.mark.parametrize("radius,K", [(0.25, 16), (0.08, 8)])
def test_k2_ball_query_plain_matches_pallas(cloud, radius, K):
    xyz, centers = cloud
    ri, rc = ball_query_pallas(jnp.asarray(xyz), jnp.asarray(centers),
                               radius, K, interpret=True)
    L = sampling.pallas_bucket_stride(N, K)
    r2 = float(np.float32(radius * radius))
    gi, gc = ball_query.ball_query_bucketed(t(xyz), t(centers), r2, K, L)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))


def test_ball_query_dispatch(cloud, monkeypatch):
    """Below the JAX threshold the plain bucket path (buckets ceil(N/K))
    runs and matches JAX on the CPU; with the threshold at 0 the kernel
    semantics (buckets of 128-multiples) run."""
    xyz, centers = cloud
    assert ball_query.KERNEL_MIN_WORK == jbq._PALLAS_BQ_THRESHOLD
    ri, rc = jbq.ball_query(jnp.asarray(xyz), jnp.asarray(centers), 0.2, 16)
    gi, gc = ball_query.ball_query(t(xyz), t(centers), 0.2, 16)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    monkeypatch.setattr(ball_query, "KERNEL_MIN_WORK", 0)
    pi, pc = ball_query_pallas(jnp.asarray(xyz), jnp.asarray(centers), 0.2,
                               16, interpret=True)
    gi, gc = ball_query.ball_query(t(xyz), t(centers), 0.2, 16)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(pc))


# --- K3 3-NN ----------------------------------------------------------------

@pytest.mark.parametrize("dense_query", [True, False])
def test_k3_three_nn_plain_matches_pallas(cloud, dense_query):
    xyz, centers = cloud
    q, k = (xyz, centers) if dense_query else (centers, xyz)
    ri, rd = three_nn_pallas(jnp.asarray(q), jnp.asarray(k), interpret=True)
    gi, gd = knn.three_nn_kernel(t(q), t(k))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-6)


def test_k3_ties_go_to_the_smaller_index():
    key = np.zeros((1, 8, 3), np.float32)
    key[0, :, 0] = [5, 1, 1, 3, 1, 2, 9, 1]
    q = np.zeros((1, 1, 3), np.float32)
    ri, _ = three_nn_pallas(jnp.asarray(q), jnp.asarray(key), interpret=True)
    gi, gd = knn.three_nn_plain(t(q), t(key))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gi.numpy()[0, 0], [1, 2, 4])


def test_three_nn_plain_path_matches_jax(cloud):
    xyz, centers = cloud
    ri, rd = jknn.three_nn(jnp.asarray(xyz), jnp.asarray(centers))
    gi, gd = knn.three_nn(t(xyz), t(centers))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-6)
    w = knn.interpolation_weights(gd)
    feat = np.random.RandomState(6).randn(B, M, 5).astype(np.float32)
    ref = jknn.three_interpolate(jnp.asarray(feat), ri,
                                 jknn.interpolation_weights(rd))
    got = knn.three_interpolate(t(feat), gi, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


# --- K4 gather-max ------------------------------------------------------

@pytest.mark.parametrize("n,c,s,k", [(1600, 128, 96, 16), (800, 128, 72, 8)])
def test_k4_gather_max_plain_matches_pallas(n, c, s, k):
    rng = np.random.RandomState(11)
    feat = rng.randn(B, n, c).astype(np.float32)
    mask = rng.rand(B, s, n) < 0.008
    mask[0, 0] = False            # an all-empty row: all-zero indices
    noise = jsamp.hash_uniform(jax.random.PRNGKey(7), mask.shape)
    idx, any_valid, _ = jsamp.bucket_choice(jnp.asarray(mask), k,
                                            score=noise)
    idx = np.asarray(jnp.where(any_valid[..., None], idx, 0))
    ref = jpool.gather_max_pallas(jnp.asarray(feat), jnp.asarray(idx),
                                  jsamp.bucket_stride(n, k), interpret=True)
    got = pooling.gather_max(t(feat), t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --- K5 crop ----------------------------------------------------------------

def test_k5_crop_plain_matches_pallas(dense_cloud):
    xyz, grasp = dense_cloud
    g = infer_config().gripper
    box = (0.0, g.depth / 2, g.width / 2, g.height / 2)
    frames, bases = jcodec.grasps_to_frames(jnp.asarray(grasp))
    K = 16
    ri, rc = closing_region_crop_pallas(jnp.asarray(xyz), frames, bases,
                                        jnp.uint32(9), box, K,
                                        interpret=True)
    rc = np.asarray(rc)
    assert (rc > 5).any() and (rc == 0).any()
    L = sampling.pallas_bucket_stride(N, K)
    gi, gc = crop.crop_plain(t(xyz), t(frames), t(bases), 9, box, K, L)
    np.testing.assert_array_equal(gc.numpy(), rc)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("kernel", [False, True])
def test_crop_dense_matches_jax(dense_cloud, kernel, monkeypatch):
    """Both dispatch paths of closing_region_crop_dense, with the seeds
    the JAX package derives from its key."""
    xyz, grasp = dense_cloud
    g = infer_config().gripper
    key = jax.random.PRNGKey(4)
    if kernel:
        monkeypatch.setattr(jregion, "_use_pallas_crop", lambda *a: True)
        monkeypatch.setattr(
            sys.modules["regnet_for_3d_grasping_tpu.ops.crop_pallas"],
            "closing_region_crop_pallas",
            functools.partial(closing_region_crop_pallas, interpret=True))
        monkeypatch.setattr(region, "CROP_KERNEL_MIN_WORK", 0)
        seeds = [seed_of(key)]
    else:
        seeds = chunk_seeds(key, 1)
    ref = jregion.closing_region_crop_dense(key, jnp.asarray(xyz),
                                            jnp.asarray(grasp), g, 16)
    got = region.closing_region_crop_dense(seeds, t(xyz), t(grasp), g, 16)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.index_in_all.numpy(),
                                  np.asarray(ref.index_in_all))
    assert got.valid.any() and not got.valid.all()


# --- sampling, grouping, codec ----------------------------------------------

@pytest.mark.parametrize("seed,shape", [(0, (7,)), (123456789, (3, 41)),
                                        (0xFFFFFFFF, (2, 5, 333))])
def test_hash_uniform_bit_exact(seed, shape):
    key = jnp.asarray([0, seed], jnp.uint32)
    ref = np.asarray(jsamp.hash_uniform(key, shape))
    got = sampling.hash_uniform(seed, shape).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("with_score", [False, True])
def test_bucket_choice_matches_jax(with_score):
    rng = np.random.RandomState(8)
    mask = rng.rand(3, 9, 250) < 0.05
    mask[0, 0] = False
    score = rng.rand(3, 9, 250).astype(np.float32) if with_score else None
    ri, rv, rc = jsamp.bucket_choice(
        jnp.asarray(mask), 16, None if score is None else jnp.asarray(score))
    gi, gv, gc = sampling.bucket_choice(
        t(mask), 16, None if score is None else t(score))
    for g, r in ((gi, ri), (gv, rv), (gc, rc)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_strides_match_jax():
    # grouping takes the chunked path at every full-scan shape, as the JAX
    # package does (its Pallas grouping is off): the rule as it runs
    for n, k in ((25600, 64), (25600, 256), (1100, 16), (512, 16)):
        assert sampling.bucket_stride(n, k) == jsamp.bucket_stride(n, k)
        assert (sampling.pallas_bucket_stride(n, k)
                == jsamp.pallas_bucket_stride(n, k))
        for nc in (4000, 64, 8):
            assert region.group_stride(nc, n, k) == jregion.group_stride(
                nc, n, k)
    assert region.group_stride(4000, 25600, 256) == 100
    assert region.group_stride(8, 512, 16) == 32
    assert region.CROP_KERNEL_MIN_WORK == jregion._PALLAS_CROP_THRESHOLD
    assert region.dense_crop_stride(4000, 25600, 64) == 512
    assert region.dense_crop_stride(8, 512, 16) == 32


def test_group_regions_matches_jax(dense_cloud):
    xyz, grasp = dense_cloud
    centers = grasp[..., :3]
    key = jax.random.PRNGKey(2)
    ref = jregion.group_regions(key, jnp.asarray(xyz), jnp.asarray(centers),
                                16, 0.02, with_points=False)
    got = region.group_regions(chunk_seeds(key, 1), t(xyz), t(centers), 16,
                               0.02)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))


def test_group_regions_chunks(dense_cloud):
    """Several 1024-center chunks, one seed each, the tail padded (2,100 x
    1,100 points, past the fused kernel's former threshold)."""
    xyz, _ = dense_cloud
    centers = (np.random.RandomState(9).rand(B, 2100, 3) * 0.1).astype(
        np.float32)
    key = jax.random.PRNGKey(6)
    ref = jregion.group_regions(key, jnp.asarray(xyz), jnp.asarray(centers),
                                8, 0.02, with_points=False)
    got = region.group_regions(chunk_seeds(key, 3), t(xyz), t(centers), 8,
                               0.02)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))


def test_group_regions_keeps_points_on_the_radius():
    """A point at exactly d2 == r2 is in the group (`d2 <= r2`)."""
    xyz = np.full((1, 300, 3), 10.0, np.float32)
    xyz[0, 17] = [0.5, 0.0, 0.0]
    center = np.zeros((1, 1, 3), np.float32)
    ref = jregion.group_regions(jax.random.PRNGKey(0), jnp.asarray(xyz),
                                jnp.asarray(center), 8, 0.5,
                                with_points=False)
    got = region.group_regions([5], t(xyz), t(center), 8, 0.5)
    assert got.valid.item() and bool(ref.valid[0, 0])
    assert (got.index.numpy() == 17).all()
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref.index))


def test_select_score_centers_matches_jax(cloud):
    xyz, _ = cloud
    rng = np.random.RandomState(10)
    pc = np.concatenate([xyz, rng.rand(B, N, 3).astype(np.float32)], -1)
    score = rng.rand(B, N).astype(np.float32)
    rc, ri = jregion.select_score_centers(jnp.asarray(pc),
                                          jnp.asarray(score), 64, 0.5)
    gc, gi = region.select_score_centers(t(pc), t(score), 64, 0.5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))


def test_grasps_to_frames_matches_jax(dense_cloud):
    _, grasp = dense_cloud
    grasp = grasp.copy()
    grasp[0, 0, 3:6] = 0.0          # degenerate axis: the fallback branch
    rf, rcen = jcodec.grasps_to_frames(jnp.asarray(grasp))
    gf, gcen = codec.grasps_to_frames(t(grasp))
    np.testing.assert_allclose(gf.numpy(), np.asarray(rf), atol=1e-6)
    np.testing.assert_array_equal(gcen.numpy(), np.asarray(rcen))
    np.testing.assert_array_equal(codec.anchor_templates().numpy(),
                                  np.asarray(jcodec.anchor_templates()))


# --- wrappers and package boundaries ----------------------------------------

def test_cpu_wrappers_launch_no_kernel(cloud):
    xyz, centers = cloud
    _cuda.reset_launches()
    fps.farthest_point_sample(t(xyz), 8)
    pooling.gather_max(t(xyz), torch.zeros(B, 4, 2, dtype=torch.int32))
    assert sum(_cuda.launches.values()) == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.check(t(xyz), "xyz", torch.float32, (B, N, 3))


def test_entry_points_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        runtime.resolve_device()
    assert runtime.resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_port_imports_nothing_of_jax():
    code = ("import sys, pkgutil, importlib, regnet_for_3d_grasping_torch "
            "as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'regnet_for_3d_grasping_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
