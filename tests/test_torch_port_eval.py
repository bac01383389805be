"""The port's geometric evaluator (``regnet_for_3d_grasping_torch/eval/``),
its export helpers and the infer CLI's evaluation, against the JAX package
on the CPU.

Inputs come from the port's synthetic scene generator (a copy of the JAX
one) at 2,048 view points (8,192 scene points), with 512 grasps made with
numpy from the scene's labelled frames (jittered, so that some lie on a
region's edge) and from random poses near the view cloud; both packages get
the same arrays.

Tolerances:
- masks, counts and indices exact (the port writes each local coordinate
  as JAX's CPU dot rounds it, `eval/collision.py`);
- antipodal scores and score sums within 1e-5 relative (1e-7 absolute):
  the port sums a band's |n.y| in f64, JAX in f32;
- the 3x3 eigenvector within 1e-5 after aligning its sign: JAX takes the
  determinant by LU, the port by cofactors;
- normals: |cos| >= 1 - 1e-5 on at least 99.5 % of the 2,048 view points,
  and the same orientation wherever |n . (camera - p)| > 1e-4.  JAX sums
  the covariances in f32, where E[pp^T] - mu mu^T cancels three to four
  digits, the port in f64; on the 8,192-point scene clouds of these scenes
  JAX's own rounding leaves some tenths of a percent of the moment normals
  past 1e-5 (f32 sums in the port gave as many), so the test reads the
  view cloud.
"""

import pickle
from collections import namedtuple
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.eval import collision as jcol
from regnet_for_3d_grasping_tpu.eval import evaluator as jev
from regnet_for_3d_grasping_tpu.eval import normals as jnorm
from regnet_for_3d_grasping_tpu.eval import parallel_eval as jpar
from regnet_for_3d_grasping_tpu.eval import pointcloud_ops as jpco
from regnet_for_3d_grasping_tpu.utils import export as jexport
from regnet_for_3d_grasping_tpu.utils.config import (EvalConfig as JEval,
                                                     GripperConfig as JGrip)

from regnet_for_3d_grasping_torch.config import EvalConfig, GripperConfig
from regnet_for_3d_grasping_torch.data.synthetic import make_synthetic_scene
from regnet_for_3d_grasping_torch.eval import collision, evaluator, normals
from regnet_for_3d_grasping_torch.eval import parallel_eval, pointcloud_ops
from regnet_for_3d_grasping_torch.utils import export

GRIP, ECFG, JGRIP, JECFG = GripperConfig(), EvalConfig(), JGrip(), JEval()
TABLE, DEPTH = GRIP.table_height, GRIP.depth
CAM = np.array([0.8, 0.0, 1.7], np.float32)
WEIGHTS = (Path(__file__).resolve().parent.parent / "weights"
           / "r4_coherent_e100.npz")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port's evaluator runs many elementwise f64 ops on the CPU: with
    torch's pool at the machine's width in each of the suite's parallel
    workers they oversubscribe the cores, so this module runs on 2."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def scene_grasps(scene, rng, n):
    """n grasps [n, 8]: two of three from the scene's labelled frames, their
    centers moved up to 4 mm and theta up to 0.15; the rest random poses
    within 3 cm of a view point."""
    from regnet_for_3d_grasping_torch.geometry.codec import frames_to_grasps
    frames = t(np.asarray(scene["select_frame"], np.float32))
    labelled = frames_to_grasps(frames[:, :3, :3], frames[:, :3, 3],
                                torch.zeros(len(frames), 1)).numpy()
    view = scene["view_cloud"]
    g = np.zeros((n, 8), np.float32)
    for i in range(n):
        if i % 3 == 2 or len(labelled) == 0:
            g[i, :3] = view[rng.randint(len(view))] + rng.normal(0, 0.01, 3)
            v = rng.normal(size=3)
            g[i, 3:6] = v / np.linalg.norm(v)
            g[i, 6] = rng.uniform(-np.pi, np.pi)
        else:
            g[i, :7] = labelled[rng.randint(len(labelled)), :7]
            g[i, :3] += rng.uniform(-0.004, 0.004, 3)
            g[i, 6] += rng.uniform(-0.15, 0.15)
        g[i, 7] = rng.uniform(0, 1)
    return g


@pytest.fixture(scope="module")
def case():
    scene = make_synthetic_scene(3, num_view=2048)
    g = scene_grasps(scene, np.random.RandomState(0), 512)
    return scene, g


def f32(a):
    return np.asarray(a, np.float32)


# --- pointcloud_ops ----------------------------------------------------------

@pytest.mark.parametrize("nb,radius", [(16, 0.04), (5, 0.01)])
def test_radius_outlier_mask_exact(case, nb, radius):
    pts = f32(case[0]["view_cloud"])
    want = np.asarray(jpco.radius_outlier_mask(jnp.asarray(pts), nb, radius))
    got = pointcloud_ops.radius_outlier_mask(t(pts), nb, radius, chunk=300)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(want)


@pytest.mark.parametrize("voxel,table", [(0.005, 1 << 20), (0.02, 1 << 8)])
def test_voxel_downsample_mask_exact(case, voxel, table):
    """Also with a table of 256 slots, where voxels collide, and points far
    from the origin, where the int32 hash products wrap."""
    pts = f32(np.r_[case[0]["scene_cloud"], case[0]["scene_cloud"][:50] * 97])
    want = np.asarray(jpco.voxel_downsample_mask(jnp.asarray(pts), voxel,
                                                 table))
    got = pointcloud_ops.voxel_downsample_mask(t(pts), voxel, table)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(want)


# --- normals -----------------------------------------------------------------

def aligned(a, b):
    return b * np.where((a * b).sum(-1, keepdims=True) < 0, -1, 1)


def test_smallest_eigvec_3x3():
    """Random PSD matrices, rank-2 ones (a zero eigenvalue), small ones at
    a neighbourhood covariance's scale, zero and the identity (no unique
    eigenvector: (0, 0, 1)).  An eigenvector is fixed to f32's rounding
    times |A| over the gap between the two smallest eigenvalues: where that
    gap is under 5 % of the largest eigenvalue, both packages are held to
    the exact (f64) eigenvector instead, within 1 - |cos| <= 1e-6."""
    rng = np.random.RandomState(1)
    m = rng.normal(size=(200, 3, 3))
    psd = m @ np.swapaxes(m, -1, -2)
    flat = m.copy()
    flat[..., 2] = 0.0                   # rank 2: one zero eigenvalue
    plane = flat @ np.swapaxes(flat, -1, -2)
    scaled = np.diag([3e-5, 1e-5, 2e-6])[None] + 1e-7 * psd[:20]
    A = f32(np.concatenate([psd, plane, scaled]))
    want = np.asarray(jnorm.smallest_eigvec_3x3(jnp.asarray(A)))
    got = aligned(want, normals.smallest_eigvec_3x3(t(A)).numpy())
    lam, vec = np.linalg.eigh(A.astype(np.float64))
    gap = (lam[:, 1] - lam[:, 0]) / lam[:, 2]
    assert (gap >= 0.05).mean() > 0.7
    np.testing.assert_allclose(got[gap >= 0.05], want[gap >= 0.05],
                               atol=1e-5, rtol=0)
    for v in (got, want):
        assert (np.abs((v * vec[..., 0]).sum(-1)) >= 1 - 1e-6).all()
    none = f32(np.stack([np.zeros((3, 3)), np.eye(3)]))
    np.testing.assert_array_equal(normals.smallest_eigvec_3x3(t(none)),
                                  jnorm.smallest_eigvec_3x3(
                                      jnp.asarray(none)))


@pytest.mark.parametrize("method", ["moment", "knn"])
def test_estimate_normals(case, method):
    pts = f32(case[0]["view_cloud"])
    want = np.asarray(jnorm.estimate_normals(jnp.asarray(pts),
                                             jnp.asarray(CAM),
                                             method=method))
    got = normals.estimate_normals(t(pts), t(CAM), method=method).numpy()
    dot = (want * got).sum(-1)
    assert (np.abs(dot) >= 1 - 1e-5).mean() >= 0.995
    facing = np.abs((want * (CAM - pts)).sum(-1)) > 1e-4
    assert (dot[facing] > 0).all()
    # neither the chunk of queries nor a subset of them moves a normal by
    # more than the f64 sums' order (the product's blocking follows the
    # chunk's rows; it reaches only the tiny components of near-degenerate
    # covariances)
    again = normals.estimate_normals(t(pts), t(CAM), chunk=700,
                                     method=method).numpy()
    np.testing.assert_allclose(again, got, rtol=0, atol=1e-9)
    rows = torch.arange(3, len(pts), 7)
    some = normals.estimate_normals(t(pts), t(CAM), method=method, rows=rows)
    np.testing.assert_allclose(some.numpy(), got[rows.numpy()], rtol=0,
                               atol=1e-9)


# --- collision ---------------------------------------------------------------

@pytest.mark.parametrize("close_region,sign", [(True, -1.0), (False, 1.0)])
def test_check_grasps_view_exact(case, close_region, sign):
    scene, g = case
    vp = f32(scene["view_cloud"])
    want = np.asarray(jcol.check_grasps_view(
        jnp.asarray(vp), jnp.asarray(g), TABLE, DEPTH, JGRIP, JECFG,
        close_region, sign))
    got = collision.check_grasps_view(t(vp), t(g), TABLE, DEPTH, GRIP, ECFG,
                                      close_region, sign).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)
    again = collision.check_grasps_view(t(vp), t(g), TABLE, DEPTH, GRIP,
                                        ECFG, close_region, sign, chunk=37)
    np.testing.assert_array_equal(again.numpy(), got)


def test_view_check_funnel_exact(case):
    scene, g = case
    vp = f32(scene["view_cloud"])
    depth = np.random.RandomState(2).uniform(0.04, 0.07, len(g))
    want = jcol.view_check_funnel(jnp.asarray(vp), jnp.asarray(g), TABLE,
                                  jnp.asarray(f32(depth)), JGRIP, JECFG)
    got = collision.view_check_funnel(t(vp), t(g), TABLE, t(f32(depth)),
                                      GRIP, ECFG)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        assert 0 < np.asarray(want[k]).sum() < len(g) or k == "close_points"


def test_check_grasps_scene(case):
    scene, g = case
    sp, sn = f32(scene["scene_cloud"]), f32(scene["scene_normal"])
    ok, score = (np.asarray(a) for a in jcol.check_grasps_scene(
        jnp.asarray(sp), jnp.asarray(sn), jnp.asarray(g), DEPTH, JGRIP,
        JECFG))
    gok, gscore = collision.check_grasps_scene(t(sp), t(sn), t(g), DEPTH,
                                               GRIP, ECFG)
    np.testing.assert_array_equal(gok.numpy(), ok)
    assert 10 < ok.sum() < len(ok)
    np.testing.assert_allclose(gscore.numpy(), score, rtol=1e-5, atol=1e-7)
    again = collision.check_grasps_scene(t(sp), t(sn), t(g), DEPTH, GRIP,
                                         ECFG, chunk=29)
    assert torch.equal(again[0], gok) and torch.equal(again[1], gscore)


# --- the facade --------------------------------------------------------------

def close_records(got, want):
    assert got.vgr_count == want.vgr_count
    assert got.nocoll_view == want.nocoll_view
    assert got.formal == want.formal
    np.testing.assert_allclose(got.score_sum, want.score_sum, rtol=1e-5,
                               atol=1e-7)


def test_eval_test_and_validate(case):
    scene, g = case
    want = jev.eval_test(scene["view_cloud"], g, None, TABLE, DEPTH,
                         GRIP.width, JGRIP, JECFG)
    got = evaluator.eval_test(scene["view_cloud"], g, None, TABLE, DEPTH,
                              GRIP.width, GRIP, ECFG, device="cpu")
    np.testing.assert_array_equal(got, want)
    w = jev.eval_validate(scene, g, 1, TABLE, DEPTH, GRIP.width, JGRIP,
                          JECFG)
    r = evaluator.eval_validate(scene, g, 1, TABLE, DEPTH, GRIP.width, GRIP,
                                ECFG, device="cpu")
    assert r[0] == w[0] and r[2] == w[2] and w[0] > 10
    np.testing.assert_allclose(r[1], w[1], rtol=1e-5)
    for a, b in zip(r[3:5], w[3:5]):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(r[5], np.asarray(w[5]), rtol=1e-5, atol=1e-7)
    assert evaluator.eval_validate(scene, g[:0], 1, TABLE, DEPTH, GRIP.width,
                                   device="cpu")[2] == 0


def test_evaluate_scene_grasps_and_thresholds(case):
    """200 grasps padded to 256 with sentinels, with per-grasp depths; and
    the threshold sweep from one collision pass."""
    scene, g = case
    g = g[:200]
    depth = f32(np.random.RandomState(4).uniform(0.05, 0.06, len(g)))
    want = jev.evaluate_scene_grasps(scene, g, 2, TABLE, depth, GRIP.width,
                                     JGRIP, JECFG)
    got = evaluator.evaluate_scene_grasps(scene, g, 2, TABLE, depth,
                                          GRIP.width, GRIP, ECFG,
                                          device="cpu")
    close_records(got, want)
    assert got.formal == 200 and got.vgr == got.vgr_count / got.nocoll_view
    ths = [0.0, 0.3, 0.7]
    want = jev.evaluate_at_thresholds(scene, g, ths, 2, TABLE, DEPTH,
                                      GRIP.width, JGRIP, JECFG)
    got = evaluator.evaluate_at_thresholds(scene, g, ths, 2, TABLE, DEPTH,
                                           GRIP.width, GRIP, ECFG,
                                           device="cpu")
    for th in ths:
        close_records(got[th], want[th])


def test_records_and_view_numbers():
    r = evaluator.EvalRecord(5, 2.5, 10, 20).add(evaluator.EvalRecord(1, 0.5,
                                                                      2, 4))
    assert r == (6, 3.0, 12, 24)
    assert (r.vgr, r.vgr_before, r.score) == (0.5, 0.25, 0.25)
    assert evaluator.EvalRecord().vgr == 0.0
    for p in ("a/b/0001_view_2.p", "0003_view_1_noise.p"):
        assert evaluator.view_num_from_path(p) == jev.view_num_from_path(p)
    np.testing.assert_array_equal(evaluator.CAMERA_POSE, jev.CAMERA_POSE)
    np.testing.assert_array_equal(evaluator.DEFAULT_CAMERA,
                                  jev.DEFAULT_CAMERA)


@pytest.mark.parametrize("with_normals", [True, False])
def test_evaluate_scenes_sharded_one_device(with_normals):
    """Three scenes of ragged grasp counts and clouds, table heights per
    scene; without `scene_normal` each padded scene cloud's moment normals
    (the sentinel points move the centroid in both packages)."""
    rng = np.random.RandomState(5)
    scenes, grasps, depths, views = [], [], [], []
    for i, (n, nv) in enumerate([(40, 2048), (200, 1536), (7, 1800)]):
        s = make_synthetic_scene(30 + i, num_view=nv)
        if not with_normals:
            s.pop("scene_normal")
        scenes.append(s)
        grasps.append(scene_grasps(s, rng, n))
        depths.append(np.full(n, DEPTH, np.float32))
        views.append(i % 4)
    heights = [TABLE, TABLE, TABLE + 0.01]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    want = jpar.evaluate_scenes_sharded(mesh, scenes, grasps, views, heights,
                                        depths, GRIP.width, JGRIP, JECFG)
    got = parallel_eval.evaluate_scenes_sharded(
        ["cpu"], scenes, grasps, views, heights, depths, GRIP.width, GRIP,
        ECFG)
    assert sum(w.vgr_count for w in want) > 5
    for a, b in zip(got, want):
        assert a.vgr_count == b.vgr_count and a.nocoll_view == b.nocoll_view
        assert a.formal == b.formal
        # moment normals carry JAX's f32 rounding (module docstring), which
        # moves a score sum by about 1e-4 of itself here: 1e-3 there
        np.testing.assert_allclose(a.score_sum, b.score_sum,
                                   rtol=1e-5 if with_normals else 1e-3,
                                   atol=1e-6)


# --- export ------------------------------------------------------------------

Out = namedtuple("Out", "proposals final_grasps region_valid refine_accept "
                        "score_accept")


def test_extract_grasp_sets_and_diverse_selection():
    rng = np.random.RandomState(6)
    B, NC = 2, 64
    arrays = Out(f32(rng.normal(size=(B, NC, 10))),
                 f32(rng.normal(size=(B, NC, 10))), rng.rand(B, NC) < 0.8,
                 rng.rand(B, NC) < 0.5, rng.rand(B, NC) < 0.3)
    mask = rng.rand(B, NC) < 0.6
    for m in (None, mask, torch.from_numpy(mask)):
        want = jexport.extract_grasp_sets(
            arrays, None if m is None else np.asarray(m))
        got = export.extract_grasp_sets(
            Out(*(torch.from_numpy(a) for a in arrays)), m)
        for w, g in zip(want, got):
            assert set(w) == set(g)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    g = f32(np.c_[rng.uniform(0, 0.1, (200, 3)), rng.normal(size=(200, 5))])
    for k, d in ((10, 0.03), (500, 0.01), (0, 0.03)):
        np.testing.assert_array_equal(export.select_diverse_grasps(g, k, d),
                                      jexport.select_diverse_grasps(g, k, d))


# --- the infer CLI -----------------------------------------------------------

def write_clouds(folder, n):
    folder.mkdir()
    for i in range(n):
        s = make_synthetic_scene(40 + i, num_view=2048)
        with open(folder / f"{i:04d}_view_{i}.p", "wb") as f:
            pickle.dump({"view_cloud": s["view_cloud"].astype(np.float64),
                         "view_cloud_color": s["view_cloud_color"]}, f)


def test_infer_cli_evaluates_and_reseeds_every_cloud(tmp_path, monkeypatch):
    """Two clouds through the CLI with evaluation: every set in the pickle
    is what JAX's `eval_test` keeps of the raw set on the cloud as loaded,
    and both forwards drew the same seeds from ``--seed`` (the JAX CLI
    hands PRNGKey(seed) to every cloud)."""
    from regnet_for_3d_grasping_torch.cli import infer
    from regnet_for_3d_grasping_torch.models import regnet
    folder = tmp_path / "scene_data"
    write_clouds(folder, 2)
    draws = []
    draw = regnet._draw

    def spy(generator, n):
        draws.append(draw(generator, n))
        return draws[-1]

    monkeypatch.setattr(regnet, "_draw", spy)
    args = ["--folder-name", str(folder), "--center-num", "64",
            "--all-points-num", "2048", "--device", "cpu", "--seed", "3",
            "--checkpoint", str(WEIGHTS)]
    recs = infer.main(args)
    per = len(draws) // 2                # the draws of one forward
    assert per and draws[:per] == draws[per:]
    pred_dir = tmp_path / "scene_data_predict"
    kept = 0
    for r in recs:
        with open(pred_dir / r["path"].split("/")[-1], "rb") as f:
            pred = pickle.load(f)
        for k, v in export.extract_grasp_sets(r["out"])[0].items():
            want = jev.eval_test(pred["points"], v, None, TABLE, DEPTH,
                                 GRIP.width, JGRIP, JECFG)
            np.testing.assert_array_equal(pred[k], want, err_msg=k)
            kept += len(want)
        assert pred["grasp_stage2"].shape[1] == 8
    assert kept > 0
