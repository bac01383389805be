"""The serving knobs of the PyTorch port against the JAX package, on the CPU:
the above-plane center prior (``region.center_min_z``), the bucket center
selection (``region.center_select = "bucket"``), the theta pose search
(``region.pose_search_k``, `models/regnet.pose_search_thetas`) and the
refinement guard (``region.refine_guard``, `funnel_guard_refine`).

Inputs are made with numpy from fixed seeds; the pose-search scenes are
those of ``tests/test_pose_search.py`` (a thin post on a table, the grasp
at its top).  Tolerances: center picks and chosen thetas exact, in f32 and
in bf16 proposals (both rounding places: the variants' thetas in the
proposals' dtype, the served theta rounded from f32).  The whole tiny model
with every knob on is held against JAX's, op by op, in
``tests/test_torch_port_model.py`` (`test_slice_with_every_knob_matches_jax`:
it shares that file's JAX model and its compiled ops).  In slab mode the
pose search's stride runs over the sorted cloud
(`test_slab_pose_search_sees_the_sorted_cloud`); the functions themselves
are held against JAX above on the cloud they are given.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.geometry.region import (
    select_score_centers as jselect)
from regnet_for_3d_grasping_tpu.models.regnet import (
    funnel_guard_refine as jguard, pose_search_thetas as jsearch)
from regnet_for_3d_grasping_tpu.utils.config import GripperConfig as JGrip

from regnet_for_3d_grasping_torch.config import (EvalConfig, GripperConfig,
                                                 tiny_config)
from regnet_for_3d_grasping_torch.eval.collision import view_check_funnel
from regnet_for_3d_grasping_torch.geometry.region import select_score_centers
from regnet_for_3d_grasping_torch.models import regnet

from test_torch_port_model import tiny_cloud

GRIP, JGRIP = GripperConfig(), JGrip()
BF = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The funnels run many small elementwise ops: 2 threads in each of the
    suite's parallel workers, as the evaluator's tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- center selection --------------------------------------------------------

def knob_cloud(seed, B=2, n=512):
    rng = np.random.RandomState(seed)
    pc = rng.rand(B, n, 6).astype(np.float32)
    pc[..., 2] = rng.uniform(0.6, 0.9, (B, n))
    return pc, rng


def score_cases():
    """(cloud, score, threshold, min_z): the three fallback cases of the
    above-plane prior, a row of each, and the prior off."""
    pc, rng = knob_cloud(0)
    above = pc[..., 2] > 0.75
    yield "positives above", pc, rng.rand(2, 512).astype(np.float32), 0.3, \
        0.75
    # no positive above the plane: any point above it
    yield "any point above", pc, np.where(above, 0.2, 0.9).astype(
        np.float32), 0.5, 0.75
    # no point above the plane: the positives as they were
    yield "unmasked positives", pc, (rng.rand(2, 512) > 0.5).astype(
        np.float32), 0.5, 2.0
    # one row of each kind, and a row without any positive
    score = np.stack([np.where(above[0], 0.2, 0.9),
                      np.zeros(512)]).astype(np.float32)
    yield "mixed rows", pc, score, 0.5, 0.75
    yield "prior off", pc, rng.rand(2, 512).astype(np.float32), 0.5, None


@pytest.mark.parametrize("method", ["fps", "bucket"])
@pytest.mark.parametrize("case", [c[0] for c in score_cases()])
def test_select_score_centers_matches_jax(case, method):
    _, pc, score, thre, min_z = next(c for c in score_cases()
                                     if c[0] == case)
    want_c, want_i = jselect(jnp.asarray(pc), jnp.asarray(score), 100, thre,
                             method=method, min_z=min_z)
    got_c, got_i = select_score_centers(t(pc), t(score), 100, thre,
                                        method=method, min_z=min_z)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_i.dtype == torch.int32
    if case in ("positives above", "any point above"):
        assert (got_c[..., 2] > 0.75).all()


# --- pose search and the refinement guard ------------------------------------

# the post's top and the grasp center's z: 0.90 as in
# tests/test_pose_search.py, and the nearest bf16 value below it for bf16
# proposals, so that rounding the center to bf16 moves nothing
TOP = {jnp.float32: 0.90, jnp.bfloat16: 0.8984375}


def post_scene(top=0.90):
    """A table plane and a thin post whose top is the grasp center
    (tests/test_pose_search.py): [1, 2400, 3]."""
    rng = np.random.RandomState(0)
    table = np.c_[rng.uniform(-0.3, 0.3, (2000, 2)), np.full(2000, 0.75)]
    post = np.c_[rng.uniform(-0.008, 0.008, (400, 2)),
                 rng.uniform(0.75, top, 400)]
    return np.concatenate([table, post]).astype(np.float32)[None]


def buried_scene():
    rng = np.random.RandomState(1)
    return (rng.uniform(-0.2, 0.2, (1, 3000, 3))
            + np.array([0, 0, 0.9])).astype(np.float32)


def grasp(theta, score=0.9, top=0.90):
    g = np.zeros(10, np.float32)
    g[:3] = [0.0, 0.0, top]
    g[3:6] = [0.0, 1.0, 0.0]
    g[6] = theta
    g[7] = score
    return g


def grasps(*rows):
    return np.stack(rows)[None]


def many_grasps(seed, n=48, top=0.90):
    """n grasps around the post top: jittered centers, random thetas."""
    rng = np.random.RandomState(seed)
    g = grasps(*[grasp(th, top=top)
                 for th in rng.uniform(-np.pi, np.pi, n)])
    g[..., :3] += rng.randn(1, n, 3) * 0.01
    return g


def as_dtype(a, dtype):
    """-> (JAX array, torch tensor) of `a` rounded to `dtype` alike."""
    j = jnp.asarray(a).astype(dtype)
    tt = t(np.asarray(j.astype(jnp.float32)))
    return j, (tt.to(BF) if dtype == jnp.bfloat16 else tt)


def funnel_survive(pts, g):
    return view_check_funnel(t(pts[0]), torch.as_tensor(g[0, :, :8]).float(),
                             0.75, GRIP.depth, GRIP, EvalConfig())["survive"]


DTYPES = pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                                 ids=["f32", "bf16"])


def search_both(pts, props, k=8, subsample=1, dtype=jnp.float32):
    jp, tp = as_dtype(props, dtype)
    want = jsearch(jnp.asarray(pts), jp, k, subsample, 0.75, JGRIP)
    got = regnet.pose_search_thetas(t(pts), tp, k, subsample, 0.75, GRIP)
    assert got.dtype == tp.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    return tp, got


@DTYPES
def test_pose_search_rescues_a_colliding_theta(dtype):
    """Only the exactly downward variant (3 pi / 2) survives here; in bf16
    the funnel sees it rounded (4.71875), which tilts the hand enough to
    fail, so bf16 keeps the prediction, as JAX's search does."""
    pts = post_scene(TOP[dtype])
    props, out = search_both(pts, grasps(grasp(0.0, top=TOP[dtype])),
                             dtype=dtype)
    assert not funnel_survive(pts, props)[0]
    assert funnel_survive(pts, out)[0] == (dtype == jnp.float32)
    assert torch.equal(out[..., :6], props[..., :6])
    assert torch.equal(out[..., 7:], props[..., 7:])


@DTYPES
def test_pose_search_keeps_a_surviving_prediction(dtype):
    props, out = search_both(post_scene(TOP[dtype]),
                             grasps(grasp(-np.pi / 2, top=TOP[dtype])),
                             dtype=dtype)
    assert torch.equal(out, props)


def test_pose_search_without_a_survivor_keeps_the_prediction():
    props, out = search_both(buried_scene(), grasps(grasp(0.3)))
    assert torch.equal(out[..., 6], props[..., 6])


@pytest.mark.parametrize("k,subsample,dtype", [
    (8, 1, jnp.float32), (5, 4, jnp.bfloat16)], ids=["f32", "bf16"])
def test_pose_search_many_proposals(k, subsample, dtype):
    """48 proposals around the post; ties on the circular grid go to the
    first variant, as JAX's argmax takes them."""
    props, out = search_both(post_scene(TOP[dtype]),
                             many_grasps(3, top=TOP[dtype]), k, subsample,
                             dtype)
    changed = (out[..., 6] != props[..., 6]).sum()
    assert 0 < changed < 48


def guard_both(pts, refined, s2, subsample=1, dtype=jnp.float32):
    jr, tr = as_dtype(refined, dtype)
    js, ts = as_dtype(s2, dtype)
    want = jguard(jnp.asarray(pts), jr, js, subsample, 0.75, JGRIP)
    got = regnet.funnel_guard_refine(t(pts), tr, ts, subsample, 0.75, GRIP)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    return tr, ts, got


@DTYPES
def test_guard_restores_a_broken_survivor(dtype):
    top = TOP[dtype]
    refined, s2, out = guard_both(
        post_scene(top), grasps(grasp(0.0, 0.7, top)),
        grasps(grasp(-np.pi / 2, top=top)), dtype=dtype)
    assert torch.equal(out[..., :7], s2[..., :7])
    assert torch.equal(out[..., 7:], refined[..., 7:])


def test_guard_keeps_a_surviving_refinement():
    refined, _, out = guard_both(post_scene(),
                                 grasps(grasp(-np.pi / 2, 0.7)),
                                 grasps(grasp(0.0)))
    assert torch.equal(out, refined)


def test_guard_without_a_survivor_keeps_the_refinement():
    refined, _, out = guard_both(buried_scene(), grasps(grasp(1.1, 0.7)),
                                 grasps(grasp(0.3)))
    assert torch.equal(out, refined)


@pytest.mark.parametrize("subsample,dtype", [
    (1, jnp.float32), (1, jnp.bfloat16), (3, jnp.float32)])
def test_guard_preserves_stage2_survivors(subsample, dtype):
    """At subsample 1 every stage-2 survivor survives at stage 3."""
    pts = post_scene(TOP[dtype])
    rng = np.random.RandomState(3)
    s2 = grasps(*[grasp(th, top=TOP[dtype])
                  for th in rng.uniform(-np.pi, np.pi, 16)])
    refined = s2.copy()
    refined[..., :3] += rng.randn(1, 16, 3) * 0.05
    refined[..., 6] += rng.randn(1, 16) * 1.5
    _, ts, out = guard_both(pts, refined, s2, subsample, dtype)
    s2_surv = funnel_survive(pts, ts.float().numpy())
    assert s2_surv.any()
    if subsample == 1:
        assert (funnel_survive(pts, out.float().numpy()) | ~s2_surv).all()


def test_knob_funnels_take_a_fresh_eval_config(monkeypatch):
    """As JAX (`models/regnet.py:106`, `:162`), the funnels ignore the
    pipeline's EvalConfig: a model whose `cfg.eval` would reject every
    grasp searches as the default does."""
    import dataclasses
    pts, props = post_scene(), grasps(grasp(0.0))
    seen = []
    funnel = view_check_funnel

    def spy(*a, **kw):
        seen.append(a[5])
        return funnel(*a, **kw)

    from regnet_for_3d_grasping_torch.eval import collision
    monkeypatch.setattr(collision, "view_check_funnel", spy)
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, num_points_threshold=10**9))
    regnet.pose_search_thetas(t(pts), t(props), 8, 1, 0.75, cfg.gripper)
    regnet.funnel_guard_refine(t(pts), t(props), t(props), 1, 0.75,
                               cfg.gripper)
    assert seen == [EvalConfig(), EvalConfig()]


# --- slab mode ---------------------------------------------------------------

def test_slab_pose_search_sees_the_sorted_cloud(monkeypatch):
    seen = {}
    search = regnet.pose_search_thetas

    def spy(points, *a):
        seen["points"] = points
        return search(points, *a)

    monkeypatch.setattr(regnet, "pose_search_thetas", spy)
    pc = t(tiny_cloud(B=1))
    model = regnet.REGNet(tiny_config(**{
        "region.slab_cell": 0.04, "region.pose_search_k": 4})).eval()
    with torch.no_grad():
        out = model(pc, generator=torch.Generator().manual_seed(2))
    sorted_xyz = pc[0, out.point_order[0].long(), :3]
    assert torch.equal(seen["points"][0], sorted_xyz)


# --- the infer CLI -----------------------------------------------------------

class _Captured(Exception):
    pass


@pytest.mark.parametrize("argv", [
    ["--center-select", "bucket", "--center-min-z", "0.75",
     "--pose-search", "8", "--refine-guard"],
    ["--fast", "--pose-search", "4"], []])
def test_infer_cli_knob_flags_reach_the_config_as_jax_sends_them(
        argv, monkeypatch):
    from regnet_for_3d_grasping_torch.cli import infer
    jinfer = importlib.import_module("regnet_for_3d_grasping_tpu.cli.infer")
    jmodels = importlib.import_module("regnet_for_3d_grasping_tpu.models")
    jcache = importlib.import_module("regnet_for_3d_grasping_tpu.utils.cache")
    seen = {}

    def spy(cfg, dtype=None):
        seen["cfg"] = cfg
        raise _Captured

    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(jmodels, "REGNet", spy)
    with pytest.raises(_Captured):
        jinfer.main(["--no-eval", *argv])
    cfg = infer.config_from_args(infer.build_parser().parse_args(argv))
    for field in ("center_select", "center_min_z", "pose_search_k",
                  "pose_search_subsample", "pose_search_table",
                  "refine_guard", "refine_guard_subsample"):
        assert (getattr(cfg.region, field)
                == getattr(seen["cfg"].region, field)), field


def test_infer_cli_serves_with_the_four_knobs(tmp_path):
    import pickle
    from regnet_for_3d_grasping_torch.cli import infer
    folder = tmp_path / "scene_data"
    folder.mkdir()
    pc = tiny_cloud(B=1, extent=0.12)[0]
    with open(folder / "0000.p", "wb") as f:
        pickle.dump({"view_cloud": pc[:, :3].astype(np.float64),
                     "view_cloud_color": pc[:, 3:]}, f)
    rec = infer.main(["--folder-name", str(folder), "--center-num", "8",
                      "--all-points-num", "512", "--device", "cpu",
                      "--no-eval", "--center-select", "bucket",
                      "--center-min-z", "0.78",
                      "--pose-search", "4", "--refine-guard"])[0]
    out = rec["out"]
    assert (out.centers[..., 2] > 0.78).all()
    assert torch.isfinite(out.final_grasps).all()
    # data-parallel serving is accepted since it is ported (its tests:
    # tests/test_torch_port_parallel.py)
    assert infer.build_parser().parse_args(["--dp"]).dp
