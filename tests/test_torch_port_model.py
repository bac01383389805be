"""Parity of the PyTorch port's model with the JAX package, on the CPU.

Weights go from the JAX variables to the port through
`regnet_for_3d_grasping_torch.weights`.  Float outputs agree within rtol
1e-4 and atol 1e-5 (the same f32 layers, with matrix products summed in
another order); every selection and mask is exact.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.models import REGNet as JREGNet
from regnet_for_3d_grasping_tpu.models import ScoreNet as JScoreNet
from regnet_for_3d_grasping_tpu.nn.layers import ConvBN as JConvBN
from regnet_for_3d_grasping_tpu.utils import checkpoint as jckpt
from regnet_for_3d_grasping_tpu.utils.config import tiny_config as jtiny

from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.config import infer_config, tiny_config
from regnet_for_3d_grasping_torch.geometry import region
from regnet_for_3d_grasping_torch.models.regnet import REGNet, build_regnet
from regnet_for_3d_grasping_torch.models.score_net import ScoreNet
from regnet_for_3d_grasping_torch.nn.layers import ConvBN
from regnet_for_3d_grasping_torch.ops import ball_query
from regnet_for_3d_grasping_torch.utils.export import extract_grasp_sets

WEIGHTS = "weights/r5_real_e100.npz"
TOL = dict(rtol=1e-4, atol=1e-5)

# the JAX ops package exports functions under these modules' names
jbq = importlib.import_module("regnet_for_3d_grasping_tpu.ops.ball_query")
jbq_pallas = importlib.import_module(
    "regnet_for_3d_grasping_tpu.ops.ball_query_pallas")
jcrop_pallas = importlib.import_module(
    "regnet_for_3d_grasping_tpu.ops.crop_pallas")
jregion = importlib.import_module("regnet_for_3d_grasping_tpu.geometry.region")
jregnet = importlib.import_module("regnet_for_3d_grasping_tpu.models.regnet")


def tiny_cloud(seed=0, B=2, extent=0.08):
    """xyz in a cube of `extent` meters (dense enough that gripper boxes
    hold points) above the table, random colors."""
    rng = np.random.RandomState(seed)
    N = jtiny().region.num_points
    xyz = rng.rand(B, N, 3).astype(np.float32) * extent
    xyz[..., 2] += 0.75
    return np.concatenate([xyz, rng.rand(B, N, 3).astype(np.float32)], -1)


def test_r5_weights_load_every_array():
    arrays, epoch = weights.read_npz(WEIGHTS)
    assert len(arrays) == 165 and epoch > 0
    model = build_regnet(infer_config(), WEIGHTS, device="cpu")
    sd = model.state_dict()
    assert len(sd) == 165
    k = "score_net.backbone.sa0.mlp.layer0.dense.weight"
    np.testing.assert_array_equal(
        sd[k].numpy(),
        arrays["params/score_net/backbone/sa0/mlp/layer0/dense/kernel"].T)
    np.testing.assert_array_equal(
        sd["grn_head.stem.bn.running_var"].numpy(),
        arrays["batch_stats/grn_head/stem/bn/var"])


def test_weights_fail_on_leftover_or_missing():
    arrays, _ = weights.read_npz(WEIGHTS)
    model = REGNet(infer_config())
    extra = dict(arrays)
    extra["params/grn_head/stem/extra/kernel"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError):
        weights.load_into(model, extra)
    short = dict(arrays)
    short.pop("batch_stats/refine_head/cls2/bn/var")
    with pytest.raises(KeyError):
        weights.load_into(model, short)


def test_real_convbn_matches_flax():
    """The trained grn_head/stem layer on random pooled features."""
    variables, _ = jckpt.load_weights_npz(WEIGHTS)
    params = {"params": variables["params"]["grn_head"]["stem"],
              "batch_stats": variables["batch_stats"]["grn_head"]["stem"]}
    x = np.random.RandomState(1).randn(3, 50, 256).astype(np.float32)
    ref = JConvBN(1024).apply(params, jnp.asarray(x))
    layer = ConvBN(256, 1024).eval()
    weights.load_into(layer, params)
    np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), **TOL)


def tiny_model_variables(pc, dtype=None):
    """JAX REGNet variables at tiny_config from model.init on `pc`, as
    numpy arrays, with the scores of the model at compute dtype `dtype`
    spread around score_thre."""
    variables = jax.jit(JREGNet(jtiny()).init)(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.asarray(pc))
    variables = jax.tree.map(np.array, variables)
    # fresh scores bunch just above score_thre = 0.5, where an f32
    # rounding difference would flip the FPS mask: spread them around it.
    # A positive score kernel over the (ReLU, positive) features keeps the
    # logit free of cancellation, so the spread does not amplify rounding.
    bb = variables["params"]["score_net"]["backbone"]
    bb["score_dense"]["kernel"] = np.abs(bb["score_dense"]["kernel"])
    _, s = jax.jit(JScoreNet(jtiny().model, dtype=dtype).apply)(
        {c: variables[c]["score_net"] for c in variables}, jnp.asarray(pc))
    logit = np.log(np.asarray(s) / (1.0 - np.asarray(s)))
    k = 16.0 / np.ptp(logit)
    bb["score_bn"]["scale"] *= k
    bb["score_bn"]["bias"] -= k * np.median(logit)
    return variables


@pytest.fixture(scope="module")
def tiny_variables():
    """JAX REGNet variables at tiny_config from model.init, on a dense
    tiny cloud, as numpy arrays."""
    pc = tiny_cloud()
    return pc, tiny_model_variables(pc)


def test_backbone_matches_flax_at_tiny_config(tiny_variables):
    pc, variables = tiny_variables
    sv = {c: variables[c]["score_net"] for c in variables}
    ref_feat, ref_score = JScoreNet(jtiny().model).apply(sv, jnp.asarray(pc))
    model = ScoreNet(tiny_config().model).eval()
    weights.load_into(model, sv)
    with torch.no_grad():
        feat, score = model(torch.from_numpy(pc))
    np.testing.assert_allclose(feat.numpy(), np.asarray(ref_feat), **TOL)
    np.testing.assert_allclose(score.numpy(), np.asarray(ref_score), **TOL)


@pytest.fixture(scope="module")
def slice_run(tiny_variables):
    return run_full_slice(*tiny_variables)


def run_full_slice(pc, variables, dtype=None, overrides=None):
    """The whole slice at tiny_config (compute dtype `dtype`, JAX's; the
    configuration `overrides` on both sides), the ball query and crop
    forced onto their kernel semantics on both sides (Pallas in interpret
    mode on the JAX side, thresholds at 0 on the port's), the JAX keys
    captured and handed to the port as seeds."""
    mp = pytest.MonkeyPatch()
    overrides = overrides or {}
    cfg = jtiny(**overrides)
    jmodel = JREGNet(cfg, dtype=dtype)

    seeds = {"group": [], "crop": []}
    n_chunks = region.group_seed_count(
        cfg.region.center_num, cfg.region.num_points, cfg.region.group_num)

    def group_spy(key, *a, **kw):
        def keep(kd):
            seeds["group"] = [int(x) for x in kd[:, -1]]
        jax.debug.callback(keep, jax.random.key_data(
            jax.random.split(key, n_chunks)))
        return jregion.group_regions(key, *a, **kw)

    def crop_spy(key, *a, **kw):
        jax.debug.callback(
            lambda kd: seeds["crop"].append([int(kd.reshape(-1)[-1])]),
            jax.random.key_data(key))
        return jregion.closing_region_crop_dense(key, *a, **kw)

    try:
        mp.setattr(jbq, "_use_pallas_bq", lambda *a: True)
        mp.setattr(jregion, "_use_pallas_crop", lambda *a: True)
        mp.setattr(jbq_pallas, "ball_query_pallas", functools.partial(
            jbq_pallas.ball_query_pallas, interpret=True))
        mp.setattr(jcrop_pallas, "closing_region_crop_pallas",
                   functools.partial(jcrop_pallas.closing_region_crop_pallas,
                                     interpret=True))
        mp.setattr(jregnet, "group_regions", group_spy)
        mp.setattr(jregnet, "closing_region_crop_dense", crop_spy)
        # eager, as the JAX package's own model tests run it: under jit,
        # XLA may fuse bpdist2's 3-wide product into FMAs, which moves
        # radius-boundary picks away from both eager JAX and PyTorch
        ref = jmodel.apply(variables, jnp.asarray(pc),
                           rngs={"sampling": jax.random.PRNGKey(3)})

        mp.setattr(ball_query, "KERNEL_MIN_WORK", 0)
        mp.setattr(region, "CROP_KERNEL_MIN_WORK", 0)
        model = REGNet(tiny_config(**overrides, **{
            "model.compute_dtype": jnp.dtype(dtype or jnp.float32).name}))
        weights.load_into(model, variables)
        model.eval()
        with torch.no_grad():
            out = model(torch.from_numpy(pc), group_seeds=seeds["group"],
                        crop_seeds=seeds["crop"])
    finally:
        mp.undo()
    return ref, out


def test_slice_scores_spread(slice_run):
    ref, _ = slice_run
    s = np.asarray(ref.score)
    assert np.abs(s - 0.5).min() > 1e-3
    assert 0.2 < (s > 0.5).mean() < 0.8


@pytest.mark.parametrize("field", ["center_index", "region_valid",
                                   "anchor_index", "crop_valid",
                                   "refine_accept"])
def test_slice_selections_exact(slice_run, field):
    ref, out = slice_run
    np.testing.assert_array_equal(getattr(out, field).numpy(),
                                  np.asarray(getattr(ref, field)))


@pytest.mark.parametrize("field", ["score", "cls_logits", "reg", "proposals",
                                   "refine_logits", "final_grasps"])
def test_slice_values_close(slice_run, field):
    ref, out = slice_run
    np.testing.assert_allclose(getattr(out, field).numpy(),
                               np.asarray(getattr(ref, field)), **TOL)


def test_slice_exercises_both_crop_outcomes(slice_run):
    _, out = slice_run
    assert out.crop_valid.any() and not out.crop_valid.all()
    assert out.region_valid.all()


def test_slice_grasp_sets(slice_run):
    from regnet_for_3d_grasping_tpu.utils.export import (
        extract_grasp_sets as jextract)
    ref, out = slice_run
    for g, r in zip(extract_grasp_sets(out), jextract(ref)):
        assert g.keys() == r.keys()
        for k in g:
            np.testing.assert_allclose(g[k], r[k], **TOL)


# the serving knobs all at once: bucket centers above a z prior, a pose
# search at stride 2 and the refinement guard (tests/test_torch_port_knobs.py
# holds each against JAX on its own)
KNOBS = {"region.center_select": "bucket", "region.center_min_z": 0.79,
         "region.pose_search_k": 4, "region.pose_search_subsample": 2,
         "region.refine_guard": True}


@pytest.fixture(scope="module")
def knob_slice_run(tiny_variables):
    return run_full_slice(*tiny_variables, overrides=KNOBS)


@pytest.mark.parametrize("field", ["center_index", "region_valid",
                                   "anchor_index", "crop_valid",
                                   "refine_accept", "score", "proposals",
                                   "final_grasps"])
def test_slice_with_every_knob_matches_jax(tiny_variables, knob_slice_run,
                                           field):
    """The whole slice with every serving knob on, against JAX's op by op:
    selections exact, floats within TOL; every center above the prior."""
    ref, out = knob_slice_run
    got, want = getattr(out, field).numpy(), np.asarray(getattr(ref, field))
    if got.dtype == np.float32:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)
    if field == "center_index":
        z = np.take_along_axis(tiny_variables[0][..., 2],
                               got.astype(np.int64), 1)
        assert (z > KNOBS["region.center_min_z"]).all()


def test_slice_groups_as_the_jax_package(tiny_variables):
    """The whole tiny slice at 2,048 centers (2 chunks of 1,024; 2,048 x 512
    points = 2^20, where a work threshold once sent grouping to K11)
    against JAX's REGNet with no dispatch patched: the groups index for
    index, and the selections and logits that follow them.  JAX's grouping
    runs compiled, as the package serves it (eagerly, `lax.map` folds the
    cloud's norms as a constant at another rounding); the crop takes its
    plain path on both sides, one seed per chunk of 512 proposals."""
    pc, variables = tiny_variables
    over = {"region.center_num": 2048}
    cfg = jtiny(**over)
    n_group = region.group_seed_count(2048, 512, cfg.region.group_num)
    n_crop = region.crop_seed_count(2048, 512, cfg.region.gripper_num)
    assert (n_group, n_crop) == (2, 4)
    seen = {"crop": []}

    def seeds_of(key, n):
        return [int(s) for s in np.asarray(jax.random.key_data(
            jax.random.split(key, n)))[:, -1]]

    def jgroup_spy(key, pc_, centers, K, radius, **kw):
        assert kw["sorted_cloud"] is None
        jax.debug.callback(
            lambda kd: seen.update(group=[int(x) for x in kd[:, -1]]),
            jax.random.key_data(jax.random.split(key, n_group)))
        out = jax.jit(lambda k, p, c: jregion.group_regions(
            k, p, c, K, radius, with_points=False))(key, pc_, centers)
        seen["jax_index"] = np.asarray(out.index)
        return out

    def jcrop_spy(key, *a, **kw):
        jax.debug.callback(
            lambda kd: seen["crop"].append([int(x) for x in kd[:, -1]]),
            jax.random.key_data(jax.random.split(key, n_crop)))
        return jregion.closing_region_crop_dense(key, *a, **kw)

    def group_spy(*a, **kw):
        out = region.group_regions(*a, **kw)
        seen["index"] = out.index.numpy()
        return out

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jregnet, "group_regions", jgroup_spy)
        mp.setattr(jregnet, "closing_region_crop_dense", jcrop_spy)
        ref = JREGNet(cfg).apply(variables, jnp.asarray(pc),
                                 rngs={"sampling": jax.random.PRNGKey(3)})
        from regnet_for_3d_grasping_torch.models import regnet as pregnet
        mp.setattr(pregnet, "group_regions", group_spy)
        model = REGNet(tiny_config(**over))
        weights.load_into(model, variables)
        model.eval()
        with torch.no_grad():
            out = model(torch.from_numpy(pc), group_seeds=seen["group"],
                        crop_seeds=seen["crop"])
    finally:
        mp.undo()
    np.testing.assert_array_equal(seen["index"], seen["jax_index"])
    for field in ("center_index", "region_valid", "anchor_index",
                  "crop_valid"):
        np.testing.assert_array_equal(getattr(out, field).numpy(),
                                      np.asarray(getattr(ref, field)))
    np.testing.assert_allclose(out.cls_logits.numpy(),
                               np.asarray(ref.cls_logits), **TOL)


def test_slice_knobs_change_the_thetas(knob_slice_run):
    """The search moved some thetas off the regression, so the comparison
    above held the knobs, not a pass-through."""
    from regnet_for_3d_grasping_torch.models.regnet import decode_proposals
    _, out = knob_slice_run
    reg_theta = decode_proposals(out.reg, out.anchor_index,
                                 out.centers[..., :3], 0.06)[..., 6]
    assert (out.proposals[..., 6] != reg_theta).any()


@pytest.mark.parametrize("override,item", [
    ({"region.center_select": "bucket"}, "A5"),
    ({"region.pose_search_k": 8}, "A5"),
    ({"region.refine_guard": True}, "A5"),
    ({"region.center_min_z": 0.75}, "A5"),
])
def test_unported_knobs_raise(override, item):
    """The serving knobs of queue A item `item` raised NotImplementedError
    until they were ported: each now builds, runs a forward and refuses
    nothing (`tests/test_torch_port_knobs.py` holds them against JAX);
    an unknown center selection raises."""
    model = REGNet(tiny_config(**override)).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(tiny_cloud(B=1)),
                    generator=torch.Generator().manual_seed(4))
    assert torch.isfinite(out.final_grasps).all(), item
    with pytest.raises(ValueError, match="center_select"):
        REGNet(tiny_config(**{**override, "region.center_select": "grid"}))


@pytest.mark.parametrize("override", [
    {"model.compute_dtype": "bfloat16"},
    {"region.slab_cell": 0.04, "model.compute_dtype": "bfloat16"},
])
def test_bf16_configurations_build_and_run(override):
    """The bf16 compute dtype, on the full scan and on the slab (these
    raised until it was ported): bf16 network outputs, f32 geometry and
    grasps, the parameters still f32."""
    model = REGNet(tiny_config(**override)).eval()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        out = model(torch.from_numpy(tiny_cloud(B=1)),
                    generator=torch.Generator().manual_seed(4))
    for field in ("cls_logits", "reg", "refine_logits", "refine_reg"):
        assert getattr(out, field).dtype == torch.bfloat16
    for field in ("score", "centers", "proposals", "final_grasps"):
        v = getattr(out, field)
        assert v.dtype == torch.float32 and torch.isfinite(v).all()


def test_infer_cli_writes_the_prediction_pickle(tmp_path):
    import pickle
    from regnet_for_3d_grasping_torch.cli import infer
    folder = tmp_path / "scene_data"
    folder.mkdir()
    pc = tiny_cloud(B=1)[0]
    with open(folder / "0000.p", "wb") as f:
        pickle.dump({"view_cloud": pc[:, :3].astype(np.float64),
                     "view_cloud_color": pc[:, 3:]}, f)
    args = ["--folder-name", str(folder), "--center-num", "8",
            "--all-points-num", "512", "--device", "cpu"]
    evaluated = infer.main(args)[0]["sets"]
    recs = infer.main(args + ["--no-eval"])
    assert len(recs) == 1
    with open(tmp_path / "scene_data_predict" / "0000.p", "rb") as f:
        pred = pickle.load(f)
    assert set(pred) == {"points", "colors", "scores", "grasp_stage2",
                         "grasp_stage3", "grasp_stage3_stage2",
                         "grasp_stage3_score"}
    assert pred["scores"].shape == (512, 1)
    assert pred["grasp_stage2"].shape[1] == 8
    # without --no-eval each set keeps the grasps that pass the view filter
    for k, raw in recs[0]["sets"].items():
        assert len(evaluated[k]) <= len(raw)
