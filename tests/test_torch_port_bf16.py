"""Parity of the port's bf16 compute dtype (``model.compute_dtype =
"bfloat16"``) with the JAX package's ``dtype=jnp.bfloat16``, on the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages; the
JAX side runs op by op, its Pallas kernels in interpret mode, as the other
port tests run it.  The port's CPU path rounds a bf16 product as XLA's CPU
dot does (`nn/layers.bf16_matmul`) and writes the bf16 sigmoid out as XLA
expands it, so the two agree closely.

Tolerances:
- each layer (ConvBN, SharedMLP, BatchNorm, an SA layer on the full scan
  and on the slab, an FP layer on the full scan and on the slab with K8
  interpreted, the score head, both heads, `decode_proposals`): equal on
  at least 99.9 % of entries and within one bf16 ulp on as many; where a
  stack of layers carries a one-ulp difference (XLA's dot sums some rows
  in another order than the f32 product of the rounded operands) to a
  value near 0, within 2^-8 of the largest entry (`assert_bf16_close`,
  with what was measured); the four-layer heads at least 99.5 % equal
  and within 2^-7 of the largest entry (measured 99.78 %, 3.9e-3);
- K4's and K9's plain versions on bf16 rows: bit-equal to the interpreted
  Pallas kernels, rows with no covered slot included;
- the whole model at the tiny configuration, full scan and slab: center
  indices equal, scores within 4e-3 (measured 1.2e-7 full scan, 2.6e-3
  slab: a logit one ulp apart near 1 moves its sigmoid by about 2e-3),
  stage-2 and final grasps within 2e-2 of the largest entry (measured 3e-5),
  acceptance masks at least 99 % equal (measured 100 %).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from regnet_for_3d_grasping_tpu.models.backbone import (
    FeaturePropagation as JFeaturePropagation)
from regnet_for_3d_grasping_tpu.models.backbone import (
    SetAbstraction as JSetAbstraction)
from regnet_for_3d_grasping_tpu.models.heads import (
    RefineHead as JRefineHead)
from regnet_for_3d_grasping_tpu.models.heads import (
    TwoStageHead as JTwoStageHead)
from regnet_for_3d_grasping_tpu.models.regnet import (
    decode_proposals as jdecode)
from regnet_for_3d_grasping_tpu.nn.layers import ConvBN as JConvBN
from regnet_for_3d_grasping_tpu.nn.layers import SharedMLP as JSharedMLP
from regnet_for_3d_grasping_tpu.ops import pooling as jpool
from regnet_for_3d_grasping_tpu.ops import sampling as jsamp
from regnet_for_3d_grasping_tpu.ops import slab as jslab
from regnet_for_3d_grasping_tpu.utils.config import tiny_config as jtiny

from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.config import tiny_config
from regnet_for_3d_grasping_torch.models.backbone import (
    FeaturePropagation, SetAbstraction)
from regnet_for_3d_grasping_torch.models.heads import RefineHead, TwoStageHead
from regnet_for_3d_grasping_torch.models.regnet import (REGNet,
                                                        decode_proposals)
from regnet_for_3d_grasping_torch.models.score_net import ScoreNet
from regnet_for_3d_grasping_torch.nn.layers import (BatchNorm, ConvBN,
                                                    SharedMLP)
from regnet_for_3d_grasping_torch.ops import _cuda, pooling, slab

from test_torch_port_model import (run_full_slice, tiny_cloud,
                                   tiny_model_variables)
from test_torch_port_slab import (CELL, PLACEMENTS, flat_cloud, jsort,
                                  run_slice)

BF = torch.bfloat16
JBF = jnp.bfloat16


def t(a):
    return torch.from_numpy(np.array(a))


def f32(a) -> np.ndarray:
    """A torch or JAX array as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_bf16_close(got, ref, share=0.999, top=2.0 ** -8):
    """Equal on `share` of the entries and within one bf16 ulp of the
    larger magnitude on `share` of them; the rest within `top` times the
    largest magnitude (2^-8: one ulp at the top of its binade).  A layer
    stack carries an earlier layer's one-ulp difference to a later value
    near 0, many of its own ulps (measured: 1 of 92,160 SharedMLP entries
    by 2 ulps)."""
    g, r = f32(got), f32(ref)
    assert g.shape == r.shape
    big = np.maximum(np.abs(g), np.abs(r))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 2.0 ** -126))) - 7)
    diff = np.abs(g - r)
    assert (g == r).mean() >= share, (g == r).mean()
    assert (diff <= ulp).mean() >= share, (diff <= ulp).mean()
    assert diff.max() <= top * np.abs(r).max(), diff.max()


def with_stats(variables, seed):
    """Flax variables with non-trivial BatchNorm running statistics."""
    rng = np.random.RandomState(seed)
    variables = jax.tree.map(np.array, variables)

    def fill(tree):
        for k, v in tree.items():
            if k in ("mean", "var") and isinstance(v, np.ndarray):
                tree[k] = (rng.rand(*v.shape) + 0.5 if k == "var"
                           else rng.randn(*v.shape) * 0.3).astype(np.float32)
            elif isinstance(v, dict):
                fill(v)
    fill(variables.get("batch_stats", {}))
    return variables


# --- layers ------------------------------------------------------------------

@pytest.mark.parametrize("layer", ["convbn", "convbn_linear", "shared_mlp",
                                   "batchnorm", "batchnorm_train"])
def test_layers_match_flax_bf16(layer):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 40, 16, 35).astype(np.float32)
    train = layer == "batchnorm_train"
    if layer.startswith("batchnorm"):
        x = np.asarray(jnp.asarray(x).astype(JBF).astype(jnp.float32))
        jm = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                           epsilon=1e-5, dtype=JBF)
        m = BatchNorm(35)
    elif layer == "shared_mlp":
        jm, m = JSharedMLP((64, 48), dtype=JBF), SharedMLP(35, (64, 48),
                                                           dtype=BF)
    else:
        relu = layer == "convbn"
        jm, m = (JConvBN(64, relu=relu, dtype=JBF),
                 ConvBN(35, 64, relu=relu, dtype=BF))
    jx = jnp.asarray(x).astype(JBF) if layer.startswith("batchnorm") \
        else jnp.asarray(x)
    variables = with_stats(jm.init(jax.random.PRNGKey(0), jx), 2)
    if train:
        ref, upd = jm.apply(variables, jx, mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, jx)
    if layer.startswith("batchnorm"):
        sd = {"weight": "scale", "bias": "bias"}
        m.load_state_dict(
            {k: t(variables["params"][v]) for k, v in sd.items()}
            | {"running_" + k: t(variables["batch_stats"][k])
               for k in ("mean", "var")})
    else:
        weights.load_into(m, variables)
    m.train(train)
    with torch.no_grad():
        got = m(t(x).to(BF) if layer.startswith("batchnorm") else t(x))
    assert got.dtype == BF and ref.dtype == JBF
    assert_bf16_close(got, ref)
    if train:       # the running statistics stay f32
        assert m.running_mean.dtype == torch.float32
        np.testing.assert_allclose(m.running_mean.numpy(),
                                   upd["batch_stats"]["mean"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(m.running_var.numpy(),
                                   upd["batch_stats"]["var"], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("c_in", [3, 32])
def test_set_abstraction_matches_flax_bf16(c_in):
    """SA1's shape (3 f32 color channels ride the xyz gather) and a deeper
    layer's (bf16 features beside the f32 relative xyz)."""
    rng = np.random.RandomState(3)
    xyz = (rng.rand(2, 600, 3) * 0.1).astype(np.float32)
    feat = rng.rand(2, 600, c_in).astype(np.float32)
    jfeat = jnp.asarray(feat) if c_in <= 16 \
        else jnp.asarray(feat).astype(JBF)
    jm = JSetAbstraction(num_centroids=64, radius=0.02, num_neighbours=16,
                         mlp_channels=(32, 48), dtype=JBF)
    variables = with_stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(xyz),
                                   jfeat), 4)
    ref_xyz, ref = jm.apply(variables, jnp.asarray(xyz), jfeat)
    m = SetAbstraction(c_in, 64, 0.02, 16, (32, 48), dtype=BF)
    weights.load_into(m, variables)
    m.eval()
    with torch.no_grad():
        new_xyz, got = m(t(xyz), t(feat) if c_in <= 16 else t(feat).to(BF))
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(ref_xyz))
    assert got.dtype == BF and ref.dtype == JBF
    assert_bf16_close(got, ref)


def test_slab_set_abstraction_matches_flax_bf16(monkeypatch):
    """SA1 on the sorted slab: K6's plain version against the interpreted
    Pallas kernel, then the bf16 MLP and max."""
    import importlib
    jregion = importlib.import_module(
        "regnet_for_3d_grasping_tpu.geometry.region")
    monkeypatch.setattr(jregion, "SLAB_INTERPRET", True)
    pts = flat_cloud(1, 4096, 40, extent=0.12)
    jsc, sc = jsort(pts, 41)
    rgb = np.random.RandomState(42).rand(1, 4096, 3).astype(np.float32)
    jm = JSetAbstraction(num_centroids=256, radius=0.02, num_neighbours=16,
                         mlp_channels=(32, 48), dtype=JBF, slab_cell=CELL)
    args = (jsc.xyz, jnp.asarray(rgb))
    variables = with_stats(jm.init(jax.random.PRNGKey(0), *args, sc=jsc), 5)
    ref_xyz, ref = jm.apply(variables, *args, sc=jsc)
    m = SetAbstraction(3, 256, 0.02, 16, (32, 48), dtype=BF)
    weights.load_into(m, variables)
    m.eval()
    with torch.no_grad():
        new_xyz, got = m(sc.xyz, t(rgb), sc, CELL)
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(ref_xyz))
    assert_bf16_close(got, ref)


@pytest.mark.parametrize("use_slab", [False, True])
def test_feature_propagation_matches_flax_bf16(use_slab, monkeypatch):
    """bf16 sparse and skip features; the f32 3-NN weights promote the
    interpolation to f32 (JAX ``ops/knn.py``), the MLP rounds it.  On the
    slab the layer runs K8's plain version (JAX: the interpreted kernel)
    and gathers the bf16 features in key order."""
    import importlib
    jregion = importlib.import_module(
        "regnet_for_3d_grasping_tpu.geometry.region")
    monkeypatch.setattr(jregion, "SLAB_INTERPRET", True)
    rng = np.random.RandomState(30)
    pts = flat_cloud(1, 4096, 30)
    pts = pts[:, np.argsort(pts[0, :, 0], kind="stable")]
    keys = flat_cloud(1, 1000, 31)
    sfeat = jnp.asarray(rng.randn(1, 1000, 24)).astype(JBF)
    dfeat = jnp.asarray(rng.randn(1, 4096, 8)).astype(JBF)
    jm = JFeaturePropagation(mlp_channels=(32,), dtype=JBF,
                             use_slab=use_slab, nn_bound=0.06)
    args = (jnp.asarray(pts), jnp.asarray(keys), dfeat, sfeat)
    variables = with_stats(jm.init(jax.random.PRNGKey(0), *args), 6)
    ref = jm.apply(variables, *args)
    m = FeaturePropagation(32, (32,), 3, nn_bound=0.06, dtype=BF)
    weights.load_into(m, variables)
    m.eval()
    _cuda.reset_launches()
    with torch.no_grad():
        got = m(t(pts), t(keys), t(f32(dfeat)).to(BF), t(f32(sfeat)).to(BF),
                use_slab=use_slab)
    assert _cuda.fallbacks["fp3_slab"] == 0
    assert got.dtype == BF
    assert_bf16_close(got, ref)


def test_score_head_matches_flax_bf16():
    """The seg MLP, score Dense and BatchNorm in bf16 on the same 256-d
    features, the sigmoid on the f32 logit (JAX ``backbone.py:328-337``).
    The whole score net is held within the model's tolerance by the
    whole-model tests below."""
    mcfg = tiny_config(**{"model.compute_dtype": "bfloat16"}).model
    x = jnp.asarray(np.abs(np.random.RandomState(7).randn(
        2, 300, mcfg.fp_channels[-1][-1]))).astype(JBF)
    jmlp = JSharedMLP(mcfg.seg_channels, dtype=JBF)
    jdense = fnn.Dense(1, use_bias=False, dtype=JBF)
    jbn = fnn.BatchNorm(use_running_average=True, epsilon=1e-5, dtype=JBF)
    vm = with_stats(jax.jit(jmlp.init)(jax.random.PRNGKey(0), x), 8)
    h = jmlp.apply(vm, x)
    vd = jax.tree.map(np.array, jdense.init(jax.random.PRNGKey(1), h))
    vb = with_stats(jbn.init(jax.random.PRNGKey(2), jdense.apply(vd, h)), 9)
    logit = jbn.apply(vb, jdense.apply(vd, h))
    score = jax.nn.sigmoid(logit.astype(jnp.float32))[..., 0]
    bb = ScoreNet(mcfg).backbone
    variables = {"params": {"seg_mlp": vm["params"],
                            "score_dense": vd["params"],
                            "score_bn": vb["params"]},
                 "batch_stats": {"seg_mlp": vm["batch_stats"],
                                 "score_bn": vb["batch_stats"]}}
    weights.load_into(bb.seg_mlp, {c: variables[c]["seg_mlp"]
                                   for c in variables})
    bb.score_dense.weight.data = t(vd["params"]["kernel"].T)
    bb.score_bn.load_state_dict({
        "weight": t(vb["params"]["scale"]), "bias": t(vb["params"]["bias"]),
        "running_mean": t(vb["batch_stats"]["mean"]),
        "running_var": t(vb["batch_stats"]["var"])})
    bb.eval()
    with torch.no_grad():
        got = bb.score_bn(bb.score_dense(bb.seg_mlp(t(f32(x)).to(BF))))
    assert got.dtype == BF
    assert_bf16_close(got, logit)
    # the f32 sigmoids of torch and XLA differ by an f32 ulp on 1 % of
    # these entries
    np.testing.assert_allclose(torch.sigmoid(got.float())[..., 0].numpy(),
                               np.asarray(score), rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("head", ["two_stage", "refine"])
def test_heads_match_flax_bf16(head):
    """bf16 logits and residuals; the score channels' sigmoid in bf16."""
    cfg = tiny_config(**{"model.compute_dtype": "bfloat16"}).model
    rng = np.random.RandomState(8)
    pooled = jnp.asarray(np.abs(rng.randn(2, 400, 32))).astype(JBF)
    group = jnp.asarray(np.abs(rng.randn(2, 400, 32))).astype(JBF)
    jargs = (pooled,) if head == "two_stage" else (pooled, group)
    jm = (JTwoStageHead if head == "two_stage" else JRefineHead)(
        jtiny().model, dtype=JBF)
    variables = with_stats(jm.init(jax.random.PRNGKey(0), *jargs), 9)
    ref = jm.apply(variables, *jargs)
    m = (TwoStageHead if head == "two_stage" else RefineHead)(cfg)
    weights.load_into(m, variables)
    m.eval()
    with torch.no_grad():
        got = m(*(t(f32(a)).to(BF) for a in jargs))
    # four layers deep, the last three summing 1,024 and 256 products: a
    # layer's one-ulp differences add up (measured on the TwoStageHead:
    # logits 0.9978 equal, 0.9984 within one ulp, 1.6e-3 of the largest;
    # residuals 0.9988, 0.9994, 3.9e-3 of the largest)
    for g, r in zip(got, ref):
        assert g.dtype == BF and r.dtype == JBF
        assert_bf16_close(g, r, share=0.995, top=2.0 ** -7)


def test_decode_proposals_matches_jax_bf16():
    """bf16 residuals: ``sel * radius`` rounds in bf16 before the f32
    centers are added; the anchor templates promote the rest to f32."""
    rng = np.random.RandomState(10)
    reg = jnp.asarray(rng.randn(2, 60, 4, 10) * 0.5).astype(JBF)
    anchor = rng.randint(0, 4, (2, 60))
    centers = rng.rand(2, 60, 3).astype(np.float32)
    ref = jdecode(reg, jnp.asarray(anchor), jnp.asarray(centers), 0.06)
    got = decode_proposals(t(f32(reg)).to(BF), t(anchor), t(centers), 0.06)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    assert_bf16_close(got, ref)
    np.testing.assert_array_equal(got[..., :3].numpy(),
                                  np.asarray(ref[..., :3]))
    # the product rounds in bf16: not the f32 decode of the same values
    f32_decode = decode_proposals(t(f32(reg)), t(anchor), t(centers), 0.06)
    assert not torch.equal(got[..., :3], f32_decode[..., :3])


# --- the pools -----------------------------------------------------------------

@pytest.mark.parametrize("n,c,s,k", [(1600, 128, 96, 16), (800, 64, 72, 8)])
def test_k4_gather_max_plain_bf16_matches_pallas(n, c, s, k):
    rng = np.random.RandomState(11)
    feat = jnp.asarray(rng.randn(2, n, c)).astype(JBF)
    mask = rng.rand(2, s, n) < 0.008
    mask[0, 0] = False            # an all-empty row: all-zero indices
    noise = jsamp.hash_uniform(jax.random.PRNGKey(7), mask.shape)
    idx, any_valid, _ = jsamp.bucket_choice(jnp.asarray(mask), k,
                                            score=noise)
    idx = np.asarray(jnp.where(any_valid[..., None], idx, 0))
    ref = jpool.gather_max_pallas(feat, jnp.asarray(idx),
                                  jsamp.bucket_stride(n, k), interpret=True)
    got = pooling.gather_max(t(f32(feat)).to(BF), t(idx))
    assert got.dtype == BF and ref.dtype == JBF
    np.testing.assert_array_equal(f32(got), f32(ref))


@pytest.mark.parametrize("geometry", ["group", "crop"])
def test_k9_gather_max_slab_plain_bf16_matches_pallas(geometry):
    """bf16 rows; queries with no covered slot pool to bf16(-1e38), the
    sentinel JAX stores in bf16 (``slab.py:955``)."""
    pts = flat_cloud(1, 18432, 1)
    jsc, sc = jsort(pts, 2)
    rng = np.random.RandomState(3)
    centers = pts[0][rng.choice(18432, 200, False)].copy()
    centers[-5:] = [5.0, 0.0, 0.0]            # off the table: no pick
    centers = centers[np.argsort(centers[:, 0], kind="stable")][None]
    if geometry == "group":
        idx, _, sel, off = slab.group_slab(sc, t(centers), 5, 0.03, 256,
                                           CELL)
        win, spw = slab.GROUP_WIN, slab.GROUP_SPW
    else:
        frames = np.broadcast_to(np.eye(3, dtype=np.float32),
                                 (1, 200, 3, 3)).copy()
        idx, _, sel, off = slab.crop_slab(sc, t(frames), t(centers), 9,
                                          (0.0, 0.03, 0.04, 0.005), 64, CELL)
        idx = torch.where(sel[..., None], idx, 0)
        win, spw = slab.CROP_WIN, slab.CROP_SPW
    feat = jnp.asarray(rng.randn(1, 18432, 40)).astype(JBF)
    ref = jslab.gather_max_slab(feat, jnp.asarray(idx.numpy()),
                                jnp.asarray(off.numpy()), win, spw,
                                interpret=True)
    got = slab.gather_max_slab(t(f32(feat)).to(BF), idx, off, win, spw)
    assert got.dtype == BF and ref.dtype == JBF
    np.testing.assert_array_equal(f32(got), f32(ref))
    nothing = float(torch.tensor(-1e38).to(BF))
    assert nothing != -1e38 and (f32(got)[0][~sel[0].numpy()]
                                 == nothing).all()
    assert not sel[0, -5:].any()


def test_bf16_pool_gradient_raises(monkeypatch):
    """(Kept under its name from before bf16 training was ported.)  A bf16
    pool asked for a gradient no longer raises: it runs its argmax form
    and, in the backward, the bf16 scatter of its winners (on the CPU their
    plain versions, counted here), and the gradient is bf16."""
    calls = []

    def counted(mod, name):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a: calls.append(name)
                            or fn(*a))

    counted(pooling, "gather_max_argmax_plain")
    counted(pooling, "scatter_winner_plain")
    counted(slab, "gather_max_slab_argmax_plain")
    feat = torch.randn(1, 64, 8).to(BF).requires_grad_()
    idx = torch.randint(0, 64, (1, 4, 8), dtype=torch.int32)
    pooled = pooling.gather_max(feat, idx)
    pooled.backward(torch.ones_like(pooled))
    assert calls == ["gather_max_argmax_plain", "scatter_winner_plain"]
    assert pooled.dtype == feat.grad.dtype == BF
    assert float(feat.grad.float().sum()) == pooled.numel()
    calls.clear()
    off = torch.zeros(1, 1, dtype=torch.int32)
    f2 = feat.detach().clone().requires_grad_()
    pooled = slab.gather_max_slab(f2, torch.zeros(1, 4, 64, dtype=torch.int32),
                                  off, slab.CROP_WIN, slab.CROP_SPW)
    pooled.backward(torch.ones_like(pooled))
    assert calls == ["gather_max_slab_argmax_plain", "scatter_winner_plain"]
    assert f2.grad.dtype == BF and float(f2.grad[0, 0].float().sum()) == 32
    calls.clear()
    with torch.no_grad():      # without a gradient the plain max runs
        assert pooling.gather_max(feat, idx).dtype == BF
    assert calls == []


def test_bf16_entry_points_and_sentinel_in_the_sources():
    """Each bf16 form has its own C entry point and launch counter, and
    K9's bf16 sentinel is torch's (and JAX's) bf16(-1e38)."""
    for name, fn in (("gather_max_bf16", "regnet_gather_max_bf16"),
                     ("gather_max_slab_bf16", "regnet_gather_max_slab_bf16")):
        src, sym, _ = _cuda.SIGNATURES[name]
        assert sym == fn and name in _cuda.launches
        assert f'extern "C" int {fn}(' in (_cuda.CSRC / f"{src}.cu"
                                           ).read_text()
    text = (_cuda.CSRC / "gather_max_slab.cu").read_text()
    bits = int(re.search(r"nothing<uint16_t>\(\) \{\s*return (0x[0-9a-f]+)u;",
                         text).group(1), 16)
    want = torch.tensor(-1e38).to(BF).view(torch.int16).item() & 0xffff
    jwant = int(np.asarray(jnp.full((), -1e38, JBF)).view(np.uint16))
    assert bits == want == jwant


@pytest.mark.parametrize("name", sorted(_cuda.SIGNATURES | _cuda.QUERIES))
def test_entry_point_takes_the_arguments_its_signature_declares(name):
    """ctypes passes what `ops/_cuda` declares (a kernel's stream last):
    each C entry point takes that many parameters."""
    src, sym, argtypes = (_cuda.SIGNATURES | _cuda.QUERIES)[name]
    text = (_cuda.CSRC / f"{src}.cu").read_text()
    params = re.search(rf'extern "C" int {sym}\(([^)]*)\)', text).group(1)
    assert len([p for p in params.split(",")
                if p.strip() not in ("", "void")]) == len(argtypes)


# --- the whole model ----------------------------------------------------------

def assert_model_close(ref, out):
    np.testing.assert_array_equal(out.center_index.numpy(),
                                  np.asarray(ref.center_index))
    np.testing.assert_allclose(out.score.numpy(), np.asarray(ref.score),
                               atol=4e-3)
    for field in ("proposals", "final_grasps"):
        g, r = f32(getattr(out, field)), f32(getattr(ref, field))
        assert np.abs(g - r).max() <= 2e-2 * np.abs(r).max(), field
    for field in ("refine_accept", "score_accept", "crop_valid",
                  "region_valid"):
        same = (getattr(out, field).numpy()
                == np.asarray(getattr(ref, field))).mean()
        assert same >= 0.99, (field, same)
    for field in ("cls_logits", "reg", "refine_logits", "refine_reg"):
        assert getattr(out, field).dtype == BF
        assert getattr(ref, field).dtype == JBF


@pytest.mark.parametrize("path", ["full", "slab"])
def test_regnet_bf16_matches_jax(path):
    """The whole REGNet at the tiny configuration with
    ``compute_dtype="bfloat16"`` against JAX ``REGNet(cfg,
    dtype=jnp.bfloat16)``: on the full scan (K2/K5 semantics forced on
    both sides), and on the slab with the sort before the backbone, the
    serving configuration's placement."""
    if path == "full":
        pc = tiny_cloud()
        ref, out = run_full_slice(pc, tiny_model_variables(pc, JBF), JBF)
    else:
        ref, out, fallbacks = run_slice(PLACEMENTS["sort-first"], JBF)
        assert fallbacks == 0
        np.testing.assert_array_equal(out.point_order.numpy(),
                                      np.asarray(ref.point_order))
    assert_model_close(ref, out)


def test_bf16_configurations_build():
    """Both bf16 serving configurations build at full width (they raised
    before the bf16 compute dtype was ported) with every Dense in bf16."""
    from regnet_for_3d_grasping_torch.config import infer_config
    from regnet_for_3d_grasping_torch.nn.layers import Dense
    for over in ({}, {"region.slab_cell": 0.04, "model.fps_groups": 8,
                      "region.center_fps_groups": 8}):
        model = REGNet(infer_config(**over, **{
            "model.compute_dtype": "bfloat16"}))
        dense = [m for m in model.modules() if isinstance(m, Dense)]
        assert len(dense) == 33 and all(m.compute == BF for m in dense)
        assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="compute dtype"):
        REGNet(tiny_config(**{"model.compute_dtype": "float16"}))


# --- the infer CLI ------------------------------------------------------------

class _Captured(Exception):
    pass


@pytest.mark.parametrize("argv", [
    ["--fast"], ["--bf16"], [],
    ["--fast", "--slab-cell", "0", "--fps-groups", "1"],
    ["--bf16", "--slab-cell", "0.04", "--fps-groups", "4",
     "--group-num-more", "512", "--all-points-num", "4096"]])
def test_infer_cli_flags_reach_the_config_as_jax_sends_them(argv,
                                                            monkeypatch):
    """`--fast` is bf16 + slab 0.04 + G = 8; `--bf16`, `--slab-cell`,
    `--fps-groups` and `--group-num-more` reach the configuration as the
    JAX CLI sends them (its model class is replaced by a spy that stops
    the run)."""
    import importlib
    from regnet_for_3d_grasping_torch.cli import infer
    jinfer = importlib.import_module("regnet_for_3d_grasping_tpu.cli.infer")
    jmodels = importlib.import_module("regnet_for_3d_grasping_tpu.models")
    jcache = importlib.import_module("regnet_for_3d_grasping_tpu.utils.cache")
    seen = {}

    def spy(cfg, dtype=None):
        seen.update(cfg=cfg, dtype=dtype)
        raise _Captured

    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(jmodels, "REGNet", spy)
    with pytest.raises(_Captured):
        jinfer.main(["--no-eval", *argv])
    cfg = infer.config_from_args(infer.build_parser().parse_args(
        ["--no-eval", *argv]))
    jcfg = seen["cfg"]
    for section, field in (
            ("region", "slab_cell"), ("region", "center_fps_groups"),
            ("model", "fps_groups"), ("region", "group_num_more"),
            ("region", "num_points"), ("region", "center_num"),
            ("region", "accept_margin"), ("region", "refine_iters"),
            ("region", "refine_pose")):
        assert (getattr(getattr(cfg, section), field)
                == getattr(getattr(jcfg, section), field)), field
    assert cfg.model.compute_dtype == jnp.dtype(
        seen["dtype"] or jnp.float32).name
    if argv == ["--fast"]:
        assert (cfg.model.compute_dtype, cfg.region.slab_cell,
                cfg.model.fps_groups, cfg.region.center_fps_groups) == (
            "bfloat16", 0.04, 8, 8)


def test_dense_bf16_keeps_its_rounded_kernel_in_step_with_the_weight():
    """The kernel is rounded at use, so the product follows every change of
    the f32 weight (an optimizer step, `load_state_dict`), and the gradient
    reaches the f32 weight."""
    from regnet_for_3d_grasping_torch.nn.layers import Dense
    d = Dense(8, 4, BF)
    x = torch.randn(3, 8)
    with torch.no_grad():
        a = d(x)
        d.weight.mul_(2.0)
        b = d(x)
        d.load_state_dict({"weight": torch.ones(4, 8)})
        c = d(x)
    assert torch.equal(b, (a.float() * 2).to(BF))
    assert torch.equal(c, bf16_matmul_ref(x, torch.ones(4, 8)))
    d(x).float().sum().backward()
    assert d.weight.grad is not None and d.weight.grad.dtype == torch.float32


def bf16_matmul_ref(x, w):
    return (x.to(BF).float() @ w.to(BF).float().T).to(BF)
