"""Parity of the port's bf16 training (the train CLI's ``--bf16``) with the
JAX package's bf16 training (``REGNet(cfg, dtype=jnp.bfloat16)`` under its
train step), on the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages; the
JAX side runs op by op, its Pallas kernels in interpret mode, as the other
port tests run it.

- The pools' plain versions on bf16 rows: K4's argmax form bit-equal to
  the JAX package's XLA argmax pool and, on bucket-structured indices, its
  Pallas kernel; K9's to its Pallas kernel, on ReLU features whose maxima
  tie across rows.  Their backward bit-equal to ``jax.vjp`` of the JAX
  package's custom VJPs on bf16: XLA's bf16 scatter-add sums in s order,
  each add rounded to bf16 (not once, from an f32 sum).  The CUDA
  backward's rounding, read from its source, is torch's.
- The bf16 cross entropy's ``log_softmax`` bit-equal to
  ``jax.nn.log_softmax`` and its VJP; the losses of bf16 outputs as JAX
  promotes them (every metric f32, so the total's cotangent is f32).
- A whole bf16 training step of the tiny model, on the full scan (here)
  and on slab + G = 8 (``tests/test_torch_port_train_bf16_slab.py``, with
  the helpers of this file), with dropout off.  A bf16 network carries any one-ulp
  difference of a rounding to values far away: a train-mode BatchNorm
  divides by each channel's spread, and masked FPS turns one score that
  crosses the threshold into other centers.  Three implementation details
  that are not the model's formulas decide such roundings, so both sides
  take them out the same way here (`order_free`): the bf16 GEMMs sum in
  f64 (XLA's CPU dot and MKL sum in other orders), BatchNorm's statistics
  sum in f64 (likewise), and BatchNorm's ``rsqrt`` is ``1 / sqrt`` (XLA's
  CPU ``rsqrt`` is an approximation, one ulp off ``1 / sqrt`` on about a
  third of its inputs; torch's CPU ``rsqrt`` is ``1 / sqrt``).  The JAX
  side runs under ``jax.enable_x64`` for its f64 sums, which makes the
  flax one-hot weights of its stage-2 loss, and so its loss, f64; the
  losses' dtypes without x64 are held apart.  Then every layer's output
  is bit-equal and the selections are equal; what is left is the
  backward's own summation orders (scatter-adds, BatchNorm's gradient
  sums).  Tolerances: loss rtol 1e-6; running statistics rtol 1e-6; each
  gradient array within a quarter of JAX's own bf16-against-f32 gap of
  that array on the same step (each relative to the largest entry of its
  ConvBN block, as in ``tests/test_torch_port_train.py``; an array whose
  gap is 0 exact).  Measured, full scan: the loss 4.9e-8 apart (JAX's
  bf16 against its f32: 0.20); the largest ratio of the port's gradient
  error to the gap 0.109 (SA1's first BatchNorm bias: 1.2e-2 against
  0.11), the largest error 5.0e-2 of its block, where the gaps run from
  2.9e-2 to 1.7.  Slab: the loss 8.3e-9 apart (0.35); the largest ratio
  0.042, the largest error 3.3e-2; gaps up to 3.1.
"""

import importlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import linear as flinear
from flax.linen import normalization as fnorm
from jax import lax

from regnet_for_3d_grasping_tpu.geometry import gt as jgt
from regnet_for_3d_grasping_tpu.models import REGNet as JREGNet
from regnet_for_3d_grasping_tpu.models.regnet import (
    REGNetOutput as JREGNetOutput)
from regnet_for_3d_grasping_tpu.ops import pooling as jpool
from regnet_for_3d_grasping_tpu.ops import slab as jslab
from regnet_for_3d_grasping_tpu.train import losses as jlosses
from regnet_for_3d_grasping_tpu.utils.config import tiny_config as jtiny

from regnet_for_3d_grasping_torch import config as pconfig
from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.models.regnet import REGNet, REGNetOutput
from regnet_for_3d_grasping_torch.nn import layers
from regnet_for_3d_grasping_torch.ops import _cuda, pooling, slab
from regnet_for_3d_grasping_torch.train import losses, trainer

import test_torch_port_train as T
from test_torch_port_train import (  # noqa: F401  (fixtures)
    pool_case, random_output, slab_pool_case)

BF = torch.bfloat16
JBF = jnp.bfloat16
jregion = importlib.import_module("regnet_for_3d_grasping_tpu.geometry.region")


def t(a):
    return torch.from_numpy(np.array(a))


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def bits(a) -> np.ndarray:
    """bf16 values as their 16 bits (NaN compares equal to its copy)."""
    return f32(a).view(np.uint32) >> 16


def to_bf16(a: np.ndarray):
    """(JAX bf16 array, torch bf16 tensor) of the same values."""
    j = jnp.asarray(a).astype(JBF)
    return j, t(f32(j)).to(BF)


# --- the pools on bf16 rows ----------------------------------------------------

def test_k4_argmax_plain_bf16_matches_jax(pool_case):
    """Bucket-structured indices (duplicate fills), a row with no pick,
    ReLU features whose maxima tie across rows: pooled values and winners
    bit-equal to the XLA pool (``pooling.py:241-246``) and to the Pallas
    kernel's bf16 ``with_argmax`` form."""
    feat, idx, stride = pool_case
    jf, tf = to_bf16(feat)
    gp, gw = pooling.gather_max_argmax(tf, t(idx))
    assert gp.dtype == BF and gw.dtype == torch.int32
    xp, xw = jpool._xla_pooled_argmax(jf, jnp.asarray(idx))
    rp, rw = jpool.gather_max_pallas(jf, jnp.asarray(idx), stride,
                                     with_argmax=True, interpret=True)
    assert rp.dtype == xp.dtype == JBF
    for p, w in ((xp, xw), (rp, rw)):
        np.testing.assert_array_equal(bits(gp), bits(p))
        np.testing.assert_array_equal(gw.numpy(), np.asarray(w))
    assert torch.equal(gp, pooling.gather_max_plain(tf, t(idx)))
    g = f32(jf)[np.arange(2)[:, None, None], idx]
    assert ((g == g.max(2, keepdims=True)).sum(2) > 1).mean() > 0.2


def test_k4_argmax_plain_bf16_takes_the_first_nan(pool_case):
    """A NaN wins at its first slot, as jnp.argmax does in the XLA pool."""
    feat, idx, _ = pool_case
    feat = feat.copy()
    feat[0, idx[0, 3, 5], 2] = np.nan
    feat[1, idx[1, 7, 0], 9] = np.nan
    jf, tf = to_bf16(feat)
    gp, gw = pooling.gather_max_argmax(tf, t(idx))
    xp, xw = jpool._xla_pooled_argmax(jf, jnp.asarray(idx))
    assert np.isnan(f32(gp)).sum() >= 2
    np.testing.assert_array_equal(f32(gp), f32(xp))   # NaN equal to NaN
    np.testing.assert_array_equal(gw.numpy(), np.asarray(xw))


@pytest.mark.parametrize("geometry", ["group", "crop"])
def test_k9_argmax_plain_bf16_matches_pallas(slab_pool_case, geometry):
    """K9's bf16 argmax form (``slab.py:996-1010``: compare in f32, store
    back losslessly): winners and pooled values bit-equal, queries with no
    covered slot at bf16(-1e38) and winner 0."""
    feat, cases = slab_pool_case
    idx, off, win, spw = cases[geometry]
    jf, tf = to_bf16(feat)
    rp, rw = jslab.gather_max_slab(jf, jnp.asarray(idx.numpy()),
                                   jnp.asarray(off.numpy()), win, spw,
                                   with_argmax=True, interpret=True)
    gp, gw = slab.gather_max_slab_argmax(tf, idx, off, win, spw)
    assert gp.dtype == BF and rp.dtype == JBF
    np.testing.assert_array_equal(bits(gp), bits(rp))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(rw))
    assert torch.equal(gp, slab.gather_max_slab_plain(tf, idx, off, win, spw))
    none = ~slab.slab_cover(idx, off, win, spw).any(-1)
    assert none.any() and not none.all()
    nothing = torch.tensor(-1e38).to(BF)
    assert (gp[none] == nothing).all() and (gw[none] == 0).all()


def k4_jvjp(feat, idx, stride, gout):
    _, vjp = jax.vjp(lambda f: jpool.gather_max(f, jnp.asarray(idx), stride),
                     feat)
    return vjp(gout)[0]


def k9_jvjp(feat, idx, off, win, spw, gout):
    _, vjp = jax.vjp(lambda f: jslab.gather_max_slab_vjp(
        f, jnp.asarray(idx.numpy()), jnp.asarray(off.numpy()), win, spw,
        True), feat)
    return vjp(gout)[0]


def test_k4_backward_bf16_matches_the_jax_vjp(pool_case):
    """The gradient of a bf16 pool through autograd (the argmax form, then
    the bf16 backward) bit-equal to ``jax.vjp`` of ``ops.pooling.
    gather_max`` on bf16, whose scatter-add rounds each add; the ReLU
    features send many rows' gradients to one winner row."""
    feat, idx, stride = pool_case
    jf, tf = to_bf16(feat)
    jg, tg = to_bf16(np.random.RandomState(4).randn(2, 40, 24))
    ref = k4_jvjp(jf, idx, stride, jg)
    assert ref.dtype == JBF
    f = tf.clone().requires_grad_()
    pooled = pooling.gather_max(f, t(idx))
    assert pooled.dtype == BF and pooled.requires_grad
    pooled.backward(tg)
    assert f.grad.dtype == BF
    np.testing.assert_array_equal(bits(f.grad), bits(ref))
    # a sum in f32 rounded once gives other values: the rule matters
    _, win = pooling.gather_max_argmax(tf, t(idx))
    once = pooling.scatter_winner_plain(tg.float(), win, 700).to(BF)
    assert not torch.equal(once, f.grad)


@pytest.mark.parametrize("geometry", ["group", "crop"])
def test_k9_backward_bf16_matches_the_jax_vjp(slab_pool_case, geometry):
    feat, cases = slab_pool_case
    idx, off, win, spw = cases[geometry]
    jf, tf = to_bf16(feat)
    jg, tg = to_bf16(np.random.RandomState(7).randn(2, idx.shape[1], 20))
    ref = k9_jvjp(jf, idx, off, win, spw, jg)
    f = tf.clone().requires_grad_()
    slab.gather_max_slab(f, idx, off, win, spw).backward(tg)
    assert f.grad.dtype == BF
    np.testing.assert_array_equal(bits(f.grad), bits(ref))
    assert f.grad.float().abs().sum() > 0


def test_scatter_winner_bf16_is_an_ordered_sum_rounded_at_each_add():
    """Against a plain Python loop over s, on a case where many (s, c)
    share a key and the order decides the rounding."""
    rng = np.random.RandomState(9)
    B, S, C, n = 2, 50, 6, 3
    g = t(rng.randn(B, S, C) * 4).to(BF)
    win = t(rng.randint(0, n, (B, S, C)).astype(np.int32))
    got = pooling.scatter_winner(g, win, n)
    ref = torch.zeros(B, n, C, dtype=BF)
    for b in range(B):
        for s in range(S):
            for c in range(C):
                r = int(win[b, s, c])
                ref[b, r, c] = (ref[b, r, c].float() + g[b, s, c].float()
                                ).to(BF)
    assert got.dtype == BF and torch.equal(got, ref)
    backwards = pooling.scatter_winner(g.flip(1), win.flip(1), n)
    assert not torch.equal(backwards, got)


def test_cuda_backward_rounds_as_torch_does():
    """The bf16 backward kernel rounds each f32 sum to bf16 by
    ``(u + 0x7fff + ((u >> 16) & 1)) >> 16`` and writes NaN as 0x7fc0:
    the rule of torch's (and XLA's) f32-to-bf16 conversion, held here on
    ties, subnormals, infinities, NaN and random values."""
    text = (_cuda.CSRC / "gather_max.cu").read_text()
    assert re.search(r"x != x \? \(uint16_t\)0x7fc0u\s*:\s*\(uint16_t\)\(\(u "
                     r"\+ 0x7fffu \+ \(\(u >> 16\) & 1u\)\) >> 16\)", text)
    rng = np.random.RandomState(3)
    u = np.concatenate([
        rng.randint(0, 2**32, 200000, dtype=np.uint64).astype(np.uint32),
        np.array([0x3f808000, 0x3f818000, 0x7f7fffff, 0x00008000, 0x80018000,
                  0x7f800000, 0xff800000, 0x7fc00000, 0x7f800001, 0],
                 np.uint32)])
    x = u.view(np.float32)
    nan = np.isnan(x)
    want = t(x).to(BF).view(torch.int16).numpy().view(np.uint16)
    got = np.where(nan, 0x7fc0,
                   ((u.astype(np.uint64) + 0x7fff + ((u >> 16) & 1)) >> 16)
                   .astype(np.uint16))
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert (got[nan] == 0x7fc0).all() and ((want[nan] & 0x7fff) > 0x7f80).all()


def test_bf16_pool_gradient_launches_its_own_entry_points(monkeypatch):
    """Off the CPU a bf16 pool with a gradient launches its bf16 argmax
    form and, in the backward, the bf16 scatter, each under its own entry
    point and counter; f32 keeps its own.  Tensors on the meta device
    stand in for the card's, with the launch recorded instead of made."""
    seen = []
    monkeypatch.setattr(_cuda, "launch", lambda name, *a: seen.append(name))
    monkeypatch.setattr(_cuda, "check", lambda *a: None)
    meta = torch.device("meta")
    for dtype, suffix in ((BF, "_bf16"), (torch.float32, "")):
        seen.clear()
        f = torch.empty(2, 4096, 20, dtype=dtype, device=meta)
        f.requires_grad_()
        pooled = pooling.gather_max(
            f, torch.empty(2, 6, 8, dtype=torch.int32, device=meta))
        pooled.backward(torch.empty_like(pooled))
        fs = torch.empty(2, 4096, 20, dtype=dtype, device=meta)
        fs.requires_grad_()
        pooled = slab.gather_max_slab(
            fs, torch.empty(2, 6, 64, dtype=torch.int32, device=meta),
            torch.zeros(2, 1, dtype=torch.int32), slab.CROP_WIN,
            slab.CROP_SPW)
        pooled.backward(torch.empty_like(pooled))
        assert seen == [f"gather_max_argmax{suffix}",
                        f"gather_max_backward{suffix}",
                        f"gather_max_slab_argmax{suffix}",
                        f"gather_max_backward{suffix}"]
        assert pooled.dtype == f.grad.dtype == fs.grad.dtype == dtype
    for name in ("gather_max_argmax_bf16", "gather_max_backward_bf16",
                 "gather_max_slab_argmax_bf16"):
        src, sym, _ = _cuda.SIGNATURES[name]
        assert sym == "regnet_" + name and name in _cuda.launches
        assert f'extern "C" int {sym}(' in (_cuda.CSRC / f"{src}.cu"
                                             ).read_text()


# --- the losses ------------------------------------------------------------------

@pytest.mark.parametrize("A", [2, 4, 7])
def test_log_softmax_bf16_matches_jax(A):
    """Forward and VJP as ``jax.nn.log_softmax`` on bf16 (one fused XLA
    computation that rounds the shift, the sum of the f32 exps, its log and
    the result, but not the exps): bit-equal but where torch's f32 exp and
    XLA's are an f32 ulp apart across a bf16 rounding (torch's CPU exp
    takes another routine for a vector's tail, so which entries varies;
    measured 0 to 3 of 6,000), and there within one bf16 ulp.  torch's own
    bf16 ``log_softmax`` rounds once and differs far more often."""
    rng = np.random.RandomState(A)
    jx, tx = to_bf16(rng.randn(3000, A) * 3)
    jg, tg = to_bf16(rng.randn(3000, A))
    out, vjp = jax.vjp(lambda v: jax.nn.log_softmax(v, -1), jx)
    x = tx.clone().requires_grad_()
    got = losses.log_softmax(x)
    got.backward(tg)
    assert got.dtype == BF and x.grad.dtype == BF
    for a, b in ((got, out), (x.grad, vjp(jg)[0])):
        apart = np.abs(bits(a).astype(np.int64) - bits(b).astype(np.int64))
        assert apart.max() <= 1 and (apart == 0).mean() >= 0.999
    once = bits(torch.log_softmax(tx, -1)) != bits(out)
    assert once.mean() > 0.01


@pytest.mark.parametrize("stage2,stage3,order", [
    (True, True, False), (True, False, True)])
def test_losses_of_bf16_outputs_match_jax(stage2, stage3, order):
    """The heads' logits and residuals in bf16, as a bf16 model gives
    them: every JAX metric comes out f32, so its total's cotangent is f32
    (the port's too); the values and the gradients that reach the bf16
    outputs agree."""
    rng = np.random.RandomState(21)
    fields, score_gt, grasp_gt, matched = random_output(rng, order=order)
    low = ("cls_logits", "reg", "refine_logits", "refine_reg")
    jfields = {k: None if v is None else jnp.asarray(v)
               for k, v in fields.items()}
    for k in low:
        jfields[k] = jfields[k].astype(JBF)
    jout = JREGNetOutput(**jfields)
    diff = ("score",) + low

    def jloss(d):
        return jlosses.regnet_losses(
            jout._replace(**d), jnp.asarray(score_gt), jnp.asarray(grasp_gt),
            jnp.asarray(matched), jtiny(), stage2, stage3)

    (rtotal, rmetrics), rgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jfields[k] for k in diff})
    assert rtotal.dtype == jnp.float32
    assert {str(v.dtype) for v in rmetrics.values()} == {"float32"}
    tf = {k: None if v is None else t(v) for k, v in fields.items()}
    for k in low:
        tf[k] = t(f32(jfields[k])).to(BF)
    for k in diff:
        tf[k].requires_grad_()
    total, metrics = losses.regnet_losses(
        REGNetOutput(**tf), t(score_gt), t(grasp_gt), t(matched),
        pconfig.tiny_config(), stage2, stage3)
    assert total.dtype == torch.float32
    assert {v.dtype for v in metrics.values()} == {torch.float32}
    total.backward()
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(rmetrics[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    for k in diff:
        g = tf[k].grad
        g = torch.zeros_like(tf[k]) if g is None else g
        assert g.dtype == tf[k].dtype
        np.testing.assert_allclose(f32(g), f32(rgrads[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


# --- dropout ----------------------------------------------------------------------

def test_dropout_draws_one_mask_in_f32_and_bf16():
    """One generator gives one mask whatever the dtype (flax's Bernoulli
    mask does not depend on it); in bf16 the kept values are divided by
    bf16(1 - p), as JAX divides by the weak float."""
    x = torch.rand(64, 300) + 0.5
    for p in (0.5, 0.3):
        a = layers.dropout(x, p, torch.Generator().manual_seed(8))
        b = layers.dropout(x.to(BF), p, torch.Generator().manual_seed(8))
        assert b.dtype == BF
        assert torch.equal(a != 0, b != 0)
        keep = float(torch.tensor(1 - p).to(BF))
        want = (x.to(BF).float() / keep).to(BF)
        assert torch.equal(b[b != 0], want[b != 0])
        jwant = np.asarray((jnp.asarray(f32(x.to(BF))).astype(JBF)
                            / (1.0 - p)).astype(jnp.float32))
        np.testing.assert_array_equal(f32(b)[f32(b) != 0],
                                      jwant[f32(b) != 0])


# --- a whole bf16 training step -------------------------------------------------------

def _jstats(x, axes, dtype, axis_name=None, axis_index_groups=None,
            use_mean=True, use_fast_variance=True, mask=None,
            force_float32_reductions=True):
    """flax's train-mode statistics with the sums in f64 (the reduction's
    order taken out), rounded to f32 as its own are."""
    axes = fnorm._canonicalize_axes(x.ndim, axes)
    x64 = x.astype(jnp.float64)
    mu = x64.mean(axes).astype(jnp.float32)
    mu2 = (x64 * x64).mean(axes).astype(jnp.float32)
    return mu, jnp.maximum(0.0, mu2 - mu * mu)


def _jdot(a, b, dims, precision=None, preferred_element_type=None):
    """flax Dense's product with the sums in f64, rounded to f32 and then
    to the operands' dtype."""
    out = lax.dot_general(a.astype(jnp.float64), b.astype(jnp.float64), dims)
    return out.astype(jnp.float32).astype(jnp.result_type(a, b))


def _stats(x):
    axes = tuple(range(x.dim() - 1))
    xd = x.double()
    mu = xd.mean(axes).float()
    mu2 = (xd * xd).mean(axes).float()
    return mu, (mu2 - mu * mu).clamp(min=0.0)


def _gemm(x, w):
    return torch.nn.functional.linear(
        x.to(BF).double(), w.to(BF).double()).float().to(BF)


def _lax_with(**fns):
    """A stand-in for the ``jax.lax`` module seen by one flax module."""
    proxy = types.SimpleNamespace(**{k: getattr(lax, k) for k in dir(lax)
                                     if not k.startswith("__")})
    for k, v in fns.items():
        setattr(proxy, k, v)
    return proxy


def _formula_d2(three_nn_slab):
    """JAX's slab 3-NN with its d2 recomputed op by op from the indices it
    returns, ``(dx*dx + dy*dy) + dz*dz``: the kernel's compiled multiply-adds
    are contracted, one ulp off that formula (the port's)."""
    def wrapped(query, key, *args, **kwargs):
        idx, d2, proven = three_nn_slab(query, key, *args, **kwargs)
        B, Nq, k = idx.shape
        rows = jnp.take_along_axis(key, idx.reshape(B, Nq * k, 1), axis=1)
        d = rows.reshape(B, Nq, k, 3) - query[:, :, None, :]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        formula = (dx * dx + dy * dy) + dz * dz
        return idx, jnp.where(d2 < 1e38, formula, d2), proven
    return wrapped


def order_free(mp):
    """Both packages sum the bf16 GEMMs and BatchNorm's statistics in f64
    and take BatchNorm's rsqrt as 1 / sqrt; JAX's slab 3-NN distances are
    the formula's (see the module docstring)."""
    mp.setattr(jslab, "three_nn_slab", _formula_d2(jslab.three_nn_slab))
    mp.setattr(flinear, "lax", _lax_with(dot_general=_jdot))
    mp.setattr(fnorm, "lax", _lax_with(rsqrt=lambda x: 1.0 / jnp.sqrt(x)))
    mp.setattr(fnorm, "_compute_stats", _jstats)
    mp.setattr(layers, "batch_statistics", _stats)
    mp.setattr(layers, "bf16_matmul", _gemm)


def jax_step(jcfg, variables, batch, key, stage, dtype):
    """The loss, metrics, gradients and new running statistics of the
    JAX package's train step (``trainer._step_body``'s loss_fn), op by
    op, with the network at `dtype` and the parameters f32."""
    jmodel = JREGNet(jcfg, dtype=dtype)
    k_sample, k_drop = jax.random.split(key)
    b = jax.tree.map(jnp.asarray, tuple(batch))

    def loss_fn(params):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": jax.tree.map(
                jnp.asarray, variables["batch_stats"])},
            b[0], train=True, with_refine=stage == "refine",
            rngs={"sampling": k_sample, "dropout": k_drop},
            mutable=["batch_stats"])
        grasp_gt, matched = jgt.match_centers_to_gt(
            out.centers[..., :3], b[2], b[3], b[4],
            jcfg.region.gt_match_dist2)
        total, metrics = jlosses.regnet_losses(
            out, b[1], grasp_gt, matched, jcfg,
            with_stage2=stage in ("region", "refine"),
            with_stage3=stage == "refine")
        return total, (mutated["batch_stats"], metrics, out)

    (_, (stats, metrics, out)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(jax.tree.map(jnp.asarray, variables["params"]))
    out = jax.tree.map(lambda a: f32(a) if a.dtype == JBF else np.asarray(a),
                       out)
    return (out, {k: float(v) for k, v in metrics.items()},
            T.flat(grads, "params"), T.flat(stats, "batch_stats"))


def port_step(cfg, variables, batch, stage, forward_kw):
    """Forward, losses and backward of the port's bf16 model in training
    mode (no update)."""
    model = REGNet(pconfig._override(cfg, {"model.compute_dtype":
                                           "bfloat16"}))
    weights.load_into(model, variables)
    model.train()
    tb = trainer.DeviceBatch(*(t(np.asarray(x)) for x in batch))
    out, total, metrics = trainer.forward_losses(model, tb, stage,
                                                 **forward_kw)
    assert out.cls_logits.dtype == BF and out.refine_reg.dtype == BF
    assert total.dtype == torch.float32
    total.backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    grads = weights.state_dict_to_jax(
        {k: p.grad.double() for k, p in model.named_parameters()})
    stats = {k: v for k, v in weights.state_dict_to_jax(
        {k: v.double() for k, v in model.state_dict().items()}).items()
        if k.startswith("batch_stats/")}
    out = REGNetOutput(*(None if v is None else f32(v) if v.is_floating_point()
                         else v.numpy() for v in out))
    return out, {k: float(v.detach()) for k, v in metrics.items()}, grads, \
        stats


def bf16_steps(jcfg, cfg, variables, batch, key, stage, patch):
    """JAX's bf16 and f32 steps and the port's bf16 step on the same
    seeds, all `order_free`."""
    mp = pytest.MonkeyPatch()
    try:
        patch(mp)
        order_free(mp)
        spies = T.Spies(mp)
        with jax.enable_x64(True):
            ref = jax_step(jcfg, variables, batch, key, stage, JBF)
            kw = spies.forward_kw()
            ref32 = jax_step(jcfg, variables, batch, key, stage, None)
        got = port_step(cfg, variables, batch, stage, kw)
    finally:
        mp.undo()
    return ref, ref32, got


def block_errors(got, ref):
    """{gradient array: max |got - ref| over the largest |ref| of its
    ConvBN block (over 1 where the block's gradient is 0)}."""
    scale = {}
    for k, v in ref.items():
        block = k.rsplit("/", 2)[0]
        scale[block] = max(scale.get(block, 0.0), float(np.abs(v).max()))
    return {k: float(np.abs(got[k] - v).max())
            / (scale[k.rsplit("/", 2)[0]] or 1.0) for k, v in ref.items()}


def slab_g8_cfgs():
    """The slab step's shapes (``tests/test_torch_port_train.py``) with
    SA1's FPS in 8 groups: the run of record's ``--slab-cell 0.04
    --fps-groups 8``."""
    jcfg, cfg = T.slab_cfgs()
    return (pconfig._override(jcfg, {"model.fps_groups": 8}),
            pconfig._override(cfg, {"model.fps_groups": 8}))


def slab_scenario():
    jcfg, cfg = slab_g8_cfgs()
    s = T.jmake_scene(0, num_view=4096)
    frames, gscores, valid = T.pad_gt_grasps(s, 32)
    batch = T.jtrainer.DeviceBatch(
        pc=np.c_[s["view_cloud"], s["view_cloud_color"]][None].astype(
            np.float32),
        score=np.tanh(s["view_cloud_score"])[None].astype(np.float32),
        gt_frames=frames[None], gt_scores=gscores[None], gt_valid=valid[None])
    variables = jax.jit(JREGNet(T.slab_cfgs()[0]).init)(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.asarray(batch.pc))
    variables = jax.tree.map(np.array, variables)
    T.spread_scores_and_shrink_residuals(variables)

    def patch(mp):
        mp.setattr(jregion, "SLAB_INTERPRET", True)
        assert jregion.use_slab_backbone(4096, 16)

    return jcfg, cfg, variables, batch, jax.random.PRNGKey(0), patch


@pytest.fixture(scope="module")
def bf16_step():
    """The full-scan step (``tests/test_torch_port_train_bf16_slab.py``
    runs these tests on the slab step)."""
    jcfg, cfg, variables, batch, key = T.build_scenario()
    return "full", bf16_steps(jcfg, cfg, variables, batch, key, "refine",
                              T.full_scan_kernels)


def test_bf16_step_selections_equal(bf16_step):
    path, ((rout, *_), _, (out, *_)) = bf16_step
    fields = T.SELECTIONS + (("point_order",) if path == "slab" else ())
    T.assert_selections(out, rout, fields)
    assert rout.region_valid.any() and rout.crop_valid.any()
    np.testing.assert_allclose(out.score, rout.score, rtol=0, atol=1e-6)


def test_bf16_step_loss_and_gradients_match_jax(bf16_step):
    path, (ref, ref32, got) = bf16_step
    loss, rloss, loss32 = (r[1]["loss_total"] for r in (got, ref, ref32))
    err = block_errors(got[2], ref[2])
    gap = block_errors(ref32[2], ref[2])
    ratio = {k: err[k] / gap[k] for k in err if gap[k] > 0}
    worst = max(ratio, key=ratio.get)
    print(f"{path}: loss {loss} against JAX's bf16 {rloss} (rel "
          f"{abs(loss - rloss) / abs(rloss):.2e}; JAX's f32 {loss32}, rel "
          f"{abs(loss32 - rloss) / abs(rloss):.2e}); gradient error over "
          f"JAX's bf16-f32 gap at most {ratio[worst]:.3f} ({worst}: "
          f"{err[worst]:.3e} against {gap[worst]:.3e}); the largest error "
          f"{max(err.values()):.3e}; gaps {min(gap.values()):.3e} to "
          f"{max(gap.values()):.3e}")
    np.testing.assert_allclose(loss, rloss, rtol=1e-6)
    assert abs(loss32 - rloss) > 100 * abs(loss - rloss)
    assert got[2].keys() == ref[2].keys()
    for k in err:
        assert err[k] <= 0.25 * gap[k], (k, err[k], gap[k])
    for k in got[1]:
        np.testing.assert_allclose(got[1][k], ref[1][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_bf16_step_running_statistics_match_jax(bf16_step):
    """BatchNorm's running statistics stay f32 and follow JAX's."""
    _, (ref, _, got) = bf16_step
    assert got[3].keys() == ref[3].keys()
    for k, v in ref[3].items():
        assert v.dtype == np.float32
        np.testing.assert_allclose(got[3][k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
