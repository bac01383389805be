"""The set-abstraction layers' max over neighbours fused into their last
BatchNorm + ReLU, K13e and K13f (``ops/batch_norm``, ``csrc/batch_norm.cu``),
on the CPU.

- The plain K13e (`apply_max_plain`: m and the winners words) and K13f
  (`max_backward_plain`) against the written-out chain + ``amax`` and
  amax's autograd, and the autograd.Function the card runs
  (`batch_norm_max`, its wrappers on their plain versions here) against
  the chain + ``amax`` with autograd: output, dx, dweight, dbias and the
  running buffers, f32 and bf16, train, eval and frozen, and under
  `remat`; bit for bit.
- Both against the JAX package's ``jnp.max(SharedMLP(...)(h), axis=2)``
  (flax) and its ``jax.vjp``, from the same numpy inputs: f32 within 1e-5
  and bf16 within 2^-6 of the largest entry (the tolerances of
  `test_torch_port_batch_norm`'s flax comparison: another summation
  order, XLA's CPU rsqrt).
- Ties: rows repeated as ball query pads a short neighbourhood, a channel
  negative everywhere (m = 0, a K-way tie), -0.0 beside +0.0, and NaN.
- A numpy emulation of the kernel's loop (a new max resets the word, an
  equal value sets its bit, a NaN empties it) and of K13f's popcount
  against the plain twins; K > 64 and a wrong axis raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.nn.layers import SharedMLP as JSharedMLP

from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.nn import layers
from regnet_for_3d_grasping_torch.nn.layers import BatchNorm, SharedMLP
from regnet_for_3d_grasping_torch.ops import batch_norm as B

BF = torch.bfloat16
EPS = 1e-5


def bits(t):
    view = {torch.float32: torch.int32, BF: torch.int16,
            torch.int64: torch.int64}[t.dtype]
    return t.detach().contiguous().view(view)


def same(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def same_but_nan(a, b) -> bool:
    """Bit for bit where not NaN, NaN where the other is NaN (a sum that
    meets a NaN keeps the sign and payload of whichever operand the CPU
    took first)."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and same(torch.where(nan, 0, a),
                                                torch.where(nan, 0, b))


def inputs(shape, dtype, seed, pad=True):
    """x [B, S, K, C] (each channel its own offset and scale; where `pad`,
    some groups keep n < K distinct rows and repeat row 0 after them, as
    ball query pads a sparse neighbourhood), g [B, S, C], and a BatchNorm
    with random parameters and running statistics."""
    rng = np.random.RandomState(seed)
    b, s, k, c = shape
    x = rng.randn(*shape) * (rng.rand(c) * 3 + 0.1) + rng.randn(c) * 2
    if pad:
        n = rng.randint(1, k + 1, size=(b, s))
        rows = np.arange(k)[None, None, :]
        x = np.where((rows >= n[..., None])[..., None], x[:, :, :1], x)
    bn = BatchNorm(c)
    with torch.no_grad():
        for p, v in ((bn.weight, rng.rand(c) + 0.5),
                     (bn.bias, rng.randn(c) * 0.3),
                     (bn.running_mean, rng.randn(c) * 0.3),
                     (bn.running_var, rng.rand(c) + 0.5)):
            p.copy_(torch.tensor(v))
    g = torch.tensor(rng.randn(b, s, c)).to(dtype)
    return torch.tensor(x).to(dtype), g, bn


def set_mode(bn, mode):
    bn.train(mode != "eval")
    bn.frozen = mode == "frozen"
    return mode == "train"


def clone_bn(bn, mode):
    other = BatchNorm(bn.weight.shape[0])
    other.load_state_dict(bn.state_dict())
    set_mode(other, mode)
    return other


def chain(x, g, bn):
    """The written-out chain + amax with autograd (the module on a CPU
    tensor): m, dx, dweight, dbias, and y with its gradient from amax."""
    xr = x.clone().requires_grad_()
    y = bn.written_out(xr, True)
    y.retain_grad()
    m = y.amax(2)
    m.backward(g)
    return m.detach(), xr.grad, bn.weight.grad, bn.bias.grad, y.detach(), \
        y.grad


def fused(x, g, bn):
    """`batch_norm_max` (the Function the card runs) with autograd."""
    xr = x.clone().requires_grad_()
    m = B.batch_norm_max(xr, bn.weight, bn.bias, bn.running_mean,
                         bn.running_var, bn.training and not bn.frozen,
                         not layers._recomputing, bn.momentum, EPS)
    m.backward(g)
    return m.detach(), xr.grad, bn.weight.grad, bn.bias.grad


def statistics(x, bn, train):
    c = x.shape[-1]
    if train:
        st = B.stats_plain(x.reshape(-1, c))
        return st[0], st[1]
    return bn.running_mean, bn.running_var


@pytest.mark.parametrize("k,c", [(8, 16), (64, 40)])
@pytest.mark.parametrize("mode", ["train", "eval", "frozen"])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_plain_twins_are_the_chain_and_amax(dtype, mode, k, c):
    """K13e's m is amax of K13b's output and its words the mask of
    ``y == m``; K13f on those words is amax's autograd; bit for bit."""
    x, g, bn = inputs((2, 8, k, c), dtype, k + c)
    train = set_mode(bn, mode)
    m_ref, _, _, _, y, gy = chain(x, g, bn)
    mean, var = statistics(x, bn, train)
    w_b = bn.weight.detach()
    x3 = x.reshape(-1, k, c)
    m, w = B.apply_max_plain(x3, mean, var, w_b, bn.bias.detach(), EPS,
                             train)
    assert same(m, m_ref.reshape(-1, c)) and w.dtype == torch.int64
    y3 = y.reshape(-1, k, c)
    mask = torch.stack([(w >> i) & 1 for i in range(k)], 1).bool()
    assert torch.equal(mask, y3 == m[:, None])
    assert same(B.apply(x3.reshape(-1, c), mean, var, w_b, bn.bias.detach(),
                        EPS, train, True).reshape(-1, k, c).amax(1), m)
    gx = B.max_backward_plain(g.reshape(-1, c), w, k)
    assert gx.shape == (2 * 8, k, c) and same(gx, gy.reshape(-1, k, c))
    # the wrappers on CPU tensors are the plain versions
    m2, w2 = B.apply_max(x3, mean, var, w_b, bn.bias.detach(), EPS, train)
    assert same(m2, m) and torch.equal(w2, w)
    assert B.apply_max(x3, mean, var, w_b, bn.bias.detach(), EPS, train,
                       winners=False)[1] is None
    assert same(B.max_backward(g.reshape(-1, c), w, k), gx)
    # the padded groups tie at positive values, not only at the ReLU's 0
    pad_ties = ((mask.sum(1) > 1) & (m > 0)).sum()
    assert int(pad_ties) > 0


@pytest.mark.parametrize("mode", ["train", "eval", "frozen"])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_function_is_the_chain_and_amax(dtype, mode):
    """`batch_norm_max` (its wrappers on their plain versions) equals the
    chain + amax: m, dx, dweight, dbias and the running buffers, bit for
    bit."""
    x, g, bn = inputs((2, 8, 64, 16), dtype, 5)
    set_mode(bn, mode)
    ref_bn = clone_bn(bn, mode)
    got = fused(x, g, bn)
    ref = chain(x, g, ref_bn)[:4]
    for a, b in zip(got, ref):
        assert same(a, b)
    for a, b in ((bn.running_mean, ref_bn.running_mean),
                 (bn.running_var, ref_bn.running_var)):
        assert same(a, b)
    if mode != "train":
        assert same(bn.running_mean, clone_bn(bn, mode).running_mean)
    # without gradients: m alone, the same bits
    with torch.no_grad():
        b2 = clone_bn(ref_bn, mode)
        m = B.batch_norm_max(x, b2.weight, b2.bias, b2.running_mean,
                             b2.running_var, mode == "train", True,
                             b2.momentum, EPS)
    assert same(m, got[0])


def test_remat_updates_the_running_buffers_once():
    """Under `remat` the Function's forward runs twice (the recompute with
    `update` off): the running buffers move once and the gradients are
    the ones without remat, bit for bit."""
    x, g, bn = inputs((2, 6, 64, 16), torch.float32, 9)
    bn.train()
    runs = []
    for wrap in (False, True):
        b2 = clone_bn(bn, "train")
        xr = x.clone().requires_grad_()

        def f(t, b2=b2):
            return B.batch_norm_max(t, b2.weight, b2.bias, b2.running_mean,
                                    b2.running_var, True,
                                    not layers._recomputing, b2.momentum,
                                    EPS) * 2.0

        m = layers.remat(f, xr) if wrap else f(xr)
        m.backward(g)
        runs.append((b2.running_mean.clone(), b2.running_var.clone(),
                     xr.grad, b2.weight.grad, b2.bias.grad))
    for a, b in zip(*runs):
        assert same(a, b)
    assert not torch.equal(runs[0][0], bn.running_mean)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_shared_mlp_max_over_is_todays_chain(dtype):
    """On the CPU `SharedMLP(..., max_over=2)` is the chain and amax, as
    before the fusion; its last layer through the Function gives the same
    bits; with dropout in training mode the max follows the dropout."""
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(2, 8, 16, 7).astype(np.float32))
    m = SharedMLP(7, (12, 16), dtype=dtype).train()
    state = {k: v.clone() for k, v in m.state_dict().items()}
    got = m(x, max_over=2)
    m.load_state_dict(state)
    assert same(got, m(x).amax(2))
    m.load_state_dict(state)
    h = m.layer1.dense(m.layer0(x))
    bn = m.layer1.bn
    assert same(B.batch_norm_max(h, bn.weight, bn.bias, bn.running_mean,
                                 bn.running_var, True, True, bn.momentum,
                                 EPS), got)
    drop = SharedMLP(7, (12, 16), dropout_prob=0.5, dtype=dtype).train()
    state = {k: v.clone() for k, v in drop.state_dict().items()}
    a = drop(x, torch.Generator().manual_seed(3), max_over=2)
    drop.load_state_dict(state)
    assert same(a, drop(x, torch.Generator().manual_seed(3)).amax(2))


# --- against the JAX package ---------------------------------------------------

def jax_mlp_max(x, gout, channels, train, dtype):
    """``jnp.max(SharedMLP(channels)(x), axis=2)`` of the JAX package (flax)
    with random BatchNorm parameters and statistics, its output and its
    VJP (dx and every parameter's), and the variables."""
    jdt = jnp.bfloat16 if dtype == BF else None
    jm = JSharedMLP(channels, dtype=jdt)
    variables = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0),
                                               jnp.asarray(x)))
    rng = np.random.RandomState(4)
    for i in range(len(channels)):
        bn = variables["params"][f"layer{i}"]["bn"]
        bn["scale"] = (1 + 0.3 * rng.randn(*bn["scale"].shape)).astype(
            np.float32)
        bn["bias"] = (0.2 * rng.randn(*bn["bias"].shape)).astype(np.float32)
        st = variables["batch_stats"][f"layer{i}"]["bn"]
        st["mean"] = (0.1 * rng.randn(*st["mean"].shape)).astype(np.float32)
        st["var"] = (1 + rng.rand(*st["var"].shape)).astype(np.float32)

    def f(params, xx):
        out = jm.apply({"params": params,
                        "batch_stats": variables["batch_stats"]}, xx,
                       train=train, mutable=["batch_stats"] if train
                       else False)
        return jnp.max(out[0] if train else out, axis=2)

    m, vjp = jax.vjp(f, variables["params"], jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(gout).astype(m.dtype))
    return m, gx, gp, variables


def close(got, want, tol):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_matches_jax_max_of_the_flax_mlp(dtype, mode):
    """The port's SharedMLP with the max over neighbours (on the CPU: the
    chain and amax) and its last layer through the Function, against
    JAX's max of the flax SharedMLP and its VJP, from the same inputs; the
    neighbourhoods padded as ball query pads them (ties)."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 8, 7).astype(np.float32)
    n = rng.randint(1, 9, size=(2, 8))
    x = np.where((np.arange(8)[None, None, :] >= n[..., None])[..., None],
                 x[:, :, :1], x).astype(np.float32)
    gout = rng.randn(2, 8, 16).astype(np.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        jm, jgx, jgp, variables = jax_mlp_max(x, gout, (12, 16),
                                              mode == "train", dtype)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    g = torch.tensor(gout).to(dtype)
    for route in ("module", "function"):
        m = SharedMLP(7, (12, 16), dtype=dtype)
        weights.load_into(m, variables)
        m.train(mode == "train")
        xt = torch.tensor(x).requires_grad_()
        if route == "module":
            out = m(xt, max_over=2)
        else:
            bn = m.layer1.bn
            out = B.batch_norm_max(m.layer1.dense(m.layer0(xt)), bn.weight,
                                   bn.bias, bn.running_mean, bn.running_var,
                                   mode == "train", True, bn.momentum, EPS)
        out.backward(g)
        assert out.dtype == dtype
        close(out, jm, tol)
        close(xt.grad, jgx, tol)
        got = weights.state_dict_to_jax(
            {k: p.grad for k, p in m.named_parameters()})
        for layer in ("layer0", "layer1"):
            for name, want in (("dense/kernel",
                                jgp[layer]["dense"]["kernel"]),
                               ("bn/scale", jgp[layer]["bn"]["scale"]),
                               ("bn/bias", jgp[layer]["bn"]["bias"])):
                key = next(k for k in got if k.endswith(f"{layer}/{name}"))
                close(torch.tensor(np.asarray(got[key])), want, tol)


# --- ties and the words ---------------------------------------------------------

def emulate(y: np.ndarray) -> tuple:
    """The kernel's loop over the K rows of y [G, K, C] (f64 values): a new
    max resets the word to its bit, an equal value sets its bit (-0.0 equals
    +0.0), a NaN makes m NaN and the word 0.  Returns (m, words as uint64)."""
    g, k, c = y.shape
    best = y[:, 0].copy()
    word = np.ones((g, c), np.uint64)
    nan = np.isnan(y[:, 0])
    for i in range(1, k):
        v = y[:, i]
        bit = np.uint64(1) << np.uint64(i)
        new = v > best
        eq = v == best
        best = np.where(new, v, best)
        word = np.where(new, bit, np.where(eq, word | bit, word))
        nan |= np.isnan(v)
    return np.where(nan, np.nan, best), np.where(nan, np.uint64(0), word)


def tie_inputs(dtype, k=64, c=12):
    """x [2, 5, K, C], eval mode, with the ties the kernels must keep:
    padded groups; channel 1 negative everywhere after normalisation (m =
    0, a K-way tie); in group 0 channel 2 at -0.0 (x = mean, weight < 0,
    bias -0.0) beside +0.0 (the ReLU of a negative value) after the ReLU;
    a NaN in channel 3 of group 1."""
    x, g, bn = inputs((2, 5, k, c), dtype, 21)
    bn.eval()
    with torch.no_grad():
        bn.running_mean[1] = 1e4
        bn.weight[2] = -1.0
        bn.bias[2] = -0.0
        bn.running_mean[2] = 0.5
        x[0, 0, :, 2] = 0.5
        x[0, 0, 1::3, 2] = 7.0
        x[0, 1, 7, 3] = float("nan")
    return x, g, bn


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_ties_and_nan(dtype):
    x, g, bn = tie_inputs(dtype)
    c = x.shape[-1]
    y = bn.written_out(x, True).detach()
    zeros = y[0, 0, :, 2]
    assert bool((zeros == 0).all())
    assert bool(torch.signbit(zeros[::3]).all())
    assert not bool(torch.signbit(zeros[1::3]).any())
    got = fused(x, g, bn)
    ref = chain(x, g, clone_bn(bn, "eval"))
    for a, b in zip(got[:4], ref[:4]):
        assert same_but_nan(a, b)
    m, w = B.apply_max_plain(x.reshape(-1, 64, c), bn.running_mean,
                             bn.running_var, bn.weight.detach(),
                             bn.bias.detach(), EPS, False)
    m, w = m.view(2, 5, c), w.view(2, 5, c)
    # a NaN: m NaN, no winner, amax's gradient NaN at every row (K13f's
    # too), and dx NaN where the ReLU passed it: at the NaN
    assert bool(m[0, 1, 3].isnan()) and int(w[0, 1, 3]) == 0
    assert bool(ref[5][0, 1, :, 3].isnan().all())
    assert same(B.max_backward_plain(g.reshape(-1, c), w.reshape(-1, c),
                                     64), ref[5].reshape(-1, 64, c))
    assert torch.equal(got[1][0, 1, :, 3].isnan(),
                       torch.arange(64) == 7)
    # negative everywhere, and -0.0 beside +0.0: every row wins
    assert (m[:, :, 1] == 0).all() and (w[:, :, 1] == -1).all()
    assert float(m[0, 0, 2]) == 0.0 and int(w[0, 0, 2]) == -1
    # the emulated loop gives the same words, and m up to the sign of 0
    em, ew = emulate(y.reshape(-1, 64, c).double().numpy())
    np.testing.assert_array_equal(ew.view(np.int64),
                                  w.reshape(-1, c).numpy())
    np.testing.assert_array_equal(em, m.reshape(-1, c).double().numpy())


@pytest.mark.parametrize("k", [1, 17, 64])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_words_and_popcount_emulated(dtype, k):
    """The words of the plain twin are the kernel's loop's, and K13f's
    value is ``cast(g / popcount) * bit`` in x's dtype."""
    x, g, bn = inputs((3, 4, k, 9), dtype, 30 + k)
    bn.eval()
    x3 = x.reshape(-1, k, 9)
    m, w = B.apply_max_plain(x3, bn.running_mean, bn.running_var,
                             bn.weight.detach(), bn.bias.detach(), EPS, False)
    y = B.apply_plain(x3.reshape(-1, 9), bn.running_mean, bn.running_var,
                      bn.weight.detach(), bn.bias.detach(), EPS, False, True)
    em, ew = emulate(y.reshape(-1, k, 9).double().numpy())
    np.testing.assert_array_equal(ew.view(np.int64), w.numpy())
    np.testing.assert_array_equal(em, m.double().numpy())
    words = ew
    count = np.array([[bin(int(v)).count("1") for v in r] for r in words])
    gm = g.reshape(-1, 9)
    q = (gm.float() / torch.tensor(count, dtype=torch.float32)).to(dtype)
    bit = torch.tensor(np.stack([(words >> np.uint64(i)) & np.uint64(1)
                                 for i in range(k)], 1).astype(np.float32))
    want = (q.float()[:, None] * bit).to(dtype)
    assert same(B.max_backward_plain(gm, w, k), want)


def test_more_than_64_neighbours_raise():
    x, g, bn = inputs((1, 2, 65, 8), torch.float32, 1, pad=False)
    mean, var = bn.running_mean, bn.running_var
    args = (mean, var, bn.weight.detach(), bn.bias.detach(), EPS, False)
    with pytest.raises(ValueError):
        B.apply_max_plain(x.reshape(-1, 65, 8), *args)
    with pytest.raises(ValueError):
        B.apply_max(x.reshape(-1, 65, 8), *args)
    with pytest.raises(ValueError):
        B.max_backward_plain(g.reshape(-1, 8), torch.zeros(2, 8,
                                                         dtype=torch.int64),
                             65)
    with pytest.raises(ValueError):
        B.batch_norm_max(x, bn.weight, bn.bias, mean, var, False, True, 0.1,
                         EPS)
    with pytest.raises(ValueError):
        bn.relu_max(x, 1)           # not the axis before the channels
    with pytest.raises(ValueError):
        layers.ConvBN(8, 8, relu=False)(x, max_over=2)
