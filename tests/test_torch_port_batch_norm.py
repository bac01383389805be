"""BatchNorm + ReLU on the card, K13a-d (``ops/batch_norm``,
``csrc/batch_norm.cu``), on the CPU.

- The plain closed-form backward that K13c and K13d compute
  (`backward_reduce_plain`, `backward_apply_plain`) against autograd of the
  written-out `BatchNorm` / `ConvBN` chain: f64, f32 and bf16, train, eval
  and frozen, ReLU on and off, C = 1, 10 and 128, bit for bit (in bf16,
  the chain's two roundings of dx: bf16(bf16(direct) + bf16(statistics)));
  and against ``jax.vjp`` of the JAX package's flax ``ConvBN`` (a Dense of
  the identity, so that its input is BatchNorm's): f64 within 1e-10 (1e-6
  in eval mode, whose f32 running statistics take an f32 rsqrt, and for
  the f32 parameters' gradients), f32 within 1e-5, bf16 within 2^-6 of the
  largest entry (XLA's CPU rsqrt is an approximation and its sums take
  another order).
- A constant channel: where the clamp holds the variance at 0 the
  variance's gradient term is 0, and dx is the direct term less its mean.
- The autograd.Function behind the kernels (`batch_norm`, whose wrappers
  take the plain versions on the CPU) against the chain, and under
  `remat` the running buffers updated once.
- A numpy emulation of K13a's and K13c's block partials (f64, each thread
  in row order, a fixed tree in the block, the chunks in order in the last
  block) over `tile_grid`'s grid, against the f32 plain statistics and
  sums (stated tolerances) and the exact sums (2 ulps).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.nn.layers import ConvBN as JConvBN

from regnet_for_3d_grasping_torch.nn import layers
from regnet_for_3d_grasping_torch.nn.layers import BatchNorm
from regnet_for_3d_grasping_torch.ops import batch_norm as B
from test_torch_port_bucket_scan import cxx_constant

BF = torch.bfloat16
EPS = 1e-5


def inputs(shape, dtype, seed, const=None):
    """x and g of `shape` from numpy (x: each channel its own offset and
    scale; channel 0 held at `const` where given), and a BatchNorm with
    random parameters and running statistics."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randn(*shape) * (rng.rand(c) * 3 + 0.1) + rng.randn(c) * 2
    if const is not None:
        x[..., 0] = const
    g = rng.randn(*shape)
    bn = BatchNorm(c)
    with torch.no_grad():
        for p, v in ((bn.weight, rng.rand(c) + 0.5),
                     (bn.bias, rng.randn(c) * 0.3),
                     (bn.running_mean, rng.randn(c) * 0.3),
                     (bn.running_var, rng.rand(c) + 0.5)):
            p.copy_(torch.tensor(v))
    return (torch.tensor(x).to(dtype), torch.tensor(g).to(dtype), bn)


def set_mode(bn, mode):
    bn.train(mode != "eval")
    bn.frozen = mode == "frozen"
    return mode == "train"


def closed_form(x, g, bn, train, relu):
    """y, dx, dweight and dbias from the kernels' plain versions."""
    c = x.shape[-1]
    x2, g2 = x.reshape(-1, c), g.reshape(-1, c)
    if train:
        mean, var = B.stats_plain(x2)
    else:
        mean, var = bn.running_mean, bn.running_var
    args = (mean, var, bn.weight.detach(), bn.bias.detach(), EPS, train,
            relu)
    y = B.apply_plain(x2, *args)
    coef = B.backward_reduce_plain(g2, x2, *args)
    dx = B.backward_apply_plain(g2, x2, *args[:4], coef, *args[4:])
    return y.reshape(x.shape), dx.reshape(x.shape), coef


def chain(x, g, bn, relu):
    """The written-out chain (the module on a CPU tensor) with autograd."""
    xr = x.clone().requires_grad_()
    y = bn(xr, relu)
    y.backward(g)
    return y.detach(), xr.grad, bn.weight.grad, bn.bias.grad


def bits(t):
    view = {torch.float64: torch.int64, torch.float32: torch.int32,
            torch.bfloat16: torch.int16}[t.dtype]
    return t.contiguous().view(view)


@pytest.mark.parametrize("c", [1, 10, 128])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("mode", ["train", "eval", "frozen"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, BF])
def test_closed_form_is_autograd_of_the_chain(dtype, mode, relu, c):
    """Bit for bit: y, dx (in bf16 the chain's two roundings), and dweight
    and dbias rounded to the parameters' f32."""
    x, g, bn = inputs((2, 12, 16, c), dtype, c + 7)
    train = set_mode(bn, mode)
    y, dx, coef = closed_form(x, g, bn, train, relu)
    y_ref, dx_ref, dw_ref, db_ref = chain(x, g, bn, relu)
    assert torch.equal(bits(y), bits(y_ref))
    assert dx.dtype == dx_ref.dtype == dtype
    assert torch.equal(bits(dx), bits(dx_ref))
    assert torch.equal(bits(coef[0].float()), bits(dw_ref))
    assert torch.equal(bits(coef[1].float()), bits(db_ref))
    if dtype == BF and train:
        # one rounding of the sum would differ from autograd's two
        c2 = x.shape[-1]
        x2, g2 = x.reshape(-1, c2), g.reshape(-1, c2)
        mean, var = B.stats_plain(x2)
        gz = B.passed(g2, x2, mean, var, bn.weight.detach(),
                      bn.bias.detach(), EPS, True, relu)
        direct = gz * B.multiplier(var, bn.weight.detach(), EPS, True)
        t = coef[3] * x2.float()
        once = (direct + ((t + t) + coef[2])).to(BF)
        twice = direct.to(BF) + ((t + t) + coef[2]).to(BF)
        assert torch.equal(bits(twice), bits(dx.reshape(-1, c2)))
        if c == 128:
            assert not torch.equal(bits(once), bits(twice))


def jax_convbn(x, g, bn, train, relu, dtype):
    """y and the VJP (dx, dscale, dbias) of the JAX package's flax ConvBN
    whose Dense is the identity, at `dtype` (f64 under x64)."""
    c = x.shape[-1]
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32,
           BF: jnp.bfloat16}[dtype]
    jm = JConvBN(c, relu=relu, dtype=None if dtype != BF else jdt)
    jx = jnp.asarray(x.float().numpy() if dtype != torch.float64
                     else x.numpy()).astype(jdt)
    variables = jm.init(jax.random.PRNGKey(0), jx)
    params = {"dense": {"kernel": jnp.eye(c, dtype=jnp.float32)},
              "bn": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                     "bias": jnp.asarray(bn.bias.detach().numpy())}}
    stats = {"bn": {"mean": jnp.asarray(bn.running_mean.numpy()),
                    "var": jnp.asarray(bn.running_var.numpy())}}
    assert jax.tree.structure(variables["params"]) == \
        jax.tree.structure(params)

    def f(x, p):
        out = jm.apply({"params": p, "batch_stats": stats}, x, train=train,
                       mutable=["batch_stats"] if train else False)
        return out[0] if train else out

    y, vjp = jax.vjp(f, jx, params)
    gx, gp = vjp(jnp.asarray(g.float().numpy() if dtype != torch.float64
                             else g.numpy()).astype(y.dtype))
    return [np.asarray(a, np.float64) for a in
            (y, gx, gp["bn"]["scale"], gp["bn"]["bias"])]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, BF])
def test_closed_form_matches_jax_vjp(dtype, mode, relu):
    x, g, bn = inputs((4, 64, 10), dtype, 3)
    train = set_mode(bn, mode)
    y, dx, coef = closed_form(x, g, bn, train, relu)
    with jax.enable_x64(dtype == torch.float64):
        ref = jax_convbn(x, g, bn, train, relu, dtype)
    tol = {torch.float64: 1e-10, torch.float32: 1e-5, BF: 2.0 ** -6}[dtype]
    if dtype == torch.float64 and not train:
        tol = 1e-6      # the f32 running statistics: an f32 rsqrt
    # dscale and dbias are f32 parameters' gradients on both sides
    for i, (got, want) in enumerate(zip((y, dx, coef[0], coef[1]), ref)):
        got = got.double().numpy()
        assert np.abs(got - want).max() <= max(
            tol, 1e-6 if i > 1 else 0.0) * np.abs(want).max()


@pytest.mark.parametrize("dtype,const", [(torch.float32, 0.1),
                                         (torch.float32, 0.75), (BF, 0.75)])
def test_constant_channel_variance_term_vanishes(dtype, const):
    """A constant channel: its statistics term through the variance is 0
    where the clamp held the variance at 0 (f32 0.1: E[x^2] - mean^2 < 0
    at this M) and where the variance is 0 exactly (0.75 over a power of 2
    rows: dmul = 0), so dx there is the direct term less its mean."""
    x, g, bn = inputs((4096, 8), dtype, 11, const=const)
    bn.train()
    _, dx, coef = closed_form(x, g, bn, True, False)
    assert torch.equal(bits(dx), bits(chain(x, g, bn, False)[1]))
    mean, var = B.stats_plain(x)
    if const == 0.1:
        assert float(var[0]) < 0.0
    assert float(coef[3, 0]) == 0.0
    mul = B.multiplier(var, bn.weight.detach(), EPS, True)[0]
    direct = g[:, 0].double() * float(mul)
    want = direct - direct.mean()
    assert np.allclose(dx[:, 0].double().numpy(), want.numpy(),
                       atol=1e-2 * float(direct.abs().max())
                       if dtype == BF else 1e-5 * float(direct.abs().max()))


@pytest.mark.parametrize("mode", ["train", "eval", "frozen"])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_function_behind_the_kernels_is_the_chain(dtype, mode):
    """`ops/batch_norm.batch_norm` (the autograd.Function the card runs,
    its wrappers on their plain versions here) equals the chain: output,
    gradients and running buffers, bit for bit."""
    x, g, bn = inputs((3, 40, 10), dtype, 5)
    train = set_mode(bn, mode)
    ref_bn = BatchNorm(10)
    ref_bn.load_state_dict(bn.state_dict())
    set_mode(ref_bn, mode)
    xr = x.clone().requires_grad_()
    y = B.batch_norm(xr, bn.weight, bn.bias, bn.running_mean,
                     bn.running_var, train, True, bn.momentum, EPS, True)
    y.backward(g)
    y_ref, dx_ref, dw_ref, db_ref = chain(x, g, ref_bn, True)
    for a, b in ((y, y_ref), (xr.grad, dx_ref), (bn.weight.grad, dw_ref),
                 (bn.bias.grad, db_ref), (bn.running_mean,
                                          ref_bn.running_mean),
                 (bn.running_var, ref_bn.running_var)):
        assert torch.equal(bits(a.detach()), bits(b))


def test_remat_updates_the_running_buffers_once():
    """Under `remat` the Function's forward runs twice (the recompute
    with `update` off): the running buffers move once, as without remat,
    and the gradients are the same."""
    torch.manual_seed(0)
    x, g, bn = inputs((2, 50, 16), torch.float32, 9)
    bn.train()
    runs = []
    for wrap in (False, True):
        b2 = BatchNorm(16).train()
        b2.load_state_dict(bn.state_dict())
        xr = x.clone().requires_grad_()

        def f(t, b2=b2):
            return B.batch_norm(t, b2.weight, b2.bias, b2.running_mean,
                                b2.running_var, True, not layers._recomputing,
                                b2.momentum, EPS, True) * 2.0

        y = layers.remat(f, xr) if wrap else f(xr)
        y.backward(g)
        runs.append((b2.running_mean.clone(), b2.running_var.clone(),
                     xr.grad, b2.weight.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert not torch.equal(runs[0][0], bn.running_mean)


# --- the reductions' block partials, emulated --------------------------------

THREADS = cxx_constant("batch_norm.cu", "kThreads")


def tree(acc):
    """`block_sum`: acc [rows_par, ...] added in the kernel's fixed tree
    (row r takes row r + half at each level); returns row 0's."""
    acc = acc.copy()
    n, half = acc.shape[0], 1
    while half < n:
        for r in range(0, n, 2 * half):
            if r + half < n:
                acc[r] = acc[r] + acc[r + half]
        half *= 2
    return acc[0]


def emulate_sums(terms, lanes, chunks):
    """K13's row reduction of `terms` [NS, M, C] (f64): for every block
    (a tile of lanes x vec channels, a chunk of rows), each of its
    256 / lanes threads sums its rows (r0 + t, step 256 / lanes) in order,
    the block adds them in its tree; the tile's last block sums the chunks'
    partials (thread t: chunks t, t + 256 / lanes, ... in order) and adds
    them in the tree.  Returns the [NS, C] sums."""
    ns, m, c = terms.shape
    rows_par = THREADS // lanes
    per = -(-m // chunks)
    partial = []
    for k in range(chunks):
        part = terms[:, k * per:min(m, (k + 1) * per)]
        n_it = -(-part.shape[1] // rows_par)
        pad = np.zeros((ns, n_it * rows_par, c))
        pad[:, :part.shape[1]] = part
        # thread t's rows in order: a sequential sum down each column
        per_thread = np.cumsum(pad.reshape(ns, n_it, rows_par, c), axis=1)
        partial.append(tree(np.moveaxis(per_thread[:, -1], 1, 0)))
    partial = np.stack(partial)                       # [chunks, NS, C]
    n_it = -(-chunks // rows_par)
    pad = np.zeros((n_it * rows_par, ns, c))
    pad[:chunks] = partial
    per_thread = np.cumsum(pad.reshape(n_it, rows_par, ns, c), axis=0)[-1]
    return tree(per_thread)


@pytest.mark.parametrize("m,c,dtype", [(25600, 1, torch.float32),
                                       (4000, 10, BF),
                                       (6000, 40, torch.float32),
                                       (3000, 256, BF),
                                       (768, 1024, torch.float32)])
def test_block_partials_match_the_plain_statistics(m, c, dtype):
    x, g, bn = inputs((m, c), dtype, m + c)
    vec = B.vec_width(c, dtype)
    lanes, tiles, chunks = B.tile_grid(m, c, vec)
    assert tiles * chunks <= B.MAX_BLOCKS and lanes * vec * tiles >= c
    assert -(-m // chunks) * chunks >= m
    xd = x.double().numpy()
    s, ss = emulate_sums(np.stack([xd, xd * xd]), lanes, chunks)
    mean = s / m
    stats = np.stack([mean, ss / m - mean * mean]).astype(np.float32)
    exact = np.array([[math.fsum(col) for col in xd.T],
                      [math.fsum(col) for col in (xd * xd).T]]) / m
    exact[1] -= exact[0] ** 2
    assert np.all(np.abs(stats - exact) <= 2.0 ** -22 * np.abs(exact)
                  + 1e-12 * (xd * xd).mean(0))
    plain = B.stats_plain(x).numpy()
    msq = (xd * xd).mean(0)
    assert np.all(np.abs(stats[0] - plain[0]) <= 1e-5 * np.sqrt(msq))
    assert np.all(np.abs(stats[1] - plain[1]) <= 1e-4 * msq)

    # K13c: the sums of g' and g' (x - mean) (the product in f32), then
    # the channel's finish in the kernel's f32 operations
    st = torch.tensor(stats)
    mean_t, var_t = st[0], st[1]
    w, b = bn.weight.detach(), bn.bias.detach()
    gz = B.passed(g, x, mean_t, var_t, w, b, EPS, True, True).float()
    prod = gz * (x.float() - mean_t)
    sg, sgx = emulate_sums(np.stack([gz.double().numpy(),
                                     prod.double().numpy()]), lanes, chunks)
    r = torch.rsqrt(var_t.clamp(min=0.0) + EPS)
    mul = r * w
    dmul = torch.tensor(sgx).float()
    dd = torch.where(var_t >= 0, (-0.5 * (dmul * w)) * ((r * r) * r), 0.0)
    u = -dd * mean_t
    dmean = ((-mul.double() * torch.tensor(sg)).float() + u) + u
    coef = torch.stack([dmul * r, torch.tensor(sg).float(), dmean / m,
                        dd / m])
    plain = B.backward_reduce_plain(g, x, mean_t, var_t, w, b, EPS, True,
                                    True)
    mag = gz.double().abs().sum(0), prod.double().abs().sum(0)
    assert bool(((coef[1] - plain[1]).abs() <= 1e-4 * mag[0]).all())
    assert bool(((coef[0] - plain[0]).abs() <= 1e-4 * mag[1] * r).all())
    dx = B.backward_apply_plain(g, x, mean_t, var_t, w, b, coef, EPS, True,
                                True)
    ref = B.backward_apply_plain(g, x, mean_t, var_t, w, b, plain, EPS,
                                 True, True)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    assert float((dx.double() - ref.double()).abs().max()) <= \
        tol * float(ref.double().abs().max())
