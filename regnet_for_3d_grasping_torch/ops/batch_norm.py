"""BatchNorm (+ ReLU + cast) on the card: K13a-d (``csrc/batch_norm.cu``).

The JAX package leaves ``Dense -> BatchNorm -> relu`` to flax and XLA
(JAX ``nn/layers.py:37-45``), which fuses the statistics into one reduction
and the normalisation, cast and ReLU into one elementwise pass, forward and
backward.  `nn/layers.BatchNorm` writes flax's BatchNorm out op by op; that
written-out chain is the plain version, which the CPU runs.  On the card
every BatchNorm runs `batch_norm`, four kernels:

  K13a bn_stats            per channel: mean and E[x^2] - mean^2 (summed in
                           f64, rounded once to f32), and the running update
  K13b bn_apply            act(cast((x - mean) * mul + bias)),
                           mul = rsqrt(var + eps) * weight
  K13c bn_backward_reduce  per channel: sum g' and sum g' * (x - mean), with
                           g' = g where the ReLU passed; finishes dweight,
                           dbias and the statistics term's coefficients
  K13d bn_backward_apply   dx

a training forward launching K13a and K13b, an eval or frozen one K13b
alone, a backward K13c and K13d.  x is the Dense output, [..., C]
channels-last, f32 or bf16; statistics, parameters and running buffers
are f32.

Where the set-abstraction layers take the max over neighbours of the
last ConvBN (JAX ``models/backbone.py:89-91``, ``jnp.max(h, axis=2)``),
`batch_norm_max` runs two kernels more in place of K13b and ``amax``:

  K13e bn_apply_max     x [G, K, C] -> m [G, C] = max over k of K13b's
                        value, and the winners word [G, C] (int64 bits:
                        bit k where row k equals the max)
  K13f bn_max_backward  g [G, K, C] from the gradient of m and the words,
                        amax's backward ``(g_m / count) * mask``

so the [G, K, C] activation is neither written nor kept for the
backward, whose g then feeds K13c and K13d.  K <= 64.

The backward is autograd's of the written-out chain in closed form
(`backward_reduce_plain`, `backward_apply_plain`: the same f32 operations
in autograd's order, so on the CPU they equal autograd of the chain, bf16
bit for bit): with r = rsqrt(var + eps), mul = r * w, g' the gradient
through the ReLU (and the cast) in f32,

  dbias = sum g',  dweight = sum g' (x - mean) * r,  and dx = g' * mul
  (+, in train mode, B * x + B * x + A, with dd = (-0.5 * dmul * w) * r^3
  where var >= 0 before the clamp (else 0), dmean = -sum g' mul + u + u,
  u = -dd * mean, A = dmean / M, B = dd / M).

On bf16 x autograd casts the gradients of ``x - mean`` and of the
statistics' ``x.float()`` to bf16 apart and adds them in bf16, so dx is
bf16(bf16(g' * mul) + bf16(B x + B x + A)); in f32 x's four uses add up
in f32 in the order autograd accumulates them.
"""

from __future__ import annotations

import math

import torch

from regnet_for_3d_grasping_torch.ops import _cuda

DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256            # `kThreads`
MAX_CHANNELS = 2048      # the widest x; the reductions' tickets, one a tile
MAX_NEIGHBOURS = 64      # `kMaxNeighbours`: the bits of a winners word
# a row reduction's blocks (its grid follows from M and C alone, so its
# sums are the same bits on every card)
MAX_BLOCKS = 1024
ROWS_PER_THREAD = 8      # the fewest rows a thread of a reduction sums
BLOCKS_PER_SM = 8        # the elementwise passes' grid: 8 x 256 threads an SM

_tickets: dict = {}


def vec_width(c: int, dtype: torch.dtype, *tensors: torch.Tensor) -> int:
    """Values a thread loads at once: 16 bytes where C allows (f32 4, bf16
    8), on bf16 8 bytes (4) where C is a multiple of 4, else 1; 1 also
    where a tensor's data does not start on that many bytes."""
    if dtype == torch.bfloat16:
        vec = 8 if c % 8 == 0 else 4 if c % 4 == 0 else 1
    else:
        vec = 4 if c % 4 == 0 else 1
    size = vec * (2 if dtype == torch.bfloat16 else 4)
    return vec if all(t.data_ptr() % size == 0 for t in tensors) else 1


def tile_grid(m: int, c: int, vec: int) -> tuple:
    """A row reduction's grid (K13a, K13c) -> (lanes, tiles, chunks): a
    block covers `lanes` x vec channels (128 bytes of a row where C allows;
    32 channels of single loads else, C = 1, 2 and 10 whole) and one of
    `chunks` runs of rows, 256 / lanes rows at a time."""
    nvec = c // vec
    lanes = min(nvec, 8 if vec > 1 else 32)
    tiles = -(-nvec // lanes)
    rows_par = THREADS // lanes
    chunks = max(1, min(-(-m // (rows_par * ROWS_PER_THREAD)),
                        MAX_BLOCKS // tiles))
    return lanes, tiles, chunks


def apply_blocks(m: int, c: int, vec: int, device: torch.device) -> int:
    """The elementwise passes' grid (K13b, K13d): a thread per vec values,
    at most `BLOCKS_PER_SM` blocks an SM (a grid-stride loop), rounded up
    to a multiple of C / gcd(C, 256 vec), so that the stride is a multiple
    of C and a thread keeps its channels."""
    need = -(-(m * c // vec) // THREADS)
    unit = c // math.gcd(c, THREADS * vec)
    blocks = max(1, min(need, BLOCKS_PER_SM * _cuda.sm_count(device)))
    return -(-blocks // unit) * unit


def _ticket(device: torch.device) -> torch.Tensor:
    """The reductions' per-tile tickets on `device` (uint32, made at 0; the
    last block of a tile sets its ticket back to 0)."""
    key = _cuda.device_index(device)
    if key not in _tickets:
        with torch.inference_mode(False):
            _tickets[key] = torch.zeros(MAX_CHANNELS, dtype=torch.int32,
                                        device=torch.device("cuda", key))
    return _tickets[key]


def _check(x: torch.Tensor, *params: torch.Tensor) -> tuple:
    if x.dtype not in DTYPES:
        raise ValueError(f"batch_norm: x must be f32 or bf16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("batch_norm: x must be a contiguous [M, C]")
    m, c = x.shape
    if not 0 < c <= MAX_CHANNELS or m == 0:
        raise ValueError(f"batch_norm: [M, C] = {tuple(x.shape)}: needs M "
                         f"> 0 and 0 < C <= {MAX_CHANNELS}")
    for p in params:
        _cuda.check(p, "batch_norm parameter", torch.float32, (c,))
    return m, c


# --- K13a ------------------------------------------------------------------

def stats_plain(x: torch.Tensor) -> torch.Tensor:
    """K13a's plain version: x [M, C] -> [2, C] f32, the mean and the
    variance before the clamp, E[x^2] - mean^2, in at least f32 (the
    formula of `nn/layers.batch_statistics`)."""
    xf = x.float() if x.dtype == torch.bfloat16 else x
    mean = xf.mean(0)
    return torch.stack([mean, (xf * xf).mean(0) - mean * mean])


def stats(x: torch.Tensor, running_mean: torch.Tensor | None = None,
          running_var: torch.Tensor | None = None,
          momentum: float = 0.1) -> torch.Tensor:
    """Kernel K13a: x [M, C] f32 or bf16 -> [2, C] f32, the mean and the
    variance before the clamp, from f64 sums rounded once.  With the
    running buffers, also ``running = (1 - momentum) * running + momentum
    * batch`` in place (the variance clamped at 0).  CPU tensors take the
    plain version."""
    keep = 1.0 - momentum
    if x.device.type == "cpu":
        out = stats_plain(x)
        if running_mean is not None:
            running_mean.mul_(keep).add_(out[0], alpha=1.0 - keep)
            running_var.mul_(keep).add_(out[1].clamp(min=0.0),
                                        alpha=1.0 - keep)
        return out
    update = running_mean is not None
    m, c = _check(x, *((running_mean, running_var) if update else ()))
    vec = vec_width(c, x.dtype, x)
    lanes, _, chunks = tile_grid(m, c, vec)
    out = torch.empty(2, c, dtype=torch.float32, device=x.device)
    partial = torch.empty(chunks * 2 * c, dtype=torch.float64,
                          device=x.device)
    _cuda.launch("bn_stats", x.device, x, out,
                 running_mean if update else None,
                 running_var if update else None, partial,
                 _ticket(x.device), m, c, vec, lanes, chunks, int(update),
                 keep, 1.0 - keep, int(x.dtype == torch.bfloat16))
    return out


# --- K13b ------------------------------------------------------------------

def multiplier(var: torch.Tensor, weight: torch.Tensor, eps: float,
               train: bool) -> torch.Tensor:
    """rsqrt(var + eps) * weight, var clamped at 0 in train mode."""
    return torch.rsqrt((var.clamp(min=0.0) if train else var) + eps) * weight


def apply_plain(x, mean, var, weight, bias, eps: float, train: bool,
                relu: bool) -> torch.Tensor:
    """K13b's plain version: `nn/layers.BatchNorm`'s normalisation in its
    order, and `ConvBN`'s ReLU."""
    mul = multiplier(var, weight, eps, train)
    y = ((x - mean) * mul + bias).to(x.dtype)
    return torch.relu(y) if relu else y


def apply(x, mean, var, weight, bias, eps: float, train: bool,
          relu: bool) -> torch.Tensor:
    """Kernel K13b: x [M, C] -> act(cast((x - mean) * mul + bias)) in x's
    dtype; `train`: var is the batch's before the clamp (K13a's), else the
    running one.  CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return apply_plain(x, mean, var, weight, bias, eps, train, relu)
    m, c = _check(x, mean, var, weight, bias)
    y = torch.empty_like(x)
    vec = vec_width(c, x.dtype, x, y)
    _cuda.launch("bn_apply", x.device, x, y, mean, var, weight, bias, m, c,
                 vec, apply_blocks(m, c, vec, x.device), int(train),
                 int(relu), eps, int(x.dtype == torch.bfloat16))
    return y


# --- K13c ------------------------------------------------------------------

def passed(g, x, mean, var, weight, bias, eps: float, train: bool,
           relu: bool) -> torch.Tensor:
    """g' in f32: g where the ReLU passed (its output, recomputed from x,
    above 0: torch's threshold_backward), else 0."""
    if relu:
        y = apply_plain(x, mean, var, weight, bias, eps, train, True)
        g = torch.where(y <= 0, torch.zeros((), dtype=g.dtype,
                                            device=g.device), g)
    return g.float() if g.dtype == torch.bfloat16 else g


def backward_reduce_plain(g, x, mean, var, weight, bias, eps: float,
                          train: bool, relu: bool) -> torch.Tensor:
    """K13c's plain version -> [4, C]: dweight, dbias, and in train mode A
    and B (else 0), from torch's sums and autograd's f32 operations on the
    written-out chain."""
    gz = passed(g, x, mean, var, weight, bias, eps, train, relu)
    xf = x.float() if x.dtype == torch.bfloat16 else x
    r = torch.rsqrt((var.clamp(min=0.0) if train else var) + eps)
    mul = r * weight
    dbias = gz.sum(0)
    # autograd rounds the multiplier's gradient to its dtype (f32 where
    # running statistics meet an f64 x)
    dmul = (gz * (xf - mean)).sum(0).to(mul.dtype)
    dweight = dmul * r
    if not train:
        zero = torch.zeros_like(dbias)
        return torch.stack([dweight, dbias, zero, zero])
    m = x.shape[0]
    dmean = (-(gz * mul)).sum(0)
    dd = torch.where(var >= 0, (-0.5 * (dmul * weight)) * r.pow(3), 0.0)
    u = -dd * mean
    dmean = (dmean + u) + u
    return torch.stack([dweight, dbias, dmean / m, dd / m])


def backward_reduce(g, x, mean, var, weight, bias, eps: float, train: bool,
                    relu: bool) -> torch.Tensor:
    """Kernel K13c: g, x [M, C] -> [4, C] f32 (dweight, dbias, A, B), the
    sums in f64, rounded once.  CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return backward_reduce_plain(g, x, mean, var, weight, bias, eps,
                                     train, relu)
    m, c = _check(x, mean, var, weight, bias)
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError("batch_norm backward: g must be a contiguous "
                         "tensor of x's shape and dtype")
    vec = vec_width(c, x.dtype, x, g)
    lanes, _, chunks = tile_grid(m, c, vec)
    out = torch.empty(4, c, dtype=torch.float32, device=x.device)
    partial = torch.empty(chunks * 2 * c, dtype=torch.float64,
                          device=x.device)
    _cuda.launch("bn_backward_reduce", x.device, g, x, mean, var, weight,
                 bias, out, partial, _ticket(x.device), m, c, vec, lanes,
                 chunks, int(train), int(relu), eps,
                 int(x.dtype == torch.bfloat16))
    return out


# --- K13d ------------------------------------------------------------------

def backward_apply_plain(g, x, mean, var, weight, bias, coef, eps: float,
                         train: bool, relu: bool) -> torch.Tensor:
    """K13d's plain version: dx in x's dtype from g' * mul and, in train
    mode, the statistics term B * x + B * x + A (`coef` from K13c), added
    as autograd adds them."""
    gz = passed(g, x, mean, var, weight, bias, eps, train, relu)
    direct = gz * multiplier(var, weight, eps, train)
    if not train:
        return direct.to(x.dtype)
    xf = x.float() if x.dtype == torch.bfloat16 else x
    t = coef[3] * xf
    if x.dtype == torch.bfloat16:
        return direct.to(x.dtype) + ((t + t) + coef[2]).to(x.dtype)
    return ((direct + t) + t) + coef[2]


def backward_apply(g, x, mean, var, weight, bias, coef, eps: float,
                   train: bool, relu: bool) -> torch.Tensor:
    """Kernel K13d: dx [M, C] in x's dtype.  CPU tensors take the plain
    version."""
    if x.device.type == "cpu":
        return backward_apply_plain(g, x, mean, var, weight, bias, coef, eps,
                                    train, relu)
    m, c = _check(x, mean, var, weight, bias)
    _cuda.check(coef, "batch_norm coefficients", torch.float32, (4, c))
    dx = torch.empty_like(x)
    vec = vec_width(c, x.dtype, x, g, dx)
    _cuda.launch("bn_backward_apply", x.device, g, x, dx, mean, var, weight,
                 bias, coef, m, c, vec, apply_blocks(m, c, vec, x.device),
                 int(train), int(relu), eps, int(x.dtype == torch.bfloat16))
    return dx


# --- K13e ------------------------------------------------------------------

def _check_neighbours(k: int) -> None:
    if not 0 < k <= MAX_NEIGHBOURS:
        raise ValueError(f"batch_norm max: K = {k} neighbours, needs 0 < K "
                         f"<= {MAX_NEIGHBOURS} (a winners word holds "
                         f"{MAX_NEIGHBOURS} rows)")


def _check_groups(x: torch.Tensor) -> tuple:
    if x.dim() != 3:
        raise ValueError(f"batch_norm max: x must be [G, K, C], got "
                         f"{tuple(x.shape)}")
    _check_neighbours(x.shape[1])
    return tuple(x.shape)


def winners_plain(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The winners words of y [G, K, C] and its max m [G, C]: int64 [G, C],
    bit k set where ``y[:, k] == m`` (torch's equality: -0.0 equals +0.0,
    a NaN nothing).  The bits are distinct powers of two, so their int64
    sum (bit 63 the sign) is their OR."""
    k = y.shape[1]
    bit = torch.ones((), dtype=torch.int64, device=y.device) << torch.arange(
        k, device=y.device)
    return ((y == m[:, None]).long() * bit[:, None]).sum(1)


def apply_max_plain(x, mean, var, weight, bias, eps: float, train: bool,
                    winners: bool = True) -> tuple:
    """K13e's plain version: x [G, K, C] -> (m [G, C], the winners words or
    None): K13b's plain version with the ReLU, ``amax`` over K, and
    `winners_plain`."""
    g, k, c = _check_groups(x)
    y = apply_plain(x.reshape(g * k, c), mean, var, weight, bias, eps, train,
                    True).view(g, k, c)
    m = y.amax(1)
    return m, winners_plain(y, m) if winners else None


def apply_max(x, mean, var, weight, bias, eps: float, train: bool,
              winners: bool = True) -> tuple:
    """Kernel K13e: x [G, K, C] -> (m [G, C] in x's dtype, int64 winners
    words [G, C], or None where not `winners`: the kernel then writes m
    alone).  CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return apply_max_plain(x, mean, var, weight, bias, eps, train,
                               winners)
    groups, k, c = _check_groups(x)
    _check(x.view(groups * k, c), mean, var, weight, bias)
    m = torch.empty(groups, c, dtype=x.dtype, device=x.device)
    w = (torch.empty(groups, c, dtype=torch.int64, device=x.device)
         if winners else None)
    vec = vec_width(c, x.dtype, x, m)
    _cuda.launch("bn_apply_max", x.device, x, m, w, mean, var, weight, bias,
                 groups, k, c, vec, int(train), eps,
                 int(x.dtype == torch.bfloat16))
    return m, w


# --- K13f ------------------------------------------------------------------

def max_backward_plain(gm: torch.Tensor, w: torch.Tensor,
                       k: int) -> torch.Tensor:
    """K13f's plain version: gm [G, C], the words w [G, C] -> g [G, K, C]
    in gm's dtype, amax's backward (``(grad / mask.sum()) * mask``) on the
    mask the words hold."""
    _check_neighbours(k)
    mask = ((w[:, None] >> torch.arange(k, device=w.device)[:, None]) & 1
            ).bool()
    return (gm[:, None] / mask.sum(1, keepdim=True)) * mask


def max_backward(gm: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel K13f: gm [G, C] f32 or bf16, w [G, C] int64 -> g [G, K, C] in
    gm's dtype.  CPU tensors take the plain version."""
    if gm.device.type == "cpu":
        return max_backward_plain(gm, w, k)
    if gm.dtype not in DTYPES or gm.dim() != 2 or not gm.is_contiguous():
        raise ValueError("batch_norm max backward: g must be a contiguous "
                         "f32 or bf16 [G, C]")
    groups, c = gm.shape
    _check_neighbours(k)
    _cuda.check(w, "batch_norm max winners", torch.int64, (groups, c))
    g = torch.empty(groups, k, c, dtype=gm.dtype, device=gm.device)
    vec = vec_width(c, gm.dtype, gm, g)
    _cuda.launch("bn_max_backward", gm.device, gm, w, g, groups, k, c, vec,
                 int(gm.dtype == torch.bfloat16))
    return g


# --- the module's entry ----------------------------------------------------

def _statistics(x2, running_mean, running_var, train: bool, update: bool,
                momentum: float) -> tuple:
    """(mean, var): K13a's in train mode (and the running update where
    `update`), else the running buffers."""
    if not train:
        return running_mean, running_var
    st = stats(x2, running_mean if update else None,
               running_var if update else None, momentum)
    return st[0], st[1]


def _forward(x2, weight, bias, running_mean, running_var, train: bool,
             update: bool, momentum: float, eps: float, relu: bool):
    mean, var = _statistics(x2, running_mean, running_var, train, update,
                            momentum)
    return apply(x2, mean, var, weight, bias, eps, train, relu), mean, var


def _max_forward(x, weight, bias, running_mean, running_var, train: bool,
                 update: bool, momentum: float, eps: float, winners: bool):
    """x [..., K, C] -> (m [..., C], the words [G, C] or None, x as [M, C],
    mean, var)."""
    *lead, k, c = x.shape
    x3 = x.view(-1, k, c)
    mean, var = _statistics(x3.view(-1, c), running_mean, running_var, train,
                            update, momentum)
    m, w = apply_max(x3, mean, var, weight, bias, eps, train, winners)
    return m.view(*lead, c), w, x3.view(-1, c), mean, var


class _BatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, train,
                update, momentum, eps, relu):
        x2 = x.reshape(-1, x.shape[-1])
        y, mean, var = _forward(x2, weight, bias, running_mean, running_var,
                                train, update, momentum, eps, relu)
        ctx.save_for_backward(x2, mean, var, weight, bias)
        ctx.flags = (train, relu, eps, x.shape)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, gy):
        x2, mean, var, weight, bias = ctx.saved_tensors
        train, relu, eps, shape = ctx.flags
        g2 = gy.contiguous().view(x2.shape)
        coef = backward_reduce(g2, x2, mean, var, weight, bias, eps, train,
                               relu)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = backward_apply(g2, x2, mean, var, weight, bias, coef, eps,
                                train, relu).view(shape)
        return (dx, coef[0] if ctx.needs_input_grad[1] else None,
                coef[1] if ctx.needs_input_grad[2] else None,
                None, None, None, None, None, None, None)


class _BatchNormMax(torch.autograd.Function):
    """BatchNorm + ReLU and the max over the neighbours' axis: K13a (train
    mode) and K13e forward, saving x, the statistics, the parameters and
    the winners words (not the activation); K13f, K13c and K13d
    backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, train,
                update, momentum, eps):
        m, w, x2, mean, var = _max_forward(x, weight, bias, running_mean,
                                           running_var, train, update,
                                           momentum, eps, True)
        ctx.save_for_backward(x2, mean, var, weight, bias, w)
        ctx.flags = (train, eps, x.shape)
        return m

    @staticmethod
    def backward(ctx, gm):
        x2, mean, var, weight, bias, w = ctx.saved_tensors
        train, eps, shape = ctx.flags
        g2 = max_backward(gm.contiguous().view(w.shape), w,
                          shape[-2]).view(x2.shape)
        coef = backward_reduce(g2, x2, mean, var, weight, bias, eps, train,
                               True)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = backward_apply(g2, x2, mean, var, weight, bias, coef, eps,
                                train, True).view(shape)
        return (dx, coef[0] if ctx.needs_input_grad[1] else None,
                coef[1] if ctx.needs_input_grad[2] else None,
                None, None, None, None, None, None)


def batch_norm_max(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor,
                   train: bool, update: bool, momentum: float,
                   eps: float) -> torch.Tensor:
    """``batch_norm(x, ..., relu=True).amax(-2)`` of x [..., K, C] (K <= 64)
    -> [..., C] in x's dtype, through K13a and K13e on the card: the same
    bits, without the [..., K, C] activation.  Differentiable in x, weight
    and bias (K13f, then K13c and K13d; a tie's gradient split evenly, as
    ``amax``'s).  Without gradients K13e writes no winners words."""
    if x.dim() < 2:
        raise ValueError("batch_norm max: x must be [..., K, C]")
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _BatchNormMax.apply(x, weight, bias, running_mean,
                                   running_var, train, update, momentum, eps)
    return _max_forward(x, weight, bias, running_mean, running_var, train,
                        update, momentum, eps, False)[0]


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor,
               train: bool, update: bool, momentum: float, eps: float,
               relu: bool) -> torch.Tensor:
    """BatchNorm of x [..., C] over all but the trailing axis, then ReLU
    where `relu`, in x's dtype, through K13 on the card.  `train`: on the
    batch's statistics (and, where `update`, the running buffers updated
    in place), else on the running ones (eval, or `frozen`).
    Differentiable in x, weight and bias."""
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _BatchNorm.apply(x, weight, bias, running_mean, running_var,
                                train, update, momentum, eps, relu)
    return _forward(x.view(-1, x.shape[-1]), weight, bias, running_mean,
                    running_var, train, update, momentum, eps,
                    relu)[0].view(x.shape)
