"""Pointwise layers, channels-last (JAX ``nn/layers.py``).

`ConvBN` is a bias-free Linear on the trailing axis, a BatchNorm and an
optional ReLU.  The BatchNorm is flax's, written out, not
``torch.nn.BatchNorm1d``: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``
in that order; in training mode the statistics are taken over all leading
axes, the variance as ``max(0, E[x^2] - E[x]^2)``, and the running update
``running = 0.9 * running + 0.1 * batch`` takes that same biased variance
(torch would take the unbiased one).  It keeps the state_dict names of
``torch.nn.BatchNorm1d`` (without its batch counter), so `weights.py` maps
the JAX variables onto it one to one.  ``module.train()`` / ``.eval()`` is
the JAX package's ``train`` flag.

On the card a BatchNorm, with its ConvBN's ReLU, runs through kernels K13
(`ops/batch_norm.batch_norm`: statistics, normalisation + cast + ReLU, and
their backward); the written-out chain here is their plain version, which
the CPU runs.  Where a `SharedMLP`'s output is reduced by a max over the
neighbours (``forward(..., max_over=2)``, the set-abstraction layers), its
last BatchNorm + ReLU and the max run as one (`BatchNorm.relu_max`: K13e
and K13f on the card, the chain and ``amax`` on the CPU).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """``ModelConfig.compute_dtype`` -> the torch dtype."""
    if name not in DTYPES:
        raise ValueError(f"unknown compute dtype {name!r}: one of "
                         f"{sorted(DTYPES)}")
    return DTYPES[name]


def bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., I] @ w [O, I]^T in bf16, summed in f32, rounded once to
    bf16: cuBLAS on the card (with its reduced-precision reduction off,
    `runtime.resolve_device`); on the CPU the product of the bf16-rounded
    operands in f32, rounded once, which is what XLA's CPU dot gives for a
    bf16 flax ``Dense`` (torch's own CPU bf16 matmul differs from it by
    one ulp on a few entries)."""
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if x.is_cuda:
        return F.linear(x, w)
    return F.linear(x.float(), w.float()).to(torch.bfloat16)


# the control's precision of the matrix products' operands: None (the
# configuration's), "tf32" (the f32 operands rounded to TF32's 10-bit
# mantissa) or "fp8" (the operands rounded to float8 e4m3)
CONTROL = None


def round_operand(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to the `CONTROL` precision, in `t`'s dtype."""
    if CONTROL is None:
        return t
    if CONTROL == "fp8":
        return t.to(torch.float8_e4m3fn).to(t.dtype)
    if CONTROL == "tf32":
        bits = t.float().contiguous().view(torch.int32)
        bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32).to(t.dtype)
    raise ValueError(f"unknown control precision {CONTROL!r}")


class Dense(nn.Linear):
    """Bias-free ``nn.Linear`` at a compute dtype (flax ``Dense(dtype=)``):
    in bf16 the f32 kernel is rounded at use."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=False)
        self.compute = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute == torch.float32:
            return F.linear(round_operand(x), round_operand(self.weight))
        return bf16_matmul(round_operand(x.to(torch.bfloat16)),
                           round_operand(self.weight.to(torch.bfloat16)))


# > 0 while `remat` recomputes a forward.  A count for the process, not a
# thread-local: autograd runs the recompute on its own device thread while
# the caller's thread waits in `backward`
_recomputing = 0


@contextlib.contextmanager
def _recompute():
    global _recomputing
    _recomputing += 1
    try:
        yield
    finally:
        _recomputing -= 1


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept, where gradients are enabled (non-reentrant checkpoint; the RNG
    state is restored for the recompute).  `fn` must not draw from an
    explicit generator: none of the backbone's layers do."""
    if not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recompute()))


def batch_statistics(x: torch.Tensor):
    """Train-mode BatchNorm statistics of `x` over all but the trailing
    axis, in at least f32 (flax's ``_compute_stats`` with its fast
    variance): ``mean``, ``max(0, E[x^2] - mean^2)``."""
    axes = tuple(range(x.dim() - 1))
    if not x.is_cuda:
        # the port's plain version, which its CPU path runs
        xf = x.float() if x.dtype == torch.bfloat16 else x
        mean = xf.mean(axes)
        return mean, ((xf * xf).mean(axes) - mean * mean).clamp(min=0.0)
    # on the card in f64, as the port's statistics kernel sums
    xd = x.double()
    mean = xd.mean(axes)
    var = (xd * xd).mean(axes) - mean * mean
    return mean.float(), var.float().clamp(min=0.0)


class BatchNorm(nn.Module):
    """Batch normalization over the trailing axis, flax semantics;
    `momentum` in the torch convention (the weight of the new batch).
    `frozen` (set by `nn.freezer.frozen_bn`) runs it on its running
    statistics, unchanged, in training mode too."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.frozen = False

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        """Normalises in at least f32 and returns `x`'s dtype (flax's
        ``force_float32_reductions``), then applies a ReLU where `relu`.
        A CUDA tensor goes through K13, a CPU tensor through
        `written_out`."""
        return self.written_out(x, relu)

    def relu_max(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``forward(x, relu=True).amax(dim)``, `dim` the neighbours' axis
        (the one before the channels): on a CUDA tensor K13a (train mode)
        and K13e, differentiable through K13f, K13c and K13d
        (`ops/batch_norm.batch_norm_max`, K <= 64); on a CPU tensor the
        written-out chain and ``amax``."""
        if x.dim() < 2 or dim % x.dim() != x.dim() - 2:
            raise ValueError(f"relu_max: the max runs over the axis before "
                             f"the channels, not {dim} of {x.dim()}")
        return self.written_out(x, True).amax(dim)

    def written_out(self, x: torch.Tensor, relu: bool = False
                    ) -> torch.Tensor:
        """The plain version, flax's BatchNorm op by op (and a ReLU), on
        any device."""
        if self.training and not self.frozen:
            mean, var = batch_statistics(x)
            if not _recomputing:     # `remat`'s backward: updated once
                with torch.no_grad():
                    # flax's factors: its momentum 1 - 0.1, and 1 - that
                    keep = 1.0 - self.momentum
                    self.running_mean.mul_(keep).add_(mean,
                                                      alpha=1.0 - keep)
                    self.running_var.mul_(keep).add_(var, alpha=1.0 - keep)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = ((x - mean) * mul + self.bias).to(x.dtype)
        return torch.relu(y) if relu else y


class ConvBN(nn.Module):
    """Pointwise dense layer + BatchNorm + optional ReLU, at compute dtype
    `dtype`."""

    def __init__(self, in_channels: int, out_channels: int,
                 relu: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(in_channels, out_channels, dtype)
        self.bn = BatchNorm(out_channels)
        self.relu = relu

    def forward(self, x: torch.Tensor,
                max_over: int | None = None) -> torch.Tensor:
        """`max_over`: the output's max over that axis (the one before the
        channels), BatchNorm, ReLU and max in one (`BatchNorm.relu_max`)."""
        if max_over is None:
            return self.bn(self.dense(x), self.relu)
        if not self.relu:
            raise ValueError("ConvBN: the fused max follows a ReLU")
        return self.bn.relu_max(self.dense(x), max_over)


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with an explicit generator (on `x`'s device): each
    value is kept with probability 1 - p and divided by 1 - p.  The mask
    is drawn in f32 whatever `x`'s dtype, so one generator gives one mask
    in f32 and in bf16 (flax's Bernoulli mask does not depend on the
    dtype either), and 1 - p is rounded to `x`'s dtype first, as JAX
    rounds a Python float beside a bf16 array."""
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) >= p
    keep_prob = float(torch.tensor(1.0 - p, dtype=x.dtype))
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class SharedMLP(nn.Module):
    """Stack of ConvBN blocks named layer0, layer1, ..., with dropout
    after every block in training mode when ``dropout_prob > 0``."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 dropout_prob: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_prob = dropout_prob
        for i, ch in enumerate(channels):
            self.add_module(f"layer{i}", ConvBN(in_channels, ch,
                                                dtype=dtype))
            in_channels = ch

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                max_over: int | None = None) -> torch.Tensor:
        """`generator` (on `x`'s device) draws the dropout masks; it is
        required in training mode when ``dropout_prob > 0``.  `max_over`:
        the output's max over that axis (the neighbours', before the
        channels), taken inside the last layer where no dropout follows
        it."""
        drop = self.training and self.dropout_prob > 0.0
        if drop and generator is None:
            raise ValueError("SharedMLP: dropout in training mode needs a "
                             "torch.Generator")
        layers = list(self.children())
        for i, layer in enumerate(layers):
            if max_over is not None and not drop and i == len(layers) - 1:
                return layer(x, max_over=max_over)
            x = layer(x)
            if drop:
                x = dropout(x, self.dropout_prob, generator)
        return x if max_over is None else x.amax(max_over)
