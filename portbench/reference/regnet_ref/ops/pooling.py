"""Max over gathered rows (JAX ``ops/pooling.py``), with its gradient.

Every call goes to kernel K4 (``csrc/gather_max.cu``) on a CUDA tensor: a
max is a max, so the JAX package's Pallas/XLA split (which keeps the f32
refine pool on XLA, ``pooling.py:53-54``) changes no value.  The bucket
structure the TPU kernel needs is not needed by a direct gather, so there
is no `stride` argument.  The kernel reads only the slots `kept_slots`
keeps: slot 0 and every slot whose row differs from slot 0's (the bucket
fills of K12, K11 and K5 copy slot 0's row into every empty slot).

When `feature` needs a gradient the argmax form runs: it also gives the
winner `win[b, s, c]`, the source row of the lowest slot holding the
maximum, and the backward adds each ``g[b, s, c]`` to
``dfeature[b, win[b, s, c], c]`` (JAX ``pooling.py:265-299``).  That is not
the gradient of ``amax``, which splits a tie evenly.

bf16 features (a bf16 compute dtype; JAX dispatches its kernel's bf16 form,
``pooling.py:53``) take K4's bf16 forms, ``gather_max_bf16`` and, with a
gradient (bf16 training), ``gather_max_argmax_bf16``, which return bf16 bit
for bit as the plain max and argmax do.  The backward of a bf16 pool,
``gather_max_backward_bf16``, sums as the JAX package's bf16 scatter-add
does (``jnp.zeros(n*C, bf16).at[keys].add(g)``, ``pooling.py:295``): in s
order, each add rounded to bf16 (held against ``jax.vjp`` on the CPU).
On the card the backward writes every entry of dfeature once, each the
ordered sum of its contributions from +0.0 (``csrc/gather_max.cu``;
tests/test_torch_port_pool_backward.py emulates its two forms).
"""

from __future__ import annotations

import torch

from portbench.reference.regnet_ref.ops.grouping import group_points

DTYPES = (torch.float32, torch.bfloat16)


def kernel_name(base: str, dtype: torch.dtype) -> str:
    """The entry point of form `base` for `dtype` rows: ``base`` on f32,
    ``base_bf16`` on bf16."""
    return base if dtype == torch.float32 else base + "_bf16"


def gather_max(feature: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Kernel K4: feature [B, N, C] f32 or bf16, index [B, S, K] with
    values in [0, N) -> [B, S, C] = max_k feature[b, index[b, s, k], c], in
    `feature`'s dtype.  CPU tensors take the plain versions.
    Differentiable in `feature` by the first-winner rule."""
    if torch.is_grad_enabled() and feature.requires_grad:
        return _GatherMax.apply(feature, index)
    return gather_max_plain(feature, index)


def gather_max_argmax(feature: torch.Tensor, index: torch.Tensor):
    """K4's argmax form -> (pooled [B, S, C] in `feature`'s dtype, win
    [B, S, C] int32).  CPU tensors take `gather_max_argmax_plain`.  No
    gradient: `gather_max` is the differentiable entry."""
    return gather_max_argmax_plain(feature, index)


# the backward entry point's `parts`: its zero fill, its scatter alone
# (onto a dfeature that is zero), or the whole backward (the wrapper's)
BACKWARD_FILL, BACKWARD_SCATTER = 1, 2
BACKWARD_WHOLE = BACKWARD_FILL | BACKWARD_SCATTER
# rows (S) up to which the backward takes its short form (`kShortRows`),
# and the fewest rows a chunk of its offsets holds (f32 at 256 channels)
SHORT_ROWS, CHUNK_ROWS = 128, 128


def scatter_winner(g: torch.Tensor, win: torch.Tensor, n: int,
                   parts: int = BACKWARD_WHOLE) -> torch.Tensor:
    """The backward of K4 and K9: g [B, S, C] f32 or bf16, win [B, S, C]
    -> dfeature [B, n, C] in `g`'s dtype with ``dfeature[b, win[b, s, c], c]
    += g[b, s, c]``, summed in s order from +0.0 (deterministic; on bf16
    each sum rounded to bf16).  CPU tensors take `scatter_winner_plain`.
    On the card one entry point writes dfeature; `parts` runs a part of it
    alone, to time the parts apart: `BACKWARD_FILL` its zero fill,
    `BACKWARD_SCATTER` the scatter alone, onto uninitialised memory.
    Either returns what is no gradient."""
    return scatter_winner_plain(g, win, n)


class _GatherMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feature, index):
        pooled, win = gather_max_argmax(feature, index)
        ctx.save_for_backward(win)
        ctx.n = feature.shape[1]
        return pooled

    @staticmethod
    def backward(ctx, g):
        (win,) = ctx.saved_tensors
        return scatter_winner(g, win, ctx.n), None


def gather_max_plain(feature: torch.Tensor, index: torch.Tensor,
                     chunk: int = 512) -> torch.Tensor:
    """Plain PyTorch version of K4: gather, then amax over K."""
    return torch.cat([group_points(feature, i).amax(dim=2)
                      for i in torch.split(index, chunk, dim=1)], dim=1)


def gather_max_argmax_plain(feature: torch.Tensor, index: torch.Tensor,
                            chunk: int = 512):
    """Plain PyTorch version of K4's argmax form: gather, argmax over K
    (the first maximal slot), winner row = index at that slot."""
    pooled, win = [], []
    for i in torch.split(index, chunk, dim=1):
        g = group_points(feature, i)                     # [B, s, K, C]
        am = torch.argmax(g, dim=2, keepdim=True)        # [B, s, 1, C]
        pooled.append(torch.gather(g, 2, am)[:, :, 0])
        win.append(torch.gather(
            i.long()[..., None].expand(-1, -1, -1, g.shape[-1]), 2,
            am)[:, :, 0])
    return torch.cat(pooled, 1), torch.cat(win, 1).to(torch.int32)


def scatter_winner_plain(g: torch.Tensor, win: torch.Tensor,
                         n: int) -> torch.Tensor:
    """Plain PyTorch version of the backward.  f32: one ``index_add_``
    over the flattened keys ``win * C + c``.  bf16: row s at a time in s
    order, each sum taken in f32 and rounded to bf16, as the JAX package's
    bf16 scatter-add sums (``index_add_`` on bf16 would sum in another
    order and precision)."""
    B, S, C = g.shape
    if g.dtype == torch.bfloat16:
        df = torch.zeros(B, n, C, dtype=g.dtype, device=g.device)
        for s in range(S):
            # distinct (b, c) of one row s address distinct entries
            at = win[:, s:s + 1].long()                  # [B, 1, C]
            cur = torch.gather(df, 1, at)
            df.scatter_(1, at, (cur.float() + g[:, s:s + 1].float()).to(
                g.dtype))
        return df
    keys = win.long() * C + torch.arange(C, device=g.device)
    df = torch.zeros(B, n * C, dtype=g.dtype, device=g.device)
    for b in range(B):
        df[b].index_add_(0, keys[b].reshape(-1), g[b].reshape(-1))
    return df.reshape(B, n, C)
