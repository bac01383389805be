"""Freezing parameters and BatchNorms by name pattern (JAX
``nn/freezer.py:30-92``, after the reference's ``nn/freezer.py``).

Patterns are regular expressions over the JAX package's names, matched
with ``re.search``: a parameter's '/'-joined path in the ``params``
collection (``score_net/backbone/sa0/mlp/layer0/dense/kernel``), a
module's path (``score_net/backbone/sa0/mlp/layer0``).  The port's
modules carry the same names, and `weights.variable_path` gives each
parameter its JAX leaf, so one pattern freezes the same parameters in
both packages.  No CLI calls these.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Sequence

import torch
from torch import nn

from regnet_for_3d_grasping_torch.nn.layers import ConvBN
from regnet_for_3d_grasping_torch.weights import variable_path


def _matcher(patterns: Sequence[str]):
    regs = [re.compile(p) for p in patterns]
    return lambda path: any(r.search(path) for r in regs)


def freeze_mask(model: nn.Module,
                patterns: Sequence[str]) -> Dict[str, bool]:
    """{parameter name: its JAX path matches a pattern} (JAX
    ``freeze_mask`` over the ``params`` tree)."""
    hit = _matcher(patterns)
    return {name: hit(variable_path(name, p.dim())[1])
            for name, p in model.named_parameters()}


def frozen_optimizer(optimizer: torch.optim.Optimizer, model: nn.Module,
                     patterns: Sequence[str]) -> torch.optim.Optimizer:
    """Takes the parameters matching `patterns` out of `optimizer`'s
    groups (before its first step) and out of autograd: they are never
    updated and hold no optimizer state, as JAX's
    ``optax.multi_transform`` with ``set_to_zero`` gives them zero updates
    and the inner optimizer never sees them.  Returns `optimizer`."""
    mask = freeze_mask(model, patterns)
    frozen = {id(p) for name, p in model.named_parameters() if mask[name]}
    if any(id(p) in frozen for p in optimizer.state):
        raise ValueError("freeze parameters before the optimizer's first "
                         "step")
    for group in optimizer.param_groups:
        group["params"] = [p for p in group["params"] if id(p) not in frozen]
    for name, p in model.named_parameters():
        if mask[name]:
            p.requires_grad_(False)
    return optimizer


@contextlib.contextmanager
def frozen_bn(model: nn.Module, patterns: Sequence[str]):
    """Within the block, every `ConvBN` of `model` whose module path
    matches a pattern normalizes with its running statistics and leaves
    them unchanged, in training mode too (JAX ``frozen_bn``: such a ConvBN
    is called with ``train=False``); every other module trains as
    before."""
    hit = _matcher(patterns)
    bns = [m.bn for name, m in model.named_modules()
           if isinstance(m, ConvBN) and hit(name.replace(".", "/"))]
    before = [bn.frozen for bn in bns]
    for bn in bns:
        bn.frozen = True
    try:
        yield
    finally:
        for bn, was in zip(bns, before):
            bn.frozen = was
