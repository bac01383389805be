"""The pools: max over gathered rows, K4 (``ops/pooling.gather_max``, as
``models/regnet`` calls it) and K9 (``ops/slab.gather_max_slab``), with the
first-winner backward where the features need a gradient.  The rows a call
reads depend on the data; counted here is what any call needs however few
rows it reads, and whichever slots of the index it reads: the pooled rows
written once; backward, the pooled gradient and the winners read once and
the features' gradient written once.  A lower bound of the bytes, so the
share is at most the true one."""

import torch

TARGETS = [("regnet_for_3d_grasping_torch.models.regnet", "gather_max"),
           ("regnet_for_3d_grasping_torch.ops.slab", "gather_max_slab")]


def cost(args, kwargs, out):
    feature = args[0]
    es = feature.element_size()
    B, N, C = feature.shape
    dtype = "bfloat16" if es == 2 else "float32"
    fwd = (out.numel() * es, out.numel(), dtype)
    if not (torch.is_grad_enabled() and feature.requires_grad):
        return [fwd]
    bwd = (out.numel() * es + out.numel() * 4 + B * N * C * es,
           out.numel(), dtype)
    return [fwd, bwd]
