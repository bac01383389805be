"""BatchNorm + ReLU, and BatchNorm + ReLU + the set-abstraction max over
neighbours: K13a-f behind ``ops/batch_norm.batch_norm`` and
``batch_norm_max``.  Memory-bound, so the bound is the bytes: forward, the
activation read once and the output written once (the max's output is
[G, C], with a 64-bit winners word a channel where a gradient is taken);
backward, the output's gradient and the activation read once and the
input's gradient written once (the max: its [G, C] gradient and the words
read).  Operations: about 5 an element forward (statistics where trained,
normalise, ReLU), 8 backward."""

import torch

TARGETS = [("regnet_for_3d_grasping_torch.ops.batch_norm", "batch_norm"),
           ("regnet_for_3d_grasping_torch.ops.batch_norm", "batch_norm_max")]


def cost(args, kwargs, out):
    x = args[0]
    es = x.element_size()
    n = x.numel()
    # a backward follows where autograd records the call (under
    # `inference_mode` the parameters still require a gradient)
    grad = torch.is_grad_enabled() and (x.requires_grad
                                        or args[1].requires_grad)
    dtype = "bfloat16" if es == 2 else "float32"
    out_n = out.numel()
    if out_n == n:                  # batch_norm: y like x
        fwd = (2 * n * es, 5 * n, dtype)
        bwd = (3 * n * es, 8 * n, dtype)
    else:                           # batch_norm_max: m [G, C]
        words = 8 * out_n if grad else 0
        fwd = (n * es + out_n * es + words, 5 * n, dtype)
        bwd = (out_n * es + 8 * out_n + 2 * n * es, 8 * n, dtype)
    return [fwd, bwd] if grad else [fwd]
