"""JAX weights to a PyTorch state_dict and back (JAX
``utils/checkpoint.py:84-109``).

The npz files under ``weights/`` hold flax variables under '/'-joined
paths (``params/...`` and ``batch_stats/...``) plus ``__epoch__``; the JAX
package's Orbax checkpoint directories hold them as nested dicts
(``utils/checkpoint.restore_orbax``).  The port's modules carry the same
names, so the mapping is per leaf:

  params/<path>/kernel        [in, out] -> <path>.weight [out, in]
  params/<path>/scale, bias             -> <path>.weight, <path>.bias
  batch_stats/<path>/mean, var          -> <path>.running_mean, running_var

Every array must be used exactly once and every state_dict entry filled.
`state_dict_to_jax` is the inverse, and `write_npz` writes the layout of the
JAX package's ``export_weights_npz``, so a model trained here loads there.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
         ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


def read_npz(path: str | os.PathLike) -> tuple[dict, int]:
    """-> ({'/'-joined key: array}, epoch)."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, int(arrays.pop("__epoch__"))


def jax_to_state_dict(arrays: dict) -> dict:
    """{'params/a/b/kernel': array, ...} (flat, or nested dicts as the JAX
    ``load_weights_npz`` and an Orbax restore return them; a leaf may be a
    bfloat16 tensor) -> {'a.b.weight': f32 tensor, ...}."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = node

    walk(arrays, "")
    out = {}
    for key, val in flat.items():
        coll, *path, leaf = key.split("/")
        name = _LEAF.get((coll, leaf))
        if name is None or not path:
            raise KeyError(f"unexpected weight array {key!r}")
        t = val.float().clone() if isinstance(val, torch.Tensor) else \
            torch.from_numpy(np.array(val, np.float32))
        if leaf == "kernel":
            t = t.T.contiguous()
        tkey = ".".join(path + [name])
        if tkey in out:
            raise KeyError(f"weight {tkey!r} given twice")
        out[tkey] = t
    return out


def load_into(model: nn.Module, weights) -> int | None:
    """Load an npz path, a JAX Orbax checkpoint (a tag directory, latest
    epoch, or one ``ckpt_N`` directory; its params and batch_stats) or JAX
    variable arrays into `model`; fail on any array left over or any
    parameter missing.  Returns the epoch when the file records one."""
    epoch = None
    if isinstance(weights, (str, os.PathLike)):
        weights, epoch = read_npz(weights)
    sd = jax_to_state_dict(weights)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise KeyError(f"weights do not match the model: missing {missing}, "
                       f"unused {unexpected}")
    return epoch
