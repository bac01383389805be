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


def variable_path(key: str, ndim: int) -> tuple[str, str]:
    """A state_dict entry's JAX variable: 'a.b.weight' -> ('params',
    'a/b/kernel').  A ``weight`` is a dense kernel where it has two axes
    and a BatchNorm scale where it has one."""
    *path, name = key.split(".")
    if name == "weight":
        coll, leaf = "params", "kernel" if ndim == 2 else "scale"
    elif name == "bias":
        coll, leaf = "params", "bias"
    elif name in ("running_mean", "running_var"):
        coll, leaf = "batch_stats", name.removeprefix("running_")
    else:
        raise KeyError(f"unexpected state_dict entry {key!r}")
    return coll, "/".join([*path, leaf])


def nest(flat: dict) -> dict:
    """{'a/b/c': leaf, ...} -> {'a': {'b': {'c': leaf}}, ...}."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def state_dict_to_jax(state_dict: dict) -> dict:
    """{'a.b.weight': tensor, ...} -> {'params/a/b/kernel': array, ...}:
    the inverse of `jax_to_state_dict` (names by `variable_path`; kernels
    transposed back to [in, out]).  The arrays keep the tensors' dtype."""
    out = {}
    for key, t in state_dict.items():
        a = t.detach().cpu().numpy()
        coll, path = variable_path(key, a.ndim)
        out[f"{coll}/{path}"] = np.ascontiguousarray(
            a.T if a.ndim == 2 else a)
    return out


def write_npz(path: str | os.PathLike, model: nn.Module, epoch: int) -> None:
    """Write `model`'s weights as the JAX package's weight npz."""
    np.savez_compressed(path, __epoch__=np.asarray(epoch, np.int32),
                        **state_dict_to_jax(model.state_dict()))


def load_into(model: nn.Module, weights) -> int | None:
    """Load an npz path, a JAX Orbax checkpoint (a tag directory, latest
    epoch, or one ``ckpt_N`` directory; its params and batch_stats) or JAX
    variable arrays into `model`; fail on any array left over or any
    parameter missing.  Returns the epoch when the file records one."""
    epoch = None
    if isinstance(weights, (str, os.PathLike)) and os.path.isdir(weights):
        from regnet_for_3d_grasping_torch.utils import checkpoint
        tree, resume = checkpoint.restore_orbax(os.fspath(weights))
        weights, epoch = checkpoint.variables(tree), resume - 1
    elif isinstance(weights, (str, os.PathLike)):
        weights, epoch = read_npz(weights)
    sd = jax_to_state_dict(weights)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise KeyError(f"weights do not match the model: missing {missing}, "
                       f"unused {unexpected}")
    return epoch
