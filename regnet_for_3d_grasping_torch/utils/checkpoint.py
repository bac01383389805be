"""Checkpoints with the JAX package's resume semantics (its
``utils/checkpoint.py``).

The port writes one file ``ckpt_{epoch}.pt`` per epoch under a tag
directory, holding the model's state_dict, the optimizer's state and the
epoch (``torch.save``).  It also reads the JAX package's Orbax checkpoint
directories ``ckpt_{epoch}/`` (`restore_orbax`, the counterpart of JAX's
``restore_checkpoint(base_dir, epoch, target=None)``) through its own
OCDBT, zarr and zstd readers (``utils/ocdbt.py``), so a TPU run's
checkpoint resumes or serves on the card without orbax.  The port writes
no Orbax directory: its weights cross back to the JAX package as npz
(``weights.write_npz``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional, Tuple

import torch

_PT = re.compile(r"ckpt_(\d+)\.pt")
_ORBAX = re.compile(r"ckpt_(\d+)")


def _path(base_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(base_dir), f"ckpt_{epoch}.pt")


def save_checkpoint(base_dir: str, epoch: int, model, optimizer=None) -> str:
    """`optimizer` is a `train.trainer.Optimizer` (or None to leave its
    state out)."""
    os.makedirs(base_dir, exist_ok=True)
    path = _path(base_dir, epoch)
    state = {"epoch": epoch, "model": model.state_dict()}
    if optimizer is not None:
        state["adam"] = optimizer.adam.state_dict()
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def _epochs(base_dir: str) -> Tuple[set, set]:
    """(epochs of ``ckpt_N.pt`` files, epochs of ``ckpt_N`` Orbax
    directories) under `base_dir`; an epoch in both raises."""
    pt, orbax = set(), set()
    for n in os.listdir(base_dir):
        if m := _PT.fullmatch(n):
            pt.add(int(m.group(1)))
        elif (m := _ORBAX.fullmatch(n)) and os.path.isdir(
                os.path.join(base_dir, n)):
            orbax.add(int(m.group(1)))
    both = pt & orbax
    if both:
        raise ValueError(f"{base_dir} holds epoch {min(both)} both as "
                         f"ckpt_{min(both)}.pt and as an Orbax directory "
                         f"ckpt_{min(both)}/")
    return pt, orbax


def latest_epoch(base_dir: str) -> Optional[int]:
    """The latest epoch under a tag directory, of the port's ``ckpt_N.pt``
    files and the JAX package's ``ckpt_N`` Orbax directories alike."""
    if not os.path.isdir(base_dir):
        return None
    pt, orbax = _epochs(base_dir)
    return max(pt | orbax) if pt or orbax else None


def _orbax_dir(path: str, epoch: Optional[int]) -> Tuple[str, int]:
    """A tag directory (latest epoch, or `epoch`) or one ``ckpt_N``
    directory -> (the ``ckpt_N`` directory, N)."""
    path = os.path.abspath(path.rstrip("/"))
    m = _ORBAX.fullmatch(os.path.basename(path))
    if m and os.path.exists(os.path.join(path, "_METADATA")):
        return path, int(m.group(1))
    if epoch is None:
        epoch = latest_epoch(path)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    return os.path.join(path, f"ckpt_{epoch}"), epoch


def is_orbax(path: str, epoch: Optional[int] = None) -> bool:
    """Whether `path` (a tag directory, latest epoch or `epoch`, or one
    checkpoint) names an Orbax directory rather than a ``ckpt_N.pt``."""
    if not os.path.isdir(path):
        return False
    if os.path.exists(os.path.join(path, "_METADATA")):
        return True
    if epoch is None:
        epoch = latest_epoch(path)
    return epoch is not None and epoch in _epochs(path)[1]


def restore_orbax(path: str, epoch: Optional[int] = None
                  ) -> Tuple[Any, int]:
    """Read a JAX package Orbax checkpoint: `path` is a tag directory
    (latest epoch, or `epoch`) or one ``ckpt_N`` directory.  Returns
    ``(tree, N + 1)`` as JAX's ``restore_checkpoint(target=None)`` does:
    the tree `_METADATA` describes, dicts for its mappings and lists for
    its sequences (optax's NamedTuples come back as both), ``None`` where
    it holds None (optax's masked placeholders), and numpy arrays at the
    leaves, except bfloat16 arrays, which numpy has no type for: those are
    ``torch.bfloat16`` CPU tensors with the same bits."""
    from regnet_for_3d_grasping_torch.utils import ocdbt

    ckpt_dir, epoch = _orbax_dir(path, epoch)
    meta_path = os.path.join(ckpt_dir, "_METADATA")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except OSError as e:
        raise FileNotFoundError(f"{ckpt_dir} is not an Orbax checkpoint "
                                f"(no _METADATA)") from e
    if meta.get("use_zarr3", False):
        raise ocdbt.OcdbtError(f"{ckpt_dir}: use_zarr3: true (this reader "
                               f"reads zarr v2)")
    if not meta.get("use_ocdbt", False):
        raise ocdbt.OcdbtError(f"{ckpt_dir}: use_ocdbt: "
                               f"{meta.get('use_ocdbt')!r} (this reader reads "
                               f"OCDBT checkpoints)")
    store = ocdbt.KvStore(ckpt_dir)
    tree: Any = None
    for name, leaf in meta["tree_metadata"].items():
        keys = leaf["key_metadata"]
        kind = leaf["value_metadata"]["value_type"]
        if kind == "None":
            value = None
        elif kind in ("jax.Array", "np.ndarray"):
            value = ocdbt.read_array(store, ".".join(k["key"] for k in keys))
        else:
            raise ocdbt.OcdbtError(f"{ckpt_dir}: leaf {name} has value_type "
                                   f"{kind!r} (this reader reads jax.Array, "
                                   f"np.ndarray and None)")
        tree = _insert(tree, keys, value, name)
    return tree, epoch + 1


def _insert(node, keys, value, name):
    """Put `value` at the path `keys` (key_type 2: a dict key, 1: a list
    index) under `node`; returns the node."""
    if not keys:
        return value
    kind, key = keys[0]["key_type"], keys[0]["key"]
    if kind == 2:
        node = {} if node is None else node
        if not isinstance(node, dict):
            raise ValueError(f"leaf {name}: a mapping key inside a sequence")
        node[key] = _insert(node.get(key), keys[1:], value, name)
    elif kind == 1:
        node = [] if node is None else node
        if not isinstance(node, list):
            raise ValueError(f"leaf {name}: a sequence index inside a mapping")
        i = int(key)
        node.extend([None] * (i + 1 - len(node)))
        node[i] = _insert(node[i], keys[1:], value, name)
    else:
        raise ValueError(f"leaf {name}: key_type {kind!r}")
    return node


def load_checkpoint(path: str, epoch: Optional[int] = None) -> dict:
    """`path` is a tag directory (latest epoch, or `epoch`), one
    ``ckpt_N.pt`` file or one Orbax ``ckpt_N`` directory.  Returns
    ``{"epoch", "model": state_dict}``, with ``"adam"`` (the optimizer's
    state_dict) from a ``.pt`` file and ``"jax"`` (the restored tree, whose
    ``opt_state`` `train.trainer.load_jax_opt_state` takes) from an Orbax
    directory; ``["epoch"] + 1`` is the epoch to resume at.  Only ``.pt``
    files this program wrote should be loaded: the optimizer state is
    unpickled."""
    if is_orbax(path, epoch):
        from regnet_for_3d_grasping_torch.weights import jax_to_state_dict
        tree, resume = restore_orbax(path, epoch)
        return {"epoch": resume - 1, "model": jax_to_state_dict(
            variables(tree)), "jax": tree}
    if os.path.isdir(path):
        if epoch is None:
            epoch = latest_epoch(path)
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints under {path}")
        path = _path(path, epoch)
    return torch.load(path, map_location="cpu", weights_only=False)


def variables(tree: dict) -> dict:
    """The ``{"params", "batch_stats"}`` of a restored TrainState (or of
    restored variables)."""
    return {"params": tree["params"], "batch_stats": tree.get("batch_stats",
                                                              {})}
