"""Checkpoints with the JAX package's resume semantics (its
``utils/checkpoint.py``).

The port writes the JAX package's own checkpoint: one Orbax directory
``ckpt_{epoch}/`` per epoch under a tag directory (`save_checkpoint`), the
tree of JAX's ``TrainState._asdict()`` (params, batch_stats, optax's
opt_state, step), which JAX's ``restore_checkpoint`` reads with and without
``target`` as if JAX had written it.  It reads such directories back
(`restore_orbax`, the counterpart of JAX's ``restore_checkpoint(base_dir,
epoch, target=None)``), whichever side wrote them, through its own OCDBT,
zarr and zstd code (``utils/ocdbt.py``), so a run resumes, serves or
continues in stages on either side without orbax.  ``ckpt_{epoch}.pt``
files (the model's state_dict, the optimizer's state and the epoch,
``torch.save``), which the port wrote before it wrote Orbax directories,
still load (`load_checkpoint`); `save_pt_checkpoint` writes one.
"""

from __future__ import annotations

import base64
import json
import os
import re
import shutil
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

_PT = re.compile(r"ckpt_(\d+)\.pt")
_ORBAX = re.compile(r"ckpt_(\d+)")


def _path(base_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(base_dir), f"ckpt_{epoch}.pt")


def save_pt_checkpoint(base_dir: str, epoch: int, model,
                       optimizer=None) -> str:
    """Write ``ckpt_{epoch}.pt``; `optimizer` is a `train.trainer.Optimizer`
    (or None to leave its state out)."""
    os.makedirs(base_dir, exist_ok=True)
    path = _path(base_dir, epoch)
    state = {"epoch": epoch, "model": model.state_dict()}
    if optimizer is not None:
        state["adam"] = optimizer.adam.state_dict()
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def train_state(model, optimizer=None) -> dict:
    """The tree of the JAX package's ``TrainState._asdict()`` for `model`
    and `optimizer` (a `train.trainer.Optimizer`): ``params`` and
    ``batch_stats`` as nested dicts of numpy arrays, ``opt_state`` as
    optax's state in dicts and lists (`train.trainer.jax_opt_state`), and
    ``step``, the updates made, an int32 scalar.  Without an optimizer the
    tree holds no opt_state and step is 0."""
    from regnet_for_3d_grasping_torch.weights import nest, state_dict_to_jax

    tree = nest(state_dict_to_jax(model.state_dict()))
    step = 0
    if optimizer is not None:
        from regnet_for_3d_grasping_torch.train.trainer import jax_opt_state
        tree["opt_state"], step = jax_opt_state(optimizer)
    tree["step"] = np.asarray(step, np.int32)
    return tree


# what JAX's CPU device 0 is called: the device `_sharding` names
JAX_CPU_DEVICE = "TFRT_CPU_0"
_HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
            "PyTreeCheckpointHandler")


def _leaves(node, keys, out) -> None:
    """(key_metadata, leaf) of every leaf under `node`, in JAX's flattening
    order: a dict's keys sorted (key_type 2), a list's or tuple's indices
    (key_type 1)."""
    if isinstance(node, dict):
        items = [(k, 2, node[k]) for k in sorted(node)]
    elif isinstance(node, (list, tuple)):
        items = [(str(i), 1, v) for i, v in enumerate(node)]
    else:
        out.append((keys, node))
        return
    for k, kind, v in items:
        _leaves(v, keys + [{"key": k, "key_type": kind}], out)


def write_orbax(ckpt_dir: str, tree: Any) -> None:
    """Write `tree` (nested dicts, lists and tuples; float32 and int32
    arrays, and None, at the leaves) as the Orbax PyTree checkpoint
    directory `ckpt_dir`, which must not exist: the inverse of
    `restore_orbax`.  Beside the OCDBT database (``utils/ocdbt.py``) of the
    leaves' zarr arrays it writes what orbax reads with it: ``_METADATA``
    (the tree: each leaf's keys and value type, ``"None"`` for a None),
    ``_CHECKPOINT_METADATA``, ``array_metadatas/process_0`` and
    ``_sharding``.  JAX's restore without ``target`` reads no
    ``_sharding``; with one (its resume, its staged training) it takes
    each array's sharding from that file and fails without it, so every
    array is written on JAX's CPU device 0, `JAX_CPU_DEVICE`, where the
    JAX package's CPU processes find it (a process whose devices are all
    TPUs restores it without ``target``)."""
    from regnet_for_3d_grasping_torch.utils import ocdbt

    t0 = time.time_ns()
    leaves: list = []
    _leaves(tree, [], leaves)
    items, meta, arrays, sharding = {}, {}, [], {}
    placement = json.dumps({"sharding_type": "SingleDeviceSharding",
                            "device_str": JAX_CPU_DEVICE})
    for keys, leaf in leaves:
        path = [k["key"] for k in keys]
        name = ".".join(path)
        if leaf is None:
            value = {"value_type": "None", "skip_deserialize": True}
        else:
            leaf = np.asarray(leaf)
            ocdbt.write_array(items, name, leaf)
            value = {"value_type": "jax.Array", "skip_deserialize": False,
                     "write_shape": list(leaf.shape)}
            arrays.append({"array_metadata": {
                "param_name": name, "write_shape": list(leaf.shape),
                "chunk_shape": list(leaf.shape), "ext_metadata": None}})
            sharding[base64.b64encode(name.encode()).decode()] = placement
        meta[str(tuple(path))] = {"key_metadata": keys,
                                  "value_metadata": value}
    os.makedirs(ckpt_dir)
    ocdbt.write_kvstore(ckpt_dir, items)
    os.makedirs(os.path.join(ckpt_dir, "array_metadatas"))
    files = {
        "_METADATA": {"tree_metadata": meta, "use_ocdbt": True,
                      "use_zarr3": False,
                      "store_array_data_equal_to_fill_value": True,
                      "custom_metadata": None},
        "_sharding": sharding,
        os.path.join("array_metadatas", "process_0"): {
            "array_metadatas": arrays},
        "_CHECKPOINT_METADATA": {
            "item_handlers": _HANDLER, "metrics": {},
            "performance_metrics": {}, "init_timestamp_nsecs": t0,
            "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}}}
    for name, content in files.items():
        with open(os.path.join(ckpt_dir, name), "w") as f:
            f.write(json.dumps(content))


def save_checkpoint(base_dir: str, epoch: int, model,
                    optimizer=None) -> str:
    """Write ``ckpt_{epoch}/``, the JAX package's checkpoint of `model` and
    `optimizer` (`train_state`, `write_orbax`), as JAX's ``save_checkpoint``
    does with ``force=True``: into a temporary directory renamed into
    place over any earlier one.  A ``ckpt_{epoch}.pt`` of the same epoch
    is removed, so that a tag directory never holds an epoch twice."""
    base = os.path.abspath(base_dir)
    os.makedirs(base, exist_ok=True)
    path = os.path.join(base, f"ckpt_{epoch}")
    tmp = f"{path}.orbax-checkpoint-tmp-{time.time_ns()}"
    write_orbax(tmp, train_state(model, optimizer))
    if os.path.lexists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    if os.path.exists(_path(base, epoch)):
        os.remove(_path(base, epoch))
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
    """The latest epoch under a tag directory, of ``ckpt_N`` Orbax
    directories and ``ckpt_N.pt`` files alike."""
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
