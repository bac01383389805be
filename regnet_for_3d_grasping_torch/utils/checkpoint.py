"""Checkpoints with the JAX package's resume semantics (its
``utils/checkpoint.py``): one file ``ckpt_{epoch}.pt`` per epoch under a
tag directory, holding the model's state_dict, the optimizer's state and
the epoch.  Written with ``torch.save``; Orbax directories are not read
(weights cross between the packages as npz, see ``weights.py``)."""

from __future__ import annotations

import os
import re
from typing import Optional

import torch


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


def latest_epoch(base_dir: str) -> Optional[int]:
    if not os.path.isdir(base_dir):
        return None
    epochs = [int(m.group(1)) for n in os.listdir(base_dir)
              if (m := re.fullmatch(r"ckpt_(\d+)\.pt", n))]
    return max(epochs) if epochs else None


def load_checkpoint(path: str, epoch: Optional[int] = None) -> dict:
    """`path` is a tag directory (latest epoch, or `epoch`) or one
    ``ckpt_N.pt`` file.  Returns the saved dict; ``["epoch"] + 1`` is the
    epoch to resume at.  Only files this program wrote should be loaded:
    the optimizer state is unpickled."""
    if os.path.isdir(path):
        if epoch is None:
            epoch = latest_epoch(path)
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints under {path}")
        path = _path(path, epoch)
    return torch.load(path, map_location="cpu", weights_only=False)
