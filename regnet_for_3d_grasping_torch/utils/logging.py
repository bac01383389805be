"""Scalar metric logging under the JAX package's tag names (its
``utils/logging.py``): one JSON line per scalar in
``<log_dir>/<tag>/metrics.jsonl``, named ``batch_{mode}_{tag}`` or
``epoch_{mode}_{tag}``; where ``torch.utils.tensorboard`` imports (it
needs the ``tensorboard`` package), a ``SummaryWriter`` in the same
directory is a secondary sink under the same names (JAX
``utils/logging.py:25-47``)."""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

import torch


class MetricLogger:
    def __init__(self, log_dir: str, tag: str = "default"):
        self.dir = os.path.join(log_dir, tag)
        os.makedirs(self.dir, exist_ok=True)
        self._f = open(os.path.join(self.dir, "metrics.jsonl"), "a",
                       buffering=1)
        self._tb = None
        try:  # optional secondary sink
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(self.dir)
        except Exception:
            pass

    def scalar(self, name: str, value, step: int) -> None:
        rec = {"tag": name, "value": float(value), "step": int(step),
               "time": time.time()}
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(name, float(value), step)

    def scalars(self, metrics: Mapping[str, object], step: int,
                mode: str = "train", granularity: str = "batch") -> None:
        """Tensor values are brought to the host in one copy."""
        for k, v in host_scalars(metrics).items():
            self.scalar(f"{granularity}_{mode}_{k}", v, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def host_scalars(metrics: Mapping[str, object]) -> dict:
    """{name: 0-d tensor or number} -> {name: float}, with one
    device-to-host copy for all the tensors."""
    names = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: float(v) for k, v in metrics.items() if k not in names}
    if names:
        vals = torch.stack([metrics[k].detach().float().reshape(())
                            for k in names]).tolist()
        out.update(zip(names, vals))
    return {k: out[k] for k in metrics}
