"""Processes for data parallelism: a process group per run, and a rank per
device spawned from the caller.

Nothing here falls back: a rank that fails to join the group, to build or
to run ends the run with an exception in the caller (`run_ranks`), and
the other ranks are terminated; a run is never continued on fewer devices
or on the CPU.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import tempfile
from typing import Callable, Sequence

import torch

# how long a rank waits in a collective for the others (a rank that died
# ends the run before that: `run_ranks` terminates the rest)
TIMEOUT = datetime.timedelta(minutes=30)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(device: torch.device, world: int, rank: int, port: int):
    """Within the block, the default process group of `world` ranks at
    ``tcp://localhost:<port>``: NCCL where `device` is a card (made this
    process's current card), gloo on the CPU."""
    import torch.distributed as dist
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
        timeout=TIMEOUT,
        **({"device_id": device} if device.type == "cuda" else {}))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, devices: list, port: int,
               out_dir: str, args: tuple) -> None:
    from regnet_for_3d_grasping_torch.runtime import resolve_device
    # the entry points' product precision (no TF32, no reduced-precision
    # bf16 sums) in every rank, whatever `fn` builds
    device = resolve_device(devices[rank])
    if device.type == "cpu":
        torch.set_num_threads(1)
    with process_group(device, len(devices), rank, port):
        result = fn(rank, device, *args)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(fn: Callable, devices: Sequence, *args) -> list:
    """``fn(rank, device, *args)`` in one spawned process per entry of
    `devices`, every process in the default process group (`process_group`)
    for the length of the call.  Returns each rank's return value (passed
    through ``torch.save``, its tensors loaded onto the CPU).  `fn` and
    `args` must pickle.  Each rank's device goes through
    `runtime.resolve_device`, as an entry point's does; a rank on the CPU
    runs one torch thread.  Raises where a rank fails, after terminating
    the others."""
    import torch.multiprocessing as mp
    devices = [str(d) for d in devices]
    with tempfile.TemporaryDirectory(prefix="regnet_ranks_") as out_dir:
        mp.start_processes(_rank_main, nprocs=len(devices), join=True,
                           start_method="spawn",
                           args=(fn, devices, free_port(), out_dir, args))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(len(devices))]
