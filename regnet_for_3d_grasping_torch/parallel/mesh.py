"""Data parallelism over processes, one per device (JAX ``parallel/mesh.py``).

The JAX package shards the batch over a ``jax.sharding.Mesh`` inside one
program; the port runs one process per device, joined by a
``torch.distributed`` process group (NCCL on cards, gloo on the CPU):

  * `Mesh`: a 1-D (``"data"``) or 2-D (``"dcn"`` x ``"data"``) layout of
    the ranks, row-major, with a process group per axis; `Mesh.all_mean_`
    is JAX's ``pmean`` over every axis (within a slice first, then across
    slices, as XLA reduces a multi-slice mesh);
  * `shard_index`: the JAX trainer's flattening of the per-axis indices
    (``trainer.py:109-115``), row-major, so the shard of a rank is its rank;
  * `shard_batch`: JAX's ``shard_batch`` / ``batch_sharding``, a contiguous
    split of axis 0 (rank r holds rows ``[r*B/W, (r+1)*B/W)``);
  * `fold_seed`: ``jax.random.fold_in(key, shard)`` for the port's integer
    seeds.

Parameters are replicated by construction: every rank starts from the same
weights and applies the same averaged update (``train/trainer.py``).
`visible_devices` lists the devices an entry point spreads over.
"""

from __future__ import annotations

import contextlib
import datetime
from typing import Sequence

import numpy as np
import torch

_U32 = 0xFFFFFFFF


def fold_seed(seed: int, shard: int) -> int:
    """The seed of shard `shard` of a run seeded `seed`: the u32 that
    `ops.sampling.hash_uniform` computes for `seed` at linear index
    ``shard + 1``, i.e. the lowbias32 mix of ``seed * 0x9E3779B9 +
    (shard + 1) * 2654435761`` (mod 2^32): ``x ^= x >> 16; x *=
    0x45D9F3B`` twice, then ``x ^= x >> 16``.  Shard 0 is folded too, as
    JAX folds ``axis_index`` 0, so one shard's run is not the unfolded
    run (index 0 would leave seed 0 at 0)."""
    x = ((int(shard) + 1 & _U32) * 2654435761
         + (int(seed) & _U32) * 0x9E3779B9) & _U32
    for _ in range(2):
        x ^= x >> 16
        x = (x * 0x45D9F3B) & _U32
    return x ^ (x >> 16)


def shard_index(coords: Sequence[int], shape: Sequence[int]) -> int:
    """Row-major flattening of per-axis indices, as the JAX trainer folds
    ``axis_index`` over the mesh axes."""
    shard = 0
    for c, n in zip(coords, shape):
        shard = shard * n + c
    return shard


def shard_rows(n: int, world: int, shard: int) -> slice:
    """Rows of a batch of `n` that shard `shard` of `world` holds."""
    if n % world:
        raise ValueError(f"a batch of {n} does not split over {world} "
                         "shards")
    k = n // world
    return slice(shard * k, (shard + 1) * k)


def shard_batch(batch, world: int, shard: int):
    """Shard `shard`'s contiguous rows of every field of a NamedTuple batch
    (arrays, tensors or lists, axis 0)."""
    rows = shard_rows(len(batch[0]), world, shard)
    return type(batch)(*(x[rows] for x in batch))


def visible_devices(device: str | torch.device = "cuda"
                    ) -> list[torch.device]:
    """The devices an entry point spreads over: every visible card for
    ``cuda`` (raises where there is none; never the CPU instead), the one
    device named otherwise (``cuda:1``, ``cpu``)."""
    from regnet_for_3d_grasping_torch.runtime import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n < 1:
            raise RuntimeError("no CUDA device is visible")
        return [torch.device("cuda", i) for i in range(n)]
    return [dev]


# the axes of a mesh of 1 and of 2 dimensions, as JAX names them
AXIS_NAMES = {1: ("data",), 2: ("dcn", "data")}
# how long a rank waits on the host for the others (`Mesh.host_barrier`),
# which may be while rank 0 validates; a rank that died ends the run
# before that (`launch.run_ranks` terminates the rest)
HOST_TIMEOUT = datetime.timedelta(hours=24)


class Mesh:
    """The ranks of the default process group laid out row-major over
    `shape` (axes `AXIS_NAMES`), with one process group per axis.  Every
    rank must build the same mesh, in the same order as every other
    group."""

    def __init__(self, shape: Sequence[int]):
        import torch.distributed as dist
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = AXIS_NAMES[len(self.shape)]
        self.size = int(np.prod(self.shape))
        self.rank = dist.get_rank()
        if dist.get_world_size() != self.size:
            raise ValueError(f"a mesh of {self.shape} needs "
                             f"{self.size} ranks, not "
                             f"{dist.get_world_size()}")
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             self.shape))
        grid = np.arange(self.size).reshape(self.shape)
        # an axis's group: the ranks that differ only along it.  Every rank
        # creates every group (`new_group` is collective)
        self._groups = {}
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, ax, -1).reshape(-1, self.shape[ax])
            for line in lines:
                g = (None if len(self.shape) == 1
                     else dist.new_group([int(r) for r in line]))
                if self.rank in line:
                    self._groups[name] = g
        # a gloo group of every rank: its barrier waits on the host, with
        # no collective kernel held on the card
        self._host = dist.new_group(backend="gloo", timeout=HOST_TIMEOUT)
        # a list here collects (start, end) CUDA events around every
        # `timed` block on a card (`collective_ms`)
        self.events = None

    @property
    def shard_index(self) -> int:
        return shard_index(self.coords, self.shape)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_mean_(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the mean of `t` over every rank (JAX ``pmean`` over
        all the mesh's axes), summed along the last axis first."""
        import torch.distributed as dist
        for name in reversed(self.axis_names):
            dist.all_reduce(t, group=self._groups[name])
        return t.div_(self.size)

    def host_barrier(self) -> None:
        """Every rank waits here for every other, on the host."""
        import torch.distributed as dist
        dist.barrier(group=self._host)

    @contextlib.contextmanager
    def timed(self):
        """Within the block, where `events` is a list (a rank on a card):
        a pair of CUDA events around the block's work."""
        if self.events is None:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.events.append((start, end))

    def collective_ms(self) -> list:
        """Milliseconds of each `timed` block so far, on the card's clock
        (the wait for the slowest rank included), after a synchronize."""
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events or ()]


def make_mesh() -> Mesh:
    """1-D (``"data"``) data-parallel mesh over every rank of the process
    group."""
    import torch.distributed as dist
    return Mesh((dist.get_world_size(),))


def make_multislice_mesh(num_slices: int) -> Mesh:
    """2-D (``"dcn"`` slices x ``"data"`` devices a slice) mesh; the batch
    shards over both axes, and a mean reduces within each slice, then
    across them."""
    import torch.distributed as dist
    world = dist.get_world_size()
    if world % num_slices:
        raise ValueError(f"{world} ranks do not split into {num_slices} "
                         "slices")
    return Mesh((num_slices, world // num_slices))

