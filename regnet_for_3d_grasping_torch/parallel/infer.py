"""Data-parallel serving: one worker process per device (JAX
``parallel/infer.py``).

JAX shards the batch axis of the batched forward over a 1-D ``data`` mesh,
parameters replicated, and folds each shard's ``axis_index`` into the
sampling key.  The port's forward is host-bound (a host thread issues its
launches), so one host thread issuing W forwards would serve about one
card's worth; instead each device gets a worker process of its own, which
builds the model on its device and loads the weights once, then serves
the shards it is sent.

The contract is JAX's (``parallel/infer.py:41-51``): with a batch of B
clouds over W devices, shard i (clouds ``[i*B/W, (i+1)*B/W)``) runs as one
batched forward with its generator seeded ``fold_seed(seed, i)``, and so
reproduces that solo forward exactly; it is not one batched run of the B
clouds.  A worker that fails to start, to build or to run ends the call
with an exception, after the other workers are stopped: nothing falls back
to fewer devices or to the CPU.
"""

from __future__ import annotations

import io
import queue
import time
import traceback
from typing import List, Optional, Sequence

import numpy as np
import torch

from regnet_for_3d_grasping_torch.parallel.mesh import fold_seed, shard_rows

# seconds a worker may take to build its model, and to answer one shard
START_TIMEOUT, CALL_TIMEOUT = 900.0, 600.0


def _serve(rank: int, device: str, cfg, weights, init_seed: int,
           requests, replies) -> None:
    """A worker: the model on `device`, then one reply per request until
    the request ``None``."""
    try:
        from regnet_for_3d_grasping_torch.eval.evaluator import eval_test
        from regnet_for_3d_grasping_torch.models.regnet import (REGNetOutput,
                                                                 build_regnet)
        from regnet_for_3d_grasping_torch.ops import _cuda
        from regnet_for_3d_grasping_torch.utils.export import (
            extract_grasp_sets)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        torch.manual_seed(init_seed)      # random init without weights
        model = build_regnet(cfg, weights, dev)
        replies.put(("ready", rank, None))
    except BaseException:
        replies.put(("error", rank, traceback.format_exc()))
        return
    while True:
        msg = requests.get()
        if msg is None:
            return
        try:
            pc, seed, kw, backs = msg
            x = torch.from_numpy(pc).to(dev)
            gen = torch.Generator().manual_seed(seed)
            before = dict(_cuda.launches)
            _sync(dev)
            t0 = time.perf_counter()
            with torch.inference_mode():
                out = model(x, generator=gen, **kw)
            _sync(dev)
            dt = time.perf_counter() - t0
            launches = {k: v - before[k] for k, v in _cuda.launches.items()}
            sets = extract_grasp_sets(out)
            g = cfg.gripper
            for i, back in enumerate(backs):
                if back is not None:
                    sets[i] = {k: eval_test(back, v, None, g.table_height,
                                            g.depth, g.width, g, cfg.eval,
                                            device=dev)
                               for k, v in sets[i].items()}
            host = REGNetOutput(*(None if v is None else v.cpu()
                                  for v in out))
            # through torch.save: the tensors keep their dtype (bf16 too)
            # and travel in the message, not as shared-memory handles
            buf = io.BytesIO()
            torch.save({"out": host, "forward_s": dt, "launches": launches,
                        "sets": sets,
                        "post_s": time.perf_counter() - t0 - dt}, buf)
            replies.put(("out", rank, buf.getvalue()))
        except BaseException:
            replies.put(("error", rank, traceback.format_exc()))
            return


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class DataParallelInference:
    """W worker processes, one per device of `devices`, each holding the
    eval-mode model of `cfg` with `weights` (an npz path, a JAX Orbax
    checkpoint directory, which each worker reads, JAX variable arrays, or
    None for the random init of ``torch.manual_seed(init_seed)``,
    as the infer CLI draws it); a worker on the CPU runs one torch thread.
    Call it with a batch; `close` it (or use it as a context manager) to
    stop the workers."""

    def __init__(self, cfg, weights, devices: Sequence, init_seed: int = 0):
        import multiprocessing as mp
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("no device to serve on")
        if any(d.type == "cuda" for d in self.devices):
            # one build for all workers, before they start
            from regnet_for_3d_grasping_torch.ops import _cuda
            _cuda.build()
        ctx = mp.get_context("spawn")
        self._replies = ctx.Queue()
        self._requests = [ctx.Queue() for _ in self.devices]
        self._procs = [
            ctx.Process(target=_serve, daemon=True, args=(
                r, str(d), cfg, weights, init_seed, self._requests[r],
                self._replies))
            for r, d in enumerate(self.devices)]
        for p in self._procs:
            p.start()
        try:
            self._collect("ready", START_TIMEOUT)
        except BaseException:
            self.close()
            raise

    @property
    def size(self) -> int:
        return len(self.devices)

    def _collect(self, kind: str, timeout: float) -> list:
        """One reply of `kind` from every worker, by rank; raises on a
        worker's error, death or silence."""
        got: List[Optional[dict]] = [None] * self.size
        waiting = set(range(self.size))
        deadline = time.monotonic() + timeout
        while waiting:
            try:
                what, rank, payload = self._replies.get(timeout=1.0)
            except queue.Empty:
                for r in sorted(waiting):
                    code = self._procs[r].exitcode
                    if code is not None:
                        raise RuntimeError(
                            f"serving worker {r} ({self.devices[r]}) exited "
                            f"with code {code}")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"serving workers {sorted(waiting)} gave no "
                        f"{kind!r} within {timeout:.0f} s")
                continue
            if what == "error":
                raise RuntimeError(f"serving worker {rank} "
                                   f"({self.devices[rank]}) failed:\n"
                                   f"{payload}")
            got[rank] = (payload if what == "ready" else torch.load(
                io.BytesIO(payload), weights_only=False))
            waiting.discard(rank)
        return got

    def __call__(self, pc: np.ndarray, seed: int,
                 forward_kws: Optional[Sequence[dict]] = None,
                 eval_clouds: Optional[Sequence] = None) -> List[dict]:
        """pc [B, N, 6] f32, B a multiple of the workers -> one dict per
        shard: ``out`` (`REGNetOutput` on the CPU, batch B/W),
        ``forward_s`` (the forward on the device, synchronized),
        ``post_s`` (what the worker does after it: the sets, their view
        filter and the reply's serialization),
        ``launches`` (kernel launches of that forward) and ``sets`` (the
        grasp sets of each cloud, through the view filter `eval_test` on
        the worker's device where `eval_clouds[b]`, the cloud as loaded, is
        given).  `forward_kws[i]`: explicit seeds for shard i's forward
        (`REGNet.forward`); what they leave out is drawn from its
        generator."""
        pc = np.ascontiguousarray(pc, np.float32)
        B = len(pc)
        backs = list(eval_clouds) if eval_clouds is not None else [None] * B
        for r in range(self.size):
            rows = shard_rows(B, self.size, r)
            kw = dict(forward_kws[r]) if forward_kws is not None else {}
            self._requests[r].put((pc[rows], fold_seed(seed, r), kw,
                                   backs[rows]))
        try:
            return self._collect("out", CALL_TIMEOUT)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        for q, p in zip(self._requests, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_dp_inference(cfg, weights, devices: Sequence, init_seed: int = 0
                      ) -> DataParallelInference:
    """JAX ``make_dp_inference``: serving of `cfg` with `weights` spread
    over `devices`, one worker process each (`DataParallelInference`)."""
    return DataParallelInference(cfg, weights, devices, init_seed)
