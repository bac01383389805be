"""Training: back-to-back ``train/trainer.train_step`` as the train CLI
runs it (deterministic algorithms, a seeded sampling generator and a
dropout generator on the card each step), its batches through the port's
``data/dataset.GraspDataset.batches`` and ``trainer.device_batch`` from a
pool of training scenes on disk.  On more than one chip, one rank a card
(``parallel/launch.run_ranks``, NCCL): every rank reads the same global
batch and steps on its contiguous shard with ``train_step(..., mesh=)``,
which averages the gradients, the BatchNorm statistics and the metrics
over the ranks (``average_over_mesh``), each rank's generators seeded by
the step's seed folded by its rank, as the train CLI's ranks.

Traffic parameters (``traffic``): ``pool_scenes`` scenes written by the
frozen generator (``traffic/synthetic.py``) from ``pool_seed`` with
``layout``, once per checkout into ``.portbench_cache/scenes/`` (the
dataset's split keeps 80 % for training); ``batch`` scenes a step and a
card; the run's seed draws the shuffle, the resampling and colour
augmentation, the weights and every step's generators.  The first
``check.steps`` (3) steps are the set-up's warm-up and the steps the
reference follows, in each rank, once the window has closed.  On several
ranks rank 0 ends the window: after each step it tells the others, by one
broadcast of a flag, whether the window's seconds have passed.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import time

import torch

from portbench import flops, harness
from portbench.modes import Run as _Run, file_key, sub_seed
from portbench.modes.serve import fresh_model
from portbench.reference import checks

_U32 = 0xFFFFFFFF


def fold_seed(seed: int, rank: int) -> int:
    """Rank `rank`'s seed of a step seeded `seed`: the lowbias32 mix of
    ``seed * 0x9E3779B9 + (rank + 1) * 2654435761`` (mod 2^32), the fold
    the train CLI's ranks (and the JAX trainer's shards) apply."""
    x = (((rank + 1) & _U32) * 2654435761 + (seed & _U32) * 0x9E3779B9) \
        & _U32
    for _ in range(2):
        x ^= x >> 16
        x = (x * 0x45D9F3B) & _U32
    return x ^ (x >> 16)


def shard(batch, world: int, rank: int):
    """Rank `rank`'s contiguous rows of every field of a batch."""
    k = len(batch[0]) // world
    return type(batch)(*(x[rank * k:(rank + 1) * k] for x in batch))


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms within the block, as the train CLI's
    ``deterministic()`` sets them (memory from ``torch.empty`` is not
    filled)."""
    import torch.utils.deterministic as det
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.are_deterministic_algorithms_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        det.fill_uninitialized_memory = prev[1]


class Run(_Run):
    def execute(self) -> dict:
        from regnet_for_3d_grasping_torch import config as port_config
        self.cfg = self.config(port_config)
        self.phase("imports")
        self.pool = self.scene_pool(self.cfg.region.num_points)
        self.phase("scene pool")
        if self.chips == 1:
            with deterministic():
                parts = [self.rank_part(0, None)]
        else:
            parts = self.run_ranks()
        return self.finish(parts)

    def scene_pool(self, points: int) -> str:
        """The pool's directory, written once per checkout (named by the
        generator's source and the pool's parameters)."""
        from portbench.traffic import synthetic
        t = self.traffic
        params = f"{t['pool_scenes']}-{t['pool_seed']}-{t['layout']}-{points}"
        path = self.cache / "scenes" / file_key(synthetic.__file__,
                                                extra=params)
        if not path.is_dir():
            tmp = path.with_name(path.name + ".part")
            shutil.rmtree(tmp, ignore_errors=True)
            synthetic.write_synthetic_dataset(
                str(tmp), int(t["pool_scenes"]), num_view=points,
                seed=int(t["pool_seed"]), layout=t["layout"])
            os.replace(tmp, path)
        return str(path)

    def run_ranks(self) -> list:
        from regnet_for_3d_grasping_torch.parallel.launch import run_ranks
        devices = ([torch.device("cuda", i) for i in range(self.chips)]
                   if self.device.type == "cuda" else ["cpu"] * self.chips)
        if self.device.type == "cuda":
            from regnet_for_3d_grasping_torch.ops import _cuda
            from regnet_for_3d_grasping_torch.utils.cache import (
                enable_compilation_cache)
            enable_compilation_cache()
            _cuda.build()           # once, before the ranks load it
        return run_ranks(_rank, devices, self.cell, self.args, self.chips,
                         self.start_s, self.patch, self.cache)

    # -- one rank's part (the only part on one chip) ---------------------
    def rank_part(self, rank: int, mesh) -> dict:
        from regnet_for_3d_grasping_torch.data import GraspDataset
        from regnet_for_3d_grasping_torch.models.regnet import REGNet
        from regnet_for_3d_grasping_torch.train import trainer
        from regnet_for_3d_grasping_torch.utils.cache import (
            enable_compilation_cache)
        enable_compilation_cache()
        cfg, seed, B = self.cfg, self.args.seed, int(self.traffic["batch"])
        world = self.chips
        stage = self.cell["config_file"]["stage"]
        ds = GraspDataset(self.pool, "train", cfg.region.num_points,
                          cfg.region.max_gt_grasps, 1)
        self.phase(f"dataset (rank {rank})")
        steps_per_epoch = max(len(ds) // (B * world), 1)
        if self.args.control:
            model, opt, tr = self.reference_side(self.cell["control"],
                                                 steps_per_epoch)
        else:
            model = fresh_model(REGNet, cfg, self.device, seed)
            opt = trainer.make_optimizer(model, cfg, steps_per_epoch)
            tr = trainer
        self.phase(f"model (rank {rank})")
        drop = torch.Generator(device=self.device)
        feed = self.batches(ds, B * world)
        firsts = []

        def step(n, keep=False):
            with self.spans.span("input"):
                batch = next(feed)
                if keep:
                    firsts.append(batch)
                db = tr.device_batch(shard(batch, world, rank) if world > 1
                                     else batch, self.device)
            with self.spans.span("step"):
                s = sub_seed(seed, 5, n)
                if world > 1:
                    s = fold_seed(s, rank)
                gen = torch.Generator().manual_seed(s)
                drop.manual_seed(s)
                metrics = tr.train_step(model, opt, db, stage, mesh,
                                        generator=gen,
                                        dropout_generator=drop)
                return float(metrics["loss_total"])

        # set-up: the first steps, which the reference follows
        self.phase(f"optimizer (rank {rank})")
        record = checks.StepRecord()
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        for n in range(int(self.check["steps"])):
            record.after_step(n, step(n, keep=True), model, opt, start)
        del start
        self.sync()
        self.spans.seconds.clear()
        setup_s = self.setup_seconds()
        self.phase(f"first steps (rank {rank})")
        first = int(self.check["steps"])
        if mesh is not None and self.device.type == "cuda":
            mesh.events = []
        win = self.measure(lambda n: step(first + n), lambda n: n,
                           self.stop_flag(rank, mesh))
        self.read_memory()
        collective = None
        if mesh is not None and mesh.events is not None:
            ms = mesh.collective_ms()
            collective = sum(ms) / len(ms) if ms else None
        part = {"rank": rank, "n": win["n"], "window_s": win["window_s"],
                "setup_s": setup_s, "memory_peak": self.memory_peak,
                "trace": self.trace, "spans": self.spans.seconds,
                "collective_ms": collective, "record": vars(record)}
        del model, opt, feed, drop
        self.free()
        t_ref = time.perf_counter()
        part["reference"] = vars(self.follow(firsts, rank, mesh))
        part["reference_s"] = time.perf_counter() - t_ref
        return part

    def stop_flag(self, rank: int, mesh):
        """On several ranks, whether rank 0's window has ended, told to
        every rank after each step; None on one."""
        if mesh is None:
            return None
        import torch.distributed as dist
        flag = torch.zeros(1, device=self.device)

        def stop(elapsed: float, seconds: float) -> bool:
            if rank == 0:
                flag.fill_(float(elapsed >= seconds))
            dist.broadcast(flag, 0)
            return bool(flag.item())
        return stop

    def batches(self, ds, B):
        """Epoch after epoch of the dataset's batches, each epoch's shuffle
        and augmentation drawn from the run's seed."""
        epoch = 0
        while True:
            yield from ds.batches(B, seed=sub_seed(self.args.seed, 6, epoch))
            epoch += 1

    # -- the result and the check ----------------------------------------
    def finish(self, parts: list) -> dict:
        world, B = self.chips, int(self.traffic["batch"])
        main = parts[0]
        n, window = main["n"], main["window_s"]
        self.memory_peak = max(p["memory_peak"] for p in parts)
        end_to_end = {"train_scenes_per_s": n * B * world / window,
                      "setup_s": max(p["setup_s"] for p in parts)}
        spans = harness.Spans(False)
        spans.seconds = {k: [sum(sum(p["spans"].get(k, ())) for p in parts)
                             / world] for k in main["spans"]}
        coll = [p["collective_ms"] for p in parts
                if p["collective_ms"] is not None]
        ctx = {"mode": "train", "spans": spans, "per_unit": n,
               "flops": flops.step_flops(self.cfg, n * B, True),
               "peak_flops": harness.PEAK_FLOPS[
                   self.cfg.model.compute_dtype],
               "memory_peak": self.memory_peak,
               "collective_ms": sum(coll) / len(coll) if coll else None}
        if main["trace"] is not None:
            self.trace = _mean_trace([p["trace"] for p in parts])
        records, refs = [], []
        for p in parts:
            for key, out in (("record", records), ("reference", refs)):
                r = checks.StepRecord()
                vars(r).update(p[key])
                out.append(r)
        print(f"reference: {max(p['reference_s'] for p in parts)!r} s",
              file=sys.stderr)
        numbers = checks.training_numbers(records[0], refs[0])
        if world > 1:
            numbers["rank_gap"] = checks.rank_gap(records)
        print(f"losses: program {records[0].losses!r}, reference "
              f"{refs[0].losses!r}", file=sys.stderr)
        return self.result(end_to_end, ctx,
                           checks.with_limits(numbers, self.check["limits"]),
                           attempted=n, failed=0)

    def reference_side(self, control, steps_per_epoch):
        """The reference's model, optimizer and trainer module on the
        device, from the same weights, at `control`'s precision."""
        from portbench.reference.regnet_ref import config as ref_config
        from portbench.reference.regnet_ref.models.regnet import REGNet
        from portbench.reference.regnet_ref.nn import layers
        from portbench.reference.regnet_ref.train import trainer
        layers.CONTROL = control
        rcfg = self.config(ref_config)
        model = fresh_model(REGNet, rcfg, self.device, self.args.seed)
        return model, trainer.make_optimizer(model, rcfg,
                                             steps_per_epoch), trainer

    def follow(self, batches, rank: int, mesh) -> checks.StepRecord:
        """The reference's first steps on the program's batches with the
        program's seeds, once the program's state is freed.  On several
        ranks the reference steps in every rank on its shard, and its
        exchange is `PlainMesh`'s: torch.distributed's mean over the
        ranks."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        world, B = self.chips, int(self.traffic["batch"])
        n_train = int(int(self.traffic["pool_scenes"]) * 0.8)
        model, opt, tr = self.reference_side(None, max(
            n_train // (B * world), 1))
        plain = None if mesh is None else PlainMesh()
        stage = self.cell["config_file"]["stage"]
        rec = checks.StepRecord()
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        for n, batch in enumerate(batches):
            s = sub_seed(self.args.seed, 5, n)
            if world > 1:
                batch, s = shard(batch, world, rank), fold_seed(s, rank)
            m = tr.train_step(
                model, opt, tr.device_batch(batch, self.device), stage,
                plain, generator=torch.Generator().manual_seed(s),
                dropout_generator=torch.Generator(
                    device=self.device).manual_seed(s))
            rec.after_step(n, float(m["loss_total"]), model, opt, start)
        return rec


class PlainMesh:
    """The reference's exchange between ranks: the mean of a tensor over
    every rank of the default process group, torch.distributed's all-reduce
    sum divided by the ranks."""

    def __init__(self):
        import torch.distributed as dist
        self.dist = dist
        self.size = dist.get_world_size()

    @contextlib.contextmanager
    def timed(self):
        yield

    def all_mean_(self, t: torch.Tensor) -> torch.Tensor:
        self.dist.all_reduce(t)
        return t.div_(self.size)


def _mean_trace(traces: list) -> dict:
    """The ranks' traces as one: seconds averaged over the cards, the
    roofline functions' bounds and device seconds summed, rank 0's
    breakdown."""
    k = len(traces)
    out = dict(traces[0])
    for key in ("busy_s", "gemm_s", "own_s"):
        out[key] = sum(t[key] for t in traces) / k
    out["roofline"] = {fn: (sum(t["roofline"][fn][0] for t in traces),
                            sum(t["roofline"][fn][1] for t in traces))
                       for fn in traces[0]["roofline"]}
    return out


def _rank(rank, device, cell, args, chips, start_s, patch, cache) -> dict:
    """One rank's process: its part of the run, returned to the caller."""
    from regnet_for_3d_grasping_torch import config as port_config
    from regnet_for_3d_grasping_torch.parallel.mesh import make_mesh
    run = Run(cell=cell, args=args, chips=chips, start_s=start_s,
              device=torch.device(device), patch=patch, cache=cache)
    run.cfg = run.config(port_config)
    run.pool = run.scene_pool(run.cfg.region.num_points)
    mesh = make_mesh()
    from portbench.faults import plant
    plant(patch.get("fault"))
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    with deterministic():
        return run.rank_part(rank, mesh)
