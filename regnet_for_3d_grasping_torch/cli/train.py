"""Training CLI of the PyTorch port (JAX ``cli/train.py``).

Modes: train (all three losses), pretrain_score, pretrain_region,
validate[_score|_region], test[_score|_region].  With ``--eval-grasps`` the
validation forwards' grasp sets also go through the geometric evaluator:
every ``--eval-every``-th epoch and the last in the train modes, always in
the validate and test modes, never at stage ``score``; each stage's VGR,
score and VGR before the view check are logged as
``epoch_{mode}_{stage}_vgr`` and so on.  With one visible device it
evaluates scene by scene (`eval.evaluator.evaluate_scene_grasps`); with
more, one scene per device (`eval.parallel_eval.evaluate_scenes_sharded`),
W pending scenes of a stage at a time, grouped by gripper width, as the
JAX CLI does on a mesh.

Data parallelism (JAX ``cli/train.py:250-255``): a training mode with more
than one visible card and a batch that the card count W divides trains on
every card, with no wrapper: the CLI spawns one process per card, joined
by NCCL (`parallel.launch.run_ranks`).  Each rank loads the same batches,
keeps its contiguous shard of B / W scenes and runs the data-parallel step
of `train.trainer` (its seed folded by its shard index; gradients,
BatchNorm statistics and metrics averaged).  Rank 0 logs the averaged
metrics, writes the checkpoints and runs the validation forwards, which
JAX does not shard either, and the grasp evaluation over every card; the
other ranks only train, and wait on the host (a gloo barrier, no
collective kernel on their cards) until rank 0 has validated.  Every flag
works as on one card.  Otherwise, or with ``--device cpu``, the CLI runs
on one device.  A rank that fails ends the run with an error; it never goes on
with fewer cards or on the CPU.

Each epoch rank 0 writes ``ckpt_N/`` under model-path/tag, the JAX
package's Orbax checkpoint of the model and Adam (`utils/checkpoint.
save_checkpoint`), as the JAX CLI does: the JAX package resumes it, trains
from it in stages and evaluates it, as the port does with the JAX
package's.  ``--resume`` continues at epoch N + 1 from the latest
checkpoint under model-path/tag: an Orbax directory ``ckpt_N`` of either
side (`utils/checkpoint.restore_orbax`: its params, batch statistics and
Adam's moments and counts, `train.trainer.load_jax_opt_state`) or a
``ckpt_N.pt`` the port wrote before it wrote Orbax directories.
``--load-score-path`` and ``--load-region-path`` take either form too.

Usage:
  python -m regnet_for_3d_grasping_torch.cli.train --mode train \\
      --synthetic-scenes 24 --data-path /tmp/scenes --batch-size 12 \\
      --epoch 1 [--bf16] [--slab-cell 0.04 --fps-groups 8] [--device cpu]
      [--eval-grasps --eval-every 5] [--geom-aug 1.0] [--native-loader]
      [--remat] [--profile-dir /tmp/trace]

``--bf16 --slab-cell 0.04 --fps-groups 8`` is the configuration that
trained the served weights ``weights/r5_real_e100.npz``.  The training
knobs (``--bf16``, ``--slab-cell``, ``--fps-groups``) apply to the train
steps only: validation forwards run f32 at exact geometry, as the JAX
CLI's ``exact_cfg`` does.  Under ``--bf16`` the network computes in bf16
in the train steps (bf16 GEMMs, pools and losses' logits) while the
parameters, the Adam state and BatchNorm's running statistics stay f32,
and all geometry stays f32.

The training leftovers of the JAX CLI: ``--geom-aug`` (`data/augment.py`:
Kinect noise and a rigid jitter per scene, drawn per epoch from
``RandomState(seed + 7919 + epoch)``), ``--native-loader`` (the C++ batch
loader, `data/native_loader.py`; it raises where its library does not
build, where JAX falls back to the Python loader), ``--remat`` (the
backbone's activations recomputed in the backward, `models/backbone.py`)
and ``--profile-dir`` (a ``torch.profiler`` trace of steps 3-7 of the
first epoch, written as a Chrome trace into the directory).

Runs on the card unless ``--device cpu`` asks for the plain PyTorch
versions of the kernels.  Every run is bit-reproducible, as the JAX
package's is: the CLI runs under `torch.use_deterministic_algorithms`
(`deterministic`), with cuBLAS's fixed workspace
(``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set here unless the caller set it
before the first cuBLAS call), on every rank.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

MODE_STAGE = {
    "train": "refine", "validate": "refine", "test": "refine",
    "pretrain_score": "score", "validate_score": "score",
    "test_score": "score",
    "pretrain_region": "region", "validate_region": "region",
    "test_region": "region",
}
TRAIN_MODES = ("train", "pretrain_score", "pretrain_region")


def build_parser():
    p = argparse.ArgumentParser(description="REGNet training (PyTorch)")
    p.add_argument("--tag", type=str, default="default")
    p.add_argument("--mode", required=True, choices=list(MODE_STAGE))
    p.add_argument("--epoch", type=int, default=101)
    p.add_argument("--batch-size", type=int, default=12)
    p.add_argument("--data-path", type=str, required=True)
    p.add_argument("--model-path", type=str, default="./assets/models")
    p.add_argument("--log-path", type=str, default="./assets/log")
    p.add_argument("--lr-score", type=float, default=1e-3)
    p.add_argument("--lr-region", type=float, default=1e-3)
    p.add_argument("--lr-step-epochs", type=int, default=5,
                   help="period of the step decay, in epochs")
    p.add_argument("--lr-gamma", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--center-jitter", type=str, default="",
                   help="comma list of center_num values cycled across "
                        "train steps (e.g. '64,256,1024')")
    p.add_argument("--eval-center-num", type=int, default=0,
                   help="run validation forwards at this center_num instead "
                        "of the training value")
    p.add_argument("--load-score-path", type=str, default="",
                   help="checkpoint tag dir (or an Orbax ckpt_N dir, "
                        "or a ckpt_N.pt) whose ScoreNet weights "
                        "initialize this run")
    p.add_argument("--load-region-path", type=str, default="",
                   help="checkpoint tag dir (or an Orbax ckpt_N dir, "
                        "or a ckpt_N.pt) whose GRN and RefineNet weights "
                        "initialize this run; the optimizer state starts "
                        "fresh")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint under "
                        "model-path/tag: an Orbax ckpt_N directory, "
                        "written by this CLI or the JAX package's, or a "
                        "ckpt_N.pt (model, batch statistics and Adam's "
                        "state)")
    p.add_argument("--synthetic-scenes", type=int, default=0,
                   help="generate N synthetic scenes under data-path first")
    p.add_argument("--gt-robust", type=int, default=0,
                   help="pose-robust GT labelling: candidates must also "
                        "survive N jittered poses (data/synthetic.py)")
    p.add_argument("--scene-layout", type=str, default="origin",
                   choices=["origin", "randomized"],
                   help="synthetic scene layout (data/synthetic.py)")
    p.add_argument("--eval-grasps", action="store_true",
                   help="run the geometric evaluator on the validation "
                        "forwards' grasp sets (slower)")
    p.add_argument("--eval-every", type=int, default=1,
                   help="evaluate grasps only every K validation epochs "
                        "(and the last); the loss metrics run every epoch")
    p.add_argument("--num-points", type=int, default=25600)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model and shapes (smoke tests)")
    p.add_argument("--slab-cell", type=float, default=0.0,
                   help="sorted-slab kernels in the TRAIN forward "
                        "(region.slab_cell; validation forwards stay exact)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 network compute in the TRAIN steps "
                        "(model.compute_dtype; parameters, optimizer state "
                        "and BatchNorm statistics stay f32; validation "
                        "forwards stay f32)")
    p.add_argument("--fps-groups", type=int, default=1,
                   help="stratified FPS at SA1 in the TRAIN forward "
                        "(model.fps_groups; validation forwards stay exact)")
    p.add_argument("--native-loader", action="store_true",
                   help="the C++ threaded batch loader "
                        "(data/native_loader.py)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the backbone's activations in the "
                        "backward (less memory, one more backbone forward)")
    p.add_argument("--geom-aug", type=float, default=0.0,
                   help="geometric augmentation severity (data/augment.py): "
                        "Kinect noise on the view cloud and a rigid jitter "
                        "per scene; 0 = off, 1.0 = the published Kinect v1 "
                        "magnitudes, 10%% dropout, full z rotation, "
                        "cm-scale translation")
    p.add_argument("--profile-dir", type=str, default="",
                   help="write a torch.profiler trace of steps 3-7 of the "
                        "first epoch into this directory")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    return p


def build_model(cfg, seed: int, device):
    """A freshly initialised REGNet on `device`: the weights are drawn on
    the CPU from ``torch.manual_seed(seed)``, so a seed names one model on
    every device."""
    from regnet_for_3d_grasping_torch.models.regnet import REGNet
    torch.manual_seed(seed)
    return REGNet(cfg).to(device)


def merge_checkpoint_modules(model, path: str, prefixes) -> None:
    """Initialise the named top-level modules of `model` from another
    run's checkpoint (a tag directory, latest epoch, one ``ckpt_N.pt`` or
    one JAX Orbax ``ckpt_N`` directory).  Entries the checkpoint lacks keep
    their fresh init."""
    from regnet_for_3d_grasping_torch.utils import checkpoint as ckpt
    saved = ckpt.load_checkpoint(path.rstrip("/"))
    own = model.state_dict()
    picked = {k: v for k, v in saved["model"].items()
              if k in own and k.split(".")[0] in prefixes}
    model.load_state_dict(picked, strict=False)
    print(f"loaded {len(picked)} arrays of {list(prefixes)} from {path} "
          f"(epoch {saved['epoch']})")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def deterministic():
    """Within the block, every PyTorch op takes its deterministic form
    (autograd's scatter-adds among them: the backward of `torch.gather`
    and of indexing sorts and sums in order instead of adding with float
    atomics) and an op that has none raises; the port's own kernels are
    deterministic.  Memory that `torch.empty` hands out is not filled: no
    result reads it.  The previous settings come back on exit."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch.utils.deterministic as det
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


def main(argv=None, devices=None) -> dict:
    """Returns {"model", "cfg", "eval_cfg", "steps": [{"epoch", "loss",
    "seconds"}], "epochs": [{"epoch", "seconds" (training, checkpoint and
    validation), "validate_seconds"}] (train modes),
    "validation": [metrics of each validation forward],
    "grasp_records": [{"epoch", "mode", "records": {stage: EvalRecord}}]
    (one per epoch that evaluated grasps), "trace": the profiler trace's
    path or None}; a step's seconds are synchronized on the device and
    cover the batch upload, the forward, the backward and the update.
    Data-parallel runs return rank 0's, its model on the CPU, and "ranks":
    each rank's device, step seconds, peak device memory and the
    milliseconds of each step's averaging collectives.  `devices`:
    the visible devices (default: `parallel.mesh.visible_devices` of
    ``--device``)."""
    from regnet_for_3d_grasping_torch.parallel.mesh import visible_devices
    from regnet_for_3d_grasping_torch.utils.cache import (
        enable_compilation_cache)
    args = build_parser().parse_args(argv)
    enable_compilation_cache()
    devices = list(devices) if devices is not None else \
        visible_devices(args.device)
    _prepare(args)
    if (args.mode in TRAIN_MODES and len(devices) > 1
            and args.batch_size % len(devices) == 0):
        return _run_data_parallel(args, devices)
    with deterministic():
        return _run(args, devices)


def _configs(args):
    """(train configuration, exact configuration) from the flags; sets
    ``args.num_points`` from the tiny configuration under ``--tiny``."""
    from regnet_for_3d_grasping_torch.config import tiny_config, train_config
    over = {"train.batch_size": args.batch_size,
            "train.lr_score": args.lr_score,
            "train.lr_region": args.lr_region,
            "train.lr_step_epochs": args.lr_step_epochs,
            "train.lr_gamma": args.lr_gamma}
    if args.tiny:
        cfg = tiny_config(**over)
        args.num_points = cfg.region.num_points
    else:
        cfg = train_config(**{"region.num_points": args.num_points, **over})
    if args.remat:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, remat_backbone=True))
    # the training knobs apply to the TRAIN config only; validation
    # forwards keep the exact geometry and f32 compute of `exact_cfg`
    exact_cfg = cfg
    if args.slab_cell > 0.0:
        cfg = dataclasses.replace(cfg, region=dataclasses.replace(
            cfg.region, slab_cell=args.slab_cell))
    if args.fps_groups > 1:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, fps_groups=args.fps_groups))
    if args.bf16:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="bfloat16"))
    return cfg, exact_cfg


def _prepare(args) -> None:
    """What a run writes to disk before it trains, once for all ranks:
    the synthetic scenes, and the native loader's scene cache and
    library."""
    from regnet_for_3d_grasping_torch.data import (GraspDataset,
                                                   write_synthetic_dataset)
    cfg, _ = _configs(args)
    if args.synthetic_scenes:
        write_synthetic_dataset(args.data_path, args.synthetic_scenes,
                                num_view=args.num_points,
                                layout=args.scene_layout,
                                gt_robust=args.gt_robust)
    if args.native_loader and args.mode in TRAIN_MODES:
        from regnet_for_3d_grasping_torch.data.native_loader import (
            build_library, convert_dataset)
        convert_dataset(GraspDataset(args.data_path, "train", args.num_points,
                                     cfg.region.max_gt_grasps,
                                     args.seed).paths,
                        os.path.join(args.data_path, "rsc_cache"))
        build_library()


def _run_data_parallel(args, devices) -> dict:
    """One rank per device (`_rank`), rank 0's result back."""
    from regnet_for_3d_grasping_torch.parallel.launch import run_ranks
    print(f"data-parallel over {len(devices)} devices")
    if any(torch.device(d).type == "cuda" for d in devices):
        from regnet_for_3d_grasping_torch.ops import _cuda
        _cuda.build()           # once, before the ranks load the kernels
    ranks = run_ranks(_rank, devices, args, [str(d) for d in devices])
    result = ranks[0]
    model = build_model(result["cfg"], args.seed, "cpu")
    model.load_state_dict(result.pop("state_dict"))
    result["model"] = model
    result["ranks"] = [r["rank"] for r in ranks]
    return result


def _rank(rank: int, device: torch.device, args, devices) -> dict:
    from regnet_for_3d_grasping_torch.parallel.mesh import make_mesh
    mesh = make_mesh()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        mesh.events = []
    with deterministic():
        result = _run(args, devices, mesh, device)
    cuda = device.type == "cuda"
    info = {"device": str(device),
            "seconds": [s["seconds"] for s in result["steps"]],
            "peak_bytes": torch.cuda.max_memory_allocated(device)
            if cuda else None,
            # each step's averaging, on the card's clock
            "collective_ms": mesh.collective_ms() if cuda else None}
    if rank != 0:
        return {"rank": info}
    del result["optimizer"]
    model = result.pop("model")
    result["state_dict"] = {k: v.cpu() for k, v in
                            model.state_dict().items()}
    result["rank"] = info
    return result


class _Silent:
    """The metric logger of a rank other than 0."""

    def scalar(self, *a) -> None:
        pass

    def scalars(self, *a) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


def _run(args, devices, mesh=None, device=None) -> dict:
    """One run on `device` (default ``--device``); with a `mesh`, this
    rank's part of a data-parallel run.  `devices`: the visible devices,
    over which the grasp evaluation spreads."""
    from regnet_for_3d_grasping_torch.data import GraspDataset
    from regnet_for_3d_grasping_torch.ops import _cuda
    from regnet_for_3d_grasping_torch.parallel.mesh import (fold_seed,
                                                            shard_batch)
    from regnet_for_3d_grasping_torch.runtime import resolve_device
    from regnet_for_3d_grasping_torch.train import trainer
    from regnet_for_3d_grasping_torch.utils import checkpoint as ckpt
    from regnet_for_3d_grasping_torch.utils.logging import (MetricLogger,
                                                            host_scalars)

    device = resolve_device(args.device if device is None else device)
    main_rank = mesh is None or mesh.is_main
    say = print if main_rank else (lambda *a, **k: None)
    cfg, exact_cfg = _configs(args)
    stage = MODE_STAGE[args.mode]
    is_train = args.mode in TRAIN_MODES

    ckpt_dir = os.path.join(args.model_path, args.tag)
    train_ds = GraspDataset(args.data_path, "train", args.num_points,
                            cfg.region.max_gt_grasps, args.seed)
    val_tag = "test" if "test" in args.mode else "validate"
    val_ds = GraspDataset(args.data_path, val_tag, args.num_points,
                          cfg.region.max_gt_grasps, args.seed)
    batch_size = args.batch_size if is_train else 1
    steps_per_epoch = max(len(train_ds) // max(batch_size, 1), 1)

    model = build_model(cfg, args.seed, device)
    resume_epoch, saved = 0, None
    if args.resume and ckpt.latest_epoch(ckpt_dir) is not None:
        saved = ckpt.load_checkpoint(ckpt_dir)
        model.load_state_dict(saved["model"])
        resume_epoch = saved["epoch"] + 1
        say(f"resumed from epoch {saved['epoch']}")
    optimizer = trainer.make_optimizer(model, cfg, steps_per_epoch,
                                       resume_epoch)
    if saved is not None and "adam" in saved:
        optimizer.adam.load_state_dict(saved["adam"])
    elif saved is not None and "jax" in saved:
        if "opt_state" not in saved["jax"]:
            raise ValueError(f"the Orbax checkpoint under {ckpt_dir} holds "
                             f"no optimizer state to resume")
        trainer.load_jax_opt_state(optimizer, saved["jax"]["opt_state"])
    if args.load_score_path:
        merge_checkpoint_modules(model, args.load_score_path, ["score_net"])
    if args.load_region_path:
        merge_checkpoint_modules(model, args.load_region_path,
                                 ["grn_head", "refine_head"])

    def with_center_num(base, nc):
        return dataclasses.replace(base, region=dataclasses.replace(
            base.region, center_num=nc))

    train_cfgs = [cfg]
    if args.center_jitter:
        jitter = [int(v) for v in args.center_jitter.split(",") if v]
        train_cfgs = [with_center_num(cfg, v) for v in jitter]
        say(f"center_num jitter over {jitter}")
    eval_cfg = exact_cfg
    if args.eval_center_num:
        eval_cfg = with_center_num(exact_cfg, args.eval_center_num)
        say(f"validation forwards at center_num={args.eval_center_num}")

    # validation forwards run a model of their own, built for `eval_cfg`
    # (SA1 keeps its FPS grouping from the configuration it was built
    # for), with the training model's weights copied in before each epoch
    eval_model = (model if eval_cfg == cfg and not args.center_jitter
                  else build_model(eval_cfg, args.seed, device))
    result = {"model": model, "optimizer": optimizer, "cfg": cfg,
              "eval_cfg": eval_cfg, "steps": [], "epochs": [],
              "validation": [], "grasp_records": [], "trace": None}

    # the grasp evaluation spreads one scene per device where there are
    # several (JAX `cli/train.py:311`); rank 0 runs it over every card
    eval_devices = list(devices) if len(devices) > 1 else None

    def run_eval_epoch(logger, epoch, mode_name, ds, with_grasps=True):
        from regnet_for_3d_grasping_torch.data import load_scene
        from regnet_for_3d_grasping_torch.eval.evaluator import (
            EvalRecord, evaluate_scene_grasps, view_num_from_path)
        from regnet_for_3d_grasping_torch.eval.parallel_eval import (
            evaluate_scenes_sharded)
        from regnet_for_3d_grasping_torch.utils.export import (
            extract_grasp_sets)
        if eval_model is not model:
            eval_model.load_state_dict(model.state_dict())
        grasps_on = args.eval_grasps and with_grasps and stage != "score"
        names = ("stage2", "stage3_class", "stage3_score")
        records = dict.fromkeys(names, EvalRecord())
        pending = {name: [] for name in names}
        g = cfg.gripper

        def flush(name):
            """The pending scenes of a stage, one per device, a call for
            each gripper width."""
            items, pending[name] = pending[name], []
            for w in sorted({it[4] for it in items}):
                sel = [it for it in items if it[4] == w]
                for rec in evaluate_scenes_sharded(
                        eval_devices, [it[0] for it in sel],
                        [it[1] for it in sel], [it[2] for it in sel],
                        [it[5] for it in sel], [it[3] for it in sel], w, g,
                        cfg.eval):
                    records[name] = records[name].add(rec)

        for n, batch in enumerate(ds.batches(1, seed=epoch, shuffle=False,
                                             augment=False)):
            gen = torch.Generator().manual_seed(epoch * 10007 + n)
            out, metrics = trainer.eval_step(
                eval_model, trainer.device_batch(batch, device), stage,
                generator=gen)
            logger.scalars(metrics, n + epoch * len(ds), mode_name, "batch")
            result["validation"].append(host_scalars(metrics))
            if not grasps_on:
                continue
            sets = extract_grasp_sets(out)[0]
            data = load_scene(batch.paths[0])
            try:
                view = view_num_from_path(batch.paths[0])
            except ValueError:
                view = 0
            # scenes of a randomized layout carry their own table height
            tz = float(data.get("table_height", g.table_height))
            for name, key in zip(names, ("grasp_stage2", "grasp_stage3",
                                         "grasp_stage3_score")):
                grasps = sets[key]
                if len(grasps) == 0:
                    continue
                depths = np.full(len(grasps), g.depth, np.float32)
                width = float(batch.width[0])
                if eval_devices is None:
                    records[name] = records[name].add(evaluate_scene_grasps(
                        data, grasps, view, tz, depths, width, g, cfg.eval,
                        device=device))
                    continue
                pending[name].append((data, grasps, view, depths, width, tz))
                if len(pending[name]) >= len(eval_devices):
                    flush(name)
        if eval_devices is not None:
            for name in names:
                flush(name)
        if grasps_on:
            result["grasp_records"].append(
                {"epoch": epoch, "mode": mode_name, "records": records})
        for name, rec in records.items():
            if rec.formal > 0:
                logger.scalar(f"epoch_{mode_name}_{name}_vgr", rec.vgr, epoch)
                logger.scalar(f"epoch_{mode_name}_{name}_score", rec.score,
                              epoch)
                logger.scalar(f"epoch_{mode_name}_{name}_vgr_before",
                              rec.vgr_before, epoch)
                print(f"[{mode_name} {epoch}] {name}: vgr={rec.vgr:.3f} "
                      f"score={rec.score:.3f}")

    native = None
    if args.native_loader and is_train:
        from regnet_for_3d_grasping_torch.data.native_loader import (
            NativeLoader, convert_dataset)
        rsc = convert_dataset(train_ds.paths,
                              os.path.join(args.data_path, "rsc_cache"))
        native = NativeLoader(rsc, batch_size, args.num_points,
                              cfg.region.max_gt_grasps, seed=args.seed)
        say(f"native loader over {len(rsc)} cached scenes")

    def epoch_batches(epoch):
        from regnet_for_3d_grasping_torch.data import augment
        from regnet_for_3d_grasping_torch.eval.evaluator import (
            CAMERA_POSE, view_num_from_path)
        # one augmentation stream an epoch: a resumed run replays the
        # stream of an uninterrupted one
        geom_rng = np.random.RandomState(args.seed + 7919 + epoch)
        batches = ((native.next_batch() for _ in range(steps_per_epoch))
                   if native is not None
                   else train_ds.batches(batch_size, seed=epoch))
        for b in batches:
            if args.geom_aug:
                cams = np.stack([CAMERA_POSE[view_num_from_path(p)]
                                 for p in b.paths])
                b = augment.augment_batch(b, geom_rng, args.geom_aug, cams)
            yield b

    prof = None

    def profile_stop(epoch):
        nonlocal prof
        _sync(device)
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, f"trace_epoch{epoch}.json")
        prof.export_chrome_trace(path)
        prof, result["trace"] = None, path
        print(f"profiler trace written to {path}")

    with (MetricLogger(args.log_path, args.tag) if main_rank
          else _Silent()) as logger:
        if not is_train:
            run_eval_epoch(logger, resume_epoch, args.mode, val_ds)
            return result

        drop_gen = torch.Generator(device=device)
        for epoch in range(resume_epoch, args.epoch):
            t_epoch = time.time()
            total, nb = 0.0, 0
            # read once an epoch: on the card the count syncs
            fallbacks = _cuda.fallbacks["fp3_slab"]
            for batch in epoch_batches(epoch):
                if args.profile_dir and epoch == resume_epoch and main_rank:
                    if nb == 3 and prof is None:
                        acts = [torch.profiler.ProfilerActivity.CPU]
                        if device.type == "cuda":
                            acts.append(torch.profiler.ProfilerActivity.CUDA)
                        prof = torch.profiler.profile(activities=acts)
                        prof.start()
                    elif nb == 8 and prof is not None:
                        profile_stop(epoch)
                _sync(device)
                t0 = time.perf_counter()
                seed = epoch * 131071 + nb
                if mesh is not None:
                    # this rank's contiguous shard, its seed folded by its
                    # shard index (JAX `trainer.py:109-116`)
                    batch = shard_batch(batch, mesh.size, mesh.shard_index)
                    seed = fold_seed(seed, mesh.shard_index)
                gen = torch.Generator().manual_seed(seed)
                drop_gen.manual_seed(seed)
                step = epoch * steps_per_epoch + nb
                # the jittered configurations differ in center_num alone,
                # which is read at every forward and built into no module
                model.cfg = train_cfgs[step % len(train_cfgs)]
                metrics = trainer.train_step(
                    model, optimizer, trainer.device_batch(batch, device),
                    stage, mesh, generator=gen, dropout_generator=drop_gen)
                logger.scalars(metrics, step, "train", "batch")
                loss = float(metrics["loss_total"])
                _sync(device)
                dt = time.perf_counter() - t0
                result["steps"].append({"epoch": epoch, "loss": loss,
                                        "seconds": dt})
                total += loss
                nb += 1
                say(f"train epoch {epoch} [{nb}/{steps_per_epoch}] "
                    f"loss {loss:.4f} ({dt:.3f}s)")
            if prof is not None:
                profile_stop(epoch)
            logger.scalar("epoch_train_loss", total / max(nb, 1), epoch)
            note = ""
            if args.slab_cell > 0.0:
                fallbacks = _cuda.fallbacks["fp3_slab"] - fallbacks
                logger.scalar("epoch_fp3_slab_fallbacks", fallbacks, epoch)
                note = f", {fallbacks} steps' slab 3-NN fell back"
            say(f"epoch {epoch}: mean loss {total / max(nb, 1):.4f} "
                f"({time.time() - t_epoch:.1f}s{note})")
            if main_rank:
                ckpt.save_checkpoint(ckpt_dir, epoch, model, optimizer)
                t_val = time.perf_counter()
                run_eval_epoch(logger, epoch, "validate", val_ds,
                               with_grasps=(epoch % max(args.eval_every, 1)
                                            == 0 or epoch == args.epoch - 1))
                result["epochs"].append({
                    "epoch": epoch, "seconds": time.time() - t_epoch,
                    "validate_seconds": time.perf_counter() - t_val})
            if mesh is not None:
                # the other ranks wait on the host while rank 0 validates:
                # its grasp evaluation runs on their cards too
                mesh.host_barrier()
    if native is not None:
        native.close()
    return result


if __name__ == "__main__":
    main()
