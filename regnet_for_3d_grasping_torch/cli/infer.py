"""Inference CLI of the PyTorch port (JAX ``cli/infer.py``).

Runs the cascade on .p (virtual) or .pcd (real) clouds, one at a time, and
writes the JAX CLI's prediction pickle:
  {points, colors, scores, grasp_stage2, grasp_stage3_stage2,
   grasp_stage3, grasp_stage3_score}
next to the input, with ``_data`` replaced by ``_data_predict`` in the path.
Each grasp set holds the grasps that survive the evaluator's view
collision filter on the cloud as loaded (`eval.evaluator.eval_test`, on
the model's device), as the JAX CLI writes them; ``--no-eval`` keeps every
grasp.  Every cloud's forward draws its seeds from a generator seeded with
``--seed`` anew, as the JAX CLI hands ``PRNGKey(seed)`` to each.

``scores`` holds the model's per-point scores in the model's row order
(slab order with ``--slab-cell``), beside the input cloud as loaded: the
JAX CLI writes the two the same way and pairs them nowhere.

``--center-select``, ``--center-min-z``, ``--pose-search`` and
``--refine-guard`` are the JAX CLI's serving knobs (its
``cli/infer.py:67-89``).

``--dp`` serves one cloud per device over every visible card (JAX
``cli/infer.py:179-236``): a worker process per card holds the model
(`parallel.infer.make_dp_inference`), the clouds go in chunks of W, cloud
i of a chunk to card i with the seed ``fold_seed(seed, i)``, a partial
last chunk padded with its first cloud (the padded outputs dropped), and
each worker runs its cloud's view filter on its card.  Each cloud's line
carries the chunk's wall time and ``({n} clouds)``.  A worker that fails
ends the run with an error; ``--dp`` never continues on fewer cards or on
the CPU (``--device cpu --dp`` asks for one CPU worker).

``--fast`` is the JAX package's serving configuration of record: bf16
network compute with f32 geometry, the sorted slab (cell 0.04) and grouped
FPS (G = 8); ``--bf16`` alone is bf16 on the full scan.  ``--slab-cell``
and ``--fps-groups`` override what ``--fast`` derives, as in the JAX CLI.

Usage:
  python -m regnet_for_3d_grasping_torch.cli.infer [--no-eval] \\
      --folder-name /path/to/virtual_data \\
      --checkpoint weights/r5_real_e100.npz [--fast | --bf16]
      (or --checkpoint <JAX Orbax tag directory or its ckpt_N>)
      [--slab-cell 0.04 --fps-groups 8] [--center-min-z 0.75] \\
      [--pose-search 8] [--refine-guard] [--center-select bucket] [--dp]
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="REGNet inference (PyTorch)")
    p.add_argument("--folder-name", type=str, default="")
    p.add_argument("--file-name", type=str, default="")
    p.add_argument("--checkpoint", type=str, default="",
                   help="weights npz (weights/*.npz) or the JAX package's "
                        "Orbax checkpoint (a tag directory, latest epoch, "
                        "or one ckpt_N directory); random init if empty")
    p.add_argument("--center-num", type=int, default=4000)
    p.add_argument("--group-num-more", type=int, default=2048,
                   help="wide-region points (the JAX CLI's flag; no model "
                        "path reads it)")
    p.add_argument("--all-points-num", type=int, default=25600)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--no-eval", action="store_true",
                   help="skip the view collision filter (raw grasp "
                        "sets)")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel serving: one cloud per visible card, "
                        "a worker process each (parallel/infer.py)")
    p.add_argument("--accept-margin", type=float, default=0.0)
    p.add_argument("--num-refine", type=int, default=1)
    p.add_argument("--refine-pose", default="full",
                   choices=["full", "center", "off"])
    p.add_argument("--center-select", default="fps",
                   choices=["fps", "bucket"],
                   help="center selection (region.center_select): 'bucket' "
                        "takes the best score in each index bucket, with no "
                        "sequential FPS loop")
    p.add_argument("--center-min-z", type=float, default=None,
                   help="keep the centers above this z (region."
                        "center_min_z), e.g. the evaluation protocol's table "
                        "plane where the real table lies below it")
    p.add_argument("--pose-search", type=int, default=0,
                   help="try K theta variants per proposal and serve the "
                        "one nearest the prediction that survives the view "
                        "collision funnel (region.pose_search_k; 0 = off)")
    p.add_argument("--refine-guard", action="store_true",
                   help="serve the stage-2 pose where the refined pose fails "
                        "the view collision funnel and the stage-2 pose "
                        "survives it (region.refine_guard)")
    add_serving_flags(p)
    return p


def add_serving_flags(p) -> None:
    """The flags that pick the serving configuration and the device (the
    suite CLI's too)."""
    p.add_argument("--bf16", action="store_true",
                   help="bf16 network compute (geometry stays f32)")
    p.add_argument("--fast", action="store_true",
                   help="the serving configuration of record: bf16 + "
                        "sorted slab (cell 0.04) + stratified FPS (G = 8)")
    p.add_argument("--slab-cell", type=float, default=-1.0,
                   help="sorted-slab cell in meters (0 = exact full scans; "
                        "default: 0.04 with --fast, else 0)")
    p.add_argument("--fps-groups", type=int, default=-1,
                   help="stratified-FPS groups at SA1 and the center "
                        "selection (1 = exact; default: 8 with --fast, "
                        "else 1)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")


def serving_overrides(args) -> dict:
    """The configuration overrides of `add_serving_flags`' flags, derived
    as the JAX CLI derives them (``cli/infer.py:148-167``)."""
    slab_cell = args.slab_cell if args.slab_cell >= 0.0 else \
        (0.04 if args.fast else 0.0)
    fps_groups = args.fps_groups if args.fps_groups >= 1 else \
        (8 if args.fast else 1)
    return {"region.slab_cell": slab_cell,
            "region.center_fps_groups": fps_groups,
            "model.fps_groups": fps_groups,
            "model.compute_dtype": ("bfloat16" if args.bf16 or args.fast
                                    else "float32")}


def config_from_args(args):
    """The inference configuration the flags ask for."""
    from regnet_for_3d_grasping_torch.config import infer_config
    return infer_config(**{
        "region.center_num": args.center_num,
        "region.group_num_more": args.group_num_more,
        "region.num_points": args.all_points_num,
        "region.accept_margin": args.accept_margin,
        "region.refine_iters": args.num_refine,
        "region.refine_pose": args.refine_pose,
        "region.center_select": args.center_select,
        "region.center_min_z": args.center_min_z,
        "region.pose_search_k": args.pose_search,
        "region.refine_guard": args.refine_guard,
        **serving_overrides(args),
    })


def load_cloud(pc_path: str, all_points_num: int,
               rng: np.random.RandomState):
    """Load one cloud and resample it as the JAX CLI does (the same
    RandomState draws give the same points)."""
    from regnet_for_3d_grasping_torch.utils import pcd as pcdio

    real = pc_path.endswith(".pcd")
    if real:
        pts, colors = pcdio.read_pcd(pc_path)
        pts = pcdio.transform_points(pcdio.camera_to_global_transform(), pts)
        pc = np.c_[pts, colors]
        pc = pc[(pc[:, 0] < 0.26) & (pc[:, 0] > -0.4) & (pc[:, 2] < 1)
                & (pc[:, 1] < 0.65) & (pc[:, 1] > 0.2)]
    else:
        with open(pc_path, "rb") as f:
            data = pickle.load(f)
        pc = np.c_[data["view_cloud"].astype(np.float32),
                   data["view_cloud_color"].astype(np.float32)]
    pc_back, color_back = pc[:, :3].copy(), pc[:, 3:6].copy()
    pc = pc.copy()
    pc[:, 3:6] *= (1 - rng.rand(3) / 5)     # color noise
    sel = rng.choice(len(pc), all_points_num,
                     replace=len(pc) < all_points_num)
    return pc[sel].astype(np.float32), pc_back, color_back, real


def main(argv=None, devices=None) -> list:
    """Returns one record per cloud: path, forward seconds (synchronized
    on the device; with ``--dp`` the chunk's wall time, ``chunk`` its
    clouds), the model output and the grasp sets written.  `devices`:
    the devices ``--dp`` spreads over (default: every visible card of
    ``--device``, `parallel.mesh.visible_devices`)."""
    args = build_parser().parse_args(argv)

    from regnet_for_3d_grasping_torch.utils.cache import (
        enable_compilation_cache)
    enable_compilation_cache()

    from regnet_for_3d_grasping_torch.eval.evaluator import eval_test
    from regnet_for_3d_grasping_torch.models.regnet import build_regnet
    from regnet_for_3d_grasping_torch.utils.export import extract_grasp_sets

    cfg = config_from_args(args)
    if args.file_name:
        paths = [os.path.join(args.folder_name, args.file_name)]
    else:
        paths = sorted(glob.glob(os.path.join(args.folder_name, "*.p"))
                       + glob.glob(os.path.join(args.folder_name, "*.pcd")))
    if not paths:
        raise SystemExit(f"no input clouds under {args.folder_name!r}")
    if args.dp:
        return _serve_dp(args, cfg, paths, devices)

    torch.manual_seed(args.seed)          # random init without weights
    model = build_regnet(cfg, args.checkpoint or None, args.device)
    device = next(model.parameters()).device
    if args.checkpoint:
        print(f"loaded weights from {args.checkpoint}")

    rng = np.random.RandomState(args.seed)
    records = []
    for pc_path in paths:
        pc, pc_back, color_back, real = load_cloud(
            pc_path, args.all_points_num, rng)
        x = torch.from_numpy(pc)[None].to(device)
        gen = torch.Generator().manual_seed(args.seed)
        _sync(device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(x, generator=gen)
        _sync(device)
        dt = time.perf_counter() - t0
        sets = extract_grasp_sets(out)[0]
        print(f"{pc_path}: forward {dt:.4f}s, "
              f"{len(sets['grasp_stage2'])} stage2 / "
              f"{len(sets['grasp_stage3'])} stage3 grasps")
        if not args.no_eval:
            g = cfg.gripper
            sets = {k: eval_test(pc_back, v, None, g.table_height, g.depth,
                                 g.width, g, cfg.eval, device=device)
                    for k, v in sets.items()}
        _write_prediction(pc_path, real, pc_back, color_back,
                          out.score[0], sets)
        records.append({"path": pc_path, "forward_s": dt, "out": out,
                        "sets": sets})
    return records


def _serve_dp(args, cfg, paths, devices) -> list:
    """``--dp``: the clouds in chunks of W over W worker processes."""
    from regnet_for_3d_grasping_torch.parallel.infer import make_dp_inference
    from regnet_for_3d_grasping_torch.parallel.mesh import visible_devices

    devices = list(devices) if devices is not None else \
        visible_devices(args.device)
    group = len(devices)
    print(f"data-parallel serving over {group} device(s)")
    rng = np.random.RandomState(args.seed)
    records = []
    with make_dp_inference(cfg, args.checkpoint or None, devices,
                           init_seed=args.seed) as fwd:
        if args.checkpoint:
            print(f"loaded weights from {args.checkpoint}")
        for start in range(0, len(paths), group):
            chunk = paths[start:start + group]
            loaded = [load_cloud(p, args.all_points_num, rng) for p in chunk]
            x = np.stack([l[0] for l in loaded])
            backs = [None if args.no_eval else l[1] for l in loaded]
            if len(chunk) < group:     # pad the final partial chunk
                pad = group - len(chunk)
                x = np.concatenate([x, np.repeat(x[:1], pad, 0)])
                backs += [None] * pad
            t0 = time.perf_counter()
            shards = fwd(x, args.seed, eval_clouds=backs)
            dt = time.perf_counter() - t0
            for (pc_path, (_, pc_back, color_back, real)), shard in zip(
                    zip(chunk, loaded), shards):
                out = shard["out"]
                sets = shard["sets"][0]
                print(f"{pc_path}: forward {dt:.4f}s ({len(chunk)} clouds), "
                      f"{len(sets['grasp_stage2'])} stage2 / "
                      f"{len(sets['grasp_stage3'])} stage3 grasps")
                _write_prediction(pc_path, real, pc_back, color_back,
                                  out.score[0], sets)
                records.append({"path": pc_path, "forward_s": dt,
                                "chunk": len(chunk), "out": out,
                                "sets": sets,
                                "device_forward_s": shard["forward_s"],
                                "launches": shard["launches"]})
    return records


def _write_prediction(pc_path, real, pc_back, color_back, score, sets):
    """The prediction pickle beside the input (``_data`` ->
    ``_data_predict``)."""
    out_path = pc_path.replace("_data", "_data_predict")
    if real:
        out_path = out_path.replace(".pcd", ".p")
    if out_path == pc_path:     # never overwrite the input
        out_path = os.path.splitext(pc_path)[0] + "_predict.p"
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump({"points": pc_back, "colors": color_back,
                     "scores": score.cpu().numpy().reshape(-1, 1),
                     **{k: np.asarray(v, np.float32)
                        for k, v in sets.items()}}, f)
    print(f"  -> {out_path}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()
