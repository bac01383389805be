"""Quality metrics on the frozen benchmark suite (the port's counterpart of
the JAX package's ``tools/benchmark_eval.py`` suite path).

Every scene of the versioned suite (``data/benchmark_suite.py``) is
generated and checked against its committed SHA-256 fingerprint, run once
through the configured forward, and its stage-2, stage-3 and
stage-3-score grasp sets are evaluated with
`eval.evaluator.evaluate_scene_grasps` on the scene's view cloud and its
dense scene cloud with the committed normals (``scene_normal``).  The
output has the JAX tool's layout: ``summary`` per regime and stage (vgr,
vgr_before, antipodal, n_grasps), ``per_scene`` and ``config``.

Seeds: scene ``i`` draws its forward's seeds from ``torch.Generator``
seeded with ``7000 + i``, the JAX tool's per-scene seed through the port's
generator: the draws are not JAX's threefry keys, so centers, groups and
crops are other random picks than the TPU run's.

Usage (on the card; ``--device cpu`` runs the plain versions):
  python -m regnet_for_3d_grasping_torch.cli.benchmark_eval \\
      --checkpoint weights/r4_coherent_e100.npz [--fast | --bf16]
      [--slab-cell 0.04 --fps-groups 8] [--out metrics.json]
  python -m regnet_for_3d_grasping_torch.cli.benchmark_eval --verify-only
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

STAGES = {"stage2": "grasp_stage2", "stage3": "grasp_stage3",
          "stage3_score": "grasp_stage3_score"}
SEED_BASE = 7000


def build_parser():
    from regnet_for_3d_grasping_torch.cli.infer import add_serving_flags
    p = argparse.ArgumentParser(description="REGNet suite metrics (PyTorch)")
    p.add_argument("--checkpoint", default="weights/r4_coherent_e100.npz",
                   help="weights npz")
    p.add_argument("--center-num", type=int, default=4000)
    p.add_argument("--verify-only", action="store_true",
                   help="check every scene's fingerprint and stop")
    p.add_argument("--out", default="",
                   help="write the metrics JSON here (default: print the "
                        "summary only)")
    add_serving_flags(p)
    return p


def _power_limit(device: torch.device):
    """The card's power limit as nvidia-smi prints it (None off the
    card, or where nvidia-smi does not answer)."""
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> dict:
    """Returns the metrics dict (also written to ``--out``)."""
    args = build_parser().parse_args(argv)
    from regnet_for_3d_grasping_torch.data.benchmark_suite import (
        SUITE_VERSION, generate_scene, load_fingerprints, suite_specs,
        verify_scene)

    specs = suite_specs(SUITE_VERSION)
    fps = load_fingerprints(SUITE_VERSION)
    if fps["suite_version"] != SUITE_VERSION:
        raise RuntimeError(f"fingerprint file is suite v"
                           f"{fps['suite_version']}, not v{SUITE_VERSION}")
    if args.verify_only:
        for spec in specs:
            verify_scene(spec, generate_scene(spec), fps)
        print(f"suite v{SUITE_VERSION}: all {len(specs)} scene fingerprints "
              f"verified")
        return {"verified": len(specs)}

    from regnet_for_3d_grasping_torch.cli.infer import serving_overrides
    from regnet_for_3d_grasping_torch.config import infer_config
    from regnet_for_3d_grasping_torch.eval.evaluator import (
        EvalRecord, evaluate_scene_grasps)
    from regnet_for_3d_grasping_torch.models.regnet import build_regnet
    from regnet_for_3d_grasping_torch.utils.export import extract_grasp_sets
    from regnet_for_3d_grasping_torch.weights import read_npz

    cfg = infer_config(**{"region.center_num": args.center_num,
                          **serving_overrides(args)})
    model = build_regnet(cfg, args.checkpoint, args.device)
    device = next(model.parameters()).device
    epoch = read_npz(args.checkpoint)[1]
    g = cfg.gripper

    per_scene, seconds = {}, {"forward": [], "eval": []}
    totals = {r: {s: EvalRecord() for s in STAGES}
              for r in ("sparse", "clutter")}
    for i, spec in enumerate(specs):
        scene = generate_scene(spec)
        verify_scene(spec, scene, fps)
        pc = np.c_[scene["view_cloud"], scene["view_cloud_color"]].astype(
            np.float32)
        x = torch.from_numpy(pc)[None].to(device)
        gen = torch.Generator().manual_seed(SEED_BASE + i)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(x, generator=gen)
        sets = extract_grasp_sets(out)[0]
        t1 = time.perf_counter()
        row = {}
        for sname, skey in STAGES.items():
            grasps = sets[skey]
            rec = EvalRecord() if len(grasps) == 0 else evaluate_scene_grasps(
                scene, grasps, spec["view_index"], g.table_height,
                np.full(len(grasps), g.depth, np.float32), g.width, g,
                cfg.eval, device=device)
            totals[spec["regime"]][sname] = \
                totals[spec["regime"]][sname].add(rec)
            row[sname] = {"vgr": round(rec.vgr, 4),
                          "antipodal": round(rec.score, 4),
                          "n_grasps": int(rec.formal)}
        seconds["forward"].append(t1 - t0)
        seconds["eval"].append(time.perf_counter() - t1)
        per_scene[spec["name"]] = row
        print(f"{spec['name']:12s} stage3_score: vgr="
              f"{row['stage3_score']['vgr']:.3f} "
              f"n={row['stage3_score']['n_grasps']}")

    summary = {}
    for regime, recs in totals.items():
        summary[regime] = {
            s: {"vgr": round(r.vgr, 4), "vgr_before": round(r.vgr_before, 4),
                "antipodal": round(r.score, 4), "n_grasps": int(r.formal)}
            for s, r in recs.items()}
        print(f"[{regime}] stage3_score VGR {recs['stage3_score'].vgr:.4f} "
              f"antipodal {recs['stage3_score'].score:.4f} over "
              f"{int(recs['stage3_score'].formal)} grasps")
    result = {
        "suite_version": SUITE_VERSION,
        "checkpoint": args.checkpoint,
        "epoch": epoch,
        "config": {"center_num": args.center_num,
                   "fps_groups": cfg.model.fps_groups,
                   "center_fps_groups": cfg.region.center_fps_groups,
                   "slab_cell": cfg.region.slab_cell,
                   "dtype": "bf16" if cfg.model.compute_dtype == "bfloat16"
                   else "f32",
                   "normals": "precomputed(scene_normal)",
                   "backend": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
                   "power_limit": _power_limit(device),
                   "torch": torch.__version__,
                   "seeds": f"torch.Generator().manual_seed({SEED_BASE} + "
                            f"scene index), not JAX's threefry "
                            f"PRNGKey({SEED_BASE} + i)"},
        "seconds": {k: sum(v) for k, v in seconds.items()},
        "summary": summary,
        "per_scene": per_scene,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, sort_keys=True)
        print(f"wrote {args.out}")
    else:
        print(json.dumps(summary, indent=1))
    return result


if __name__ == "__main__":
    main()
