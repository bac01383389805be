"""Data-parallel scaling over the visible cards.

    python -m regnet_for_3d_grasping_torch.cli.scaling [--clouds 24]
        [--scenes 90] [--parts serving,training,eval] [--out scaling.json]

Serving: `--clouds` tabletop clouds (``utils/scene.tabletop_cloud``, 25,600
points) with ``weights/r5_real_e100.npz``, full scan f32 and ``--fast``:
the solo loop of the infer CLI (one process, one card), then
`parallel.infer.make_dp_inference` over W = 1, 2, 4, ... cards (up to the
visible count), a chunk of W clouds at a time after one warm-up chunk;
each chunk's wall time (forwards and transfer, no view filter), clouds/s,
the workers' synchronized forwards and what they do after them (the grasp
sets and the reply's serialization).

Training: the train CLI at batch 12 on `--scenes` synthetic scenes (80 %
train), one epoch, full scan f32 and ``--bf16 --slab-cell 0.04
--fps-groups 8``, on W = 1 (the one-card CLI), 2, 4, ... cards: each
card's step times, scenes/s from the median step after the first, each
step's averaging collectives in milliseconds (CUDA events around
`train.trainer.average_over_mesh`, `Mesh.timed`: the wait for the slowest
rank included; the median after the first step) and each card's peak
memory.

Evaluation: the train CLI with ``--eval-grasps --eval-every 1`` for
`EVAL_EPOCHS` epochs on the same scenes, full scan f32, on one card
(scene by scene) and over every card (rank 0's grasp evaluation one scene
a card while the other ranks wait on the host): each epoch's seconds
(training, checkpoint, validation forwards and grasp evaluation) and its
validation's.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
WEIGHTS = ROOT / "weights" / "r5_real_e100.npz"
N_POINTS, BATCH = 25600, 12
EVAL_EPOCHS = 3
PARTS = ("serving", "training", "eval")


def clouds(n: int) -> np.ndarray:
    """n tabletop clouds [n, N, 6], resampled as the infer CLI resamples."""
    from regnet_for_3d_grasping_torch.utils.scene import tabletop_cloud
    out = []
    for i in range(n):
        rs = np.random.RandomState(100 + i)
        xyz, rgb = tabletop_cloud(rs)
        pc = np.c_[xyz, rgb]
        sel = rs.choice(len(pc), N_POINTS, replace=len(pc) < N_POINTS)
        out.append(pc[sel].astype(np.float32))
    return np.stack(out)


def widths(n_cards: int) -> list:
    return [w for w in (1, 2, 4, 8) if w <= n_cards]


def serving(pcs: np.ndarray, devices: list) -> dict:
    from regnet_for_3d_grasping_torch.cli import infer
    from regnet_for_3d_grasping_torch.models.regnet import build_regnet
    from regnet_for_3d_grasping_torch.parallel.infer import make_dp_inference
    out = {}
    for label, flags in (("full scan f32", []), ("fast", ["--fast"])):
        cfg = infer.config_from_args(infer.build_parser().parse_args(flags))
        model = build_regnet(cfg, str(WEIGHTS), devices[0])
        ms = []
        with torch.inference_mode():
            for i in range(len(pcs) + 1):          # the first warms up
                x = torch.from_numpy(pcs[i % len(pcs)])[None].to(devices[0])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(x, generator=torch.Generator().manual_seed(1))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        del model
        torch.cuda.empty_cache()
        rows = {"solo": {"forward_ms": ms[1:],
                         "clouds_per_s": 1e3 * len(pcs) / sum(ms[1:])}}
        print(f"serving {label}, solo: median forward "
              f"{statistics.median(ms[1:]):.3f} ms, "
              f"{rows['solo']['clouds_per_s']:.2f} clouds/s")
        for w in widths(len(devices)):
            with make_dp_inference(cfg, str(WEIGHTS), devices[:w]) as fwd:
                fwd(pcs[:w], 1)                      # warm-up chunk
                walls, fwd_ms, post_ms = [], [], []
                for start in range(0, len(pcs) - w + 1, w):
                    t0 = time.perf_counter()
                    shards = fwd(pcs[start:start + w], 1)
                    walls.append(time.perf_counter() - t0)
                    fwd_ms += [s["forward_s"] * 1e3 for s in shards]
                    post_ms += [s["post_s"] * 1e3 for s in shards]
            n = len(walls) * w
            rows[f"dp{w}"] = {"chunk_s": walls, "worker_forward_ms": fwd_ms,
                              "worker_post_ms": post_ms,
                              "clouds_per_s": n / sum(walls)}
            print(f"serving {label}, --dp over {w}: median chunk "
                  f"{statistics.median(walls) * 1e3:.3f} ms, "
                  f"{rows[f'dp{w}']['clouds_per_s']:.2f} clouds/s, median "
                  f"worker forward {statistics.median(fwd_ms):.3f} ms, "
                  f"after it {statistics.median(post_ms):.3f} ms (the sets "
                  f"and the reply)")
        out[label] = rows
    return out


def training(data: str, devices: list, tmp: str) -> dict:
    from regnet_for_3d_grasping_torch.cli import train as train_cli
    out = {}
    slab = ["--slab-cell", "0.04", "--fps-groups", "8"]
    for label, flags in (("full scan f32", []),
                         ("slab bf16", ["--bf16", *slab])):
        rows = {}
        for w in widths(len(devices)):
            argv = ["--mode", "train", "--data-path", data, "--model-path",
                    os.path.join(tmp, "models"), "--log-path",
                    os.path.join(tmp, "log"), "--tag", f"w{w}",
                    "--batch-size", str(BATCH), "--epoch", "1", "--seed",
                    "1", *flags]
            torch.cuda.reset_peak_memory_stats(devices[0])
            res = train_cli.main(argv, devices=devices[:w])
            if w == 1:
                ranks = [{"seconds": [s["seconds"] for s in res["steps"]],
                          "peak_bytes": torch.cuda.max_memory_allocated(
                              devices[0]), "collective_ms": [0.0, 0.0]}]
            else:
                ranks = res["ranks"]
            med = statistics.median(ranks[0]["seconds"][1:])
            # after the first step, whose collectives start NCCL
            coll = [statistics.median(r["collective_ms"][1:]) for r in ranks]
            del res
            torch.cuda.empty_cache()    # the next run's rank 0 shares card 0
            rows[f"w{w}"] = {
                "step_ms_by_card": [[x * 1e3 for x in r["seconds"]]
                                    for r in ranks],
                "median_step_ms": med * 1e3,
                "scenes_per_s": BATCH / med,
                "collective_ms_by_card": [r["collective_ms"] for r in ranks],
                "median_collective_ms_by_card": coll,
                "peak_gib_by_card": [r["peak_bytes"] / 2**30
                                     for r in ranks]}
            print(f"training {label} over {w} card(s): median step "
                  f"{med * 1e3:.3f} ms (after the first), "
                  f"{BATCH / med:.2f} scenes/s; averaging collectives "
                  f"{[round(c, 3) for c in coll]} ms a step by card (median "
                  f"after the first); peak "
                  f"{[round(r['peak_bytes'] / 2**30, 3) for r in ranks]} "
                  f"GiB by card")
        out[label] = rows
    return out


def eval_epochs(data: str, devices: list, tmp: str) -> dict:
    from regnet_for_3d_grasping_torch.cli import train as train_cli
    out = {}
    for w in sorted({1, len(devices)}):
        argv = ["--mode", "train", "--data-path", data, "--model-path",
                os.path.join(tmp, "models"), "--log-path",
                os.path.join(tmp, "log"), "--tag", f"eval_w{w}",
                "--batch-size", str(BATCH), "--epoch", str(EVAL_EPOCHS),
                "--seed", "1", "--eval-grasps", "--eval-every", "1"]
        res = train_cli.main(argv, devices=devices[:w])
        epochs = [{k: e[k] for k in ("seconds", "validate_seconds")}
                  for e in res["epochs"]]
        records = [{s: tuple(r) for s, r in g["records"].items()}
                   for g in res["grasp_records"]]
        del res
        torch.cuda.empty_cache()
        out[f"w{w}"] = {"epochs": epochs, "grasp_records": records}
        print(f"evaluation epochs over {w} card(s): epoch s "
              f"{[round(e['seconds'], 3) for e in epochs]}, of which "
              f"validation {[round(e['validate_seconds'], 3) for e in epochs]}"
              f"; records {records}")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clouds", type=int, default=24)
    p.add_argument("--scenes", type=int, default=90)
    p.add_argument("--parts", default=",".join(PARTS),
                   help="which of serving, training, eval to run")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        p.error(f"--parts takes {', '.join(PARTS)}")
    from regnet_for_3d_grasping_torch.data import write_synthetic_dataset
    from regnet_for_3d_grasping_torch.ops import _cuda
    from regnet_for_3d_grasping_torch.parallel.mesh import visible_devices
    devices = visible_devices("cuda")
    _cuda.build()
    result = {"devices": len(devices),
              "card": torch.cuda.get_device_name(0)}
    if "serving" in parts:
        result["serving"] = serving(clouds(args.clouds), devices)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "scenes")
        write_synthetic_dataset(data, args.scenes, num_view=N_POINTS)
        for part, run in (("training", training), ("eval", eval_epochs)):
            if part in parts:
                result[part] = run(data, devices, tmp)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
