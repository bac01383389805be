"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is printed as a
result unless every phase passed):

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off;
2. build: the five CUDA kernels from ``regnet_for_3d_grasping_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the inference path (25,600 points, 4,000 centers), with their median
   times, a bound computed from the shapes, and a library call where one
   computes the same function;
4. the main path: the port's infer CLI on 3 tabletop clouds with the
   trained weights (``weights/r5_real_e100.npz``), the kernel launch
   counters reset just before and read just after;
5. one of those clouds again on the CPU through the plain versions,
   compared with the card's output.

The last lines are the kernels' JSON, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_POINTS, N_CENTERS = 25600, 4000
WEIGHTS = ROOT / "weights" / "r5_real_e100.npz"
# H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the tensor cores
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Median device time of one call, CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_: float, ops: float) -> tuple:
    tb, to = bytes_ / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max())


def main() -> None:
    # --- 1. environment ---------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device")
    import regnet_for_3d_grasping_torch as pkg
    check(Path(pkg.__file__).resolve().parent.parent == ROOT,
          "the port package is not beside this script")
    from regnet_for_3d_grasping_torch.runtime import resolve_device
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, card {smi}")

    # --- 2. build ----------------------------------------------------------
    from regnet_for_3d_grasping_torch.ops import _cuda
    t0 = time.perf_counter()
    spent = _cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f}s "
          f"({', '.join(f'{k} {v:.1f}s' for k, v in spent.items())})")

    # --- 3. each kernel against its plain version --------------------------
    from regnet_for_3d_grasping_torch.geometry import region
    from regnet_for_3d_grasping_torch.geometry.codec import grasps_to_frames
    from regnet_for_3d_grasping_torch.ops import (ball_query, crop, fps, knn,
                                                  pooling, sampling)
    from regnet_for_3d_grasping_torch.utils.scene import tabletop_cloud
    xyz_np, _ = tabletop_cloud(np.random.RandomState(0), N_POINTS)
    xyz = torch.tensor(xyz_np, dtype=torch.float32, device=dev)[None]
    results = {}

    def record(name, source, replaces, err, ms, plain_ms, bytes_, ops,
               library_ms=None):
        b_ms, b_by = bound(bytes_, ops)
        results[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}
        print(f"{name}: max_abs_err {err} kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})"
              + (f", library {library_ms:.4f} ms" if library_ms else ""))

    # K1: 25600 -> 5120 unmasked (SA1), and the masked 25600 -> 4000
    dist = fps.dist_init(xyz, None)
    got = fps.fps(xyz, dist, 5120)
    ref = fps.fps_plain(xyz, dist, 5120)
    check(torch.equal(got, ref), "K1 fps differs from its plain version")
    mask = xyz[..., 2] > 0.76
    dist_m = fps.dist_init(xyz, mask)
    check(torch.equal(fps.fps(xyz, dist_m, N_CENTERS),
                      fps.fps_plain(xyz, dist_m, N_CENTERS)),
          "K1 masked fps differs from its plain version")
    sa1_idx = got.long()
    record("fps", "regnet_for_3d_grasping_torch/csrc/fps.cu",
           "regnet_for_3d_grasping_tpu/ops/fps_pallas.py:260",
           max_err(got, ref), cuda_ms(lambda: fps.fps(xyz, dist, 5120), 5),
           cuda_ms(lambda: fps.fps_plain(xyz, dist, 5120), 2),
           nbytes(xyz, dist, got), 5120 * N_POINTS * 10)

    # K2: SA1 ball query, 5120 centers, r = 0.02, K = 64, L = 512
    centers = xyz[:, sa1_idx[0]].contiguous()
    r2 = float(np.float32(0.02 * 0.02))
    L = sampling.pallas_bucket_stride(N_POINTS, 64)
    got = ball_query.ball_query_bucketed(xyz, centers, r2, 64, L)
    ref = ball_query.ball_query_bucketed_plain(xyz, centers, r2, 64, L)
    check(all(torch.equal(g, r) for g, r in zip(got, ref)),
          "K2 ball query differs from its plain version")
    record("ball_query", "regnet_for_3d_grasping_torch/csrc/ball_query.cu",
           "regnet_for_3d_grasping_tpu/ops/ball_query_pallas.py:154",
           max_err(got, ref),
           cuda_ms(lambda: ball_query.ball_query_bucketed(
               xyz, centers, r2, 64, L), 20),
           cuda_ms(lambda: ball_query.ball_query_bucketed_plain(
               xyz, centers, r2, 64, L), 5),
           nbytes(xyz, centers, *got), 5120 * N_POINTS * 9)

    # K3: FP3, 25600 queries against the 5120 SA1 centers
    got = knn.three_nn_kernel(xyz, centers)
    ref = knn.three_nn_plain(xyz, centers)
    check(torch.equal(got[0], ref[0]), "K3 3-NN indices differ")
    check(torch.allclose(got[1], ref[1], rtol=1e-6, atol=0),
          "K3 3-NN distances differ beyond rtol 1e-6")

    def cdist_topk():
        return torch.cdist(xyz, centers).topk(3, dim=-1, largest=False)

    record("three_nn", "regnet_for_3d_grasping_torch/csrc/three_nn.cu",
           "regnet_for_3d_grasping_tpu/ops/knn_pallas.py:169",
           max_err(got, ref),
           cuda_ms(lambda: knn.three_nn_kernel(xyz, centers), 20),
           cuda_ms(lambda: knn.three_nn_plain(xyz, centers), 5),
           nbytes(xyz, centers, *got), N_POINTS * 5120 * 10,
           cuda_ms(cdist_topk, 20))

    # K4: region pool (4000 x 256 slots x 256 channels) and refine pool
    c4000 = xyz[:, fps.fps(xyz, dist_m, N_CENTERS)[0].long()].contiguous()
    groups = region.group_regions([1, 2, 3, 4], xyz, c4000, 256, 0.008)
    feature = torch.randn(1, N_POINTS, 256, device=dev)
    got = pooling.gather_max(feature, groups.index)
    ref = pooling.gather_max_plain(feature, groups.index)
    check(torch.equal(got, ref), "K4 gather-max differs (region pool)")
    refine_idx = groups.index[..., :64].contiguous()
    check(torch.equal(pooling.gather_max(feature, refine_idx),
                      pooling.gather_max_plain(feature, refine_idx)),
          "K4 gather-max differs (refine pool)")
    index = groups.index

    def embedding_bag():
        return torch.nn.functional.embedding_bag(
            index[0].long(), feature[0], mode="max")

    check(torch.equal(embedding_bag()[None], ref),
          "embedding_bag yardstick disagrees with gather-max")
    record("gather_max", "regnet_for_3d_grasping_torch/csrc/gather_max.cu",
           "regnet_for_3d_grasping_tpu/ops/pooling.py:216", max_err(got, ref),
           cuda_ms(lambda: pooling.gather_max(feature, index), 20),
           cuda_ms(lambda: pooling.gather_max_plain(feature, index), 5),
           nbytes(feature, index, got), index.numel() * 256,
           cuda_ms(embedding_bag, 20))

    # K5: crop of 4000 proposals around the selected centers
    axis = torch.nn.functional.normalize(torch.randn(1, N_CENTERS, 3,
                                                     device=dev), dim=-1)
    theta = (torch.rand(1, N_CENTERS, 1, device=dev) * 2 - 1) * np.pi
    frames, bases = grasps_to_frames(torch.cat([c4000, axis, theta], -1))
    frames, bases = frames.contiguous(), bases.contiguous()
    box = (0.0, 0.03, 0.04, 0.005)
    got = crop.closing_region_crop(xyz, frames, bases, 12345, box, 64, L)
    ref = crop.crop_plain(xyz, frames, bases, 12345, box, 64, L)
    check(all(torch.equal(g, r) for g, r in zip(got, ref)),
          "K5 crop differs from its plain version")
    inside = int(got[1].sum())
    print(f"crop: {inside} inside points, "
          f"{int((got[1] > 5).sum())} proposals with > 5")
    record("crop", "regnet_for_3d_grasping_torch/csrc/crop.cu",
           "regnet_for_3d_grasping_tpu/ops/crop_pallas.py:145",
           max_err(got, ref),
           cuda_ms(lambda: crop.closing_region_crop(
               xyz, frames, bases, 12345, box, 64, L), 20),
           cuda_ms(lambda: crop.crop_plain(
               xyz, frames, bases, 12345, box, 64, L), 5),
           nbytes(xyz, frames, bases, *got),
           N_CENTERS * N_POINTS * 22 + inside * 8)

    # --- 4. the main path: the infer CLI on 3 clouds ------------------------
    from regnet_for_3d_grasping_torch.cli import infer
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp) / "smoke_data"
        folder.mkdir()
        for i in range(3):
            cxyz, crgb = tabletop_cloud(np.random.RandomState(100 + i))
            with open(folder / f"{i:04d}_view.p", "wb") as f:
                pickle.dump({"view_cloud": cxyz,
                             "view_cloud_color": crgb}, f)
        argv = ["--folder-name", str(folder), "--checkpoint", str(WEIGHTS),
                "--no-eval", "--seed", "1"]
        _cuda.reset_launches()
        records = infer.main(argv)
        torch.cuda.synchronize()
        launches = dict(_cuda.launches)
        check(len(records) == 3, "the CLI did not serve 3 clouds")
        check(all((Path(tmp) / "smoke_data_predict" / Path(r["path"]).name)
                  .exists() for r in records), "prediction pickle missing")
    per_fwd = {k: v / 3 for k, v in launches.items()}
    print(f"launches on the main path (3 clouds): {launches}")
    for k, want in (("fps", 4), ("ball_query", 1), ("three_nn", 1),
                    ("crop", 1)):
        check(per_fwd[k] == want, f"{k}: {per_fwd[k]} launches per "
              f"forward, expected {want}")
    check(per_fwd["gather_max"] >= 1, "gather_max never launched")
    for k in results:
        results[k]["launches"] = launches[k]
    lat = [r["forward_s"] * 1e3 for r in records]
    for r, ms in zip(records, lat):
        out = r["out"]
        check(all(torch.isfinite(v.float()).all() for v in out
                  if v.is_floating_point()), "non-finite output")
        print(f"{Path(r['path']).name}: forward {ms:.3f} ms, "
              f"{len(r['sets']['grasp_stage2'])} stage-2 / "
              f"{len(r['sets']['grasp_stage3'])} stage-3 grasps, "
              f"{int(out.score_accept.sum())} score-accepted")
    print(f"forward latency per cloud: median {statistics.median(lat):.3f} "
          f"ms, all {[round(x, 3) for x in lat]}")

    # --- 5. the same forward on the CPU, through the plain versions --------
    from regnet_for_3d_grasping_torch.config import infer_config
    from regnet_for_3d_grasping_torch.models.regnet import build_regnet
    cxyz, crgb = tabletop_cloud(np.random.RandomState(100))
    sel = np.random.RandomState(1).choice(len(cxyz), N_POINTS, False)
    pc = np.c_[cxyz, crgb][sel].astype(np.float32)
    seeds = dict(group_seeds=[11, 12, 13, 14], crop_seeds=[[15]])
    gpu = build_regnet(infer_config(), WEIGHTS, "cuda")
    cpu = build_regnet(infer_config(), WEIGHTS, "cpu")
    out_g = gpu(torch.from_numpy(pc)[None].to(dev), **seeds)
    t0 = time.perf_counter()
    out_c = cpu(torch.from_numpy(pc)[None], **seeds)
    print(f"cpu forward {time.perf_counter() - t0:.1f}s")
    score_err = float((out_g.score.cpu() - out_c.score).abs().max())
    same = float((out_g.center_index.cpu() == out_c.center_index)
                 .float().mean())
    print(f"card vs cpu: score max abs err {score_err:.3e}, "
          f"center_index equal share {same:.5f}")
    check(score_err <= 1e-4, "scores differ between card and CPU")
    check(same >= 0.99, "center selection differs between card and CPU")

    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
