"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--kernels-only]

Phases (any failure raises and exits non-zero; nothing is printed as a
result unless every phase passed):

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off;
2. build: the eight CUDA sources (ten kernels) of
   ``regnet_for_3d_grasping_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the inference paths (25,600 points, 4,000 centers; K6-K10 on a
   slab-sorted cloud), with their median times, a bound computed from the
   shapes (for the slab kernels from the pairs their span tables scan and
   the pairs that pass), and a library call where one computes the same
   function.  K6-K8 are timed, like their plain versions, on a span table
   computed beforehand, which is the work the bound counts; the whole call
   with its span table, fill and certificate is ``wrapper_ms``.  And once, on a
   cloud scaled past the slab 3-NN's bound, the refused certificate and the
   FP layer's fallback to the full scan (``--kernels-only`` stops here);
4. the full-scan path: the port's infer CLI on 3 tabletop clouds with the
   trained weights (``weights/r5_real_e100.npz``), the kernel launch
   counters reset just before and read just after;
5. one of those clouds again on the CPU through the plain versions,
   compared with the card's output;
6. the sorted-slab serving path: the CLI again with ``--slab-cell 0.04
   --fps-groups 8`` on the same clouds, counters reset and read as in 4,
   and the count of forwards whose slab 3-NN fell back to the full scan;
7. one slab forward on the card and on the CPU with the same sort noise
   and seeds, compared.

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
SLAB_CELL, FPS_GROUPS = 0.04, 8
CSRC = "regnet_for_3d_grasping_torch/csrc/"
JAX_OPS = "regnet_for_3d_grasping_tpu/ops/"


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


def all_equal(got, ref) -> bool:
    return all(torch.equal(g, r) for g, r in zip(got, ref))


def scanned_pairs(ss: torch.Tensor, m: int, tile: int, scan: int,
                  n: int) -> int:
    """(query, row) pairs a span table scans: per tile its real queries
    times the rows of its blocks [start, stop)."""
    start, stop = ss[0, :, 0].long(), ss[0, :, 1].long()
    rows = torch.clamp(stop * scan, max=n) - start * scan
    queries = torch.clamp(m - torch.arange(len(rows), device=ss.device)
                          * tile, max=tile)
    return int((rows * queries).sum())


def slab_kernels(dev, xyz, record) -> None:
    """Phase 3 for K6-K10, on the cloud `xyz` [1, N, 3] in slab order."""
    from regnet_for_3d_grasping_torch.geometry.codec import grasps_to_frames
    from regnet_for_3d_grasping_torch.ops import fps, slab

    _, sc = slab.sort_cloud(xyz, SLAB_CELL,
                            generator=torch.Generator().manual_seed(7))
    sx, G = sc.xyz, FPS_GROUPS
    L = N_POINTS // G
    src = CSRC + "slab_select.cu"

    def x_sorted(t):
        order = torch.sort(t[..., 0], dim=-1, stable=True).indices
        return t[:, order[0]].contiguous()

    # K10: SA1 shape (unmasked 25,600 -> 5,120) and centers shape (masked
    # 25,600 -> 4,000), 8 slices of 3,200 points
    dist = fps.dist_init(sx.reshape(G, L, 3), None).reshape(1, N_POINTS)
    got = fps.fps_grouped(sx, dist, 5120, G)
    ref = fps.fps_grouped_plain(sx, dist, 5120, G)
    check(torch.equal(got, ref), "K10 grouped fps differs (SA1 shape)")
    sa1 = got
    mask = sx[..., 2] > 0.76
    dist_m = fps.dist_init(sx.reshape(G, L, 3),
                           mask.reshape(G, L)).reshape(1, N_POINTS)
    got_m = fps.fps_grouped(sx, dist_m, N_CENTERS, G)
    check(torch.equal(got_m, fps.fps_grouped_plain(sx, dist_m, N_CENTERS, G)),
          "K10 grouped fps differs (masked centers shape)")
    record("fps_grouped", CSRC + "fps.cu", JAX_OPS + "fps_pallas.py:211",
           max_err(got, ref),
           cuda_ms(lambda: fps.fps_grouped(sx, dist, 5120, G), 10),
           cuda_ms(lambda: fps.fps_grouped_plain(sx, dist, 5120, G), 2),
           nbytes(sx, dist, got), 5120 // G * N_POINTS * 10,
           also=[{"shape": "masked 25600->4000, G=8",
                  "ms": cuda_ms(lambda: fps.fps_grouped(
                      sx, dist_m, N_CENTERS, G), 10)}])

    # K6: the SA1 ball query (5,120 x-sorted centroids, r 0.02, K 64, win
    # 256, spw 2, distinct) and the region grouping (4,000 x-sorted centers,
    # r 0.008, K 256, win 128, spw 4).  Operations: the radius test (9) on
    # every scanned pair; the hash (8) and its place in the window's argmax
    # (2) only on the pairs that pass, which `count` sums exactly
    def k6(centers, seed, radius, K, win, spw, distinct, label):
        ss = slab.select_spans(sc, centers, radius, SLAB_CELL, K, win, spw)
        r2 = float(np.float32(float(radius) ** 2))

        def plain():
            return slab.finish_select(*slab.group_slab_plain(
                sx, centers, ss, seed, r2, K, win, spw, distinct), ss)

        def kernel():
            return slab.finish_select(*slab.group_slab_spans(
                sx, centers, ss, seed, r2, K, win, spw, distinct), ss)

        def wrapper():
            return slab.group_slab(sc, centers, seed, radius, K, SLAB_CELL,
                                   win, spw, distinct)

        got, ref = kernel(), plain()
        check(all_equal(got, ref) and all_equal(wrapper(), ref),
              f"K6 group_slab differs ({label})")
        pairs = scanned_pairs(ss, centers.shape[1], 128, 2048, N_POINTS)
        passing = int(got[1].sum())
        print(f"group_slab {label}: {pairs} pairs scanned of "
              f"{centers.shape[1] * N_POINTS}, {passing} in radius, "
              f"{int(got[2].sum())} rows with a pick")
        return (got, max_err(got[:2], ref[:2]), cuda_ms(kernel, 20),
                cuda_ms(plain, 3), nbytes(sx, centers, ss, *got),
                pairs * 9 + passing * 10, cuda_ms(wrapper, 20))

    centroids = x_sorted(sx[:, sa1[0].long()])
    c4000 = x_sorted(sx[:, got_m[0].long()])
    _, err_b, ms_b, plain_b, bytes_b, ops_b, wrap_b = k6(
        centroids, 0x5A1B, 0.02, 64, slab.BALL_WIN, slab.BALL_SPW, True,
        "SA1 geometry")
    groups, err, ms, plain_ms, bytes_, ops, wrap = k6(
        c4000, 21, 0.008, 256, slab.GROUP_WIN, slab.GROUP_SPW, False,
        "region geometry")
    record("group_slab", src, JAX_OPS + "slab.py:425", err, ms, plain_ms,
           bytes_, ops, wrapper_ms=wrap, also=[{
               "shape": "SA1 ball query: 5120 centroids, K=64, distinct",
               "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
               "bound_ms": bound(bytes_b, ops_b)[0], "wrapper_ms": wrap_b}])

    # K7: crop of 4,000 proposals around those centers.  Operations: the
    # frame transform and box test (22) on every scanned pair, hash and
    # argmax (10) on the pairs inside the box
    gen = torch.Generator().manual_seed(8)
    axis = torch.nn.functional.normalize(
        torch.randn(1, N_CENTERS, 3, generator=gen), dim=-1).to(dev)
    theta = ((torch.rand(1, N_CENTERS, 1, generator=gen) * 2 - 1)
             * np.pi).to(dev)
    frames, bases = grasps_to_frames(torch.cat([c4000, axis, theta], -1))
    frames, bases = frames.contiguous(), bases.contiguous()
    box = (0.0, 0.03, 0.04, 0.005)
    box32 = tuple(float(np.float32(v)) for v in box)
    ss = slab.select_spans(sc, bases, slab.crop_bound(box), SLAB_CELL, 64,
                           slab.CROP_WIN, slab.CROP_SPW)
    f9 = frames.reshape(1, N_CENTERS, 9)

    def crop_plain():
        return slab.finish_select(*slab.crop_slab_plain(
            sx, f9, bases, ss, 12345, box32, 64), ss)

    def crop_kernel():
        return slab.finish_select(*slab.crop_slab_spans(
            sx, f9, bases, ss, 12345, box32, 64), ss)

    def crop_wrapper():
        return slab.crop_slab(sc, frames, bases, 12345, box, 64, SLAB_CELL)

    crops, ref = crop_kernel(), crop_plain()
    check(all_equal(crops, ref) and all_equal(crop_wrapper(), ref),
          "K7 crop_slab differs")
    pairs = scanned_pairs(ss, N_CENTERS, 128, 2048, N_POINTS)
    inside = int(crops[1].sum())
    print(f"crop_slab: {pairs} pairs scanned of {N_CENTERS * N_POINTS}, "
          f"{inside} inside points, "
          f"{int(((crops[1] > 5) & crops[2]).sum())} valid proposals")
    record("crop_slab", src, JAX_OPS + "slab.py:425", max_err(crops[:2],
                                                              ref[:2]),
           cuda_ms(crop_kernel, 20), cuda_ms(crop_plain, 3),
           nbytes(sx, frames, bases, ss, *crops), pairs * 22 + inside * 10,
           wrapper_ms=cuda_ms(crop_wrapper, 20))

    # K8: FP3, 25,600 sorted queries against the 5,120 x-sorted centroids,
    # with the bounded spans (the default) and the flat ones
    def k8(flat, label):
        start, stop, _ = slab.three_nn_spans(sx, centroids, 0.06, 3, flat)
        ss = torch.stack([start, stop], -1).to(torch.int32).contiguous()

        def kernel():
            return slab.three_nn_slab_spans(sx, centroids, ss)

        def wrapper():
            return slab.three_nn_slab(sx, centroids, 0.06, 3, flat)

        def plain():
            return slab.three_nn_slab_plain(sx, centroids, ss)

        got, ref = wrapper(), plain()
        check(all_equal(kernel(), got[:2]),
              f"K8 wrapper and launch differ ({label})")
        check(torch.equal(got[0], ref[0]), f"K8 3-NN indices differ ({label})")
        check(torch.allclose(got[1], ref[1], rtol=1e-6, atol=0),
              f"K8 3-NN distances differ beyond rtol 1e-6 ({label})")
        pairs = scanned_pairs(ss, N_POINTS, 256, 1024, 5120)
        print(f"three_nn_slab {label}: {pairs} pairs scanned of "
              f"{N_POINTS * 5120}, proven {bool(got[2].all())}")
        return (got, max_err(got[:2], ref), cuda_ms(kernel, 20),
                cuda_ms(plain, 3), nbytes(sx, centroids, ss, *got[:2]),
                pairs * 10, cuda_ms(wrapper, 20))

    nn, err, ms, plain_ms, bytes_, ops, wrap = k8(False, "bounded spans")
    _, err_f, ms_f, plain_f, bytes_f, ops_f, wrap_f = k8(True, "flat spans")
    check(bool(nn[2].all()), "K8 certificate failed on the tabletop cloud")

    def cdist_topk():
        return torch.cdist(sx, centroids).topk(3, dim=-1, largest=False)

    lib = cdist_topk()
    same = float((lib[1] == nn[0]).float().mean())
    print(f"three_nn_slab vs cdist+topk: indices equal share {same:.5f}")
    check(same > 0.99, "the proven slab 3-NN disagrees with the full scan")
    record("three_nn_slab", CSRC + "three_nn_slab.cu",
           JAX_OPS + "slab.py:853", err, ms, plain_ms, bytes_, ops,
           cuda_ms(cdist_topk, 20), wrapper_ms=wrap, also=[{
               "shape": "flat spans (slab.py:885)", "max_abs_err": err_f,
               "ms": ms_f, "plain_ms": plain_f,
               "bound_ms": bound(bytes_f, ops_f)[0], "wrapper_ms": wrap_f}])

    # the certificate refusing, on the card: the same cloud 20 times larger,
    # so the 0.06 bound no longer covers the neighbours and the FP layer
    # runs K3 over the x-sorted keys; it must give what the full scan gives
    from regnet_for_3d_grasping_torch.models.backbone import (
        FeaturePropagation)
    from regnet_for_3d_grasping_torch.ops import _cuda
    far_q, far_k = sx * 20.0, sx[:, sa1[0].long()] * 20.0
    check(not bool(slab.three_nn_slab(far_q, x_sorted(far_k), 0.06)[2].all()),
          "K8 certificate held on a cloud 20 times the bound's scale")
    torch.manual_seed(10)
    fp = FeaturePropagation(16, (16,), 3, 0.06).to(dev).eval()
    feat = torch.randn(1, 5120, 16, device=dev)
    before = (_cuda.fallbacks["fp3_slab"], _cuda.launches["three_nn"])
    with torch.no_grad():
        via_slab = fp(far_q, far_k, None, feat, use_slab=True)
        full = fp(far_q, far_k, None, feat)
    check(_cuda.fallbacks["fp3_slab"] == before[0] + 1
          and _cuda.launches["three_nn"] == before[1] + 2,
          "the refused slab 3-NN did not fall back to K3")
    err_fb = max_err(via_slab, full)
    print(f"three_nn_slab fallback: FP layer vs full scan max abs err "
          f"{err_fb:.3e}")
    check(err_fb <= 1e-5, "the slab FP layer's fallback differs from the "
          "full scan")

    # K9: the region pool (4,000 x 256 slots x 256 channels, win 128, spw 4)
    # and the refine pool (4,000 x 64 slots, win 256, spw 1)
    feature = torch.randn(1, N_POINTS, 256,
                          generator=torch.Generator().manual_seed(9)).to(dev)

    def k9(index, off, win, spw, label):
        def kernel():
            return slab.gather_max_slab(feature, index, off, win, spw)

        def plain():
            return slab.gather_max_slab_plain(feature, index, off, win, spw)

        cover = slab.slab_cover(index, off, win, spw)[0]
        flat_idx = index[0].long()[cover]
        n_cov = cover.sum(-1)
        offsets = torch.cumsum(n_cov, 0) - n_cov

        def embedding_bag():
            return torch.nn.functional.embedding_bag(
                flat_idx, feature[0], offsets, mode="max")

        got, ref = kernel(), plain()
        check(torch.equal(got, ref), f"K9 gather_max_slab differs ({label})")
        has = n_cov > 0
        check(bool((got[0][~has] == -1e38).all()),
              f"K9 rows without a covered slot are not -1e38 ({label})")
        check(torch.equal(embedding_bag()[has], ref[0][has]),
              f"embedding_bag yardstick disagrees with K9 ({label})")
        print(f"gather_max_slab {label}: {int(cover.sum())} covered slots of "
              f"{cover.numel()}, {int((~has).sum())} rows without one")
        return (max_err(got, ref), cuda_ms(kernel, 20), cuda_ms(plain, 3),
                nbytes(feature, index, off, got), int(cover.sum()) * 256,
                cuda_ms(embedding_bag, 20))

    g_idx = torch.where((groups[2] & (groups[1] > 0))[..., None], groups[0], 0)
    err, ms, plain_ms, bytes_, ops, lib_ms = k9(
        g_idx, groups[3], slab.GROUP_WIN, slab.GROUP_SPW, "region pool")
    c_idx = torch.where(crops[2][..., None], crops[0], 0)
    err_c, ms_c, plain_c, bytes_c, ops_c, lib_c = k9(
        c_idx, crops[3], slab.CROP_WIN, slab.CROP_SPW, "refine pool")
    record("gather_max_slab", CSRC + "gather_max_slab.cu",
           JAX_OPS + "slab.py:1072", err, ms, plain_ms, bytes_, ops, lib_ms,
           also=[{"shape": "refine pool: 4000 x 64 slots, win 256, spw 1",
                  "max_abs_err": err_c, "ms": ms_c, "plain_ms": plain_c,
                  "bound_ms": bound(bytes_c, ops_c)[0],
                  "library_ms": lib_c}])


def serve(argv_extra, tmp, label):
    """Drive the infer CLI on 3 tabletop clouds; returns (records, launch
    counts, 3-NN fallbacks) with the counters reset just before."""
    from regnet_for_3d_grasping_torch.cli import infer
    from regnet_for_3d_grasping_torch.ops import _cuda
    from regnet_for_3d_grasping_torch.utils.scene import tabletop_cloud
    folder = Path(tmp) / f"{label}_data"
    folder.mkdir()
    for i in range(3):
        cxyz, crgb = tabletop_cloud(np.random.RandomState(100 + i))
        with open(folder / f"{i:04d}_view.p", "wb") as f:
            pickle.dump({"view_cloud": cxyz, "view_cloud_color": crgb}, f)
    argv = ["--folder-name", str(folder), "--checkpoint", str(WEIGHTS),
            "--no-eval", "--seed", "1", *argv_extra]
    _cuda.reset_launches()
    records = infer.main(argv)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    fallbacks = _cuda.fallbacks["fp3_slab"]
    check(len(records) == 3, f"the CLI did not serve 3 clouds ({label})")
    check(all((Path(tmp) / f"{label}_data_predict" / Path(r["path"]).name)
              .exists() for r in records), "prediction pickle missing")
    print(f"launches on the {label} path (3 clouds): {launches}")
    lat = [r["forward_s"] * 1e3 for r in records]
    for r, ms in zip(records, lat):
        out = r["out"]
        check(all(torch.isfinite(v.float()).all() for v in out
                  if v is not None and v.is_floating_point()),
              "non-finite output")
        check(out.score.shape == (1, N_POINTS)
              and out.final_grasps.shape[:2] == (1, N_CENTERS),
              "unexpected output shape")
        print(f"{Path(r['path']).name}: forward {ms:.3f} ms, "
              f"{len(r['sets']['grasp_stage2'])} stage-2 / "
              f"{len(r['sets']['grasp_stage3'])} stage-3 grasps, "
              f"{int(out.score_accept.sum())} score-accepted")
    print(f"{label} path forward latency per cloud: median "
          f"{statistics.median(lat):.3f} ms, all "
          f"{[round(x, 3) for x in lat]}")
    return records, launches, fallbacks


def card_vs_cpu(cfg, pc, dev, label, **randomness) -> None:
    """One forward on the card and on the CPU (plain versions) with the
    same randomness: scores within 1e-4, selections at least 99 % equal."""
    from regnet_for_3d_grasping_torch.models.regnet import build_regnet
    out_g = build_regnet(cfg, WEIGHTS, "cuda")(
        torch.from_numpy(pc)[None].to(dev), **randomness)
    t0 = time.perf_counter()
    out_c = build_regnet(cfg, WEIGHTS, "cpu")(torch.from_numpy(pc)[None],
                                              **randomness)
    print(f"{label}: cpu forward {time.perf_counter() - t0:.1f}s")
    score_g, score_c = out_g.score.cpu(), out_c.score
    if out_c.point_order is not None:
        same_order = float((out_g.point_order.cpu() == out_c.point_order)
                           .float().mean())
        print(f"{label}: point_order equal share {same_order:.5f}")
        check(same_order >= 0.99, "slab order differs between card and CPU")
        # back to the input's row order, each by its own permutation
        score_g = torch.empty_like(score_g).scatter_(
            1, out_g.point_order.cpu().long(), score_g)
        score_c = torch.empty_like(score_c).scatter_(
            1, out_c.point_order.long(), score_c)
    score_err = float((score_g - score_c).abs().max())
    same = float((out_g.center_index.cpu() == out_c.center_index)
                 .float().mean())
    print(f"{label}: card vs cpu score max abs err {score_err:.3e}, "
          f"center_index equal share {same:.5f}")
    check(score_err <= 1e-4, "scores differ between card and CPU")
    check(same >= 0.99, "center selection differs between card and CPU")


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
    # a few points more than needed: the scene's objects round their share
    xyz_np, _ = tabletop_cloud(np.random.RandomState(0), N_POINTS + 64)
    xyz = torch.tensor(xyz_np[:N_POINTS], dtype=torch.float32,
                       device=dev)[None]
    results = {}

    def record(name, source, replaces, err, ms, plain_ms, bytes_, ops,
               library_ms=None, also=None, wrapper_ms=None):
        """`also`: the numbers of the kernel's second shape, where it has
        one on the path.  `wrapper_ms`: the whole call where `ms` times the
        launch on a span table computed beforehand."""
        b_ms, b_by = bound(bytes_, ops)
        results[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}
        if wrapper_ms is not None:
            results[name]["wrapper_ms"] = wrapper_ms
        if also:
            results[name]["also"] = also
        print(f"{name}: max_abs_err {err} kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})"
              + (f", library {library_ms:.4f} ms" if library_ms else "")
              + (f", whole call {wrapper_ms:.4f} ms" if wrapper_ms else ""))

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

    # K6-K10 on the same cloud in slab order
    slab_kernels(dev, xyz, record)
    check(set(results) == set(_cuda.KERNELS),
          "not every kernel of the port was held against its plain version")
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"kernels": list(results.values())}))
        print(smi)
        return

    from regnet_for_3d_grasping_torch.config import infer_config
    slab_over = {"region.slab_cell": SLAB_CELL, "model.fps_groups": FPS_GROUPS,
                 "region.center_fps_groups": FPS_GROUPS}
    slab_kernel_names = ("fps_grouped", "group_slab", "crop_slab",
                         "three_nn_slab", "gather_max_slab")
    cxyz, crgb = tabletop_cloud(np.random.RandomState(100))
    sel = np.random.RandomState(1).choice(len(cxyz), N_POINTS, False)
    pc = np.c_[cxyz, crgb][sel].astype(np.float32)

    with tempfile.TemporaryDirectory() as tmp:
        # --- 4. the full-scan path: the infer CLI on 3 clouds ---------------
        _, full, _ = serve([], tmp, "full-scan")
        want = {"fps": 4, "ball_query": 1, "three_nn": 1, "gather_max": 2,
                "crop": 1, **dict.fromkeys(slab_kernel_names, 0)}
        for k, n in want.items():
            check(full[k] == 3 * n, f"{k}: {full[k]} launches in 3 full-scan "
                  f"forwards, expected {3 * n}")

        # --- 5. the same forward on the CPU, through the plain versions -----
        card_vs_cpu(infer_config(), pc, dev, "full-scan",
                    group_seeds=[11, 12, 13, 14], crop_seeds=[[15]])

        # --- 6. the sorted-slab serving path: the CLI on the same clouds ----
        _, slab_l, fallbacks = serve(
            ["--slab-cell", str(SLAB_CELL), "--fps-groups", str(FPS_GROUPS)],
            tmp, "slab")
    print(f"slab path: {fallbacks} of 3 forwards fell back to the full-scan "
          f"3-NN")
    want = {"fps_grouped": 2, "fps": 2, "group_slab": 2, "crop_slab": 1,
            "three_nn_slab": 1, "gather_max_slab": 2, "ball_query": 0,
            "gather_max": 0, "crop": 0}
    for k, n in want.items():
        check(slab_l[k] == 3 * n, f"{k}: {slab_l[k]} launches in 3 slab "
              f"forwards, expected {3 * n}")
    check(slab_l["three_nn"] == fallbacks,
          "K3 ran in a forward that did not fall back")
    for k in results:
        path = slab_l if k in slab_kernel_names else full
        results[k]["launches"] = path[k]
        results[k]["launches_by_path"] = {"full_scan": full[k],
                                          "slab": slab_l[k]}
        check(path[k] > 0 or k == "three_nn",
              f"{k} was never launched on its path")

    # --- 7. one slab forward on the card and on the CPU ---------------------
    u = torch.rand(1, N_POINTS, generator=torch.Generator().manual_seed(3))
    card_vs_cpu(infer_config(**slab_over), pc, dev, "slab", sort_u=u,
                sa1_seed=16, group_seeds=[17], crop_seeds=[[18]])

    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
