"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--kernels-only]

Phases (any failure raises and exits non-zero; nothing is printed as a
result unless every phase passed):

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off;
2. build: the eleven CUDA sources (twenty-seven kernel entry points) of
   ``regnet_for_3d_grasping_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the inference paths (25,600 points, 4,000 centers; K6-K10 on a
   slab-sorted cloud) and, for K1 and K10 (at every shape the serving and
   training paths launch, and at their edge cases, with the cluster size
   chosen for each, and every cluster size timed apart at the main
   shapes), K6 and K7, the SA1 ball query K2 (also at a training batch of
   12 clouds), the served grouping K12 (the JAX package's chunked path on
   a cell grid: 4 chunks of 1,024 centers and 4 seeds at serving, buckets
   of 100 columns; the grid the build wrote held against
   `ops/group.grid_plan`, the records a center tests and the cells it
   visits printed, and each call's device activities counted: build and
   query), the fused grouping K11
   (on no model path) and the crop K5 (also at a validation forward's 64
   centers; the four at small edge shapes, some with buckets wider than
   1,024 columns or than a block stages, K12 also on cell boundaries, 75
   m from the origin and in one cell at 25,600 points; for K11, K5 and
   K2 the grid `ops/bucket_scan.scan_grid` picks, pairs per ns and the
   bound's share printed, and each call's device activities counted: scan
   and fill), the FP3 3-NN K3 (at serving, at a training batch and on the
   slab fallback's x-sorted keys, with the grid `ops/knn.split_grid`
   picks, pairs per ns, the bound's share, the kernel timed at several
   grids, edge shapes, and each call's device activities counted:
   split, and merge where it splits the keys), the pool K4 at the region
   pool and on the crop K5's own 4,000 x 64 output (with the slots it
   keeps: mean, p90 and most a row, and the rows a call reads, at every
   K4 shape), the bf16 forms of K4 and K9 at their serving shapes (bit for
   bit, rows read, the bound at 2 bytes a channel, ``embedding_bag`` on
   bf16 where torch runs it; K9's also at 8 channels a thread, the form
   its entry point offers beside the wrapper's 4)
   and the argmax and backward forms of the pools K4 and K9, f32 and bf16
   (bf16 training; bit for bit, K4's bf16 argmax also with a NaN and at
   C = 7, the backward against the plain version's ordered sum: f32 on
   CPU copies, bf16 on the card; its zero fill and its scatter also timed
   apart; and on adversarial winners and gradients, `backward_edges`), of
   the training paths (12 clouds, 64 centers) and the 4,000-center region
   pool, with their median times, a
   bound computed from the shapes (for the slab kernels from the pairs
   their span tables scan and the pairs that pass; for K12 from its
   bytes, beside the old all-pairs count; for K11, K5, K2
   and K3 from the operations an exact test needs on the run's pairs and
   the pairs that pass), and a library call where one computes the same
   function (the bf16 backward: ``index_add_``, torch has no bf16
   ``embedding_bag`` backward); a pool that needs a gradient launches the
   argmax form and the backward of its dtype once each and nothing else,
   and its gradient is the scatter of its winners.  A K6
   or K7 call (span table, selection, fill) is held against
   ``slab_bounds``, the plain selection and ``finish_select``, span table
   included, and its device activities are counted with ``torch.profiler``
   (at most 3).  A K8 call (span table, scan, merge and certificate: 3
   launches) is held against ``three_nn_spans``, ``three_nn_slab_plain``
   and ``three_nn_certificate`` (span table and bounds exact, indices
   exact, distances bit-equal, the flag equal to the certificate), timed
   at several grids, and ``wrapper_ms`` is the FP layer's whole 3-NN (the
   call and K3's launches that return at once on the card while the flag
   says proven); the slab FP3 layer runs once with CUDA's sync debug mode
   set to raise.  And once, on a cloud scaled past the slab 3-NN's bound,
   the refused certificate and the FP layer's fallback to the full scan,
   counted on the card.  K13a-d, BatchNorm + ReLU (`batch_norm_kernels`),
   at SA1's shapes at serving (327,680 x 256) and in training (3,932,160
   x 128 and x 256), a head's stem (4,000 x 1,024), score_bn (C = 1) and
   the heads' C = 2, 4, 10 and 40, f32 and bf16, train, eval and frozen:
   K13b bit-equal to the plain version given the same statistics, K13d
   given the same coefficients; K13a and K13c within `BN_ULPS` of the f64
   sums and within their stated tolerances of torch's f32 ones, dx within
   `BN_DX_TOL`; every kernel twice, bit-equal; the module against its
   written-out chain on the card (`bn_module_check`), one launch of each
   kernel; times beside the bound and ``torch.nn.functional.batch_norm``
   (+ ``relu``), forward and backward.  K13e-f, the set-abstraction
   layers' max over neighbours fused into their last BatchNorm + ReLU
   (`bn_max_kernels`), at SA1-3's serving (5,120, 1,024 and 256 groups of
   64) and batch-12 shapes, f32 and bf16, train and eval, neighbourhoods
   padded as ball query pads them: K13e's m and winners words bit-equal to
   its plain version and m to K13b + ``amax``, K13f bit-equal to its plain
   version and to ``amax``'s autograd, every kernel twice; the module
   (`BatchNorm.relu_max`) against the parent's path, K13's BatchNorm with
   its ReLU then ``amax``, on the card, train, eval and frozen, bit for
   bit, one launch of each kernel; ties, -0.0, NaN, K = 1, 17, 64 and C =
   7, 12, 40 (`bn_max_edges`); times beside the bound, the parent's pair
   (K13b + ``amax``) and ``amax``'s backward.  (a) K8 flat (``three_nn_slab(flat=True)``) at
   serving and at 12 training clouds, where its spans sum past G (the
   bounded grid) and where the clamp cut spans (flat differs from
   bounded), against its plain version bit for bit, timed beside the
   bounded K8; then its entry point at both shapes with the counters reset
   just before and read just after; K11's entry point likewise at its
   three shapes, its "path" (``--kernels-only`` stops here);
4. the full-scan path: the port's infer CLI, with its evaluation, on 3
   tabletop clouds with the trained weights (``weights/r5_real_e100.npz``),
   the kernel launch counters reset just before and read just after (the
   full-scan paths, serving and training, launch K12 and no K11; every
   serving forward K13b once a BatchNorm, `BN_LAYERS`, but for SA1-3's
   last, which launch K13e (`BN_SA_MAX`), a training step K13a, K13c and
   K13d once a BatchNorm, K13b and K13e as a forward, and K13f once an SA
   layer);
   (d) every forward of every serving path draws the same seeds (C1), and
   the first cloud's pickled sets are the CPU's `eval_test` of its raw
   sets;
6. the sorted-slab serving path: the CLI again with ``--slab-cell 0.04
   --fps-groups 8`` on the same clouds, counters reset and read as in 4
   (K3 launches in every forward: it returns at once on the card where the
   slab 3-NN is proven), and the count of forwards whose slab 3-NN fell
   back to the full scan;
11. bf16 on the full scan (``--bf16``) and 12. the JAX package's serving
   configuration of record (``--fast``: bf16 + slab 0.04 + G = 8), counters
   as in 4: each bf16 pool twice a forward, no f32 pool;
8. training, full scan: the port's train CLI for 4 steps at batch 12 and
   full width on synthetic scenes made from a seed (and its validation
   forwards), counters reset before and read after, losses finite, weights
   moved, step times and peak device memory printed;
9. the same with ``--slab-cell 0.04 --fps-groups 8``, and for every slab
   3-NN of those steps: the clouds whose certificate failed, their largest
   third-neighbour distance against the bound, the tiles the clamp cut and
   the queries that failed inside and outside them;
10. one training step at batch 2 on the card and on the CPU with the same
    weights and seeds and dropout off, with the native GEMMs and BatchNorm
    statistics and again with both summed in f64 on both sides (on the
    card K13a's own f64 sums; the card launches K13 in both):
    selections equal, loss within 1e-4, the gradients' cosines at least
    0.99, and, without the summation orders, the gradients of the score
    and proposal heads within 2 % of their largest entry and that of SA1's
    first layer within 15 % (`train_step_card_vs_cpu`); and one step at
    batch 2 on the card, f32 and bf16, through the fused SA max (K13e,
    K13f) and through the parent's K13b + ``amax``: metrics, gradients,
    updated parameters and running buffers bit-equal
    (`fused_max_step_check`);
15. bf16 training (``--bf16``), full scan, and 16. the run of record,
    ``--bf16 --slab-cell 0.04 --fps-groups 8``: as 8 and 9, with each step
    launching the bf16 argmax forms and the bf16 backward and no f32 pool,
    the validation forwards f32 at exact geometry (f32 pools), and the
    share of regions with a pick in each step printed;
17. one bf16 training step at batch 2 on the card against the CPU's (in a
    second helper process), both given the CPU's centers: the loss and the
    gradients of the score head's Dense, the proposal head's stem and
    SA1's first layer within `BF16_STEP_MULTIPLE` times the larger of the
    two sides' own drifts with f64 GEMM sums (`bf16_step_card_vs_cpu`);
(e) suite v2 (24 scenes, fingerprints verified) through
   ``cli/benchmark_eval.py`` with ``weights/r4_coherent_e100.npz``, at
   ``--fast`` and f32 exact, written to ``chiprun_out/suite/``: stage-3
   VGR within `SUITE_VGR_LIMIT` of the TPU's ``docs/evidence`` files;
(j) the library functions no entry point reaches, at full width on the
   serving cloud, each on the card and in the CPU helper with the same
   weights and seeds (indices equal, f32 features within `LIBRARY_RTOL`
   of the largest entry; the median forward of `LIBRARY_REPS` and the
   launches a forward, counters reset before and read after, as
   `LIBRARY_LAUNCHES`): `SetAbstractionMSG` at SA1 (25,600 -> 5,120,
   scales (0.02, 64) and (0.04, 64), MLP (128, 128, 256) each: K1 once,
   K2 twice), `SetAbstractionAvg` and `EdgeSetAbstraction` at SA1 on xyz
   + rgb (K1, K2), the edge SA again with the exact ball query (plain
   PyTorch), `EdgeFeaturePropagation` at FP3 (25,600 points with the rgb
   skip, 5,120 with 512 channels, MLP (256, 256, 256): K3), and
   `group_regions_two_scales` at ``infer_config()`` (4,000 centers, 256
   at `group_radius`, 2,048 at `group_radius_more`) with
   `closing_region_crop` from its wide regions (plain PyTorch);
(k) the JAX package's Orbax checkpoint ``tests/data/orbax_tiny`` (a
   ``tiny_config()`` TrainState after one score step, written by
   ``tools/make_orbax_fixture.py``) read by the port's own OCDBT, zarr and
   zstd readers, every leaf (path, dtype, shape, SHA-256) held to the
   fixture's ``expected.json``; one forward on the card from the Orbax
   directory bit-equal to the forward from the same values given as
   arrays; the train CLI resumed from the fixture's tag directory for one
   step on the card, writing ``ckpt_1/``, the JAX package's checkpoint,
   through the port's own writer: read back equal to the model's and
   Adam's state (counts and step 2), ``--resume`` from it bit-equal to
   ``--resume`` from a ``ckpt_1.pt`` of the same state, a forward from it
   bit-equal to the forward from its arrays; the reader's ms, the
   decoder's MB/s and the writer's ms and MB/s (host CPU: the tiny state,
   the r5 weights at full width, and those with a fresh Adam) beside the
   card's name and power limit, and the launches of the forwards and of
   the steps, counters reset before and read after each;
(c) the evaluator on the card against the CPU (in a helper process beside
   the training phases), on suite scene clutter_00 and the 4,000 stage-2
   grasps of a forward on it: view masks, funnel and scene check equal
   grasp for grasp, antipodal scores within 1e-5, both methods' normals
   of the 102,400-point scene cloud within 1 - 1e-5 of |cos| on 99.9 % of
   every 10th point, and the card's times;
(b) determinism (C2): the train CLI twice for 3 steps from one seed, full
   scan f32 and bf16 slab, losses and parameters bit-equal; and the four
   training configurations once with the CLI's deterministic block
   replaced by a no-op, for its cost in step time;
(f) the serving knobs through the infer CLI on the 3 clouds, one
   run each: ``--center-min-z 0.75 --pose-search 8``, ``--refine-guard``,
   ``--center-select bucket``, ``--fast --pose-search 8 --refine-guard``
   and ``--slab-cell 0.04 --fps-groups 8 --pose-search 8``, counters as in
   4 (the funnels are PyTorch; the bucket selection replaces the center
   FPS), the forward and the pose search and guard timed apart, every
   center above the prior where a positive lies above it, and the guard's
   invariant at subsample 1 (every stage-2 survivor of the funnel survives
   at stage 3); each configuration also joins the card-CPU forwards below,
   with the search and the guard on the card given the CPU's inputs equal
   to the CPU's results bit for bit;
(g) the train CLI's flags that no other phase drives, at batch 12 on
   phase 8's scenes (after phases 8-17): ``--eval-grasps --eval-every 1``
   (VGR records logged,
   the evaluation's seconds), ``--geom-aug 1.0 --native-loader
   --profile-dir`` (4 native batches, 4 augmented, a trace naming the
   port's kernels) and ``--remat`` (after 4 steps bit-equal to phase 8's
   run, its peak memory and step times beside phase 8's), each with phase
   8's launch counts (``--remat``: K13a once more for each of the
   `BN_REMAT` BatchNorms it recomputes, and K13b, or for SA1-3's last
   K13e);
5., 7., 13., 14. one forward of each serving path (full scan, slab, bf16
   full scan, ``--fast``; and phase (f)'s five) on the card and on the CPU
   (plain versions, the CPU twin of the bf16 GEMM) with the same seeds and
   sort noise: f32
   scores within 1e-4 and every selection 99 % equal; bf16 as
   `compare_phases` says (the scores against how far two GEMM recipes on
   the CPU drift apart, everything after the score with the CPU's
   centers on both sides).  The CPU's forwards run in one helper process
   beside the training phases (after the serving phases, whose latencies
   are host-bound).

The last lines are the kernels' JSON, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# the train CLI's steps run deterministic (cli/train.py): cuBLAS's fixed
# workspace is chosen at the process's first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
N_POINTS, N_CENTERS = 25600, 4000
CPU_THREADS = 4      # the CPU reference forwards' threads, beside the card
WEIGHTS = ROOT / "weights" / "r5_real_e100.npz"
# H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the tensor cores
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
SLAB_CELL, FPS_GROUPS = 0.04, 8
SLAB_KERNELS = ("fps_grouped", "group_slab", "crop_slab", "three_nn_slab",
                "gather_max_slab")
TRAIN_KERNELS = ("gather_max_argmax", "gather_max_backward",
                 "gather_max_slab_argmax", "gather_max_argmax_bf16",
                 "gather_max_backward_bf16", "gather_max_slab_argmax_bf16")
BF16_KERNELS = ("gather_max_bf16", "gather_max_slab_bf16")
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


def device_ms(fn, reps: int) -> float:
    """Median device time of one call with the host ahead of the card: a
    sleep kernel holds the queue while the call is enqueued, so the events
    leave out the host's own time, which `cuda_ms` counts for a call the
    card runs faster than the host issues it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
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
    """(query, row) pairs a span table [B, T, >=2] scans: per tile its real
    queries times the rows of its blocks [start, stop)."""
    start, stop = ss[..., 0].long(), ss[..., 1].long()
    rows = torch.clamp(stop * scan, max=n) - start * scan
    queries = torch.clamp(m - torch.arange(rows.shape[-1], device=ss.device)
                          * tile, max=tile)
    return int((rows * queries).sum())


TRAIN_B, TRAIN_CENTERS = 12, 64


def train_clouds(dev) -> torch.Tensor:
    """[12, N, 3]: the clouds of one training batch."""
    from regnet_for_3d_grasping_torch.utils.scene import tabletop_cloud
    return torch.tensor(np.stack([
        tabletop_cloud(np.random.RandomState(300 + b), N_POINTS + 64)[0]
        [:N_POINTS] for b in range(TRAIN_B)]), dtype=torch.float32,
        device=dev)


def relu_features(b: int, seed: int, dev) -> torch.Tensor:
    """[b, N, 256] features as a ReLU leaves them: half of them 0, so the
    maxima of a pool tie across different rows and the winner rule shows."""
    return torch.relu(torch.randn(
        b, N_POINTS, 256, generator=torch.Generator().manual_seed(seed))
    ).to(dev)


def embedding_bag_pair(feature, index):
    """The library yardstick of a pool with its gradient: ``embedding_bag``
    (max) over all clouds at once -> (forward, backward) closures."""
    B, N, C = feature.shape
    w = feature.reshape(B * N, C).clone().requires_grad_()
    flat = (index.long() + torch.arange(B, device=index.device)
            [:, None, None] * N).reshape(-1, index.shape[-1])

    def fwd():
        return torch.nn.functional.embedding_bag(flat, w, mode="max")

    graph = []

    def bwd():
        if not graph:       # the forward once, on first use
            graph.append(fwd())
        return torch.autograd.grad(graph[0], w, torch.ones_like(graph[0]),
                                   retain_graph=True)

    return fwd, bwd


def pool_kernels(record, name_fwd, src, replaces, argmax, plain, cases,
                 n_points, pooled_slots=None, kept=None) -> list:
    """Phase 3 for an argmax pool (K4's or K9's) and its backward at the
    shapes `cases` = [(label, feature, index, extra args)], the first the
    main path's.  Winners and pooled values must equal the plain version's
    (bit for bit); the backward, which sums in a fixed order, must repeat
    itself bit for bit and equal the ordered sum bit for bit: on f32 the
    plain version on CPU copies of `g` and the winners (``index_add_`` on
    the CPU adds in index order), and also the plain version on the card
    (an atomic ``index_add_``, unordered) within rtol 1e-5 / atol 1e-5; on
    bf16 the plain version's ordered sum on the card, rounded at each add.
    Its fill and its scatter are timed apart (`backward_parts`).  The
    gradient `g` has the feature's dtype.  The forward's bound counts the
    feature rows
    that this run's indices touch (`pooled_slots` masks the slots that are
    pooled over; all, when None), not the whole feature array.  `kept`: a
    function of the index that gives the rows' read statistics (K4's
    `kept_stats`), added to each row.  Returns the backward's rows, for one
    record over both pools."""
    from regnet_for_3d_grasping_torch.ops import pooling
    rows_f, rows_b = [], []
    bf16 = cases[0][1].dtype == torch.bfloat16
    for label, feature, index, extra in cases:
        got, ref = argmax(feature, index, *extra), plain(feature, index,
                                                         *extra)
        check(bit_equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"{name_fwd} differs ({label})")
        win = got[1]
        g = torch.randn(got[0].shape, device=feature.device,
                        generator=torch.Generator(
                            device=feature.device).manual_seed(1)
                        ).to(feature.dtype)
        df = pooling.scatter_winner(g, win, n_points)
        check(torch.equal(df, pooling.scatter_winner(g, win, n_points)),
              f"the backward of {name_fwd} is not deterministic ({label})")
        df_plain = pooling.scatter_winner_plain(g, win, n_points)
        check(bit_equal(df, df_plain) if bf16 else
              torch.allclose(df, df_plain, rtol=1e-5, atol=1e-5)
              and bit_equal(df.cpu(), pooling.scatter_winner_plain(
                  g.cpu(), win.cpu(), n_points)),
              f"the backward of {name_fwd} differs ({label})")
        lib_f, lib_b = embedding_bag_pair(feature, index)
        rows_id = (index.long() + torch.arange(
            len(index), device=index.device)[:, None, None] * n_points)
        if pooled_slots is not None:
            rows_id = rows_id[pooled_slots(index, *extra)]
        touched = torch.unique(rows_id).numel()
        # K4's yardstick pools every slot, as K4 does; K9's too, where K9
        # pools its covered slots alone (`pooled_slots`), so only K4's is
        # held to the plain version
        lib = library_ms(lib_f, lambda out: pooled_slots is not None
                         or bit_equal(out.reshape(got[0].shape), ref[0]),
                         f"{name_fwd} {label}", bf16)
        rows_f.append({
            "shape": label, "max_abs_err": max_err(got, ref),
            "ms": cuda_ms(lambda: argmax(feature, index, *extra), 20),
            "plain_ms": cuda_ms(lambda: plain(feature, index, *extra), 3),
            "bytes": (touched * feature.shape[-1] * feature.element_size()
                      + nbytes(index, *got)),
            "ops": index.numel() * feature.shape[-1],
            "device_ms": device_ms(lambda: argmax(feature, index, *extra),
                                   10)}
            | lib | (kept(index) if kept else {}))
        rows_b.append({
            "shape": label, "max_abs_err": max_err(df, df_plain),
            "ms": cuda_ms(lambda: pooling.scatter_winner(g, win, n_points),
                          20),
            "plain_ms": cuda_ms(lambda: pooling.scatter_winner_plain(
                g, win, n_points), 5),
            "bytes": nbytes(g, win, df), "ops": g.numel(),
            "device_ms": device_ms(lambda: pooling.scatter_winner(
                g, win, n_points), 10)}
            | backward_parts(g, win, n_points)
            | backward_library(lib_b, g, win, n_points))
    record_rows(record, name_fwd, src, replaces, rows_f)
    return rows_b


def backward_parts(g, win, n: int) -> dict:
    """The backward's zero fill and its scatter's own work timed apart
    (device ms; the entry point's `parts`: the tile form, S <= 128, is one
    kernel, timed without its stores; the sort form onto zeros), beside the
    whole call."""
    from regnet_for_3d_grasping_torch.ops import pooling
    return {f"{part}_device_ms": device_ms(
        lambda: pooling.scatter_winner(g, win, n, code), 10)
        for part, code in (("fill", pooling.BACKWARD_FILL),
                           ("scatter", pooling.BACKWARD_SCATTER))}


def backward_library(embedding_bag_bwd, g, win, n: int) -> dict:
    """The library yardsticks of the backward: one ``index_add_`` of `g`
    into the flattened winner keys with its zero fill (atomic: another
    order of the same sums), and ``embedding_bag``'s backward (the max's
    gradient), where torch has one (not on bf16).  ``library_ms`` is
    ``embedding_bag``'s where it runs, else ``index_add_``'s."""
    B, S, C = g.shape
    keys = ((win.long() + torch.arange(B, device=g.device)[:, None, None]
             * n) * C + torch.arange(C, device=g.device)).reshape(-1)
    flat = g.reshape(-1)

    def index_add():
        return torch.zeros(B * n * C, dtype=g.dtype,
                           device=g.device).index_add_(0, keys, flat)

    add = {"index_add_ms": cuda_ms(index_add, 10),
           "index_add_device_ms": device_ms(index_add, 10)}
    try:
        return add | {"library_ms": cuda_ms(embedding_bag_bwd, 10),
                      "library_device_ms": device_ms(embedding_bag_bwd, 10),
                      "library": "embedding_bag backward"}
    except (RuntimeError, NotImplementedError):
        if g.dtype != torch.bfloat16:
            raise
    return add | {"library_ms": add["index_add_ms"],
                  "library_device_ms": add["index_add_device_ms"],
                  "library": "index_add_"}


def same_bits(got, ref) -> bool:
    """Bit for bit, but any NaN equal to any NaN: the card's f32 adds
    return the canonical NaN, the CPU's keep the operand's."""
    nan = got.isnan()
    return (got.dtype == ref.dtype and torch.equal(nan, ref.isnan())
            and bit_equal(torch.where(nan, 0, got),
                          torch.where(nan, 0, ref)))


def backward_edges(dev) -> None:
    """The pools' backward on adversarial winners and gradients, f32 and
    bf16, each bit-equal to the plain version's ordered sum (`same_bits`;
    f32 on CPU copies, bf16 on the card, whose loop over s is slow on the
    CPU) and to itself on a second call: every winner distinct at
    4,000 rows, every winner 0 (the slab's unpicked regions) at the
    training pools and at 4,000 rows (one chain of 4,000 a column), -0.0
    and NaN in g, C = 7, and rows at the two forms' edges (1, 128, 129)
    and past a long-form segment (2,049).  Prints each call's device
    time."""
    from regnet_for_3d_grasping_torch.ops import pooling
    rng = np.random.RandomState(15)
    n = N_POINTS

    def winners(kind, B, S, C):
        if kind == "distinct":
            return np.stack([rng.permutation(n)[:S] for _ in range(B * C)]
                            ).reshape(B, C, S).transpose(0, 2, 1)
        if kind == "zero":
            return np.zeros((B, S, C))
        return rng.randint(0, kind, (B, S, C))

    def grads(kind, B, S, C):
        g = rng.randn(B, S, C) * 10.0 ** rng.randint(-4, 5, (B, S, C))
        if kind == "signed zeros and NaN":
            g[rng.rand(B, S, C) < 0.3] = -0.0
            g[rng.rand(B, S, C) < 1e-4] = np.nan
            g[0, 0, 0] = np.nan
        return g

    cases = [
        ("every winner distinct, 1 x 4000 x 256", 1, 4000, 256, "distinct",
         None),
        ("every winner 0, 12 x 64 x 256", TRAIN_B, 64, 256, "zero", None),
        ("every winner 0, 1 x 4000 x 256", 1, 4000, 256, "zero", None),
        ("-0.0 and NaN in g, 12 x 64 x 256, 8 rows", TRAIN_B, 64, 256, 8,
         "signed zeros and NaN"),
        ("-0.0 and NaN in g, 1 x 4000 x 256, 40 rows", 1, 4000, 256, 40,
         "signed zeros and NaN"),
        ("C = 7, 12 x 64 x 7", TRAIN_B, 64, 7, 50, None),
        ("C = 7, 1 x 4000 x 7", 1, 4000, 7, 3, None),
        ("S = 1, 12 x 1 x 256", TRAIN_B, 1, 256, 5, None),
        ("S = 128, 2 x 128 x 256", 2, 128, 256, 30, None),
        ("S = 129, 2 x 129 x 256", 2, 129, 256, 30, None),
        ("S = 2049, 1 x 2049 x 40", 1, 2049, 40, 7, None)]
    for label, B, S, C, wkind, gkind in cases:
        win = torch.from_numpy(np.ascontiguousarray(
            winners(wkind, B, S, C).astype(np.int32)))
        g32 = torch.from_numpy(grads(gkind, B, S, C).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            g = g32.to(dtype)
            gd, wd = g.to(dev), win.to(dev)
            got = pooling.scatter_winner(gd, wd, n)
            ref = (pooling.scatter_winner_plain(g, win, n)
                   if dtype == torch.float32 else
                   pooling.scatter_winner_plain(gd, wd, n).cpu())
            check(bit_equal(got, pooling.scatter_winner(gd, wd, n))
                  and same_bits(got.cpu(), ref),
                  f"the pools' backward differs from the ordered sum "
                  f"({label}, {dtype})")
            ms = device_ms(lambda: pooling.scatter_winner(gd, wd, n), 5)
            print(f"backward edge {label}, {dtype}: bit-equal, device "
                  f"{ms:.4f} ms")


def pool_gradient(pool, feature, argmax_name, backward_name) -> tuple:
    """`pool` of a copy of `feature` that needs a gradient, and its
    backward of ones -> (the gradient, the pooled values); fails unless
    they launched the argmax form `argmax_name` once and the backward
    `backward_name` once, and no other kernel."""
    from regnet_for_3d_grasping_torch.ops import _cuda
    f = feature.clone().requires_grad_()
    before = dict(_cuda.launches)
    pooled = pool(f)
    pooled.backward(torch.ones_like(pooled))
    delta = {k: n - before[k] for k, n in _cuda.launches.items()
             if n != before[k]}
    check(delta == {argmax_name: 1, backward_name: 1} and f.grad is not None
          and f.grad.dtype == feature.dtype,
          f"a {feature.dtype} pool that needs a gradient launched {delta}")
    return f.grad, pooled


def kept_stats(index: torch.Tensor) -> dict:
    """The slots K4 reads (`pooling.kept_slots`: slot 0 and every slot
    whose row differs from slot 0's): mean, p90 and most a row, and the
    feature rows a call reads, beside the S*K that a walk of every slot
    reads."""
    from regnet_for_3d_grasping_torch.ops import pooling
    n = pooling.kept_slots(index).sum(-1).reshape(-1).float()
    out = {"kept_mean": float(n.mean()),
           "kept_p90": float(torch.quantile(n, 0.9)),
           "kept_max": int(n.max()), "rows_read": int(n.sum()),
           "rows_all_slots": index.numel()}
    print(f"  K4 reads {out['rows_read']} rows of {out['rows_all_slots']} "
          f"slots: {out['kept_mean']:.2f} a row (p90 {out['kept_p90']:.0f},"
          f" most {out['kept_max']}) of {index.shape[-1]}")
    return out


def bit_equal(got, ref) -> bool:
    """Equal bit for bit (a max copies values: nothing may round); floats
    are compared as the integers of their width."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        return False
    if got.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        got = got.view(view[got.element_size()])
        ref = ref.view(view[ref.element_size()])
    return torch.equal(got, ref)


def library_ms(fn, agrees, label, bf16: bool) -> dict:
    """The library yardstick's times; it must run and agree with the plain
    version (`agrees(output)`).  On bf16 rows (`bf16`) torch may refuse
    it: then None and the reason."""
    try:
        out = fn()
    except (RuntimeError, NotImplementedError) as e:
        if not bf16:
            raise
        reason = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        print(f"{label}: no library time ({reason})")
        return {"library_ms": None, "library_none": reason}
    check(agrees(out), f"the library yardstick disagrees ({label})")
    return {"library_ms": cuda_ms(fn, 20),
            "library_device_ms": device_ms(fn, 20)}


def k9_bf16_vec8(feature, index, off, win, spw, ref, label) -> dict:
    """K9's bf16 form at 8 channels a thread (16-byte loads, 8 row groups
    a block; its entry point's `vec` = 8, which the wrapper never asks
    for), bit-equal to the plain version `ref` and timed, to set beside
    the 4-channel form the wrapper runs."""
    from regnet_for_3d_grasping_torch.ops import _cuda
    (B, N, C), (S, K) = feature.shape, index.shape[1:]
    out = torch.empty(B, S, C, dtype=feature.dtype, device=feature.device)
    off = off.to(torch.int32).contiguous()

    def call():
        _cuda.launch("gather_max_slab_bf16", feature.device, feature, index,
                     off, out, B, N, C, S, K, win, spw, 8)
        return out

    check(bit_equal(call(), ref), f"K9 bf16 at 8 channels a thread "
          f"differs ({label})")
    row = {"vec8_ms": cuda_ms(call, 20), "vec8_device_ms": device_ms(call, 20)}
    print(f"gather_max_slab {label}: 8 channels a thread {row}")
    return row


def gather_max_case(label, feature, index) -> dict:
    """Phase 3 for K4's forward at one shape, f32 or bf16 rows: equal bit
    for bit to `gather_max_plain` and to ``embedding_bag`` (max), where
    torch runs it; times with and without the host, the plain version's
    and the library's; the bound counts the feature rows the indices
    touch (each read once, at the rows' element size), not all of them."""
    from regnet_for_3d_grasping_torch.ops import pooling
    got = pooling.gather_max(feature, index)
    ref = pooling.gather_max_plain(feature, index)
    check(bit_equal(got, ref), f"K4 gather-max differs ({label})")

    def embedding_bag():
        return torch.nn.functional.embedding_bag(
            index[0].long(), feature[0], mode="max")

    print(f"gather_max {label}:")
    return {"shape": label, "max_abs_err": max_err(got, ref),
            "ms": cuda_ms(lambda: pooling.gather_max(feature, index), 20),
            "plain_ms": cuda_ms(lambda: pooling.gather_max_plain(
                feature, index), 5),
            "bytes": (torch.unique(index).numel() * feature.shape[-1]
                      * feature.element_size() + nbytes(index, got)),
            # the compares this run's data needs: one a kept slot and channel
            "ops": int(pooling.kept_slots(index).sum()) * feature.shape[-1],
            "device_ms": device_ms(lambda: pooling.gather_max(feature, index),
                                   20)} \
        | library_ms(embedding_bag, lambda out: torch.equal(out[None], ref),
                     f"K4 {label}", feature.dtype == torch.bfloat16) | kept_stats(index)


ROW_KEYS = ("shape", "max_abs_err", "ms", "plain_ms", "bytes", "ops",
            "library_ms", "device_ms", "library_device_ms")


def record_rows(record, name, src, replaces, rows) -> None:
    """One record from per-shape rows: the first is the main path's shape,
    the others go under ``also`` with their own bounds.  The first row's
    other fields (cluster size, sweeps, launches per call) are kept as
    they are."""
    first, also = rows[0], []
    for r in rows[1:]:
        also.append({k: v for k, v in r.items() if k not in ("bytes", "ops")}
                    | {"bound_ms": bound(r["bytes"], r["ops"])[0]})
    record(name, src, replaces, first["max_abs_err"], first["ms"],
           first["plain_ms"], first["bytes"], first["ops"],
           first.get("library_ms"), also=also or None, shape=first["shape"],
           extra={k: v for k, v in first.items() if k not in ROW_KEYS},
           **{k: first[k] for k in ("device_ms", "library_device_ms")
              if k in first})


def fps_kernels(dev, xyz, record) -> torch.Tensor:
    """Phase 3 for K1: the cluster kernel against `fps_plain` (equal to the
    bit) at every shape the serving (one cloud) and training (12 clouds)
    paths launch, and at the edge cases: an N that no cluster size divides,
    rows whose points are all masked, duplicated points (equal distances in
    every block of a cluster) and more samples than valid points.  Each
    shape's cluster size R, time and time per step (ms / S) are recorded
    beside the bound, and every R whose chunk fits a block is timed apart at
    the three serving shapes (`cluster_sweep`).  Returns the SA1 picks."""
    from regnet_for_3d_grasping_torch.ops import fps
    tx = train_clouds(dev)
    ones = torch.ones(1, N_POINTS, dtype=torch.bool, device=dev)

    def picks(x, s):
        i = fps.fps(x, fps.dist_init(x, None), s).long()
        return torch.gather(x, 1, i[..., None].expand(-1, -1, 3)).contiguous()

    sa2, sa2_12 = picks(xyz, 5120), picks(tx, 5120)
    sa3, sa3_12 = picks(sa2, 1024), picks(sa2_12, 1024)
    nan_x = xyz.clone()
    nan_x[..., 0] = float("nan")
    tiles = xyz[:, :1600].repeat(1, 16, 1).contiguous()
    few = torch.zeros_like(ones)
    few[:, ::256] = True
    cases = [  # (label, xyz, mask, S)
        ("serving SA1 25600->5120, B=1", xyz, None, 5120),
        ("serving centers, masked 25600->4000, B=1", xyz,
         xyz[..., 2] > 0.76, N_CENTERS),
        ("serving SA2 5120->1024, B=1", sa2, None, 1024),
        ("serving SA3 1024->256, B=1", sa3, None, 256),
        ("training SA1 25600->5120, B=12", tx, None, 5120),
        ("training SA2 5120->1024, B=12", sa2_12, None, 1024),
        ("training SA3 1024->256, B=12", sa3_12, None, 256),
        ("training centers, masked 25600->64, B=12", tx, tx[..., 2] > 0.76,
         TRAIN_CENTERS),
        ("edge: N=25599, which no cluster size divides",
         xyz[:, :25599].contiguous(), None, 512),
        ("edge: a fully masked row (all-valid fallback) and a NaN-x row "
         "(all -1), B=3", torch.cat([xyz, xyz, nan_x]),
         torch.cat([xyz[..., 2] > 0.76, ~ones, ones]), 256),
        ("edge: 1,600 points 16 times over (ties across blocks)", tiles,
         None, 1024),
        ("edge: 100 valid points, S=300", xyz, few, 300),
        ("edge: 10 points, fewer than blocks, S=12",
         xyz[:, :10].contiguous(), None, 12)]
    rows = []
    for label, x, mask, S in cases:
        dist = fps.dist_init(x, mask)
        B, N = dist.shape
        occupancy = fps.max_clusters(x.device, N)
        R = fps.cluster_size(B, N, occupancy)
        got, ref = fps.fps(x, dist, S), fps.fps_plain(x, dist, S)
        check(torch.equal(got, ref), f"K1 fps differs ({label}, R={R})")
        ms = cuda_ms(lambda: fps.fps(x, dist, S), 5 if not rows else 3)
        print(f"fps {label}: R={R} (clusters the card holds by size "
              f"{occupancy}), {ms:.4f} ms, {ms / S * 1e3:.3f} us per step")
        row = {"shape": label, "cluster": R, "max_abs_err": max_err(got, ref),
               "ms": ms, "ms_per_step": ms / S,
               "bytes": nbytes(x, dist, got), "ops": B * S * N * 10}
        if not rows:
            sa1 = got
            row["plain_ms"] = cuda_ms(lambda: fps.fps_plain(x, dist, S), 2)
        if label.startswith("serving SA"):
            row["ms_by_cluster_size"] = cluster_sweep(
                "fps", label, x, dist, got, B, N, S)
        rows.append(row)
    record_rows(record, "fps", CSRC + "fps.cu", JAX_OPS + "fps_pallas.py:260",
                rows)
    return sa1


def cluster_sweep(kernel, label, x, dist, got, B, N, S, *groups) -> dict:
    """{R: ms} of K1 (`kernel` "fps") or K10 ("fps_grouped", `groups` the
    slices) forced to every cluster size R whose chunk fits a block, each
    run equal to `got`."""
    from regnet_for_3d_grasping_torch.ops import _cuda, fps
    out, sweep = torch.empty_like(got), {}
    n = N // groups[0] if groups else N
    for r in fps.CLUSTER_SIZES:
        if -(-n // r) > fps._MAX_BLOCK_POINTS:
            continue

        def forced():
            _cuda.launch(kernel, x.device, x, dist, out, B, N, S, *groups, r)

        forced()
        check(torch.equal(out, got), f"{kernel} differs at R={r} ({label})")
        sweep[r] = cuda_ms(forced, 10)
    print(f"{kernel} {label} by cluster size, ms: {sweep}")
    return sweep


def kernel_profile(calls: dict, reps: int = 5) -> dict:
    """{label: (device activities per call, {kernel name: device ms per
    call})} of the functions `calls` {label: fn}, each called `reps` times
    inside its own ``record_function`` range under one torch.profiler
    session (the card's events of a range are those that start inside it:
    each range ends with a synchronize).  Every kernel launch and every
    copy or memset that a call puts on the card counts.  A range idles
    `gap` seconds before its first call and after its synchronize: the
    card's timestamps, brought onto the host's clock, landed an event of
    one range inside its neighbour when the ranges touched (2.2 activities
    a call in one run of a two-launch call)."""
    import re

    from torch.profiler import ProfilerActivity, profile, record_function
    gap = 0.005
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, fn in calls.items():
            with record_function(label):
                time.sleep(gap)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(gap)
    events = prof.events()
    # the card's events, less the ranges' own annotations on the card
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in calls]
    out = {}
    for label in calls:
        rng = next(e.time_range for e in events if e.name == label)
        names = {}
        inside = [e for e in device
                  if rng.start <= e.time_range.start <= rng.end]
        for e in inside:
            m = re.search(r"::(\w+_kernel)", e.name)
            key = m.group(1) if m else e.name[:60]
            names[key] = names.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
        out[label] = (len(inside) / reps,
                      {k: v / reps for k, v in names.items()})
    return out


def select_case(name, label, sc, call, plain, public, inputs, test_ops
                ) -> tuple:
    """Phase 3 for one K6 or K7 shape: `call` (the selection and its span
    table) against `plain` (the same from `slab_bounds`, the plain
    selection and `finish_select`), indices, counts, masks, offsets and the
    span table exact, and the public wrapper equal to both; times of the
    call, with and without the host, and of the plain version.  The bound
    counts `test_ops` per scanned pair and 10 per passing pair (hash and
    argmax).  Returns (the outputs, the record row, the public call), the
    last for `select_launches`."""
    from regnet_for_3d_grasping_torch.ops import slab
    got, ref = call(), plain()
    check(torch.equal(got[4], ref[4]), f"{name}: the card's span table "
          f"differs from slab_bounds ({label})")
    check(all_equal(got, ref) and all_equal(public(), ref[:4]),
          f"{name} differs from its plain version ({label})")
    check(torch.equal(got[4][..., 2], got[3]), f"{name}: off_blk is not the "
          f"span table's origin column ({label})")
    M, N = got[0].shape[1], sc.xyz.shape[1]
    pairs = scanned_pairs(got[4], M, 128, 2048, N)
    passing = int(got[1].sum())
    print(f"{name} {label}: {pairs} pairs scanned of "
          f"{got[0].shape[0] * M * N}, {passing} passing, "
          f"{int(got[2].sum())} rows with a pick")
    row = {"shape": label, "max_abs_err": max_err(got, ref),
           "ms": cuda_ms(public, 20), "plain_ms": cuda_ms(plain, 3),
           "device_ms": device_ms(public, 20),
           "bytes": nbytes(sc.xyz, sc.cell_row, *inputs, *got),
           "ops": pairs * test_ops + passing * 10}
    return got[:4], row, public


def select_launches(cases: dict, scan_calls: dict) -> dict:
    """The device activities of one K6 or K7 call, at every shape of
    `cases` {label: (record row, public call)}: the three launches (span
    table, selection, fill) and nothing else, each kernel's device time
    added to the row; and of one call of K11, K5, K2 or K3 at every shape
    of `scan_calls` {label: (call, the kernels it launches)}: those
    launches (K11, K5, K2: scan and fill; K3: the split, and the merge
    where it splits the keys; K8: span table, scan and merge, and K3's two
    launches after it), no copy, no memset.  One profiler session for all
    (a later session in the same process can lose or misplace device
    events).  Returns the profile (`kernel_profile`)."""
    prof = kernel_profile({label: fn for label, (_, fn) in cases.items()}
                          | {label: fn for label, (fn, _) in
                             scan_calls.items()})
    for label, (row, _) in cases.items():
        n_act, per_kernel = prof[label]
        print(f"{label}: {n_act:g} device activities a call, device ms "
              f"{per_kernel}")
        check(n_act == 3 and "slab_select_kernel" in per_kernel,
              f"{n_act} device activities in one call ({label}), expected "
              f"the 3 launches of the span table, selection and fill: "
              f"{per_kernel}")
        row["launches_per_call"] = n_act
        row["kernel_device_ms"] = per_kernel
    for label, (_, kernels) in scan_calls.items():
        n_act, per_kernel = prof[label]
        print(f"{label}: {n_act:g} device activities a call, device ms "
              f"{per_kernel}")
        check(n_act == len(kernels) and set(kernels) == set(per_kernel),
              f"{n_act} device activities in one call ({label}), expected "
              f"{sorted(kernels)}: {per_kernel}")
    return prof


def radius_test_ops(x, c, r2: float, strict: bool = False,
                    chunk: int = 256) -> tuple:
    """The float operations an exact radius test (K11's d2 <= r2, or K2's
    d2 < r2 with `strict`; d = center - point squares as point - center
    does) needs on this run's pairs, the pairs inside the x slab and the
    pairs in radius: dx, its square and a compare (3) on every pair, since
    the rounded sum of squares is at least dx*dx; dy, dz, their squares,
    two adds and the compare (7) only inside the slab (dx*dx <= r2, or
    < r2)."""
    slab = inside = 0
    for m0 in range(0, c.shape[1], chunk):
        d = [c[:, m0:m0 + chunk, None, i] - x[:, None, :, i]
             for i in range(3)]
        xx = d[0] * d[0]
        d2 = (xx + d[1] * d[1]) + d[2] * d[2]
        if strict:
            slab += int((xx < r2).sum())
            inside += int((d2 < r2).sum())
        else:
            slab += int((xx <= r2).sum())
            inside += int((d2 <= r2).sum())
    pairs = c.shape[0] * c.shape[1] * x.shape[1]
    return pairs * 3 + slab * 7, slab, inside


def expansion_test_ops(x, c, pairs: int | None = None) -> int:
    """The float operations of K12's expansion test on `pairs` (center,
    point) pairs, by default all of them (the bucket scan K12 ran before
    its cell grid tested every pair: the expansion-form distance rounds
    unlike the difference form, so no slab rules a pair out): the cross
    term (a product and two fused multiply-adds), -2 cross + |c|^2,
    + |p|^2 and the compare (6) a pair; |p|^2 and |c|^2 (5 each) once a
    point and once a center."""
    B, M = c.shape[:2]
    N = x.shape[1]
    if pairs is None:
        pairs = B * M * N
    return pairs * 6 + B * (M + N) * 5


def box_test_ops(x, frames, bases, box, chunk: int = 256) -> tuple:
    """The float operations an exact box test (K5's, crop_plain's products)
    needs on this run's pairs, and the pairs inside the z slab and inside
    the z and x slabs: the offset and the frame's z row, its abs and a
    compare (10) on every pair; the x row and its two compares (7) only
    inside the z slab; the y row, abs and compare (7) only inside both.
    Also the pairs inside the box."""
    xlo, xhi, yabs, zabs = (float(np.float32(v)) for v in box)
    in_z = in_zx = inside = 0
    for m0 in range(0, frames.shape[1], chunk):
        f = frames[:, m0:m0 + chunk]
        c = bases[:, m0:m0 + chunk]
        r = [x[:, None, :, i] - c[:, :, None, i] for i in range(3)]

        def row(j):
            return (f[:, :, 0, j, None] * r[0] + f[:, :, 1, j, None] * r[1]
                    ) + f[:, :, 2, j, None] * r[2]

        z = row(2).abs() < zabs
        l0 = row(0)
        zx = z & (l0 > xlo) & (l0 < xhi)
        in_z += int(z.sum())
        in_zx += int(zx.sum())
        inside += int((zx & (row(1).abs() < yabs)).sum())
    pairs = frames.shape[0] * frames.shape[1] * x.shape[1]
    return pairs * 10 + in_z * 7 + in_zx * 7, (in_z, in_zx), inside


def bucket_scan_case(name, label, call, plain, inputs, ops, passing, kernel,
                     k, bucket) -> dict:
    """Phase 3 for one K11, K5 or K2 shape: the call against its plain
    version (indices and counts equal to the bit); its time with and
    without the host, and the plain version's; the grid that
    ``ops/bucket_scan.scan_grid`` picks with `kernel`'s constants; pairs
    per ns and the bound's share of the device time.  The bound counts
    `ops`: an exact test on this run's pairs (`radius_test_ops`,
    `box_test_ops`) and the pick's work on the `passing` pairs."""
    from regnet_for_3d_grasping_torch.ops import _cuda, bucket_scan
    got, ref = call(), plain()
    check(all_equal(got, ref),
          f"{name} differs from its plain version ({label})")
    (batch, m), n = got[1].shape, inputs[0].shape[1]
    dev = got[0].device
    grid = bucket_scan.scan_grid(batch, m, n, k, bucket,
                                 _cuda.sm_count(dev),
                                 *bucket_scan.limits(kernel, dev))
    pairs = batch * m * n
    row = {"shape": label, "max_abs_err": max_err(got, ref),
           "ms": cuda_ms(call, 20), "plain_ms": cuda_ms(plain, 3),
           "device_ms": device_ms(call, 20),
           "bytes": nbytes(*inputs, *got), "ops": ops, "grid": list(grid)}
    row["pairs_per_ns"] = pairs / row["device_ms"] / 1e6
    row["bound_share"] = bound(row["bytes"], row["ops"])[0] / row["device_ms"]
    print(f"{name} {label}: tile {grid[0]} x range {grid[1]}, {pairs} "
          f"pairs, {passing} passing, {int((got[1] > 0).sum())} of {m * batch}"
          f" rows non-empty, {row['ops']} operations, "
          f"{row['pairs_per_ns']:.1f} pairs/ns, bound share "
          f"{row['bound_share']:.3f}, call {row['ms']:.4f} ms, device "
          f"{row['device_ms']:.4f} ms")
    return row


def bucket_scan_edges(dev) -> None:
    """K11, K12, K5 and K2 against their plain versions at small shapes
    (K12 through both its passes, with buckets of ceil(N / K) columns, 69
    to 4,500, and centers in chunks of 50, the last short, and at M = 130
    in 65 chunks of 2 through the grid, two query launches of at most 64
    seeds after one build): M not
    a multiple of any tile, M = 1, B = 3, N not a multiple of L, K*L > N,
    L = 512 (the serving width of K5 and K2), L = 1,280 (two 1,024-column
    segments a bucket), L = 4,608 (wider than a block stages: windows of
    3,072 columns, the last bucket cut at N), the last center far from
    every point, more points in radius than K (K2 caps its count); points
    exactly on the radius of center 0 (0.125 - 0.0625 = 0.0625: d2 = r2,
    inside for K11, outside for K2) and just outside it, and, in center 0's
    identity
    frame, exactly on the box's faces (all outside) beside two inside; a
    frame that is not orthonormal.  Then K2 through `ball_query` at
    N = 25,600 with K = 8, 16 and 24 (L = 3,200, 1,664 and 1,152), M =
    1,400: shapes the dispatcher sends to the kernel, with buckets wider
    than 1,024 columns."""
    from regnet_for_3d_grasping_torch.geometry.codec import grasps_to_frames
    from regnet_for_3d_grasping_torch.ops import (ball_query, crop, group,
                                                  sampling)
    g = torch.Generator().manual_seed(7)
    box = (0.0, 0.03125, 0.015625, 0.0078125)
    r2 = float(np.float32(0.0625 ** 2))
    for B, N, M, K in ((3, 1100, 130, 16), (1, 1100, 1, 16),
                       (2, 5000, 77, 64), (3, 700, 65, 8),
                       (2, 3500, 70, 8), (2, 5000, 70, 4),
                       (1, 9000, 33, 2)):
        x = torch.rand(B, N, 3, generator=g) * 0.25
        c = x[:, torch.randperm(N, generator=g)[:M]].clone()
        c[:, -1] = 5.0
        if M > 1:
            c[:, 0] = 0.125
            x[:, 3] = torch.tensor([0.0625, 0.125, 0.125])
            x[:, 4] = torch.tensor([0.125, 0.125, 0.0625 - 2 ** -26])
            x[:, 5:11] = torch.tensor([
                [0.125 + box[1], 0.125, 0.125], [0.125, 0.125, 0.125],
                [0.140625, 0.125 + box[2], 0.125],
                [0.140625, 0.125, 0.125 - box[3]],
                [0.140625, 0.125, 0.125],
                [0.140625, 0.1328125, 0.12890625]])
        axis = torch.nn.functional.normalize(
            torch.randn(B, M, 3, generator=g), dim=-1)
        theta = (torch.rand(B, M, 1, generator=g) * 2 - 1) * np.pi
        frames, bases = grasps_to_frames(torch.cat([c, axis, theta], -1))
        frames[:, 0] = torch.eye(3)
        bases[:, 0] = c[:, 0]
        if M > 2:   # a frame that is not orthonormal
            frames[:, 1] = torch.randn(B, 3, 3, generator=g)
        x, c, frames, bases = (t.to(dev).contiguous()
                               for t in (x, c, frames, bases))
        L = sampling.pallas_bucket_stride(N, K)
        got = group.group_regions_fused(x, c, 9, 0.0625, K, L)
        ref = group.group_regions_fused_plain(x, c, 9, 0.0625, K, L)
        check(all_equal(got, ref), f"K11 differs at edge shape B={B} N={N} "
              f"M={M} K={K} L={L}")
        # chunks of 50 centers; at M = 130 also chunks of 2: 65 seeds, more
        # than one launch takes (two launches)
        for ch in {min(50, M), 2 if M == 130 else min(50, M)}:
            seeds = [9 + 1000 * i for i in range(-(-M // ch))]
            r12 = group.group_regions_chunked_plain(x, c, seeds, 0.0625, K,
                                                    ch)
            for via in ("grid", "direct")[:2 if len(seeds) <= 64 else 1]:
                with k12_pass(via):
                    g12 = group.group_regions_chunked(x, c, seeds, 0.0625, K,
                                                      ch)
                check(all_equal(g12, r12), f"K12 ({via}) differs at edge "
                      f"shape B={B} N={N} M={M} K={K} "
                      f"L={sampling.bucket_stride(N, K)}, chunks of {ch}")
        gc = crop.closing_region_crop(x, frames, bases, 9, box, K, L)
        rc = crop.crop_plain(x, frames, bases, 9, box, K, L)
        check(all_equal(gc, rc), f"K5 differs at edge shape B={B} N={N} "
              f"M={M} K={K} L={L}")
        gb = ball_query.ball_query_bucketed(x, c, r2, K, L)
        rb = ball_query.ball_query_bucketed_plain(x, c, r2, K, L)
        check(all_equal(gb, rb), f"K2 differs at edge shape B={B} N={N} "
              f"M={M} K={K} L={L}")
        print(f"edge B={B} N={N} M={M} K={K} L={L}: K11 {int(got[1].sum())}"
              f" in radius, K12 {int(g12[1].sum())}, K5 "
              f"{int(gc[1].sum())} inside, K2 "
              f"{int((gb[1] == K).sum())} of {B * M} counts capped at K; all "
              f"equal")
    x = torch.rand(1, 25600, 3, generator=g).to(dev) * 0.25
    c = x[:, :1400].contiguous()
    r = 0.01    # about 7 points in radius: first hits in every segment
    for K in (8, 16, 24):
        L = sampling.pallas_bucket_stride(25600, K)
        check(ball_query.use_kernel(1400, 25600, K) and L > 1024,
              f"K2 edge K={K}: not a kernel shape with L > 1024")
        got = ball_query.ball_query(x, c, r, K)
        ref = ball_query.ball_query_bucketed_plain(
            x, c, float(np.float32(r * r)), K, L)
        check(all_equal(got, ref), f"K2 differs at N=25600 K={K} L={L}")
        print(f"edge K2 through ball_query N=25600 M=1400 K={K} L={L}: "
              f"{int((got[1] == K).sum())} of 1400 counts capped; equal")


# the serving forward's group seeds in phase 3: 4,000 centers, 4 chunks
SERVING_GROUP_SEEDS = [21, 22, 23, 24]


@contextlib.contextmanager
def k12_pass(via: str):
    """K12 through its grid pass or its direct pass inside the block,
    whatever `group.route` would pick (its pair limit moved out of reach
    either way)."""
    from regnet_for_3d_grasping_torch.ops import group
    with replaced(group, "DIRECT_PAIRS", 1 << 62 if via == "direct" else -1):
        yield


@contextlib.contextmanager
def k12_scratch():
    """Yields a list that gets the scratch of every K12 grid call inside
    the block (`group.grid_scratch`), whose grid `group.grid_views`
    reads."""
    from regnet_for_3d_grasping_torch.ops import group
    made = []
    make = group.grid_scratch

    def keep(*args):
        made.append(make(*args))
        return made[-1]

    with replaced(group, "grid_scratch", keep):
        yield made


def grid_group_case(label, x, c, seeds, chunk, radius=0.008, K=256,
                    reps=20) -> tuple:
    """Phase 3 for one K12 shape: the call against the plain chunked path
    (indices and counts equal to the bit), through the pass `group.route`
    picks and through the other; the grid the build wrote
    (`group.grid_views` of the call's scratch) against `grid_plan`, and its
    cells' first records against the plan's cells; the records a center
    tests (a direct pass: every point) and the cells it visits
    (`grid_candidates`); the times of the call with and without the host,
    of the plain version and of the other pass.  The bound counts what the
    function needs on this run's data, whichever pass runs: its bytes
    (cloud and centers read once, indices and counts written once) and its
    operations (the expansion test on the records the grid pass would
    test, 13 a pair in radius for the hash and the key), the larger;
    `all_pairs_bound_ms` is the bound the bucket-scan design was held to,
    the expansion test on every pair.  Returns (the row, the call, the
    kernels it launches)."""
    from regnet_for_3d_grasping_torch.ops import _cuda, group
    B, N = x.shape[:2]
    M = c.shape[1]
    r2 = group.radius2(radius)
    kind, per = group.route(B, M, N, K, len(seeds), _cuda.sm_count(x.device))

    def call(via=None):
        if via is None:
            return group.group_regions_chunked(x, c, seeds, radius, K, chunk)
        with k12_pass(via):
            return group.group_regions_chunked(x, c, seeds, radius, K, chunk)

    def plain():
        return group.group_regions_chunked_plain(x, c, seeds, radius, K,
                                                 chunk)

    ref = plain()
    for via in ("grid", "direct"):
        check(all_equal(call(via), ref), f"group_regions_chunked ({via}) "
              f"differs from its plain version ({label})")
    with k12_scratch() as made:
        call("grid")
    plan = group.grid_plan(x, r2)
    _, grids, starts, _ = group.grid_views(made[0], B, N)
    check(all(torch.equal(a, b) for a, b in zip(group.grid_read(grids),
                                                   plan)),
          f"K12's grid differs from grid_plan ({label}): "
          f"{group.grid_read(grids)} against {plan}")
    cells = group.grid_cells(x, plan)
    for b, (gx, gy, gz) in enumerate(plan.dims.tolist()):
        ok = cells[b, :, 0] >= 0
        lin = (cells[b, ok, 2] * gy + cells[b, ok, 1]) * gx + cells[b, ok, 0]
        want = torch.cumsum(torch.bincount(lin, minlength=gx * gy * gz), 0)
        check(torch.equal(starts[b, 1:gx * gy * gz + 1].long(), want)
              and int(starts[b, 0]) == 0,
              f"K12's cell starts differ from grid_plan's cells ({label})")
    got = call()
    pairs, visited = group.grid_candidates(x, c, r2)
    inside = int(ref[1].sum())
    tested = int(pairs.sum()) if kind == "grid" else B * M * N
    byts = nbytes(x, c, *got)
    other = "direct" if kind == "grid" else "grid"
    row = {"shape": label, "max_abs_err": max_err(got, ref),
           "route": f"{kind} ({per} centers a block)" if per else kind,
           "ms": cuda_ms(call, reps), "plain_ms": cuda_ms(plain, 3),
           "device_ms": device_ms(call, reps),
           f"{other}_device_ms": device_ms(lambda: call(other), reps),
           "bytes": byts,
           "ops": expansion_test_ops(x, c, int(pairs.sum())) + inside * 13,
           "grid_dims": plan.dims.tolist(),
           "cell_side": [1 / float(v) for v in plan.inv_h],
           "pairs_tested": tested, "pairs_in_radius": inside,
           "pairs_tested_per_center": tested / (B * M),
           "grid_pairs_tested_per_center": float(pairs.double().mean()),
           "grid_pairs_tested_max": int(pairs.max()),
           "cells_visited_per_center": float(visited.double().mean()),
           "cells_visited_max": int(visited.max())}
    all_pairs = bound(byts, expansion_test_ops(x, c) + inside * 13)[0]
    row["bound_share"] = bound(byts, row["ops"])[0] / row["device_ms"]
    row["all_pairs_bound_ms"] = all_pairs
    row["all_pairs_bound_share"] = all_pairs / row["device_ms"]
    print(f"group_regions_chunked {label}: {row['route']}; grid "
          f"{row['grid_dims']} of cells {row['cell_side']}, "
          f"{row['grid_pairs_tested_per_center']:.2f} records a center in "
          f"the grid pass ({100 * row['grid_pairs_tested_per_center'] / N:.3f}"
          f" % of {N}; most {row['grid_pairs_tested_max']}), "
          f"{row['cells_visited_per_center']:.2f} cells visited a center "
          f"(most {row['cells_visited_max']}); this pass tests "
          f"{row['pairs_tested_per_center']:.2f} a center; {inside} pairs in "
          f"radius, bound share {row['bound_share']:.3f} (all-pairs "
          f"{row['all_pairs_bound_share']:.3f}), call {row['ms']:.4f} ms, "
          f"device {row['device_ms']:.4f} ms, {other} pass "
          f"{row[f'{other}_device_ms']:.4f} ms")
    kernels = (("grid_build_kernel", "grid_query_kernel") if kind == "grid"
               else ("direct_kernel",))
    return row, call, kernels


def boundary_cloud(xyz, c, radius=0.008) -> tuple:
    """The serving cloud with a fifth of its points moved onto cell
    boundaries of its grid on x (half on the first f32 of a cell, half on
    the last of the cell below; none in the first cell, at the largest x or
    near the cloud's largest norm, so the grid stays), and a copy of `c`
    moved on x so that each center's box starts at a boundary (where the
    search finds it)."""
    from regnet_for_3d_grasping_torch.ops import group
    r2 = group.radius2(radius)
    plan = group.grid_plan(xyz, r2)
    lo, inv_h = plan.lo[0, 0], plan.inv_h[0]

    def cell(v):
        return torch.floor((v - lo) * inv_h)

    def first_of_cell(k):
        """The least f32 of cell k: lo + k h, then a few steps either way."""
        v = (lo.double() + k.double() / inv_h.double()).float()
        down, up = torch.full_like(v, -math.inf), torch.full_like(v, math.inf)
        for _ in range(8):
            v = torch.where(cell(v) >= k, torch.nextafter(v, down), v)
        for _ in range(8):
            v = torch.where(cell(v) < k, torch.nextafter(v, up), v)
        return v

    g = torch.Generator(device=xyz.device).manual_seed(5)
    x = xyz.clone()
    ok = ((x[0].double().norm(dim=-1) < 0.99 * plan.p_norm[0])
          & (cell(x[0, :, 0]) >= 1) & (x[0, :, 0] < plan.hi[0, 0]))
    pick = torch.nonzero(ok)[:, 0]
    pick = pick[torch.randperm(len(pick), generator=g,
                               device=xyz.device)[:N_POINTS // 5]]
    k = cell(x[0, pick, 0])
    on = first_of_cell(k)
    half = len(pick) // 2
    x[0, pick[:half], 0] = on[:half]
    x[0, pick[half:], 0] = torch.nextafter(
        on[half:], torch.full_like(on[half:], -math.inf))
    below = torch.nextafter(on, torch.full_like(on, -math.inf))
    exact = int(((cell(on) == k) & (cell(below) == k - 1)).sum())
    after = group.grid_plan(x, r2)
    check(all(torch.equal(a, b) for a, b in zip(plan, after)),
          "boundary cloud: moving points onto boundaries moved the grid")
    # centers whose box starts (x - rho, rounded outward) at a boundary
    cb = c.clone()
    d = cb[0].double()
    rho = group.reach(torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                                 + d[:, 2] * d[:, 2]), plan.p_norm[0], r2)
    edge = first_of_cell(cell(cb[0, :, 0] - rho))
    cx = edge + rho
    down, up = torch.full_like(cx, -math.inf), torch.full_like(cx, math.inf)
    for _ in range(64):
        start = torch.nextafter(cx - rho, down)
        cx = torch.where(start > edge, torch.nextafter(cx, down),
                         torch.where(start < edge, torch.nextafter(cx, up),
                                     cx))
    cb[0, :, 0] = cx
    on_edge = int((torch.nextafter(cx - rho, down) == edge).sum())
    print(f"boundary cloud: {len(pick)} points moved, {exact} boundaries "
          f"exact (the first f32 of cell k, the one below in k - 1); "
          f"{on_edge} of {cb.shape[1]} centers' boxes start at a boundary")
    return x, cb


def grid_group_edges(xyz, c4000) -> None:
    """K12 at 25,600 points, through both passes, on clouds the CPU tests
    hold the emulation on:
    points on cell boundaries and centers whose box starts at one; the
    cloud 75 m from the origin (the expansion form's rounding passes
    points beyond the radius there, and the reach covers them); every
    point in one cell (a 0.1 mm cube, each center in radius of all)."""
    from regnet_for_3d_grasping_torch.ops import group
    bx, bc = boundary_cloud(xyz, c4000)
    far = xyz + 75.0
    g = torch.Generator(device=xyz.device).manual_seed(9)
    one = 0.4 + torch.rand(1, N_POINTS, 3, generator=g,
                           device=xyz.device) * 1e-4
    for label, x, c, radius, seeds, chunk in (
            ("cell boundaries", bx, bc, 0.008, SERVING_GROUP_SEEDS, 1024),
            ("75 m from the origin", far, c4000 + 75.0, 0.008,
             SERVING_GROUP_SEEDS, 1024),
            ("one cell", one, one[:, :64] + 2e-5, 0.01, [7], 64)):
        ref = group.group_regions_chunked_plain(x, c, seeds, radius, 256,
                                                chunk)
        for via in ("grid", "direct"):
            with k12_pass(via):
                got = group.group_regions_chunked(x, c, seeds, radius, 256,
                                                  chunk)
            check(all_equal(got, ref),
                  f"K12 ({via}) differs on the {label} cloud")
        pairs, cells = group.grid_candidates(x, c, group.radius2(radius))
        print(f"edge K12 {label}: {int(got[1].sum())} pairs in radius, "
              f"{float(pairs.double().mean()):.1f} records tested a center, "
              f"{float(cells.double().mean()):.2f} cells visited; equal")


def group_chunked_kernels(xyz, c4000, tx, c12, c64, record,
                          scan_calls) -> tuple:
    """Phase 3 for K12, the served grouping, at serving (4,000 centers in 4
    chunks of 1,024, one seed each), at a training batch (12 x 64) and at
    a validation forward (1 x 64): `grid_group_case` at each, and its edge
    clouds (`grid_group_edges`).  Returns the serving call's output."""
    from regnet_for_3d_grasping_torch.geometry import region
    from regnet_for_3d_grasping_torch.ops import group
    rows = []
    for label, x, c, seeds in (
            ("serving: 4000 centers x 25600 points, 4 chunks", xyz, c4000,
             SERVING_GROUP_SEEDS),
            ("training: 12 clouds x 64 centers x 25600 points", tx, c12,
             [22]),
            ("validation: 1 cloud x 64 centers", xyz, c64, [21])):
        chunk = min(region.GROUP_CENTER_CHUNK, c.shape[1])
        row, call, kernels = grid_group_case(label, x, c, seeds, chunk)
        rows.append(row)
        scan_calls[f"group_regions_chunked {label}"] = (call, kernels)
    grid_group_edges(xyz, c4000)
    record_rows(record, "group_regions_chunked", CSRC + "grid_group.cu",
                "regnet_for_3d_grasping_tpu/geometry/region.py:160-185 "
                "(the XLA path of group_regions)", rows)
    return group.group_regions_chunked(xyz, c4000, SERVING_GROUP_SEEDS,
                                       0.008, 256, region.GROUP_CENTER_CHUNK)


def ball_query_kernels(xyz, centers, tx, c12, record, scan_calls) -> None:
    """Phase 3 for K2, the SA1 ball query (r 0.02, K 64, L 512) on the
    bucket scan, against its plain version at serving (the cloud's 5,120
    SA1 `centers`) and at a training batch (the 12 clouds `tx` and their
    5,120 SA1 centers `c12`), with the grid, pairs/ns and the bound's
    share (its edge shapes run in `bucket_scan_edges`); its two launches a
    call are counted in `select_launches`.  The bound counts an exact
    strict radius test on this run's pairs (`radius_test_ops`) and, on
    each pair in radius, its count and its place in the bucket's first-hit
    minimum (2)."""
    from regnet_for_3d_grasping_torch.ops import ball_query, sampling
    r2 = float(np.float32(0.02 * 0.02))
    L = sampling.pallas_bucket_stride(N_POINTS, 64)
    rows = []
    for label, x, c in (
            ("serving: 5120 centers x 25600 points", xyz, centers),
            ("training: 12 clouds x 5120 centers x 25600 points", tx,
             c12)):
        def kernel(x=x, c=c):
            return ball_query.ball_query_bucketed(x, c, r2, 64, L)

        def plain(x=x, c=c):
            return ball_query.ball_query_bucketed_plain(x, c, r2, 64, L)

        test_ops, slab, inside = radius_test_ops(x, c, r2, strict=True)
        print(f"ball_query {label}: {slab} pairs inside the x slab, {inside} "
              f"in radius")
        rows.append(bucket_scan_case("ball_query", label, kernel, plain,
                                     (x, c), test_ops + 2 * inside, inside,
                                     "ball_query", 64, L))
        scan_calls[f"ball_query {label}"] = (
            kernel, ("bucket_scan_kernel", "bucket_fill_kernel"))
    record_rows(record, "ball_query", CSRC + "ball_query.cu",
                JAX_OPS + "ball_query_pallas.py:154", rows)


def sa1_centers(x) -> torch.Tensor:
    """[B, 5120, 3]: the SA1 centers of the clouds `x` (unmasked FPS)."""
    from regnet_for_3d_grasping_torch.ops import fps
    i = fps.fps(x, fps.dist_init(x, None), 5120).long()
    return torch.gather(x, 1, i[..., None].expand(-1, -1, 3)).contiguous()


def three_nn_forced(q, k, Q, S) -> tuple:
    """(launch, idx, dist): K3 on a given grid, into outputs of its own
    (the grid sweeps and the edge shapes)."""
    from regnet_for_3d_grasping_torch.ops import _cuda
    (B, N1, _), N2 = q.shape, k.shape[1]
    idx = torch.empty(B, N1, 3, dtype=torch.int32, device=q.device)
    dist = torch.empty(B, N1, 3, device=q.device)
    pi = torch.empty(B, S, 3, N1, dtype=torch.int32, device=q.device)
    pd = torch.empty(B, S, 3, N1, device=q.device)

    def launch():
        _cuda.launch("three_nn", q.device, q, k, idx, dist, pi, pd, None, B,
                     N1, N2, Q, S)
    return launch, idx, dist


def three_nn_insertions(q, k, ranges: int, tiles: int = 8) -> tuple:
    """How often K3's steps take their insertion branch, replayed in numpy
    on the first cloud for `tiles` tiles of 256 queries spread evenly over
    it, each range from an empty best three, with three_nn.cuh's constants:
    (the mean insertions a query, the share of a warp's steps in which one
    of its queries takes the branch; a warp holds 32 queries and the 32
    that are 128 further)."""
    import re
    src = (ROOT / CSRC / "three_nn.cuh").read_text()
    chunk, step = (int(re.search(rf"\b{n} = (\d+);", src).group(1))
                   for n in ("kChunk", "kStep"))
    first = np.linspace(0, q.shape[1] // 256 - 1, tiles).round().astype(int)
    qq = q[0].cpu().numpy()[(first[:, None] * 256
                             + np.arange(256)).ravel()]
    kk = k[0].cpu().numpy()
    warps = np.array([t * 256 + w * 32 + np.arange(32) + h * 128
                      for t in range(tiles) for w in range(4)
                      for h in range(2)]).reshape(-1, 64)
    inf = np.float32(3e38)

    def dist(keys):
        d = [keys[None, :, i] - qq[:, None, i] for i in range(3)]
        return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]

    span, inserted, taken = -(-kk.shape[0] // ranges), 0, []
    for r0 in range(0, kk.shape[0], span):
        best = np.full((len(qq), 3), inf, np.float32)
        for c0 in range(r0, min(kk.shape[0], r0 + span), chunk):
            d = dist(kk[c0:min(kk.shape[0], r0 + span, c0 + chunk)])
            d = np.pad(d, ((0, 0), (0, -d.shape[1] % step)),
                       constant_values=np.nan)
            for s0 in range(0, d.shape[1], step):
                with np.errstate(invalid="ignore"):
                    hit = (d[:, s0:s0 + step] < best[:, 2:]).any(1)
                taken.append(hit[warps].any(1))
                for x in d[hit, s0:s0 + step].T:      # strict, in key order
                    b = best[hit]
                    c = x[:, None] < b
                    inserted += int(c[:, 2].sum())
                    b0, b1 = b[:, :1], b[:, 1:2]
                    x1 = x[:, None]
                    best[hit] = np.where(c[:, :1], np.c_[x1, b0, b1],
                                         np.where(c[:, 1:2], np.c_[b0, x1, b1],
                                                  np.where(c[:, 2:],
                                                           np.c_[b[:, :2], x1],
                                                           b)))
    return inserted / len(qq), float(np.mean(taken))


def three_nn_case(label, q, k, ranges, sorted_keys=False) -> dict:
    """Phase 3 for one K3 shape: the call against `three_nn_plain`
    (indices equal, distances within rtol 1e-6); its time with and without
    the host, and the plain version's; the grid (Q, S) of
    ``ops/knn.split_grid`` (`sorted_keys`: the keys sorted in x, as the
    slab fallback passes them); pairs/ns and the bound's share; and the device
    time of the kernel at Q = 1 and 2 and every S of `ranges` and the
    rule's, each equal to the call to the bit.  The bound counts
    what any exact scan does: dx, its square and a compare (3) on every
    pair; the rest of the distance and the compare (7) only on a pair
    whose dx*dx is under its query's final third distance (taken from the
    plain version's output), since the rounded sum is at least dx*dx."""
    from regnet_for_3d_grasping_torch.ops import _cuda, knn
    def kernel():
        return knn.three_nn_kernel(q, k, sorted_keys)

    got, ref = kernel(), knn.three_nn_plain(q, k)
    check(torch.equal(got[0], ref[0]), f"K3 3-NN indices differ ({label})")
    check(torch.allclose(got[1], ref[1], rtol=1e-6, atol=0),
          f"K3 3-NN distances differ beyond rtol 1e-6 ({label})")
    (B, N1, _), N2 = q.shape, k.shape[1]
    threads, max_q = knn.limits(q.device)
    grid = knn.split_grid(B, N1, N2, _cuda.sm_count(q.device), threads,
                          max_q, sorted_keys)
    d3 = ref[1][..., 2]
    slab = 0
    for q0 in range(0, N1, 1024):
        dx = k[:, None, :, 0] - q[:, q0:q0 + 1024, None, 0]
        slab += int((dx * dx < d3[:, q0:q0 + 1024, None]).sum())
    pairs = B * N1 * N2
    row = {"shape": label, "max_abs_err": max_err(got, ref),
           "ms": cuda_ms(kernel, 20),
           "plain_ms": cuda_ms(lambda: knn.three_nn_plain(q, k), 3),
           "device_ms": device_ms(kernel, 20),
           "bytes": nbytes(q, k, *got), "ops": pairs * 3 + slab * 7,
           "grid": list(grid)}
    row["pairs_per_ns"] = pairs / row["device_ms"] / 1e6
    row["bound_share"] = bound(row["bytes"], row["ops"])[0] / row["device_ms"]
    sweep = {}
    for Q in (1, max_q):
        for S in sorted(set(ranges) | {grid[1]}):
            launch, idx, dist = three_nn_forced(q, k, Q, S)
            launch()
            check(torch.equal(idx, got[0]) and torch.equal(dist, got[1]),
                  f"K3 differs at Q={Q} S={S} ({label})")
            sweep[f"Q={Q} S={S}"] = device_ms(launch, 10)
    row["device_ms_by_grid"] = sweep
    row["insertions_per_query"], row["steps_inserting"] = \
        three_nn_insertions(q, k, grid[1])
    print(f"three_nn {label}: Q {grid[0]} x S {grid[1]} ({threads} threads "
          f"a block), {pairs} pairs, {slab} inside their query's final x "
          f"slab, {row['insertions_per_query']:.1f} insertions a query and "
          f"{row['steps_inserting']:.3f} of a warp's 4-key steps inserting "
          f"(8 tiles of 256 queries), {row['pairs_per_ns']:.1f} pairs/ns, "
          f"bound share {row['bound_share']:.3f}, call {row['ms']:.4f} ms, "
          f"device {row['device_ms']:.4f} ms; device ms by grid: "
          + ", ".join(f"{v} {t:.4f}" for v, t in sweep.items()))
    return row


def three_nn_edges(dev) -> None:
    """K3 against `three_nn_plain` at small shapes, on the rule's grid and
    on forced ones: N1 not a multiple of any
    tile; equal keys on both sides of every range boundary of the rule's
    grid, among coarse keys with many equal distances; N2 = 3; N2 not a
    multiple of the range; and ranges shorter than three keys (N2 = 7 in 4
    or 7 ranges)."""
    from regnet_for_3d_grasping_torch.ops import _cuda, knn
    g = torch.Generator().manual_seed(11)
    coarse = torch.randint(0, 16, (1, 5120, 3), generator=g) / 16.0
    S = knn.split_grid(1, 25600, 5120, _cuda.sm_count(dev),
                       *knn.limits(dev))[1]
    span = -(-5120 // S)
    for j in range(span, 5120, span):
        coarse[:, j] = coarse[:, j - 1]
    cases = [  # (label, query, key, forced grids (Q, S))
        ("N1 = 1000, not a multiple of a tile, B = 2",
         torch.rand(2, 1000, 3, generator=g),
         torch.rand(2, 5120, 3, generator=g), ()),
        (f"equal keys across each of the {S} ranges' boundaries",
         torch.randint(0, 32, (1, 25600, 3), generator=g) / 32.0, coarse,
         ()),
        ("N2 = 3", torch.rand(2, 300, 3, generator=g),
         torch.rand(2, 3, 3, generator=g), ((1, 1), (2, 3))),
        ("N2 = 301 in 4 and 7 ranges, B = 3",
         torch.rand(3, 777, 3, generator=g),
         torch.randint(0, 4, (3, 301, 3), generator=g) / 4.0,
         ((1, 4), (2, 7))),
        ("N2 = 7 in 4 and 7 ranges (fewer than 3 keys a range)",
         torch.randint(0, 4, (1, 500, 3), generator=g) / 4.0,
         torch.randint(0, 2, (1, 7, 3), generator=g) / 2.0,
         ((1, 4), (2, 7)))]
    for label, q, k, forced in cases:
        q, k = q.to(dev).contiguous(), k.to(dev).contiguous()
        got, ref = knn.three_nn_kernel(q, k), knn.three_nn_plain(q, k)
        ok = torch.equal(got[0], ref[0]) and torch.allclose(
            got[1], ref[1], rtol=1e-6, atol=0)
        for Q, S_ in forced:
            launch, idx, dist = three_nn_forced(q, k, Q, S_)
            launch()
            ok = ok and torch.equal(idx, got[0]) and torch.equal(dist, got[1])
        check(ok, f"K3 differs at edge shape: {label}")
        ties = int((ref[1][..., 1] == ref[1][..., 2]).sum())
        print(f"three_nn edge {label}: equal ({ties} queries with equal "
              f"second and third distances)")


def three_nn_kernels(dev, xyz, centers, tx, c12, record,
                     scan_calls) -> None:
    """Phase 3 for K3, the FP3 3-NN: at serving (the cloud's 25,600 points
    against its 5,120 SA1 centers), at a training batch (12 clouds) and as
    the slab fallback runs it (12 slab-sorted clouds against the x-sorted
    SA1 centers of each; also timed with the same keys in their FPS
    order), with `cdist` + `topk` timed at serving; then its edge shapes.
    Its launches a call (the split, and the merge where the keys are
    split) are counted in `select_launches`."""
    from regnet_for_3d_grasping_torch.ops import knn, slab
    _, sc12 = slab.sort_cloud(tx, SLAB_CELL,
                              generator=torch.Generator().manual_seed(7))
    sq = sc12.xyz.contiguous()
    kf = sa1_centers(sq)
    order = torch.sort(kf[..., 0], dim=-1, stable=True).indices
    ks = torch.gather(kf, 1, order[..., None].expand(-1, -1, 3)).contiguous()
    rows = []
    for label, q, k, ranges, srt in (
            ("serving: 25600 queries x 5120 keys", xyz, centers,
             (2, 3, 4, 6, 8, 14), False),
            ("training: 12 clouds x 25600 queries x 5120 keys", tx, c12,
             (1, 2, 3, 4), False),
            ("slab fallback: 12 slab-sorted clouds x 5120 x-sorted keys",
             sq, ks, (1, 2, 4, 6, 8, 12), True)):
        rows.append(three_nn_case(label, q, k, ranges, srt))
        S = rows[-1]["grid"][1]
        scan_calls[f"three_nn {label}"] = (
            lambda q=q, k=k, srt=srt: knn.three_nn_kernel(q, k, srt),
            ("three_nn_split_kernel",) + (("three_nn_merge_kernel",)
                                          if S > 1 else ()))

    # the fallback's queries and keys, the keys in their FPS order: what
    # the x order alone costs
    launch, idx, _ = three_nn_forced(sq, kf, *rows[-1]["grid"])
    launch()
    check(torch.equal(idx, knn.three_nn_plain(sq, kf)[0]),
          "K3 differs on the fallback's keys in FPS order")
    rows[-1]["fps_order_keys"] = {
        "device_ms": device_ms(launch, 20),
        "insertions_per_query_and_steps_inserting": three_nn_insertions(
            sq, kf, rows[-1]["grid"][1])}
    print(f"three_nn slab fallback, the same keys in FPS order: "
          f"{rows[-1]['fps_order_keys']}")

    def cdist_topk():
        return torch.cdist(xyz, centers).topk(3, dim=-1, largest=False)

    rows[0]["library_ms"] = cuda_ms(cdist_topk, 20)
    three_nn_edges(dev)
    record_rows(record, "three_nn", CSRC + "three_nn.cu",
                JAX_OPS + "knn_pallas.py:169", rows)


def fps_grouped_kernels(dev, sx, record) -> tuple:
    """Phase 3 for K10, K1's cluster kernel over the slices: against
    `fps_grouped_plain` (equal to the bit) at the two serving shapes (SA1,
    25,600 -> 5,120, and the masked centers, -> 4,000; 8 slices of 3,200
    points), at slab training's SA1 (12 sorted clouds, 96 slices) and at the
    edge cases: a slice whose points are all masked (it falls back to
    all-valid on its own) and slices of fewer points than blocks.  Each
    shape's cluster size R, time and time per step are recorded, and every
    R is timed apart at both serving shapes and the training one.  Returns
    the SA1 and centers picks and the training batch in slab order."""
    from regnet_for_3d_grasping_torch.ops import fps, slab
    G, L = FPS_GROUPS, N_POINTS // FPS_GROUPS
    _, sc12 = slab.sort_cloud(train_clouds(dev), SLAB_CELL,
                              generator=torch.Generator().manual_seed(11))
    z = sx[..., 2] > 0.76
    holes = z.clone()
    holes[:, 2 * L:3 * L] = False           # slice 2: no valid point
    cases = [  # (label, xyz, mask, S)
        ("serving SA1 25600->5120, B=1, G=8", sx, None, 5120),
        ("serving centers, masked 25600->4000, B=1, G=8", sx, z, N_CENTERS),
        ("training SA1 25600->5120, B=12, G=8 (96 slices)", sc12.xyz, None,
         5120),
        ("edge: a slice with every point masked, ->4000", sx, holes,
         N_CENTERS),
        ("edge: 8 slices of 10 points, fewer than blocks, S=96",
         sx[:, :80].contiguous(), None, 96)]
    rows, picks = [], []
    for label, x, mask, S in cases:
        B, N, _ = x.shape
        dist = fps.dist_init(x.reshape(B * G, N // G, 3),
                             None if mask is None
                             else mask.reshape(B * G, N // G)).reshape(B, N)
        occupancy = fps.max_clusters(x.device, N // G)
        R = fps.cluster_size(B * G, N // G, occupancy)
        got = fps.fps_grouped(x, dist, S, G)
        ref = fps.fps_grouped_plain(x, dist, S, G)
        check(torch.equal(got, ref), f"K10 grouped fps differs ({label}, "
              f"R={R})")
        ms = cuda_ms(lambda: fps.fps_grouped(x, dist, S, G), 10)
        print(f"fps_grouped {label}: R={R} (clusters the card holds by size "
              f"{occupancy}), {ms:.4f} ms, {ms / (S // G) * 1e3:.3f} us per "
              f"step")
        row = {"shape": label, "cluster": R, "max_abs_err": max_err(got, ref),
               "ms": ms, "ms_per_step": ms / (S // G),
               "bytes": nbytes(x, dist, got), "ops": B * S * (N // G) * 10}
        if len(rows) < 2:
            picks.append(got)
            row["plain_ms"] = cuda_ms(
                lambda: fps.fps_grouped_plain(x, dist, S, G), 2)
        if len(rows) < 3:
            row["ms_by_cluster_size"] = cluster_sweep(
                "fps_grouped", label, x, dist, got, B, N, S, G)
        rows.append(row)
    record_rows(record, "fps_grouped", CSRC + "fps.cu",
                JAX_OPS + "fps_pallas.py:211", rows)
    return picks[0], picks[1], sc12


K8_KERNELS = ("slab_nn_span_kernel", "slab_nn_split_kernel",
              "slab_nn_merge_kernel")


class K8Case:
    """Phase 3 for K8 at one shape: slab-sorted queries `q` [B, 25600, 3]
    against x-sorted keys `k` [B, 5120, 3]."""

    def __init__(self, dev, q, k, label):
        from regnet_for_3d_grasping_torch.ops import _cuda, knn, slab
        self.dev, self.q, self.k, self.label = dev, q, k, label
        nn, ref = self.call(), self.plain()
        check(torch.equal(nn.ss, ref.ss) and torch.equal(nn.lr, ref.lr),
              f"K8's span table differs from three_nn_spans ({label})")
        check(torch.equal(nn.idx, ref.idx),
              f"K8 3-NN indices differ ({label})")
        check(torch.equal(nn.d2, ref.d2), f"K8 3-NN distances are not "
              f"bit-equal to the plain version's ({label})")
        check(torch.equal(nn.proven, ref.proven)
              and int(nn.fallback) == int(not bool(ref.proven.all())),
              f"K8's certificate differs from three_nn_certificate ({label})")
        self.nn, self.err = nn, max_err((nn.idx, nn.d2), (ref.idx, ref.d2))
        B, T = nn.ss.shape[:2]
        self.cap = min(3, slab.n_scan_blocks_k(k.shape[1]))
        self.grid = slab.three_nn_slab_grid(B, T, self.cap,
                                            _cuda.sm_count(dev),
                                            *knn.limits(dev))
        self.pairs = scanned_pairs(nn.ss, q.shape[1], 256, 1024, k.shape[1])
        spans = (nn.ss[..., 1] - nn.ss[..., 0]).float()
        unclamped = slab.three_nn_spans(q, k, 0.06, 99)[0]
        self.cut = int((unclamped[..., 1] - unclamped[..., 0] > 3).sum())
        print(f"three_nn_slab {label}: {B * T} tiles, span blocks mean "
              f"{float(spans.mean()):.3f} (max {int(spans.max())}), "
              f"{self.cut} tiles cut by the clamp, {self.pairs} pairs "
              f"scanned of {B * q.shape[1] * k.shape[1]}, grid Q "
              f"{self.grid[0]} x {self.grid[1]} parts a block, proven "
              f"{nn.proven.tolist()}")

    def call(self):
        from regnet_for_3d_grasping_torch.ops import slab
        return slab.three_nn_slab_call(self.q, self.k, 0.06, 3)

    def plain(self):
        from regnet_for_3d_grasping_torch.ops import slab
        ss, lr = slab.three_nn_spans(self.q, self.k, 0.06, 3)
        idx, d2 = slab.three_nn_slab_plain(self.q, self.k, ss)
        return slab.SlabNN(idx, d2, slab.three_nn_certificate(self.q, d2, lr),
                           None, ss, lr)

    def layer_nn(self):
        """The FP layer's whole 3-NN: the call, then K3 gated by its flag."""
        from regnet_for_3d_grasping_torch.ops import knn
        r = self.call()
        return knn.three_nn_where(r.fallback, self.q, self.k, r.idx, r.d2,
                                  sorted_keys=True)

    def forced(self, Q, parts):
        """One call's launches on a given grid, into outputs of its own."""
        from regnet_for_3d_grasping_torch.ops import _cuda
        (B, Nq, _), NK, dev = self.q.shape, self.k.shape[1], self.dev
        T = -(-Nq // 256)
        out = [torch.empty(B, T, 2, dtype=torch.int32, device=dev),
               torch.empty(B, T, 2, device=dev),
               torch.empty(B, self.cap * parts, 3, T * 256,
                           dtype=torch.int32, device=dev),
               torch.empty(B, self.cap * parts, 3, T * 256, device=dev),
               torch.empty(B, Nq, 3, dtype=torch.int32, device=dev),
               torch.empty(B, Nq, 3, device=dev),
               torch.empty(B, dtype=torch.bool, device=dev),
               torch.empty(1, dtype=torch.int32, device=dev)]

        def launch():
            _cuda.launch("three_nn_slab", dev, self.q, self.k, *out, None, B,
                         Nq, NK, 0.06, self.cap, Q, parts)
        return launch, out[4], out[5]

    def row(self, per_kernel=None, plain_reps=3) -> dict:
        """The record row: times of the call (host included and not), of
        the FP layer's whole 3-NN, of the plain versions and of `cdist` +
        `topk`; the call's device time at every grid the kernel takes;
        `per_kernel`: each kernel's device ms (`select_launches`)."""
        sweep = {}
        for Q in (1, 2):
            for parts in (1, 2, 4):
                launch, idx, d2 = self.forced(Q, parts)
                launch()
                check(torch.equal(idx, self.nn.idx)
                      and torch.equal(d2, self.nn.d2),
                      f"K8 differs at Q={Q}, {parts} parts ({self.label})")
                sweep[f"Q={Q} parts={parts}"] = device_ms(launch, 10)
        dms = device_ms(self.call, 20)

        def cdist_topk():
            return torch.cdist(self.q, self.k).topk(3, dim=-1, largest=False)

        same = float((cdist_topk()[1] == self.nn.idx).float().mean())
        row = {"shape": self.label, "max_abs_err": self.err,
               "ms": cuda_ms(self.call, 20),
               "plain_ms": cuda_ms(self.plain, plain_reps),
               "bytes": nbytes(self.q, self.k, self.nn.ss, self.nn.idx,
                               self.nn.d2),
               "ops": self.pairs * 10, "library_ms": cuda_ms(cdist_topk, 10),
               "device_ms": dms, "wrapper_ms": cuda_ms(self.layer_nn, 20),
               "layer_device_ms": device_ms(self.layer_nn, 20),
               "grid": list(self.grid), "tiles_cut_by_clamp": self.cut,
               "pairs_scanned": self.pairs,
               "pairs_per_ns_call": self.pairs / dms / 1e6,
               "device_ms_by_grid": sweep,
               "proven": self.nn.proven.tolist()}
        if per_kernel:
            row["kernel_device_ms"] = per_kernel
            row["pairs_per_ns_split"] = (
                self.pairs / per_kernel["slab_nn_split_kernel"] / 1e6)
        print(f"three_nn_slab {self.label}: vs cdist+topk indices equal "
              f"share {same:.5f}; call {row['ms']:.4f} ms, device "
              f"{dms:.4f}, the FP layer's 3-NN {row['wrapper_ms']:.4f} "
              f"(device {row['layer_device_ms']:.4f}); device ms by grid: "
              + ", ".join(f"{g} {t:.4f}" for g, t in sweep.items()))
        check(same > 0.99, f"the proven slab 3-NN disagrees with the full "
              f"scan ({self.label})")
        return row


def x_sorted_rows(t: torch.Tensor) -> torch.Tensor:
    """The rows of each cloud of `t` [B, N, 3] sorted by x, stably."""
    order = torch.sort(t[..., 0], dim=-1, stable=True).indices
    return torch.gather(t, 1, order[..., None].expand(-1, -1, 3)).contiguous()


def slab_fp3_checks(dev, sx, sa1, centroids) -> None:
    """The slab FP3 layer on the card: with the certificate holding, under
    CUDA's sync debug mode set to raise (nothing is read on the host), its
    K3 launches returning at once; and on the same cloud 20 times larger,
    where the 0.06 bound no longer covers the neighbours, the certificate
    refusing and the layer falling back to K3 over the x-sorted keys,
    counted on the card, equal to the full scan."""
    from regnet_for_3d_grasping_torch.models.backbone import (
        FeaturePropagation)
    from regnet_for_3d_grasping_torch.ops import _cuda, slab
    torch.manual_seed(10)
    fp = FeaturePropagation(515, (256, 256, 256), 3, 0.06).to(dev).eval()
    dense = torch.rand(1, N_POINTS, 3, device=dev)
    sparse = torch.randn(1, 5120, 512, device=dev)
    with torch.no_grad():
        fp(sx, centroids, dense, sparse, use_slab=True)   # warm
        torch.cuda.synchronize()
        before = (_cuda.fallbacks["fp3_slab"], dict(_cuda.launches))
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fp(sx, centroids, dense, sparse, use_slab=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        full = fp(sx, centroids, dense, sparse)
    torch.cuda.synchronize()
    check(_cuda.fallbacks["fp3_slab"] == before[0]
          and _cuda.launches["three_nn_slab"]
          == before[1]["three_nn_slab"] + 1
          and _cuda.launches["three_nn"] == before[1]["three_nn"] + 2,
          "the slab FP3 layer did not take K8 and K3's gated launch once")
    err = max_err(out, full)
    print(f"slab FP3 layer (515 -> 256 channels) under sync debug mode "
          f"'error': no sync; vs the full-scan layer max abs err {err:.3e}")

    far_q, far_k = sx * 20.0, sx[:, sa1[0].long()] * 20.0
    check(not bool(slab.three_nn_slab(far_q, x_sorted_rows(far_k),
                                      0.06)[2].all()),
          "K8 certificate held on a cloud 20 times the bound's scale")
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


def slab_kernels(dev, xyz, record, scan_calls) -> list:
    """Phase 3 for K6-K10 and K8 flat (phase (a)), on the cloud `xyz`
    [1, N, 3] in slab order (and the launch count of K11's and K5's calls
    `scan_calls`, in K6/K7's profiler session).  Returns the rows of the
    pools' backward at K9's shapes, f32 and bf16, and the launch counts of
    K8 flat's entry point."""
    from regnet_for_3d_grasping_torch.geometry.codec import grasps_to_frames
    from regnet_for_3d_grasping_torch.ops import fps, pooling, slab

    _, sc = slab.sort_cloud(xyz, SLAB_CELL,
                            generator=torch.Generator().manual_seed(7))
    sx, G = sc.xyz, FPS_GROUPS
    L = N_POINTS // G
    src = CSRC + "slab_select.cu"

    sa1, got_m, sc12 = fps_grouped_kernels(dev, sx, record)

    # K6: the SA1 ball query (5,120 x-sorted centroids, r 0.02, K 64, win
    # 256, spw 2, distinct), the region grouping (4,000 x-sorted centers,
    # r 0.008, K 256, win 128, spw 4) and the grouping of a slab training
    # batch (12 sorted clouds, 64 x-sorted centers each).  Operations: the
    # radius test (9) on every scanned pair; the hash (8) and its place in
    # the window's argmax (2) only on the pairs that pass, which `count`
    # sums exactly
    def k6(sc_, centers, seed, radius, K, win, spw, distinct, label):
        r2 = float(np.float32(float(radius) ** 2))

        def call():
            return slab.group_slab_with_spans(sc_, centers, seed, radius, K,
                                              SLAB_CELL, win, spw, distinct)

        def plain():
            ss = slab.select_spans(sc_, centers, radius, SLAB_CELL, K, win,
                                   spw)
            return (*slab.finish_select(*slab.group_slab_plain(
                sc_.xyz, centers, ss, seed, r2, K, win, spw, distinct), ss),
                    ss)

        def public():
            return slab.group_slab(sc_, centers, seed, radius, K, SLAB_CELL,
                                   win, spw, distinct)

        return select_case("group_slab", label, sc_, call, plain, public,
                           (centers,), 9)

    picks12 = fps.fps(sc12.xyz, fps.dist_init(sc12.xyz, None), TRAIN_CENTERS)
    check(torch.equal(picks12, fps.fps_plain(
        sc12.xyz, fps.dist_init(sc12.xyz, None), TRAIN_CENTERS)),
        "K1 fps differs at batch 12")
    c12 = torch.gather(sc12.xyz, 1,
                       picks12.long()[..., None].expand(-1, -1, 3))
    c12 = torch.gather(c12, 1, torch.sort(
        c12[..., 0], dim=-1, stable=True).indices[..., None].expand(
            -1, -1, 3)).contiguous()
    centroids = x_sorted_rows(sx[:, sa1[0].long()])
    c4000 = x_sorted_rows(sx[:, got_m[0].long()])
    calls = {}
    groups, *calls["group_slab: region grouping"] = k6(
        sc, c4000, 21, 0.008, 256, slab.GROUP_WIN, slab.GROUP_SPW, False,
        "region grouping: 4000 centers, K=256, win 128, spw 4")
    _, *calls["group_slab: SA1"] = k6(
        sc, centroids, 0x5A1B, 0.02, 64, slab.BALL_WIN, slab.BALL_SPW, True,
        "SA1 ball query: 5120 centroids, K=64, win 256, spw 2, distinct")
    g12, *calls["group_slab: training"] = k6(
        sc12, c12, 31, 0.008, 256, slab.GROUP_WIN, slab.GROUP_SPW, False,
        "region grouping, training: 12 x 64 centers")

    # K7: crop of 4,000 proposals around those centers, and of the 12 x 64
    # proposals of a training batch.  Operations: the frame transform and
    # box test (22) on every scanned pair, hash and argmax (10) on the pairs
    # inside the box
    box = (0.0, 0.03, 0.04, 0.005)
    box32 = tuple(float(np.float32(v)) for v in box)

    def k7(sc_, centers, seed, gen_seed, label):
        B, M = centers.shape[:2]
        gen = torch.Generator().manual_seed(gen_seed)
        axis = torch.nn.functional.normalize(
            torch.randn(B, M, 3, generator=gen), dim=-1).to(dev)
        theta = ((torch.rand(B, M, 1, generator=gen) * 2 - 1)
                 * np.pi).to(dev)
        frames, bases = grasps_to_frames(torch.cat([centers, axis, theta],
                                                   -1))
        frames, bases = frames.contiguous(), bases.contiguous()
        f9 = frames.reshape(B, M, 9)

        def call():
            return slab.crop_slab_with_spans(sc_, frames, bases, seed, box,
                                             64, SLAB_CELL)

        def plain():
            ss = slab.select_spans(sc_, bases, slab.crop_bound(box),
                                   SLAB_CELL, 64, slab.CROP_WIN,
                                   slab.CROP_SPW)
            return (*slab.finish_select(*slab.crop_slab_plain(
                sc_.xyz, f9, bases, ss, seed, box32, 64), ss), ss)

        def public():
            return slab.crop_slab(sc_, frames, bases, seed, box, 64,
                                  SLAB_CELL)

        return select_case("crop_slab", label, sc_, call, plain, public,
                           (frames, bases), 22)

    crops, *calls["crop_slab: crop"] = k7(
        sc, c4000, 12345, 8, "crop: 4000 proposals, K=64, win 256, spw 1")
    k12, *calls["crop_slab: training"] = k7(
        sc12, c12, 32, 12, "crop, training: 12 x 64 proposals")
    # K8: FP3, 25,600 sorted queries against the 5,120 x-sorted centroids.
    # One call (span table, scan, merge and certificate: 3 launches) against
    # its plain versions; and the FP layer's whole 3-NN, the call and K3's
    # launches, which return at once on the card while the flag says proven
    fp3 = K8Case(dev, sx, centroids, "FP3 serving: 25600 slab-sorted "
                 "queries x 5120 x-sorted keys")
    check(bool(fp3.nn.proven.all()),
          "K8 certificate failed on the tabletop cloud")
    check(all_equal(fp3.layer_nn(), (fp3.nn.idx, fp3.nn.d2)),
          "the FP layer's 3-NN differs from K8's on a proven cloud")
    fp3_12 = K8Case(dev, sc12.xyz, x_sorted_rows(sa1_centers(sc12.xyz)),
                    "FP3 training: 12 slab-sorted clouds x 5120 x-sorted "
                    "keys")
    scan_calls["three_nn_slab: FP3 serving"] = (fp3.call, K8_KERNELS)
    scan_calls["three_nn_slab and K3's flag-gated fallback: FP3 serving"] = (
        fp3.layer_nn, K8_KERNELS + ("three_nn_split_kernel",
                                    "three_nn_merge_kernel"))
    scan_calls["three_nn_slab: FP3 training"] = (fp3_12.call, K8_KERNELS)
    prof = select_launches(calls, scan_calls)
    for name in ("group_slab", "crop_slab"):
        record_rows(record, name, src, JAX_OPS + "slab.py:425",
                    [row for label, (row, _) in calls.items()
                     if label.startswith(name)])
    record_rows(record, "three_nn_slab", CSRC + "three_nn_slab.cu",
                JAX_OPS + "slab.py:853",
                [fp3.row(prof["three_nn_slab: FP3 serving"][1]),
                 fp3_12.row(prof["three_nn_slab: FP3 training"][1], 1)])
    slab_fp3_checks(dev, sx, sa1, centroids)
    flat_launches = k8_flat_kernels(record, sx, centroids, sc12.xyz,
                                    x_sorted_rows(sa1_centers(sc12.xyz)))

    # K9: the region pool (4,000 x 256 slots x 256 channels, win 128, spw 4)
    # and the refine pool (4,000 x 64 slots, win 256, spw 1)
    feature = torch.randn(1, N_POINTS, 256,
                          generator=torch.Generator().manual_seed(9)).to(dev)

    def k9(feature, index, off, win, spw, label):
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
        check(bit_equal(got, ref), f"K9 gather_max_slab differs ({label})")
        bf16 = feature.dtype == torch.bfloat16
        has = n_cov > 0
        nothing = torch.tensor(-1e38, dtype=feature.dtype)
        check(bool((got[0][~has] == nothing.to(dev)).all()),
              f"K9 rows without a covered slot are not {float(nothing)} "
              f"({label})")
        lib = library_ms(embedding_bag, lambda out: torch.equal(
            out[has], ref[0][has]), f"K9 {label}", bf16)
        print(f"gather_max_slab {label}: {int(cover.sum())} covered slots of "
              f"{cover.numel()}, {int((~has).sum())} rows without one")
        # bytes: the feature rows the covered slots touch, not all of them
        touched = torch.unique(flat_idx).numel()
        print(f"gather_max_slab {label}: {touched} of {N_POINTS} feature "
              f"rows touched")
        return {"max_abs_err": max_err(got, ref), "ms": cuda_ms(kernel, 20),
                "plain_ms": cuda_ms(plain, 3),
                "bytes": (touched * feature.shape[-1] * feature.element_size()
                          + nbytes(index, off, got)),
                "ops": int(cover.sum()) * 256, "rows_read": touched} | lib \
            | {"device_ms": device_ms(kernel, 20)} \
            | (k9_bf16_vec8(feature, index, off, win, spw, ref, label)
               if bf16 else {})

    g_idx = torch.where((groups[2] & (groups[1] > 0))[..., None], groups[0], 0)
    c_idx = torch.where(crops[2][..., None], crops[0], 0)
    # the f32 form, and the bf16 form (a bf16 compute dtype: `--fast`) on
    # the same values rounded to bf16
    for name, f in (("gather_max_slab", feature),
                    ("gather_max_slab_bf16", feature.bfloat16())):
        rows = [{"shape": "region pool: 4000 x 256 slots, win 128, spw 4"}
                | k9(f, g_idx, groups[3], slab.GROUP_WIN, slab.GROUP_SPW,
                     f"{name} region pool"),
                {"shape": "refine pool: 4000 x 64 slots, win 256, spw 1"}
                | k9(f, c_idx, crops[3], slab.CROP_WIN, slab.CROP_SPW,
                     f"{name} refine pool")]
        record_rows(record, name, CSRC + "gather_max_slab.cu",
                    JAX_OPS + "slab.py:1072", rows)
    # the kernel reads 4 channels a load: the wrapper refuses a C that is
    # not a multiple of 4 and features not aligned to a load
    for f in (feature, feature.bfloat16()):
        shifted = torch.empty(f.numel() + 1, dtype=f.dtype, device=dev)[1:]
        for bad in (f[..., :255].contiguous(), shifted.view(f.shape)):
            try:
                slab.gather_max_slab(bad, g_idx, groups[3], slab.GROUP_WIN,
                                     slab.GROUP_SPW)
            except ValueError:
                continue
            check(False, "K9 took features it cannot read 4 channels a "
                  "load")
    # K9's argmax form and the backward, at the pools of a training batch
    # (12 sorted clouds, 64 x-sorted centers each; K6 and K7 make the
    # indices, held against their plain versions at this batch too) and at
    # the 4,000-center region pool; the bf16 forms (bf16 training) at the
    # same pools on the same values rounded to bf16
    print(f"training batch in slab order: {int(g12[1].sum())} points in "
          f"radius, {int((g12[2] & (g12[1] > 0)).sum())} of "
          f"{TRAIN_B * TRAIN_CENTERS} regions with a pick, "
          f"{int(((k12[1] > 5) & k12[2]).sum())} crops with > 5 points")
    f12, f1 = relu_features(TRAIN_B, 13, dev), torch.relu(feature)
    cases = [
        ("region pool, training: 12 x 64 x 256 slots, win 128, spw 4", f12,
         torch.where((g12[2] & (g12[1] > 0))[..., None], g12[0], 0),
         (g12[3], slab.GROUP_WIN, slab.GROUP_SPW)),
        ("refine pool, training: 12 x 64 x 64 slots, win 256, spw 1", f12,
         torch.where(k12[2][..., None], k12[0], 0),
         (k12[3], slab.CROP_WIN, slab.CROP_SPW)),
        ("region pool, 4000 x 256 slots", f1, g_idx,
         (groups[3], slab.GROUP_WIN, slab.GROUP_SPW))]
    rows = pool_kernels(
        record, "gather_max_slab_argmax", CSRC + "gather_max_slab.cu",
        JAX_OPS + "slab.py:1072", slab.gather_max_slab_argmax,
        slab.gather_max_slab_argmax_plain, cases, N_POINTS,
        slab.slab_cover)
    rows_bf16 = pool_kernels(
        record, "gather_max_slab_argmax_bf16", CSRC + "gather_max_slab.cu",
        JAX_OPS + "slab.py:1072 (bf16 rows, with_argmax; :996-1010)",
        slab.gather_max_slab_argmax, slab.gather_max_slab_argmax_plain,
        [(label + ", bf16", f.bfloat16(), i, e)
         for label, f, i, e in cases], N_POINTS, slab.slab_cover)
    # a pool that needs a gradient takes the argmax form and the backward of
    # its dtype, and its gradient is the scatter of its own winners
    region_idx, region_args = cases[0][2], cases[0][3]
    for f, suffix in ((f12, ""), (f12.bfloat16(), "_bf16")):
        grad, pooled = pool_gradient(
            lambda x: slab.gather_max_slab(x, region_idx, *region_args), f,
            "gather_max_slab_argmax" + suffix, "gather_max_backward" + suffix)
        check(bit_equal(grad, pooling.scatter_winner(
            torch.ones_like(pooled), slab.gather_max_slab_argmax(
                f, region_idx, *region_args)[1], N_POINTS)),
            f"K9's gradient is not the scatter of its winners ({f.dtype})")
    return rows, rows_bf16, flat_launches


def write_clouds(folder: Path) -> Path:
    """The 3 tabletop clouds the serving phases serve, as ``.p`` files."""
    from regnet_for_3d_grasping_torch.utils.scene import tabletop_cloud
    folder.mkdir()
    for i in range(3):
        cxyz, crgb = tabletop_cloud(np.random.RandomState(100 + i))
        with open(folder / f"{i:04d}_view.p", "wb") as f:
            pickle.dump({"view_cloud": cxyz, "view_cloud_color": crgb}, f)
    return folder


def serve(argv_extra, tmp, label, check_eval=False):
    """Drive the infer CLI, with its evaluation, on 3 tabletop clouds;
    returns (records, launch counts, 3-NN fallbacks) with the counters
    reset just before.  Every forward draws the same seeds (phase (d): the
    CLI reseeds from ``--seed`` for each cloud).  `check_eval`: the first
    cloud's pickled sets are what the CPU's `eval_test` keeps of its raw
    sets (phase (d))."""
    from regnet_for_3d_grasping_torch.cli import infer
    from regnet_for_3d_grasping_torch.models import regnet
    from regnet_for_3d_grasping_torch.ops import _cuda
    folder = write_clouds(Path(tmp) / f"{label}_data")
    argv = ["--folder-name", str(folder), "--checkpoint", str(WEIGHTS),
            "--seed", "1", *argv_extra]
    draws, draw = [], regnet._draw

    def spy(generator, n):
        draws.append(draw(generator, n))
        return draws[-1]

    _cuda.reset_launches()
    with replaced(regnet, "_draw", spy):
        records = infer.main(argv)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    fallbacks = _cuda.fallbacks["fp3_slab"]
    check(len(records) == 3, f"the CLI did not serve 3 clouds ({label})")
    per = len(draws) // 3
    check(per > 0 and draws == draws[:per] * 3,
          f"the 3 forwards drew other seeds ({label}): {draws}")
    if check_eval:
        eval_pickle(records[0], Path(tmp) / f"{label}_data_predict", label)
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


def train(argv_extra, tmp, label, n_val, want_step, want_val, keep=None):
    """Drive the train CLI for one epoch of 4 steps at batch 12 (and its
    validation forwards, which run the exact full-scan configuration at
    batch 1); returns the launch counts, read just after a run that started
    with the counters at 0.  `want_step` / `want_val`: launches per training
    step and per validation forward.  `keep` (a dict) receives the CLI's
    result (``res``), the peak device memory (``peak``) and the step ms
    (``ms``)."""
    from regnet_for_3d_grasping_torch.cli import train as train_cli
    from regnet_for_3d_grasping_torch.ops import _cuda
    argv = ["--mode", "train", "--data-path", str(Path(tmp) / "scenes"),
            "--model-path", str(Path(tmp) / "models"), "--log-path",
            str(Path(tmp) / "log"), "--tag", label, "--batch-size",
            str(TRAIN_B), "--epoch", "1", "--seed", "1", *argv_extra]
    from regnet_for_3d_grasping_torch.train import trainer
    picks = []      # each train step's share of regions with a pick
    forward_losses = trainer.forward_losses

    def spy(model, *args, **kwargs):
        out = forward_losses(model, *args, **kwargs)
        if model.training:
            picks.append(out[0].region_valid.float().mean().detach())
        return out

    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    with replaced(trainer, "forward_losses", spy):
        res = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    fallbacks = _cuda.fallbacks["fp3_slab"]
    peak = torch.cuda.max_memory_allocated()
    steps = res["steps"]
    check(len(steps) == 4 and len(res["validation"]) == n_val,
          f"{label}: {len(steps)} steps and {len(res['validation'])} "
          f"validation forwards, expected 4 and {n_val}")
    check(all(np.isfinite(s["loss"]) for s in steps)
          and all(np.isfinite(v["loss_total"]) for v in res["validation"]),
          f"{label}: non-finite loss")
    print(f"launches on the {label} training path (4 steps, {n_val} "
          f"validation forwards): {launches}; 3-NN fallbacks {fallbacks}")
    for k in launches:
        want = 4 * want_step.get(k, 0) + n_val * want_val.get(k, 0)
        check(launches[k] == want, f"{label}: {k} launched {launches[k]} "
              f"times, expected {want}")
    # the weights of every stage moved away from the seed's initial model
    fresh = train_cli.build_model(res["cfg"], 1, "cpu").state_dict()
    now = res["model"].state_dict()
    moved = {k.split(".")[0] for k in fresh
             if not torch.equal(fresh[k], now[k].cpu())}
    check(moved == {"score_net", "grn_head", "refine_head"},
          f"{label}: only {sorted(moved)} moved in training")
    check((Path(tmp) / "models" / label / "ckpt_0" / "_METADATA").exists(),
          f"{label}: no checkpoint written")
    ms = [s["seconds"] * 1e3 for s in steps]
    print(f"{label} training, batch {TRAIN_B}: losses "
          f"{[round(s['loss'], 4) for s in steps]}, step ms first "
          f"{ms[0]:.3f}, median of the rest "
          f"{statistics.median(ms[1:]):.3f}, all "
          f"{[round(x, 3) for x in ms]}; peak device memory "
          f"{peak / 2**30:.3f} GiB; validation loss_total "
          f"{statistics.median(v['loss_total'] for v in res['validation']):.4f}"
          f" (median of {n_val}); share of regions with a pick in each step "
          f"{[round(float(p), 4) for p in picks]}; compute dtype "
          f"{res['cfg'].model.compute_dtype}, validation "
          f"{res['eval_cfg'].model.compute_dtype}")
    check(res["eval_cfg"].model.compute_dtype == "float32"
          and res["eval_cfg"].region.slab_cell == 0.0,
          f"{label}: validation forwards not f32 at exact geometry")
    if keep is not None:
        keep.update(res=res, peak=peak, ms=ms)
    return launches


class SlabNNProbe:
    """Within the block, keeps a copy of every slab 3-NN call's queries,
    keys and outputs (`slab.three_nn_slab_call` wrapped; copies made on the
    card's stream, before K3 can overwrite the outputs), and `report`s why
    a certificate failed: which clouds, their largest exact third-neighbour
    distance against the bound, the tiles whose span the clamp cut, and
    the queries that failed inside and outside those tiles."""

    def __enter__(self):
        from regnet_for_3d_grasping_torch.ops import slab
        self.slab, self.calls = slab, []
        self.orig = slab.three_nn_slab_call

        def wrapped(query, key, bound=0.06, grid_span=3, count=None):
            r = self.orig(query, key, bound, grid_span, count)
            self.calls.append((query.clone(), key.clone(), bound, grid_span,
                               r.d2.clone(), r.lr.clone(), r.proven.clone()))
            return r

        slab.three_nn_slab_call = wrapped
        return self

    def __exit__(self, *exc):
        self.slab.three_nn_slab_call = self.orig

    def report(self) -> None:
        from regnet_for_3d_grasping_torch.ops import knn
        slab = self.slab
        for i, (q, k, bound, grid_span, d2, lr, proven) in enumerate(
                self.calls):
            exact = knn.three_nn_kernel(q, k, sorted_keys=True)[1]
            third = exact[..., 2].sqrt().amax(-1)                   # [B]
            ss99 = slab.three_nn_spans(q, k, bound, 99)[0]
            cut = (ss99[..., 1] - ss99[..., 0]) > grid_span         # [B, T]
            tile = torch.arange(q.shape[1], device=q.device) // 256
            qx = q[..., 0]
            margin = torch.minimum(qx - lr[:, tile, 0], lr[:, tile, 1] - qx)
            fails = d2[..., 2] > margin.clamp(min=0) ** 2           # [B, Nq]
            in_cut = cut[:, tile]
            bad = (~proven).nonzero().flatten().tolist()
            flat = slab.three_nn_slab(q, k, bound, grid_span, flat=True)[2]
            total = int((ss99[..., 1] - ss99[..., 0]).sum())
            steps = slab.flat_steps(*ss99.shape[:2])
            print(f"slab 3-NN call {i} (batch {q.shape[0]}, bound {bound}, "
                  f"clamp {grid_span} blocks): {len(bad)} clouds unproven "
                  f"{bad}; K8 flat proves {int(flat.sum())} of "
                  f"{q.shape[0]} (unclamped spans sum {total} of G {steps}: "
                  f"{'flat' if total <= steps else 'the bounded grid'}); "
                  f"largest third-neighbour distance "
                  f"{float(third.max()):.5f} m over the batch; tiles cut by "
                  f"the clamp per cloud {cut.sum(-1).tolist()} of "
                  f"{cut.shape[1]}")
            for b in bad:
                kx = k[b, :, 0]
                print(f"  cloud {b}: third-neighbour distance "
                      f"{float(third[b]):.5f} m (bound {bound}), "
                      f"{int(cut[b].sum())} tiles cut, "
                      f"{int(fails[b].sum())} queries failed, "
                      f"{int((fails[b] & in_cut[b]).sum())} of them in cut "
                      f"tiles; x extent of the cloud "
                      f"{float(qx[b].amax() - qx[b].amin()):.4f} m, of the "
                      f"keys {float(kx.amax() - kx.amin()):.4f} m")


def f64_dense(self, x: torch.Tensor) -> torch.Tensor:
    """An f32 `Dense` summed in f64 and rounded once to f32: the same bits
    on the card and the CPU but in rare cases (phase 10's second recipe)."""
    return torch.nn.functional.linear(x.double(), self.weight.double()
                                      ).float()


def f64_batch_statistics(x: torch.Tensor):
    """`nn/layers.batch_statistics` summed in f64 and rounded once to f32
    (the formula unchanged: mean, max(0, E[x^2] - mean^2))."""
    axes = tuple(range(x.dim() - 1))
    xd = x.double()
    mean = xd.mean(axes)
    var = ((xd * xd).mean(axes) - mean * mean).clamp(min=0.0)
    dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    return mean.to(dtype), var.to(dtype)


def train_step_card_vs_cpu(tmp, dev) -> None:
    """One refine-stage training step at batch 2 on the card and on the CPU
    (plain versions), same initial weights, batch and seeds, dropout off;
    twice: with the native GEMMs and BatchNorm statistics, and with both
    summed in f64 on both sides (`f64_dense` on both; on the CPU
    `f64_batch_statistics`, on the card K13a, whose statistics are those
    f64 sums up to their order), which takes the summation orders out, as
    the CPU tests of the bf16 step do.  The card's side launches K13 once
    a BatchNorm in each recipe.  A unit whose pre-activation lies within the native sums'
    rounding of 0 sits on one side of a ReLU on the card and on the other
    on the CPU, and such a flip moves a head's gradient by several % of
    its largest entry (the CPU's own f32 step lies 0.02-10 % from its f64
    step in grn_head.stem at batch 2, with K11's grouping and with the
    served one: PERF.md §6).  The native step is held to its loss and
    its gradients' directions; the gradients' tolerances apply to the
    step without the summation orders."""
    from regnet_for_3d_grasping_torch.cli.train import build_model
    from regnet_for_3d_grasping_torch.config import train_config
    from regnet_for_3d_grasping_torch.data import GraspDataset
    from regnet_for_3d_grasping_torch.geometry import region
    from regnet_for_3d_grasping_torch.nn import layers
    from regnet_for_3d_grasping_torch.train import trainer
    cfg = train_config(**{"model.dropout_prob": 0.0})
    R = cfg.region
    ds = GraspDataset(str(Path(tmp) / "scenes"), "train", R.num_points,
                      R.max_gt_grasps, 1)
    batch = next(ds.batches(2, seed=0))
    kw = dict(
        group_seeds=list(range(40, 40 + region.group_seed_count(
            R.center_num, R.num_points, R.group_num))),
        crop_seeds=[list(range(50, 50 + region.crop_seed_count(
            R.center_num, R.num_points, R.gripper_num)))])
    from regnet_for_3d_grasping_torch.ops import _cuda
    runs = {}
    for recipe in ("native", "f64 sums"):
        for name in ("cuda", "cpu"):
            with contextlib.ExitStack() as stack:
                if recipe != "native":
                    stack.enter_context(replaced(layers.Dense, "forward",
                                                 f64_dense))
                    stack.enter_context(replaced(
                        layers, "batch_statistics", f64_batch_statistics))
                model = build_model(cfg, 5, name).train()
                _cuda.reset_launches()
                t0 = time.perf_counter()
                out, total, metrics = trainer.forward_losses(
                    model, trainer.device_batch(batch, name), "refine", **kw)
                total.backward()
            runs[recipe, name] = (out, float(total.detach()), model)
            print(f"training step on {name} ({recipe}): "
                  f"{time.perf_counter() - t0:.1f}s, loss "
                  f"{float(total.detach()):.6f}")
            if name == "cuda":
                # the card's BatchNorms run K13 in both recipes: K13a sums
                # in f64 itself, so the patched `batch_statistics` (the
                # plain statistics) reaches the CPU's side alone
                got = {k: _cuda.launches[k] for k in BN_STEP}
                check(got == BN_STEP, f"training step on the card "
                      f"({recipe}): K13 launched {got}, expected {BN_STEP}")
    # a score that lies within rounding of score_thre on one device and not
    # on the other changes the FPS mask, and with it some centers: so the
    # selections must agree on 97 % of their entries, and loss and gradients
    # are compared only when they agree on all
    for recipe in ("native", "f64 sums"):
        (out_g, loss_g, m_g), (out_c, loss_c, m_c) = (
            runs[recipe, "cuda"], runs[recipe, "cpu"])
        exact = True
        for field in ("center_index", "region_valid", "anchor_index",
                      "crop_valid"):
            same = float((getattr(out_g, field).cpu()
                          == getattr(out_c, field)).float().mean())
            print(f"training step ({recipe}): {field} equal share "
                  f"{same:.5f}")
            check(same >= 0.97, f"training step: {field} differs between "
                  f"card and CPU (equal share {same:.5f})")
            exact = exact and same == 1.0
        check(np.isfinite(loss_g) and np.isfinite(loss_c),
              "training step: non-finite loss")
        if not exact:
            print(f"training step ({recipe}): selections differ, loss and "
                  f"gradients not compared")
            continue
        check(abs(loss_g - loss_c) <= 1e-4 * max(1.0, abs(loss_c)),
              f"training step: loss {loss_g} on the card, {loss_c} on the "
              f"CPU ({recipe})")
        # f32 gradients carry the rounding of every train-mode BatchNorm
        # above them, each of which magnifies it: within 2 % of the array's
        # largest entry at the heads, 15 % at SA1's first layer, 21
        # normalisations below the loss; a wrong stride or a cut graph is
        # off by its whole size
        for name, tol in (("score_net.backbone.score_dense.weight", 2e-2),
                          ("grn_head.stem.dense.weight", 2e-2),
                          ("score_net.backbone.sa0.mlp.layer0.dense.weight",
                           0.15)):
            g_g = m_g.get_parameter(name).grad.cpu()
            g_c = m_c.get_parameter(name).grad
            err = float((g_g - g_c).abs().max() / g_c.abs().max())
            cos = float(torch.nn.functional.cosine_similarity(
                g_g.flatten(), g_c.flatten(), dim=0))
            print(f"training step ({recipe}): gradient of {name} card vs "
                  f"cpu, max abs err over max abs {err:.3e} (max abs "
                  f"{float(g_c.abs().max()):.3e}, cosine {cos:.6f})")
            check(float(g_c.abs().max()) > 0 and cos >= 0.99
                  and (recipe == "native" or err <= tol),
                  f"training step: gradient of {name} differs ({recipe})")


def fused_max_step_check(tmp) -> None:
    """One refine-stage training step at batch 2 on the card, f32 and bf16,
    deterministic as the train CLI runs it: through the fused SA max
    (K13e, K13f) and again with `BatchNorm.relu_max` replaced by the
    parent's path (K13's `_BatchNorm` with its ReLU, then ``amax``), the
    same weights, batch and seeds.  The metrics, every gradient, the
    updated parameters and the running buffers bit-equal; K13e and K13f
    launched `BN_SA_MAX` times in the first run, never in the second."""
    from regnet_for_3d_grasping_torch.cli.train import (build_model,
                                                        deterministic)
    from regnet_for_3d_grasping_torch.config import train_config
    from regnet_for_3d_grasping_torch.data import GraspDataset
    from regnet_for_3d_grasping_torch.nn import layers
    from regnet_for_3d_grasping_torch.ops import _cuda
    from regnet_for_3d_grasping_torch.train import trainer

    def parent_relu_max(self, x, dim):
        return self(x, True).amax(dim)

    names = ("bn_apply", "bn_apply_max", "bn_max_backward")
    for dtype in ("float32", "bfloat16"):
        cfg = train_config(**{"train.batch_size": 2,
                              "model.compute_dtype": dtype})
        R = cfg.region
        ds = GraspDataset(str(Path(tmp) / "scenes"), "train", R.num_points,
                          R.max_gt_grasps, 1)
        batch = trainer.device_batch(next(ds.batches(2, seed=0)), "cuda")
        runs = []
        for fused in (True, False):
            with deterministic(), contextlib.ExitStack() as stack:
                if not fused:
                    stack.enter_context(replaced(layers.BatchNorm,
                                                 "relu_max", parent_relu_max))
                model = build_model(cfg, 5, "cuda")
                opt = trainer.make_optimizer(model, cfg, 1)
                _cuda.reset_launches()
                metrics = trainer.train_step(
                    model, opt, batch, "refine",
                    generator=torch.Generator().manual_seed(0),
                    dropout_generator=torch.Generator(
                        device="cuda").manual_seed(0))
                torch.cuda.synchronize()
                runs.append((metrics, model,
                             {k: _cuda.launches[k] for k in names}))
        (m_f, model_f, l_f), (m_p, model_p, l_p) = runs
        want_f = {"bn_apply": BN_LAYERS - BN_SA_MAX,
                  "bn_apply_max": BN_SA_MAX, "bn_max_backward": BN_SA_MAX}
        want_p = {"bn_apply": BN_LAYERS, "bn_apply_max": 0,
                  "bn_max_backward": 0}
        check(l_f == want_f and l_p == want_p,
              f"fused-max step ({dtype}): launches {l_f} and {l_p}, "
              f"expected {want_f} and {want_p}")
        check(m_f.keys() == m_p.keys() and all(
            bit_equal(m_f[k], m_p[k]) for k in m_f),
              f"fused-max step ({dtype}): the metrics differ")
        params_p = dict(model_p.named_parameters())
        for name, p in model_f.named_parameters():
            q = params_p[name]
            check(bit_equal(p.detach(), q.detach()) and (
                (p.grad is None and q.grad is None)
                or bit_equal(p.grad, q.grad)),
                  f"fused-max step ({dtype}): {name} or its gradient "
                  f"differs")
        bufs_p = dict(model_p.named_buffers())
        for name, b in model_f.named_buffers():
            check(bit_equal(b, bufs_p[name]),
                  f"fused-max step ({dtype}): buffer {name} differs")
        print(f"fused-max step ({dtype}, batch 2): loss "
              f"{float(m_f['loss_total']):.6f}, metrics, gradients, "
              f"updated parameters and running buffers bit-equal to the "
              f"parent's K13b + amax step; launches {l_f} / {l_p}")


BF16_STEP_GRADS = ("score_net.backbone.score_dense.weight",
                   "grn_head.stem.dense.weight",
                   "score_net.backbone.sa0.mlp.layer0.dense.weight")
# phase 17's limit: the card's step within this multiple of how far one
# side's bf16 step moves when its GEMMs sum in f64, and never below one
# bf16 ulp at the top of the value (2^-8 of it) (PERF.md §6)
BF16_STEP_MULTIPLE, BF16_STEP_FLOOR = 3.0, 2.0 ** -8


def bf16_step_fields(data_dir: str, device: str, gemm: str = "native",
                     center_index: np.ndarray | None = None) -> dict:
    """One refine-stage bf16 training step at batch 2, full scan, full
    width (``train_config()``, dropout off, the initial weights of seed 5,
    fixed seeds) on `device` ("cpu": the plain versions and the CPU twin of
    the bf16 GEMM), forward, losses and backward -> its selections, loss,
    the gradients of `BF16_STEP_GRADS` and the seconds it took, as numpy.
    `gemm` and `center_index` as in `forward_fields`."""
    from regnet_for_3d_grasping_torch.cli.train import build_model
    from regnet_for_3d_grasping_torch.config import train_config
    from regnet_for_3d_grasping_torch.data import GraspDataset
    from regnet_for_3d_grasping_torch.geometry import region
    from regnet_for_3d_grasping_torch.models import regnet
    from regnet_for_3d_grasping_torch.nn import layers
    from regnet_for_3d_grasping_torch.ops.grouping import gather_points
    from regnet_for_3d_grasping_torch.train import trainer
    if device == "cpu":
        torch.set_num_threads(CPU_THREADS - 1)
    cfg = train_config(**{"model.dropout_prob": 0.0,
                          "model.compute_dtype": "bfloat16"})
    R = cfg.region
    batch = next(GraspDataset(data_dir, "train", R.num_points,
                              R.max_gt_grasps, 1).batches(2, seed=0))
    kw = dict(
        group_seeds=list(range(40, 40 + region.group_seed_count(
            R.center_num, R.num_points, R.group_num))),
        crop_seeds=[list(range(50, 50 + region.crop_seed_count(
            R.center_num, R.num_points, R.gripper_num)))])
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if gemm != "native":
            stack.enter_context(replaced(layers, "bf16_matmul",
                                         GEMMS[gemm]))
        if center_index is not None:
            idx = torch.from_numpy(center_index).to(device)
            stack.enter_context(replaced(
                regnet, "select_score_centers",
                lambda cloud, *_: (gather_points(cloud, idx), idx)))
        model = build_model(cfg, 5, device).train()
        out, total, _ = trainer.forward_losses(
            model, trainer.device_batch(batch, device), "refine", **kw)
        total.backward()
    fields = {k: getattr(out, k).cpu().numpy() for k in (
        "center_index", "region_valid", "anchor_index", "crop_valid")}
    fields["loss"] = float(total.detach())
    fields["grads"] = {n: model.get_parameter(n).grad.float().cpu().numpy()
                       for n in BF16_STEP_GRADS}
    fields["seconds"] = time.perf_counter() - t0
    return fields


def cpu_bf16_steps(data_dir: str) -> tuple:
    """The CPU's bf16 training step, and the same step with its GEMMs
    summed in f64 (`f64_gemm`) on the first's centers."""
    native = bf16_step_fields(data_dir, "cpu")
    return native, bf16_step_fields(data_dir, "cpu", "f64",
                                    native["center_index"])


def step_apart(a: dict, b: dict) -> dict:
    """How far two bf16 training steps lie apart: the loss (absolute) and
    each gradient of `BF16_STEP_GRADS` (largest difference over the
    largest entry of `b`'s)."""
    out = {"loss": abs(a["loss"] - b["loss"])}
    for n in BF16_STEP_GRADS:
        out[n] = float(np.abs(a["grads"][n] - b["grads"][n]).max()
                       / np.abs(b["grads"][n]).max())
    return out


def bf16_step_card_vs_cpu(data_dir: str, cpu_job) -> dict:
    """17. One bf16 training step on the card against the CPU's, both given
    the CPU's centers (`cpu_bf16_steps` in the helper process).  Masked FPS
    turns a one-ulp change of a bf16 score into other centers, and a
    train-mode BatchNorm magnifies any rounding change, so the yardstick is
    how far each side's own step moves when its GEMMs sum in f64: the loss,
    each gradient and the share of anchors and of crops that differ must
    lie within `BF16_STEP_MULTIPLE` times the larger of the two drifts (and
    may always lie `BF16_STEP_FLOOR` of the loss or of the gradient's
    largest entry apart, one bf16 ulp, or one anchor or crop: a drift of 0
    would otherwise forbid any difference); the regions, which follow from
    the centers and f32 geometry alone, at least 97 % equal."""
    cpu, cpu64 = cpu_job.result(timeout=900)
    card = bf16_step_fields(data_dir, "cuda",
                            center_index=cpu["center_index"])
    card64 = bf16_step_fields(data_dir, "cuda", "f64", cpu["center_index"])
    print(f"bf16 training step, batch 2: cpu {cpu['seconds']:.1f}s (f64 "
          f"GEMMs {cpu64['seconds']:.1f}s), card {card['seconds']:.2f}s; "
          f"losses cpu {cpu['loss']:.6f}, cpu f64 GEMMs {cpu64['loss']:.6f},"
          f" card {card['loss']:.6f}, card f64 GEMMs {card64['loss']:.6f}")
    err, d_cpu, d_card = (step_apart(card, cpu), step_apart(cpu64, cpu),
                          step_apart(card64, card))
    # the regions follow from the centers and f32 geometry alone; the
    # anchors are the argmax of 4 bf16 logits, which a rounding flips where
    # two lie an ulp apart, and the crops follow the anchors
    for k in ("region_valid", "anchor_index", "crop_valid"):
        err[k], d_cpu[k], d_card[k] = (
            float((a[k] != b[k]).mean())
            for a, b in ((card, cpu), (cpu64, cpu), (card64, card)))
        if k == "region_valid":
            check(err[k] <= 0.03, f"bf16 training step: {k} "
                  f"{1 - err[k]:.5f} equal between card and CPU")
    for k in err:
        if k == "region_valid":
            continue
        floor = (BF16_STEP_FLOOR * abs(cpu["loss"]) if k == "loss"
                 else 1.0 / cpu[k].size if k in cpu else BF16_STEP_FLOOR)
        limit = max(BF16_STEP_MULTIPLE * max(d_cpu[k], d_card[k]), floor)
        print(f"bf16 training step, {k}: card vs cpu {err[k]:.4e}; drift "
              f"with f64 GEMMs: cpu {d_cpu[k]:.4e}, card {d_card[k]:.4e}; "
              f"limit {limit:.4e}")
        check(np.isfinite(err[k]) and err[k] <= limit,
              f"bf16 training step: {k} differs between card and CPU")
    return {"card_vs_cpu": err, "cpu_f64_drift": d_cpu,
            "card_f64_drift": d_card}


def cpu_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`nn/layers.bf16_matmul`'s CPU recipe on any device: the f32 product
    of the bf16-rounded operands (TF32 is off), rounded once to bf16."""
    return torch.nn.functional.linear(
        x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
    ).to(torch.bfloat16)


def f64_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The bf16 GEMM summed in f64 (a sum of products of bf16 operands,
    exact in all but rare cases, so in any order), rounded to f32 and then
    to bf16: the same on the card and the CPU."""
    return torch.nn.functional.linear(
        x.to(torch.bfloat16).double(), w.to(torch.bfloat16).double()
    ).float().to(torch.bfloat16)


GEMMS = {"cpu": cpu_gemm, "f64": f64_gemm}


@contextlib.contextmanager
def replaced(module, name: str, value):
    """`module.name` is `value` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


F64 = ", f64 GEMMs"      # a CPU forward with `f64_gemm`'s sums
FIELDS = ("score", "center_index", "region_valid", "anchor_index",
          "proposals", "crop_valid", "final_grasps", "refine_accept")


def forward_fields(overrides: dict, pc: np.ndarray, device: str,
                   randomness: dict, gemm: str = "native",
                   center_index: np.ndarray | None = None) -> dict:
    """One forward at ``infer_config(**overrides)`` with the trained
    weights on `device` ("cpu": the plain versions and the CPU twin of the
    bf16 GEMM) and the given randomness (numpy arrays for tensors) -> the
    fields a card-CPU comparison reads, as numpy, and the seconds it
    took.  `gemm`: the bf16 GEMMs' recipe, "native" (as the port runs
    them), "cpu" (the CPU twin's, on the card too: `cpu_gemm`) or "f64"
    (`f64_gemm`).  `center_index` [1, NC] (rows in the forward's own
    order): the centers, in place of the masked FPS's picks."""
    from regnet_for_3d_grasping_torch.config import infer_config
    from regnet_for_3d_grasping_torch.models import regnet
    from regnet_for_3d_grasping_torch.nn import layers
    from regnet_for_3d_grasping_torch.ops.grouping import gather_points
    if device == "cpu":
        torch.set_num_threads(CPU_THREADS)
    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in randomness.items()}
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if gemm != "native":
            stack.enter_context(replaced(layers, "bf16_matmul",
                                         GEMMS[gemm]))
        if center_index is not None:
            idx = torch.from_numpy(center_index).to(device)
            stack.enter_context(replaced(
                regnet, "select_score_centers",
                lambda cloud, *_: (gather_points(cloud, idx), idx)))
        knobs = {}
        for name in ("pose_search_thetas", "funnel_guard_refine"):
            stack.enter_context(replaced(regnet, name, capturing(
                getattr(regnet, name), knobs.setdefault(name, []))))
        stack.enter_context(torch.inference_mode())
        model = regnet.build_regnet(infer_config(**overrides), WEIGHTS,
                                    device)
        out = model(torch.from_numpy(pc)[None].to(device), **kw)
    fields = {k: getattr(out, k).float().cpu().numpy() if
              getattr(out, k).is_floating_point()
              else getattr(out, k).cpu().numpy() for k in FIELDS}
    fields |= {k: v[0] for k, v in knobs.items() if v}
    if out.point_order is not None:
        fields["point_order"] = out.point_order.cpu().numpy()
    fields["seconds"] = time.perf_counter() - t0
    return fields


def capturing(fn, calls: list):
    """`fn`, which also appends each call's tensor arguments and result,
    as numpy, to `calls`."""
    def run(*args):
        out = fn(*args)
        calls.append({"args": [a.float().cpu().numpy() for a in args[:3]
                               if isinstance(a, torch.Tensor)],
                      "dtypes": [str(a.dtype) for a in args[:3]
                                 if isinstance(a, torch.Tensor)],
                      "out": out.float().cpu().numpy()})
        return out
    return run


class CpuForwards:
    """The CPU's side of the card-CPU comparisons: each forward runs in
    one helper process (spawned, `CPU_THREADS` threads) while the card
    phases go on, so they add little to the command's time.  `result`
    waits for one; `close` stops the process."""

    def __init__(self, pc: np.ndarray, cases: dict):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        self.jobs = {label: self.pool.submit(forward_fields, over, pc, "cpu",
                                             *args)
                     for label, (over, *args) in cases.items()}

    def result(self, label: str) -> dict:
        return self.jobs[label].result(timeout=900)

    def close(self) -> None:
        self.pool.shutdown(cancel_futures=True)


def card_vs_cpu(card: dict, cpu: dict, label: str) -> dict:
    """One forward on the card against the CPU's with the same weights and
    randomness -> how far they agree, printed: the scores (in the input's
    row order), the points on each side of score_thre (the FPS mask), the
    equal shares of every selection, and the share of proposals whose
    stage-2 and final grasps lie within 2e-2 of the CPU's largest entry
    (the CPU tests' limit for the tiny model)."""
    from regnet_for_3d_grasping_torch.config import infer_config
    score_g, score_c = card["score"], cpu["score"]
    out = {}
    if "point_order" in cpu:
        out["point_order_equal"] = float(
            (card["point_order"] == cpu["point_order"]).mean())
        # back to the input's row order, each by its own permutation
        score_g, score_c = np.empty_like(score_g), np.empty_like(score_c)
        np.put_along_axis(score_g, card["point_order"].astype(np.int64),
                          card["score"], 1)
        np.put_along_axis(score_c, cpu["point_order"].astype(np.int64),
                          cpu["score"], 1)
    err = np.abs(score_g - score_c)
    thre = infer_config().region.score_thre
    out |= {"score_max_abs_err": float(err.max()),
            "score_abs_err_p99": float(np.quantile(err, 0.99)),
            "score_sides_equal": float(((score_g > thre)
                                        == (score_c > thre)).mean())}
    for k in ("center_index", "region_valid", "anchor_index", "crop_valid",
              "refine_accept"):
        out[f"{k}_equal"] = float((card[k] == cpu[k]).mean())
    for k in ("proposals", "final_grasps"):
        row = np.abs(card[k] - cpu[k]).max(-1) / np.abs(cpu[k]).max()
        out[f"{k}_within_2e-2"] = float((row <= 2e-2).mean())
    print(f"{label}: card vs cpu " + ", ".join(
        f"{k} {v:.5g}" for k, v in out.items()))
    return out


def hold(out: dict, label: str, share: float,
         score_tol: float | None = None) -> None:
    """Fails unless every selection and grasp share of `out` is at least
    `share` and, where `score_tol` is given, every score lies within it of
    the CPU's."""
    check(out.get("point_order_equal", 1.0) == 1.0,
          f"slab order differs between card and CPU ({label})")
    check(score_tol is None or out["score_max_abs_err"] <= score_tol,
          f"scores differ between card and CPU ({label})")
    for k, v in out.items():
        if k.endswith(("_equal", "_within_2e-2")) and k != "score_sides_equal":
            check(v >= share, f"{k} {v:.5g} < {share} between card and CPU "
                  f"({label})")


def cpu_rows_on_card(index: np.ndarray, card: dict, cpu: dict) -> np.ndarray:
    """Rows of the CPU forward's cloud -> the same points' rows in the
    card's (the slab orders, each its own permutation of the input)."""
    if "point_order" not in cpu:
        return index
    rank = np.argsort(card["point_order"], axis=1)
    src = np.take_along_axis(cpu["point_order"].astype(np.int64),
                             index.astype(np.int64), 1)
    return np.take_along_axis(rank, src, 1).astype(index.dtype)


def eval_pickle(record, pred_dir, label) -> None:
    """Phase (d): the pickle of one served cloud holds, for every set, the
    grasps that the CPU's `eval_test` keeps of the forward's raw set on the
    cloud as loaded: the card's view filter equal grasp for grasp."""
    from regnet_for_3d_grasping_torch.config import GripperConfig
    from regnet_for_3d_grasping_torch.eval.evaluator import eval_test
    from regnet_for_3d_grasping_torch.utils.export import extract_grasp_sets
    with open(pred_dir / Path(record["path"]).name, "rb") as f:
        pred = pickle.load(f)
    g = GripperConfig()
    kept = {}
    for k, raw in extract_grasp_sets(record["out"])[0].items():
        want = eval_test(pred["points"], raw, None, g.table_height, g.depth,
                         g.width, g, device="cpu")
        check(np.array_equal(pred[k], want), f"{label}: the pickled {k} is "
              f"not the CPU's view filter of the raw set")
        kept[k] = f"{len(want)} of {len(raw)}"
    print(f"{label}: the infer CLI's evaluated sets (card) equal the CPU's "
          f"eval_test of the raw sets: kept {kept}")


def training_phases(dev) -> dict:
    """Phases 8-10: training through the train CLI, 4 steps at batch 12 on
    each path, and one step on the card against the CPU.  Returns the
    launch counts by path."""
    # 8./9. training: the train CLI, 4 steps at batch 12, both paths -----
    # 60 scenes: the split keeps 48 for training (4 batches of 12) and 12
    # for validation.  A validation forward runs the exact configuration at
    # batch 1 and 64 centers: the crop takes its plain path there
    # (64 x 25,600 pairs are under its kernel's threshold), as in training
    n_val = 12
    val = {"fps": 4, "ball_query": 1, "three_nn": 1,
           "group_regions_chunked": 1, "group_regions": 0, "gather_max": 2,
           **BN_EVAL}
    full_step = {"fps": 4, "ball_query": 1, "three_nn": 1,
                 "group_regions_chunked": 1, "group_regions": 0,
                 "gather_max_argmax": 2, "gather_max_backward": 2, **BN_STEP}
    plain = {}
    with tempfile.TemporaryDirectory() as tmp:
        train_full = train(["--synthetic-scenes", "60"], tmp, "full-scan",
                           n_val, full_step, val, plain)
        with SlabNNProbe() as probe:
            train_slab = train(
                ["--slab-cell", str(SLAB_CELL), "--fps-groups",
                 str(FPS_GROUPS)], tmp, "slab", n_val,
                {"fps_grouped": 1, "fps": 3, "group_slab": 2, "crop_slab": 1,
                 "three_nn_slab": 1, "three_nn": 1,
                 "gather_max_slab_argmax": 2, "gather_max_backward": 2,
                 **BN_STEP}, val)
        probe.report()
        # 10. one training step on the card and on the CPU; and on the
        # card through the fused SA max against the parent's K13b + amax
        train_step_card_vs_cpu(tmp, dev)
        fused_max_step_check(tmp)
        # 15./16. bf16 training (`--bf16`): the bf16 argmax forms and the
        # bf16 backward in every step, no f32 pool; the validation forwards
        # f32 at exact geometry, with the f32 pools
        bf16_full = train(
            ["--bf16"], tmp, "bf16-full-scan", n_val,
            {"fps": 4, "ball_query": 1, "three_nn": 1,
             "group_regions_chunked": 1, "group_regions": 0,
             "gather_max_argmax_bf16": 2, "gather_max_backward_bf16": 2,
             **BN_STEP}, val)
        with SlabNNProbe() as probe:
            bf16_slab = train(
                ["--bf16", "--slab-cell", str(SLAB_CELL), "--fps-groups",
                 str(FPS_GROUPS)], tmp, "bf16-slab", n_val,
                {"fps_grouped": 1, "fps": 3, "group_slab": 2, "crop_slab": 1,
                 "three_nn_slab": 1, "three_nn": 1,
                 "gather_max_slab_argmax_bf16": 2,
                 "gather_max_backward_bf16": 2, **BN_STEP}, val)
        probe.report()
        # (g) the train CLI's flags that no other phase drives
        t0 = time.perf_counter()
        knobs = training_knob_phase(tmp, plain, n_val, full_step, val)
        print(f"phase (g): {time.perf_counter() - t0:.1f} s")
    return {"train_full_scan": train_full, "train_slab": train_slab,
            "train_bf16_full_scan": bf16_full, "train_bf16_slab": bf16_slab,
            **knobs}


def serving_wants() -> dict:
    """The launches of one forward on each serving path (full scan, slab,
    bf16 full scan, `--fast`), by kernel: K13b once a BatchNorm (the
    served model has `BN_LAYERS`) but for SA1-3's last, K13e."""
    from regnet_for_3d_grasping_torch.config import infer_config
    from regnet_for_3d_grasping_torch.models.regnet import REGNet
    from regnet_for_3d_grasping_torch.nn.layers import BatchNorm
    n_bn = sum(isinstance(m, BatchNorm)
               for m in REGNet(infer_config()).modules())
    check(n_bn == BN_LAYERS, f"the served model has {n_bn} BatchNorms, "
          f"expected {BN_LAYERS}")
    f32_zero = dict.fromkeys(TRAIN_KERNELS + BF16_KERNELS, 0) | BN_EVAL
    full_want = {"fps": 4, "ball_query": 1, "three_nn": 1, "gather_max": 2,
                 "crop": 1, "group_regions_chunked": 1, "group_regions": 0,
                 **dict.fromkeys(SLAB_KERNELS, 0), **f32_zero}
    # K3 launches in every slab forward: its launches read K8's flag on
    # the card and return at once where the slab 3-NN is proven
    slab_want = {"fps_grouped": 2, "fps": 2, "group_slab": 2, "crop_slab": 1,
                 "three_nn_slab": 1, "three_nn": 1, "gather_max_slab": 2,
                 "ball_query": 0, "gather_max": 0, "crop": 0,
                 "group_regions": 0, "group_regions_chunked": 0, **f32_zero}
    # the bf16 paths launch the bf16 pools and no f32 pool
    return {"full_scan": full_want, "slab": slab_want,
            "bf16_full_scan": full_want | {"gather_max": 0,
                                           "gather_max_bf16": 2},
            "fast": slab_want | {"gather_max_slab": 0,
                                 "gather_max_slab_bf16": 2}}


def serving_phases(wants: dict) -> dict:
    """Phases 4, 6, 11 and 12: each serving path through the infer CLI on
    3 clouds, launch counts reset before and read after (`wants`: one
    forward's, by path).  Returns the counts and the median forward
    seconds, by path."""
    paths, medians = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, label, flags in (
                # 4. the full-scan path; 6. the sorted-slab serving path
                ("full_scan", "full-scan", []),
                ("slab", "slab", ["--slab-cell", str(SLAB_CELL),
                                  "--fps-groups", str(FPS_GROUPS)]),
                # 11. bf16 on the full scan; 12. the JAX configuration of
                # record, bf16 + slab + G = 8
                ("bf16_full_scan", "bf16-full-scan", ["--bf16"]),
                ("fast", "fast", ["--fast"])):
            want = wants[key]
            records, launches, fallbacks = serve(
                flags, tmp, label, check_eval=key == "full_scan")
            medians[key] = statistics.median(r["forward_s"] for r in records)
            for k, n in want.items():
                check(launches[k] == 3 * n, f"{k}: {launches[k]} launches "
                      f"in 3 {label} forwards, expected {3 * n}")
            if "--slab-cell" in flags or "--fast" in flags:
                print(f"{label} path: {fallbacks} of 3 forwards fell back to "
                      f"the full-scan 3-NN")
            paths[key] = launches
    return paths, medians


def compare_phases(pc, compared, cpu) -> dict:
    """Phases 5, 7, 13 and 14: one forward of each serving path on the
    card against the CPU's (from the helper process).

    f32: scores within 1e-4, and every selection (centers, regions,
    anchors, crops, refine acceptance) and grasp share at least 99 %.
    bf16: the trained network carries a one-ulp change of any bf16
    rounding to its scores, and masked FPS, which is sequential, turns one
    mask point that differs into other picks from then on; so how far the
    CPU's own forward drifts from one with its GEMMs summed in f64
    (`f64_gemm`) is the yardstick.  The card's forward (cuBLAS) is
    printed beside it, with the card's forwards with the CPU twin's GEMM
    recipe (`cpu_gemm`) and with f64 sums (against the CPU's f64 forward).
    Held: the card's scores within twice the yardstick's largest and 99th
    percentile differences, and, with both sides given the CPU's centers,
    everything after the score: the selections at least 97 % equal and
    97 % of the grasps within 2e-2 of the CPU's largest entry."""
    agreement = {}
    for label, (over, rand, *_) in compared.items():
        if label.endswith(F64):
            continue
        ref = cpu.result(label)
        print(f"{label}: cpu forward {ref['seconds']:.1f}s")
        card = forward_fields(over, pc, "cuda", rand)
        agreement[label] = out = card_vs_cpu(card, ref, label)
        if "pose_search_thetas" in ref or "funnel_guard_refine" in ref:
            out |= knobs_on_cpu_inputs(over, card, ref, label)
        if "model.compute_dtype" not in over:
            hold(out, label, 0.99, 1e-4)
            continue
        ref64 = cpu.result(label + F64)
        yard = agreement[f"{label}: the CPU{F64} against the CPU"] = \
            card_vs_cpu(ref64, ref, f"{label}, the CPU{F64}")
        for k in ("score_max_abs_err", "score_abs_err_p99"):
            check(out[k] <= 2 * yard[k], f"{k} {out[k]:.5g} above twice the "
                  f"CPU's own {yard[k]:.5g} ({label})")
        for gemm, base in (("cpu", ref), ("f64", ref64)):
            run = f"{label}, GEMMs by the {gemm} recipe"
            agreement[run] = card_vs_cpu(forward_fields(
                over, pc, "cuda", rand, gemm), base, run)
        run = f"{label}, the CPU's centers"
        agreement[run] = card_vs_cpu(forward_fields(
            over, pc, "cuda", rand, center_index=cpu_rows_on_card(
                ref["center_index"], card, ref)), ref, run)
        hold(agreement[run], run, 0.97)
    print(json.dumps({"card_vs_cpu": agreement}))
    return agreement


def knobs_on_cpu_inputs(over, card, cpu, label) -> dict:
    """Phase (f)'s card-CPU checks of the knobs: the pose search and the
    guard on the card, given the CPU forward's inputs (its cloud in model
    order, its stage-2 proposals, its refined grasps), equal the CPU's
    results bit for bit; between the two forwards, the chosen thetas are
    equal on every row whose stage-2 proposal is equal, and in f32 the
    same variant is chosen on at least 99 % of the rows."""
    from regnet_for_3d_grasping_torch.config import infer_config
    from regnet_for_3d_grasping_torch.models import regnet
    cfg = infer_config(**over)
    r, g = cfg.region, cfg.gripper
    dt = {"torch.float32": torch.float32, "torch.bfloat16": torch.bfloat16}

    def on_card(call):
        return [torch.from_numpy(a).cuda().to(dt[d])
                for a, d in zip(call["args"], call["dtypes"])]

    out = {}
    with torch.inference_mode():
        if "pose_search_thetas" in cpu:
            call = cpu["pose_search_thetas"]
            got = regnet.pose_search_thetas(
                *on_card(call), r.pose_search_k, r.pose_search_subsample,
                r.pose_search_table, g).float().cpu().numpy()
            check(np.array_equal(got, call["out"]), f"{label}: the pose "
                  f"search on the card differs from the CPU's on its inputs")
            before, after = call["args"][1], call["out"]
            out["search_changed_thetas"] = int(
                (before[..., 6] != after[..., 6]).sum())
            mine = card["pose_search_thetas"]
            same = (mine["args"][1] == before).all(-1)
            check(np.array_equal(mine["out"][same][:, 6],
                                 after[same][:, 6]),
                  f"{label}: equal stage-2 proposals, other thetas")
            out["search_rows_equal_inputs"] = int(same.sum())

            def variant(call):
                step = 2 * np.pi / r.pose_search_k
                d = call["out"][..., 6] - call["args"][1][..., 6]
                return np.rint(d / step).astype(np.int64) % r.pose_search_k

            # the variant each side chose, on its own stage-2 proposals
            out["search_variant_equal_share"] = float(
                (variant(mine) == variant(call)).mean())
            if "model.compute_dtype" not in over:
                check(out["search_variant_equal_share"] >= 0.99,
                      f"{label}: the two forwards chose other variants")
        if "funnel_guard_refine" in cpu:
            call = cpu["funnel_guard_refine"]
            got = regnet.funnel_guard_refine(
                *on_card(call), r.refine_guard_subsample,
                r.pose_search_table, g).float().cpu().numpy()
            check(np.array_equal(got, call["out"]), f"{label}: the guard "
                  f"on the card differs from the CPU's on its inputs")
            restored = (call["out"][..., :7] != call["args"][1][..., :7]
                        ).any(-1)
            mine = card["funnel_guard_refine"]
            out["guard_restored"] = int(restored.sum())
            out["guard_choice_equal_share"] = float((
                (mine["out"][..., :7] != mine["args"][1][..., :7]).any(-1)
                == restored).mean())
    print(f"{label}: the knobs on the card given the CPU's inputs equal the "
          f"CPU's: {out}")
    return out


# --- the serving knobs and the train CLI's other flags ----------------------

def knob_runs() -> tuple:
    """Phase (f)'s configurations: (key, infer CLI flags, configuration
    overrides, the randomness of the card-CPU forward: "full" or
    "slab")."""
    slab = {"region.slab_cell": SLAB_CELL, "model.fps_groups": FPS_GROUPS,
            "region.center_fps_groups": FPS_GROUPS}
    search = {"region.pose_search_k": 8}
    guard = {"region.refine_guard": True}
    return (
        # the JAX knob run of record (docs/evidence/real_data_r5_knobs.json:
        # exact + min-z 0.75 + search 8), here on synthetic clouds
        ("knob-minz-search", ["--center-min-z", "0.75", "--pose-search",
                              "8"], {"region.center_min_z": 0.75, **search},
         "full"),
        ("knob-guard", ["--refine-guard"], guard, "full"),
        ("knob-bucket", ["--center-select", "bucket"],
         {"region.center_select": "bucket"}, "full"),
        ("knob-fast-search-guard", ["--fast", "--pose-search", "8",
                                    "--refine-guard"],
         {**slab, "model.compute_dtype": "bfloat16", **search, **guard},
         "slab"),
        # the search's stride over the slab-sorted cloud
        ("knob-slab-search", ["--slab-cell", str(SLAB_CELL), "--fps-groups",
                              str(FPS_GROUPS), "--pose-search", "8"],
         {**slab, **search}, "slab"))


class KnobProbe:
    """Within the block, every call of the pose search and of the guard is
    timed on the card (CUDA events around it, read after the run) and kept
    with its arguments and result, and every center selection keeps the
    cloud's z, the scores, its arguments and the centers' z."""

    def __init__(self):
        self.calls = {"pose_search_thetas": [], "funnel_guard_refine": []}
        self.select = []

    def __enter__(self):
        from regnet_for_3d_grasping_torch.models import regnet
        self.stack = contextlib.ExitStack()
        for name, calls in self.calls.items():
            self.stack.enter_context(replaced(
                regnet, name, self._timed(getattr(regnet, name), calls)))
        select = regnet.select_score_centers

        def spy(pc, score, *args):
            out = select(pc, score, *args)
            self.select.append((pc[..., 2], score, args, out[0][..., 2]))
            return out

        self.stack.enter_context(replaced(regnet, "select_score_centers",
                                          spy))
        return self

    @staticmethod
    def _timed(fn, calls):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            calls.append((start, end, args, out))
            return out
        return run

    def __exit__(self, *exc):
        self.stack.close()

    def ms(self, name) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e, *_ in self.calls[name]]


def knob_serving_phase(wants: dict) -> tuple:
    """Phase (f): the infer CLI with the serving knobs on the 3 tabletop
    clouds at full width, one run per `knob_runs` configuration, the
    launch counters reset before and read after (the funnels launch no
    kernel of the port; the bucket selection replaces the center FPS);
    the forward timed, and the pose search and the guard timed apart.
    Checks: with `center_min_z`, every center lies above it where the
    cloud has a positive above it; at `refine_guard_subsample` 1, every
    stage-2 survivor of the funnel survives at stage 3 (on the card).
    Returns (launches by run, readings by run)."""
    from regnet_for_3d_grasping_torch.config import infer_config
    from regnet_for_3d_grasping_torch.eval.collision import view_check_funnel
    paths, readings = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, flags, over, _ in knob_runs():
            base = ("fast" if "model.compute_dtype" in over else "slab") \
                if "region.slab_cell" in over else "full_scan"
            want = dict(wants[base])
            if over.get("region.center_select") == "bucket":
                want["fps"] -= 1
            with KnobProbe() as probe:
                records, launches, _ = serve(flags, tmp, key)
            for k, n in want.items():
                check(launches[k] == 3 * n, f"{key}: {k} launched "
                      f"{launches[k]} times in 3 forwards, expected {3 * n}")
            cfg = infer_config(**over)
            reading = {"forward_ms": [r["forward_s"] * 1e3 for r in records],
                       "pose_search_ms": probe.ms("pose_search_thetas"),
                       "guard_ms": probe.ms("funnel_guard_refine")}
            check(len(reading["pose_search_ms"]) == 3 * bool(
                cfg.region.pose_search_k) and len(reading["guard_ms"])
                == 3 * cfg.region.refine_guard, f"{key}: knob calls")
            min_z = cfg.region.center_min_z
            if min_z is not None:
                for z, score, args, cz in probe.select:
                    has = ((score > args[1]) & (z > min_z)).any(-1)
                    check(bool((cz[has] > min_z).all()), f"{key}: a center "
                          f"below {min_z} where a positive lies above it")
                reading["clouds_with_a_positive_above"] = sum(
                    int(((s > a[1]) & (z > min_z)).any()) for z, s, a, _
                    in probe.select)
            search = probe.calls["pose_search_thetas"]
            reading["search_changed_thetas"] = [
                int((out[..., 6] != args[1][..., 6]).sum())
                for *_, args, out in search]
            guard = []
            for *_, args, out in probe.calls["funnel_guard_refine"]:
                pts, refined, s2, sub = args[:4]
                f = [view_check_funnel(pts[0].float(), x[0, :, :8].float(),
                                       cfg.region.pose_search_table,
                                       cfg.gripper.depth, cfg.gripper,
                                       cfg.eval)["survive"]
                     for x in (s2, refined, out)]
                if sub == 1:
                    check(bool((f[2] | ~f[0]).all()), f"{key}: a stage-2 "
                          f"survivor failed at stage 3 after the guard")
                guard.append({"stage2_survivors": int(f[0].sum()),
                              "refined_survivors": int(f[1].sum()),
                              "served_survivors": int(f[2].sum()),
                              "restored": int((out[0, :, :7] != refined[
                                  0, :, :7]).any(-1).sum())})
            reading["guard"] = guard
            print(f"{key}: forward ms {reading['forward_ms']}, pose search "
                  f"ms {reading['pose_search_ms']}, guard ms "
                  f"{reading['guard_ms']}, "
                  + json.dumps({k: v for k, v in reading.items()
                                if not k.endswith("_ms")}))
            paths[key], readings[key] = launches, reading
    return paths, readings


def training_knob_phase(tmp, plain: dict, n_val: int, step_want: dict,
                        val_want: dict) -> dict:
    """Phase (g): the train CLI at batch 12 and full width on phase 8's
    scenes with each flag no other phase drives: `--eval-grasps
    --eval-every 1` (the VGR records logged, the evaluation's seconds in
    the epoch);
    `--geom-aug 1.0 --native-loader --profile-dir` (every step's batch
    from the native loader, augmented; a trace naming the port's kernels);
    `--remat` against phase 8's run without it (`plain`): parameters and
    statistics after the epoch's 4 steps bit-equal, losses equal, peak
    memory and step times of both.  Each run's launches as phase 8's, but
    that remat's recompute launches K13a once more for each BatchNorm of
    the SA and FP layers, and K13b (SA1-3's last: K13e) with it.  Returns the launches by run."""
    import re
    from regnet_for_3d_grasping_torch.data import augment, native_loader
    from regnet_for_3d_grasping_torch.eval import evaluator
    from regnet_for_3d_grasping_torch.ops._cuda import CSRC
    paths = {}
    spent = []
    evaluate = evaluator.evaluate_scene_grasps

    def timed(*args, **kw):
        t0 = time.perf_counter()
        rec = evaluate(*args, **kw)
        spent.append(time.perf_counter() - t0)
        return rec

    keep = {}
    t0 = time.perf_counter()
    with replaced(evaluator, "evaluate_scene_grasps", timed):
        paths["train_eval_grasps"] = train(
            ["--eval-grasps", "--eval-every", "1"], tmp, "eval-grasps",
            n_val, step_want, val_want, keep)
    seconds = time.perf_counter() - t0
    recs = keep["res"]["grasp_records"]
    check(len(recs) == 1 and recs[0]["records"]["stage2"].formal > 0,
          "(g) no grasp records")
    with open(Path(tmp) / "log" / "eval-grasps" / "metrics.jsonl") as f:
        logged = {json.loads(line)["tag"] for line in f}
    check("epoch_validate_stage2_vgr" in logged, "(g) VGR not logged")
    print(f"(g) --eval-grasps: {len(spent)} evaluator calls, "
          f"{sum(spent):.3f} s of evaluation in the epoch's validation "
          f"({n_val} scenes; the run {seconds:.1f} s); records "
          + json.dumps({k: {"vgr": v.vgr, "score": v.score, "formal":
                            v.formal} for k, v in
                        recs[0]["records"].items()})
          + f"; logged {sorted(t for t in logged if t.startswith('epoch_'))}")

    counts = {"augment": 0, "native": 0}
    aug, nxt = augment.augment_batch, native_loader.NativeLoader.next_batch

    def aug_spy(*args):
        counts["augment"] += 1
        return aug(*args)

    def next_spy(self):
        counts["native"] += 1
        return nxt(self)

    keep = {}
    trace_dir = Path(tmp) / "trace"
    with replaced(augment, "augment_batch", aug_spy), \
            replaced(native_loader.NativeLoader, "next_batch", next_spy):
        paths["train_aug_native"] = train(
            ["--geom-aug", "1.0", "--native-loader", "--profile-dir",
             str(trace_dir)], tmp, "aug-native", n_val, step_want, val_want,
            keep)
    check(counts == {"augment": 4, "native": 4}, f"(g) {counts}")
    trace = keep["res"]["trace"]
    check(trace is not None and Path(trace).exists(), "(g) no trace")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    texts = [src.read_text() for src in CSRC.glob("*.cu*")]
    names = {m for t in texts
             for m in re.findall(r"\b(\w+_kernel)\s*\(", t)}
    found = {n for e in events if e.get("cat") == "kernel"
             for n in names if n in e.get("name", "")}
    check("fps_cluster_kernel" in found and len(found) >= 4,
          f"(g) the trace names {sorted(found)}")
    print(f"(g) --geom-aug 1.0 --native-loader: 4 native batches, 4 "
          f"augmented; trace {Path(trace).name} "
          f"({Path(trace).stat().st_size} bytes, {len(events)} events) "
          f"names the port's kernels {sorted(found)}")

    keep = {}
    paths["train_remat"] = train(
        ["--remat"], tmp, "remat", n_val,
        step_want | {k: step_want[k] + n for k, n in BN_REMAT_EXTRA.items()},
        val_want, keep)
    a, b = plain["res"], keep["res"]
    check([s["loss"] for s in a["steps"]] == [s["loss"] for s in b["steps"]],
          "(g) --remat changed the losses")
    sa, sb = a["model"].state_dict(), b["model"].state_dict()
    check(all(torch.equal(sa[n], sb[n]) for n in sa),
          "(g) --remat: parameters or statistics differ after 4 steps")
    print(f"(g) --remat: losses, parameters and BatchNorm statistics "
          f"bit-equal to phase 8's after 4 steps; peak "
          f"{keep['peak'] / 2**30:.3f} GiB (without: "
          f"{plain['peak'] / 2**30:.3f}), step ms "
          f"{[round(x, 3) for x in keep['ms']]} (without: "
          f"{[round(x, 3) for x in plain['ms']]})")
    return paths


# --- PR 11: K8 flat, determinism, the evaluator, the suite -----------------

def k8_flat_case(label, q, k, bound=0.06, grid_span=3, reps=20,
                 plain_reps=3) -> dict:
    """Phase (a), K8 flat at one shape: the call (`three_nn_slab_call(...,
    flat=True)`) against its plain version (`three_nn_spans(..., flat=True)`,
    `three_nn_slab_plain`, `three_nn_certificate`), spans and bounds exact,
    indices exact, distances bit-equal, `proven` and the flag equal; which
    grid the card chose (the unclamped spans where they sum to at most G),
    against the bounded K8 in the same run.  Returns the record row."""
    from regnet_for_3d_grasping_torch.ops import slab

    def call():
        return slab.three_nn_slab_call(q, k, bound, grid_span, flat=True)

    def bounded():
        return slab.three_nn_slab_call(q, k, bound, grid_span)

    def plain():
        ss, lr = slab.three_nn_spans(q, k, bound, grid_span, flat=True)
        idx, d2 = slab.three_nn_slab_plain(q, k, ss)
        return slab.SlabNN(idx, d2, slab.three_nn_certificate(q, d2, lr),
                           None, ss, lr)

    nn, ref, bnn = call(), plain(), bounded()
    check(torch.equal(nn.ss, ref.ss) and torch.equal(nn.lr, ref.lr),
          f"K8 flat's spans differ from three_nn_spans(flat=True) ({label})")
    check(torch.equal(nn.idx, ref.idx), f"K8 flat indices differ ({label})")
    check(torch.equal(nn.d2, ref.d2), f"K8 flat distances are not "
          f"bit-equal to the plain version's ({label})")
    check(torch.equal(nn.proven, ref.proven)
          and int(nn.fallback) == int(not bool(ref.proven.all())),
          f"K8 flat's certificate differs from its plain version ({label})")
    B, T = nn.ss.shape[:2]
    unclamped = slab.three_nn_spans(q, k, bound, 99)[0]
    spans = unclamped[..., 1] - unclamped[..., 0]
    total, steps = int(spans.sum()), slab.flat_steps(B, T)
    cut = int((spans > grid_span).sum())
    taken = total <= steps
    check(torch.equal(nn.ss, unclamped if taken else bnn.ss),
          f"K8 flat scanned other spans than its grid rule's ({label})")
    differs = not all_equal((nn.idx, nn.d2, nn.proven),
                            (bnn.idx, bnn.d2, bnn.proven))
    check(differs <= (taken and cut > 0), f"K8 flat differs from the "
          f"bounded grid on the same spans ({label})")
    pairs = scanned_pairs(nn.ss, q.shape[1], 256, 1024, k.shape[1])

    def cdist_topk():
        return torch.cdist(q, k).topk(3, dim=-1, largest=False)

    dms = device_ms(call, reps)
    row = {"shape": label, "max_abs_err": max_err((nn.idx, nn.d2),
                                                  (ref.idx, ref.d2)),
           "ms": cuda_ms(call, reps), "plain_ms": cuda_ms(plain, plain_reps),
           "bytes": nbytes(q, k, nn.ss, nn.idx, nn.d2), "ops": pairs * 10,
           "library_ms": cuda_ms(cdist_topk, 5), "device_ms": dms,
           "bounded_device_ms": device_ms(bounded, reps),
           "flat_taken": taken, "span_total": total, "G": steps,
           "tiles_cut_by_clamp": cut, "pairs_scanned": pairs,
           "differs_from_bounded": differs,
           "proven": int(nn.proven.sum()), "bounded_proven":
           int(bnn.proven.sum()), "clouds": B}
    print(f"three_nn_slab_flat {label}: spans sum {total} of G {steps} "
          f"(flat {'taken' if taken else 'not taken: the bounded grid'}), "
          f"{cut} tiles cut by the clamp, proven {row['proven']} of {B} "
          f"(bounded grid {row['bounded_proven']}), differs from the "
          f"bounded grid: {differs}; device {dms:.4f} ms, bounded "
          f"{row['bounded_device_ms']:.4f} ms, {pairs} pairs scanned")
    return row


def k8_flat_kernels(record, sx, centroids, q12, k12) -> dict:
    """Phase (a): K8 flat at serving (FP3: the slab-sorted cloud against
    its x-sorted SA1 centers) and at 12 training clouds, and where it falls
    back (a bound of 0.3 m: the spans sum past G) or differs from the
    bounded grid (a clamp of 1 block).  Then its entry point's path:
    `three_nn_slab(flat=True)` at both shapes, counters reset just before
    and read just after.  Returns those counts."""
    from regnet_for_3d_grasping_torch.ops import _cuda, slab
    rows = [k8_flat_case("FP3 serving: 25600 slab-sorted queries x 5120 "
                         "x-sorted keys", sx, centroids),
            k8_flat_case("FP3 training: 12 slab-sorted clouds x 5120 "
                         "x-sorted keys", q12, k12, reps=10, plain_reps=1)]
    fb = k8_flat_case("serving, bound 0.3: the spans sum past G", sx,
                      centroids, bound=0.3, reps=5, plain_reps=1)
    check(not fb["flat_taken"] and not fb["differs_from_bounded"],
          "K8 flat did not fall back to the bounded grid past G")
    cut = k8_flat_case("serving, a clamp of 1 block", sx, centroids,
                       grid_span=1, reps=5, plain_reps=1)
    check(cut["flat_taken"] and cut["differs_from_bounded"],
          "K8 flat did not scan past the clamp of 1 block")
    record_rows(record, "three_nn_slab_flat", CSRC + "three_nn_slab.cu",
                JAX_OPS + "slab.py:885", rows)
    _cuda.reset_launches()
    for q, k in ((sx, centroids), (q12, k12)):
        slab.three_nn_slab(q, k, 0.06, 3, flat=True)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    check(launches["three_nn_slab_flat"] == 2
          and launches["three_nn_slab"] == 0,
          f"three_nn_slab(flat=True) did not launch K8 flat: {launches}")
    return launches


DET_STEPS = 3     # phase (b): steps a run


def determinism_phase(tmp) -> dict:
    """Phase (b): the train CLI twice from one seed, `DET_STEPS` steps at
    batch 12, on the full scan in f32 and on the bf16 slab (the run of
    record's configuration): losses and every parameter and buffer
    bit-equal.  Then the same four training configurations with the CLI's
    `deterministic` block replaced by a no-op, for the step time that the
    determinism costs (phases 8, 9, 15 and 16 are the deterministic
    ones).  Returns the step times by configuration."""
    from regnet_for_3d_grasping_torch.cli import train as train_cli
    from regnet_for_3d_grasping_torch.data import write_synthetic_dataset
    data = Path(tmp) / "det_scenes"
    # 80 % of 45 scenes train: 36, 3 steps at batch 12
    write_synthetic_dataset(str(data), 45, num_view=N_POINTS)
    slab_flags = ["--slab-cell", str(SLAB_CELL), "--fps-groups",
                  str(FPS_GROUPS)]
    configs = {"full scan f32": [], "slab f32": slab_flags,
               "full scan bf16": ["--bf16"],
               "slab bf16": ["--bf16", *slab_flags]}

    def run(label, flags, tag):
        res = train_cli.main(
            ["--mode", "train", "--data-path", str(data), "--model-path",
             str(Path(tmp) / "det_models"), "--log-path",
             str(Path(tmp) / "det_log"), "--tag", tag, "--batch-size",
             str(TRAIN_B), "--epoch", "1", "--seed", "1", *flags])
        check(len(res["steps"]) == DET_STEPS, f"{label}: "
              f"{len(res['steps'])} steps, expected {DET_STEPS}")
        return res

    out = {}
    for label in ("full scan f32", "slab bf16"):
        a = run(label, configs[label], "det_a")
        b = run(label, configs[label], "det_b")
        sa, sb = a["model"].state_dict(), b["model"].state_dict()
        losses = [s["loss"] for s in a["steps"]]
        check(losses == [s["loss"] for s in b["steps"]],
              f"{label}: two runs' losses differ")
        check(all(torch.equal(sa[n], sb[n]) for n in sa),
              f"{label}: two runs' parameters differ after {DET_STEPS} "
              f"steps")
        print(f"determinism, {label}: two runs of {DET_STEPS} steps "
              f"bit-equal (losses {losses})")
        out[label] = {"deterministic_step_s": [s["seconds"] for s in
                                               a["steps"] + b["steps"]]}
    with replaced(train_cli, "deterministic", contextlib.nullcontext):
        for label, flags in configs.items():
            res = run(label, flags, "nondet")
            out.setdefault(label, {})["nondeterministic_step_s"] = [
                s["seconds"] for s in res["steps"]]
    for label, times in out.items():
        print(f"{label}: step s " + ", ".join(
            f"{k} {[round(x, 4) for x in v]}" for k, v in times.items()))
    return out


ORBAX_FIXTURE = ROOT / "tests" / "data" / "orbax_tiny"


def flat_leaves(tree, path=()):
    """(path, leaf) of a restored tree in JAX's flattening order: dict keys
    sorted, list items in order, None a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat_leaves(v, path + (str(i),))
    else:
        yield list(path), tree


def same_leaves(a, b) -> bool:
    """Two checkpoint trees with the same paths, None leaves, dtypes,
    shapes and bytes."""
    fa, fb = list(flat_leaves(a)), list(flat_leaves(b))
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        (x is None and y is None) or (
            x is not None and y is not None
            and (np.asarray(x).dtype, np.asarray(x).shape)
            == (np.asarray(y).dtype, np.asarray(y).shape)
            and np.asarray(x).tobytes() == np.asarray(y).tobytes())
        for (_, x), (_, y) in zip(fa, fb))


def orbax_write_ms(model, optimizer, epoch: int) -> tuple:
    """(median ms of 3 `save_checkpoint` calls of `model` and `optimizer`
    from the card into a temporary directory, host clock; the arrays'
    bytes)."""
    from regnet_for_3d_grasping_torch.utils import checkpoint

    n_bytes = sum(np.asarray(x).nbytes for _, x in flat_leaves(
        checkpoint.train_state(model, optimizer)) if x is not None)
    times = []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save_checkpoint(tmp, epoch, model, optimizer)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), n_bytes


def orbax_phase(dev, smi: str) -> tuple:
    """Phase (k): the JAX package's Orbax checkpoint fixture through the
    port's reader, a forward and the train CLI's ``--resume`` on the card;
    then what the resumed step wrote, ``ckpt_1/``, the JAX package's
    checkpoint written by the port: read back, resumed again beside a
    ``ckpt_1.pt`` of the same state, and served.  Returns (the launch
    counts of the forwards and of the resumed steps, the phase's
    numbers)."""
    import hashlib
    import shutil
    from regnet_for_3d_grasping_torch.cli import train as train_cli
    from regnet_for_3d_grasping_torch.config import infer_config, tiny_config
    from regnet_for_3d_grasping_torch.models.regnet import build_regnet
    from regnet_for_3d_grasping_torch.ops import _cuda
    from regnet_for_3d_grasping_torch.train import trainer
    from regnet_for_3d_grasping_torch.utils import checkpoint, ocdbt, zstd
    from regnet_for_3d_grasping_torch.utils.scene import tabletop_cloud

    zstd.build_library()          # built before the reader is timed
    t0 = time.perf_counter()
    tree, resume = checkpoint.restore_orbax(str(ORBAX_FIXTURE))
    read_ms = (time.perf_counter() - t0) * 1e3
    expected = json.loads((ORBAX_FIXTURE / "expected.json").read_text())
    got = list(flat_leaves(tree))
    check(resume == expected["epoch"] + 1
          and len(got) == len(expected["leaves"]),
          f"phase (k): {len(got)} leaves at epoch {resume - 1}, the fixture "
          f"has {len(expected['leaves'])} at {expected['epoch']}")
    n_bytes = 0
    for (path, leaf), want in zip(got, expected["leaves"]):
        check(path == want["path"], f"phase (k): leaf {path} where the "
              f"fixture has {want['path']}")
        if want.get("none"):
            check(leaf is None, f"phase (k): {path} is not None")
            continue
        if isinstance(leaf, torch.Tensor):
            dtype, raw = "bfloat16", leaf.view(torch.int16).numpy().tobytes()
        else:
            dtype, raw = str(leaf.dtype), leaf.tobytes()
        n_bytes += len(raw)
        check((dtype, list(leaf.shape), hashlib.sha256(raw).hexdigest())
              == (want["dtype"], want["shape"], want["sha256"]),
              f"phase (k): {path} differs from the fixture's expected.json")
    # the decoder alone, over the fixture's zarr chunks
    store = ocdbt.KvStore(ORBAX_FIXTURE / "ckpt_0")
    frames = [store.read(k) for k in store.keys()
              if not k.endswith(b"/.zarray")]
    t0 = time.perf_counter()
    decoded = sum(len(zstd.decompress(f)) for f in frames)
    decode_s = time.perf_counter() - t0

    # one forward from an Orbax directory and from the same values given
    # as arrays (the npz layout): bit-equal
    cfg = tiny_config()
    n = cfg.region.num_points
    cxyz, crgb = tabletop_cloud(np.random.RandomState(7), n + 64)
    pc = torch.tensor(np.c_[cxyz, crgb][:n], dtype=torch.float32,
                      device=dev)[None]
    launches = {}

    def forwards(label, directory, tree):
        arrays = {}
        for coll, sub in checkpoint.variables(tree).items():
            for path, leaf in flat_leaves(sub, (coll,)):
                arrays["/".join(path)] = leaf
        outs = []
        for key, w in ((label, directory), (label + "_arrays", arrays)):
            model = build_regnet(cfg, w, dev)
            torch.cuda.synchronize()
            _cuda.reset_launches()
            with torch.inference_mode():
                outs.append(model(pc, generator=torch.Generator()
                                  .manual_seed(3)))
            torch.cuda.synchronize()
            launches[key] = dict(_cuda.launches)
        check(all(a is None and b is None or torch.equal(a, b)
                  for a, b in zip(*outs)),
              f"phase (k): the forward from {directory} differs from the "
              f"forward from the same arrays")
        check(bool(torch.isfinite(outs[0].final_grasps).all()),
              f"phase (k): non-finite grasps from {directory}")
        check(sum(launches[label].values()) > 0,
              f"phase (k): the forward from {directory} launched none of "
              f"the port's kernels")

    forwards("orbax_forward", str(ORBAX_FIXTURE), tree)

    with tempfile.TemporaryDirectory() as tmp:
        models = Path(tmp) / "models"

        def train(tag, epochs):
            _cuda.reset_launches()
            t0 = time.perf_counter()
            res = train_cli.main([
                "--mode", "pretrain_score", "--tiny", "--synthetic-scenes",
                "6", "--data-path", str(Path(tmp) / "scenes"),
                "--model-path", str(models), "--log-path",
                str(Path(tmp) / "log"), "--tag", tag, "--batch-size", "4",
                "--epoch", str(epochs), "--resume", "--seed", "1"])
            torch.cuda.synchronize()
            check([s["epoch"] for s in res["steps"]] == [epochs - 1]
                  and all(np.isfinite(s["loss"]) for s in res["steps"]),
                  f"phase (k): the run resumed from {tag}'s steps "
                  f"{res['steps']}")
            check(sorted(os.listdir(models / tag))[-1] == f"ckpt_{epochs - 1}"
                  and (models / tag / f"ckpt_{epochs - 1}" / "_METADATA")
                  .exists(), f"phase (k): the train CLI wrote no "
                  f"ckpt_{epochs - 1}/ under {tag}")
            return res, time.perf_counter() - t0, dict(_cuda.launches)

        # the train CLI resumed from the fixture's tag directory, one step;
        # it writes ckpt_1/, which the port reads back as the state it
        # ended with
        shutil.copytree(ORBAX_FIXTURE / "ckpt_0", models / "orbax" / "ckpt_0")
        res, resume_s, launches["orbax_resume"] = train("orbax", 2)
        written, resume = checkpoint.restore_orbax(str(models / "orbax"))
        adam = written["opt_state"]["inner_states"]
        check(resume == 2 and same_leaves(written, checkpoint.train_state(
            res["model"], res["optimizer"])),
              "phase (k): ckpt_1/ differs from the model's and Adam's state")
        check(int(written["step"]) == 2 and all(
            int(adam[g]["inner_state"][i]["count"]) == 2
            for g in ("score", "region") for i in (0, 1)),
            "phase (k): ckpt_1/ does not carry Adam's counts on")
        # --resume from it and from a ckpt_1.pt of the same state: the same
        # next step, bit for bit
        checkpoint.save_pt_checkpoint(str(models / "pt"), 1, res["model"],
                                      res["optimizer"])
        again = {}
        for tag in ("orbax", "pt"):
            step, _, launches[f"{tag}_resume_again"] = train(tag, 3)
            again[tag] = (step["steps"][0]["loss"],
                          checkpoint.restore_orbax(str(models / tag))[0])
        check(again["orbax"][0] == again["pt"][0]
              and same_leaves(again["orbax"][1], again["pt"][1]),
              "phase (k): --resume from ckpt_1/ differs from --resume from "
              "ckpt_1.pt of the same state")
        forwards("written_forward", str(models / "orbax" / "ckpt_1"),
                 written)
        tiny_ms, tiny_bytes = orbax_write_ms(res["model"], res["optimizer"],
                                             1)
    check(launches["orbax_resume"]["bn_stats"] > 0,
          "phase (k): the resumed step launched no BatchNorm kernel")
    # the write at full width: the served weights alone, and with a fresh
    # Adam (zero moments) as a training run's first epoch writes them
    full = build_regnet(infer_config(), str(WEIGHTS), dev)
    r5_ms, r5_bytes = orbax_write_ms(full, None, 100)
    adam_ms, adam_bytes = orbax_write_ms(
        full, trainer.make_optimizer(full, infer_config(), 1), 100)
    del full
    writes = {"tiny": (tiny_ms, tiny_bytes), "r5": (r5_ms, r5_bytes),
              "r5_adam": (adam_ms, adam_bytes)}
    numbers = {"read_ms": read_ms, "leaves": len(got), "array_bytes": n_bytes,
               "decode_mb_s": decoded / decode_s / 1e6,
               "decoded_bytes": decoded,
               "frame_bytes": sum(len(f) for f in frames),
               "resume_step_s": resume_s, "card": smi,
               "write": {k: {"ms": ms, "bytes": b, "mb_s": b / ms / 1e3}
                         for k, (ms, b) in writes.items()}}
    print(f"phase (k): the Orbax fixture ({len(got)} leaves, {n_bytes} "
          f"bytes of arrays) read in {read_ms:.1f} ms; zstd decoder "
          f"{numbers['decode_mb_s']:.1f} MB/s over {len(frames)} frames "
          f"({decoded} bytes out), on the host CPU; forward bit-equal to the "
          f"arrays' ({sum(launches['orbax_forward'].values())} launches); "
          f"resumed train CLI {resume_s:.1f} s "
          f"({sum(launches['orbax_resume'].values())} launches); card {smi}")
    print("phase (k): the port's Orbax writer (host CPU of the card's "
          "machine, the state copied from the card; median of 3 writes "
          "into the page cache, not synced): " + "; ".join(
              f"{k} {w['bytes']} bytes of arrays in {w['ms']:.1f} ms, "
              f"{w['mb_s']:.1f} MB/s" for k, w in numbers["write"].items())
          + f"; ckpt_1/ read back equal to the model's and Adam's state, "
          f"--resume from it bit-equal to --resume from ckpt_1.pt, its "
          f"forward bit-equal to the arrays' "
          f"({sum(launches['written_forward'].values())} launches); "
          f"card {smi}")
    return launches, numbers


def eval_scene_grasps(dev) -> tuple:
    """Suite v2's clutter_00 and the 4,000 stage-2 grasps of one full-scan
    forward on it (f32, `weights/r4_coherent_e100.npz`, seed 7012)."""
    from regnet_for_3d_grasping_torch.config import infer_config
    from regnet_for_3d_grasping_torch.data import benchmark_suite as suite
    from regnet_for_3d_grasping_torch.models.regnet import build_regnet
    from regnet_for_3d_grasping_torch.utils.export import extract_grasp_sets
    spec = suite.suite_specs()[12]
    scene = suite.generate_scene(spec)
    model = build_regnet(infer_config(), str(SUITE_WEIGHTS), dev)
    pc = np.c_[scene["view_cloud"], scene["view_cloud_color"]].astype(
        np.float32)
    with torch.inference_mode():
        out = model(torch.from_numpy(pc)[None].to(dev),
                    generator=torch.Generator().manual_seed(7012))
    return spec, scene, extract_grasp_sets(out)[0]["grasp_stage2"]


NORMAL_ROWS = 10     # the CPU's normals: every 10th point of the cloud


def eval_fields(spec_index: int, grasps: np.ndarray, device: str) -> dict:
    """The evaluator's outputs on suite v2 scene `spec_index` for `grasps`
    [G, 8] on `device`: view masks (validate path), the funnel, the scene
    check and antipodal scores (committed normals), and both methods'
    normals of the scene cloud (on the CPU every `NORMAL_ROWS`-th point;
    the card's whole cloud), with the card's times."""
    if device == "cpu":
        torch.set_num_threads(CPU_THREADS)
    from regnet_for_3d_grasping_torch.config import EvalConfig, GripperConfig
    from regnet_for_3d_grasping_torch.data import benchmark_suite as suite
    from regnet_for_3d_grasping_torch.eval import collision, evaluator
    from regnet_for_3d_grasping_torch.eval.normals import estimate_normals
    spec = suite.suite_specs()[spec_index]
    scene = suite.generate_scene(spec)
    dev = torch.device(device)
    grip, cfg = GripperConfig(), EvalConfig()
    vp = torch.from_numpy(scene["view_cloud"].astype(np.float32)).to(dev)
    sp = torch.from_numpy(scene["scene_cloud"].astype(np.float32)).to(dev)
    sn = torch.from_numpy(scene["scene_normal"].astype(np.float32)).to(dev)
    g = torch.from_numpy(np.asarray(grasps, np.float32)).to(dev)
    cam = torch.from_numpy(evaluator.CAMERA_POSE[spec["view_index"]]).to(dev)
    rows = None if device != "cpu" else torch.arange(0, len(sp), NORMAL_ROWS)
    calls = {
        "view_ok": lambda: collision.check_grasps_view(
            vp, g, grip.table_height, grip.depth, grip, cfg, True, -1.0),
        "funnel": lambda: collision.view_check_funnel(
            vp, g, grip.table_height, grip.depth, grip, cfg),
        "scene": lambda: collision.check_grasps_scene(
            sp, sn, g, grip.depth, grip, cfg),
        "normals_moment": lambda: estimate_normals(
            sp, cam, cfg.normal_radius, cfg.normal_max_nn, method="moment",
            rows=rows),
        "normals_knn": lambda: estimate_normals(
            sp, cam, cfg.normal_radius, cfg.normal_max_nn, method="knn",
            rows=rows)}
    out, ms = {}, {}
    for name, fn in calls.items():
        if device == "cpu":
            r = fn()
        else:
            ms[name] = cuda_ms(fn, 3 if name.startswith("normals") else 5)
            r = fn()
        if isinstance(r, dict):
            out |= {f"funnel_{k}": v.cpu().numpy() for k, v in r.items()}
        elif isinstance(r, tuple):
            out["scene_ok"], out["antipodal"] = (v.cpu().numpy() for v in r)
        else:
            out[name] = r.cpu().numpy()
    out["ms"] = ms
    return out


def evaluator_card_vs_cpu(card: dict, cpu: dict) -> dict:
    """Phase (c): the card's evaluator against the CPU's on the same
    grasps: masks equal grasp for grasp, antipodal scores within 1e-5
    relative and 1e-6 absolute, both methods' normals |cos| >= 1 - 1e-5 on
    at least 99.9 % of the CPU's points."""
    res = {"grasps": int(len(card["view_ok"])), "ms": card["ms"]}
    for k in card:
        if k in ("ms", "antipodal") or k.startswith("normals"):
            continue
        check(np.array_equal(card[k], cpu[k]),
              f"evaluator: {k} differs between the card and the CPU "
              f"({int((card[k] != cpu[k]).sum())} grasps)")
        res[f"{k}_true"] = int(card[k].sum())
    err = np.abs(card["antipodal"].astype(np.float64) - cpu["antipodal"])
    check((err <= 1e-6 + 1e-5 * np.abs(cpu["antipodal"])).all(),
          f"evaluator: antipodal scores differ by up to {err.max():.3g}")
    res["antipodal_max_abs_err"] = float(err.max())
    for m in ("normals_moment", "normals_knn"):
        got = card[m][::NORMAL_ROWS]
        cos = np.abs((got * cpu[m]).sum(-1))
        share = float((cos >= 1 - 1e-5).mean())
        res[f"{m}_share"] = share
        res[f"{m}_bit_equal_share"] = float((got == cpu[m]).all(-1).mean())
        check(share >= 0.999, f"evaluator: {m} agree on {share:.5f} of the "
              f"points")
    print(json.dumps({"evaluator_card_vs_cpu": res}))
    return res


SUITE_WEIGHTS = ROOT / "weights" / "r4_coherent_e100.npz"
SUITE_VGR_LIMIT = 0.03   # phase (e): stage-3 VGR against the TPU's files


def suite_phase(out_dir: Path) -> dict:
    """Phase (e): suite v2 through `cli/benchmark_eval.py` with the weights
    of the TPU's suite files, at `--fast` and at f32 exact; all 24
    fingerprints verified (the CLI verifies each scene it makes); the
    metrics written to `out_dir`; per regime and stage vgr, antipodal and
    n_grasps printed beside the TPU's.  Fails where a stage-3 or
    stage-3-score VGR lies more than `SUITE_VGR_LIMIT` from the TPU's."""
    from regnet_for_3d_grasping_torch.cli import benchmark_eval
    out_dir.mkdir(parents=True, exist_ok=True)
    readings = {}
    for flags, tpu_file, ours in (
            (["--fast"], "metrics_r04.json", "metrics_torch_r04.json"),
            ([], "metrics_r04_exact.json", "metrics_torch_r04_exact.json")):
        t0 = time.perf_counter()
        res = benchmark_eval.main(["--checkpoint",
                                   os.path.relpath(SUITE_WEIGHTS),
                                   "--out", str(out_dir / ours), *flags])
        seconds = time.perf_counter() - t0
        check(len(res["per_scene"]) == 24, "the suite did not run 24 scenes")
        tpu = json.loads((ROOT / "docs" / "evidence" / tpu_file).read_text())
        label = "--fast" if flags else "f32 exact"
        for regime, stages in res["summary"].items():
            for stage, r in stages.items():
                t = tpu["summary"][regime][stage]
                print(f"suite v2 {label} {regime} {stage}: vgr {r['vgr']} "
                      f"(TPU {t['vgr']}), antipodal {r['antipodal']} (TPU "
                      f"{t['antipodal']}), n_grasps {r['n_grasps']} (TPU "
                      f"{t['n_grasps']})")
                if stage != "stage2":
                    check(abs(r["vgr"] - t["vgr"]) <= SUITE_VGR_LIMIT,
                          f"suite v2 {label} {regime} {stage}: VGR "
                          f"{r['vgr']} against the TPU's {t['vgr']}")
        print(f"suite v2 {label}: {seconds:.1f} s ({res['seconds']})")
        readings[label] = {"summary": res["summary"], "seconds": seconds,
                           "cli_seconds": res["seconds"]}
    return readings


# --- the library functions no entry point reaches (ROADMAP A8) ------------

# phase (j): each item's launches in one forward on the card
LIBRARY_LAUNCHES = {
    "msg_sa1": {"fps": 1, "ball_query": 2, "bn_apply": 4, "bn_apply_max": 2},
    "avg_sa1": {"fps": 1, "ball_query": 1, "bn_apply": 3},
    "edge_sa1": {"fps": 1, "ball_query": 1, "bn_apply": 2, "bn_apply_max": 1},
    "edge_sa1_exact": {"fps": 1, "ball_query": 0, "bn_apply": 2,
                       "bn_apply_max": 1},
    "edge_fp3": {"three_nn": 1, "bn_apply": 3},
    "two_scales_and_crop": {},
}
LIBRARY_REPS = 3
LIBRARY_RTOL = 1e-4    # f32 features: of the largest entry


def library_items(pc: np.ndarray, dev: torch.device) -> dict:
    """Phase (j)'s items at full width on `pc` [N, 6]: {name: a callable
    returning (index tensors, f32 feature tensors)}.  The layers are made
    on the CPU from a seed (the same weights on both sides), then moved."""
    from regnet_for_3d_grasping_torch.config import (GripperConfig,
                                                     infer_config)
    from regnet_for_3d_grasping_torch.geometry import region
    from regnet_for_3d_grasping_torch.models.backbone import (
        SetAbstractionAvg, SetAbstractionMSG)
    from regnet_for_3d_grasping_torch.models.edge import (
        EdgeFeaturePropagation, EdgeSetAbstraction)
    from regnet_for_3d_grasping_torch.ops.fps import farthest_point_sample
    from regnet_for_3d_grasping_torch.ops.grouping import gather_points
    cfg = infer_config()
    cloud = torch.from_numpy(pc[None]).to(dev)
    xyz, rgb = cloud[..., :3].contiguous(), cloud[..., 3:].contiguous()
    mlp = (128, 128, 256)

    def made(seed, mod):
        torch.manual_seed(seed)
        return mod().eval().to(dev)

    layers = {
        "msg_sa1": made(1, lambda: SetAbstractionMSG(
            3, 5120, (0.02, 0.04), (64, 64), (mlp, mlp))),
        "avg_sa1": made(2, lambda: SetAbstractionAvg(3, 5120, 0.02, 64,
                                                     mlp)),
        "edge_sa1": made(3, lambda: EdgeSetAbstraction(3, 5120, 0.02, 64,
                                                       mlp)),
        "edge_sa1_exact": made(3, lambda: EdgeSetAbstraction(
            3, 5120, 0.02, 64, mlp, ball_query_method="exact")),
    }
    fp = made(4, lambda: EdgeFeaturePropagation(2 * 512 + 3,
                                                (256, 256, 256)))
    g = torch.Generator().manual_seed(5)
    sparse_idx = farthest_point_sample(xyz, 5120)
    sparse = gather_points(xyz, sparse_idx)
    sparse_feat = torch.randn(1, 5120, 512, generator=g).to(dev)
    chunks = region.group_chunks(cfg.region.center_num)
    centers = gather_points(cloud, farthest_point_sample(
        xyz, cfg.region.center_num))
    axis = torch.nn.functional.normalize(
        torch.randn(1, cfg.region.center_num, 3, generator=g), dim=-1)
    theta = (torch.rand(1, cfg.region.center_num, 1, generator=g) * 2 - 1) \
        * np.pi
    grasp = torch.cat([centers[..., :3], axis.to(dev), theta.to(dev)], -1)

    def sa(name):
        def run():
            new_xyz, feat = layers[name](xyz, rgb)
            return [new_xyz], [feat]
        return run

    def edge_fp():
        return [], [fp(xyz, sparse, rgb, sparse_feat)]

    def two_scales():
        a, b = region.group_regions_two_scales(
            list(range(60, 60 + 2 * chunks)), cloud, centers,
            cfg.region.group_num, cfg.group_radius,
            cfg.region.group_num_more, cfg.group_radius_more)
        crop = region.closing_region_crop(
            70, cloud, b.index, grasp, GripperConfig(),
            cfg.region.gripper_num)
        return ([a.index, a.valid, b.index, b.valid, crop.index_in_all,
                 crop.valid], [crop.points])

    return {**{k: sa(k) for k in layers}, "edge_fp3": edge_fp,
            "two_scales_and_crop": two_scales}


def library_fields(pc: np.ndarray, device: str) -> dict:
    """Phase (j) on `device`: each item's outputs as numpy, and on the card
    its median forward ms over `LIBRARY_REPS` and its launches a forward,
    the counters reset just before and read just after."""
    if device == "cpu":
        torch.set_num_threads(CPU_THREADS)
    from regnet_for_3d_grasping_torch.ops import _cuda
    dev = torch.device(device)
    out = {}
    with torch.no_grad():
        for name, fn in library_items(pc, dev).items():
            ms, reps = [], LIBRARY_REPS if device == "cuda" else 1
            _cuda.reset_launches()
            for _ in range(reps):
                t0 = time.perf_counter()
                idx, feats = fn()
                if device == "cuda":
                    torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            launches = {k: v / reps for k, v in _cuda.launches.items() if v}
            out[name] = {"index": [t.cpu().numpy() for t in idx],
                         "features": [t.float().cpu().numpy()
                                      for t in feats],
                         "ms": statistics.median(ms), "launches": launches}
    return out


def library_card_vs_cpu(card: dict, cpu: dict) -> dict:
    """Phase (j)'s checks: indices equal, f32 features within
    `LIBRARY_RTOL` of the largest entry, each item's launches a forward
    `LIBRARY_LAUNCHES`.  Returns each item's ms, launches and distance."""
    found = {}
    for name, want in LIBRARY_LAUNCHES.items():
        c, h = card[name], cpu[name]
        check(all(np.array_equal(a, b) for a, b in zip(c["index"],
                                                        h["index"])),
              f"phase (j) {name}: the card's indices are not the CPU's")
        err = max((float(np.abs(a - b).max()) / float(np.abs(b).max())
                   for a, b in zip(c["features"], h["features"])),
                  default=0.0)
        check(err <= LIBRARY_RTOL and all(
            np.isfinite(a).all() for a in c["features"]),
              f"phase (j) {name}: features {err:.3e} of the largest apart")
        got = {k: c["launches"].get(k, 0) for k in
               set(want) | set(c["launches"])}
        check(got == {k: want.get(k, 0) for k in got},
              f"phase (j) {name}: launches a forward {got}, expected {want}")
        found[name] = {"ms": c["ms"], "cpu_s": h["ms"] / 1e3,
                       "launches": c["launches"], "rel_err": err}
        print(f"phase (j) {name}: median forward {c['ms']:.3f} ms on the "
              f"card (CPU {h['ms'] / 1e3:.1f} s), launches a forward "
              f"{c['launches']}, indices equal, features {err:.2e} of the "
              f"largest apart")
    return found


# --- data parallelism ------------------------------------------------------

# the outputs phase (h) holds bit for bit against the solo forward
DP_FIELDS = ("score", "proposals", "final_grasps", "center_index",
             "region_valid", "anchor_index", "crop_valid", "refine_accept",
             "score_accept")
DP_STEPS = 3            # phase (i) on W >= 2 cards: steps a run
# phase (i), W >= 2: the train CLI against its emulation on card 0.  At
# W = 2 the mean of two is order-free: bit-equal.  Over more cards NCCL
# sums in an order of its own, and Adam's first updates carry an ulp of a
# gradient near 0 to 2 lr in a parameter, so the runs are held at their
# first step: the CLI's first loss within DP_FIRST_RTOL, and the first
# step's averaged gradients and running statistics (`dp_first_step`),
# entry by entry, within DP_SUM_ULPS * (W - 1) roundings of the mean of
# the W shards' magnitudes: two sums of the same W terms in two orders
# are at most 2 (W - 1) such roundings apart, the division one more
DP_FIRST_RTOL, DP_SUM_ULPS = 1e-6, 4


def dp_serving_phase(wants: dict, solo_s: dict | None) -> tuple:
    """Phase (h): ``--dp`` through the infer CLI on phase 4's 3 clouds, full
    scan f32 and ``--fast``, over every visible card (W; where W does not
    divide 3 the last chunk is padded).  Each forward launches the path's
    kernels (the workers' counts, reset in effect just before each forward
    and read just after), and each cloud's scores, selections, stage-2 and
    stage-3 grasps and view-filtered sets are bit for bit those of the solo
    forward on card 0 with the seed folded by its place in its chunk.
    Returns the launch counts and the throughput by path."""
    from regnet_for_3d_grasping_torch.cli import infer
    from regnet_for_3d_grasping_torch.eval.evaluator import eval_test
    from regnet_for_3d_grasping_torch.models.regnet import build_regnet
    from regnet_for_3d_grasping_torch.parallel.mesh import (fold_seed,
                                                            visible_devices)
    from regnet_for_3d_grasping_torch.utils.export import extract_grasp_sets
    W = len(visible_devices("cuda"))
    paths, rates = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        folder = write_clouds(Path(tmp) / "dp_data")
        for key, solo_key, flags in (("dp_full_scan", "full_scan", []),
                                     ("dp_fast", "fast", ["--fast"])):
            argv = ["--folder-name", str(folder), "--checkpoint",
                    str(WEIGHTS), "--seed", "1", "--dp", *flags]
            t0 = time.perf_counter()
            records = infer.main(argv)
            cli_s = time.perf_counter() - t0
            check(len(records) == 3, f"{key}: {len(records)} clouds served")
            launches = {k: sum(r["launches"][k] for r in records)
                        for k in records[0]["launches"]}
            for k, n in wants[solo_key].items():
                check(launches[k] == 3 * n, f"{key}: {k} launched "
                      f"{launches[k]} times in 3 forwards, expected {3 * n}")
            cfg = infer.config_from_args(infer.build_parser().parse_args(argv))
            model = build_regnet(cfg, str(WEIGHTS), "cuda")
            g = cfg.gripper
            rng = np.random.RandomState(1)
            for j, r in enumerate(records):
                pc, back, _, _ = infer.load_cloud(r["path"], N_POINTS, rng)
                gen = torch.Generator().manual_seed(fold_seed(1, j % W))
                with torch.inference_mode():
                    out = model(torch.from_numpy(pc)[None].cuda(),
                                generator=gen)
                for f in DP_FIELDS:
                    check(torch.equal(getattr(out, f).cpu(),
                                      getattr(r["out"], f)),
                          f"{key}: cloud {j}'s {f} is not the solo forward's "
                          "with its folded seed")
                for name, raw in extract_grasp_sets(out)[0].items():
                    want = eval_test(back, raw, None, g.table_height, g.depth,
                                     g.width, g, cfg.eval, device="cuda")
                    check(np.array_equal(want, r["sets"][name]),
                          f"{key}: cloud {j}'s {name} set differs")
            del model
            chunks = [r["forward_s"] for r in records[::W]]
            fwd_ms = [r["device_forward_s"] * 1e3 for r in records]
            rates[key] = {"devices": W, "chunk_s": chunks,
                          "clouds_per_s": 3 / sum(chunks),
                          "worker_forward_ms": fwd_ms, "cli_s": cli_s}
            solo = ("" if solo_s is None else
                    f"; phase {4 if solo_key == 'full_scan' else 12}'s solo "
                    f"forward {1.0 / solo_s[solo_key]:.2f} clouds/s")
            print(f"phase (h) {key} over {W} card(s): chunk walls "
                  f"{[round(c, 4) for c in chunks]} s (forward, view filter "
                  f"and transfer), {rates[key]['clouds_per_s']:.2f} clouds/s; "
                  f"the workers' forwards {[round(x, 3) for x in fwd_ms]} ms"
                  f"{solo}; the CLI {cli_s:.1f} s with its workers' start")
            paths[key] = launches
    return paths, rates


def dp_step_one_card(data_dir: str) -> dict:
    """Phase (i) on one card: the library's data-parallel step at world 1,
    in an NCCL group of one, against the solo step with the folded seed:
    2 refine steps at batch 1 of phase 17's scenes, deterministic;
    parameters, running statistics, Adam's moments and losses bit-equal."""
    from regnet_for_3d_grasping_torch.cli.train import (build_model,
                                                        deterministic)
    from regnet_for_3d_grasping_torch.config import train_config
    from regnet_for_3d_grasping_torch.data import GraspDataset
    from regnet_for_3d_grasping_torch.parallel import launch
    from regnet_for_3d_grasping_torch.parallel.mesh import (fold_seed,
                                                            make_mesh)
    from regnet_for_3d_grasping_torch.train import trainer
    cfg = train_config(**{"train.batch_size": 1})
    ds = GraspDataset(data_dir, "train", N_POINTS, cfg.region.max_gt_grasps,
                      1)
    batches = list(ds.batches(1, seed=0))[:2]
    check(len(batches) == 2, "phase (i): fewer than 2 training scenes")
    dev = torch.device("cuda", 0)

    def run(mesh):
        model = build_model(cfg, 1, dev)
        opt = trainer.make_optimizer(model, cfg, 2)
        drop = torch.Generator(device=dev)
        losses = []
        if mesh is not None:
            mesh.events = []        # each step's averaging, CUDA events
        for nb, b in enumerate(batches):
            seed = fold_seed(nb, 0)
            drop.manual_seed(seed)
            m = trainer.train_step(
                model, opt, trainer.device_batch(b, dev), "refine", mesh,
                generator=torch.Generator().manual_seed(seed),
                dropout_generator=drop)
            losses.append(float(m["loss_total"]))
        return model, opt, losses, mesh and mesh.collective_ms()

    t0 = time.perf_counter()
    with deterministic():
        with launch.process_group(dev, 1, 0, launch.free_port()):
            dp = run(make_mesh())
        solo = run(None)
    check(len(dp[3]) == 2, f"phase (i): {len(dp[3])} timed averagings, "
          "expected 2")
    check(dp[2] == solo[2], f"phase (i): world-1 losses {dp[2]} differ from "
          f"the solo step's {solo[2]}")
    sa, sb = dp[0].state_dict(), solo[0].state_dict()
    check(all(torch.equal(sa[k], sb[k]) for k in sa),
          "phase (i): world-1 parameters or statistics differ")
    pa = dict(dp[0].named_parameters())
    for n, p in solo[0].named_parameters():
        for m in ("exp_avg", "exp_avg_sq"):
            check(torch.equal(dp[1].adam.state[pa[n]][m],
                              solo[1].adam.state[p][m]),
                  f"phase (i): world-1 Adam {m} of {n} differs")
    print(f"phase (i), one card: the data-parallel step at world 1 (NCCL) "
          f"bit-equal to the solo step with the folded seed over 2 steps "
          f"(losses {dp[2]}; averaging {[round(x, 3) for x in dp[3]]} ms a "
          f"step), {time.perf_counter() - t0:.1f} s")
    return {"world1_losses": dp[2], "averaging_ms": dp[3]}


def sharded_eval_check(data_dir: str) -> dict:
    """The sharded evaluation over every visible card against
    `evaluate_scene_grasps` on card 0, scene by scene, on W + 1 scenes
    (a padded last shard) and grasps at their GT frames: counts equal,
    antipodal sums within 1e-6."""
    from regnet_for_3d_grasping_torch.config import GripperConfig
    from regnet_for_3d_grasping_torch.data import GraspDataset, load_scene
    from regnet_for_3d_grasping_torch.eval.evaluator import (
        evaluate_scene_grasps)
    from regnet_for_3d_grasping_torch.eval.parallel_eval import (
        evaluate_scenes_sharded)
    from regnet_for_3d_grasping_torch.parallel.mesh import visible_devices
    devices = visible_devices("cuda")
    g = GripperConfig()
    ds = GraspDataset(data_dir, "train", N_POINTS, 1, 1)
    scenes = [load_scene(p) for p in ds.paths[:len(devices) + 1]]
    grasps, depths = [], []
    for s in scenes:
        f = np.asarray(s["select_frame"], np.float32)[:256]
        gr = np.zeros((len(f), 8), np.float32)
        gr[:, :3], gr[:, 3:6], gr[:, 7] = f[:, :, 3], f[:, :, 1], 0.5
        grasps.append(gr)
        depths.append(np.full(len(gr), g.depth, np.float32))
    views = [i % 4 for i in range(len(scenes))]
    t0 = time.perf_counter()
    got = evaluate_scenes_sharded(devices, scenes, grasps, views,
                                  g.table_height, depths, g.width, g)
    t1 = time.perf_counter()
    want = [evaluate_scene_grasps(s, gr, v, g.table_height, d, g.width, g,
                                  device="cuda")
            for s, gr, v, d in zip(scenes, grasps, views, depths)]
    t2 = time.perf_counter()
    for a, b in zip(got, want):
        check((a.vgr_count, a.nocoll_view, a.formal)
              == (b.vgr_count, b.nocoll_view, b.formal)
              and abs(a.score_sum - b.score_sum)
              <= 1e-6 * max(abs(b.score_sum), 1.0),
              f"sharded evaluation {a} differs from one card's {b}")
    print(f"sharded evaluation over {len(devices)} card(s), {len(scenes)} "
          f"scenes: records equal one card's ({[tuple(r) for r in got]}); "
          f"{t1 - t0:.3f} s sharded, {t2 - t1:.3f} s scene by scene")
    return {"devices": len(devices), "sharded_s": t1 - t0,
            "one_card_s": t2 - t1}


def flat_buffers(model) -> torch.Tensor:
    return torch.cat([b.detach().reshape(-1) for b in model.buffers()])


def dp_emulation(data: Path, argv: list, W: int) -> tuple:
    """The train CLI's `DP_STEPS` data-parallel steps over W shards on
    card 0, one after another (`trainer.train_step_emulated`), with the
    CLI's batches and folded seeds -> (losses, state_dict, first): `first`
    holds the first step's averaged flat gradient and running statistics
    and, for each, the mean over the shards of its entries' magnitudes."""
    from regnet_for_3d_grasping_torch.cli import train as train_cli
    from regnet_for_3d_grasping_torch.data import GraspDataset
    from regnet_for_3d_grasping_torch.parallel.mesh import (fold_seed,
                                                            shard_batch)
    from regnet_for_3d_grasping_torch.train import trainer
    dev = torch.device("cuda", 0)
    cfg, _ = train_cli._configs(train_cli.build_parser().parse_args(argv))
    ds = GraspDataset(str(data), "train", N_POINTS, cfg.region.max_gt_grasps,
                      1)
    terms = {"grad": [], "stats": []}
    flat_grads = trainer._flat_grads

    def spy(model):
        # after each shard's backward: its gradient and running statistics
        params, flat = flat_grads(model)
        terms["grad"].append(flat.abs())
        terms["stats"].append(flat_buffers(model).abs())
        return params, flat

    losses, first = [], {}
    with train_cli.deterministic():
        model = train_cli.build_model(cfg, 1, dev)
        opt = trainer.make_optimizer(model, cfg, len(ds) // TRAIN_B)
        for nb, batch in enumerate(ds.batches(TRAIN_B, seed=0)):
            shards, kws = [], []
            for i in range(W):
                seed = fold_seed(nb, i)
                drop = torch.Generator(device=dev)
                drop.manual_seed(seed)
                shards.append(trainer.device_batch(shard_batch(batch, W, i),
                                                   dev))
                kws.append({"generator": torch.Generator().manual_seed(seed),
                            "dropout_generator": drop})
            with replaced(trainer, "_flat_grads",
                          spy if nb == 0 else flat_grads):
                losses.append(float(trainer.train_step_emulated(
                    model, opt, shards, kws)["loss_total"]))
            if nb == 0:
                first = {"grad": flat_grads(model)[1].cpu(),
                         "stats": flat_buffers(model).cpu()}
                for kind, xs in terms.items():
                    first[f"{kind}_scale"] = (sum(xs) / W).cpu()
                terms = None
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    return losses, state, first


def dp_first_step(rank: int, device: torch.device, data: str,
                  argv: list) -> dict:
    """Rank `rank` of the train CLI's first data-parallel step, through
    `trainer.train_step` over a mesh of every rank: the CLI's first batch,
    this rank's shard and folded seed, deterministic -> the averaged flat
    gradient and running statistics and the loss, on the host."""
    from regnet_for_3d_grasping_torch.cli import train as train_cli
    from regnet_for_3d_grasping_torch.data import GraspDataset
    from regnet_for_3d_grasping_torch.parallel.mesh import (fold_seed,
                                                            make_mesh,
                                                            shard_batch)
    from regnet_for_3d_grasping_torch.train import trainer
    cfg, _ = train_cli._configs(train_cli.build_parser().parse_args(argv))
    ds = GraspDataset(data, "train", N_POINTS, cfg.region.max_gt_grasps, 1)
    mesh = make_mesh()
    batch = shard_batch(next(iter(ds.batches(TRAIN_B, seed=0))), mesh.size,
                        mesh.shard_index)
    seed = fold_seed(0, mesh.shard_index)
    drop = torch.Generator(device=device)
    drop.manual_seed(seed)
    with train_cli.deterministic():
        model = train_cli.build_model(cfg, 1, device)
        opt = trainer.make_optimizer(model, cfg, len(ds) // TRAIN_B)
        m = trainer.train_step(
            model, opt, trainer.device_batch(batch, device), "refine", mesh,
            generator=torch.Generator().manual_seed(seed),
            dropout_generator=drop)
    return {"grad": trainer._flat_grads(model)[1].cpu(),
            "stats": flat_buffers(model).cpu(),
            "loss": float(m["loss_total"])}


def dp_first_step_check(data: Path, argv: list, devices: list,
                        first: dict, le0: float, label: str) -> dict:
    """Phase (i) over W > 2 cards: `dp_first_step` on every card against
    the emulation's first step (`first`, `le0` its loss): every rank's
    averages equal, each entry within `DP_SUM_ULPS` (W - 1) roundings of
    its shards' mean magnitude, the loss within `DP_FIRST_RTOL`.  Returns
    how far apart they are, and the largest share of its limit an entry
    used."""
    from regnet_for_3d_grasping_torch.parallel import launch
    W = len(devices)
    ranks = launch.run_ranks(dp_first_step, devices, str(data), argv)
    for r, got in enumerate(ranks):
        check(torch.equal(got["grad"], ranks[0]["grad"])
              and torch.equal(got["stats"], ranks[0]["stats"]),
              f"{label}: rank {r}'s averages differ from rank 0's")
        check(abs(got["loss"] - le0) <= DP_FIRST_RTOL * abs(le0),
              f"{label}: rank {r}'s first loss {got['loss']} is not the "
              f"emulation's {le0}")
    apart = {}
    for kind in ("grad", "stats"):
        got, want = ranks[0][kind].double(), first[kind].double()
        check(got.shape == want.shape,
              f"{label}: {kind} of {tuple(got.shape)}, not "
              f"{tuple(want.shape)}")
        limit = (DP_SUM_ULPS * (W - 1) * torch.finfo(first[kind].dtype).eps
                 / 2 * first[f"{kind}_scale"].double())
        diff = (got - want).abs()
        check(bool((diff <= limit).all()),
              f"{label}: the first step's averaged {kind} is "
              f"{float(diff.max()):.3e} from the emulation's, past "
              f"{DP_SUM_ULPS} (W - 1) roundings of its shards' magnitudes")
        apart[kind] = {"max_abs": float(diff.max()),
                       "max_value": float(want.abs().max()),
                       "entries_apart": int((diff > 0).sum()),
                       "entries": diff.numel(),
                       "limit_share": float((diff / limit.clamp_min(1e-300))
                                            .max())}
    print(f"phase (i) {label} over {W} cards: the first step's averages "
          f"against the emulation's: {apart}")
    return apart


def dp_training_phase(tmp) -> dict:
    """Phase (i) on W >= 2 cards: the train CLI, data-parallel over every
    card, `DP_STEPS` steps at batch 12 on the full scan in f32 and the bf16
    slab, twice each (bit-equal), against its emulation on card 0
    (`dp_emulation`): bit-equal at W = 2 (also run where there are more
    cards); over more, the first loss within `DP_FIRST_RTOL` and the first
    step's averages as `dp_first_step_check` holds them; step times and
    each card's peak memory."""
    from regnet_for_3d_grasping_torch.cli import train as train_cli
    from regnet_for_3d_grasping_torch.data import write_synthetic_dataset
    from regnet_for_3d_grasping_torch.parallel.mesh import visible_devices
    devices = visible_devices("cuda")
    W = len(devices)
    data = Path(tmp) / "dp_scenes"
    # 80 % of 45 scenes train: 36, 3 steps at batch 12
    write_synthetic_dataset(str(data), 45, num_view=N_POINTS)
    slab = ["--slab-cell", str(SLAB_CELL), "--fps-groups", str(FPS_GROUPS)]
    out = {}
    for label, flags in (("full scan f32", []), ("slab bf16", ["--bf16",
                                                               *slab])):
        argv = ["--mode", "train", "--data-path", str(data), "--model-path",
                str(Path(tmp) / "dp_models"), "--log-path",
                str(Path(tmp) / "dp_log"), "--batch-size", str(TRAIN_B),
                "--epoch", "1", "--seed", "1", *flags]
        a, b = (train_cli.main(argv + ["--tag", t]) for t in ("a", "b"))
        check(len(a["ranks"]) == W and len(a["steps"]) == DP_STEPS,
              f"{label}: {len(a.get('ranks', []))} ranks, "
              f"{len(a['steps'])} steps")
        la = [s["loss"] for s in a["steps"]]
        sa, sb = a["model"].state_dict(), b["model"].state_dict()
        check(la == [s["loss"] for s in b["steps"]]
              and all(torch.equal(sa[k], sb[k]) for k in sa),
              f"{label}: two data-parallel runs differ")
        le, se, emulated_first = dp_emulation(data, argv, W)
        diff = max(float((sa[k] - se[k]).abs().max()) for k in sa)
        first = abs(la[0] - le[0]) / abs(le[0])
        print(f"phase (i) {label} over {W} cards: two runs bit-equal; "
              f"losses {la}, emulated {le}; first step relative difference "
              f"{first:.3e}, parameters' largest difference after "
              f"{DP_STEPS} steps {diff:.3e}")
        found = {}
        if W == 2:
            check(la == le and diff == 0.0,
                  f"{label}: 2 cards differ from their emulation")
        else:
            check(first <= DP_FIRST_RTOL,
                  f"{label}: {W} cards' first loss is not the emulation's")
            found["first_step"] = dp_first_step_check(
                data, argv, devices, emulated_first, le[0], label)
            two = train_cli.main(argv + ["--tag", "two"],
                                 devices=devices[:2])
            l2, s2, _ = dp_emulation(data, argv, 2)
            st = two["model"].state_dict()
            check([s["loss"] for s in two["steps"]] == l2
                  and all(torch.equal(st[k], s2[k]) for k in st),
                  f"{label}: 2 of the cards differ from their emulation")
            print(f"phase (i) {label} over 2 of the cards: bit-equal to the "
                  f"emulation (losses {l2})")
        ms = [[round(x * 1e3, 3) for x in r["seconds"]] for r in a["ranks"]]
        peaks = [round(r["peak_bytes"] / 2**30, 3) for r in a["ranks"]]
        avg = [[round(x, 3) for x in r["collective_ms"]] for r in a["ranks"]]
        print(f"phase (i) {label}: step ms by card {ms}; peak GiB by card "
              f"{peaks}; averaging ms a step by card {avg}")
        out[label] = {"step_ms": ms, "peak_gib": peaks, "first_rel": first,
                      "param_max": diff, **found}
    return out


def dp_phases(wants: dict, solo_s: dict | None) -> tuple:
    """Phases (h) and (i): the launch counts of the data-parallel serving
    paths, and what they measured."""
    from regnet_for_3d_grasping_torch.data import write_synthetic_dataset
    t0 = time.perf_counter()
    paths, serving = dp_serving_phase(wants, solo_s)
    print(f"phase (h): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # 8 scenes: 6 train (2 steps at batch 1, and W + 1 scenes for
        # the sharded evaluation up to W = 5)
        write_synthetic_dataset(tmp, 8, num_view=N_POINTS)
        found = {"serving": serving, "one_card": dp_step_one_card(tmp),
                 "sharded_eval": sharded_eval_check(tmp)}
    if torch.cuda.device_count() >= 2:
        with tempfile.TemporaryDirectory() as tmp:
            found["training"] = dp_training_phase(tmp)
    print(f"phase (i): {time.perf_counter() - t0:.1f} s")
    return paths, found


# --- K13: BatchNorm + ReLU (ops/batch_norm, csrc/batch_norm.cu) -------------

# BatchNorm modules a forward runs (`infer_config()` and `train_config()`
# alike): SA1-3 3 x 3, FP1-3 2 + 2 + 3, the seg MLP 4, score_bn, the GRN
# head 7, the refine head 5; 16 of them inside the SA and FP layers, which
# `--remat` recomputes in the backward
BN_LAYERS, BN_REMAT = 33, 16
# the last BatchNorm of SA1-3, whose ReLU's max over neighbours runs in
# K13e (in place of K13b and amax) and whose backward starts with K13f
BN_SA_MAX = 3
# K13's launches in a forward in eval mode (serving, validation) and in a
# training step: each BatchNorm once
BN_EVAL = {"bn_stats": 0, "bn_apply": BN_LAYERS - BN_SA_MAX,
           "bn_apply_max": BN_SA_MAX, "bn_backward_reduce": 0,
           "bn_backward_apply": 0, "bn_max_backward": 0}
BN_STEP = BN_EVAL | {"bn_stats": BN_LAYERS, "bn_backward_reduce": BN_LAYERS,
                     "bn_backward_apply": BN_LAYERS,
                     "bn_max_backward": BN_SA_MAX}
# `--remat` recomputes the SA and FP layers' BatchNorms, SA1-3's last
# through K13e
BN_REMAT_EXTRA = {"bn_stats": BN_REMAT, "bn_apply": BN_REMAT - BN_SA_MAX,
                  "bn_apply_max": BN_SA_MAX}
JAX_BN = "regnet_for_3d_grasping_tpu/nn/layers.py"
BN_REPLACES = {
    "bn_stats": JAX_BN + ":39-42 (flax nn.BatchNorm's batch statistics and "
                "running update, fused by XLA)",
    "bn_apply": JAX_BN + ":39-45 (flax nn.BatchNorm's normalisation and "
                "nn.relu, fused by XLA)",
    "bn_backward_reduce": JAX_BN + ":39-45 (the VJP of flax nn.BatchNorm + "
                          "nn.relu: its reductions)",
    "bn_backward_apply": JAX_BN + ":39-45 (the VJP of flax nn.BatchNorm + "
                         "nn.relu: dx)",
}
# (label, rows, channels, modes, relu, the modes timed): the paths' shapes
# (SA1's at serving and at batch 12, a head's stem, score_bn), timed, and
# the heads' odd channel counts
BN_CASES = (
    ("training SA1 layer 2: 3,932,160 x 256", 3932160, 256, ("train",),
     True, ("train",)),
    ("serving SA1 layer 2: 327,680 x 256", 327680, 256, ("eval", "train"),
     True, ("eval",)),
    ("training SA1 layer 0: 3,932,160 x 128", 3932160, 128,
     ("train", "frozen"), True, ("train",)),
    ("head stem: 4,000 x 1,024", 4000, 1024, ("eval", "train"), True,
     ("eval", "train")),
    ("score_bn, serving: 25,600 x 1", 25600, 1, ("eval",), False,
     ("eval",)),
    ("score_bn, training: 307,200 x 1", 307200, 1, ("train",), False,
     ("train",)),
    ("GRN cls3: 4,000 x 4", 4000, 4, ("eval", "train"), False, ()),
    ("refine cls2: 4,000 x 2", 4000, 2, ("train", "frozen"), False, ()),
    ("refine reg2: 4,000 x 10", 4000, 10, ("eval", "train"), False, ()),
    ("GRN reg3: 4,000 x 40", 4000, 40, ("train",), False, ()),
    ("training head reg1: 768 x 256", 768, 256, ("train", "frozen"), True,
     ()),
)
# K13's tolerances.  K13a against the f64 statistics rounded once: 2 f32
# ulps (the f64 sums' order); against torch's f32 statistics (summed in
# f32): the mean within 1e-5 and the variance within 1e-4 of E[x^2].
# K13c against f64 sums of the plain g' and g' * (x - mean): 2 ulps and
# 1e-12 of the sum of the terms' magnitudes; against torch's f32 sums
# 1e-4 of it.  K13d (through K13c's coefficients) against the plain
# backward: f32 1e-4 of the largest |dx|, bf16 2^-7 (one bf16 rounding
# flipped by the coefficients' last bits).  K13b and K13d given the same
# statistics and coefficients: bit for bit.
BN_ULPS = 2.0 ** -22
BN_DX_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def bn_inputs(m: int, c: int, dtype, seed: int, dev) -> tuple:
    """x and g [m, c] (each channel its own offset and scale, channel 0
    constant where C > 1: its clamp holds the variance at 0), and the
    parameters and running buffers, f32."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=gen, device=dev)
    off = torch.randn(c, **kw) * 2
    scale = torch.rand(c, **kw) * 3 + 0.1
    x = torch.randn(m, c, **kw) * scale + off
    if c > 1:
        x[:, 0] = 0.75
    g = torch.randn(m, c, **kw)
    params = [torch.rand(c, **kw) + 0.5, torch.randn(c, **kw) * 0.3,
              off + torch.randn(c, **kw) * 0.1,
              scale * scale * (torch.rand(c, **kw) + 0.5)]
    return (x.to(dtype), g.to(dtype), *params)


def ulps_apart(got, ref, slack=None) -> bool:
    """`got` within 2 f32 ulps of `ref` (and `slack` where given)."""
    tol = ref.abs() * BN_ULPS + (0.0 if slack is None else slack)
    return bool(((got.double() - ref.double()).abs() <= tol).all())


def bn_case(m, c, dtype, mode, relu, dev, timed=False) -> dict:
    """K13a-d at one shape, dtype and mode against their plain versions
    (`ops/batch_norm`'s, on the card), each run twice and its bits
    compared; `timed`: each kernel's, its plain version's and the library
    call's times.  Returns the errors (and times) by kernel."""
    from regnet_for_3d_grasping_torch.ops import batch_norm as B
    x, g, w, b, rm, rv = bn_inputs(m, c, dtype, m + c, dev)
    eps, train = 1e-5, mode == "train"
    label = f"[{m} x {c}] {str(dtype)[6:]} {mode}{' relu' if relu else ''}"
    out = {}
    if train:
        st = B.stats(x)
        check(bit_equal(B.stats(x), st), f"K13a not repeatable ({label})")
        xd = x.double()
        mean64 = xd.mean(0)
        ref64 = torch.stack([mean64, (xd * xd).mean(0) - mean64 * mean64])
        check(ulps_apart(st, ref64.float(),
                         (xd * xd).mean(0) * 2.0 ** -52 * 4),
              f"K13a is not the f64 statistics ({label}): "
              f"{max_err(st, ref64.float())}")
        plain = B.stats_plain(x)
        msq = (xd * xd).mean(0)
        check(bool(((st[0] - plain[0]).abs() <= 1e-5 * msq.sqrt()).all()
                   and ((st[1] - plain[1]).abs() <= 1e-4 * msq).all()),
              f"K13a differs from the f32 statistics ({label})")
        # the running update in place, against torch's on the same batch
        rm1, rv1 = rm.clone(), rv.clone()
        B.stats(x, rm1, rv1, 0.1)
        rm2 = rm.clone().mul_(0.9).add_(st[0], alpha=1.0 - 0.9)
        rv2 = rv.clone().mul_(0.9).add_(st[1].clamp(min=0.0),
                                        alpha=1.0 - 0.9)
        check(ulps_apart(rm1, rm2, 1e-30) and ulps_apart(rv1, rv2, 1e-30),
              f"K13a's running update differs ({label})")
        out["bn_stats"] = {"max_abs_err": max_err(st, ref64.float()),
                           "vs_f32_plain": max_err(st, plain)}
        mean, var = st[0], st[1]
    else:
        mean, var = rm, rv
    args = (mean, var, w, b, eps, train, relu)
    y = B.apply(x, *args)
    check(bit_equal(y, B.apply_plain(x, *args)) and bit_equal(
        B.apply(x, *args), y), f"K13b is not the plain version bit for bit "
        f"({label})")
    out["bn_apply"] = {"max_abs_err": 0.0}
    coef = B.backward_reduce(g, x, *args)
    check(bit_equal(B.backward_reduce(g, x, *args), coef),
          f"K13c not repeatable ({label})")
    gz = B.passed(g, x, *args).float()
    xm = (x.float() - mean) * gz
    s64 = (gz.double().sum(0), xm.double().sum(0))
    mag = (gz.double().abs().sum(0), xm.double().abs().sum(0))
    r = torch.rsqrt((var.clamp(min=0.0) if train else var) + eps)
    check(ulps_apart(coef[1], s64[0].float(), 1e-12 * mag[0])
          and ulps_apart(coef[0], s64[1].float() * r,
                         1e-12 * mag[1] * r.double()),
          f"K13c is not the f64 sums ({label})")
    plain = B.backward_reduce_plain(g, x, *args)
    check(bool(((coef[1] - plain[1]).abs() <= 1e-4 * mag[0]).all()
               and ((coef[0] - plain[0]).abs() <= 1e-4 * mag[1] * r).all()),
          f"K13c differs from the f32 sums ({label})")
    out["bn_backward_reduce"] = {
        "max_abs_err": max_err(coef[:2], torch.stack([s64[1].float() * r,
                                                      s64[0].float()])),
        "vs_f32_plain": max_err(coef, plain)}
    dx = B.backward_apply(g, x, *args[:4], coef, *args[4:])
    check(bit_equal(B.backward_apply(g, x, *args[:4], coef, *args[4:]), dx)
          and bit_equal(dx, B.backward_apply_plain(g, x, *args[:4], coef,
                                                   *args[4:])),
          f"K13d is not the plain version bit for bit on K13c's "
          f"coefficients ({label})")
    ref = B.backward_apply_plain(g, x, *args[:4], plain, *args[4:])
    err = max_err(dx, ref)
    check(err <= BN_DX_TOL[dtype] * float(ref.abs().max()),
          f"K13d differs from the plain backward ({label}): {err}")
    out["bn_backward_apply"] = {"max_abs_err": err,
                                "rel_err": err / float(ref.abs().max())}
    print(f"K13 {label}: stats/coefficients/dx "
          + ", ".join(f"{k} {v}" for k, v in out.items()))
    if timed:
        bn_times(out, x, g, w, b, rm, rv, mean, var, coef, eps, train, relu,
                 label)
    return out


def bn_times(out, x, g, w, b, rm, rv, mean, var, coef, eps, train, relu,
             label) -> None:
    """Each kernel's time (host launch included, and with the host ahead),
    its plain version's, its bytes (each input read once, each output
    written once) and operations, and the library's: one
    ``torch.nn.functional.batch_norm`` (+ ``relu``), training or eval,
    forward (K13a: its training call; K13b: its eval call) and backward
    (K13c and K13d: the training call's whole backward)."""
    from regnet_for_3d_grasping_torch.ops import batch_norm as B
    F = torch.nn.functional
    args = (mean, var, w, b, eps, train, relu)
    m, c = x.shape
    vals, elt = m * c, x.element_size()
    rm1, rv1 = rm.clone(), rv.clone()

    def lib_fwd(training):
        y = F.batch_norm(x, rm1, rv1, w, b, training, 0.1, eps)
        return F.relu(y) if relu else y

    xg = x.detach().clone().requires_grad_()

    def lib_graph():
        y = F.batch_norm(xg, rm1.clone(), rv1.clone(), w, b, True, 0.1, eps)
        return F.relu(y) if relu else y

    graph = []

    def lib_bwd():
        if not graph:
            graph.append(lib_graph())
        return torch.autograd.grad(graph[0], xg, g, retain_graph=True)

    calls = {
        "bn_apply": (lambda: B.apply(x, *args),
                     lambda: B.apply_plain(x, *args),
                     2 * vals * elt + 3 * c * 4, 4 * vals,
                     lambda: lib_fwd(train)),
        "bn_backward_reduce": (
            lambda: B.backward_reduce(g, x, *args),
            lambda: B.backward_reduce_plain(g, x, *args),
            2 * vals * elt + 8 * c * 4, 8 * vals, lib_bwd),
        "bn_backward_apply": (
            lambda: B.backward_apply(g, x, *args[:4], coef, *args[4:]),
            lambda: B.backward_apply_plain(g, x, *args[:4], coef, *args[4:]),
            3 * vals * elt + 6 * c * 4, (9 if train else 5) * vals,
            lib_bwd)}
    if train:
        calls["bn_stats"] = (lambda: B.stats(x, rm1, rv1, 0.1),
                             lambda: B.stats_plain(x),
                             vals * elt + 6 * c * 4, 3 * vals,
                             lambda: lib_fwd(True))
    for name, (kernel, plain, bytes_, ops, lib) in calls.items():
        try:
            lib_row = {"library_ms": cuda_ms(lib, 10),
                       "library_device_ms": device_ms(lib, 10)}
        except (RuntimeError, NotImplementedError) as e:
            lib_row = {"library_ms": None, "library_none":
                       f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"}
        out[name] |= {"ms": cuda_ms(kernel, 10),
                      "device_ms": device_ms(kernel, 10),
                      "plain_ms": cuda_ms(plain, 3), "bytes": bytes_,
                      "ops": ops} | lib_row
        b_ms = bound(bytes_, ops)[0]
        print(f"  {name} {label}: device {out[name]['device_ms']:.4f} ms "
              f"(bound {b_ms:.4f}, share {b_ms / out[name]['device_ms']:.3f}"
              f"), call {out[name]['ms']:.4f}, plain "
              f"{out[name]['plain_ms']:.4f}, library "
              f"{lib_row.get('library_device_ms')}")


def bn_module_check(m, c, dtype, relu, dev, frozen=False) -> None:
    """The module on the card (`nn/layers.BatchNorm`, K13) against its
    written-out chain on the card with autograd, train mode: y and dx
    (but where the two ReLUs differ, at most 1e-5 of the entries) within
    `BN_DX_TOL` of the largest entry, dweight and dbias within 1e-4 of
    their terms' magnitudes (K13a's statistics are the f64 sums', the
    chain's torch's f32 ones), the running buffers within a tenth of
    K13a's tolerance against torch's statistics, and one launch of each
    kernel.  `frozen` (`nn/freezer.frozen_bn`): on the running statistics,
    left unchanged, and no K13a."""
    from regnet_for_3d_grasping_torch.nn import layers
    from regnet_for_3d_grasping_torch.ops import _cuda
    x, g, w, b, rm, rv = bn_inputs(m, c, dtype, 7 * m + c, dev)
    mods = []
    for _ in range(2):
        bn = layers.BatchNorm(c).to(dev).train()
        bn.frozen = frozen
        with torch.no_grad():
            for t, v in zip((bn.weight, bn.bias, bn.running_mean,
                             bn.running_var), (w, b, rm, rv)):
                t.copy_(v)
        mods.append(bn)
    xs = [x.clone().requires_grad_() for _ in mods]
    _cuda.reset_launches()
    y = mods[0](xs[0], relu)
    y.backward(g)
    torch.cuda.synchronize()
    got = {k: _cuda.launches[k] for k in BN_REPLACES}
    want = dict.fromkeys(BN_REPLACES, 1) | {"bn_stats": int(not frozen)}
    check(got == want, f"the module's launches {got}, expected {want}")
    y_ref = mods[1].written_out(xs[1], relu)
    y_ref.backward(g)
    label = (f"module [{m} x {c}] {str(dtype)[6:]}{' relu' if relu else ''}"
             f"{' frozen' if frozen else ''}")
    # dweight and dbias against the magnitude of their terms (a sum of
    # millions in f32 on the chain's side)
    xf, gf = x.float(), g.float().abs()
    mean, var = xf.mean(0), xf.var(0, unbiased=False)
    mag_w = (gf * (xf - mean).abs()).sum(0) * torch.rsqrt(var + 1e-5)
    # where the pre-activation lies within the statistics' rounding of 0
    # the two sides' ReLUs may differ: dx is compared elsewhere
    flips = ((y > 0) != (y_ref > 0) if relu
             else torch.zeros_like(y, dtype=torch.bool))
    share = float(flips.float().mean())
    print(f"K13 {label}: {int(flips.sum())} ReLU flips (share {share:.2e})")
    check(share <= 1e-5, f"K13 {label}: ReLU flips {share:.2e}")
    dx = torch.where(flips, xs[1].grad, xs[0].grad)
    for what, a, r, scale in (
            ("y", y, y_ref, None), ("dx", dx, xs[1].grad, None),
            ("dweight", mods[0].weight.grad, mods[1].weight.grad, mag_w),
            ("dbias", mods[0].bias.grad, mods[1].bias.grad, gf.sum(0))):
        a, r = a.detach().double(), r.detach().double()
        if scale is None:
            err = float((a - r).abs().max() / r.abs().max().clamp(min=1e-30))
            tol = BN_DX_TOL[dtype]
        else:
            err = float(((a - r).abs()
                         / scale.double().clamp(min=1e-30)).max())
            tol = 1e-4
        print(f"K13 {label}: {what} within {err:.3e} of the written-out "
              f"chain's ({'largest entry' if scale is None else 'terms'})")
        check(err <= tol, f"K13 {label}: {what} {err:.3e} from the "
              f"written-out chain")
    if frozen:
        check(torch.equal(mods[0].running_mean, rm)
              and torch.equal(mods[0].running_var, rv),
              f"K13 {label}: the running statistics moved")
        return
    msq = (xf * xf).mean(0)
    check(bool(((mods[0].running_mean - mods[1].running_mean).abs()
                <= 1e-6 * msq.sqrt() + 1e-30).all()
               and ((mods[0].running_var - mods[1].running_var).abs()
                    <= 1e-5 * msq + 1e-30).all()),
          f"K13 {label}: running statistics differ")


def batch_norm_kernels(dev, record) -> None:
    """Phase 3 for K13a-d: every case of `BN_CASES` in f32 and bf16
    against the plain versions (`bn_case`), the module against its
    written-out chain (`bn_module_check`), and one record a kernel with
    the main shape first."""
    rows = {k: [] for k in BN_REPLACES}
    for label, m, c, modes, relu, timed_modes in BN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for mode in modes:
                timed = mode in timed_modes
                res = bn_case(m, c, dtype, mode, relu, dev, timed)
                if not timed:
                    continue
                for k, r in res.items():
                    if "ms" in r:
                        rows[k].append({"shape": f"{label}, "
                                        f"{str(dtype)[6:]} {mode}", **r})
    for m, c, dtype, relu in ((3932160, 128, torch.float32, True),
                              (3932160, 128, torch.bfloat16, True),
                              (4000, 1024, torch.float32, True),
                              (307200, 1, torch.float32, False),
                              (768, 10, torch.bfloat16, False)):
        bn_module_check(m, c, dtype, relu, dev)
    bn_module_check(4000, 256, torch.bfloat16, True, dev, frozen=True)
    # the main shapes first: K13b's serving SA1 in f32 eval, the others'
    # training SA1 in f32
    main = {"bn_apply": BN_CASES[1][0] + ", float32 eval"}
    for k, r in rows.items():
        first = main.get(k, BN_CASES[0][0] + ", float32 train")
        r.sort(key=lambda row: row["shape"] != first)
        record_rows(record, k, CSRC + "batch_norm.cu", BN_REPLACES[k], r)


# --- K13e-f: the SA layers' max over neighbours (ops/batch_norm) ----------

JAX_SA_MAX = "regnet_for_3d_grasping_tpu/models/backbone.py:89-91"
BN_MAX_REPLACES = {
    "bn_apply_max": JAX_SA_MAX + " (jnp.max over the neighbours of the last "
                    "ConvBN's flax nn.BatchNorm + nn.relu, " + JAX_BN
                    + ":39-45, fused by XLA)",
    "bn_max_backward": JAX_SA_MAX + " (the VJP of jnp.max over the "
                       "neighbours: the gradient split evenly over ties)",
}
# SA1-3 (K = 64 neighbours) at a serving forward and at a batch of 12:
# (label, groups, channels of the last layer)
BN_MAX_CASES = (
    ("serving SA1: 5,120 x 64 x 256", 5120, 256),
    ("serving SA2: 1,024 x 64 x 512", 1024, 512),
    ("serving SA3: 256 x 64 x 1,024", 256, 1024),
    ("training SA1: 61,440 x 64 x 256", 61440, 256),
    ("training SA2: 12,288 x 64 x 512", 12288, 512),
    ("training SA3: 3,072 x 64 x 1,024", 3072, 1024),
)
SA_K = 64


def bn_max_inputs(groups: int, c: int, dtype, seed: int, dev) -> tuple:
    """`bn_inputs` at [groups * K, c] as x [groups, K, c] with the ties of
    ball query's padding (a group keeps n <= K distinct rows and repeats
    its first after them), g_m [groups, c], the parameters and running
    buffers."""
    x, _, *params = bn_inputs(groups * SA_K, c, dtype, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    n = torch.randint(1, SA_K + 1, (groups, 1, 1), generator=gen, device=dev)
    x3 = x.view(groups, SA_K, c)
    rows = torch.arange(SA_K, device=dev)[None, :, None]
    x3 = torch.where(rows >= n, x3[:, :1], x3).contiguous()
    gm = torch.randn(groups, c, generator=gen, device=dev).to(dtype)
    return (x3, gm, *params)


def bn_max_case(label, groups, c, dtype, mode, dev, timed=False) -> dict:
    """K13e and K13f at one shape, dtype and mode: m and the words bit-equal
    to the plain version and m to K13b + amax, g to the plain version and
    to amax's autograd on K13b's output, each kernel twice bit for bit;
    `timed`: their times, the plain versions', the parent's pair (K13b +
    amax; amax's backward, the library call of K13f) and the bounds."""
    from regnet_for_3d_grasping_torch.ops import batch_norm as B
    x3, gm, w, b, rm, rv = bn_max_inputs(groups, c, dtype, groups + c, dev)
    eps, train = 1e-5, mode == "train"
    x2 = x3.view(-1, c)
    tag = f"[{groups} x {SA_K} x {c}] {str(dtype)[6:]} {mode}"
    if train:
        st = B.stats(x2)
        mean, var = st[0], st[1]
    else:
        mean, var = rm, rv
    args = (mean, var, w, b, eps, train)
    m, win = B.apply_max(x3, *args)
    m2, win2 = B.apply_max(x3, *args)
    check(bit_equal(m2, m) and torch.equal(win2, win),
          f"K13e not repeatable ({tag})")
    pm, pwin = B.apply_max_plain(x3, *args)
    check(bit_equal(m, pm) and torch.equal(win, pwin),
          f"K13e is not its plain version bit for bit ({tag})")
    check(bit_equal(B.apply_max(x3, *args, winners=False)[0], m),
          f"K13e without its words differs ({tag})")
    y = B.apply(x2, *args, True).view(groups, SA_K, c)
    check(bit_equal(y.amax(1), m), f"K13e is not K13b + amax ({tag})")
    ties = int(((win != 0) & (win & (win - 1) != 0)).sum())
    del pm, pwin, m2, win2
    g = B.max_backward(gm, win, SA_K)
    check(bit_equal(B.max_backward(gm, win, SA_K), g),
          f"K13f not repeatable ({tag})")
    check(bit_equal(g, B.max_backward_plain(gm, win, SA_K)),
          f"K13f is not its plain version bit for bit ({tag})")
    yr = y.requires_grad_()
    ref = torch.autograd.grad(yr.amax(1), yr, gm)[0]
    check(bit_equal(g, ref), f"K13f is not amax's autograd ({tag})")
    del ref, g
    print(f"K13e/K13f {tag}: m, words and g bit-equal to the plain versions"
          f", to K13b + amax and to amax's autograd; {ties} of "
          f"{groups * c} channels tie")
    out = {"bn_apply_max": {"max_abs_err": 0.0, "ties": ties},
           "bn_max_backward": {"max_abs_err": 0.0}}
    if not timed:
        return out
    vals, elt = groups * SA_K * c, x3.element_size()
    small = groups * c
    mr = yr.amax(1)

    def parent_fwd():
        return B.apply(x2, *args, True).view(groups, SA_K, c).amax(1)

    def amax_bwd():
        return torch.autograd.grad(mr, yr, gm, retain_graph=True)

    for name, kernel, plain, bytes_, ops, lib, parent in (
            ("bn_apply_max", lambda: B.apply_max(x3, *args),
             lambda: B.apply_max_plain(x3, *args),
             vals * elt + small * (elt + 8) + 4 * c * 4, 5 * vals, None,
             parent_fwd),
            ("bn_max_backward", lambda: B.max_backward(gm, win, SA_K),
             lambda: B.max_backward_plain(gm, win, SA_K),
             vals * elt + small * (elt + 8), 2 * vals, amax_bwd, None)):
        row = {"ms": cuda_ms(kernel, 10), "device_ms": device_ms(kernel, 10),
               "plain_ms": cuda_ms(plain, 3), "bytes": bytes_, "ops": ops,
               "library_ms": None}
        if lib is not None:
            row |= {"library_ms": cuda_ms(lib, 10),
                    "library_device_ms": device_ms(lib, 10),
                    "library": "amax's backward (autograd)"}
        if parent is not None:
            row |= {"parent_ms": cuda_ms(parent, 10),
                    "parent_device_ms": device_ms(parent, 10),
                    "parent": "K13b + amax",
                    # K13b reads x and writes y, amax reads y, writes m
                    "parent_bytes": 3 * vals * elt + small * elt,
                    "no_words_device_ms": device_ms(
                        lambda: B.apply_max(x3, *args, winners=False), 10)}
        out[name] |= row
        b_ms = bound(bytes_, ops)[0]
        print(f"  {name} {tag}: device {row['device_ms']:.4f} ms (bound "
              f"{b_ms:.4f}, share {b_ms / row['device_ms']:.3f}), call "
              f"{row['ms']:.4f}, plain {row['plain_ms']:.4f}"
              + (f", parent K13b + amax device {row['parent_device_ms']:.4f}"
                 f", without the words {row['no_words_device_ms']:.4f}"
                 if parent else "")
              + (f", amax's backward device {row['library_device_ms']:.4f}"
                 if lib else ""))
    return out


def bn_max_module_check(groups, c, dtype, mode, dev) -> None:
    """The module's fused max on the card (`BatchNorm.relu_max`: K13a,
    K13e, then K13f, K13c, K13d) against the parent's path on the card
    (K13's `_BatchNorm` with its ReLU, then ``amax`` and its autograd) on
    the same [B, S, K, C]: m, dx, dweight, dbias and the running buffers
    bit for bit, and one launch of each kernel it runs.  `mode` "frozen"
    (`nn/freezer.frozen_bn`): the running statistics, unchanged."""
    from regnet_for_3d_grasping_torch.nn import layers
    from regnet_for_3d_grasping_torch.ops import _cuda
    x3, gm, w, b, rm, rv = bn_max_inputs(groups, c, dtype, 3 * groups + c,
                                         dev)
    lead = (12, groups // 12) if groups % 12 == 0 else (1, groups)
    x4, g3 = x3.view(*lead, SA_K, c), gm.view(*lead, c)
    mods = []
    for _ in range(2):
        bn = layers.BatchNorm(c).to(dev).train(mode != "eval")
        bn.frozen = mode == "frozen"
        with torch.no_grad():
            for t, v in zip((bn.weight, bn.bias, bn.running_mean,
                             bn.running_var), (w, b, rm, rv)):
                t.copy_(v)
        mods.append(bn)
    xs = [x4.clone().requires_grad_() for _ in mods]
    _cuda.reset_launches()
    m = mods[0].relu_max(xs[0], 2)
    m.backward(g3)
    torch.cuda.synchronize()
    got = {k: _cuda.launches[k] for k in BN_REPLACES | BN_MAX_REPLACES}
    want = {"bn_stats": int(mode == "train"), "bn_apply": 0,
            "bn_apply_max": 1, "bn_max_backward": 1,
            "bn_backward_reduce": 1, "bn_backward_apply": 1}
    tag = f"module [{lead} x {SA_K} x {c}] {str(dtype)[6:]} {mode}"
    check(got == want, f"{tag}: launches {got}, expected {want}")
    m_ref = mods[1](xs[1], True).amax(2)
    m_ref.backward(g3)
    for what, a, r in (("m", m, m_ref), ("dx", xs[0].grad, xs[1].grad),
                       ("dweight", mods[0].weight.grad, mods[1].weight.grad),
                       ("dbias", mods[0].bias.grad, mods[1].bias.grad),
                       ("running_mean", mods[0].running_mean,
                        mods[1].running_mean),
                       ("running_var", mods[0].running_var,
                        mods[1].running_var)):
        check(bit_equal(a.detach(), r.detach()),
              f"{tag}: {what} differs from K13b + amax's")
    if mode != "train":
        check(torch.equal(mods[0].running_mean, rm)
              and torch.equal(mods[0].running_var, rv),
              f"{tag}: the running statistics moved")
    print(f"K13e/K13f {tag}: m, dx, dweight, dbias and the running buffers "
          f"bit-equal to the parent's K13b + amax")


def bn_max_edges(dev) -> None:
    """K13e and K13f at small shapes against the plain versions, K13b +
    amax and amax's autograd (`same_bits`: NaN for NaN): K = 1, 17, 64;
    C = 7 (single loads), 12 (bf16: 8-byte loads), 40; rows repeated as
    ball query pads them, a channel negative everywhere (m = 0, a K-way
    tie), -0.0 beside +0.0 before the ReLU (x = mean, weight < 0, bias
    -0.0; the ReLU of a negative value), a NaN in x; K = 65 refused."""
    from regnet_for_3d_grasping_torch.ops import batch_norm as B
    neg = 0
    for k, c in ((1, 7), (17, 12), (64, 40), (64, 7), (64, 12)):
        for dtype in (torch.float32, torch.bfloat16):
            x3, gm, w, b, rm, rv = bn_max_inputs(6, c, dtype, k + c, dev)
            x3 = x3[:, :k].contiguous()
            with torch.no_grad():
                rm[1] = 1e4
                w[2], b[2], rm[2] = -1.0, -0.0, 0.5
                x3[0, :, 2] = 0.5
                x3[0, 1::3, 2] = 7.0
                x3[1, k // 2, 3] = float("nan")
            args = (rm, rv, w, b, 1e-5, False)
            m, win = B.apply_max(x3, *args)
            pm, pwin = B.apply_max_plain(x3, *args)
            y = B.apply(x3.view(-1, c), *args, True).view(6, k, c)
            neg += int(torch.signbit(y[0, :, 2]).sum())
            tag = f"K = {k}, C = {c}, {str(dtype)[6:]}"
            check(same_bits(m, pm) and torch.equal(win, pwin)
                  and same_bits(m, y.amax(1)),
                  f"K13e differs at its edges ({tag})")
            check(bool(m[1, 3].isnan()) and int(win[1, 3]) == 0
                  and bool((win[:, 1] == (1 << k) - 1 if k < 64
                            else win[:, 1] == -1).all())
                  and (k < 3 or int(win[0, 2]) == ((1 << k) - 1 if k < 64
                                                   else -1)),
                  f"K13e's ties or NaN ({tag}): {win[:2, :4].tolist()}")
            g = B.max_backward(gm, win, k)
            yr = y.requires_grad_()
            ref = torch.autograd.grad(yr.amax(1), yr, gm)[0]
            check(same_bits(g, B.max_backward_plain(gm, win, k))
                  and same_bits(g, ref) and bool(g[1, :, 3].isnan().all()),
                  f"K13f differs at its edges ({tag})")
    print(f"K13e/K13f edges: ties, NaN, K = 1, 17, 64, C = 7, 12, 40 "
          f"bit-equal; the card's ReLU gave -0.0 {neg} times")
    x3 = torch.zeros(2, 65, 8, device=dev)
    one = torch.ones(8, device=dev)
    for call in (lambda: B.apply_max(x3, one, one, one, one, 1e-5, False),
                 lambda: B.max_backward(torch.zeros(2, 8, device=dev),
                                        torch.zeros(2, 8, dtype=torch.int64,
                                                    device=dev), 65)):
        try:
            call()
        except ValueError:
            continue
        check(False, "K = 65 neighbours were not refused")


def bn_max_kernels(dev, record) -> None:
    """Phase 3 for K13e-f: every case of `BN_MAX_CASES` in f32 and bf16,
    train and eval (`bn_max_case`; frozen runs eval's arguments), timed in
    the path's mode (serving eval, training train); the module against the
    parent's K13b + amax in train, eval and frozen (`bn_max_module_check`);
    the edges; one record a kernel, serving SA1 f32 first."""
    rows = {k: [] for k in BN_MAX_REPLACES}
    for label, groups, c in BN_MAX_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            timed_mode = "eval" if label.startswith("serving") else "train"
            for mode in ("train", "eval"):
                res = bn_max_case(label, groups, c, dtype, mode, dev,
                                  timed=mode == timed_mode)
                if mode == timed_mode:
                    for k, r in res.items():
                        rows[k].append({"shape": f"{label}, "
                                        f"{str(dtype)[6:]} {mode}", **r})
            for mode in ("train", "eval", "frozen"):
                bn_max_module_check(groups, c, dtype, mode, dev)
            torch.cuda.empty_cache()
    bn_max_edges(dev)
    # the main shapes first: K13e's serving SA1, K13f's training SA1, f32
    main = {"bn_apply_max": BN_MAX_CASES[0][0] + ", float32 eval",
            "bn_max_backward": BN_MAX_CASES[3][0] + ", float32 train"}
    for k, r in rows.items():
        r.sort(key=lambda row: row["shape"] != main[k])
        record_rows(record, k, CSRC + "batch_norm.cu", BN_MAX_REPLACES[k], r)


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
    # the launches take the current stream through torch's private raw
    # stream query: it must name the stream torch's public API names
    side = torch.cuda.Stream(dev)
    for s in (torch.cuda.current_stream(dev), side):
        with torch.cuda.stream(s):
            check(_cuda.raw_stream(torch.cuda.current_device())
                  == s.cuda_stream,
                  "the raw stream is not torch's current stream")

    if "--dp-only" in sys.argv[1:]:
        # phases (h) and (i) alone, on every visible card
        wants = serving_wants()
        _, found = dp_phases(wants, None)
        print(json.dumps({"data_parallel": found}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    # --- 3. each kernel against its plain version --------------------------
    from regnet_for_3d_grasping_torch.geometry import region
    from regnet_for_3d_grasping_torch.geometry.codec import grasps_to_frames
    from regnet_for_3d_grasping_torch.ops import (ball_query, crop, fps,
                                                  group, knn, pooling,
                                                  sampling)
    from regnet_for_3d_grasping_torch.utils.scene import tabletop_cloud
    # a few points more than needed: the scene's objects round their share
    xyz_np, _ = tabletop_cloud(np.random.RandomState(0), N_POINTS + 64)
    xyz = torch.tensor(xyz_np[:N_POINTS], dtype=torch.float32,
                       device=dev)[None]
    results = {}

    def record(name, source, replaces, err, ms, plain_ms, bytes_, ops,
               library_ms=None, also=None, wrapper_ms=None, shape=None,
               extra=None, **device):
        """`also`: the numbers of the kernel's other shapes, where it has
        some on its paths (`shape` then names the first).  `wrapper_ms`: the
        whole call where `ms` times the launch on a span table computed
        beforehand (K8).  `extra`: other fields of the main shape, kept as
        they are.  `device`: `device_ms` and `library_device_ms`, the times
        without the host's (`device_ms`), where they were taken."""
        b_ms, b_by = bound(bytes_, ops)
        results[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}
        if wrapper_ms is not None:
            results[name]["wrapper_ms"] = wrapper_ms
        if shape:
            results[name]["shape"] = shape
        results[name] |= device | (extra or {})
        if also:
            results[name]["also"] = also
        print(f"{name}: max_abs_err {err} kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})"
              + (f", library {library_ms:.4f} ms" if library_ms else "")
              + (f", whole call {wrapper_ms:.4f} ms" if wrapper_ms else "")
              + "".join(f", {k} {v:.4f}" for k, v in device.items()))
        for row in also or ():
            print(f"  {row.get('shape')}: "
                  + ", ".join(f"{k} {v:.6g}" for k, v in row.items()
                              if isinstance(v, float)))

    # K1 at every shape the paths launch and at the edge cases
    sa1_idx = fps_kernels(dev, xyz, record).long()

    # K2 and K3 at serving (the SA1 centers of this cloud) and at a
    # training batch; K3 also as the slab fallback runs it
    centers = xyz[:, sa1_idx[0]].contiguous()
    tx = train_clouds(dev)
    sa1_12 = sa1_centers(tx)
    scan_calls = {}
    ball_query_kernels(xyz, centers, tx, sa1_12, record, scan_calls)
    three_nn_kernels(dev, xyz, centers, tx, sa1_12, record, scan_calls)

    # K12, the served grouping (r 0.008, K 256, L 100), and
    # K11, the fused grouping on no model path (L 128), at a serving
    # forward (4,000 centers: 4 chunks, 4 seeds), a training batch (12
    # clouds x 64 centers) and a validation forward (1 x 64).  Operations:
    # an exact test on this run's pairs (`expansion_test_ops`,
    # `radius_test_ops`), and on the pairs in radius the pick: K12 the
    # lowbias32 hash, its float and argmax (13), K11 hash and argmax (10)
    dist_m = fps.dist_init(xyz, xyz[..., 2] > 0.76)
    c4000 = xyz[:, fps.fps(xyz, dist_m, N_CENTERS)[0].long()].contiguous()
    picks = fps.fps(tx, fps.dist_init(tx, tx[..., 2] > 0.76), TRAIN_CENTERS)
    c12 = torch.gather(tx, 1, picks.long()[..., None].expand(-1, -1, 3))
    c64 = xyz[:, fps.fps(xyz, dist_m, TRAIN_CENTERS)[0].long()].contiguous()
    Lg = sampling.pallas_bucket_stride(N_POINTS, 256)
    bucket_scan_edges(dev)
    group12 = group_chunked_kernels(xyz, c4000, tx, c12, c64, record,
                                    scan_calls)
    rows = []
    for label, x, c in (
            ("serving: 4000 centers x 25600 points", xyz, c4000),
            ("training: 12 clouds x 64 centers x 25600 points", tx, c12),
            ("validation: 1 cloud x 64 centers", xyz, c64)):
        def kernel(x=x, c=c):
            return group.group_regions_fused(x, c, 21, 0.008, 256, Lg)

        def plain(x=x, c=c):
            return group.group_regions_fused_plain(x, c, 21, 0.008, 256, Lg)

        test_ops, slab, inside = radius_test_ops(x, c, group.radius2(0.008))
        print(f"group_regions {label}: {slab} pairs inside the x slab")
        row = bucket_scan_case("group_regions", label, kernel, plain, (x, c),
                               test_ops + inside * 10, inside,
                               "group_regions", 256, Lg)
        rows.append(row)
        scan_calls[f"group_regions {label}"] = (
            kernel, ("bucket_scan_kernel", "bucket_fill_kernel"))
    record_rows(record, "group_regions", CSRC + "group.cu",
                JAX_OPS + "group_pallas.py:119", rows)
    # K11's path: its entry point at the three shapes, counters reset just
    # before and read just after (no model path launches it)
    _cuda.reset_launches()
    for x, c in ((xyz, c4000), (tx, c12), (xyz, c64)):
        group.group_regions_fused(x, c, 21, 0.008, 256, Lg)
    torch.cuda.synchronize()
    k11_launches = dict(_cuda.launches)
    check(k11_launches["group_regions"] == 3
          and k11_launches["group_regions_chunked"] == 0,
          f"group_regions_fused did not launch K11: {k11_launches}")

    # K5: crop of 4000 proposals around the selected centers (the serving
    # path), and of the training and validation shapes' 64 proposals
    # (there the crop takes its plain path: checked, not on a path)
    box = (0.0, 0.03, 0.04, 0.005)
    L = sampling.pallas_bucket_stride(N_POINTS, 64)
    rows = []
    for label, x, c in (
            ("serving: 4000 proposals x 25600 points", xyz, c4000),
            ("training: 12 clouds x 64 proposals", tx, c12),
            ("validation: 1 cloud x 64 proposals", xyz, c64)):
        B, M = c.shape[:2]
        gen = torch.Generator().manual_seed(M)
        axis = torch.nn.functional.normalize(
            torch.randn(B, M, 3, generator=gen), dim=-1).to(dev)
        theta = ((torch.rand(B, M, 1, generator=gen) * 2 - 1) * np.pi
                 ).to(dev)
        frames, bases = grasps_to_frames(torch.cat([c, axis, theta], -1))
        frames, bases = frames.contiguous(), bases.contiguous()

        def kernel(x=x, frames=frames, bases=bases):
            return crop.closing_region_crop(x, frames, bases, 12345, box,
                                            64, L)

        def plain(x=x, frames=frames, bases=bases):
            return crop.crop_plain(x, frames, bases, 12345, box, 64, L)

        test_ops, (in_z, in_zx), inside = box_test_ops(x, frames, bases,
                                                       box)
        print(f"crop {label}: {in_z} pairs inside the z slab, {in_zx} "
              f"inside the z and x slabs")
        rows.append(bucket_scan_case("crop", label, kernel, plain,
                                     (x, frames, bases), test_ops
                                     + inside * 10, inside, "crop", 64, L))
        if M == N_CENTERS:    # the serving refine pool's indices, as the
            cidx, ccount = kernel()    # model masks them
            crop_idx = torch.where((ccount > 0)[..., None], cidx, 0)
        scan_calls[f"crop {label}"] = (
            kernel, ("bucket_scan_kernel", "bucket_fill_kernel"))
    record_rows(record, "crop", CSRC + "crop.cu",
                JAX_OPS + "crop_pallas.py:145", rows)

    # K4: the region pool (4,000 x 256 slots x 256 channels, K12's picks)
    # and the refine pool (4,000 x 64 slots, K5's picks of the crop above)
    groups = region.group_regions(SERVING_GROUP_SEEDS, xyz, c4000, 256,
                                  0.008)
    check(torch.equal(groups.index, group12[0])
          and torch.equal(groups.valid, group12[1] > 0),
          "region.group_regions does not return K12's picks")
    feature = torch.randn(1, N_POINTS, 256, device=dev)
    rows = [gather_max_case("region pool: 4000 x 256 slots", feature,
                            groups.index),
            gather_max_case("refine pool: 4000 x 64 slots of K5's crop",
                            feature, crop_idx)]
    record_rows(record, "gather_max", CSRC + "gather_max.cu",
                JAX_OPS + "pooling.py:216", rows)
    # the bf16 form (a bf16 compute dtype: `--bf16`) on the same values
    # rounded to bf16, at the same two pools
    fb = feature.bfloat16()
    rows = [gather_max_case("region pool: 4000 x 256 slots, bf16", fb,
                            groups.index),
            gather_max_case("refine pool: 4000 x 64 slots of K5's crop, "
                            "bf16", fb, crop_idx)]
    nan = fb.clone()
    nan[0, groups.index[0, 7, 3].long(), 5] = float("nan")
    check(torch.equal(pooling.gather_max(nan, groups.index).isnan(),
                      pooling.gather_max_plain(nan, groups.index).isnan()),
          "K4 bf16 does not propagate a NaN as torch.amax does")
    f7 = fb[..., :7].contiguous()     # 2-byte loads: C not a multiple of 8
    check(bit_equal(pooling.gather_max(f7, crop_idx),
                    pooling.gather_max_plain(f7, crop_idx)),
          "K4 bf16 differs at C = 7")
    record_rows(record, "gather_max_bf16", CSRC + "gather_max.cu",
                JAX_OPS + "pooling.py:216 (bf16 rows, :53)", rows)
    index = groups.index

    # K4's argmax form and the backward, at the pools of a training batch
    # and at the 4,000-center region pool
    g12 = region.group_regions([22], tx, c12, 256, 0.008)
    f12 = relu_features(TRAIN_B, 14, dev)
    cases = [
        ("region pool, training: 12 x 64 x 256 slots", f12, g12.index, ()),
        ("refine pool, training: 12 x 64 x 64 slots", f12,
         g12.index[..., :64].contiguous(), ()),
        ("region pool, 4000 x 256 slots", torch.relu(feature), index, ())]
    backward_rows = pool_kernels(
        record, "gather_max_argmax", CSRC + "gather_max.cu",
        JAX_OPS + "pooling.py:216", pooling.gather_max_argmax,
        pooling.gather_max_argmax_plain, cases, N_POINTS,
        kept=kept_stats)
    # the bf16 argmax form (bf16 training) at the same pools, on the same
    # values rounded to bf16, with a NaN and at C = 7 (2-byte loads)
    f12b = f12.bfloat16()
    bf16_backward_rows = pool_kernels(
        record, "gather_max_argmax_bf16", CSRC + "gather_max.cu",
        JAX_OPS + "pooling.py:216 (bf16 rows, with_argmax; :241-246)",
        pooling.gather_max_argmax, pooling.gather_max_argmax_plain,
        [(label + ", bf16", f.bfloat16(), i, e)
         for label, f, i, e in cases], N_POINTS, kept=kept_stats)
    nan = f12b.clone()
    nan[3, g12.index[3, 7, 5].long(), 9] = float("nan")
    nan[0, g12.index[0, 2, 0].long(), 4] = float("nan")
    f7 = f12b[..., :7].contiguous()
    for label, f in (("a NaN", nan), ("C = 7", f7)):
        got = pooling.gather_max_argmax(f, g12.index)
        ref = pooling.gather_max_argmax_plain(f, g12.index)
        check(bit_equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"K4 bf16 argmax differs ({label})")
    check(bool(got[0].isfinite().all())
          and pooling.gather_max_argmax(nan, g12.index)[0].isnan().sum() >= 2,
          "K4 bf16 argmax does not take a NaN as torch.argmax does")
    # the autograd wiring on the card: the pool's gradient is the scatter
    # of its own winners, and the graph is not cut
    for f, suffix in ((f12, ""), (f12b, "_bf16")):
        grad, pooled = pool_gradient(
            lambda x: pooling.gather_max(x, g12.index), f,
            "gather_max_argmax" + suffix, "gather_max_backward" + suffix)
        check(bit_equal(grad, pooling.scatter_winner(
            torch.ones_like(pooled), pooling.gather_max_argmax(
                f, g12.index)[1], N_POINTS))
            and float(grad.float().sum()) == pooled.numel(),
            f"the pool's gradient is not the scatter of its winners "
            f"({f.dtype})")

    backward_edges(dev)

    # K6-K10 on the same cloud in slab order
    slab_rows, slab_rows_bf16, flat_launches = slab_kernels(dev, xyz, record,
                                                            scan_calls)
    record_rows(record, "gather_max_backward", CSRC + "gather_max.cu",
                JAX_OPS + "pooling.py:285 (the XLA scatter-add of the "
                "custom VJPs, also slab.py:1090)", backward_rows + slab_rows)
    record_rows(record, "gather_max_backward_bf16", CSRC + "gather_max.cu",
                JAX_OPS + "pooling.py:285 and slab.py:1090 on bf16 g (the "
                "XLA scatter-add in g.dtype)",
                bf16_backward_rows + slab_rows_bf16)
    # K13a-d, BatchNorm + ReLU, at the paths' shapes; K13e-f, its ReLU's
    # max over neighbours at SA1-3
    batch_norm_kernels(dev, record)
    bn_max_kernels(dev, record)
    check(set(results) == set(_cuda.KERNELS),
          "not every kernel of the port was held against its plain version")
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"kernels": list(results.values())}))
        print(smi)
        return

    slab_over = {"region.slab_cell": SLAB_CELL, "model.fps_groups": FPS_GROUPS,
                 "region.center_fps_groups": FPS_GROUPS}
    bf16_over = {"model.compute_dtype": "bfloat16"}
    cxyz, crgb = tabletop_cloud(np.random.RandomState(100))
    sel = np.random.RandomState(1).choice(len(cxyz), N_POINTS, False)
    pc = np.c_[cxyz, crgb][sel].astype(np.float32)
    # one forward of each serving path on the card and on the CPU, with the
    # same seeds and sort noise; the CPU's run in a helper process beside
    # the training phases
    full_rand = {"group_seeds": [11, 12, 13, 14], "crop_seeds": [[15]]}
    slab_rand = {"sort_u": torch.rand(1, N_POINTS, generator=torch.Generator()
                                      .manual_seed(3)).numpy(),
                 "sa1_seed": 16, "group_seeds": [17], "crop_seeds": [[18]]}
    compared = {"full-scan": ({}, full_rand), "slab": (slab_over, slab_rand),
                "bf16 full-scan": (bf16_over, full_rand),
                "fast": (slab_over | bf16_over, slab_rand),
                "bf16 full-scan" + F64: (bf16_over, full_rand, "f64"),
                "fast" + F64: (slab_over | bf16_over, slab_rand, "f64")}
    wants = serving_wants()
    paths, solo_s = serving_phases(wants)
    paths["k8_flat_entry"] = flat_launches
    paths["k11_entry"] = k11_launches
    # (f) the serving knobs through the infer CLI, and one forward of each
    # configuration against the CPU's (in `compared`, below)
    t0 = time.perf_counter()
    knob_paths, knob_serving = knob_serving_phase(wants)
    paths |= knob_paths
    print(f"phase (f): {time.perf_counter() - t0:.1f} s")
    # (h) and (i): data parallelism over every visible card
    dp_paths, data_parallel = dp_phases(wants, solo_s)
    paths |= dp_paths
    for key, _, over, rand in knob_runs():
        compared[key] = (over, {"full": full_rand, "slab": slab_rand}[rand])
        if "model.compute_dtype" in over:
            compared[key + F64] = (over, compared[key][1], "f64")
    # (k) the JAX package's Orbax checkpoint, read by the port
    t0 = time.perf_counter()
    orbax_paths, orbax = orbax_phase(dev, smi)
    paths |= orbax_paths
    print(f"phase (k): {time.perf_counter() - t0:.1f} s")
    # (e) suite v2 through the metrics CLI, both configurations
    suite = suite_phase(ROOT / "chiprun_out" / "suite")
    # (c) the evaluator on the card; the CPU's side in a helper beside the
    # training phases
    spec, _, eval_grasps = eval_scene_grasps(dev)
    check(len(eval_grasps) >= 1024, f"only {len(eval_grasps)} stage-2 "
          f"grasps on {spec['name']}")
    eval_card = eval_fields(12, eval_grasps, "cuda")
    # after the serving phases, whose host-bound latencies they would slow:
    # the CPU's forwards, and its bf16 training steps in a second helper
    import concurrent.futures
    import multiprocessing
    from regnet_for_3d_grasping_torch.data import write_synthetic_dataset
    step_data = tempfile.TemporaryDirectory()
    write_synthetic_dataset(step_data.name, 3, num_view=N_POINTS)
    step_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    cpu = CpuForwards(pc, compared)
    try:
        cpu_steps = step_pool.submit(cpu_bf16_steps, step_data.name)
        cpu_eval = step_pool.submit(eval_fields, 12, eval_grasps, "cpu")
        cpu_library = step_pool.submit(library_fields, pc, "cpu")
        paths |= training_phases(dev)
        # (b) two training runs from one seed are bit-equal
        with tempfile.TemporaryDirectory() as tmp:
            det = determinism_phase(tmp)
        evaluator = evaluator_card_vs_cpu(eval_card,
                                          cpu_eval.result(timeout=900))
        # 17. one bf16 training step on the card against the CPU
        step = bf16_step_card_vs_cpu(step_data.name, cpu_steps)
        # (j) the library functions no entry point reaches, card and CPU
        t0 = time.perf_counter()
        library = library_card_vs_cpu(library_fields(pc, "cuda"),
                                      cpu_library.result(timeout=900))
        print(f"phase (j): {time.perf_counter() - t0:.1f} s")
        compare_phases(pc, compared, cpu)
    finally:
        cpu.close()
        step_pool.shutdown(cancel_futures=True)
        step_data.cleanup()
    print(json.dumps({"bf16_train_step_card_vs_cpu": step}))
    print(json.dumps({"determinism": det, "evaluator": evaluator,
                      "suite_v2": suite, "knob_serving": knob_serving,
                      "data_parallel": data_parallel, "library": library,
                      "orbax": orbax}))

    main_path = {**dict.fromkeys(results, "full_scan"),
                 **dict.fromkeys(SLAB_KERNELS, "slab"),
                 "gather_max_argmax": "train_full_scan",
                 "gather_max_backward": "train_full_scan",
                 "gather_max_slab_argmax": "train_slab",
                 "gather_max_bf16": "bf16_full_scan",
                 "gather_max_slab_bf16": "fast",
                 "gather_max_argmax_bf16": "train_bf16_full_scan",
                 "gather_max_backward_bf16": "train_bf16_full_scan",
                 "gather_max_slab_argmax_bf16": "train_bf16_slab",
                 "three_nn_slab_flat": "k8_flat_entry",
                 "group_regions": "k11_entry",
                 "bn_stats": "train_full_scan",
                 "bn_backward_reduce": "train_full_scan",
                 "bn_backward_apply": "train_full_scan",
                 "bn_max_backward": "train_full_scan"}
    for k in results:
        results[k]["launches"] = paths[main_path[k]][k]
        results[k]["launches_by_path"] = {p: c[k] for p, c in paths.items()}
        check(results[k]["launches"] > 0 or k == "three_nn",
              f"{k} was never launched on its path")
    for k, path in (("group_regions_chunked", "train_full_scan"),
                    ("gather_max_backward", "train_slab"),
                    ("gather_max_backward_bf16", "train_bf16_slab")):
        check(paths[path][k] > 0, f"{k} was never launched in {path}")

    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
