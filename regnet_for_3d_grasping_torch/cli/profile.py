"""Where one inference forward, or one training step, spends its time on
the card.

    python -m regnet_for_3d_grasping_torch.cli.profile [--clouds 3]
        [--slab-cell 0.04 --fps-groups 8] [--bf16]
    python -m regnet_for_3d_grasping_torch.cli.profile --train
        [--batch-size 12] [--slab-cell 0.04 --fps-groups 8] [--bf16]

Runs the inference preset (25,600 points, 4,000 centers, the trained
weights; with the two flags, the sorted-slab serving configuration; with
``--bf16``, the bf16 compute dtype, which with both is the infer CLI's
``--fast``) on
synthetic tabletop clouds, two warm-up forwards first, then runs the
next `--clouds` forwards untraced and once more under ``torch.profiler``,
and prints: the host-clock latency of each forward both ways, the device
busy share (the union of the device's activity intervals over wall time,
against the traced and the untraced forwards), the program's spans a
forward and the longest idle gaps of the card, each with the innermost
span open on the host in it (`print_spans`), the
device-to-host copies per forward (in slab mode one of them is the read of
the 3-NN certificate), the forwards that fell back to the full-scan 3-NN,
the device time per forward of the ten costliest kernels and of every
kernel of ``csrc/``, the GEMMs' share (cuBLAS's matrix-product
kernels), BatchNorm's kernels (K13, ``csrc/batch_norm.cu``) apart from the
other elementwise and library kernels, and what every BatchNorm with its
ReLU launched, by where the launch came from (`batch_norm_ranges`), and
what the set-abstraction layers' max over neighbours launched: ``amax``'s
kernels where it follows the MLP, K13e where the max runs fused into the
last BatchNorm (then inside BatchNorm too; "BN + SA max" counts each
launch once, so two trees compare like with like).

With ``--train``: the training preset (25,600 points, 64 centers, batch 12,
all three losses, freshly initialised weights; with ``--bf16``, bf16
training, the train CLI's ``--bf16``), deterministic as the train CLI runs
it, on synthetic scenes made from a seed; two warm-up steps, two untraced
steps, then one step whose forward (with the losses) and whose backward
(with the update) are traced apart, and one more step traced whole with
its input (a batch read from the scenes, prepared and uploaded) for the
program's spans, its counters and the idle gaps.
It prints the step times, the peak device memory, and for each half the
device busy time, the launches, the GEMMs' time, BatchNorm's and the SA
max's (as for a forward; in the backward, what the autograd nodes of
their forward ops launched: ``amax``'s backward, or K13f) and the five
costliest kernels.

The program's spans (``utils/trace.py``, on while the profiler records;
profiler ranges ``regnet::<span>``): ``regnet`` (``REGNet.forward``) >
``sn`` (ScoreNet), ``grn`` (centers, grouping, pool, TwoStageHead, decode,
pose search), ``rn`` (refine, guard, acceptance); ``extract``; ``step``
(``train_step``) > ``forward`` (``regnet`` and the losses), ``backward``,
``update``; ``data.prep`` > ``data.read``, ``data.upload``.  ``sn``,
``grn``, ``rn``, ``forward``, ``backward`` and ``update`` are timed on the
card's stream by CUDA events at their ends (wall time on the stream, its
idle gaps included, not the card's work); each counted wait of the host
for the card (``to_host``, ``to_device``, ``waiting``) adds to its
innermost span's syncs and wait.  The counters ``read_bytes`` (the scene
files read in ``data.read``) and ``upload_bytes`` (``data.upload``) print
as MB a step and MB/s of their span's host time.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from pathlib import Path

import numpy as np
import torch

from regnet_for_3d_grasping_torch.utils import trace

WEIGHTS = Path(__file__).resolve().parents[2] / "weights" / "r5_real_e100.npz"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clouds", type=int, default=3)
    p.add_argument("--weights", default=str(WEIGHTS))
    p.add_argument("--slab-cell", type=float, default=0.0)
    p.add_argument("--fps-groups", type=int, default=1)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 network compute (geometry stays f32)")
    p.add_argument("--train", action="store_true",
                   help="profile one training step instead of forwards")
    p.add_argument("--batch-size", type=int, default=12)
    args = p.parse_args(argv)
    if args.train:
        return profile_train(args)

    from torch.profiler import ProfilerActivity, profile

    from regnet_for_3d_grasping_torch.config import infer_config
    from regnet_for_3d_grasping_torch.models.regnet import build_regnet
    from regnet_for_3d_grasping_torch.utils.scene import tabletop_cloud

    from regnet_for_3d_grasping_torch.ops import _cuda

    cfg = infer_config(**{"region.slab_cell": args.slab_cell,
                          "model.fps_groups": args.fps_groups,
                          "region.center_fps_groups": args.fps_groups,
                          "model.compute_dtype": ("bfloat16" if args.bf16
                                                  else "float32")})
    model = build_regnet(cfg, args.weights, "cuda")
    gen = torch.Generator().manual_seed(0)
    clouds = []
    for i in range(args.clouds + 2):
        # the scene's objects round their share of the points: make a few
        # more and keep exactly 25,600, as the infer CLI resamples a cloud
        rng = np.random.RandomState(200 + i)
        xyz, rgb = tabletop_cloud(rng, 25600 + 64)
        keep = rng.choice(len(xyz), 25600, replace=False)
        clouds.append(torch.tensor(np.c_[xyz, rgb][keep], dtype=torch.float32,
                                   device="cuda")[None])
    with torch.inference_mode():
        for pc in clouds[:2]:
            model(pc, generator=gen)
    torch.cuda.synchronize()

    @torch.inference_mode()
    def serve() -> list:
        lat = []
        for pc in clouds[2:]:
            t0 = time.perf_counter()
            model(pc, generator=gen)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        return lat

    untraced = serve()
    _cuda.reset_launches()
    trace.reset()
    with batch_norm_ranges(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_all = time.perf_counter()
        lat = serve()
        wall = (time.perf_counter() - t_all) * 1e3
    n = args.clouds
    kernels = device_kernels(prof)
    busy = trace.device_timeline(prof)["busy_us"] / 1e3
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"forward latency (host clock) ms: profiler off "
          f"{[round(x, 3) for x in untraced]}, profiler on "
          f"{[round(x, 3) for x in lat]}")
    print(f"device busy {busy / n:.3f} ms per forward of {wall / n:.3f} ms "
          f"wall: busy share {busy / wall:.3f} with the profiler on, "
          f"{busy / sum(untraced):.3f} of the untraced forwards")
    print_spans(prof, n, "forward")
    d2h = [e for e in prof.key_averages() if "Memcpy DtoH" in e.key]
    print(f"device-to-host copies per forward: "
          f"{sum(e.count for e in d2h) / n:.1f}, "
          f"{sum(e.self_device_time_total for e in d2h) / 1e3 / n:.3f} ms; "
          f"3-NN fallbacks: {_cuda.fallbacks['fp3_slab']} of {n} forwards; "
          f"launches per forward: "
          f"{ {k: v // n for k, v in _cuda.launches.items() if v} }")
    own = own_kernels(kernels)
    for title, rows in (("top kernels", kernels[:10]),
                        ("the port's own kernels", own)):
        print(f"{title}, device ms per forward:")
        for e in rows:
            print(f"  {e.self_device_time_total / 1e3 / n:9.3f} "
                  f"x{e.count // n:<5d} {e.key[:90]}")
    own_ms = sum(e.self_device_time_total for e in own) / 1e3 / n
    gemm = [e for e in kernels if is_gemm(e.key)]
    gemm_ms = sum(e.self_device_time_total for e in gemm) / 1e3 / n
    bn = [e for e in own if is_batch_norm(e.key)]
    bn_ms = sum(e.self_device_time_total for e in bn) / 1e3 / n
    print(f"the port's own kernels {own_ms:.3f} ms (BatchNorm's K13 "
          f"{bn_ms:.3f} ms in {sum(e.count for e in bn) // n} launches, "
          f"the others {own_ms - bn_ms:.3f}), library and elementwise "
          f"kernels {busy / n - own_ms:.3f} ms per forward, "
          f"{sum(e.count for e in kernels) // n} kernel launches per forward")
    print(f"GEMMs (cuBLAS) {gemm_ms:.3f} ms in "
          f"{sum(e.count for e in gemm) // n} launches per forward, "
          f"{gemm_ms / (busy / n):.3f} of the busy time; elementwise and "
          f"other library kernels {busy / n - own_ms - gemm_ms:.3f} ms")
    parts, how = batch_norm_time(prof, forward=True)
    for key, title in PARTS:
        ms, count = parts[key]
        print(f"{title} ({how}): {ms / n:.3f} ms in {count / n:.1f} "
              f"launches per forward, {ms / n / (busy / n):.3f} of the busy "
              f"time")


def print_spans(prof, n: int, unit: str) -> None:
    """The program's spans a `unit` (a forward or a step) of the `n` in the
    profile `prof`: calls, host self ms, stream ms (the stream-timed
    spans), the span's own syncs and their wait ms; the waits by where
    they sit; the byte counters as MB a `unit` and MB/s of their span's
    host time; the card's longest idle gaps, each with the innermost
    program span open on the host in it."""
    tot = trace.totals()
    print(f"the program's spans, a {unit}: calls, host self ms, stream ms, "
          f"syncs, wait ms")
    for name, s in tot["spans"].items():
        dev = "" if s["stream_ms"] is None else f"{s['stream_ms'] / n:.3f}"
        print(f"  {name:<12} {s['calls'] / n:5g} {s['self_ms'] / n:9.3f} "
              f"{dev:>9} {s['self_syncs'] / n:6g} "
              f"{s['self_wait_ms'] / n:8.3f}")
    print(f"syncs a {unit}: {tot['syncs'] / n:g} ("
          + ", ".join(f"{w} {s['syncs'] / n:g}"
                      for w, s in tot["sites"].items()) + ")")
    for name, where in (("read_bytes", "data.read"),
                        ("upload_bytes", "data.upload")):
        if name in tot["counters"] and where in tot["spans"]:
            mb = tot["counters"][name] / 1e6
            ms = tot["spans"][where]["host_ms"]
            print(f"{name}: {mb / n:.3f} MB a {unit}, {mb / ms * 1e3:.1f} "
                  f"MB/s of {where}'s {ms / n:.3f} ms")
    gaps = trace.device_timeline(prof)["gaps"]
    print("longest idle gaps of the card, us (innermost span): "
          + ", ".join(f"{us:.1f} ({span})" for span, us in gaps))


def is_gemm(name: str) -> bool:
    """A matrix-product kernel of cuBLAS (its own, CUTLASS's or the
    architecture's generated kernels)."""
    return any(k in name.lower() for k in ("gemm", "xmma", "cutlass",
                                            "cublas", "sm90_", "nvjet"))


def is_batch_norm(name: str) -> bool:
    """A kernel of BatchNorm's K13 (``csrc/batch_norm.cu``)."""
    return "bn_" in name and "_kernel" in name


BN_RANGE, DENSE_RANGE = "regnet::batch_norm", "regnet::dense"
# the set-abstraction layers' grouping, MLP and max over neighbours
SA_RANGE = "regnet::sa_features"
# K13e and K13f: the SA max fused into the last BatchNorm, and its backward
MAX_KERNELS = ("bn_apply_max_kernel", "bn_max_backward_kernel")
# what `batch_norm_time` reports: BatchNorm + ReLU, the SA max, and both
# (a launch counted once)
PARTS = (("bn", "BatchNorm + ReLU (every launch inside them)"),
         ("max", "SA max over neighbours (amax's kernels, or K13e/K13f)"),
         ("both", "BN + SA max"))


@contextlib.contextmanager
def batch_norm_ranges():
    """Within the block, every ``nn/layers`` BatchNorm and ConvBN forward
    runs inside a profiler range named `BN_RANGE` and every Dense inside
    `DENSE_RANGE`, so that `batch_norm_time` can tell what BatchNorm and
    its ReLU launched (a ConvBN's range minus its Dense's), and every
    ``SetAbstraction._features`` (grouping, MLP, max) inside `SA_RANGE`.
    Only the traced window pays for the ranges."""
    from torch.profiler import record_function

    from regnet_for_3d_grasping_torch.models.backbone import SetAbstraction
    from regnet_for_3d_grasping_torch.nn import layers
    saved = {}
    for cls, attr, name in ((layers.ConvBN, "forward", BN_RANGE),
                            (layers.BatchNorm, "forward", BN_RANGE),
                            (layers.Dense, "forward", DENSE_RANGE),
                            (SetAbstraction, "_features", SA_RANGE)):
        def wrapped(self, *args, _f=getattr(cls, attr), _name=name,
                    **kwargs):
            with record_function(_name):
                return _f(self, *args, **kwargs)
        saved[cls, attr] = getattr(cls, attr)
        setattr(cls, attr, wrapped)
    try:
        yield
    finally:
        for (cls, attr), f in saved.items():
            setattr(cls, attr, f)


def _ancestors(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def _in_batch_norm(e) -> bool:
    """`e` lies inside a BatchNorm range and not inside its Dense's."""
    for a in _ancestors(e):
        if a.name == DENSE_RANGE:
            return False
        if a.name == BN_RANGE:
            return True
    return False


def _in_sa_amax(e) -> bool:
    """`e` lies inside an ``aten::amax`` of a set-abstraction layer's
    features: the max over neighbours where it follows the MLP."""
    names = {a.name for a in _ancestors(e)}
    return "aten::amax" in names and SA_RANGE in names


def batch_norm_time(prof, forward: bool, seqs: tuple = ((), ())) -> tuple:
    """({"bn", "max", "both"}: (device ms, kernel launches)), and how many
    kernels were tied to their launch) of what BatchNorm and its ReLU, and
    the SA layers' max over neighbours, launched in the profile `prof`: in
    a forward (traced within `batch_norm_ranges`), the kernels whose launch
    lies inside a BatchNorm range, or inside an SA layer's ``amax`` (or
    that are K13e); in a backward, those launched by autograd nodes whose
    sequence number is in `seqs` (`batch_norm_seqs` of the forward's
    profile: BatchNorm's, the SA max's), or that are K13f.  "both" counts
    a kernel that is BatchNorm's and the max's (K13e, K13f) once.  A
    kernel is tied to its launch by the correlation id it shares with the
    runtime call."""
    events = list(prof.events())
    launch = {e.id: e for e in events
              if e.device_type == torch.autograd.DeviceType.CPU
              and "Launch" in e.name and e.id > 0}
    out = dict.fromkeys(("bn", "max", "both"), (0.0, 0))
    tied = 0

    def node_of(r, which):
        return any(a.sequence_nr in which
                   and a.name.startswith("autograd::engine")
                   for a in _ancestors(r))

    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.id not in launch or "Memcpy" in e.name or \
                "Memset" in e.name or e.name.startswith("regnet::"):
            continue
        tied += 1
        r = launch[e.id]
        fused = any(k in e.name for k in MAX_KERNELS)
        if forward:
            mine = {"bn": _in_batch_norm(r), "max": fused or _in_sa_amax(r)}
        else:
            mine = {"bn": node_of(r, seqs[0]),
                    "max": fused or node_of(r, seqs[1])}
        mine["both"] = mine["bn"] or mine["max"]
        for key, hit in mine.items():
            if hit:
                ms, count = out[key]
                out[key] = (ms + e.self_device_time_total / 1e3, count + 1)
    return out, f"{tied} kernels tied to their launch"


def batch_norm_seqs(prof) -> tuple:
    """The autograd sequence numbers of a traced forward's ops inside
    BatchNorm ranges (not inside their Dense's), and of its SA layers'
    ``amax``."""
    bn, sa_max = set(), set()
    for e in prof.events():
        if e.sequence_nr >= 0:
            if _in_batch_norm(e):
                bn.add(e.sequence_nr)
            if _in_sa_amax(e):
                sa_max.add(e.sequence_nr)
    return bn, sa_max


def device_kernels(prof) -> list:
    """The profile's device-side rows, costliest first: kernels and copies,
    not the ranges (`batch_norm_ranges`), which the card's timeline also
    shows."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("regnet::")]
    return sorted(rows, key=lambda e: -e.self_device_time_total)


def own_kernels(rows: list) -> list:
    """The rows of the kernels of ``csrc/``: they live in anonymous
    namespaces at global scope (so do a few of PyTorch's) or in the named
    namespaces of its headers, under the names their sources define."""
    import re

    from regnet_for_3d_grasping_torch.ops._cuda import CSRC
    texts = [src.read_text() for pattern in ("*.cu", "*.cuh")
             for src in CSRC.glob(pattern)]
    names = {m for t in texts for m in re.findall(r"\b(\w+_kernel)\s*\(", t)}
    spaces = {"(anonymous namespace)"} | {
        m for t in texts for m in re.findall(r"namespace (\w+) \{", t)}
    return [e for e in rows if any(
        f"{s}::{n}" in e.key for s in spaces for n in names)]


def profile_train(args) -> None:
    """The training step as the train CLI runs it: deterministic."""
    from regnet_for_3d_grasping_torch.cli.train import deterministic
    with deterministic():
        _profile_train(args)


def _profile_train(args) -> None:
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from regnet_for_3d_grasping_torch.cli.train import build_model
    from regnet_for_3d_grasping_torch.config import train_config
    from regnet_for_3d_grasping_torch.data import (GraspDataset,
                                                   write_synthetic_dataset)
    from regnet_for_3d_grasping_torch.ops import _cuda
    from regnet_for_3d_grasping_torch.runtime import resolve_device
    from regnet_for_3d_grasping_torch.train import trainer

    dev = resolve_device("cuda")
    B = args.batch_size
    cfg = train_config(**{"train.batch_size": B,
                          "region.slab_cell": args.slab_cell,
                          "model.fps_groups": args.fps_groups,
                          "model.compute_dtype": ("bfloat16" if args.bf16
                                                  else "float32")})
    tmp = tempfile.TemporaryDirectory()
    # the split keeps 80 % for training: make enough for one batch
    write_synthetic_dataset(tmp.name, -(-B * 5 // 4), num_view=25600)
    ds = GraspDataset(tmp.name, "train", 25600, cfg.region.max_gt_grasps, 1)
    batch = trainer.device_batch(next(ds.batches(B, seed=0)), dev)
    model = build_model(cfg, 1, dev)
    opt = trainer.make_optimizer(model, cfg, 1)
    gen = torch.Generator().manual_seed(0)
    drop = torch.Generator(device=dev).manual_seed(0)
    kw = dict(generator=gen, dropout_generator=drop)

    def step() -> tuple:
        t0 = time.perf_counter()
        m = trainer.train_step(model, opt, batch, "refine", **kw)
        loss = float(m["loss_total"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, loss

    warm = [step() for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    untraced = [step() for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    _cuda.reset_launches()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    model.train()
    opt.zero_grad()
    t0 = time.perf_counter()
    with batch_norm_ranges(), profile(activities=acts) as fwd:
        _, total, _ = trainer.forward_losses(model, batch, "refine", **kw)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    with profile(activities=acts) as bwd:
        total.backward()
        opt.step()
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"training step, batch {B}, "
          f"{'slab' if args.slab_cell > 0 else 'full scan'}, "
          f"{cfg.model.compute_dtype}: warm-up "
          f"{[round(t, 1) for t, _ in warm]} ms, untraced "
          f"{[round(t, 3) for t, _ in untraced]} ms (losses "
          f"{[round(v, 4) for _, v in warm + untraced]}), traced forward "
          f"{(t1 - t0) * 1e3:.3f} + backward and update "
          f"{(t2 - t1) * 1e3:.3f} ms")
    print(f"peak device memory of an untraced step: {peak / 2**30:.3f} GiB; "
          f"launches of the port's kernels in the step: "
          f"{ {k: v for k, v in _cuda.launches.items() if v} }; 3-NN "
          f"fallbacks {_cuda.fallbacks['fp3_slab']}")
    mean_untraced = sum(t for t, _ in untraced) / len(untraced)
    busy_all = 0.0
    seqs = batch_norm_seqs(fwd)
    for title, prof, wall in (("forward and losses", fwd, t1 - t0),
                              ("backward and update", bwd, t2 - t1)):
        rows = device_kernels(prof)
        busy = trace.device_timeline(prof)["busy_us"] / 1e3
        busy_all += busy
        gemm = [e for e in rows if is_gemm(e.key)]
        k13 = [e for e in own_kernels(rows) if is_batch_norm(e.key)]
        parts, how = batch_norm_time(prof, prof is fwd, seqs)
        print(f"{title}: device busy {busy:.3f} ms of {wall * 1e3:.3f} ms "
              f"traced wall, {sum(e.count for e in rows)} kernel launches; "
              f"GEMMs {sum(e.self_device_time_total for e in gemm) / 1e3:.3f}"
              f" ms in {sum(e.count for e in gemm)} launches; BatchNorm's "
              f"K13 {sum(e.self_device_time_total for e in k13) / 1e3:.3f} "
              f"ms in {sum(e.count for e in k13)} launches; "
              + "; ".join(f"{t} {parts[k][0]:.3f} ms in {parts[k][1]} "
                          f"launches" for k, t in PARTS)
              + f" ({how}); the five costliest kernels, device ms:")
        for e in rows[:5]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} x{e.count:<5d} "
                  f"{e.key[:90]}")
        for e in own_kernels(rows):
            print(f"  own {e.self_device_time_total / 1e3:7.3f} "
                  f"x{e.count:<5d} {e.key[:90]}")
    print(f"device busy {busy_all:.3f} ms per step: busy share "
          f"{busy_all / mean_untraced:.3f} of the untraced steps' mean "
          f"{mean_untraced:.3f} ms")
    trace.reset()
    with profile(activities=acts) as whole:
        feed = trainer.device_batch(next(ds.batches(B, seed=1)), dev)
        trainer.train_step(model, opt, feed, "refine", **kw)
        torch.cuda.synchronize()
    tmp.cleanup()
    print_spans(whole, 1, "step")


if __name__ == "__main__":
    main()
