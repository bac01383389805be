"""The port's spans and counters (``utils/trace.py``) on the CPU at
``tiny_config()``, the benchmark's readers of them, and, on a card, the
check that every wait of a served forward and of a training step goes
through the counted helpers."""

import math
import tempfile
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from regnet_for_3d_grasping_torch.config import tiny_config
from regnet_for_3d_grasping_torch.models.regnet import REGNet
from regnet_for_3d_grasping_torch.train import trainer
from regnet_for_3d_grasping_torch.utils import trace
from regnet_for_3d_grasping_torch.utils.export import extract_grasp_sets

STAGES = ("sn", "grn", "rn")


def _cloud(cfg, B=2, seed=0):
    rng = np.random.RandomState(seed)
    xyz = rng.rand(B, cfg.region.num_points, 3).astype(np.float32) * 0.08
    xyz[..., 2] += 0.75
    return torch.from_numpy(np.concatenate(
        [xyz, rng.rand(B, cfg.region.num_points, 3).astype(np.float32)], -1))


@pytest.fixture(scope="module")
def served():
    """Two traced requests (forward and extraction) of the tiny model:
    (totals, the profile)."""
    cfg = tiny_config()
    torch.manual_seed(0)
    model = REGNet(cfg).eval()
    x, gen = _cloud(cfg), torch.Generator().manual_seed(0)
    with torch.inference_mode():
        extract_grasp_sets(model(x, generator=gen))      # untraced
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                extract_grasp_sets(model(x, generator=gen))
    return trace.totals(), prof


def _cpu():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh_registry():
    """Each test's traced window reads alone (two windows with no untraced
    span between them would read as one)."""
    trace.reset()


def test_a_span_outside_a_profiler_records_nothing():
    trace.reset()
    with trace.span("sn"):
        with trace.waiting("x"):
            pass
    trace.to_host(torch.ones(2), "y")
    trace.count("read_bytes", 10)
    tot = trace.totals()
    assert tot["spans"] == {} and tot["syncs"] == 0
    assert tot["counters"] == {} and tot["units"] == 0


def test_forward_spans_nest_with_one_id_a_request(served):
    tot, _ = served
    spans = tot["spans"]
    assert spans["regnet"]["parents"] == {None: 2}
    assert spans["extract"]["parents"] == {None: 2}
    for name in STAGES:
        assert spans[name]["parents"] == {"regnet": 2}
    for name in ("regnet", "extract") + STAGES:
        assert spans[name]["calls"] == 2 and spans[name]["units"] == 2
    # one id a request: the forward and the extraction are its two
    # outermost spans
    assert tot["units"] == 4


def test_self_time_is_duration_less_the_children(served):
    spans = served[0]["spans"]
    children = sum(spans[n]["host_ms"] for n in STAGES)
    r = spans["regnet"]
    assert math.isclose(r["self_ms"], r["host_ms"] - children,
                        abs_tol=1e-9)
    assert 0 < r["self_ms"] < r["host_ms"]
    for name in STAGES:
        assert spans[name]["self_ms"] == spans[name]["host_ms"]
        assert spans[name]["stream_ms"] is None      # no card


def test_spans_are_profiler_ranges_nested_the_same_way(served):
    _, prof = served
    ranges = [e for e in prof.events() if e.name.startswith(trace.RANGE)]
    by_name: dict = {}
    for e in ranges:
        by_name.setdefault(e.name[len(trace.RANGE):], []).append(e)
    assert {n: len(v) for n, v in by_name.items()} == {
        "regnet": 2, "sn": 2, "grn": 2, "rn": 2, "extract": 2}
    for name in STAGES:
        for e in by_name[name]:
            p = e.cpu_parent
            while p is not None and not p.name.startswith(trace.RANGE):
                p = p.cpu_parent
            assert p is not None and p.name == trace.RANGE + "regnet"
    for e in by_name["regnet"] + by_name["extract"]:
        p = e.cpu_parent
        while p is not None and not p.name.startswith(trace.RANGE):
            p = p.cpu_parent
        assert p is None


def test_extraction_reads_are_counted_waits(served):
    tot = served[0]
    assert tot["spans"]["extract"]["self_syncs"] == 10
    assert {w: s["syncs"] for w, s in tot["sites"].items()
            if w.startswith("extract.")} == {
        f"extract.{k}": 2 for k in ("proposals", "final_grasps",
                                    "region_valid", "refine_accept",
                                    "score_accept")}
    assert tot["syncs"] == sum(s["syncs"] for s in tot["sites"].values())


def test_waits_are_counted_and_timed():
    with _cpu():
        with trace.span("extract"):
            trace.to_host(torch.ones(3), "a")
            with trace.waiting("b"):
                time.sleep(0.003)
            up = trace.to_device(torch.ones(2), "meta", "c")
            here = torch.ones(2)
            # on its device already: no copy, no wait, not counted
            assert trace.to_device(here, "cpu", "c") is here
        trace.to_host(torch.ones(1), "a")
    tot = trace.totals()
    assert tot["syncs"] == 4 and up.shape == (2,) and up.is_meta
    assert {w: s["syncs"] for w, s in tot["sites"].items()} == {
        "a": 2, "b": 1, "c": 1}
    assert tot["sites"]["b"]["wait_ms"] >= 3.0
    ext = tot["spans"]["extract"]
    assert ext["self_syncs"] == ext["syncs"] == 3
    assert ext["wait_ms"] >= 3.0 and ext["wait_ms"] <= ext["host_ms"]
    assert tot["wait_ms"] >= ext["wait_ms"]


def test_a_new_window_forgets_the_last():
    with _cpu():
        with trace.span("sn"):
            pass
    with trace.span("sn"):                   # untraced: the window ends
        pass
    with _cpu():
        with trace.span("grn"):
            pass
    assert set(trace.totals()["spans"]) == {"grn"}


def test_training_step_and_input_spans():
    cfg = tiny_config()
    from regnet_for_3d_grasping_torch.data import (GraspDataset,
                                                   write_synthetic_dataset)
    torch.manual_seed(0)
    model = REGNet(cfg)
    opt = trainer.make_optimizer(model, cfg, 1)
    with tempfile.TemporaryDirectory() as d:
        write_synthetic_dataset(d, 4, num_view=cfg.region.num_points)
        ds = GraspDataset(d, "train", cfg.region.num_points,
                          cfg.region.max_gt_grasps, 1)
        feed = ds.batches(2, seed=0)
        with _cpu():
            batch = next(feed)
            db = trainer.device_batch(batch, "cpu")
            trainer.train_step(model, opt, db, "refine",
                               generator=torch.Generator().manual_seed(1),
                               dropout_generator=torch.Generator()
                               .manual_seed(1))
        import os
        read = sum(os.path.getsize(p) for p in batch.paths)
    tot = trace.totals()
    spans = tot["spans"]
    for name in ("forward", "backward", "update"):
        assert spans[name]["parents"] == {"step": 1}
    assert spans["regnet"]["parents"] == {"forward": 1}
    for name in STAGES:
        assert spans[name]["parents"] == {"regnet": 1}
    assert spans["data.read"]["parents"] == {"data.prep": 2}
    assert spans["data.read"]["units"] == 1
    assert spans["data.prep"]["self_ms"] < spans["data.prep"]["host_ms"]
    # the batch stays on the CPU: no copy, no counted wait (the card test
    # counts the five uploads)
    assert spans["data.upload"]["calls"] == 1
    assert spans["data.upload"]["self_syncs"] == 0
    assert tot["counters"] == {
        "read_bytes": read,
        "upload_bytes": sum(getattr(batch, f).nbytes
                            for f in trainer.DeviceBatch._fields)}


def test_device_timeline_is_the_union_with_labelled_gaps():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, start, end, dev, note=False):
        return types.SimpleNamespace(
            name=name, device_type=dev, is_user_annotation=note,
            time_range=types.SimpleNamespace(start=start, end=end))
    events = [ev("k1", 0, 10, cuda), ev("k2", 5, 12, cuda),   # overlap
              ev("k3", 20, 25, cuda), ev("k4", 60, 70, cuda),
              ev(trace.RANGE + "sn", 0, 30, cuda, True),      # a range
              ev(trace.RANGE + "regnet", 0, 80, cpu, True),
              ev(trace.RANGE + "grn", 30, 50, cpu, True)]
    tl = trace.device_timeline(types.SimpleNamespace(events=lambda: events))
    assert tl["busy_us"] == 12 + 5 + 10
    assert tl["gaps"] == [["grn", 35], ["regnet", 8]]


# the benchmark's readers of the spans and counters --------------------
READERS = {   # metric base: (mode, totals -> value before the division)
    "sn_ms": ("serve", lambda t: t["spans"]["sn"]["stream_ms"]),
    "grn_ms": ("serve", lambda t: t["spans"]["grn"]["stream_ms"]),
    "rn_ms": ("serve", lambda t: t["spans"]["rn"]["stream_ms"]),
    "host_ms": ("serve", lambda t: sum(
        t["spans"][n]["host_ms"] - t["spans"][n]["wait_ms"]
        for n in ("regnet", "extract"))),
    "sync_ms": (None, lambda t: t["wait_ms"]),
    "syncs": (None, lambda t: t["syncs"]),
    "read_ms": ("train", lambda t: t["spans"]["data.read"]["host_ms"]),
    "prep_ms": ("train", lambda t: t["spans"]["data.prep"]["self_ms"]),
    "upload_ms": ("train", lambda t: t["spans"]["data.upload"]["host_ms"]),
    "forward_ms": ("train", lambda t: t["spans"]["forward"]["stream_ms"]),
    "backward_ms": ("train", lambda t: t["spans"]["backward"]["stream_ms"]),
    "update_ms": ("train", lambda t: t["spans"]["update"]["stream_ms"]),
}


def _filled() -> dict:
    """Totals with every span the readers read, distinct numbers."""
    spans = {}
    for i, name in enumerate(("regnet", "extract", "sn", "grn", "rn",
                              "data.read", "data.prep", "data.upload",
                              "forward", "backward", "update")):
        spans[name] = {"host_ms": 10.0 + i, "self_ms": 3.0 + i,
                       "stream_ms": 20.0 + 2 * i, "wait_ms": 0.5 + i / 8}
    return {"spans": spans, "syncs": 21, "wait_ms": 7.25}


def _new_metrics():
    import json
    from pathlib import Path
    m = json.loads((Path(__file__).resolve().parents[1]
                    / "BENCHMARK.json").read_text())
    return [e["name"] for e in m["per_layer"]
            if e["name"].split(".")[0] in READERS]


@pytest.mark.parametrize("metric", _new_metrics())
def test_reader_per_unit_and_none_in_the_other_mode(metric, monkeypatch):
    from portbench import harness
    mode, value = READERS[metric.split(".")[0]]
    tot = _filled()
    monkeypatch.setattr(trace, "totals", lambda: tot)
    read = harness.reader(metric).read
    suffix = metric.partition(".")[2]
    own = "train" if suffix == "train" else "serve"
    assert mode in (None, own)
    ctx = {"mode": own, "per_unit": 4, "suffix": suffix}
    assert read(ctx) == pytest.approx(value(tot) / 4)
    if mode is not None:
        other = {"serve": "train", "train": "serve"}[mode]
        assert read({**ctx, "mode": other}) is None
    assert read({**ctx, "per_unit": 0}) is None
    monkeypatch.setattr(trace, "totals", lambda: {"spans": {}})
    assert read(ctx) is None


@pytest.mark.parametrize("missing", [
    "regnet_for_3d_grasping_torch.utils.trace", "zstandard"])
def test_readers_find_nothing_only_where_the_module_is_missing(
        missing, monkeypatch):
    """Without the port's tracing module (the parent tree) the readers
    find nothing; a fault inside it, such as a module it imports that is
    missing, raises."""
    from portbench.metrics import _program

    def absent(name):
        raise ModuleNotFoundError(f"No module named {missing!r}",
                                  name=missing)
    monkeypatch.setattr(_program.importlib, "import_module", absent)
    if missing == _program.MODULE:
        assert _program.totals() is None
    else:
        with pytest.raises(ModuleNotFoundError):
            _program.totals()


def test_all_twenty_metrics_have_readers():
    assert len(_new_metrics()) == 20


# on a card ---------------------------------------------------------------
class _StrictWait(trace._Wait):
    """A counted wait that lifts ``set_sync_debug_mode("error")`` while it
    waits, so that only a sync outside the helpers raises."""

    __slots__ = ()

    def __enter__(self):
        torch.cuda.set_sync_debug_mode(0)
        super().__enter__()

    def __exit__(self, kind, value, tb):
        super().__exit__(kind, value, tb)
        torch.cuda.set_sync_debug_mode("error")


def test_card_every_wait_goes_through_the_counted_helpers(monkeypatch):
    """Both served configurations' forwards with the extraction, and a bf16
    training step at batch 12 with its upload, under
    ``set_sync_debug_mode("error")`` while tracing: a sync outside
    `to_host` / `to_device` / `waiting` raises.  The counts a request or a
    step repeat, and are printed (``-s``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    monkeypatch.setattr(trace, "_Wait", _StrictWait)
    from pathlib import Path

    from regnet_for_3d_grasping_torch.cli.train import deterministic
    from regnet_for_3d_grasping_torch.config import (infer_config,
                                                     train_config)
    from regnet_for_3d_grasping_torch.data import (GraspDataset,
                                                   write_synthetic_dataset)
    from regnet_for_3d_grasping_torch.models.regnet import build_regnet
    from regnet_for_3d_grasping_torch.utils.scene import tabletop_cloud
    weights = Path(__file__).resolve().parents[1] / "weights" / \
        "r5_real_e100.npz"

    def clouds(k):
        out = []
        for i in range(k):
            rng = np.random.RandomState(300 + i)
            xyz, rgb = tabletop_cloud(rng, 25600 + 64)
            keep = rng.choice(len(xyz), 25600, replace=False)
            out.append(np.c_[xyz, rgb][keep].astype(np.float32))
        return torch.from_numpy(np.stack(out)).cuda()

    def counted(fn):
        """Syncs and their sites of each of two calls of `fn`."""
        counts = []
        for _ in range(2):
            torch.cuda.synchronize()
            trace.reset()
            with _cpu():
                torch.cuda.set_sync_debug_mode("error")
                try:
                    fn()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            tot = trace.totals()
            counts.append((tot["syncs"], {w: s["syncs"] for w, s
                                          in tot["sites"].items()}))
        return counts

    fast = {"region.slab_cell": 0.04, "model.fps_groups": 8,
            "region.center_fps_groups": 8, "model.compute_dtype": "bfloat16"}
    for name, over, batch in (("infer-full-f32", {}, 1),
                              ("infer-fast-b8", fast, 8)):
        model = build_regnet(infer_config(**over), str(weights), "cuda")
        x = clouds(batch)
        gen = torch.Generator().manual_seed(1)

        def request():
            with torch.inference_mode():
                extract_grasp_sets(model(x, generator=gen))
        request()
        a, b = counted(request)
        print(f"{name}: {a[0]} syncs a request: {a[1]}")
        assert a == b and a[0] >= 5
        del model

    cfg = train_config(**{"model.compute_dtype": "bfloat16"})
    with deterministic(), tempfile.TemporaryDirectory() as d:
        write_synthetic_dataset(d, 15, num_view=25600)
        ds = GraspDataset(d, "train", 25600, cfg.region.max_gt_grasps, 1)
        host = next(ds.batches(12, seed=0))
        torch.manual_seed(0)
        model = REGNet(cfg).cuda()
        opt = trainer.make_optimizer(model, cfg, 1)
        drop = torch.Generator(device="cuda")

        def step():
            db = trainer.device_batch(host, "cuda")
            drop.manual_seed(5)
            trainer.train_step(model, opt, db, "refine",
                               generator=torch.Generator().manual_seed(5),
                               dropout_generator=drop)
        step()
        a, b = counted(step)
        print(f"train-bf16-b12: {a[0]} syncs a step: {a[1]}")
        assert a == b and a[1]["data.upload"] == 5
