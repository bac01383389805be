"""What every cell's run shares: its files found by name, the port's
configuration built from them, host spans, the function wrappers behind the
roofline files, the reading of the profiler's trace, the result line, and
the check that no JAX module was loaded.

A cell is ``workloads/<cell>.json`` (its configuration's name, its mode and
its traffic parameters), its configuration ``configs/<config>.json``, its
mode ``modes/<mode>.py``; a per-layer metric is ``metrics/<name>.py`` (or,
for ``<base>.<suffix>``, ``metrics/<base>.py``), and a counted function is
``rooflines/<function>.py``.  Nothing here is edited to add one of them.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "regnet_for_3d_grasping_tpu")
PORT = "regnet_for_3d_grasping_torch"
# NVIDIA's data sheet, H100 SXM, dense: bytes/s of HBM3 and FLOP/s by the
# dtype the work is done in (f32 outside the tensor cores: the port turns
# TF32 off)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
RANGE = "portbench::"


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def load_cell(name: str) -> dict:
    """The cell's workload file with its configuration file under
    ``"config_file"``."""
    path = BENCH / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no workload file {path.relative_to(ROOT)}")
    cell = read_json(path)
    cell["name"] = name
    cell["config_file"] = read_json(BENCH / "configs" /
                                    f"{cell['config']}.json")
    return cell


def config_overrides(cell: dict) -> dict:
    """Every field of the configuration file as ``section.field``, lists
    as tuples, then the cell's own overrides."""
    out = {}
    for section in ("gripper", "model", "region", "eval", "train"):
        for key, val in cell["config_file"][section].items():
            out[f"{section}.{key}"] = _tuples(val)
    out.update({k: _tuples(v) for k, v in cell.get("overrides", {}).items()})
    return out


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def build_config(config_module, cell: dict):
    """The cell's PipelineConfig from `config_module` (the port's or the
    reference's ``config``), every field checked against the file."""
    preset = getattr(config_module, cell["config_file"]["preset"])
    cfg = preset(**config_overrides(cell))
    for key, val in config_overrides(cell).items():
        section, field = key.split(".")
        if getattr(getattr(cfg, section), field) != val:
            raise ValueError(f"config field {key} is not {val!r}")
    return cfg


def cell_metrics(cell: str, trace: bool) -> list:
    """The manifest's metrics that this cell reports: with `trace` its
    per-layer metrics, else its end-to-end ones."""
    out = []
    for m in manifest()["per_layer" if trace else "end_to_end"]:
        if cell in m.get("workloads", [cell]):
            out.append(m)
    return out


def reader(name: str):
    """The per-layer metric's reader module: ``metrics/<name>.py``, else
    ``metrics/<base>.py`` for ``<base>.<suffix>``."""
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.is_file():
            return _load(path, f"portbench_metric_{stem.replace('.', '_')}")
    raise SystemExit(f"no reader for metric {name} under portbench/metrics")


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Top-level names in `sys.modules` that a run may not load, compared
    whole (the port's name begins with the JAX package's)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Spans:
    """Host spans of the harness: each name's durations in seconds, and in
    a traced run a profiler range ``portbench::<name>`` around each."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import record_function
            rf = record_function(RANGE + name)
        t0 = time.perf_counter()
        with rf:
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def total_ms(self, name: str) -> float:
        return 1e3 * sum(self.seconds.get(name, ()))


class Rooflines:
    """The functions of ``rooflines/*.py`` wrapped, in a traced run, in a
    profiler range ``portbench::roofline::<function>`` each call, with the
    bound of the call (the larger of its bytes over the HBM's rate and its
    operations over the dtype's peak), forward and, where an input needs a
    gradient, backward: the autograd nodes whose sequence numbers the
    forward's operations carry are the function's in the backward."""

    PREFIX = RANGE + "roofline::"

    def __init__(self):
        self.files = {p.stem: _load(p, f"portbench_roofline_{p.stem}")
                      for p in sorted((BENCH / "rooflines").glob("*.py"))
                      if not p.name.startswith("_")}
        self.calls: dict = {name: [] for name in self.files}
        self._saved = []

    def __enter__(self):
        for name, mod in self.files.items():
            for module_name, attr in mod.TARGETS:
                module = importlib.import_module(module_name)
                orig = getattr(module, attr)
                self._saved.append((module, attr, orig))
                setattr(module, attr, self._wrap(name, mod, orig))
        return self

    def __exit__(self, *exc):
        for module, attr, orig in reversed(self._saved):
            setattr(module, attr, orig)
        self._saved = []

    def _wrap(self, name, mod, orig):
        from torch.profiler import record_function

        def wrapped(*args, **kwargs):
            with record_function(self.PREFIX + name):
                out = orig(*args, **kwargs)
            self.calls[name].append(mod.cost(args, kwargs, out))
            return out
        return wrapped

    def bound_s(self, name: str) -> float:
        """Σ over the calls of the bound of each part (forward, backward
        where the call had one)."""
        total = 0.0
        for parts in self.calls[name]:
            for nbytes, flops, dtype in parts:
                total += max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])
        return total


def _ancestors(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def analyse_trace(prof, rooflines: Rooflines | None, t_window: float,
                  own_names: tuple) -> dict:
    """What the readers read from a profile of the window: device busy
    seconds (the union of the device's activity intervals), each kernel's
    seconds, the longest idle gaps by the harness range open on the host
    (the innermost), and each roofline function's device seconds."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    # the device's work: kernels, copies and sets, not the ranges that
    # record_function (and NCCL's "nccl:" ranges) show on its timeline
    device = [e for e in events if e.device_type == cuda
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith((RANGE, "nccl:"))]
    launches = {e.id: e for e in events if e.device_type != cuda
                and e.id > 0 and ("Launch" in e.name or "Memcpy" in e.name
                                  or "Memset" in e.name)}
    intervals = sorted((e.time_range.start, e.time_range.end)
                       for e in device)
    busy_us, gaps, cur = 0.0, [], None
    for s, t in intervals:
        if cur is None:
            cur = [s, t]
        elif s > cur[1]:
            busy_us += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy_us += cur[1] - cur[0]
    by_name: dict = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e6
    # host ranges of the harness on the host, for the idle gaps' labels
    ranges = sorted(((e.time_range.start, e.time_range.end,
                      e.name[len(RANGE):]) for e in events
                     if e.device_type != cuda and e.name.startswith(RANGE)
                     and not e.name.startswith(Rooflines.PREFIX)),
                    key=lambda r: r[0])
    gap_list = []
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + t) / 2
        inner = [r for r in ranges if r[0] <= mid <= r[1]]
        label = min(inner, key=lambda r: r[1] - r[0])[2] if inner else \
            "no harness range"
        gap_list.append([label, (t - s) / 1e6])
    roof = {}
    if rooflines is not None and rooflines.files:
        roof = _roofline_device_s(events, device, launches, rooflines)
    gemm_s = sum(s for n, s in by_name.items() if is_gemm(n))
    own_s = sum(s for n, s in by_name.items() if _is_own(n, own_names))
    return {"busy_s": busy_us / 1e6, "window_s": t_window,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "gemm_s": gemm_s, "own_s": own_s, "idle_gaps": gap_list,
            "roofline": roof}


def _roofline_device_s(events, device, launches, rooflines) -> dict:
    """{function: (bound s, device s)}: a kernel is the function's where
    its launch lies inside the function's range (forward) or inside an
    autograd node whose sequence number an operation inside that range
    carries (backward)."""
    seqs: dict = {}
    for e in events:
        if e.sequence_nr is None or e.sequence_nr < 0:
            continue
        for a in _ancestors(e.cpu_parent):
            if a.name.startswith(Rooflines.PREFIX):
                seqs.setdefault(a.name, set()).add(e.sequence_nr)
                break
    dev_s = dict.fromkeys(rooflines.files, 0.0)
    for k in device:
        r = launches.get(k.id)
        if r is None:
            continue
        name = None
        for a in _ancestors(r):
            if a.name.startswith(Rooflines.PREFIX):
                name = a.name
                break
            if a.name.startswith("autograd::engine") and a.sequence_nr >= 0:
                name = next((n for n, s in seqs.items()
                             if a.sequence_nr in s), None)
                if name is not None:
                    break
        if name is not None:
            fn = name[len(Rooflines.PREFIX):]
            dev_s[fn] += (k.time_range.end - k.time_range.start) / 1e6
    return {fn: (rooflines.bound_s(fn), s) for fn, s in dev_s.items()}


def is_gemm(name: str) -> bool:
    """A matrix-product kernel of cuBLAS (its own, CUTLASS's or the
    architecture's generated kernels); the port's ``cli/profile.is_gemm``."""
    return any(k in name.lower() for k in ("gemm", "xmma", "cutlass",
                                            "cublas", "sm90_", "nvjet"))


def own_kernel_names() -> tuple:
    """(kernel names, namespaces) that the port's ``csrc/`` sources define
    (the port's ``cli/profile.own_kernels`` reads them the same way)."""
    import re
    csrc = ROOT / PORT / "csrc"
    texts = [p.read_text() for pat in ("*.cu", "*.cuh")
             for p in csrc.glob(pat)]
    names = {m for t in texts for m in re.findall(r"\b(\w+_kernel)\s*\(", t)}
    spaces = {"(anonymous namespace)"} | {
        m for t in texts for m in re.findall(r"namespace (\w+) \{", t)}
    return names, spaces


def _is_own(name: str, own: tuple) -> bool:
    names, spaces = own
    return any(f"{s}::{n}" in name for s in spaces for n in names)


def process_seconds() -> float:
    """Seconds since this process started, from ``/proc`` (the clock
    ticks of its start against the system's uptime)."""
    import os
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return max(up - start, 0.0)


def quantile(values, q: float) -> float:
    """The `q` quantile of `values` by linear interpolation between the
    order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
