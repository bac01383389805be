"""The cells' modes: ``serve`` (requests through ``REGNet.forward`` and
``extract_grasp_sets``) and ``train`` (``train/trainer.train_step``).  A
cell's workload file names its mode; `Run` is what the modes share: the
window, its profile in a traced run, and the result line."""

from __future__ import annotations

import dataclasses
import hashlib
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import harness


def sub_seed(seed: int, *keys: int) -> int:
    """A 32-bit seed drawn from the run's seed and `keys` (any size of
    seed: numpy's SeedSequence takes arbitrary integers)."""
    mask = 2**64 - 1
    return int(np.random.SeedSequence([k & mask for k in (seed, *keys)])
               .generate_state(1)[0])


@dataclasses.dataclass
class Run:
    cell: dict
    args: object
    chips: int
    start_s: float
    device: torch.device
    patch: dict
    cache: Path

    def __post_init__(self):
        self.traffic = {**self.cell["traffic"],
                        **self.patch.get("traffic", {})}
        self.check = {**self.cell["check"], **self.patch.get("check", {})}
        self.spans = harness.Spans(traced=bool(self.args.trace))
        self.trace = None
        self.memory_peak = 0

    # -- the port's configuration --------------------------------------
    def overrides(self) -> dict:
        return {**self.cell.get("overrides", {}),
                **self.patch.get("overrides", {})}

    def config(self, config_module):
        cell = {**self.cell, "overrides": self.overrides()}
        return harness.build_config(config_module, cell)

    # -- the window ----------------------------------------------------
    def window_seconds(self) -> float:
        s = float(self.args.seconds)
        if self.args.trace:
            s = min(s, float(self.cell.get("trace_seconds", s)))
        return s

    def measure(self, one, units_of, stop=None) -> dict:
        """Calls `one(i)` for i = 0, 1, ... until the window's seconds
        have passed (a call started inside the window finishes; `stop`,
        where given, decides from the seconds elapsed and the window's),
        with the profiler and the roofline wrappers on in a traced run.
        -> {"n", "window_s"}; `units_of(n)` counts the forwards or
        steps."""
        seconds = self.window_seconds()
        prof = roof = None
        if self.args.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            roof = harness.Rooflines().__enter__()
            prof = profile(activities=acts)
            prof.start()
        self.sync()
        t0 = time.perf_counter()
        n = 0
        try:
            while True:
                one(n)
                n += 1
                elapsed = time.perf_counter() - t0
                if (elapsed >= seconds if stop is None
                        else stop(elapsed, seconds)):
                    break
            self.sync()
            t1 = time.perf_counter()
        finally:
            if prof is not None:
                prof.stop()
                roof.__exit__(None, None, None)
        window = t1 - t0
        if prof is not None:
            self.trace = harness.analyse_trace(
                prof, roof, window, harness.own_kernel_names())
            self.trace["units"] = units_of(n)
            del prof
        return {"n": n, "window_s": window}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def read_memory(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)

    def phase(self, name: str) -> None:
        """Prints the set-up's seconds so far at the end of phase `name`
        (standard error), so that set-up's parts show."""
        print(f"set-up {name}: {self.setup_seconds():.3f} s",
              file=sys.stderr)

    def setup_seconds(self) -> float:
        """From the process's start (the caller's, on several ranks) to
        now."""
        return time.time() - self.start_s

    def free(self) -> None:
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the result ----------------------------------------------------
    def result(self, end_to_end: dict, ctx: dict, checks: dict,
               attempted: int, failed: int) -> dict:
        """The result line: the cell's end-to-end metrics, or traced its
        per-layer metrics (a reader that finds nothing leaves its metric
        out), the device, the breakdown and the checks, last."""
        metrics = {}
        for m in harness.cell_metrics(self.cell["name"],
                                      bool(self.args.trace)):
            if self.args.trace:
                value = harness.reader(m["name"]).read(
                    {**ctx, **(self.trace or {}),
                     "suffix": m["name"].partition(".")[2]})
            else:
                value = end_to_end.get(m["name"])
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        dev = {"platform": "gpu" if self.device.type == "cuda" else "cpu",
               "kind": (torch.cuda.get_device_name(0)
                        if self.device.type == "cuda" else "cpu"),
               "count": self.chips, "memory_peak_bytes": self.memory_peak}
        out = {"correct": bool(correct), "attempted": attempted,
               "failed": failed, "metrics": metrics, "device": dev}
        if self.args.trace and self.trace is not None:
            for fn, (bound, device) in self.trace["roofline"].items():
                print(f"roofline {fn}: bound {bound!r} s, device {device!r} s",
                      file=sys.stderr)
            dev["busy_s"] = self.trace["busy_s"]
            dev["window_s"] = self.trace["window_s"]
            out["breakdown"] = {
                "device_ops": [[n, s] for n, s in
                               self.trace["device_ops"][:10]],
                "idle_gaps": self.trace["idle_gaps"]}
        out["checks"] = checks
        return out


def file_key(*paths: Path, extra: str = "") -> str:
    """A short hash of files' bytes and `extra` (a cache's name)."""
    h = hashlib.sha256(extra.encode())
    for p in paths:
        h.update(Path(p).read_bytes())
    return h.hexdigest()[:16]
