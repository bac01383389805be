"""Tiny sizes for the CPU tests: the port's ``tiny_config`` widths over a
cell's configuration, small pools, short windows."""

from __future__ import annotations

import dataclasses
import io
import json
from contextlib import redirect_stdout

TINY_TRAFFIC = {"serve": {"pool_clouds": 4, "warmup": 1},
                "train": {"pool_scenes": 10, "batch": 2}}
TINY_CHECK = {"serve": {"sample": 2, "sample_from": 2},
              "train": {}}


def tiny_overrides(cell: dict) -> dict:
    """Every field of the port's `tiny_config` that differs from the
    training preset, over the cell's own overrides (its fps groups set to
    fit the tiny cloud)."""
    from regnet_for_3d_grasping_torch.config import tiny_config, train_config
    tiny, full = dataclasses.asdict(tiny_config()), dataclasses.asdict(
        train_config())
    out = {}
    for section, fields in tiny.items():
        for k, v in fields.items():
            if full[section][k] != v:
                out[f"{section}.{k}"] = v
    out.update(cell.get("overrides", {}))
    if out.get("model.fps_groups", 1) > 1:
        out["model.fps_groups"] = out["region.center_fps_groups"] = 4
    return out


def run_tiny(workload: str, seed: int = 12345, trace: int = 0,
             control: bool = False, seconds: float = 0.5,
             extra: dict | None = None) -> tuple:
    """(result dict, the printed last line) of one CPU run of `workload`
    at tiny sizes."""
    from portbench import harness, run
    cell = harness.load_cell(workload)
    patch = {"overrides": tiny_overrides(cell),
             "traffic": TINY_TRAFFIC[cell["mode"]],
             "check": TINY_CHECK[cell["mode"]], "fresh_weights": True,
             **(extra or {})}
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)] + (["--control"] if control
                                                    else [])
    buf = io.StringIO()
    with redirect_stdout(buf):
        result = run.main(argv, device="cpu", patch=patch)
    line = buf.getvalue().strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(result))
    return result, line
