"""One run of one benchmark cell of the PyTorch port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Finds ``portbench/workloads/<cell>.json`` and its configuration, drives the
cell's mode (``portbench/modes/<mode>.py``) on the card: set-up (inputs and
weights from the seed, every shape warmed), then the measured window of
``--seconds``, then the check of the window's outputs against the plain
reference (``portbench/reference``).  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics read from a profile of the window), ``device`` and, traced,
``breakdown``; the numbers compared, each beside its limit, come last in it
under ``checks`` and as the last lines of standard error.

Exits non-zero, with no result, where no card (or fewer than the cell asks
for) is visible, and where ``jax``, ``jaxlib``, ``flax`` or the JAX package
was loaded.  Kernel builds and the scene pool live in ``.portbench_cache/``
inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"


def _environment() -> None:
    """Build caches at fixed paths inside the checkout."""
    os.environ["REGNET_TORCH_CACHE"] = str(CACHE / "kernels")
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "extensions"))


def parse(argv):
    p = argparse.ArgumentParser(description="one run of a benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the reference at the control precision in the "
                        "program's place (for setting the limits; the "
                        "benchmark's own runs never pass it)")
    return p.parse_args(argv)


def main(argv=None, device: str | None = None, patch: dict | None = None
         ) -> dict:
    """One run; returns the result it printed.  `device` and `patch`
    (configuration, traffic and check overrides, and a fault to plant) let
    the CPU tests and ``calibrate.py`` drive a run: the benchmark never
    passes them."""
    import time

    from portbench import harness
    start_s = time.time() - harness.process_seconds()
    args = parse(argv)
    _environment()
    import torch
    cell = harness.load_cell(args.workload)
    # the manifest's chips; a workload file not yet in it states its own
    chips = cell.get("chips", 1)
    for w in harness.manifest()["workloads"]:
        if w["name"] == args.workload:
            chips = w["chips"]
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: torch.cuda.is_available() "
                             "is False")
        if torch.cuda.device_count() < chips:
            raise SystemExit(f"{args.workload} needs {chips} cards, "
                             f"{torch.cuda.device_count()} visible")
    import importlib
    mode = importlib.import_module(f"portbench.modes.{cell['mode']}")
    if chips == 1 and patch and patch.get("fault"):
        from portbench.faults import plant
        plant(patch["fault"])
    run = mode.Run(cell=cell, args=args, chips=chips, start_s=start_s,
                   device=torch.device(device or "cuda"), patch=patch or {},
                   cache=CACHE)
    result = run.execute()
    found = harness.forbidden_modules()
    if found:
        raise SystemExit(f"modules that a run may not load were loaded: "
                         f"{', '.join(found)}")
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return result


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()
