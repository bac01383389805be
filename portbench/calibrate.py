"""The readings that a cell's limits are set from: the numbers compared in
runs of the program over many seeds, and in runs of the control (the
reference at the control precision in the program's place) over a few,
all in one process so that set-up is paid once for the build.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 7,8,9] [--fault half_batch --fault-seeds 4,5,6]
        [--seconds 3] [--out readings.json]

Prints each run's numbers and, per number, the largest over the program's
runs (the lower reading), the smallest over the control's and over each
planted fault's (``faults.py``; planted last: a fault patches the port for
the process's life).  The benchmark's own runs never run the control or a
fault.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path


def _run(workload, seed, seconds, control, fault=None):
    from portbench import run
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", "0"] + (["--control"] if control else [])
    buf = io.StringIO()
    t0 = time.perf_counter()
    patch = {"fault": f"portbench.faults:{fault}"} if fault else None
    with redirect_stdout(buf):
        result = run.main(argv, patch=patch)
    return result, time.perf_counter() - t0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    runs = []
    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds),
                        (args.fault, args.fault_seeds)):
        for s in [int(x) for x in seeds.split(",") if x]:
            result, wall = _run(args.workload, s, args.seconds,
                                kind == "control",
                                None if kind in ("program", "control")
                                else kind)
            row = {"seed": s, "kind": kind, "wall_s": wall,
                   "correct": result["correct"],
                   "numbers": {k: v["value"]
                               for k, v in result["checks"].items()},
                   "metrics": {k: v["value"]
                               for k, v in result["metrics"].items()}}
            runs.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    names = runs[0]["numbers"].keys()
    summary = {}
    kinds = list(dict.fromkeys(r["kind"] for r in runs))
    for k in names:
        summary[k] = {"lower": max(r["numbers"][k] for r in runs
                                   if r["kind"] == "program")}
        for kind in kinds:
            vals = [r["numbers"][k] for r in runs if r["kind"] == kind]
            summary[k][kind] = vals
            if kind != "program":
                summary[k][f"{kind}_least"] = min(vals)
    out = {"workload": args.workload, "runs": runs, "summary": summary}
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(summary))
    return out


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    main()
