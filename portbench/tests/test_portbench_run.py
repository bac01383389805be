"""Whole runs of every cell at a tiny size on the CPU (the card's look
skipped, the rest of a run driven): the last line has the contract's
shape, the checks come last and pass, and a run without a card exits
without a result."""

import json

import pytest

from portbench import harness
from portbench.tests.tiny import run_tiny

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_prints_a_result_line(cell, trace):
    result, line = run_tiny(cell, seed=2**31 + 11, trace=trace)
    keys = list(json.loads(line))
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(cell, bool(trace))}
    assert set(result["metrics"]) <= want
    if not trace:
        assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    if trace:
        assert "busy_s" in result["device"] and "breakdown" in result


def test_same_seed_same_checks():
    a, _ = run_tiny("infer-full-f32", seed=77)
    b, _ = run_tiny("infer-full-f32", seed=77)
    assert a["checks"] == b["checks"]


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from portbench import run
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""
