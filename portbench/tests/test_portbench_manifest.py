"""BENCHMARK.json against the contract's shape, and every cell's files
found by name."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51
    assert 1 <= len(M["paths"]) <= 16
    assert len(M["command"]) <= 32
    for word in M["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word.split("/")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_allowed(kind):
    names = [e["name"] for e in M[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_names_unique_across_kinds():
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in M[k]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("m", M["end_to_end"] + M["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    cells = {w["name"] for w in M["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moves = {e["name"]: e for e in M["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moves.get("workloads", cells))
        harness.reader(m["name"])           # its reader exists


def test_setup_metric_and_every_cell_reports_enough():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in M["workloads"]:
        mine = [m for m in M["end_to_end"] if w["name"] in
                m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        assert harness.cell_metrics(w["name"], True)


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    assert w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    cell = harness.load_cell(w["name"])
    assert cell["config"] == w["config"]
    assert (ROOT / "portbench" / "modes" / f"{cell['mode']}.py").is_file()
    assert set(cell["check"]["limits"])


@pytest.mark.parametrize("c", M["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("portbench/")
    data = json.loads((ROOT / c["file"]).read_text())
    assert data["name"] == c["name"]
    assert c["reduced"] == []
    assert any(w["config"] == c["name"] for w in M["workloads"])
    files = [x["file"] for x in M["configs"]]
    assert len(files) == len(set(files))


def test_check_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
