"""The comparison fails a broken program: a tiny run on the CPU with the
timed path broken underneath, for each fault a cell can have, sees
``correct`` come out false, where the same run unbroken passes."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.tests.tiny import run_tiny

SEED = 2**31 + 5
ROOT = Path(__file__).resolve().parents[2]


def test_unbroken_runs_pass():
    for cell in ("infer-full-f32", "infer-fast-b8", "train-bf16-b12",
                 "train-bf16-dp4"):
        assert run_tiny(cell, seed=SEED)[0]["correct"] is True


@pytest.mark.parametrize("cell,fault", [
    ("infer-full-f32", "answer_altered"), ("infer-fast-b8", "answer_altered"),
    ("train-bf16-b12", "state_unchanged"), ("train-bf16-b12", "half_batch"),
    ("train-bf16-dp4", "state_unchanged"), ("train-bf16-dp4", "half_batch"),
    ("train-bf16-dp4", "no_exchange")])
def test_a_planted_fault_fails_the_check(cell, fault):
    """Each fault the cell can have, planted underneath a tiny run (in a
    fresh process: a fault patches the port for the process's life)."""
    code = (
        "import json\n"
        "from portbench.tests.tiny import run_tiny\n"
        f"r, _ = run_tiny({cell!r}, seed={SEED}, "
        f"extra={{'fault': 'portbench.faults:{fault}'}})\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is False
    if fault == "answer_altered":
        assert result["checks"]["grasp_mismatch"]["value"] == 1.0
    if fault == "state_unchanged":
        assert result["checks"]["update_gap"]["value"] == pytest.approx(1.0)
    if fault == "no_exchange":
        assert result["checks"]["rank_gap"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", ["infer-full-f32", "infer-fast-b8",
                                  "train-bf16-b12", "train-bf16-dp4"])
def test_the_control_fails_at_the_cells_own_size(card, cell):
    """The reference at the control precision in the program's place, at
    the cell's own size on the card, comes out not correct."""
    import io
    from contextlib import redirect_stdout

    from portbench import harness, run
    chips = harness.load_cell(cell).get("chips", 1)
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} cards")
    with redirect_stdout(io.StringIO()):
        result = run.main(["--workload", cell, "--seed", str(SEED),
                           "--seconds", "2", "--control"])
    assert result["correct"] is False


def test_the_controls_rounding_is_below_the_configured_precision():
    from portbench.reference.regnet_ref.nn import layers
    x = torch.randn(1000)
    x = x.sign() * x.abs().clamp(0.02, 400.0)   # fp8 e4m3's normal range
    try:
        # half an ulp of a 10-bit (TF32) or 3-bit (e4m3) mantissa
        for control, dtype, bits in (("tf32", torch.float32, 11),
                                     ("fp8", torch.bfloat16, 4)):
            layers.CONTROL = control
            r = layers.round_operand(x.to(dtype))
            rel = ((r.float() - x.to(dtype).float()).abs()
                   / x.to(dtype).float().abs()).max()
            assert 0 < rel <= 2.0 ** -bits
    finally:
        layers.CONTROL = None
