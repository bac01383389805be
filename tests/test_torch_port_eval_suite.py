"""The frozen benchmark suite in the port (``data/benchmark_suite.py``) and
its metrics CLI (``cli/benchmark_eval.py``), on the CPU.

The port's copy of the synthetic generator reproduces every committed
fingerprint of suites v1 and v2 (48 scenes, about 0.1 s each).  The CLI's
suite path runs here on one scene (a forward at 25,600 points takes about
10 s on the CPU), with 32 centers and the weights the JAX package's suite
files were made with: its records are what JAX's `evaluate_scene_grasps`
gives on the same grasp sets, counts exact and score sums within 1e-5
relative (the port sums a band's |n.y| in f64, JAX in f32).
"""

import json

import numpy as np
import pytest

from regnet_for_3d_grasping_tpu.data import benchmark_suite as jsuite
from regnet_for_3d_grasping_tpu.eval import evaluator as jev
from regnet_for_3d_grasping_tpu.utils.config import (EvalConfig as JEval,
                                                     GripperConfig as JGrip)

from regnet_for_3d_grasping_torch.data import benchmark_suite as suite


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """As in ``test_torch_port_eval.py``: 2 of torch's threads, so that the
    suite's parallel workers do not oversubscribe the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("version", [1, 2])
def test_port_generator_reproduces_every_committed_fingerprint(version):
    fps = suite.load_fingerprints(version)
    specs = suite.suite_specs(version)
    assert specs == jsuite.suite_specs(version)
    assert fps == jsuite.load_fingerprints(version)
    assert set(fps["scenes"]) == {s["name"] for s in specs}
    for spec in specs:
        suite.verify_scene(spec, suite.generate_scene(spec), fps)


def test_verify_scene_refuses_a_moved_scene():
    spec = suite.suite_specs(2)[0]
    scene = suite.generate_scene(spec)
    scene["view_cloud"] = scene["view_cloud"] + np.float32(1e-6)
    with pytest.raises(RuntimeError, match="drifted"):
        suite.verify_scene(spec, scene, suite.load_fingerprints(2))


def test_benchmark_eval_cli_on_one_scene(tmp_path, monkeypatch):
    from regnet_for_3d_grasping_torch.cli import benchmark_eval
    from regnet_for_3d_grasping_torch.eval import evaluator
    specs = suite.suite_specs(2)
    monkeypatch.setattr(suite, "suite_specs",
                        lambda version=2: [specs[0]])
    calls = []
    evaluate = evaluator.evaluate_scene_grasps

    def spy(*args, **kwargs):
        calls.append((args, evaluate(*args, **kwargs)))
        return calls[-1][1]

    monkeypatch.setattr(evaluator, "evaluate_scene_grasps", spy)
    out = tmp_path / "metrics.json"
    res = benchmark_eval.main(["--center-num", "32", "--device", "cpu",
                               "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["config"]["backend"] == "cpu" and res["epoch"] == 100
    assert "not JAX's threefry" in res["config"]["seeds"]
    assert set(res["per_scene"]) == {"sparse_00"}
    # one call a stage with grasps, stage 2 first
    row = res["per_scene"]["sparse_00"]
    assert len(calls) == sum(r["n_grasps"] > 0 for r in row.values())
    assert row["stage2"]["n_grasps"] > 0
    total = jev.EvalRecord()
    for (scene, grasps, view, th, depth, width, _g, _c), got in calls:
        want = jev.evaluate_scene_grasps(scene, grasps, view, th, depth,
                                         width, JGrip(), JEval())
        assert got[0] == want[0] and got[2:] == want[2:]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)
        total = total.add(want)
    assert total.vgr_count > 0
    assert 0 < res["summary"]["sparse"]["stage2"]["n_grasps"] <= 32
    assert res["summary"]["clutter"]["stage2"]["n_grasps"] == 0
    monkeypatch.undo()
    assert benchmark_eval.main(["--verify-only"]) == {"verified": 24}
