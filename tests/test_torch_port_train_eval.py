"""The train CLI's grasp evaluation (``--eval-grasps`` / ``--eval-every``)
against the JAX CLI, on the CPU at ``--tiny``.

The JAX CLI runs in validate mode with its model's forward replaced by the
port's outputs on the same scenes (its jitted init and eval step would
cost minutes here, and they are not what is compared), on one device, as
the port runs: both CLIs then evaluate the same grasp sets with their own
evaluator and log under their own names.  Tolerances: the logged names
equal; counts exact and scores within 1e-5 relative (the port sums a
band's |n.y| in f64, JAX in f32; tests/test_torch_port_eval.py).
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.data import (
    write_synthetic_dataset as jwrite_dataset)
from regnet_for_3d_grasping_tpu.eval import evaluator as jev
from regnet_for_3d_grasping_tpu.models.regnet import (
    REGNetOutput as JREGNetOutput)
from regnet_for_3d_grasping_tpu.utils.config import (EvalConfig as JEval,
                                                     GripperConfig as JGrip)

from regnet_for_3d_grasping_torch.cli import train as train_cli
from regnet_for_3d_grasping_torch.eval import evaluator
from regnet_for_3d_grasping_torch.train import trainer

jtrain = importlib.import_module("regnet_for_3d_grasping_tpu.cli.train")
jtrainer = importlib.import_module("regnet_for_3d_grasping_tpu.train.trainer")
jcache = importlib.import_module("regnet_for_3d_grasping_tpu.utils.cache")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    jwrite_dataset(str(d), num_scenes=6, num_view=512)
    return str(d)


def cli_args(tmp_path, data_dir, log, *extra):
    return ["--tiny", "--data-path", data_dir, "--model-path",
            str(tmp_path / "models"), "--log-path", str(tmp_path / log),
            "--batch-size", "2", *extra]


def epoch_records(path):
    with open(path / "default" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return {(r["tag"], r["step"]): r["value"] for r in recs
            if r["tag"].startswith("epoch_")}


def close(a, b):
    return a == b or abs(a - b) <= 1e-5 * max(abs(a), abs(b))


def test_validate_records_and_names_match_the_jax_cli(tmp_path, data_dir,
                                                      monkeypatch):
    """validate mode with --eval-grasps: every call of the port's evaluator
    equals JAX's `evaluate_scene_grasps` on the same arguments, and the
    JAX CLI, given the port's forward outputs, logs the same epoch
    scalars under the same names."""
    outs, calls = [], []
    eval_step, evaluate = trainer.eval_step, evaluator.evaluate_scene_grasps

    def eval_spy(*a, **kw):
        out, metrics = eval_step(*a, **kw)
        outs.append(out)
        return out, metrics

    def evaluate_spy(*a, **kw):
        rec = evaluate(*a, **kw)
        calls.append((a, rec))
        return rec

    monkeypatch.setattr(trainer, "eval_step", eval_spy)
    monkeypatch.setattr(evaluator, "evaluate_scene_grasps", evaluate_spy)
    res = train_cli.main(cli_args(tmp_path, data_dir, "log", "--device",
                                  "cpu", "--mode", "validate",
                                  "--eval-grasps"))
    assert len(outs) == 2 and calls
    assert [r["epoch"] for r in res["grasp_records"]] == [0]
    for (data, grasps, view, tz, depths, width, g, cfg), rec in calls:
        want = jev.evaluate_scene_grasps(data, grasps, view, tz, depths,
                                         width, JGrip(), JEval())
        assert rec[0] == want[0] and rec[2:] == want[2:]
        assert close(rec[1], want[1])
    assert res["grasp_records"][0]["records"]["stage2"].formal > 0

    # the JAX CLI on the port's outputs, one device
    feed = iter(outs)

    def jeval_step(*_):
        out = next(feed)
        return JREGNetOutput(**{
            k: None if v is None else jnp.asarray(v.numpy())
            for k, v in out._asdict().items()}), {}

    real_devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: real_devices(*a)[:1])
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(jtrainer, "init_state", lambda *a, **kw: None)
    monkeypatch.setattr(jtrainer, "make_eval_step",
                        lambda *a, **kw: jeval_step)
    jtrain.main(cli_args(tmp_path, data_dir, "jlog", "--mode", "validate",
                         "--eval-grasps"))
    got, want = (epoch_records(tmp_path / "log"),
                 epoch_records(tmp_path / "jlog"))
    assert got.keys() == want.keys()
    assert ("epoch_validate_stage2_vgr", 0) in got
    for k in got:
        assert close(got[k], want[k]), k


def test_eval_every_schedules_the_grasp_evaluation(tmp_path, data_dir):
    """train mode, 3 epochs, --eval-every 2: grasps are evaluated at epochs
    0 and 2 (the last), the loss metrics of every validation forward every
    epoch; at stage score never."""
    res = train_cli.main(cli_args(tmp_path, data_dir, "log", "--device",
                                  "cpu", "--mode", "train", "--epoch", "3",
                                  "--eval-grasps", "--eval-every", "2"))
    assert [r["epoch"] for r in res["grasp_records"]] == [0, 2]
    assert len(res["validation"]) == 6
    logged = {step for tag, step in epoch_records(tmp_path / "log")
              if tag.startswith("epoch_validate_stage")}
    assert logged == {0, 2}
    res = train_cli.main(cli_args(tmp_path, data_dir, "log2", "--device",
                                  "cpu", "--mode", "validate_score",
                                  "--eval-grasps"))
    assert res["grasp_records"] == [] and len(res["validation"]) == 2
