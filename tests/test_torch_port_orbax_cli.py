"""The JAX package's Orbax checkpoints behind the PyTorch port's entry
points, on the CPU: a TrainState after a refine step read as JAX reads it,
the infer CLI serving a JAX Orbax directory as it serves that directory's
npz export, and the train CLI resuming a JAX tag directory as it resumes
the port's own checkpoint of the same state.  The reader itself:
``tests/test_torch_port_orbax.py``, whose helpers this file imports.
"""

import pickle
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.data import (GraspDataset as JGraspDataset,
                                             write_synthetic_dataset as
                                             jwrite_dataset)
from regnet_for_3d_grasping_tpu.models import REGNet as JREGNet
from regnet_for_3d_grasping_tpu.train import trainer as jtrainer
from regnet_for_3d_grasping_tpu.utils import checkpoint as jckpt
from regnet_for_3d_grasping_tpu.utils.config import tiny_config as jtiny

from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.cli import infer
from regnet_for_3d_grasping_torch.cli import train as train_cli
from regnet_for_3d_grasping_torch.config import tiny_config
from regnet_for_3d_grasping_torch.data import write_synthetic_dataset
from regnet_for_3d_grasping_torch.models.regnet import REGNet
from regnet_for_3d_grasping_torch.train import trainer
from regnet_for_3d_grasping_torch.utils import checkpoint

from test_torch_port_orbax import (FIXTURE, R5, assert_same_tree,
                                   optax_state)


def test_refine_step_state_restores_as_jax_restores_it(tmp_path):
    """The fixture's TrainState after one more step, a refine step (the
    heads' Adam moments moving too), saved by JAX and read by both."""
    cfg = jtiny()
    tree, _ = jckpt.restore_checkpoint(str(FIXTURE))
    opt = jtrainer.make_optimizer(cfg, steps_per_epoch=4)
    state = jtrainer.TrainState(
        params=tree["params"], batch_stats=tree["batch_stats"],
        opt_state=optax_state(opt, tree, tree["params"]), step=tree["step"])
    jwrite_dataset(str(tmp_path / "scenes"), num_scenes=4,
                   num_view=cfg.region.num_points)
    ds = JGraspDataset(str(tmp_path / "scenes"), "train",
                       cfg.region.num_points, cfg.region.max_gt_grasps)
    batch = jtrainer.device_batch(next(ds.batches(2, seed=1)))
    step = jtrainer.make_train_step(JREGNet(cfg), opt, cfg, stage="refine")
    state, metrics = step(state, batch, jax.random.PRNGKey(1))
    assert np.isfinite(float(metrics["loss_total"]))
    jckpt.save_checkpoint(str(tmp_path / "tag"), 1, state._asdict())
    port, resume = checkpoint.restore_orbax(str(tmp_path / "tag"))
    ref, jresume = jckpt.restore_checkpoint(str(tmp_path / "tag"))
    assert resume == jresume == 2
    assert_same_tree(port, ref)
    region = port["opt_state"]["inner_states"]["region"]["inner_state"][0]
    assert int(region["count"]) == 2 and any(
        np.abs(m).max() > 0 for m in jax.tree.leaves(region["mu"]))


def test_infer_cli_serves_an_orbax_directory_as_its_npz_export(tmp_path):
    variables, epoch = jckpt.load_weights_npz(str(R5))
    jckpt.save_checkpoint(str(tmp_path / "tag"), epoch, variables)
    restored, _ = jckpt.restore_checkpoint(str(tmp_path / "tag"))
    npz = tmp_path / "export.npz"
    jckpt.export_weights_npz(str(npz), restored, epoch)
    folder = tmp_path / "scene_data"
    folder.mkdir()
    rng = np.random.RandomState(5)
    pc = np.c_[rng.uniform(-0.1, 0.1, (600, 2)), rng.uniform(0.74, 0.8,
                                                             (600, 1)),
               rng.uniform(0, 1, (600, 3))]
    with open(folder / "0000.p", "wb") as f:
        pickle.dump({"view_cloud": pc[:, :3], "view_cloud_color": pc[:, 3:]},
                    f)
    args = ["--folder-name", str(folder), "--center-num", "8",
            "--all-points-num", "512", "--device", "cpu", "--no-eval"]
    got = infer.main(args + ["--checkpoint", str(tmp_path / "tag")])[0]
    want = infer.main(args + ["--checkpoint", str(npz)])[0]
    for field in got["out"]._fields:
        a, b = getattr(got["out"], field), getattr(want["out"], field)
        assert (a is None and b is None) or torch.equal(a, b), field
    assert got["sets"].keys() == want["sets"].keys()
    assert all(np.array_equal(got["sets"][k], want["sets"][k])
               for k in got["sets"])


def test_train_cli_resumes_a_jax_tag_directory(tmp_path, capsys,
                                                monkeypatch):
    """One step from the fixture's tag directory writes ``ckpt_1/``, bit
    for bit the one written by resuming a ``ckpt_0.pt`` of the mapped state
    (weights, batch statistics, Adam's moments and counts, step).  Metrics
    go to JSON lines alone, as on the card's machine, which has no
    tensorboard (importing it here imports tensorflow)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    data = tmp_path / "scenes"
    write_synthetic_dataset(str(data), 6, num_view=512)
    shutil.copytree(FIXTURE / "ckpt_0", tmp_path / "models" / "jax" /
                    "ckpt_0")
    tree, _ = checkpoint.restore_orbax(str(FIXTURE))
    model = REGNet(tiny_config())
    weights.load_into(model, checkpoint.variables(tree))
    opt = trainer.make_optimizer(model, tiny_config(), 1)
    trainer.load_jax_opt_state(opt, tree["opt_state"])
    checkpoint.save_pt_checkpoint(str(tmp_path / "models" / "port"), 0,
                                  model, opt)
    saved = {}
    for tag in ("jax", "port"):
        res = train_cli.main([
            "--tiny", "--device", "cpu", "--data-path", str(data),
            "--model-path", str(tmp_path / "models"), "--log-path",
            str(tmp_path / "log"), "--tag", tag, "--mode", "pretrain_score",
            "--batch-size", "4", "--epoch", "2", "--resume"])
        assert "resumed from epoch 0" in capsys.readouterr().out
        assert [s["epoch"] for s in res["steps"]] == [1]
        assert checkpoint.latest_epoch(str(tmp_path / "models" / tag)) == 1
        saved[tag] = checkpoint.load_checkpoint(str(tmp_path / "models" /
                                                    tag))
        saved[tag]["groups"] = res["optimizer"].adam.state_dict()[
            "param_groups"]
    a, b = saved["jax"], saved["port"]
    assert a["epoch"] == b["epoch"] == 1
    assert a["model"].keys() == b["model"].keys()
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    assert a["groups"] == b["groups"]
    assert_same_tree(a["jax"], b["jax"])
    for group in ("score", "region"):
        adam = a["jax"]["opt_state"]["inner_states"][group]["inner_state"]
        assert int(adam[0]["count"]) == int(adam[1]["count"]) == 2
    assert int(a["jax"]["step"]) == 2
    # the step moved the Orbax directory's weights
    before = weights.jax_to_state_dict(checkpoint.variables(tree))
    assert any(not torch.equal(before[k], a["model"][k])
               for k in before if k.startswith("score_net."))


def test_partial_loads_take_orbax_directories(tmp_path):
    model = train_cli.build_model(tiny_config(), 3, "cpu")
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    train_cli.merge_checkpoint_modules(model, str(FIXTURE / "ckpt_0"),
                                       ["score_net"])
    want = checkpoint.load_checkpoint(str(FIXTURE))["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k] if k.startswith("score_net.")
                           else fresh[k]), k
    with pytest.raises(FileNotFoundError):
        checkpoint.load_checkpoint(str(tmp_path))
