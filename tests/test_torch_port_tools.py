"""The port's tools against the JAX package's, on the CPU: the dataset
statistics CLI (``cli/stats.py``), the grasp visualization
(``vis/vis_grasp.py``), the metric logger's tensorboard sink
(``utils/logging.py``) and the kernels' build directory
(``utils/cache.py``, the counterpart of JAX's compilation cache).

Tolerances: printed lines and PLY files byte-equal; tag names, values and
steps equal.
"""

import pickle
import sys
import types

import numpy as np
import pytest

from regnet_for_3d_grasping_tpu.cli import stats as jstats
from regnet_for_3d_grasping_tpu.data import (
    write_synthetic_dataset as jwrite_dataset)
from regnet_for_3d_grasping_tpu.utils import logging as jlogging
from regnet_for_3d_grasping_tpu.vis import vis_grasp as jvis

import regnet_for_3d_grasping_torch.vis as pvis
from regnet_for_3d_grasping_torch.cli import infer, stats
from regnet_for_3d_grasping_torch.ops import _cuda
from regnet_for_3d_grasping_torch.utils import cache
from regnet_for_3d_grasping_torch.utils import logging as plogging
from regnet_for_3d_grasping_torch.vis import vis_grasp


def test_stats_cli_prints_what_the_jax_package_prints(tmp_path, capsys):
    jwrite_dataset(str(tmp_path), 3, num_view=2048)
    jstats.main(["--data-path", str(tmp_path)])
    want = capsys.readouterr().out
    stats.main(["--data-path", str(tmp_path)])
    got = capsys.readouterr().out
    assert got == want and got.startswith("scenes: 3\n")
    with pytest.raises(SystemExit):
        stats.main(["--data-path", str(tmp_path / "none")])


def test_show_grasp_writes_the_jax_package_s_ply(tmp_path):
    """One prediction pickle of the port's infer CLI (tiny shapes on the
    CPU), drawn by both packages: the same bytes, every stage."""
    folder = tmp_path / "scene_data"
    folder.mkdir()
    rng = np.random.RandomState(0)
    xyz = rng.rand(512, 3) * 0.08
    xyz[:, 2] += 0.75
    with open(folder / "0000.p", "wb") as f:
        pickle.dump({"view_cloud": xyz, "view_cloud_color": rng.rand(512, 3)},
                    f)
    infer.main(["--folder-name", str(folder), "--center-num", "8",
                "--all-points-num", "512", "--device", "cpu", "--no-eval"])
    pred = tmp_path / "scene_data_predict" / "0000.p"
    with open(pred, "rb") as f:
        data = pickle.load(f)
    assert len(data["grasp_stage2"]) > 1
    for stage, thre in (("grasp_stage2", None), ("grasp_stage3", None),
                        ("grasp_stage2", 0.0)):
        want = jvis.show_grasp(str(pred), stage, thre,
                               str(tmp_path / "jax.ply"))
        got = vis_grasp.show_grasp(str(pred), stage, thre,
                                   str(tmp_path / "port.ply"))
        assert open(got, "rb").read() == open(want, "rb").read()
    assert pvis.show_grasp is vis_grasp.show_grasp
    assert {n for n in dir(pvis) if not n.startswith("_")} >= {
        "gripper_hand_boxes", "show_grasp", "write_ply"}


class FakeWriter:
    """A stand-in ``torch.utils.tensorboard.SummaryWriter``: records."""

    seen: list = []

    def __init__(self, log_dir):
        self.log_dir = log_dir

    def add_scalar(self, tag, value, step):
        FakeWriter.seen.append((type(self).__name__, tag, value, step))

    def close(self):
        FakeWriter.seen.append(("closed", self.log_dir))


def test_tensorboard_sink_takes_the_jax_package_s_tag_names(tmp_path,
                                                             monkeypatch):
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = FakeWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    metrics = {"loss_total": 1.5, "acc": 0.25}
    for mod, tag in ((jlogging, "jax"), (plogging, "port")):
        FakeWriter.seen.clear()
        log = mod.MetricLogger(str(tmp_path), tag)
        log.scalars(metrics, 3, mode="train", granularity="batch")
        log.scalars(metrics, 1, mode="validate", granularity="epoch")
        log.scalar("lr", 0.001, 7)
        log.close()
        if tag == "jax":
            want = list(FakeWriter.seen)
        else:
            got = list(FakeWriter.seen)
    assert [e[1:] for e in got[:-1]] == [e[1:] for e in want[:-1]]
    assert got[0][1:] == ("batch_train_loss_total", 1.5, 3)
    assert got[-1] == ("closed", str(tmp_path / "port"))


def test_tensorboard_sink_is_optional(tmp_path, monkeypatch):
    """Where tensorboard does not import, the JSON lines alone."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    log = plogging.MetricLogger(str(tmp_path), "t")
    log.scalar("x", 2.0, 1)
    log.close()
    assert log._tb is None
    assert '"tag": "x"' in (tmp_path / "t" / "metrics.jsonl").read_text()


def test_enable_compilation_cache_moves_the_build_directory(tmp_path,
                                                            monkeypatch):
    default = _cuda.BUILD_DIR
    assert default == _cuda.CSRC / "build"
    monkeypatch.setattr(_cuda, "BUILD_DIR", default)
    monkeypatch.delenv(cache.ENV, raising=False)
    assert cache.enable_compilation_cache() == default
    assert cache.enable_compilation_cache(str(tmp_path / "a")) \
        == tmp_path / "a" == _cuda.BUILD_DIR
    assert _cuda._lib_path("group").parent == tmp_path / "a"
    monkeypatch.setenv(cache.ENV, str(tmp_path / "b"))
    assert cache.enable_compilation_cache() == tmp_path / "b"
    # the CLIs call it, as the JAX package's call theirs
    monkeypatch.setenv(cache.ENV, str(tmp_path / "c"))
    with pytest.raises(SystemExit):
        infer.main(["--folder-name", str(tmp_path / "none"), "--device",
                    "cpu"])
    assert _cuda.BUILD_DIR == tmp_path / "c"
