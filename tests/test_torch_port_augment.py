"""The port's geometric augmentation (`data/augment.py`, the train CLI's
``--geom-aug``) against the JAX package's ``data/augment.py``, on the CPU:
from one `RandomState` both give the same batch, bit for bit (numpy on
both sides).  The CLI test also drives ``--native-loader``
(tests/test_torch_port_native_loader.py holds the loader itself)."""

import numpy as np
import pytest

from regnet_for_3d_grasping_tpu.data import augment as jaug
from regnet_for_3d_grasping_tpu.data import (
    GraspDataset as JGraspDataset, write_synthetic_dataset as jwrite_dataset)

from regnet_for_3d_grasping_torch.cli import train as train_cli
from regnet_for_3d_grasping_torch.data import GraspDataset, augment
from regnet_for_3d_grasping_torch.eval.evaluator import (CAMERA_POSE,
                                                         view_num_from_path)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    jwrite_dataset(str(d), num_scenes=6, num_view=512)
    return str(d)


def batch_pair(data_dir):
    args = (data_dir, "train", 512, 32, 1)
    return (next(GraspDataset(*args).batches(2, seed=3)),
            next(JGraspDataset(*args).batches(2, seed=3)))


def cameras(batch):
    return np.stack([CAMERA_POSE[view_num_from_path(p)]
                     for p in batch.paths])


def assert_same_batch(a, b):
    for f in a._fields:
        u, v = getattr(a, f), getattr(b, f)
        if isinstance(u, np.ndarray):
            assert u.dtype == v.dtype and np.array_equal(u, v), f
        else:
            assert u == v, f


@pytest.mark.parametrize("severity", [0.0, 0.3, 1.0, 2.5])
def test_augment_batch_bit_equal_to_jax(data_dir, severity):
    ours, theirs = batch_pair(data_dir)
    assert_same_batch(ours, theirs)
    cams = cameras(ours)
    got = augment.augment_batch(ours, np.random.RandomState(11), severity,
                                cams)
    want = jaug.augment_batch(theirs, np.random.RandomState(11), severity,
                              cams)
    assert_same_batch(got, want)
    if severity:
        assert not np.array_equal(got.pc, ours.pc)
    else:
        assert got is ours


@pytest.mark.parametrize("kw", [dict(axial=1.0), dict(lateral=0.7),
                                dict(quant=2.0), dict(dropout=0.3),
                                dict(axial=1, lateral=1, quant=1,
                                     dropout=0.1, return_index=True)])
def test_kinect_corrupt_and_rigid_jitter_bit_equal_to_jax(kw):
    rng = np.random.RandomState(5)
    view = rng.uniform(-0.3, 0.3, (400, 3)).astype(np.float32)
    view[:, 2] += 0.8
    view[:3, :2] = 0.0            # rays along z: the lateral fallback axis
    cam = np.array([0.0, 0.0, 1.7], np.float32)
    got = augment.kinect_corrupt(view, cam, np.random.RandomState(2), **kw)
    want = jaug.kinect_corrupt(view, cam, np.random.RandomState(2), **kw)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for s in (0.0, 0.5, 3.0):
        for g, w in zip(augment.rigid_jitter(np.random.RandomState(9), s),
                        jaug.rigid_jitter(np.random.RandomState(9), s)):
            assert np.array_equal(g, w)


def test_geom_aug_and_native_loader_flags_feed_every_train_batch(
        tmp_path, data_dir, monkeypatch):
    """--geom-aug over --native-loader: each epoch's augmentation stream is
    RandomState(seed + 7919 + epoch), with the cameras of the scenes'
    views; every train batch comes from the native loader (its .rsc
    paths), and the step trains on what the augmentation returns."""
    from regnet_for_3d_grasping_torch.data import native_loader
    from regnet_for_3d_grasping_torch.train import trainer
    calls, fed, native = [], [], []
    real, device_batch = augment.augment_batch, trainer.device_batch
    next_batch = native_loader.NativeLoader.next_batch

    def spy(batch, rng, severity, cams):
        calls.append((rng.get_state()[1].copy(), severity, cams,
                      batch.paths))
        out = real(batch, rng, severity, cams)
        fed.append(out.pc)
        return out

    def next_spy(self):
        native.append(next_batch(self))
        return native[-1]

    def batch_spy(b, device):
        if b.pc.shape[0] == 2:               # the train batches
            assert any(b.pc is pc for pc in fed)
        return device_batch(b, device)

    monkeypatch.setattr(augment, "augment_batch", spy)
    monkeypatch.setattr(native_loader.NativeLoader, "next_batch", next_spy)
    monkeypatch.setattr(trainer, "device_batch", batch_spy)
    res = train_cli.main([
        "--tiny", "--device", "cpu", "--data-path", data_dir,
        "--model-path", str(tmp_path / "m"), "--log-path",
        str(tmp_path / "l"), "--batch-size", "2", "--mode", "train",
        "--epoch", "2", "--seed", "4", "--geom-aug", "0.5",
        "--native-loader"])
    assert len(calls) == len(native) == len(res["steps"]) == 4
    assert all(c[1] == 0.5 and c[2].shape == (2, 3) for c in calls)
    assert all(p.endswith(".rsc") for c in calls for p in c[3])
    for epoch in (0, 1):
        first = calls[2 * epoch][0]
        assert np.array_equal(
            first, np.random.RandomState(4 + 7919 + epoch).get_state()[1])
