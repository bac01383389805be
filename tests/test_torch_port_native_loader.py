"""The port's native C++ loader (`data/native_loader.py`, its own copy of
the loader source) against the JAX package's, on the CPU: the same .rsc
cache, the same batches bit for bit from one seed; a failed build raises.
No timing is tested here.  The train CLI's ``--native-loader`` is driven
in tests/test_torch_port_augment.py."""

import glob
import os

import numpy as np
import pytest

from regnet_for_3d_grasping_tpu.data import (
    write_synthetic_dataset as jwrite_dataset)
from regnet_for_3d_grasping_tpu.data import native_loader as jnative

from regnet_for_3d_grasping_torch.data import native_loader

pytestmark = pytest.mark.skipif(jnative.build_library() is None,
                                reason="g++ unavailable")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("rsc")
    jwrite_dataset(str(d), num_scenes=6, num_view=600)
    paths = sorted(glob.glob(os.path.join(d, "training_data", "*.p")))
    return str(d), paths


def test_rsc_files_equal_the_jax_converters(scenes, tmp_path):
    _, paths = scenes
    ours = native_loader.convert_dataset(paths, str(tmp_path / "a"))
    theirs = jnative.convert_dataset(paths, str(tmp_path / "b"))
    for a, b in zip(ours, theirs):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("augment,batch", [(True, 2), (False, 3)])
def test_batches_equal_the_jax_loaders(scenes, tmp_path, augment, batch):
    _, paths = scenes
    rsc = native_loader.convert_dataset(paths, str(tmp_path / "c"))
    kw = dict(batch_size=batch, num_points=512, max_grasps=32, seed=7,
              augment=augment)
    ours = native_loader.NativeLoader(rsc, **kw)
    theirs = jnative.NativeLoader(rsc, **kw)
    try:
        for _ in range(5):          # past an epoch: the reshuffle too
            a, b = ours.next_batch(), theirs.next_batch()
            for f in a._fields:
                u, v = getattr(a, f), getattr(b, f)
                if isinstance(u, np.ndarray):
                    assert u.dtype == v.dtype and np.array_equal(u, v), f
                else:
                    assert u == v, f
    finally:
        ours.close()
        theirs.close()


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native_loader, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native_loader, "COMPILER",
                        str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="did not build"):
        native_loader.build_library()
    with pytest.raises(RuntimeError, match="did not build"):
        native_loader.NativeLoader([], 1, 16, 4)
    assert os.listdir(tmp_path / "b") == []     # no half-written library
