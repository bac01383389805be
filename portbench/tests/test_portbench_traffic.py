"""The frozen generators: the same seed gives the same inputs, another
seed other inputs, every seed the same sizes."""

import pickle

import numpy as np

from portbench.modes import sub_seed
from portbench.modes.serve import make_pool
from portbench.traffic import synthetic


def test_cloud_pool_is_deterministic():
    a, b = make_pool(2**31 + 77, 3, 512), make_pool(2**31 + 77, 3, 512)
    c = make_pool(5, 3, 512)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert all(x.shape == (512, 6) and x.dtype == np.float32 for x in a + c)


def test_scene_pool_is_deterministic(tmp_path):
    p1 = synthetic.write_synthetic_dataset(str(tmp_path / "a"), 2, 600,
                                           seed=9, layout="randomized")
    p2 = synthetic.write_synthetic_dataset(str(tmp_path / "b"), 2, 600,
                                           seed=9, layout="randomized")
    for x, y in zip(p1, p2):
        with open(x, "rb") as fx, open(y, "rb") as fy:
            sx, sy = pickle.load(fx), pickle.load(fy)
        assert sx.keys() == sy.keys()
        for k in sx:
            assert np.array_equal(np.asarray(sx[k]), np.asarray(sy[k])), k


def test_sub_seeds_take_any_seed():
    assert sub_seed(2**40 + 3, 1) == sub_seed(2**40 + 3, 1)
    assert sub_seed(1, 2, 3) != sub_seed(1, 2, 4)
    assert 0 <= sub_seed(-5, -1) < 2**32
