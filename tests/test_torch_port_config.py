"""The port's config trees against the JAX package's, field by field.

`infer_config()` and `train_config()` of both packages are walked
dataclass by dataclass: every dataclass has the same field names, and
every leaf the same default, so a field that one side adds or drops shows
here.  Tolerances: none (the defaults are Python values).
"""

import dataclasses
import importlib

import pytest

from regnet_for_3d_grasping_torch import config as pconfig

jconfig = importlib.import_module("regnet_for_3d_grasping_tpu.utils.config")


def walk(mine, theirs, path="config"):
    """Yields (path, mine, theirs) for every leaf of two config trees,
    after asserting that each pair of dataclasses has the same fields."""
    assert dataclasses.is_dataclass(theirs) == dataclasses.is_dataclass(
        mine), path
    if not dataclasses.is_dataclass(mine):
        yield path, mine, theirs
        return
    names = [f.name for f in dataclasses.fields(mine)]
    assert sorted(names) == sorted(f.name for f in dataclasses.fields(
        theirs)), (path, sorted(set(names) ^ {
            f.name for f in dataclasses.fields(theirs)}))
    for name in names:
        yield from walk(getattr(mine, name), getattr(theirs, name),
                        f"{path}.{name}")


@pytest.mark.parametrize("preset", ["infer_config", "train_config"])
def test_config_trees_have_the_jax_package_s_fields_and_defaults(preset):
    mine, theirs = getattr(pconfig, preset)(), getattr(jconfig, preset)()
    leaves = list(walk(mine, theirs))
    assert len(leaves) > 60
    for path, a, b in leaves:
        assert type(a) is type(b) and a == b, (path, a, b)
    assert mine.train.data_parallel_axis == "data"
