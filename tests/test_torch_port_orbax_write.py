"""The PyTorch port's writer of the JAX package's Orbax checkpoints, on the
CPU: ``utils/checkpoint.save_checkpoint`` (the tree of JAX's
``TrainState._asdict()``, `train_state`, written by `write_orbax`) and
``utils/ocdbt.write_kvstore`` / ``write_array``, held against JAX's
``restore_checkpoint`` with and without ``target``, against tensorstore's
``ocdbt`` kvstore and against the port's own reader; the train CLI writing
``ckpt_N/`` and resuming from it; and the writer importing none of JAX,
orbax, tensorstore or zstandard.

Cases: the committed fixture ``tests/data/orbax_tiny`` (``tiny_config()``
after one score step, written by JAX) read into the port's model and Adam
and written straight back; OCDBT databases of orbax's limits and of
300-byte nodes; the served weights ``weights/r5_real_e100.npz`` at full
width.  JAX's target is its ``init_state`` at ``tiny_config()``, built
once.  The reader's own tests: ``tests/test_torch_port_orbax.py``, whose
helpers this file imports.

Tolerance: none; every comparison is bit for bit (paths, None
placeholders, dtypes, shapes, bytes).
"""

import base64
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.models import REGNet as JREGNet
from regnet_for_3d_grasping_tpu.train import trainer as jtrainer
from regnet_for_3d_grasping_tpu.utils import checkpoint as jckpt
from regnet_for_3d_grasping_tpu.utils.config import tiny_config as jtiny

from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.cli import train as train_cli
from regnet_for_3d_grasping_torch.config import tiny_config
from regnet_for_3d_grasping_torch.data import write_synthetic_dataset
from regnet_for_3d_grasping_torch.models.regnet import REGNet
from regnet_for_3d_grasping_torch.train import trainer
from regnet_for_3d_grasping_torch.utils import checkpoint, ocdbt

from test_torch_port_orbax import (FIXTURE, R5, ROOT, assert_same_tree,
                                   tensorstore_items)

ORBAX_FILES = ("_METADATA", "_sharding",
               os.path.join("array_metadatas", "process_0"))


@pytest.fixture(scope="module")
def jax_target():
    """JAX's TrainState at ``tiny_config()``, as its train CLI restores
    into it."""
    cfg = jtiny()
    opt = jtrainer.make_optimizer(cfg, steps_per_epoch=4)
    state = jtrainer.init_state(JREGNet(cfg), cfg, opt, jnp.zeros(
        (2, cfg.region.num_points, 6), jnp.float32))
    return state._asdict()


@pytest.fixture(scope="module")
def fixture_state():
    """The fixture as the port reads it: (its tree, the model, Adam)."""
    tree, _ = checkpoint.restore_orbax(str(FIXTURE))
    model = REGNet(tiny_config())
    weights.load_into(model, checkpoint.variables(tree))
    opt = trainer.make_optimizer(model, tiny_config(), 1)
    trainer.load_jax_opt_state(opt, tree["opt_state"])
    return tree, model, opt


@pytest.fixture(scope="module")
def rewritten(fixture_state, tmp_path_factory):
    """The fixture's state written straight back by the port."""
    _, model, opt = fixture_state
    base = tmp_path_factory.mktemp("rewritten")
    path = checkpoint.save_checkpoint(str(base), 0, model, opt)
    assert path == str(base / "ckpt_0")
    return base


def assert_bit_equal(got, want):
    """Two JAX restores: the same tree (JAX's NamedTuples and masked
    placeholders included), leaf for leaf, bit for bit."""
    none = lambda x: x is None  # noqa: E731
    a, ta = jax.tree_util.tree_flatten_with_path(got, is_leaf=none)
    b, tb = jax.tree_util.tree_flatten_with_path(want, is_leaf=none)
    assert ta == tb
    for (path, x), (other, y) in zip(a, b):
        assert path == other
        if y is None:
            assert x is None, path
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), path
        assert x.tobytes() == y.tobytes(), path


@pytest.mark.parametrize("with_target", [False, True])
def test_rewritten_fixture_restores_in_jax_as_the_fixture(
        rewritten, jax_target, with_target):
    target = jax_target if with_target else None
    want, want_resume = jckpt.restore_checkpoint(str(FIXTURE), target=target)
    got, resume = jckpt.restore_checkpoint(str(rewritten), target=target)
    assert resume == want_resume == 1
    assert_bit_equal(got, want)
    counts = [got["step"]]
    for group in ("score", "region"):
        if with_target:
            inner = got["opt_state"].inner_states[group].inner_state
            counts += [inner[0].count, inner[1].count]
        else:
            inner = got["opt_state"]["inner_states"][group]["inner_state"]
            counts += [inner[0]["count"], inner[1]["count"]]
    assert [int(c) for c in counts] == [1] * 5
    if with_target:
        # optax's own state, ready for JAX's next update
        assert type(got["opt_state"]) is type(jax_target["opt_state"])
        assert isinstance(got["step"], jax.Array)
    else:
        leaves = jax.tree.leaves(got, is_leaf=lambda x: x is None)
        assert len(leaves) == 566 and sum(v is None for v in leaves) == 198
    # what orbax reads beside the database is what JAX wrote
    for name in ORBAX_FILES:
        assert json.loads((rewritten / "ckpt_0" / name).read_text()) == \
            json.loads((FIXTURE / "ckpt_0" / name).read_text()), name


def test_port_reads_its_own_output_bit_equal(fixture_state, rewritten):
    tree, model, opt = fixture_state
    got, resume = checkpoint.restore_orbax(str(rewritten))
    assert resume == 1
    assert_same_tree(got, tree)
    assert_same_tree(checkpoint.train_state(model, opt), tree)
    # a tree of the other forms: lists, tuples, None, int32 scalars
    mixed = {"a": [np.arange(6, dtype=np.float32).reshape(2, 3), None,
                   (np.int32(7),)], "b": {"c": np.float32(-0.0)}}
    checkpoint.write_orbax(str(rewritten / "mixed" / "ckpt_4"), mixed)
    got, resume = checkpoint.restore_orbax(str(rewritten / "mixed"))
    assert resume == 5
    assert_same_tree(got, {"a": [mixed["a"][0], None, [np.int32(7)]],
                           "b": {"c": np.float32(-0.0)}})
    assert_same_tree(got, jckpt.restore_checkpoint(str(rewritten /
                                                        "mixed"))[0])
    for bad, match in (({"x": np.zeros(3)}, "float64"),
                       ({"x": np.zeros(3, np.float16)}, "float16")):
        with pytest.raises(ocdbt.OcdbtError, match=match):
            checkpoint.write_orbax(str(rewritten / "bad"), bad)


def test_save_replaces_the_pt_and_an_earlier_directory(tmp_path):
    model = REGNet(tiny_config())
    opt = trainer.make_optimizer(model, tiny_config(), 1)
    checkpoint.save_pt_checkpoint(str(tmp_path), 3, model, opt)
    assert checkpoint.latest_epoch(str(tmp_path)) == 3
    checkpoint.save_checkpoint(str(tmp_path), 3, model, opt)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3"]
    assert checkpoint.is_orbax(str(tmp_path))
    # before the first update: optax's init, zeros and counts of 0
    tree, _ = checkpoint.restore_orbax(str(tmp_path))
    adam = tree["opt_state"]["inner_states"]["region"]["inner_state"][0]
    assert int(adam["count"]) == 0 and int(tree["step"]) == 0
    assert not any(np.any(m) for m in jax.tree.leaves(adam["mu"]))
    # written again over itself (orbax's force=True); no optimizer: params,
    # batch statistics and step
    checkpoint.save_checkpoint(str(tmp_path), 3, model)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3"]
    tree, _ = checkpoint.restore_orbax(str(tmp_path))
    assert sorted(tree) == ["batch_stats", "params", "step"]


def node_sizes(root) -> list:
    """The decoded size of every B+tree node of the database under
    `root`, read with the reader's own container and table parsers."""
    buf = ocdbt._container((root / "manifest.ocdbt").read_bytes(),
                           ocdbt.MANIFEST_MAGIC, "manifest")
    buf.take(16)
    buf.varints(3)
    buf.byte()
    assert buf.varint() == 0                    # nothing compressed
    files = ocdbt._file_table(buf, "")
    assert buf.varint() == 1                    # one version
    buf.varint()
    todo = [(buf.byte(), ocdbt.KvStore._locations(buf, files, 1)[0])]
    sizes = []
    while todo:
        height, loc = todo.pop()
        raw = (root / loc.path).read_bytes()[loc.offset:loc.offset +
                                             loc.length]
        node = ocdbt._container(raw, ocdbt.NODE_MAGIC, "node")
        sizes.append(len(node.data))
        assert node.byte() == height
        if height:
            kids = ocdbt._file_table(node, "")
            n = node.varint()
            ocdbt._keys(node, n, True)
            todo += [(height - 1, c) for c in
                     ocdbt.KvStore._locations(node, kids, n)]
    return sizes


@pytest.mark.parametrize("limits,count", [
    ({}, 400),
    ({"max_inline_value_bytes": 16, "max_decoded_node_bytes": 300}, 200)])
def test_ocdbt_writer_equals_tensorstore(tmp_path, rewritten, limits, count):
    rng = np.random.RandomState(count)
    sizes = [0, 5, 17, 40, 1025, 3000]
    items = {f"k{i:04d}/{'x' * (i % 7)}".encode(): rng.bytes(
        rng.choice(sizes)) for i in rng.permutation(count)}
    items[b"a"] = b""
    ocdbt.write_kvstore(tmp_path, items, **limits)
    store = ocdbt.KvStore(tmp_path)
    assert tensorstore_items(tmp_path) == items
    assert store.keys() == sorted(items)
    assert all(store.read(k) == v for k, v in items.items())
    assert (store.height >= 2) == bool(limits)
    sizes = node_sizes(tmp_path)
    assert max(sizes) <= limits.get("max_decoded_node_bytes", 100_000_000)
    assert len(sizes) > 10 if limits else len(sizes) == 1
    assert len(os.listdir(tmp_path / "d")) == 1
    with pytest.raises(ocdbt.OcdbtError, match="already holds"):
        ocdbt.write_kvstore(tmp_path, items)
    # the checkpoint's own database
    store = ocdbt.KvStore(rewritten / "ckpt_0")
    want = tensorstore_items(rewritten / "ckpt_0")
    assert store.keys() == sorted(want) and len(want) == 736
    assert all(store.read(k) == v for k, v in want.items())


def test_full_width_weights_written_by_the_port_read_by_orbax(tmp_path):
    """The r5 weights as a full-width model's state_dict (what
    `save_checkpoint` reads of a model), written and read back by orbax."""
    want, epoch = weights.read_npz(R5)
    state = weights.jax_to_state_dict(want)
    assert set(state) == set(REGNet(tiny_config()).state_dict())
    model = types.SimpleNamespace(state_dict=lambda: state)
    checkpoint.save_checkpoint(str(tmp_path), epoch, model)
    got, resume = jckpt.restore_checkpoint(str(tmp_path))
    assert resume == 101 and int(got["step"]) == 0
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            (walk(v, f"{prefix}/{k}") if isinstance(v, dict)
             else flat.__setitem__(f"{prefix}/{k}", v))

    for coll in ("params", "batch_stats"):
        walk(got[coll], coll)
    assert flat.keys() == want.keys()
    for k, v in want.items():
        assert flat[k].dtype == v.dtype and flat[k].shape == v.shape, k
        assert flat[k].tobytes() == v.tobytes(), k
    assert sum(v.size for v in flat.values()) == 7_086_692


def test_train_cli_resumes_its_directory_as_the_same_state_pt(
        tmp_path, capsys, monkeypatch):
    """The CLI writes ``ckpt_0/``; resuming it gives the same next step,
    bit for bit, as resuming a ``ckpt_0.pt`` of the state it ended with.
    Its metrics go to JSON lines alone, as on the card's machine, which has
    no tensorboard (importing it here imports tensorflow)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    data = tmp_path / "scenes"
    write_synthetic_dataset(str(data), 6, num_view=512)

    def run(tag, *extra):
        return train_cli.main([
            "--tiny", "--device", "cpu", "--data-path", str(data),
            "--model-path", str(tmp_path / "models"), "--log-path",
            str(tmp_path / "log"), "--tag", tag, "--mode", "train",
            "--batch-size", "4", *extra])

    first = run("orbax", "--epoch", "1")
    assert sorted(os.listdir(tmp_path / "models" / "orbax")) == ["ckpt_0"]
    checkpoint.save_pt_checkpoint(str(tmp_path / "models" / "pt"), 0,
                                  first["model"], first["optimizer"])
    saved = {}
    for tag in ("orbax", "pt"):
        res = run(tag, "--epoch", "2", "--resume")
        assert "resumed from epoch 0" in capsys.readouterr().out
        assert [s["epoch"] for s in res["steps"]] == [1]
        tree, resume = checkpoint.restore_orbax(str(tmp_path / "models" /
                                                    tag))
        assert resume == 2 and int(tree["step"]) == 2
        saved[tag] = (res["steps"][0]["loss"], tree,
                      res["optimizer"].adam.state_dict()["param_groups"])
    assert saved["orbax"][0] == saved["pt"][0]
    assert saved["orbax"][2] == saved["pt"][2]
    assert_same_tree(saved["orbax"][1], saved["pt"][1])
    # the step moved the weights
    before = checkpoint.train_state(first["model"])
    assert not np.array_equal(before["params"]["grn_head"]["stem"]["dense"][
        "kernel"], saved["orbax"][1]["params"]["grn_head"]["stem"]["dense"][
        "kernel"])


def test_writer_imports_without_jax_orbax_tensorstore_or_zstandard(tmp_path):
    code = f"""
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "orbax", "tensorstore", "zstandard", "flax",
           "optax", "ml_dtypes", "regnet_for_3d_grasping_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import torch
from regnet_for_3d_grasping_torch.config import tiny_config
from regnet_for_3d_grasping_torch.models.regnet import REGNet
from regnet_for_3d_grasping_torch.train import trainer
from regnet_for_3d_grasping_torch.utils import checkpoint
model = REGNet(tiny_config())
opt = trainer.make_optimizer(model, tiny_config(), 1)
path = checkpoint.save_checkpoint({str(tmp_path)!r}, 0, model, opt)
saved = checkpoint.load_checkpoint({str(tmp_path)!r})
assert saved["epoch"] == 0 and "opt_state" in saved["jax"]
sd = model.state_dict()
assert all(torch.equal(saved["model"][k], sd[k]) for k in sd)
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    # what it wrote restores in JAX, its sharding file naming JAX's CPU
    # device for every array
    tree, _ = jckpt.restore_checkpoint(str(tmp_path))
    sharding = json.loads((tmp_path / "ckpt_0" / "_sharding").read_text())
    names = {base64.b64decode(k).decode() for k in sharding}
    assert len(names) == len(jax.tree.leaves(tree)) and "step" in names
    assert {json.loads(v)["device_str"] for v in sharding.values()} == {
        checkpoint.JAX_CPU_DEVICE}
