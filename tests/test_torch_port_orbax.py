"""The PyTorch port's reader of the JAX package's Orbax checkpoints, on the
CPU: its zstd decoder (``native/zstd_decode.cc``) against the `zstandard`
package, its OCDBT walk (``utils/ocdbt.py``) against tensorstore's
``ocdbt`` kvstore, and its restore (``utils/checkpoint.restore_orbax``)
against the JAX package's ``restore_checkpoint(target=None)``: the same
paths, None leaves, dtypes, shapes and bits.  Also the weights and Adam's
state taken into the port's model and optimizer, the JAX schedule's
learning rate on resume, and the reader's guards.

Cases: the committed fixture ``tests/data/orbax_tiny`` (``tiny_config()``
after one score step, written by ``tools/make_orbax_fixture.py``) and the
served weights ``weights/r5_real_e100.npz`` at full width, saved as Orbax
by the JAX package's ``save_checkpoint``.  The state after a refine step
and the CLIs: ``tests/test_torch_port_orbax_cli.py``.

Tolerances: the reader bit for bit; one Adam update against optax's (in
f64) rtol 1e-6 with an atol of 1e-6 of the learning rate.
"""

import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from regnet_for_3d_grasping_tpu.train import trainer as jtrainer
from regnet_for_3d_grasping_tpu.utils import checkpoint as jckpt
from regnet_for_3d_grasping_tpu.utils.config import tiny_config as jtiny

from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.config import tiny_config
from regnet_for_3d_grasping_torch.models.regnet import REGNet
from regnet_for_3d_grasping_torch.train import trainer
from regnet_for_3d_grasping_torch.utils import checkpoint, ocdbt, zstd

zstandard = pytest.importorskip("zstandard")
ts = pytest.importorskip("tensorstore")

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "orbax_tiny"
R5 = ROOT / "weights" / "r5_real_e100.npz"


# ---------------------------------------------------------------- zstd

def compress(data: bytes, level: int, **kw) -> bytes:
    return zstandard.ZstdCompressor(level=level, **kw).compress(data)


def block_features(frames: bytes) -> set:
    """What the zstd frames in `frames` use: block types, literal types and
    stream counts, sequence table modes (RFC 8878 headers, walked)."""
    seen, pos = set(), 0
    while pos < len(frames):
        magic = int.from_bytes(frames[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            seen.add("skippable")
            pos += 8 + int.from_bytes(frames[pos + 4:pos + 8], "little")
            continue
        fhd = frames[pos + 4]
        fcs = [0, 2, 4, 8][fhd >> 6] or (1 if fhd & 0x20 else 0)
        pos += 5 + (0 if fhd & 0x20 else 1) + [0, 1, 2, 4][fhd & 3] + fcs
        seen.add("checksum" if fhd & 4 else "no checksum")
        seen.add("content size" if fcs else "no content size")
        while True:
            bh = int.from_bytes(frames[pos:pos + 3], "little")
            pos += 3
            kind, size = (bh >> 1) & 3, bh >> 3
            seen.add(["raw block", "rle block", "compressed block"][kind])
            if kind == 2:
                b = frames[pos:pos + size]
                lt, sf = b[0] & 3, (b[0] >> 2) & 3
                seen.add(["raw literals", "rle literals", "huffman literals",
                          "treeless literals"][lt])
                if lt < 2:
                    hdr = [1, 2, 1, 3][sf]
                    n = (b[0] >> 3 if hdr == 1 else
                         (b[0] >> 4) + (b[1] << 4) + (b[2] << 12 if hdr == 3
                                                       else 0))
                    at = hdr + (n if lt == 0 else 1)
                else:
                    seen.add("1 stream" if sf == 0 else "4 streams")
                    hdr = [3, 3, 4, 5][sf]
                    h = int.from_bytes(b[:hdr], "little")
                    at = hdr + (h >> (4 + [10, 10, 14, 18][sf]))
                nseq = b[at]
                if nseq:
                    at += 1 if nseq < 128 else 2 if nseq < 255 else 3
                    for shift in (6, 4, 2):
                        seen.add(["predefined", "rle", "fse", "repeat"][
                            (b[at] >> shift) & 3] + " sequences")
            pos += 1 if kind == 1 else size
            if bh & 1:
                break
        pos += 4 if fhd & 4 else 0
    return seen


@settings(max_examples=30, deadline=None, database=None)
@given(data=st.binary(max_size=3000) | st.text(max_size=3000).map(
    lambda s: s.encode() * 7), level=st.sampled_from([1, 3, 19]),
    checksum=st.booleans())
def test_zstd_decodes_what_zstandard_writes(data, level, checksum):
    frame = compress(data, level, write_checksum=checksum)
    assert zstd.decompress(frame) == data
    assert zstandard.ZstdDecompressor().decompress(frame) == data


def corpus() -> dict:
    rng = np.random.RandomState(0)
    text = (ROOT / "regnet_for_3d_grasping_torch" / "train" /
            "trainer.py").read_bytes()
    floats = rng.randn(600_000).astype(np.float32).tobytes()
    pieces = [rng.bytes(64) for _ in range(100)]
    return {
        "empty": compress(b"", 3),
        "random bytes": compress(rng.bytes(300_000), 3),
        "long runs": compress(b"\0" * 1_000_000 + b"\7" * 500_000, 3),
        # past 2 MB: many blocks, matches reaching back across blocks
        "2.4 MB of f32": compress(floats, 1),
        "text, level 19, checksum": compress(text * 30, 19,
                                             write_checksum=True),
        "text, no content size": compress(text * 30, 3,
                                          write_content_size=False),
        "several frames": (compress(text, 1) + compress(b"abc" * 100, 3)
                           + (0x184D2A53).to_bytes(4, "little")
                           + (3).to_bytes(4, "little") + b"xyz"
                           + compress(floats[:100_000], 19)),
        # short runs of three byte values: literals in 1 stream, treeless
        # literals and sequence tables repeated from the block before
        "runs": compress(b"".join(
            bytes([int(c)]) * int(k) for c, k in zip(
                rng.randint(0, 3, 20000), rng.randint(4, 40, 20000))), 19),
        # one offset code throughout: an RLE sequence table
        "repeated chunks": compress(b"".join(rng.bytes(20) * 3 + b"z"
                                             for _ in range(300)), 3),
        # a block whose only literals are its 100 "R"s: RLE literals
        "one literal byte": compress(
            b"Q".join(pieces) + b"\0" * (131072 - 100 * 65 + 1)
            + b"".join(b"R" + pieces[i] for i in rng.permutation(100)), 3),
    }


def test_zstd_decodes_every_block_literal_and_sequence_form():
    zd = zstandard.ZstdDecompressor()
    seen = set()
    for name, frames in corpus().items():
        want = b"".join(zd.decompressobj().decompress(f) for f in
                        split_frames(frames))
        assert zstd.decompress(frames) == want, name
        seen |= block_features(frames)
    assert {"raw block", "rle block", "compressed block", "raw literals",
            "rle literals", "huffman literals", "treeless literals",
            "1 stream", "4 streams", "predefined sequences", "rle sequences",
            "fse sequences", "repeat sequences", "checksum", "no checksum",
            "content size", "no content size", "skippable"} <= seen, seen


def split_frames(frames: bytes) -> list:
    out, pos = [], 0
    while pos < len(frames):
        if int.from_bytes(frames[pos:pos + 4], "little") & 0xFFFFFFF0 == \
                0x184D2A50:
            pos += 8 + int.from_bytes(frames[pos + 4:pos + 8], "little")
            continue
        n = zstandard.frame_header_size(frames[pos:pos + 18])
        rest = zstandard.ZstdDecompressor().decompressobj()
        rest.decompress(frames[pos:])
        end = len(frames) - len(rest.unused_data)
        out.append(frames[pos:end])
        assert end - pos > n
        pos = end
    return out


def test_zstd_checksums():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    # a frame's checksum is XXH64's low 32 bits: every length through the
    # 32-byte stripes, the 8- and 4-byte words and the last bytes
    rng = np.random.RandomState(1)
    for n in list(range(70)) + [1000, 4099]:
        data = rng.bytes(n)
        frame = compress(data, 3, write_checksum=True)
        assert int.from_bytes(frame[-4:], "little") == \
            zstd.xxh64(data) & 0xFFFFFFFF
    assert zstd.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("where", ["block header", "literals", "sequences",
                                   "checksum", "magic"])
def test_zstd_raises_on_a_corrupted_byte(where):
    text = (ROOT / "regnet_for_3d_grasping_torch" / "utils" /
            "ocdbt.py").read_bytes() * 3
    frame = bytearray(compress(text, 19, write_checksum=True))
    at = {"magic": 1, "block header": 7, "literals": 20,
          "sequences": len(frame) - 40, "checksum": len(frame) - 2}[where]
    frame[at] ^= 0x21
    with pytest.raises(zstandard.ZstdError):
        zstandard.ZstdDecompressor().decompress(bytes(frame))
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(frame))


def test_zstd_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(zstd, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(zstd, "COMPILER", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(zstd, "_lib", None)
    with pytest.raises(RuntimeError, match="zstd decoder did not build"):
        zstd.decompress(compress(b"x", 3))
    assert os.listdir(tmp_path / "b") == []     # no half-written library


def test_zstd_raises_on_truncated_and_trailing_input():
    frame = compress(b"0123456789" * 5000, 3, write_checksum=True)
    for n in (0, 3, 5, 12, len(frame) // 2, len(frame) - 1):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:n])
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(frame + b"\0\0\0")


# ---------------------------------------------------------------- OCDBT

@pytest.fixture(scope="module")
def r5_dir(tmp_path_factory):
    """The served weights saved as Orbax by the JAX package."""
    variables, epoch = jckpt.load_weights_npz(str(R5))
    base = tmp_path_factory.mktemp("r5")
    jckpt.save_checkpoint(str(base), epoch, variables)
    return base


def tensorstore_items(root) -> dict:
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{os.path.abspath(root)}/"}).result()
    return {k: bytes(kv.read(k).result().value) for k in kv.list().result()}


def test_ocdbt_walk_equals_tensorstore(r5_dir, tmp_path):
    # a database of small nodes: interior nodes three levels deep, values
    # in data files and inline, nine versions; and Orbax's own layouts
    small = tmp_path / "small"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{small}/",
                          "config": {"max_inline_value_bytes": 16,
                                     "max_decoded_node_bytes": 300,
                                     "compression": {"id": "zstd",
                                                     "level": 5}}}).result()
    rng = np.random.RandomState(2)
    for i in rng.permutation(60):
        kv.write(f"key{i:03d}/{'x' * (i % 7)}", rng.bytes(i % 40)).result()
    kv.delete_range(ts.KvStore.KeyRange("key050", "key053")).result()
    for root in (small, FIXTURE / "ckpt_0", r5_dir / "ckpt_100",
                 FIXTURE / "ckpt_0" / "ocdbt.process_0"):
        store = ocdbt.KvStore(root)
        want = tensorstore_items(root)
        assert store.keys() == sorted(want), root
        assert all(store.read(k) == v for k, v in want.items()), root
    assert ocdbt.KvStore(small).height >= 2


def test_ocdbt_rejects_what_it_does_not_read(tmp_path):
    numbered = tmp_path / "numbered"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{numbered}/",
                          "config": {"manifest_kind": "numbered"}}).result()
    kv.write("a", b"1").result()
    with pytest.raises(ocdbt.OcdbtError, match="numbered"):
        ocdbt.KvStore(numbered)
    # a corrupt node fails its CRC-32C; a manifest cut short its length
    copy = tmp_path / "copy"
    shutil.copytree(FIXTURE / "ckpt_0", copy)
    node = next((copy / "d").iterdir())
    raw = bytearray(node.read_bytes())
    raw[20] ^= 1
    node.write_bytes(bytes(raw))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        ocdbt.KvStore(copy)
    manifest = copy / "manifest.ocdbt"
    manifest.write_bytes(manifest.read_bytes()[:-1])
    with pytest.raises(ocdbt.OcdbtError, match="header says"):
        ocdbt.KvStore(copy)


@pytest.mark.parametrize("spec,match", [
    ({"dtype": "<u2"}, "dtype '<u2'"),
    ({"compressor": {"id": "blosc", "cname": "lz4", "clevel": 5,
                     "shuffle": 1}}, "blosc"),
    ({"order": "F"}, "order 'F'")])
def test_zarr_rejects_what_it_does_not_read(tmp_path, spec, match):
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    meta = {"dtype": "<f4", "shape": [3, 4], "chunks": [2, 4],
            "compressor": None, "order": "C"} | spec
    arr = ts.open({"driver": "zarr", "kvstore": kv, "path": "a",
                   "metadata": meta}, create=True).result()
    arr.write(np.arange(12).reshape(3, 4).astype(arr.dtype.numpy_dtype)
              ).result()
    with pytest.raises(ocdbt.OcdbtError, match=match):
        ocdbt.read_array(ocdbt.KvStore(tmp_path), "a")


def test_zarr_reads_chunk_grids_fill_values_and_dtypes(tmp_path):
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    rng = np.random.RandomState(3)
    # dtype, shape, chunks, fill value, the region written (the chunks
    # outside it are left to the fill value)
    cases = {"f4": ("<f4", [5, 7], [2, 3], 1.5, np.s_[4:, 6:]),
             "f8": ("<f8", [4], [3], None, np.s_[:]),
             "i4": ("<i4", [3, 2], [3, 2], 7, np.s_[:]),
             "i8": ("<i8", [], [], None, ()),
             "u1": ("|u1", [9], [4], 0, np.s_[8:]),
             "b1": ("|b1", [6], [4], False, np.s_[:]),
             "bf": ("bfloat16", [5], [2], None, np.s_[:])}
    want = {}
    for name, (dtype, shape, chunks, fill, region) in cases.items():
        arr = ts.open({"driver": "zarr", "kvstore": kv, "path": name,
                       "metadata": {"dtype": dtype, "shape": shape,
                                    "chunks": chunks, "fill_value": fill,
                                    "compressor": {"id": "zstd",
                                                   "level": 3}}},
                      create=True).result()
        value = np.asarray(rng.randn(*shape) * 50).astype(
            arr.dtype.numpy_dtype)
        arr[region].write(value[region]).result()
        if fill is not None:
            written = value[region]
            value = np.full(shape, fill, value.dtype)
            value[region] = written
        want[name] = value
    store = ocdbt.KvStore(tmp_path)
    assert b"f4/0.0" not in store and b"f4/2.2" in store
    for name, value in want.items():
        got = ocdbt.read_array(store, name)
        if name == "bf":
            assert got.dtype == torch.bfloat16
            got = got.view(torch.int16).numpy()
            value = value.view(np.int16)
        assert got.dtype == value.dtype and got.shape == value.shape, name
        assert got.tobytes() == value.tobytes(), name
    with pytest.raises(ocdbt.OcdbtError, match="no zarr array"):
        ocdbt.read_array(store, "missing")


# ---------------------------------------------------------------- trees

def assert_same_tree(port, ref):
    """Same paths (None leaves included), dtypes, shapes and bits."""
    leaf = lambda x: x is None or isinstance(x, torch.Tensor)  # noqa: E731
    a = jax.tree_util.tree_flatten_with_path(port, is_leaf=leaf)[0]
    b = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: x is None)[0]
    assert [k for k, _ in a] == [k for k, _ in b]
    assert jax.tree.structure(port, is_leaf=leaf) == jax.tree.structure(
        ref, is_leaf=lambda x: x is None)
    for (path, x), (_, y) in zip(a, b):
        if y is None:
            assert x is None, path
            continue
        y = np.asarray(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == torch.bfloat16 and str(y.dtype) == "bfloat16"
            x = x.view(torch.int16).numpy()
            y = y.view(np.int16)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path


def test_fixture_restores_as_jax_restores_it():
    """``tiny_config()`` after one score step: 566 leaves, 198 of them
    optax's masked None placeholders; int32 scalars of shape []."""
    port, resume = checkpoint.restore_orbax(str(FIXTURE))
    ref, jresume = jckpt.restore_checkpoint(str(FIXTURE))
    assert resume == jresume == 1
    assert_same_tree(port, ref)
    nones = jax.tree_util.tree_flatten_with_path(
        port, is_leaf=lambda x: x is None)[0]
    assert len(nones) == 566 and sum(v is None for _, v in nones) == 198
    assert port["step"].dtype == np.int32 and port["step"].shape == ()
    # the fixture's expected.json is what JAX restores, and the port's
    # reader gives it (chip_smoke.py phase (k) holds the reader to it)
    expected = json.loads((FIXTURE / "expected.json").read_text())
    flat = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: x is None)[0]
    assert len(flat) == len(expected["leaves"])
    for (path, v), want in zip(flat, expected["leaves"]):
        assert [str(getattr(k, "key", getattr(k, "idx", k))) for k in path] \
            == want["path"]
        if want.get("none"):
            assert v is None
            continue
        assert (str(v.dtype), list(v.shape)) == (want["dtype"], want["shape"])
        assert hashlib.sha256(v.tobytes()).hexdigest() == want["sha256"]
    # the ckpt_N directory itself, and an epoch by number
    assert checkpoint.restore_orbax(str(FIXTURE / "ckpt_0"))[1] == 1
    assert checkpoint.restore_orbax(str(FIXTURE), epoch=0)[1] == 1


def test_full_width_weights_restore_as_jax_restores_them(r5_dir):
    port, resume = checkpoint.restore_orbax(str(r5_dir))
    ref, jresume = jckpt.restore_checkpoint(str(r5_dir))
    assert resume == jresume == 101
    assert_same_tree(port, ref)
    n = sum(v.size for v in jax.tree.leaves(port))
    assert n == 7_086_692


def test_bf16_and_numpy_leaves(tmp_path):
    tree = {"a": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3,
            "b": [None, np.arange(4, dtype=np.int64), (jnp.float32(2.5),)],
            "c": {"d": np.array([True, False])}}
    jckpt.save_checkpoint(str(tmp_path), 4, tree)
    port, resume = checkpoint.restore_orbax(str(tmp_path))
    ref, _ = jckpt.restore_checkpoint(str(tmp_path))
    assert resume == 5
    assert_same_tree(port, ref)


def test_unsupported_layouts_raise(tmp_path):
    for field, value, match in (("use_zarr3", True, "use_zarr3: true"),
                                ("use_ocdbt", False, "use_ocdbt: False")):
        copy = tmp_path / field / "ckpt_0"
        shutil.copytree(FIXTURE / "ckpt_0", copy)
        meta = json.loads((copy / "_METADATA").read_text())
        meta[field] = value
        (copy / "_METADATA").write_text(json.dumps(meta))
        with pytest.raises(ocdbt.OcdbtError, match=match):
            checkpoint.restore_orbax(str(copy.parent))
    # a leaf of another value type
    copy = tmp_path / "scalar" / "ckpt_0"
    shutil.copytree(FIXTURE / "ckpt_0", copy)
    meta = json.loads((copy / "_METADATA").read_text())
    next(iter(meta["tree_metadata"].values()))["value_metadata"][
        "value_type"] = "scalar"
    (copy / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(ocdbt.OcdbtError, match="value_type 'scalar'"):
        checkpoint.restore_orbax(str(copy.parent))


def test_latest_epoch_sees_both_forms(tmp_path):
    tag = tmp_path / "tag"
    shutil.copytree(FIXTURE / "ckpt_0", tag / "ckpt_3")
    assert checkpoint.latest_epoch(str(tag)) == 3
    assert checkpoint.is_orbax(str(tag))
    (tag / "ckpt_5.pt").write_bytes(b"")
    assert checkpoint.latest_epoch(str(tag)) == 5
    assert not checkpoint.is_orbax(str(tag))
    assert checkpoint.is_orbax(str(tag), epoch=3)
    (tag / "ckpt_3.pt").write_bytes(b"")
    with pytest.raises(ValueError, match="epoch 3 both"):
        checkpoint.latest_epoch(str(tag))


def test_reader_imports_without_jax_orbax_tensorstore_or_zstandard():
    code = f"""
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "orbax", "tensorstore", "zstandard", "flax",
           "optax", "ml_dtypes", "regnet_for_3d_grasping_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.utils import checkpoint, ocdbt, zstd
from regnet_for_3d_grasping_torch.train import trainer
from regnet_for_3d_grasping_torch.cli import infer, train
tree, resume = checkpoint.restore_orbax({str(FIXTURE)!r})
saved = checkpoint.load_checkpoint({str(FIXTURE)!r})
assert resume == 1 and saved["epoch"] == 0 and len(saved["model"]) > 100
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------- weights

def test_state_dict_from_orbax_equals_the_npz_route(r5_dir):
    arrays, epoch = weights.read_npz(R5)
    want = weights.jax_to_state_dict(arrays)
    saved = checkpoint.load_checkpoint(str(r5_dir))
    assert saved["epoch"] == epoch == 100
    assert set(saved["model"]) == set(want)
    assert all(torch.equal(saved["model"][k], want[k]) for k in want)
    # `load_into` / `build_regnet` take the directory (tag or ckpt_N)
    model = REGNet(tiny_config())
    assert weights.load_into(model, str(FIXTURE / "ckpt_0")) == 0
    tree, _ = checkpoint.restore_orbax(str(FIXTURE))
    sd = model.state_dict()
    for key, t in sd.items():
        coll, path = weights.variable_path(key, t.ndim)
        node = tree[coll]
        for part in path.split("/"):
            node = node[part]
        assert np.array_equal(t.numpy(), node.T if t.ndim == 2 else node)


# ---------------------------------------------------------------- Adam

def optax_state(opt, tree, params):
    """The restored opt_state of `params` (the restored params or a part
    of them) in optax's own structure (the NamedTuples of `opt.init`), its
    leaves looked up by name in the restored dicts."""
    def lookup(path, _):
        node = tree["opt_state"]
        for k in path:
            node = node[k.idx] if hasattr(k, "idx") else node[
                getattr(k, "key", getattr(k, "name", None))]
        return node

    return jax.tree_util.tree_map_with_path(
        lookup, jax.eval_shape(opt.init, params))


def at(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def test_adam_state_maps_and_one_update_equals_optax():
    tree, _ = checkpoint.restore_orbax(str(FIXTURE))
    model = REGNet(tiny_config())
    weights.load_into(model, checkpoint.variables(tree))
    opt = trainer.make_optimizer(model, tiny_config(), steps_per_epoch=4)
    trainer.load_jax_opt_state(opt, tree["opt_state"])
    # mu, nu and count land on exp_avg, exp_avg_sq and step, bit for bit
    inner = tree["opt_state"]["inner_states"]
    named = dict(model.named_parameters())
    for name in opt.names:
        p = named[name]
        group = "score" if name.startswith("score_net.") else "region"
        adam = inner[group]["inner_state"][0]
        _, path = weights.variable_path(name, p.ndim)
        state = opt.adam.state[p]
        for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            got = state[key].numpy()
            assert np.array_equal(got.T if p.ndim == 2 else got,
                                  at(adam[field], path))
        assert float(state["step"]) == int(adam["count"]) == 1
    # one update with a fixed gradient against optax's, at the same rate
    # (epoch 0 of 4 steps): the parameters at zero, so that each side's
    # new parameters are its update.  optax runs in f64: in f32 its bias
    # correction 1 - 0.999 ** 2 cancels to 1e-5 of the update, where the
    # port's (torch's) takes it in Python's double
    # optax takes a layer of each group (the port updates them all)
    jopt = jtrainer.make_optimizer(jtiny(), 4, 0)
    def part(t):
        return {"score_net": {"backbone": {"sa0": t["score_net"]["backbone"][
            "sa0"]}}, "grn_head": {"cls1": t["grn_head"]["cls1"]}}

    rng = np.random.RandomState(4)
    grads = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                         tree["params"])
    f64 = functools.partial(jax.tree.map, lambda a: np.asarray(
        a, np.float64) if np.asarray(a).dtype == np.float32 else a)
    with jax.enable_x64(True):
        updates, new_opt = jopt.update(
            f64(part(grads)), f64(optax_state(jopt, tree, part(
                tree["params"]))),
            f64(jax.tree.map(np.zeros_like, part(tree["params"]))))
    with torch.no_grad():
        for name in opt.names:
            p = named[name]
            g = at(grads, weights.variable_path(name, p.ndim)[1])
            p.zero_()
            p.grad = torch.from_numpy(np.ascontiguousarray(
                g.T if p.ndim == 2 else g))
    opt.step()
    compared = 0
    for name in opt.names:
        p = named[name]
        path = weights.variable_path(name, p.ndim)[1]
        if not path.startswith(("score_net/backbone/sa0/", "grn_head/cls1/")):
            continue
        compared += 1
        got = p.detach().numpy()
        want = np.asarray(at(updates, path))
        # atol: 1e-6 of the rate, for an entry whose new mu cancels (f32
        # rounds 0.9 mu + 0.1 g at its terms' scale)
        np.testing.assert_allclose(got.T if p.ndim == 2 else got, want,
                                   rtol=1e-6, atol=1e-9)
    assert compared == 12       # 3 layers of sa0 and cls1: kernel, scale, bias
    assert int(new_opt.inner_states["score"].inner_state[0].count) == 2
    assert all(float(s["step"]) == 2 for s in opt.adam.state.values())


def test_jax_schedule_counts_past_epochs_twice_on_resume():
    """JAX's ``make_optimizer(cfg, spe, resume_epoch)`` gives its schedule
    ``resume_epoch + count // spe`` with optax's RESTORED count, which
    already holds the past epochs' updates: resumed at epoch 5 after 5
    epochs of 2 steps, JAX sets the rate of epoch 10 (two decays of
    ``lr_step_epochs = 5``); the port and the reference's StepLR that of
    epoch 5 (one decay)."""
    spe, resume = 2, 5
    jparams = {"score_net": {"w": np.full((3,), 0.5, np.float32)},
               "grn_head": {"w": np.full((2,), -1.0, np.float32)}}
    opt = jtrainer.make_optimizer(jtiny(), spe, resume_epoch=resume)
    state = opt.init(jparams)
    count = jnp.asarray(resume * spe, jnp.int32)   # as a checkpoint holds it
    state = jax.tree.map(
        lambda x: count if (isinstance(x, jax.Array) and x.dtype == jnp.int32
                            and x.shape == ()) else x, state)
    grads = jax.tree.map(lambda a: np.full_like(a, 0.25), jparams)
    updates, _ = opt.update(grads, state, jparams)
    # Adam from zero moments at count 10 -> 11: mu_hat / sqrt(nu_hat) = 1
    b1c, b2c = 1 - 0.9 ** 11, 1 - 0.999 ** 11
    step = (0.1 * 0.25 / b1c) / (np.sqrt(0.001 * 0.0625 / b2c) + 1e-8)
    cfg = jtiny().train
    jax_lr = -float(updates["score_net"]["w"][0]) / step
    assert jax_lr == pytest.approx(cfg.lr_score * cfg.lr_gamma ** 2,
                                   rel=1e-5)
    assert trainer.learning_rates(tiny_config(), resume)[0] == \
        cfg.lr_score * cfg.lr_gamma
    assert tiny_config().train.lr_step_epochs == cfg.lr_step_epochs == 5
