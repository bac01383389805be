"""Read and write the key-value store and the arrays of an Orbax checkpoint
directory without orbax or tensorstore (the card's machine has neither).

Orbax (through tensorstore) keeps a PyTree checkpoint's arrays as zarr v2
arrays inside one OCDBT database: a B+tree of keys such as
``params.score_net.backbone.sa0.mlp.layer0.dense.kernel/.zarray`` (the
array's metadata) and ``.../0.0`` (its chunks), under the directory's
``manifest.ocdbt``.  This module reads that format as tensorstore writes it:

  * `KvStore`: the manifest and its latest version, the B+tree's interior
    and leaf nodes with their prefix-compressed keys, and values stored
    inline or by reference into a data file (``d/<name>``, possibly under
    ``ocdbt.process_N/``, named relative to the directory);
  * `read_array`: a zarr v2 array, its ``.zarray`` and a grid of one or
    more chunks, compressed with zstd (``utils/zstd.py``) or not.

Every container's CRC-32C is checked.  What the reader does not know raises
`OcdbtError` naming what it found (a numbered manifest, a codec, a dtype,
zarr v3); it never guesses.

The writers are the other direction, in the simplest layout tensorstore's
``ocdbt`` kvstore reads (and so orbax, which opens the checkpoint directory
itself as the database):

  * `write_kvstore`: a sorted key -> value map as one database, a
    single-version manifest (kind 0, nothing compressed, a fresh uuid) at
    the top of the directory and one data file ``d/<32 hex digits>`` with
    the values longer than the inline limit, then the B+tree's nodes, leaves
    first, each node within the decoded node limit (interior nodes once one
    leaf is not enough).  Orbax writes ``ocdbt.process_0/`` beside the top
    manifest because each of its processes writes a database of its own
    that it then merges; one writer needs none, and orbax reads the top
    manifest alone;
  * `write_array`: a zarr v2 array of float32 or int32 as one chunk (chunks
    = shape, a scalar's key ``name/0``), with no compressor.

The encoding, every integer a LEB128 varint unless said otherwise:

  container   magic (u32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de
              B+tree node), length of the whole container (u64 LE),
              format version (0), compression (0 none, 1 zstd), the body
              (compressed as said), CRC-32C of all before it (u32 LE)
  manifest    config: uuid (16 bytes), manifest kind (0 = single),
              max inline value bytes, max decoded node bytes, version tree
              arity log2 (u8), compression (0, or 1 then the zstd level as
              i32 LE); data file table; the inline versions: count n, then
              n generation numbers, n root heights (u8), n root locations
              (file ids, offsets, lengths) and n root statistics (keys, tree
              bytes, indirect value bytes), n commit times (u64 LE); then
              the version tree nodes.  The last inline version is the latest.
              A root whose offset and length are 2^64 - 1 is an empty tree.
  file table  count n, n - 1 lengths of the prefix each path shares with
              the one before, n suffix lengths, n base path lengths, the
              suffixes.  A node's paths are relative to the base path of the
              file the node itself came from.
  node        height (u8), data file table, entry count n, n - 1 key prefix
              lengths, n key suffix lengths, then
                interior: n subtree common prefix lengths, the key
                suffixes, n child locations (file ids, offsets, lengths), n
                child statistics (as a root's);
                leaf: the key suffixes, n value lengths, n value kinds (0
                inline, 1 in a data file), for the m values in files their m
                file ids and m offsets, then the inline values in order.
              The keys of a child node follow its entry's subtree common
              prefix (the first that many bytes of the entry's key, itself
              following its own node's prefix).
"""

from __future__ import annotations

import json
import math
import os
import time
import uuid
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from regnet_for_3d_grasping_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1


class OcdbtError(ValueError):
    """A checkpoint directory this reader cannot read, or a corrupt one."""


class _Buf:
    """A cursor over one decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.what}: {len(self.data) - self.pos} bytes "
                             f"after its end")


def _container(raw: bytes, magic: int, what: str) -> _Buf:
    """Check a container's header and checksum; its decoded body."""
    if len(raw) < 18:
        raise OcdbtError(f"{what}: truncated ({len(raw)} bytes)")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#010x}, not {magic:#010x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise OcdbtError(f"{what}: header says {length} bytes, found "
                         f"{len(raw)}")
    if zstd.crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    head = _Buf(raw[12:-4], what)
    version = head.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} (this reader "
                         f"reads 0)")
    compression = head.varint()
    body = head.data[head.pos:]
    if compression == 1:
        try:
            body = zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{what}: {e}") from e
    elif compression != 0:
        raise OcdbtError(f"{what}: compression format {compression} (this "
                         f"reader reads 0 none and 1 zstd)")
    return _Buf(body, what)


def _file_table(buf: _Buf, base: str) -> List[Tuple[str, str]]:
    """The data file table: (base path, relative path) of each file, the
    base path from the database's directory."""
    n = buf.varint()
    prefix = [0] + buf.varints(max(n - 1, 0))
    suffix = buf.varints(n)
    base_len = buf.varints(n)
    paths, prev = [], b""
    for k in range(n):
        if prefix[k] > len(prev):
            raise OcdbtError(f"{buf.what}: data file prefix past its path")
        path = prev[:prefix[k]] + buf.take(suffix[k])
        if base_len[k] > len(path):
            raise OcdbtError(f"{buf.what}: base path past its path")
        path_s = path.decode()
        paths.append((base + path_s[:base_len[k]], path_s[base_len[k]:]))
        prev = path
    return paths


def _keys(buf: _Buf, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + buf.varints(max(n - 1, 0))
    suffix = buf.varints(n)
    common = buf.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for k in range(n):
        if prefix[k] > len(prev):
            raise OcdbtError(f"{buf.what}: key prefix past its key")
        prev = prev[:prefix[k]] + buf.take(suffix[k])
        if common[k] > len(prev):
            raise OcdbtError(f"{buf.what}: subtree prefix past its key")
        keys.append(prev)
    return keys, common


class _Location(NamedTuple):
    path: str        # relative to the database's directory
    offset: int
    length: int
    base: str        # the file's base path, to which a node's paths are
                     # relative


class KvStore:
    """The latest version of the OCDBT database under `root`: its keys in
    order (`keys`) and their values (`read`)."""

    def __init__(self, root: str | os.PathLike):
        self.root = os.fspath(root)
        self._values: Dict[bytes, bytes | _Location] = {}
        buf = _container(self._file("manifest.ocdbt"), MANIFEST_MAGIC,
                         "manifest.ocdbt")
        buf.take(16)                                    # uuid
        kind = buf.varint()
        if kind != 0:
            raise OcdbtError(f"manifest kind {kind}: numbered manifests are "
                             f"not read (this reader reads kind 0, single)")
        buf.varint()                                    # max inline bytes
        buf.varint()                                    # max node bytes
        buf.byte()                                      # version tree arity
        compression = buf.varint()
        if compression == 1:
            buf.take(4)                                 # zstd level
        elif compression != 0:
            raise OcdbtError(f"manifest: node compression {compression}")
        files = _file_table(buf, "")
        n = buf.varint()
        if n == 0:
            raise OcdbtError("manifest: no version")
        buf.varints(n)                                  # generation numbers
        heights = list(buf.take(n))
        locs = self._locations(buf, files, n)
        buf.varints(3 * n)                              # statistics
        buf.take(8 * n)                                 # commit times
        self.height = heights[-1]
        root_loc = locs[-1]
        if (root_loc.offset, root_loc.length) != (_MISSING, _MISSING):
            self._walk(root_loc, self.height, b"")

    def _file(self, path: str, offset: int = 0, length: int = -1) -> bytes:
        full = os.path.normpath(os.path.join(self.root, path))
        if os.path.relpath(full, self.root).startswith(".."):
            raise OcdbtError(f"data file {path!r} lies outside {self.root}")
        try:
            with open(full, "rb") as f:
                f.seek(offset)
                data = f.read(length)
        except OSError as e:
            raise OcdbtError(f"cannot read {path!r}: {e}") from e
        if length >= 0 and len(data) != length:
            raise OcdbtError(f"{path!r}: {length} bytes at {offset} past "
                             f"its end")
        return data

    @staticmethod
    def _locations(buf: _Buf, files: List[Tuple[str, str]],
                   n: int) -> List[_Location]:
        ids, offsets, lengths = buf.varints(n), buf.varints(n), buf.varints(n)
        out = []
        for i, o, ln in zip(ids, offsets, lengths):
            if i >= len(files):
                raise OcdbtError(f"{buf.what}: data file id {i} of "
                                 f"{len(files)}")
            base, rel = files[i]
            out.append(_Location(base + rel, o, ln, base))
        return out

    def _walk(self, loc: _Location, height: int, prefix: bytes) -> None:
        what = f"B+tree node {loc.path}@{loc.offset}"
        buf = _container(self._file(loc.path, loc.offset, loc.length),
                         NODE_MAGIC, what)
        h = buf.byte()
        if h != height:
            raise OcdbtError(f"{what}: height {h}, its parent says {height}")
        files = _file_table(buf, loc.base)
        n = buf.varint()
        keys, common = _keys(buf, n, interior=h > 0)
        if h > 0:
            children = self._locations(buf, files, n)
            buf.varints(3 * n)                          # statistics
            buf.end()
            for key, c, child in zip(keys, common, children):
                self._walk(child, h - 1, prefix + key[:c])
            return
        lengths = buf.varints(n)
        kinds = buf.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError(f"{what}: value kind {max(kinds)}")
        indirect = [k for k in range(n) if kinds[k] == 1]
        ids, offsets = buf.varints(len(indirect)), buf.varints(len(indirect))
        refs = {}
        for k, i, o in zip(indirect, ids, offsets):
            if i >= len(files):
                raise OcdbtError(f"{what}: data file id {i} of {len(files)}")
            base, rel = files[i]
            refs[k] = _Location(base + rel, o, lengths[k], base)
        for k in range(n):
            full = prefix + keys[k]
            if full in self._values:
                raise OcdbtError(f"{what}: key {full!r} twice")
            self._values[full] = refs[k] if kinds[k] else buf.take(lengths[k])
        buf.end()

    def keys(self) -> List[bytes]:
        return sorted(self._values)

    def __contains__(self, key: bytes) -> bool:
        return key in self._values

    def read(self, key: bytes) -> bytes:
        value = self._values[key]
        if isinstance(value, _Location):
            return self._file(value.path, value.offset, value.length)
        return value


# ---------------------------------------------------------------- writing

def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _varints(ns) -> bytes:
    return b"".join(_varint(n) for n in ns)


def _wrap(magic: int, body: bytes) -> bytes:
    """A container of `body`: format version 0, compression 0."""
    head = magic.to_bytes(4, "big") + (len(body) + 18).to_bytes(8, "little")
    data = head + b"\0\0" + body
    return data + zstd.crc32c(data).to_bytes(4, "little")


def _one_file(path: bytes) -> bytes:
    """A data file table of the one file `path` (its base path empty)."""
    return _varint(1) + _varint(len(path)) + _varint(0) + path


def _common_prefix(a: bytes, b: bytes) -> bytes:
    return os.path.commonprefix([a, b])


def _key_columns(keys: List[bytes]) -> Tuple[bytes, bytes, bytes]:
    """(prefix lengths shared with the key before, suffix lengths,
    suffixes) of a node's keys."""
    prefix, suffix = [], []
    for prev, key in zip([b""] + keys, keys):
        n = len(_common_prefix(prev, key))
        prefix.append(n)
        suffix.append(key[n:])
    return (_varints(prefix[1:]), _varints(len(x) for x in suffix),
            b"".join(suffix))


class _Node(NamedTuple):
    first: bytes     # the subtree's first and last full keys
    last: bytes
    prefix: bytes    # what every key under it shares, which it leaves out
    offset: int
    length: int
    keys: int        # the statistics: keys, node bytes, indirect value
    tree_bytes: int  # bytes under it
    indirect: int


def _groups(sizes: List[int], limit: int, least: int) -> List[range]:
    """Runs of consecutive entries whose sizes (upper bounds of their
    encoding) sum within `limit`, each of at least `least` entries."""
    out, start, total = [], 0, 0
    for i, size in enumerate(sizes):
        if i - start >= least and total + size > limit:
            out.append(range(start, i))
            start, total = i, 0
        total += size
    out.append(range(start, len(sizes)))
    return out


def write_kvstore(root: str | os.PathLike, items: Dict[bytes, bytes], *,
                  max_inline_value_bytes: int = 1024,
                  max_decoded_node_bytes: int = 100_000_000) -> None:
    """Write `items` as a new OCDBT database under `root`: its
    ``manifest.ocdbt`` and one data file under ``d/`` (the limits are
    orbax's).  `root` must hold no database yet."""
    if not items:
        raise OcdbtError("an empty database is not written")
    root = os.fspath(root)
    if os.path.exists(os.path.join(root, "manifest.ocdbt")):
        raise OcdbtError(f"{root} already holds a database")
    name = f"d/{uuid.uuid4().hex}".encode()
    data = bytearray()
    keys = sorted(items)
    values = []          # bytes inline, or (offset, length) in the file
    for key in keys:
        v = bytes(items[key])
        if len(v) > max_inline_value_bytes:
            values.append((len(data), len(v)))
            data += v
        else:
            values.append(v)
    # upper bounds of a node's encoding less its entries (height, file
    # table, count) and of each entry's share (a key's prefix stripped
    # shortens it and its varints)
    limit = max_decoded_node_bytes - 11 - len(_one_file(name))
    size = lambda *ns: sum(len(_varint(n)) for n in ns)  # noqa: E731
    sizes = [len(k) + size(len(k), len(k)) + 1 + (
        size(0, v[0], v[1]) if isinstance(v, tuple) else size(len(v))
        + len(v)) for k, v in zip(keys, values)]
    groups = _groups(sizes, limit, 1)
    level: List[_Node] = []
    for g in groups:
        first, last = keys[g.start], keys[g.stop - 1]
        prefix = b"" if len(groups) == 1 else _common_prefix(first, last)
        vals = [values[i] for i in g]
        refs = [v for v in vals if isinstance(v, tuple)]
        p, s, suffixes = _key_columns([keys[i][len(prefix):] for i in g])
        body = (b"\0" + (_one_file(name) if refs else _varint(0))
                + _varint(len(g)) + p + s + suffixes
                + _varints(v[1] if isinstance(v, tuple) else len(v)
                           for v in vals)
                + _varints(int(isinstance(v, tuple)) for v in vals)
                + _varints(0 for _ in refs) + _varints(o for o, _ in refs)
                + b"".join(v for v in vals if not isinstance(v, tuple)))
        node = _wrap(NODE_MAGIC, body)
        level.append(_Node(first, last, prefix, len(data), len(node),
                           len(g), len(node), sum(n for _, n in refs)))
        data += node
    height = 0
    while len(level) > 1:
        height += 1
        sizes = [len(c.first) + size(*[len(c.first)] * 3, 0, c.offset,
                                     c.length, c.keys, c.tree_bytes,
                                     c.indirect) for c in level]
        groups = _groups(sizes, limit, 2)
        parents = []
        for g in groups:
            kids = [level[i] for i in g]
            first, last = kids[0].first, kids[-1].last
            prefix = b"" if len(groups) == 1 else _common_prefix(first, last)
            p, s, suffixes = _key_columns([c.first[len(prefix):]
                                           for c in kids])
            body = (bytes([height]) + _one_file(name) + _varint(len(kids))
                    + p + s + _varints(len(c.prefix) - len(prefix)
                                       for c in kids)
                    + suffixes + _varints(0 for _ in kids)
                    + _varints(c.offset for c in kids)
                    + _varints(c.length for c in kids)
                    + _varints(c.keys for c in kids)
                    + _varints(c.tree_bytes for c in kids)
                    + _varints(c.indirect for c in kids))
            node = _wrap(NODE_MAGIC, body)
            parents.append(_Node(
                first, last, prefix, len(data), len(node),
                sum(c.keys for c in kids),
                len(node) + sum(c.tree_bytes for c in kids),
                sum(c.indirect for c in kids)))
            data += node
        level = parents
    top = level[0]
    manifest = (uuid.uuid4().bytes + _varint(0)
                + _varints([max_inline_value_bytes, max_decoded_node_bytes])
                + bytes([4]) + _varint(0) + _one_file(name)
                # one version: generation 1, its root, statistics and commit
                # time, and no version tree node
                + _varint(1) + _varint(1) + bytes([height])
                + _varints([0, top.offset, top.length, top.keys,
                            top.tree_bytes, top.indirect])
                + time.time_ns().to_bytes(8, "little") + _varint(0))
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    with open(os.path.join(root, name.decode()), "wb") as f:
        f.write(data)
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(_wrap(MANIFEST_MAGIC, manifest))


# ---------------------------------------------------------------- zarr v2

_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32,
           "<i8": np.int64, "|u1": np.uint8, "|b1": np.bool_,
           "bfloat16": np.uint16}


def _fill(value, dtype: str):
    if isinstance(value, str):
        value = {"NaN": math.nan, "Infinity": math.inf,
                 "-Infinity": -math.inf}.get(value, value)
        if isinstance(value, str):
            raise OcdbtError(f"zarr fill value {value!r}")
    if dtype == "bfloat16":
        return torch.tensor(value, dtype=torch.bfloat16).view(torch.int16) \
            .item() & 0xFFFF
    return value


def read_array(store: KvStore, name: str):
    """The zarr v2 array `name` of `store`: a numpy array, or for bfloat16
    (which numpy has no type for) a ``torch.bfloat16`` CPU tensor with the
    stored bits."""
    key = f"{name}/.zarray".encode()
    if key not in store:
        raise OcdbtError(f"no zarr array {name!r} (its .zarray is missing)")
    meta = json.loads(store.read(key))
    if meta.get("zarr_format") != 2:
        raise OcdbtError(f"{name}: zarr_format {meta.get('zarr_format')!r} "
                         f"(this reader reads 2)")
    dtype = meta.get("dtype")
    if dtype not in _DTYPES:
        raise OcdbtError(f"{name}: dtype {dtype!r} (this reader reads "
                         f"{sorted(_DTYPES)})")
    if meta.get("order") != "C":
        raise OcdbtError(f"{name}: order {meta.get('order')!r}")
    if meta.get("filters"):
        raise OcdbtError(f"{name}: filters {meta['filters']!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OcdbtError(f"{name}: compressor {compressor!r} (this reader "
                         f"reads zstd or none)")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise OcdbtError(f"{name}: dimension_separator {sep!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise OcdbtError(f"{name}: chunks {chunks} for shape {shape}")
    np_dtype = np.dtype(_DTYPES[dtype])
    out = np.empty(shape, np_dtype)
    chunk_bytes = math.prod(chunks) * np_dtype.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*[len(g) for g in grid]) if shape else [()]:
        ckey = (f"{name}/" + (sep.join(map(str, index)) if index else "0")
                ).encode()
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        if ckey not in store:
            if meta.get("fill_value") is None:
                raise OcdbtError(f"{name}: chunk {index} missing and no "
                                 f"fill value")
            out[region] = _fill(meta["fill_value"], dtype)
            continue
        data = store.read(ckey)
        if compressor is not None:
            try:
                data = zstd.decompress(data)
            except zstd.ZstdError as e:
                raise OcdbtError(f"{name}: chunk {index}: {e}") from e
        if len(data) != chunk_bytes:
            raise OcdbtError(f"{name}: chunk {index} holds {len(data)} "
                             f"bytes, not {chunk_bytes}")
        block = np.frombuffer(data, np_dtype).reshape(chunks)
        out[region] = block[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    if dtype == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


_WRITE_DTYPES = {np.dtype(np.float32): "<f4", np.dtype(np.int32): "<i4"}


def write_array(items: Dict[bytes, bytes], name: str, array) -> None:
    """Add the zarr v2 array `name` to `items` (for `write_kvstore`): its
    ``.zarray`` and its one chunk, uncompressed."""
    a = np.asarray(array)
    dtype = _WRITE_DTYPES.get(a.dtype)
    if dtype is None:
        raise OcdbtError(f"{name}: dtype {a.dtype} (this writer writes "
                         f"float32 and int32)")
    shape = list(a.shape)
    meta = {"chunks": shape, "compressor": None, "dimension_separator": ".",
            "dtype": dtype, "fill_value": None, "filters": None,
            "order": "C", "shape": shape, "zarr_format": 2}
    items[f"{name}/.zarray".encode()] = json.dumps(
        meta, separators=(",", ":")).encode()
    chunk = ".".join("0" * a.ndim) or "0"
    items[f"{name}/{chunk}".encode()] = np.ascontiguousarray(a).tobytes()
