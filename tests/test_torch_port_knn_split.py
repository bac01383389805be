"""K3's key-split 3-NN (``csrc/three_nn.cu`` on ``csrc/three_nn.cuh``), on
the CPU.

The kernel splits the keys into S ranges of ceil(N2 / S) in index order; a
block of 128 threads owns 128*Q queries (Q a thread, strided by 128) x one
range and keeps each query's best three (distance, index) with strict
compares in key order; it stages the range in chunks of 1,024 keys and
scans each in steps of 4 keys (NaN past the chunk) that insert only where
one of the step's pairs is under the third distance; with one range it
writes the result, else each range's three
([B, S, 3, N1], a placeholder (3e38, 0) where a range holds fewer than
three keys) and a merge inserts the S lists in range order with the same
compares.  The kernel runs only on the card; here a numpy
emulation of that decomposition (blocks, threads, the ranges, the
placeholders, the merge) is held against `three_nn_plain` and against the
JAX Pallas kernel in interpret mode, and the pure rule
`ops.knn.split_grid` is checked at the shapes the paths launch.

Tolerances: indices exact; the emulation's distances equal the plain
version's exactly (the same f32 steps); against the interpreted Pallas
kernel, distances to rtol 1e-6, as the K3 tests of
``test_torch_port_ops.py`` hold them.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.ops.knn_pallas import three_nn_pallas

from regnet_for_3d_grasping_torch.ops import knn

H100_SMS = 132
CSRC = Path(__file__).resolve().parents[1] / "regnet_for_3d_grasping_torch" \
    / "csrc"
INF = np.float32(3e38)


def cxx_constant(name):
    """The int constant `name` of three_nn.cu and the scan it shares with
    K8 (three_nn.cuh): the wrapper reads it from the built library, which
    needs a card; here from the sources."""
    text = (CSRC / "three_nn.cu").read_text() + (CSRC / "three_nn.cuh"
                                                 ).read_text()
    found = re.findall(rf"\b{name} = (\d+);", text)
    assert len(found) == 1, f"{name}: {found}"
    return int(found[0])


THREADS = cxx_constant("kThreads")
MAX_Q = cxx_constant("kMaxPerThread")
STEP = cxx_constant("kStep")
CHUNK = cxx_constant("kChunk")


def t(a):
    return torch.from_numpy(np.array(a))


# --- (a) the grid rule ------------------------------------------------------

@pytest.mark.parametrize("batch,n1,n2,srt,want", [
    # FP3 at serving: 200 tiles x 4 ranges, the rule's pick among the
    # fastest grids of the serving sweep on the H100 (PERF.md)
    (1, 25600, 5120, False, (1, 4)),
    (12, 25600, 5120, False, (2, 1)),   # FP3 in training: no merge
    (12, 25600, 5120, True, (2, 6)),    # the slab fallback's x-sorted keys
    (1, 25600, 5120, True, (1, 6)),     # the fallback at serving
    (2, 25600, 5120, False, (2, 4)),    # the card-vs-CPU training step
    (1, 5120, 1024, False, (1, 4)),     # too few tiles at any Q: Q = 1
    (1, 100, 5120, False, (1, 20)),     # one tile at every Q: most ranges
    (12, 25600, 600, True, (2, 2)),     # at most 2 ranges of 256 keys
    (1, 25600, 300, False, (1, 1)),     # too few keys to split
    (1, 1, 3, True, (1, 1)),            # the smallest search
])
def test_split_grid_at_path_shapes(batch, n1, n2, srt, want):
    q, s = knn.split_grid(batch, n1, n2, H100_SMS, THREADS, MAX_Q, srt)
    assert (q, s) == want
    span = -(-n2 // s)
    assert -(-n2 // span) == s and (s - 1) * span < n2  # no empty range
    assert q in (1, MAX_Q)
    blocks = batch * -(-n1 // (THREADS * q)) * s
    if n2 == 5120 and n1 == 25600:        # every FP3 shape fills the card
        assert blocks >= H100_SMS
    if s > 1:
        assert span >= knn.MIN_RANGE_KEYS


@pytest.mark.parametrize("srt", [False, True])
@pytest.mark.parametrize("batch", [1, 2, 4, 12, 24])
def test_split_grid_takes_the_fewest_ranges(batch, srt):
    """At the FP3 shape: Q = 2 exactly where its tiles alone put a block
    on every SM, and S the fewest ranges (at least SORTED_MIN_RANGES for
    sorted keys) that reach BLOCKS_PER_SM blocks a SM."""
    q, s = knn.split_grid(batch, 25600, 5120, H100_SMS, THREADS, MAX_Q, srt)
    tiles = batch * -(-25600 // (THREADS * q))
    assert (q == MAX_Q) == (batch * -(-25600 // (THREADS * MAX_Q))
                            >= H100_SMS)
    target = knn.BLOCKS_PER_SM * H100_SMS
    least = knn.SORTED_MIN_RANGES if srt else 1
    assert s >= least and tiles * s >= target
    assert s == least or tiles * (s - 1) < target


def test_split_grid_refuses_empty_searches():
    for n1, n2 in ((0, 10), (10, 0)):
        with pytest.raises(ValueError):
            knn.split_grid(1, n1, n2, H100_SMS, THREADS, MAX_Q)


# --- (b) the emulation ------------------------------------------------------

class Best3:
    """Best3 of three_nn.cuh for a vector of queries; `empty` is the
    distance of an empty slot (K3's 3e38, K8's 1e38)."""

    def __init__(self, n, empty=INF):
        self.d = np.full((n, 3), empty, np.float32)
        self.i = np.zeros((n, 3), np.int64)

    def insert(self, d, j):
        c0, c1, c2 = (d < self.d[:, 0]), (d < self.d[:, 1]), (d < self.d[:, 2])
        d0, d1, d2 = self.d.T.copy()
        i0, i1, i2 = self.i.T.copy()
        self.d[:, 2] = np.where(c1, d1, np.where(c2, d, d2))
        self.i[:, 2] = np.where(c1, i1, np.where(c2, j, i2))
        self.d[:, 1] = np.where(c0, d0, np.where(c1, d, d1))
        self.i[:, 1] = np.where(c0, i0, np.where(c1, j, i1))
        self.d[:, 0] = np.where(c0, d, d0)
        self.i[:, 0] = np.where(c0, j, i0)


def distances(qs, k):
    """dx = key - query, d = (dx*dx + dy*dy) + dz*dz in f32; and dx*dx."""
    dx = k[..., 0] - qs[:, None, 0]
    xx = dx * dx
    dy, dz = k[..., 1] - qs[:, None, 1], k[..., 2] - qs[:, None, 2]
    return (xx + dy * dy) + dz * dz, xx


def scan(qs, keys, k0):
    """One thread's loop over keys[k0:] for the queries `qs` [n, 3]: steps
    of STEP keys over each staged chunk of CHUNK keys (NaN past the
    chunk).  A step takes its compares before its insertions, and a query
    inserts only where one of them holds."""
    best = Best3(len(qs))
    for c0 in range(0, len(keys), CHUNK):
        chunk = keys[c0:c0 + CHUNK]
        pad = -len(chunk) % STEP
        chunk = np.concatenate([chunk, np.full((pad, 3), np.nan,
                                               np.float32)])
        for s0 in range(0, len(chunk), STEP):
            d = distances(qs, chunk[s0:s0 + STEP])[0]     # [n, STEP]
            with np.errstate(invalid="ignore"):
                hit = (d < best.d[:, 2:]).any(1)
            for i in range(STEP):
                best.insert(np.where(hit, d[:, i], np.nan), k0 + c0 + s0 + i)
    return best


def emulate(query, key, Q, S):
    """The split launch's blocks and threads and, for S > 1, the merge."""
    B, N1, _ = query.shape
    N2 = key.shape[1]
    span = -(-N2 // S)
    tile = THREADS * Q
    tiles = -(-N1 // tile)
    out_i = np.full((B, S, 3, N1), -7, np.int64)
    out_d = np.full((B, S, 3, N1), np.nan, np.float32)
    owner = np.zeros((B, S, N1), np.int64)
    for b in range(B):
        for tl in range(tiles):
            # thread x holds queries q0 + u*THREADS, u < Q; past N1 it
            # scans a copy of the last and writes nothing
            q = tl * tile + np.arange(Q)[:, None] * THREADS \
                + np.arange(THREADS)[None]
            q = q.reshape(-1)
            for r in range(S):
                k0, k1 = r * span, min(N2, (r + 1) * span)
                best = scan(query[b, np.minimum(q, N1 - 1)], key[b, k0:k1],
                            k0)
                ok = q < N1
                out_i[b, r][:, q[ok]] = best.i[ok].T
                out_d[b, r][:, q[ok]] = best.d[ok].T
                owner[b, r, q[ok]] += 1
    assert (owner == 1).all()      # every (range, query) has one writer
    if S == 1:
        return out_i[:, 0].transpose(0, 2, 1), out_d[:, 0].transpose(0, 2, 1)
    idx = np.zeros((B, N1, 3), np.int64)
    dist = np.zeros((B, N1, 3), np.float32)
    for b in range(B):
        best = Best3(N1)
        for r in range(S):                    # range order, strict compares
            for e in range(3):
                best.insert(out_d[b, r, e], out_i[b, r, e])
        idx[b], dist[b] = best.i, best.d
    return idx, dist


def references(query, key):
    plain = knn.three_nn_plain(t(query), t(key))
    ri, rd = three_nn_pallas(jnp.asarray(query), jnp.asarray(key),
                             interpret=True)
    np.testing.assert_array_equal(plain[0].numpy(), np.asarray(ri))
    np.testing.assert_allclose(plain[1].numpy(), np.asarray(rd), rtol=1e-6)
    return plain[0].numpy(), plain[1].numpy()


def check(got, ref):
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.fixture(scope="module")
def case():
    """B=2, N1=1000 (not a multiple of any tile), N2=301 (not a multiple of
    the ranges' span at S = 2, 4, 7), keys drawn from a coarse grid so that
    many queries meet equal distances; keys 75 and 76 equal (the boundary
    of S = 4's first range: span 76 puts them in ranges 0 and 1), and so
    are keys 150 and 151 (the boundary at S = 2); key 64 equals key 10."""
    rng = np.random.RandomState(83)
    key = (rng.randint(0, 8, (2, 301, 3)) * 0.125).astype(np.float32)
    key[:, 76] = key[:, 75]
    key[:, 151] = key[:, 150]
    key[:, 64] = key[:, 10]
    query = (rng.randint(0, 16, (2, 1000, 3)) * 0.0625).astype(np.float32)
    query[:, :20] = key[:, 75, None]    # zero distance to keys 75 and 76
    query[:, 20:40] = key[:, 150, None]
    query[:, 40:60] = key[:, 10, None]  # key 64 ties an earlier key
    return query, key


@pytest.fixture(scope="module")
def case_ref(case):
    return references(*case)


def test_case_straddles_range_boundaries(case, case_ref):
    query, key = case
    idx, dist = case_ref
    np.testing.assert_array_equal(idx[:, :20, :2], [[[75, 76]] * 20] * 2)
    for b in range(2):     # the keys equal to key 10, smallest indices first
        same = np.flatnonzero((key[b] == key[b, 10]).all(-1))[:3]
        assert 64 in same and same[0] == 10
        np.testing.assert_array_equal(idx[b, 40:60, :len(same)],
                                      [same] * 20)
    assert (dist[:, :20, :2] == 0).all()
    # equal second and third distances are common: ties go to the index
    ties = (dist[..., 1] == dist[..., 2])
    assert ties.mean() > 0.2 and (idx[..., 1][ties] < idx[..., 2][ties]).all()


@pytest.mark.parametrize("Q", [1, 2])
@pytest.mark.parametrize("S", [1, 2, 4, 7])
def test_emulation_matches_plain_and_pallas(case, case_ref, Q, S):
    check(emulate(*case, Q, S), case_ref)


@pytest.mark.parametrize("n2", [1023, 1024, 1025, 1100])
def test_chunk_edges(n2):
    """Ranges that span two staged chunks, or end one key short of or past
    the first (its last step padded with NaN keys): the nearest key in the
    last chunk, a key tied by the next, and a query on each."""
    rng = np.random.RandomState(n2)
    key = (rng.randint(0, 64, (1, n2, 3)) / 64.0).astype(np.float32)
    query = (rng.randint(0, 64, (1, 600, 3)) / 64.0).astype(np.float32)
    key[0, -1] = query[0, 0]                  # the last key
    key[0, 1020] = np.float32(0.5 + 1 / 128)  # off the grid: no other key
    key[0, 1021] = key[0, 1020]
    query[0, 1] = key[0, 1020]                # a key, tied by the next
    ref = references(query, key)
    assert ref[0][0, 0, 0] == n2 - 1
    np.testing.assert_array_equal(ref[0][0, 1, :2], [1020, 1021])
    for Q, S in ((2, 1), (1, 2)):
        check(emulate(query, key, Q, S), ref)


@pytest.mark.parametrize("S", [3, 4, 7])
def test_ranges_shorter_than_three_keys(S):
    """N2 = 7: ranges of 3/3/1, 2/2/2/1 and 1 key each, so most ranges
    hand the merge a placeholder (3e38, 0) that must never enter; equal
    keys across every boundary."""
    rng = np.random.RandomState(S)
    key = np.zeros((1, 7, 3), np.float32)
    key[0, :, 0] = [0.5, 0.25, 0.25, 0.75, 0.25, 0.5, 0.25]
    query = (rng.randint(0, 4, (1, 300, 3)) * 0.25).astype(np.float32)
    ref = references(query, key)
    for Q in (1, 2):
        check(emulate(query, key, Q, S), ref)


def test_x_sorted_keys_as_the_slab_fallback_passes_them(case):
    """The slab FP layer's fallback hands K3 its keys sorted by x."""
    query, key = case
    order = np.argsort(key[..., 0], axis=-1, kind="stable")
    keys = np.take_along_axis(key, order[..., None], 1)
    ref = references(query, keys)
    for Q, S in ((2, 1), (2, 2), (1, 5)):
        check(emulate(query, keys, Q, S), ref)


def test_three_queries_three_keys():
    """The smallest search: one tile, one range, every key taken."""
    key = np.array([[[0.0, 0, 0], [1, 0, 0], [0.5, 0, 0]]], np.float32)
    query = np.array([[[0.25, 0, 0], [2, 2, 2], [0.5, 0, 0]]], np.float32)
    ref = references(query, key)
    check(emulate(query, key, 1, 1), ref)
    np.testing.assert_array_equal(ref[0][0, 0], [0, 2, 1])
