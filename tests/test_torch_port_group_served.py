"""The served region grouping (K12, ``csrc/group.cu``), on the CPU.

On the full scan the port groups as the JAX package does on every backend:
its chunked XLA path (``geometry/region.py:160-185``), since the JAX
package's Pallas grouping is off (``_PALLAS_GROUP_THRESHOLD = None``).  The
JAX side runs unpatched.  K12 computes that function on the card; here its
plain version (the chunked loop) is held against the JAX package, and a
numpy emulation of K12's scan (buckets of ceil(N / K) columns staged in
multiples of 32 slots, windows where a bucket is wider than a block
stages, the expansion-form test, the chunked hash compared as f32, ties to
the first column) against the plain version.  K11, the fused grouping, is
no longer on a model path; its entry point is held against JAX's Pallas
grouping in ``tests/test_torch_port_train.py``.  The whole tiny model at a
shape where that threshold sent grouping to K11 is
``tests/test_torch_port_model.py::test_slice_groups_as_the_jax_package``,
where it shares that file's compiled JAX ops.

JAX's grouping runs compiled (`jax.jit`), as the JAX package runs it when
it serves and trains.  Run eagerly, ``lax.map`` traces the chunk's body
with the cloud as a constant, and XLA folds the cloud's norms |p|^2 at
another rounding (3 of a tiny model's 4,096 picks moved so).

Tolerances: indices, counts and masks exact.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_torch.geometry import region
from regnet_for_3d_grasping_torch.ops import bucket_scan, group, sampling
from regnet_for_3d_grasping_torch.ops.distances import bpdist2

from test_torch_port_bucket_scan import (SEG_COLS, STAGE_COLS, WARPS,
                                         WIN_COLS, H100_SMS, cxx_constant,
                                         key64, warp_key, key_rel)
jregion = importlib.import_module("regnet_for_3d_grasping_tpu.geometry.region")

MAX_CHUNKS = cxx_constant("bucket_scan.cuh", "kMaxChunks")


def t(a):
    return torch.from_numpy(np.array(a))


def jax_group(key, pc, centers, K, radius):
    """JAX's `group_regions`, unpatched, compiled: its index and valid."""
    out = jax.jit(lambda k, p, c: jregion.group_regions(
        k, p, c, K, radius, with_points=False))(key, pc, centers)
    return out.index, out.valid


def chunk_seeds(key, n_chunks) -> list:
    keys = jax.random.split(key, n_chunks)
    return [int(s) for s in np.asarray(jax.random.key_data(keys))[:, -1]]


def cloud(B, N, M, seed, extent=0.3):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(B, N, 3) * extent).astype(np.float32)
    centers = xyz[:, rng.choice(N, M)] + np.float32(0.001)
    return xyz, centers


# --- the served grouping against the JAX package, unpatched ----------------

@pytest.mark.parametrize("B,N,M,K,radius", [
    (1, 25600, 64, 256, 0.05),     # the training shape (one chunk)
    (1, 4096, 4000, 256, 0.08),    # 4 chunks, the last padded
    (2, 2048, 600, 64, 0.06),      # 600 x 2,048 > 2^20
])
def test_served_grouping_is_the_jax_package_s(B, N, M, K, radius):
    """`region.group_regions` on the full scan equals the JAX package's
    `group_regions` as it runs (no dispatch patched), index for index, at
    shapes where a work threshold (NC*N >= 2^20, K a multiple of 8) once
    sent the port's grouping to K11, another function."""
    assert M * N >= 1 << 20 and K % 8 == 0
    xyz, centers = cloud(B, N, M, N + M)
    key = jax.random.PRNGKey(M)
    ref_index, ref_valid = jax_group(key, jnp.asarray(xyz),
                                     jnp.asarray(centers), K, radius)
    n = region.group_seed_count(M, N, K)
    assert n == -(-M // 1024) == region.group_chunks(M)
    got = region.group_regions(chunk_seeds(key, n), t(xyz), t(centers), K,
                               radius)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(ref_index))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref_valid))
    assert got.slab_off is None and got.index.dtype == torch.int32
    assert region.group_stride(M, N, K) == jregion.group_stride(M, N, K) \
        == sampling.bucket_stride(N, K)


def test_chunked_plain_is_the_served_path():
    """K12's plain version, given `region.group_regions`' chunk, is what
    `group_regions` returns; the wrapper refuses a wrong number of seeds."""
    xyz, centers = cloud(1, 3000, 2100, 4, 0.1)
    seeds = [5, 6, 7]
    idx, count = group.group_regions_chunked(t(xyz), t(centers), seeds,
                                             0.01, 32, 1024)
    got = region.group_regions(seeds, t(xyz), t(centers), 32, 0.01)
    assert torch.equal(got.index, idx) and torch.equal(got.valid, count > 0)
    d2 = bpdist2(t(centers), t(xyz))
    assert torch.equal(count, (d2 <= group.radius2(0.01)).sum(-1,
                       dtype=torch.int32))
    with pytest.raises(ValueError, match="seeds"):
        group.group_regions_chunked(t(xyz), t(centers), seeds[:2], 0.01, 32,
                                    1024)


# --- K12's scan, emulated ---------------------------------------------------

def lowbias32(x):
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        for _ in range(2):
            x = x ^ (x >> np.uint32(16))
            x = x * np.uint32(0x45D9F3B)
        return x ^ (x >> np.uint32(16))


def chunk_row(b, m, n, chunk, seeds):
    """ChunkHash::row: the chunk's linear index of (b, m, column 0) times
    2654435761 plus the chunk's seed times 0x9E3779B9, in uint32."""
    k = min(m // chunk, len(seeds) - 1)
    with np.errstate(over="ignore"):
        lin = (np.uint32(b) * np.uint32(chunk) + np.uint32(m - k * chunk)) \
            * np.uint32(n)
        return lin * np.uint32(2654435761) \
            + np.uint32(seeds[k]) * np.uint32(0x9E3779B9)


def chunk_score(row, j):
    """ChunkHash::score: the mix's float, as its bits (they order as the
    floats do)."""
    with np.errstate(over="ignore"):
        x = np.uint32(row) + np.asarray(j, np.uint32) * np.uint32(2654435761)
    return lowbias32(x).astype(np.float32).view(np.uint32)


def expansion_test(centers):
    """ExpansionTest: (|c|^2 - 2 cross) + |p|^2 <= r2, cross = fma(cz, pz,
    fma(cy, py, cx*px)), the fused multiply-adds in f64 and rounded once
    (exact here: no operand of these tests is small enough for the f64 sum
    to round)."""
    def f(b, m, pts, r2):
        c = centers[b, m]
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        cross = np.float32(np.float64(c[2]) * z + np.float32(
            np.float64(c[1]) * y + (c[0] * x)))
        c2 = (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]
        p2 = (x * x + y * y) + z * z
        d2 = np.float32(np.float64(c2) - 2.0 * np.float64(cross)) + p2
        return d2 <= np.float32(r2)
    return f


def emulate_k12(xyz, centers, seeds, r2, K, chunk, tile, rng, per_warp=8):
    """The scan and fill of csrc/bucket_scan.cuh with K12's Test and Pick,
    in numpy: a block stages its range's buckets `lp` slots apart (NaN in
    the pad and past N), all at once or, where its one bucket is wider
    than a block stages, in windows of WIN_COLS; each center's bucket is
    scanned in segments of up to SEG_COLS slots and keeps the best key."""
    B, N, _ = xyz.shape
    M = centers.shape[1]
    L = sampling.bucket_stride(N, K)
    lp = bucket_scan.staged_width(L)
    nb = -(-N // L)
    nranges = bucket_scan.ranges(N, L, rng)
    stride = rng * lp
    wide = lp > SEG_COLS
    win = stride if not wide or stride <= STAGE_COLS else WIN_COLS
    test = expansion_test(centers)
    idx = np.full((B, M, K), -7, np.int64)
    met = np.zeros((B, M, N), np.int64)     # columns a center tested
    partial = np.zeros((B, M, nranges), np.int64)
    for b in range(B):
        for t_id in range(-(-M // tile)):
            for r_id in range(nranges):
                col0 = r_id * rng * L
                cols = min(rng * L, N - col0)
                nbk = -(-cols // L)
                if wide:
                    end = (nbk - 1) * lp + -(-(cols - (nbk - 1) * L) // 32) \
                        * 32
                else:
                    end = nbk * lp
                best = {}
                for w0 in range(0, end, win):
                    s = np.arange(w0, min(w0 + win, end))
                    kk_s, v = s // lp, s % lp
                    col = kk_s * L + v
                    ok = (v < L) & (col < cols)
                    staged = np.full((len(s), 3), np.nan, np.float32)
                    staged[ok] = xyz[b, col0 + col[ok]]
                    for m in range(t_id * tile, min(M, t_id * tile + tile)):
                        row = chunk_row(b, m, N, chunk, seeds)
                        for kk in range(nbk):
                            b0, b1 = kk * lp, min(kk * lp + lp, end)
                            lo, hi = max(b0, w0), min(b1, w0 + win)
                            if lo >= hi:
                                continue
                            c_first = col0 + kk * L
                            if lo == b0:
                                best[m, kk] = None
                            for seg in range(lo, hi, SEG_COLS):
                                sl = slice(seg - w0, min(seg + SEG_COLS, hi)
                                           - w0)
                                rel = np.arange(sl.start, sl.stop) + w0 - b0
                                hit = test(b, m, staged[sl], r2)
                                real = ok[sl]
                                met[b, m, col0 + col[sl][real]] += 1
                                partial[b, m, r_id] += int(hit.sum())
                                if not hit.any():
                                    continue
                                lanes = np.zeros(32, np.uint64)
                                sc = chunk_score(row, c_first + rel)
                                for i in np.flatnonzero(hit):
                                    r = int(rel[i])
                                    lanes[r % 32] = max(lanes[r % 32],
                                                        key64(sc[i], r))
                                k = warp_key(lanes)
                                old = best[m, kk]
                                best[m, kk] = k if old is None else max(old,
                                                                        k)
                            if hi == b1:
                                k = best[m, kk]
                                idx[b, m, kk + r_id * rng] = -1 if k is None \
                                    else c_first + key_rel(k)
    assert (met == 1).all()       # every column tested once by every center
    count = partial.sum(-1)
    picks = idx[..., :nb]
    assert (picks != -7).all()
    has = picks >= 0
    first = np.where(has.any(-1), np.take_along_axis(
        picks, has.argmax(-1)[..., None], -1)[..., 0], 0)
    out = np.where(np.arange(K) < nb, idx, -1)
    out = np.where(out >= 0, out, first[..., None])
    return out.astype(np.int32), count.astype(np.int32)


@pytest.mark.parametrize("B,N,M,K,chunk,radius", [
    (2, 1100, 130, 16, 50, 0.1),    # L 69 staged as 96, 3 chunks, padded
    (1, 700, 20, 256, 8, 0.15),     # L 3 (32 slots), K*L > N
    (1, 2600, 9, 2, 4, 0.12),       # L 1,300 (1,312 slots): 2 segments
    (1, 9000, 3, 2, 2, 0.08),       # L 4,500 (4,512): windows, cut at N
])
def test_k12_emulation_matches_the_plain_chunked_path(B, N, M, K, chunk,
                                                      radius):
    xyz, centers = cloud(B, N, M, 7 * N + M, 0.25)
    centers[:, -1] = 5.0      # a center far from every point
    seeds = [0x9E3779B9 * (i + 3) & 0xFFFFFFFF for i in range(-(-M // chunk))]
    ref = group.group_regions_chunked_plain(t(xyz), t(centers), seeds,
                                            radius, K, chunk)
    L = sampling.bucket_stride(N, K)
    lp = bucket_scan.staged_width(L)
    assert lp % 32 == 0 and L <= lp < L + 32
    grid = bucket_scan.scan_grid(B, M, N, K, L, H100_SMS, 8, STAGE_COLS, lp)
    for tile, rng in {grid, (8, 1)}:
        got = emulate_k12(xyz, centers, seeds, group.radius2(radius), K,
                          chunk, tile, rng)
        np.testing.assert_array_equal(got[1], ref[1].numpy())
        np.testing.assert_array_equal(got[0], ref[0].numpy())
    assert (ref[1][:, -1] == 0).all() and (ref[1] > 0).sum() > B


def test_k12_ties_in_f32_go_to_the_first_column():
    """Two hashes that round to one f32 tie (argmax over the uniforms picks
    the first), though their u32 values differ: a seed where the largest
    scores of one bucket collide, found by search (about one seed in
    20,000), and both the plain path and the emulated key pick the
    first."""
    N, K = 400, 4                        # buckets of 100 columns
    n_found = 0
    for seed in range(20000):
        row = chunk_row(0, 0, N, 1, [seed])
        bits = chunk_score(row, np.arange(100))
        raw = lowbias32(np.uint32(row) + np.arange(100, dtype=np.uint32)
                        * np.uint32(2654435761))
        vals, inv, cnt = np.unique(bits, return_inverse=True,
                                   return_counts=True)
        top = np.flatnonzero(bits == bits.max())
        if len(top) < 2:
            continue
        assert len(set(raw[top])) == len(top)   # different u32, one f32
        n_found += 1
        # every column of bucket 0 in radius of the one center, none else
        xyz = np.full((1, N, 3), 9.0, np.float32)
        xyz[0, :100] = np.float32(0.5)
        centers = np.full((1, 1, 3), 0.5, np.float32)
        idx, count = group.group_regions_chunked_plain(
            t(xyz), t(centers), [seed], 0.01, K, 1)
        assert idx[0, 0, 0] == top[0] and count[0, 0] == 100
        got, _ = emulate_k12(xyz, centers, [seed], group.radius2(0.01), K,
                             1, 8, 1)
        assert got[0, 0, 0] == top[0]
        break
    assert n_found == 1


def test_k12_constants_and_grid():
    """The staged width, the grid rule at the served shapes (L = 100 staged
    as 128) and the launch's seed capacity."""
    assert MAX_CHUNKS == 64 and WARPS == 8
    assert bucket_scan.staged_width(100) == 128
    assert bucket_scan.staged_width(128) == 128
    for batch, m in ((1, 4000), (12, 64), (1, 64)):
        tile, rng = bucket_scan.scan_grid(batch, m, 25600, 256, 100,
                                          H100_SMS, 8, STAGE_COLS, 128)
        assert rng * 128 <= STAGE_COLS and tile <= 64
        assert batch * -(-m // tile) * bucket_scan.ranges(25600, 100, rng) \
            >= H100_SMS
    with pytest.raises(ValueError):     # staged below the bucket
        bucket_scan.scan_grid(1, 64, 25600, 256, 100, H100_SMS, 8,
                              STAGE_COLS, 96)
    with pytest.raises(ValueError):     # the bucket not staged as a multiple
        bucket_scan.scan_grid(1, 64, 25600, 256, 100, H100_SMS, 8,
                              STAGE_COLS)
