"""The decompositions behind three of the port's CUDA kernels, on the CPU.

K1 (``csrc/fps.cu`` `fps_cluster_kernel`) splits each cloud into R
contiguous chunks, one per block of a thread-block cluster, takes each
chunk's argmax by a packed 64-bit key and reduces the R records.  K10 is
the same kernel over the [B*G, N/G] view of the G slices, each slice's
picks offset by its first row.  K9
(``csrc/gather_max_slab.cu``) compacts each query's covered slots into a
list of rows before it gathers, and splits that list over row groups.  The
kernels run only on the card; here numpy emulations of those decompositions
are held against the plain versions and the JAX package, and the pure
cluster-size rule of the K1 wrapper is checked for given occupancy limits.

Tolerances: none; picks, winners and pooled values are exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.ops import fps as jfps
from regnet_for_3d_grasping_tpu.ops.fps_pallas import fps_pallas_grouped

from regnet_for_3d_grasping_torch.ops import fps, slab

# --- (a) the cluster-size rule ----------------------------------------------

# a card that holds 1 block per SM in clusters of up to 8 and 16 blocks
ONE_PER_SM = {16: 8, 8: 16, 4: 33, 2: 66, 1: 132}
# the same card when two blocks fit an SM
TWO_PER_SM = {16: 16, 8: 32, 4: 66, 2: 132, 1: 264}


@pytest.mark.parametrize("batch,n,occupancy,want", [
    (1, 25600, ONE_PER_SM, 16),      # serving SA1 and the centers
    (1, 5120, ONE_PER_SM, 8),        # serving SA2: chunks of 640
    (1, 1024, ONE_PER_SM, 2),        # serving SA3: chunks of 512
    (1, 512, ONE_PER_SM, 1),
    (12, 25600, ONE_PER_SM, 8),      # training: 12 x 16 blocks do not fit
    (12, 25600, TWO_PER_SM, 16),     # ... unless two blocks share an SM
    (12, 5120, ONE_PER_SM, 8),
    (12, 1024, TWO_PER_SM, 2),
    (1, 25600, {16: -1, 8: 16, 4: 33, 2: 66}, 8),   # 16 refused
    (12, 25600, {16: 4, 8: 8, 4: 16, 2: 33, 1: 66}, 4),
    (12, 25600, {16: 4, 8: 8, 4: 8, 2: 8, 1: -1}, 16),  # none holds 12
    (12, 25600, {16: -1, 8: 8, 4: 8, 2: 8, 1: -1}, 8),
    (1, 10, ONE_PER_SM, 1),          # fewer points than MIN_CHUNK
    (1, 25601, ONE_PER_SM, 16),      # N that no R divides
    (8, 3200, ONE_PER_SM, 4),        # K10, serving: 8 slices of 3,200
    (96, 3200, ONE_PER_SM, 1),       # K10, slab training: 12 x 8 slices
    (96, 3200, TWO_PER_SM, 2),
    (1, 8177, ONE_PER_SM, 16),       # the least chunk: 512 at R = 16
    (1, 8176, ONE_PER_SM, 8),        # ... 511: R = 8
    (1, 600, {16: 8, 8: 16, 4: 33, 2: 66, 1: -1}, 2),  # none gives 512
])
def test_cluster_size(batch, n, occupancy, want):
    assert fps.cluster_size(batch, n, occupancy) == want


def test_cluster_size_raises_when_nothing_launches():
    with pytest.raises(ValueError):    # chunks beyond a block's memory
        fps.cluster_size(1, 16 * fps._MAX_BLOCK_POINTS + 1, ONE_PER_SM)
    with pytest.raises(ValueError):    # every size refused
        fps.cluster_size(1, 25600, {r: -1 for r in fps.CLUSTER_SIZES})
    # a chunk of R = 2 at 25,600 points fits a block, of R = 1 it does not
    assert 12800 <= fps._MAX_BLOCK_POINTS < 25600


# --- (b) the packed argmax key ----------------------------------------------

def test_fps_key_orders_as_value_then_index():
    """Larger distance first, lower index on a tie, over the values the
    field holds: the sentinels 1e10 (valid) and -1 (masked), +0, equal
    distances of duplicated points, tiny and large distances."""
    rng = np.random.RandomState(0)
    pool = np.float32([1e10, -1.0, 0.0, 0.0, 2.5e-3, 2.5e-3, 1e-30, 7.0,
                       3.4e38, np.finfo(np.float32).tiny, 1e10, -1.0])
    vals = np.concatenate([pool, rng.choice(pool, 200)]).astype(np.float32)
    idx = rng.permutation(len(vals)).astype(np.int64) * 997
    keys = fps.fps_key(vals, idx)
    assert keys.dtype == np.uint64 and (keys > 0).all()   # 0 = no candidate
    by_key = sorted(range(len(vals)), key=lambda i: -int(keys[i]))
    by_rule = sorted(range(len(vals)), key=lambda i: (-vals[i], idx[i]))
    assert by_key == by_rule
    # the largest index the kernel takes still orders below index 0
    assert fps.fps_key(1.0, 2**31 - 1) < fps.fps_key(1.0, 0)
    assert fps.fps_key(-1.0, 0) < fps.fps_key(0.0, 2**31 - 1)


# --- (c) the cluster decomposition of K1 ------------------------------------

def cluster_fps(xyz: np.ndarray, dist: np.ndarray, S: int, R: int):
    """numpy emulation of `fps_cluster_kernel`: per step, each of R
    contiguous chunks updates its distances in the kernel's order and
    offers its best packed key; the largest of the R keys wins."""
    B, N, _ = xyz.shape
    out = np.empty((B, S), np.int32)
    bounds = [(r * N // R, (r + 1) * N // R) for r in range(R)]
    for b in range(B):
        cur = dist[b].copy()

        def pick():
            recs = [fps.fps_key(cur[lo:hi], np.arange(lo, hi)).max()
                    if hi > lo else np.uint64(0) for lo, hi in bounds]
            return 0xFFFFFFFF - (int(max(recs)) & 0xFFFFFFFF)

        far = pick()
        for s in range(S):
            out[b, s] = far
            if s + 1 == S:
                break
            dx, dy, dz = (xyz[b, :, i] - xyz[b, far, i] for i in range(3))
            d = (dx * dx + dy * dy) + dz * dz
            cur = np.where(cur < 0, cur, np.where(d < cur, d, cur))
            far = pick()
    return out


@functools.lru_cache(maxsize=None)
def fps_case(name: str):
    """(xyz [B, N, 3], mask [B, N] or None, S) of a small case."""
    rng = np.random.RandomState(sum(map(ord, name)))
    N = 37
    xyz = rng.rand(3, N, 3).astype(np.float32)
    mask = None
    S = 20
    if name == "duplicates":
        # each point 4 times over, a copy in every quarter of the cloud, so
        # equal distances sit in different chunks
        xyz = np.tile(rng.rand(3, 10, 3).astype(np.float32), (1, 4, 1))
        N = 40
    elif name == "masked":
        mask = rng.rand(3, N) < 0.5
        mask[1] = False                  # falls back to all valid
        xyz[2, :, 0] = np.nan            # NaN x: every point masked
    elif name == "exhausted":
        mask = np.zeros((3, N), bool)    # S beyond the valid count
        mask[:, [3, 11, 19, 20, 33]] = True
    elif name == "tiny":
        xyz = np.ascontiguousarray(xyz[:, :10])  # fewer points than R = 16
        S = 12
    return xyz, mask, S


@functools.lru_cache(maxsize=None)
def jax_fps(name: str) -> np.ndarray:
    xyz, mask, S = fps_case(name)
    return np.asarray(jfps.farthest_point_sample(
        jnp.asarray(xyz), S, None if mask is None else jnp.asarray(mask)))


@pytest.mark.parametrize("R", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", ["unmasked", "duplicates", "masked",
                                  "exhausted", "tiny"])
def test_cluster_decomposition_matches_plain_and_jax(name, R):
    xyz, mask, S = fps_case(name)
    d = fps.dist_init(torch.from_numpy(xyz),
                      None if mask is None else torch.from_numpy(mask))
    got = cluster_fps(xyz, d.numpy(), S, R)
    plain = fps.fps_plain(torch.from_numpy(xyz), d, S).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_fps(name))


# --- (d) K10: the cluster kernel over the slices ----------------------------

def grouped_cluster_fps(xyz: np.ndarray, dist: np.ndarray, S: int, G: int,
                        R: int):
    """numpy emulation of K10: `cluster_fps` over the [B*G, N/G] view,
    cluster b's picks offset by (b % G) * N/G as the kernel stores them,
    the [B*G, S/G] result read as [B, S]."""
    B, N, _ = xyz.shape
    L = N // G
    out = cluster_fps(xyz.reshape(B * G, L, 3), dist.reshape(B * G, L),
                      S // G, R)
    return (out + (np.arange(B * G) % G * L)[:, None]).reshape(B, S)


@functools.lru_cache(maxsize=None)
def grouped_case(name: str):
    """(xyz [B, N, 3], mask [B, N] or None, S, G) of a small grouped case."""
    rng = np.random.RandomState(sum(map(ord, name)) + 1)
    B, G, L, S = 2, 4, 40, 48
    xyz = rng.rand(B, G * L, 3).astype(np.float32)
    mask = None
    if name == "masked":                 # as at the center pick
        mask = xyz[..., 2] > 0.4
    elif name == "slice-masked":         # slice 1 of cloud 0: no valid point
        mask = xyz[..., 2] > 0.4
        mask[0, L:2 * L] = False
    elif name == "tiny-slices":          # 10 points a slice, S/G beyond it
        L = 10
        xyz = np.ascontiguousarray(xyz[:, :G * L])
    return xyz, mask, S, G


@functools.lru_cache(maxsize=None)
def jax_grouped(name: str) -> np.ndarray:
    """JAX's grouped FPS and its Pallas kernel in interpret mode, which
    must agree."""
    xyz, mask, S, G = grouped_case(name)
    B, N, _ = xyz.shape
    jm = None if mask is None else jnp.asarray(mask)
    ref = np.asarray(jfps.farthest_point_sample(jnp.asarray(xyz), S, jm,
                                                groups=G))
    dist = jfps._dist_init(jnp.asarray(xyz).reshape(B * G, N // G, 3),
                           None if jm is None else jm.reshape(B * G, N // G))
    pal = np.asarray(fps_pallas_grouped(jnp.asarray(xyz), dist.reshape(B, N),
                                        S, G, interpret=True))
    np.testing.assert_array_equal(pal, ref)
    return ref


@pytest.mark.parametrize("R", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", ["unmasked", "masked", "slice-masked",
                                  "tiny-slices"])
def test_grouped_cluster_decomposition_matches_plain_and_jax(name, R):
    xyz, mask, S, G = grouped_case(name)
    B, N, _ = xyz.shape
    d = fps.dist_init(torch.from_numpy(xyz).reshape(B * G, N // G, 3),
                      None if mask is None else
                      torch.from_numpy(mask).reshape(B * G, N // G))
    d = d.reshape(B, N)
    got = grouped_cluster_fps(xyz, d.numpy(), S, G, R)
    plain = fps.fps_grouped_plain(torch.from_numpy(xyz), d, S, G).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_grouped(name))
    # slice-major: the picks of slice g lie in [g*N/G, (g+1)*N/G)
    assert (got.reshape(B, G, -1) // (N // G)
            == np.arange(G)[None, :, None]).all()


# --- (e) the compacted gather of K9 -----------------------------------------

def compacted_pool(fs, index, off_blk, win, spw, groups, argmax):
    """numpy emulation of `gather_max_slab_kernel`: per query the covered
    rows in slot order, a row that the slot before repeats kept once; the
    list dealt round-robin to `groups` row groups, each keeping its max
    (argmax form: its first strict max) and the groups combined."""
    cover = slab.slab_cover(torch.from_numpy(index), torch.from_numpy(off_blk),
                            win, spw).numpy()
    B, S, K = index.shape
    C = fs.shape[-1]
    pooled = np.empty((B, S, C), np.float32)
    winner = np.zeros((B, S, C), np.int32)
    for b in range(B):
        for s in range(S):
            rows = np.where(cover[b, s], index[b, s], -1)
            keep = (rows >= 0) & (rows != np.r_[-1, rows[:-1]])
            lst = rows[keep]
            m = np.full((groups, C), -1e38, np.float32)
            pos = np.full((groups, C), np.iinfo(np.int32).max)
            for i, r in enumerate(lst):
                g, v = i % groups, fs[b, r]
                better = v > m[g]
                m[g] = np.where(better, v, m[g])
                pos[g] = np.where(better, i, pos[g])
            top = m.max(0)
            first = np.where(m == top, pos, np.iinfo(np.int32).max).min(0)
            pooled[b, s] = top
            if argmax:
                has = first < np.iinfo(np.int32).max
                winner[b, s] = np.where(has, lst[np.where(has, first, 0)]
                                        if len(lst) else 0, 0)
    return pooled, winner


def pool_case(win, spw):
    """Indices at (win, spw) geometry over 2 clouds of 6,144 rows: most
    slots covered, runs of repeated rows (as padded regions have), a query
    with no covered slot, and ReLU features (ties at 0)."""
    rng = np.random.RandomState(win + spw)
    B, S, N, C = 2, 7, 6144, 12
    rps = (2048 // win) * spw
    K = 2 * rps
    off = rng.randint(0, 2, (B, 1)).astype(np.int32)
    k = np.arange(K)
    base = (off[:, :, None] + k // rps) * 2048 + (k % rps) // spw * win
    index = base + rng.randint(0, win, (B, S, K))
    stray = rng.rand(B, S, K) < 0.3          # rows outside their window
    index = np.where(stray, rng.randint(0, N, (B, S, K)), index)
    rep = rng.rand(B, S, K) < 0.4            # repeat the slot before
    for j in range(1, K):
        index[..., j] = np.where(rep[..., j], index[..., j - 1],
                                 index[..., j])
    index[1, 3] = (base[1, 0] + win) % N     # never in its own window
    fs = np.maximum(rng.randn(B, N, C), 0).astype(np.float32)
    return fs, index.astype(np.int32), off


@pytest.mark.parametrize("groups", [1, 3, 4])
@pytest.mark.parametrize("win,spw", [(slab.GROUP_WIN, slab.GROUP_SPW),
                                     (slab.CROP_WIN, slab.CROP_SPW)])
def test_compacted_gather_matches_plain(win, spw, groups):
    fs, index, off = pool_case(win, spw)
    t = torch.from_numpy
    cover = slab.slab_cover(t(index), t(off), win, spw)
    assert not cover[1, 3].any() and cover.float().mean() > 0.3
    pooled, _ = compacted_pool(fs, index, off, win, spw, groups, False)
    plain = slab.gather_max_slab_plain(t(fs), t(index), t(off), win, spw)
    np.testing.assert_array_equal(pooled, plain.numpy())
    assert (pooled[1, 3] == np.float32(-1e38)).all()
    pooled, winner = compacted_pool(fs, index, off, win, spw, groups, True)
    ref = slab.gather_max_slab_argmax_plain(t(fs), t(index), t(off), win, spw)
    np.testing.assert_array_equal(pooled, ref[0].numpy())
    np.testing.assert_array_equal(winner, ref[1].numpy())
