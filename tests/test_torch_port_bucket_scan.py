"""The center-tiled bucket scan behind K11, K5 and K2, on the CPU.

K11 (``csrc/group.cu``), K5 (``csrc/crop.cu``) and K2
(``csrc/ball_query.cu``) run one kernel body (``csrc/bucket_scan.cuh``): a
block owns a tile of centers (C per warp) x a range of buckets whose
columns it stages (a bucket wider than a block stages in windows of whole
1,024-column segments), keeps one hit bit per (center, 32-column step) of
a segment, and picks a bucket's column from its segments' hits (K11, K5:
each hit's hash score and place packed into a key whose warp-wide maximum
is the pick; K2: the warp-wide minimum of the lanes' first hits), writes
each slot it owns (pick or -1) and one partial count per center; a fill
pass sums the partials (K2: capped at K) and fills the empty buckets.  The kernels run
only on the card; here a numpy emulation of that decomposition, block by
block and lane by lane, is held against the plain versions and against the
JAX Pallas kernels in interpret mode, and the pure grid rule
`ops.bucket_scan.scan_grid` is checked at the shapes the paths launch.

Tolerances: none; indices and counts are exact.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.ops.ball_query_pallas import (
    ball_query_pallas)
from regnet_for_3d_grasping_tpu.ops.crop_pallas import (
    closing_region_crop_pallas)
from regnet_for_3d_grasping_tpu.ops.group_pallas import group_regions_pallas

from regnet_for_3d_grasping_torch.geometry.codec import grasps_to_frames
from regnet_for_3d_grasping_torch.ops import (ball_query, bucket_scan, crop,
                                              group)
from regnet_for_3d_grasping_torch.ops.sampling import pallas_bucket_stride

H100_SMS = 132
CSRC = Path(__file__).resolve().parents[1] / "regnet_for_3d_grasping_torch" \
    / "csrc"


def cxx_constant(source, name):
    """The int constant `name` of a CUDA source: the kernels own the
    scan's constants and the wrappers read them from the built library,
    which needs a card; here they are read from the source itself."""
    found = re.findall(rf"\b{name} = (\d+);", (CSRC / source).read_text())
    assert len(found) == 1, f"{name} in {source}: {found}"
    return int(found[0])


# centers per warp of the radius test that K11 and K2 share
GROUP_C = cxx_constant("bucket_scan.cuh", "kPerWarp")
CROP_C = cxx_constant("crop.cu", "kPerWarp")
STAGE_COLS = cxx_constant("bucket_scan.cuh", "kMaxStageCols")
WARPS = cxx_constant("bucket_scan.cuh", "kWarps")
# bucket_scan.cuh's kSegCols (the columns of a lane's 32 hit bits) and
# kWinCols (the window of a bucket wider than STAGE_COLS)
SEG_COLS = 32 * 32
WIN_COLS = STAGE_COLS // SEG_COLS * SEG_COLS


def t(a):
    return torch.from_numpy(np.array(a))


# --- (a) the grid rule ------------------------------------------------------

@pytest.mark.parametrize("batch,m,n,k,per_warp,want", [
    (1, 4000, 25600, 256, GROUP_C, (64, 11)),  # K11 serving
    (12, 64, 25600, 256, GROUP_C, (64, 2)),    # K11 training
    (1, 64, 25600, 256, GROUP_C, (64, 1)),     # validation
    (1, 4000, 25600, 64, CROP_C, (16, 7)),     # K5 serving
    (12, 64, 25600, 64, CROP_C, (16, 2)),      # K5, 12 x 64
    (1, 1, 1100, 16, GROUP_C, (8, 1)),         # fills nothing
    (1, 5120, 25600, 64, GROUP_C, (64, 3)),    # K2 serving (SA1)
    (12, 5120, 25600, 64, GROUP_C, (64, 7)),   # K2 training (SA1, B = 12)
    (1, 1400, 25600, 24, GROUP_C, (64, 1)),    # K2, L = 1152: 2 segments
    (1, 1400, 25600, 8, GROUP_C, (64, 1)),     # K2, L = 3200: 4 segments
    (1, 1400, 25600, 4, GROUP_C, (32, 1)),     # L = 6400: windows
])
def test_scan_grid_at_path_shapes(batch, m, n, k, per_warp, want):
    L = pallas_bucket_stride(n, k)
    tile, rng = bucket_scan.scan_grid(batch, m, n, k, L, H100_SMS, per_warp,
                                      STAGE_COLS)
    assert (tile, rng) == want
    nb = -(-n // L)
    blocks = batch * -(-m // tile) * bucket_scan.ranges(n, L, rng)
    assert blocks == batch * -(-m // tile) * -(-nb // rng)
    assert (rng * L <= STAGE_COLS or rng == 1) and tile <= 64
    assert (WARPS * per_warp) % tile == 0
    if n == 25600:              # every path shape fills a wave of SMs
        assert blocks >= H100_SMS


@pytest.mark.parametrize("batch,blocks,staged", [(1, 1360, 1536),
                                                 (12, 7680, 3584)])
def test_k2_grid_at_sa1(batch, blocks, staged):
    """K2 at SA1 (5,120 centers, 25,600 points, L = 512: 50 buckets that
    hold a point): 80 tiles of 64 x 17 ranges of 3 buckets at serving; at
    batch 12, 7 buckets a range, exactly the staging limit."""
    L = pallas_bucket_stride(25600, 64)
    assert L == 512
    tile, rng = bucket_scan.scan_grid(batch, 5120, 25600, 64, L, H100_SMS,
                                      GROUP_C, STAGE_COLS)
    assert batch * -(-5120 // tile) * bucket_scan.ranges(25600, L, rng) \
        == blocks
    assert rng * L == staged <= STAGE_COLS


def test_scan_grid_refuses_uncovered_and_odd_buckets():
    with pytest.raises(ValueError):
        bucket_scan.scan_grid(1, 64, 25600, 64, 384, H100_SMS, 8, STAGE_COLS)
    with pytest.raises(ValueError):
        bucket_scan.scan_grid(1, 64, 1000, 16, 100, H100_SMS, 8, STAGE_COLS)
    with pytest.raises(ValueError):
        bucket_scan.scan_grid(1, 64, 1000, 64, 16, H100_SMS, 8, STAGE_COLS)


# --- (b) the packed pick key ------------------------------------------------

def key64(score, rel):
    """csrc/bucket_scan.cuh HashPick::key: (score + 1) over the complement
    of the place, as uint64."""
    return ((np.uint64(score) + 1) << np.uint64(32)) \
        | np.uint64(0xFFFFFFFF - rel)


def warp_key(keys):
    """HashPick::warp_key over the lanes' best keys [32] -> the high
    words' maximum over the low words' maximum among its lanes."""
    hi = keys >> np.uint64(32)
    lo = np.where(hi == hi.max(), keys & np.uint64(0xFFFFFFFF), 0)
    return (int(hi.max()) << 32) | int(lo.max())


def key_rel(key):
    """A key's place in its bucket (HashPick::rel, and FirstPick's with the
    emulation's first-pick key, the complement of the place)."""
    return 0xFFFFFFFF - (key & 0xFFFFFFFF)


def warp_rel(keys):
    return key_rel(warp_key(keys))


@pytest.mark.parametrize("top", [127, 511, 1023, 4607])
def test_pick_key_orders_score_then_first_place(top):
    """Places up to `top` (buckets of L = top + 1 columns; past 1,024 a
    warp packs one segment's places at a time)."""
    score_max = (1 << 23) - 1
    assert key64(score_max, 0) < (1 << 64)
    assert key64(5, 7) > key64(5, 9) > key64(4, 0) > key64(0, top) > 0
    rng = np.random.RandomState(top)
    for _ in range(200):
        rel = rng.choice(top + 1, 40, replace=False)
        score = rng.randint(0, 4, 40)          # many ties
        keys = np.zeros(32, np.uint64)
        for s, r in zip(score, rel):           # lane = rel % 32
            keys[r % 32] = max(keys[r % 32], key64(s, r))
        best = score.max()
        assert warp_rel(keys) == rel[score == best].min()
        # two segments' keys: the better is the larger
        assert max(warp_key(keys), int(key64(best, top + 1))) \
            == warp_key(keys)


# --- (c) the emulation ------------------------------------------------------

def hash23(m, seed, j):
    m, j = np.uint32(m), np.asarray(j, np.uint32)
    with np.errstate(over="ignore"):
        h = (m * np.uint32(0x9E3779B9) + np.uint32(seed)) \
            + j * np.uint32(2654435761)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x45D9F3B)
        h ^= h >> np.uint32(16)
    return h >> np.uint32(9)


def ball_test(centers, r2, strict=False):
    """[B, M, 3] -> pass(b, m, points [n, 3]) as csrc/bucket_scan.cuh's
    BallTest: d = center - point, (dx*dx + dy*dy) + dz*dz <= r2 (K11) or
    < r2 (`strict`, K2), each step in f32."""
    def f(b, m, pts):
        d = centers[b, m] - pts
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        return d2 < np.float32(r2) if strict else d2 <= np.float32(r2)
    return f


def box_test(frames, centers, box):
    """As csrc/crop.cu: r = point - center, loc_j = (F0j*r0 + F1j*r1) +
    F2j*r2, then the open box."""
    xlo, xhi, yabs, zabs = (np.float32(v) for v in box)

    def f(b, m, pts):
        r = pts - centers[b, m]
        F = frames[b, m]
        loc = [(F[0, j] * r[:, 0] + F[1, j] * r[:, 1]) + F[2, j] * r[:, 2]
               for j in range(3)]
        return ((loc[0] > xlo) & (loc[0] < xhi) & (np.abs(loc[1]) < yabs)
                & (np.abs(loc[2]) < zabs))
    return f


def hash_pick(m, seed, col, rel, hit):
    """HashPick::warp_key for one segment of a bucket, its places `rel` in
    the bucket (lane = place % 32) and their hits: each lane's best key
    over its hits, then the warp's largest; the larger key is the better."""
    lanes = np.zeros(32, np.uint64)
    sc = hash23(m, seed, col + rel)
    for i in np.flatnonzero(hit):
        r = int(rel[i])
        lanes[r % 32] = max(lanes[r % 32], key64(sc[i], r))
    return warp_key(lanes)


def first_pick(m, seed, col, rel, hit):
    """FirstPick::warp_key for one segment: each lane's first hit (its
    lowest set bit s, place seg + 32*s + lane), then the warp's least
    place, returned as its complement so that here too the larger key is
    the better."""
    hits = hit.reshape(-1, 32)                 # [steps, lanes]
    first = np.where(hits.any(0), rel[0] + hits.argmax(0) * 32
                     + np.arange(32), 0xFFFFFFFF)
    return 0xFFFFFFFF - int(first.min())


def emulate(test, xyz, M, K, L, seed, tile, rng, per_warp, pick=hash_pick,
            cap=None):
    """The two launches of csrc/bucket_scan.cuh in numpy, for a grid of
    `tile` centers x `rng` buckets per block: each block stages its columns
    (all at once, or windows of WIN_COLS where its one bucket is wider than
    STAGE_COLS) and NaN up to its last bucket's end (L up to SEG_COLS) or
    the next multiple of 32 past N (wider buckets); a warp tests a bucket's
    columns in segments of up to SEG_COLS, and keeps the best of the
    segments' `pick` keys; the fill caps counts at `cap`."""
    B, N, _ = xyz.shape
    nb = -(-N // L)
    nranges = bucket_scan.ranges(N, L, rng)
    stride = rng * L
    win = stride if stride <= STAGE_COLS else WIN_COLS
    assert win % 32 == 0 and (stride <= STAGE_COLS or rng == 1)
    idx = np.full((B, M, K), -7, np.int64)          # never-written marker
    owner = np.zeros((B, M, K), np.int64)
    scanned = np.zeros((B, M, nb * L), np.int64)    # columns a center met
    partial = np.full((B, M, nranges), -7, np.int64)
    groups = tile // per_warp
    per_group = WARPS // groups
    for b in range(B):
        for t_id in range(-(-M // tile)):
            for r_id in range(nranges):
                col0 = r_id * stride
                cols = min(stride, N - col0)
                nbk = -(-cols // L)
                # a bucket of one segment is scanned to its end
                end = nbk * L if L <= SEG_COLS else -(-cols // 32) * 32
                s_cnt = np.zeros(tile, np.int64)
                best = {}                        # (warp, c) -> its best key
                for w0 in range(0, cols, win):
                    staged = np.full((min(win, end - w0), 3), np.nan,
                                     np.float32)
                    wc = min(win, cols - w0)
                    staged[:wc] = xyz[b, col0 + w0:col0 + w0 + wc]
                    for warp in range(WARPS):
                        sub, g = warp % per_group, warp // per_group
                        m0 = t_id * tile + g * per_warp
                        if m0 >= M:
                            continue
                        for kk in range(sub, nbk, per_group):
                            b0, b1 = kk * L, min(kk * L + L, end)
                            lo, hi = max(b0, w0), min(b1, w0 + win)
                            if lo >= hi:
                                continue
                            col = col0 + b0
                            for c in range(per_warp):
                                m = min(m0 + c, M - 1)
                                if lo == b0:
                                    best[warp, c] = None
                                for seg in range(lo, hi, SEG_COLS):
                                    n_s = min(SEG_COLS, hi - seg)
                                    rel = np.arange(seg, seg + n_s) - b0
                                    hit = test(b, m, staged[seg - w0:
                                                            seg - w0 + n_s])
                                    if m0 + c < M:
                                        scanned[b, m0 + c,
                                                col0 + seg:col0 + seg + n_s] \
                                            += 1
                                    s_cnt[g * per_warp + c] += int(hit.sum())
                                    if hit.any():
                                        k = pick(m0 + c, seed, col, rel, hit)
                                        old = best[warp, c]
                                        best[warp, c] = k if old is None \
                                            else max(old, k)
                                if hi == b1 and m0 + c < M:
                                    k = best[warp, c]
                                    idx[b, m0 + c, col // L] = -1 \
                                        if k is None else col + key_rel(k)
                                    owner[b, m0 + c, col // L] += 1
                rows = t_id * tile + np.arange(tile)
                ok = rows < M
                partial[b, rows[ok], r_id] = s_cnt[ok]
    # every scanned slot has exactly one owner, the others were never
    # written, and every column of the cloud was met once by every center
    assert (owner[..., :nb] == 1).all() and (owner[..., nb:] == 0).all()
    assert (scanned[..., :N] == 1).all() and (scanned[..., N:] <= 1).all()
    assert (partial >= 0).all()
    count = partial.sum(-1)
    if cap is not None:
        count = np.minimum(count, cap)
    picks = idx[..., :nb]
    has = picks >= 0
    first = np.where(has.any(-1), np.take_along_axis(
        picks, has.argmax(-1)[..., None], -1)[..., 0], 0)
    out = np.where(np.arange(K) < nb, idx, -1)
    out = np.where(out >= 0, out, first[..., None])
    return out.astype(np.int32), count.astype(np.int32)


def grids(B, M, N, K, L, per_warp):
    """The rule's grid at this shape, and every tile at two ranges."""
    out = {bucket_scan.scan_grid(B, M, N, K, L, H100_SMS, per_warp,
                                 STAGE_COLS)}
    r_max = max(1, min(-(-N // L), STAGE_COLS // L))
    for groups in (8, 4, 2, 1):
        for rng in (1, r_max):
            out.add((groups * per_warp, rng))
    return sorted(out)


@pytest.fixture(scope="module")
def group_case():
    """B=3, N=1100 (not a multiple of L=128; K*L = 2048, so buckets 9-15
    hold no column), M=130 (not a multiple of any tile), the last center
    far from every point, points exactly on the radius of center 0."""
    rng = np.random.RandomState(61)
    xyz = rng.rand(3, 1100, 3).astype(np.float32) * np.float32(0.5)
    centers = xyz[:, rng.choice(1100, 130, replace=False)].copy()
    centers[:, -1] = 5.0
    centers[:, 0] = np.float32(0.25)
    # 0.25 - 0.125 = 0.125 exactly, 0.125**2 = r2 exactly: on the radius
    xyz[:, 5] = [0.125, 0.25, 0.25]
    xyz[:, 700] = [0.25, 0.375, 0.25]
    xyz[:, 701] = [0.25, 0.25, 0.125 - 2 ** -25]  # just outside
    return xyz, centers


GROUP_RADIUS, GROUP_K, GROUP_SEED = 0.125, 16, 0xC0FFEE11


@pytest.fixture(scope="module")
def group_ref(group_case):
    xyz, centers = group_case
    L = pallas_bucket_stride(1100, GROUP_K)
    plain = group.group_regions_fused_plain(
        t(xyz), t(centers), GROUP_SEED, GROUP_RADIUS, GROUP_K, L)
    ri, rc = group_regions_pallas(jnp.asarray(xyz), jnp.asarray(centers),
                                  jnp.uint32(GROUP_SEED), GROUP_RADIUS,
                                  GROUP_K, interpret=True)
    np.testing.assert_array_equal(plain[0].numpy(), np.asarray(ri))
    np.testing.assert_array_equal(plain[1].numpy(), np.asarray(rc))
    return plain[0].numpy(), plain[1].numpy()


def test_group_case_covers_the_edges(group_case, group_ref):
    xyz, centers = group_case
    idx, cnt = group_ref
    r2 = group.radius2(GROUP_RADIUS)
    assert r2 == 0.125 ** 2
    d = centers[:, 0, None] - xyz
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]
    assert (d2[:, 5] == r2).all() and (d2[:, 701] > r2).all()
    assert (cnt[:, -1] == 0).all() and (idx[:, -1] == 0).all()
    assert (cnt[:, :-1] > 0).all() and cnt.max() > GROUP_K


@pytest.mark.parametrize("tile,rng", grids(3, 130, 1100, GROUP_K, 128,
                                         GROUP_C))
def test_group_emulation_matches_plain_and_pallas(group_case, group_ref,
                                                  tile, rng):
    xyz, centers = group_case
    got = emulate(ball_test(centers, group.radius2(GROUP_RADIUS)), xyz,
                  130, GROUP_K, 128, GROUP_SEED, tile, rng,
                  GROUP_C)
    np.testing.assert_array_equal(got[1], group_ref[1])
    np.testing.assert_array_equal(got[0], group_ref[0])


def colliding_columns(seed, L):
    """(j1, j2), j1 < j2, two columns of bucket 0 whose 23-bit scores for
    row 0 under `seed` are equal."""
    s = hash23(0, seed, np.arange(L))
    u, inv, cnt = np.unique(s, return_inverse=True, return_counts=True)
    dup = np.flatnonzero(cnt[inv] > 1)
    return (int(dup[0]), int(dup[1])) if len(dup) else None


@pytest.mark.parametrize("L,K,N,seed", [(128, 8, 1000, 38201),
                                         (512, 8, 3500, 181)])
def test_equal_scores_in_one_bucket_pick_the_first(L, K, N, seed):
    """Two in-radius columns of one bucket with the same 23-bit score (the
    first seeds from 1 up that have such a pair): the first column wins, in
    the emulation, the plain version and the interpreted Pallas kernel; one
    center, so one tile."""
    j1, j2 = colliding_columns(seed, L)
    assert pallas_bucket_stride(N, K) == L
    xyz = np.full((1, N, 3), 9.0, np.float32)
    xyz[0, :, 0] += np.arange(N, dtype=np.float32)     # all far apart
    xyz[0, [j1, j2]] = 0.5
    centers = np.full((1, 1, 3), 0.5, np.float32)
    plain = group.group_regions_fused_plain(t(xyz), t(centers), seed, 0.01,
                                            K, L)
    ri, rc = group_regions_pallas(jnp.asarray(xyz), jnp.asarray(centers),
                                  jnp.uint32(seed), 0.01, K, interpret=True)
    got = emulate(ball_test(centers, group.radius2(0.01)), xyz, 1, K, L,
                  seed, 8, 1, GROUP_C)
    assert int(rc[0, 0]) == 2 and int(np.asarray(ri)[0, 0, 0]) == j1
    for idx, cnt in (plain, got):
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(ri))
        np.testing.assert_array_equal(np.asarray(cnt), np.asarray(rc))


def test_group_one_center(group_case):
    """M = 1, B = 1: the smallest grid."""
    xyz, centers = group_case
    x, c = xyz[:1], centers[:1, 3:4]
    ref = group.group_regions_fused_plain(t(x), t(c), 3, GROUP_RADIUS,
                                          GROUP_K, 128)
    for tile, rng in grids(1, 1, 1100, GROUP_K, 128,
                            GROUP_C):
        got = emulate(ball_test(c, group.radius2(GROUP_RADIUS)), x, 1,
                      GROUP_K, 128, 3, tile, rng, GROUP_C)
        np.testing.assert_array_equal(got[0], ref[0].numpy())
        np.testing.assert_array_equal(got[1], ref[1].numpy())


@pytest.fixture(scope="module")
def crop_case():
    """B=3, N=3500 in a 10 cm cube, K=8: L=512 (K*L = 4096 > N, the last
    bucket cut at N), M=70 (not a multiple of a tile).
    Frames: rotations from grasps, then proposal 1 with a frame that is not
    orthonormal, and proposal 0 the identity around a point with points
    placed exactly on the box's faces (outside) and just inside; the last
    proposal far from every point."""
    rng = np.random.RandomState(62)
    B, N, M = 3, 3500, 70
    xyz = (rng.rand(B, N, 3) * 0.1).astype(np.float32)
    centers = xyz[:, rng.choice(N, M, replace=False)].copy()
    centers[:, -1] = 5.0
    axis = rng.randn(B, M, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    theta = rng.uniform(-np.pi, np.pi, (B, M, 1))
    frames, _ = grasps_to_frames(t(np.concatenate(
        [centers, axis, theta], -1).astype(np.float32)))
    frames = frames.numpy().copy()
    frames[:, 1] = (rng.randn(B, 3, 3) * 0.7).astype(np.float32)
    frames[:, 0] = np.eye(3, dtype=np.float32)
    centers[:, 0] = np.float32(0.0625)
    box = (0.0, 0.03125, 0.015625, 0.0078125)
    c = np.float32(0.0625)
    faces = [[c + box[1], c, c], [c, c, c], [c + 0.015625, c + box[2], c],
             [c + 0.015625, c, c - box[3]], [c + 0.015625, c, c],
             [c + 0.015625, c + 0.0078125, c + 0.00390625]]
    xyz[:, 3300:3306] = np.float32(faces)
    return xyz, frames, centers, box


@pytest.fixture(scope="module")
def crop_ref(crop_case):
    xyz, frames, centers, box = crop_case
    L = pallas_bucket_stride(3500, 8)
    plain = crop.crop_plain(t(xyz), t(frames), t(centers), 77, box, 8, L)
    ri, rc = closing_region_crop_pallas(jnp.asarray(xyz), jnp.asarray(frames),
                                        jnp.asarray(centers), jnp.uint32(77),
                                        box, 8, interpret=True)
    np.testing.assert_array_equal(plain[0].numpy(), np.asarray(ri))
    np.testing.assert_array_equal(plain[1].numpy(), np.asarray(rc))
    return plain[0].numpy(), plain[1].numpy()


def test_crop_case_covers_the_edges(crop_case, crop_ref):
    xyz, frames, centers, box = crop_case
    idx, cnt = crop_ref
    assert pallas_bucket_stride(3500, 8) == 512
    inside = box_test(frames, centers, box)
    # the face points are outside, the last two inside
    for b in range(3):
        np.testing.assert_array_equal(
            inside(b, 0, xyz[b, 3300:3306]), [0, 0, 0, 0, 1, 1])
    assert (cnt[:, -1] == 0).all() and (idx[:, -1] == 0).all()
    assert (cnt > 5).any() and (cnt[:, 1] > 0).any()


@pytest.mark.parametrize("tile,rng", grids(3, 70, 3500, 8, 512,
                                           CROP_C))
def test_crop_emulation_matches_plain_and_pallas(crop_case, crop_ref, tile,
                                                 rng):
    xyz, frames, centers, box = crop_case
    got = emulate(box_test(frames, centers, box), xyz, 70, 8, 512, 77,
                  tile, rng, CROP_C)
    np.testing.assert_array_equal(got[1], crop_ref[1])
    np.testing.assert_array_equal(got[0], crop_ref[0])


def test_crop_emulation_at_l128(crop_case):
    """K5 at L = 128 (K = 32), against the plain version."""
    xyz, frames, centers, box = crop_case
    ref = crop.crop_plain(t(xyz), t(frames), t(centers), 5, box, 32, 128)
    got = emulate(box_test(frames, centers, box), xyz, 70, 32, 128, 5,
                  8 * CROP_C, 3, CROP_C)
    np.testing.assert_array_equal(got[0], ref[0].numpy())
    np.testing.assert_array_equal(got[1], ref[1].numpy())


# --- (d) K2: the strict radius test and the first pick ---------------------

@pytest.mark.parametrize("L", [32, 128, 512, 1024, 1152, 3200])
def test_first_pick_is_the_least_hit_place(L):
    """FirstPick's lanes-then-warp minimum, taken segment by segment and
    the segments' best kept, is the bucket's first hit."""
    rng = np.random.RandomState(L)
    for p in (0.0005, 0.002, 0.05, 0.5):
        for _ in range(50):
            hit = rng.rand(L) < p
            keys = [first_pick(0, 0, 0, np.arange(s0, min(L, s0 + SEG_COLS)),
                               hit[s0:s0 + SEG_COLS])
                    for s0 in range(0, L, SEG_COLS)
                    if hit[s0:s0 + SEG_COLS].any()]
            if keys:
                assert key_rel(max(keys)) == int(np.argmax(hit))


BQ_RADIUS, BQ_K, BQ_L = 0.125, 16, 128


@pytest.fixture(scope="module")
def bq_case():
    """B=3, N=1100 (not a multiple of L=128; K*L = 2048, so buckets 9-15
    hold no point), M=130 (not a multiple of any tile), the last center far
    from every point (no hit), points exactly on the radius of center 0
    (d2 == r2: outside, the test is strict) and just inside it, and about
    70 points in radius of a typical center (counts above K = 16)."""
    rng = np.random.RandomState(71)
    xyz = rng.rand(3, 1100, 3).astype(np.float32) * np.float32(0.5)
    centers = xyz[:, rng.choice(1100, 130, replace=False)].copy()
    centers[:, -1] = 5.0
    centers[:, 0] = np.float32(0.25)
    xyz[:, 5] = [0.125, 0.25, 0.25]              # d2 = r2 exactly
    xyz[:, 700] = [0.25, 0.375, 0.25]            # d2 = r2 exactly
    xyz[:, 701] = [0.25, 0.25, 0.125 + 2 ** -24]  # just inside
    return xyz, centers


@pytest.fixture(scope="module")
def bq_ref(bq_case):
    xyz, centers = bq_case
    r2 = float(np.float32(BQ_RADIUS * BQ_RADIUS))
    assert pallas_bucket_stride(1100, BQ_K) == BQ_L
    plain = ball_query.ball_query_bucketed_plain(t(xyz), t(centers), r2,
                                                 BQ_K, BQ_L)
    ri, rc = ball_query_pallas(jnp.asarray(xyz), jnp.asarray(centers),
                               BQ_RADIUS, BQ_K, interpret=True)
    np.testing.assert_array_equal(plain[0].numpy(), np.asarray(ri))
    np.testing.assert_array_equal(plain[1].numpy(), np.asarray(rc))
    return plain[0].numpy(), plain[1].numpy()


def test_bq_case_covers_the_edges(bq_case, bq_ref):
    xyz, centers = bq_case
    idx, cnt = bq_ref
    r2 = np.float32(BQ_RADIUS * BQ_RADIUS)
    inside = ball_test(centers, r2, strict=True)
    for b in range(3):
        np.testing.assert_array_equal(inside(b, 0, xyz[b, [5, 700, 701]]),
                                      [0, 0, 1])
        # K11's test (d2 <= r2) takes both points on the radius
        assert ball_test(centers, r2)(b, 0, xyz[b, [5, 700]]).all()
    assert (cnt[:, -1] == 0).all() and (idx[:, -1] == 0).all()
    assert (cnt[:, :-1] > 0).all() and (cnt == BQ_K).mean() > 0.5
    full = np.array([[ball_test(centers, r2, strict=True)(b, m, xyz[b]).sum()
                      for m in range(130)] for b in range(3)])
    assert full.max() > 2 * BQ_K          # the cap is exercised


@pytest.mark.parametrize("tile,rng", grids(3, 130, 1100, BQ_K, BQ_L,
                                           GROUP_C))
def test_k2_emulation_matches_plain_and_pallas(bq_case, bq_ref, tile, rng):
    xyz, centers = bq_case
    r2 = np.float32(BQ_RADIUS * BQ_RADIUS)
    got = emulate(ball_test(centers, r2, strict=True), xyz, 130, BQ_K, BQ_L,
                  0, tile, rng, GROUP_C, pick=first_pick, cap=BQ_K)
    np.testing.assert_array_equal(got[1], bq_ref[1])
    np.testing.assert_array_equal(got[0], bq_ref[0])


def test_k2_emulation_at_sa1_bucket_width(bq_case):
    """K2 at L = 512 (K = 8, K*L = 4096 > N = 3500: the last bucket cut at
    N), the width SA1 runs, for the rule's grid, against both references."""
    xyz = np.concatenate([bq_case[0]] * 4, 1)[:, :3500].copy()
    centers = bq_case[1][:, :70].copy()
    assert pallas_bucket_stride(3500, 8) == 512
    r2 = np.float32(BQ_RADIUS * BQ_RADIUS)
    ref = ball_query.ball_query_bucketed_plain(t(xyz), t(centers), float(r2),
                                               8, 512)
    ri, rc = ball_query_pallas(jnp.asarray(xyz), jnp.asarray(centers),
                               BQ_RADIUS, 8, interpret=True)
    np.testing.assert_array_equal(ref[0].numpy(), np.asarray(ri))
    np.testing.assert_array_equal(ref[1].numpy(), np.asarray(rc))
    for tile, rng in grids(3, 70, 3500, 8, 512, GROUP_C)[::3]:
        got = emulate(ball_test(centers, r2, strict=True), xyz, 70, 8, 512,
                      0, tile, rng, GROUP_C, pick=first_pick, cap=8)
        np.testing.assert_array_equal(got[0], ref[0].numpy())
        np.testing.assert_array_equal(got[1], ref[1].numpy())


# --- (e) buckets wider than a segment, and than a block stages -------------

def wide_case(N, M, seed):
    """B=1, N points in a 0.5 cube, K=8 buckets of L > 1,024 (one window
    at N = 9,000, L = 1,152; windows of WIN_COLS at N = 30,000, L = 3,840),
    M centers: the cloud's own points, then one far from the cloud with
    its only in-radius points planted past each bucket's first segment
    (and window), and the last far from everything."""
    rng = np.random.RandomState(seed)
    L = pallas_bucket_stride(N, 8)
    xyz = rng.rand(1, N, 3).astype(np.float32) * np.float32(0.5)
    centers = xyz[:, rng.choice(N, M, replace=False)].copy()
    centers[:, -2] = 2.0
    centers[:, -1] = 5.0
    planted = [k * L + o for k in range(8)
               for o in (SEG_COLS + 6 + k, SEG_COLS + 70, WIN_COLS + 3)
               if o < L and k * L + o < N]
    xyz[0, planted] = np.float32(2.0) + np.float32(2 ** -10) \
        * (np.arange(len(planted), dtype=np.float32) % 7)[:, None]
    return xyz, centers, L, planted


@pytest.mark.parametrize("N,M", [(9000, 24), (30000, 12)])
def test_k2_wide_buckets_match_plain_and_pallas(N, M):
    xyz, centers, L, planted = wide_case(N, M, N)
    assert L > SEG_COLS and (L > STAGE_COLS) == (N == 30000)
    radius = 0.03
    r2 = np.float32(radius * radius)
    ref = ball_query.ball_query_bucketed_plain(t(xyz), t(centers), float(r2),
                                               8, L)
    ri, rc = ball_query_pallas(jnp.asarray(xyz), jnp.asarray(centers),
                               radius, 8, interpret=True)
    np.testing.assert_array_equal(ref[0].numpy(), np.asarray(ri))
    np.testing.assert_array_equal(ref[1].numpy(), np.asarray(rc))
    # the planted center's picks lie past its buckets' first segments
    firsts = ref[0].numpy()[0, -2]
    assert (firsts % L >= SEG_COLS).all() and set(firsts) <= set(planted)
    for tile, rng in grids(1, M, N, 8, L, GROUP_C)[::2]:
        got = emulate(ball_test(centers, r2, strict=True), xyz, M, 8, L, 0,
                      tile, rng, GROUP_C, pick=first_pick, cap=8)
        np.testing.assert_array_equal(got[0], ref[0].numpy())
        np.testing.assert_array_equal(got[1], ref[1].numpy())


@pytest.mark.parametrize("N,M", [(9000, 24), (30000, 12)])
def test_k11_wide_buckets_match_plain_and_pallas(N, M):
    """The hash pick over a bucket's segments (and windows): at r = 0.06
    about 70 (N = 9,000) to 230 points are in radius of a cloud center,
    so the largest score falls in every segment of some bucket."""
    xyz, centers, L, _ = wide_case(N, M, N + 1)
    seed = 0xBADC0DE
    ref = group.group_regions_fused_plain(t(xyz), t(centers), seed, 0.06, 8,
                                          L)
    ri, rc = group_regions_pallas(jnp.asarray(xyz), jnp.asarray(centers),
                                  jnp.uint32(seed), 0.06, 8, interpret=True)
    np.testing.assert_array_equal(ref[0].numpy(), np.asarray(ri))
    np.testing.assert_array_equal(ref[1].numpy(), np.asarray(rc))
    segs = (ref[0].numpy()[0, :-2] % L) // SEG_COLS
    assert set(range(-(-L // SEG_COLS))) <= set(segs.ravel())
    for tile, rng in grids(1, M, N, 8, L, GROUP_C)[::2]:
        got = emulate(ball_test(centers, group.radius2(0.06)), xyz, M, 8, L,
                      seed, tile, rng, GROUP_C)
        np.testing.assert_array_equal(got[0], ref[0].numpy())
        np.testing.assert_array_equal(got[1], ref[1].numpy())
