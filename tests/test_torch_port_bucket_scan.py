"""The center-tiled bucket scan behind K11 and K5, on the CPU.

K11 (``csrc/group.cu``) and K5 (``csrc/crop.cu``) run one kernel body
(``csrc/bucket_scan.cuh``): a block owns a tile of centers (C per warp) x a
range of buckets whose columns it stages, keeps one hit bit per (center,
32-column step), packs each hit's hash score and place into a key whose
warp-wide maximum is the bucket's pick, writes each slot it owns (pick or
-1) and one partial count per center; a fill pass sums the partials and
fills the empty buckets.  The kernels run only on the card; here a numpy
emulation of that decomposition, block by block and lane by lane, is held
against the plain versions and against the JAX Pallas kernels in interpret
mode, and the pure grid rule `ops.bucket_scan.scan_grid` is checked at the
shapes the paths launch.

Tolerances: none; indices and counts are exact.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.ops.crop_pallas import (
    closing_region_crop_pallas)
from regnet_for_3d_grasping_tpu.ops.group_pallas import group_regions_pallas

from regnet_for_3d_grasping_torch.geometry.codec import grasps_to_frames
from regnet_for_3d_grasping_torch.ops import bucket_scan, crop, group
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


GROUP_C = cxx_constant("group.cu", "kPerWarp")    # centers per warp
CROP_C = cxx_constant("crop.cu", "kPerWarp")
STAGE_COLS = cxx_constant("bucket_scan.cuh", "kMaxStageCols")
WARPS = cxx_constant("bucket_scan.cuh", "kWarps")


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
])
def test_scan_grid_at_path_shapes(batch, m, n, k, per_warp, want):
    L = pallas_bucket_stride(n, k)
    tile, rng = bucket_scan.scan_grid(batch, m, n, k, L, H100_SMS, per_warp,
                                      STAGE_COLS)
    assert (tile, rng) == want
    nb = -(-n // L)
    blocks = batch * -(-m // tile) * bucket_scan.ranges(n, L, rng)
    assert blocks == batch * -(-m // tile) * -(-nb // rng)
    assert rng * L <= STAGE_COLS and tile <= 64
    assert (WARPS * per_warp) % tile == 0
    if n == 25600:              # every path shape fills a wave of SMs
        assert blocks >= H100_SMS


def test_scan_grid_refuses_uncovered_and_odd_buckets():
    with pytest.raises(ValueError):
        bucket_scan.scan_grid(1, 64, 25600, 64, 384, H100_SMS, 8, STAGE_COLS)
    with pytest.raises(ValueError):
        bucket_scan.scan_grid(1, 64, 1000, 16, 100, H100_SMS, 8, STAGE_COLS)
    with pytest.raises(ValueError):
        bucket_scan.scan_grid(1, 64, 40000, 32, 2048, H100_SMS, 8, STAGE_COLS)


# --- (b) the packed pick key ------------------------------------------------

def key64(score, rel):
    """csrc/bucket_scan.cuh HashPick::key: (score + 1) over the complement
    of the place, as uint64."""
    return ((np.uint64(score) + 1) << np.uint64(32)) \
        | np.uint64(0xFFFFFFFF - rel)


def warp_rel(keys):
    """HashPick::warp_rel over the lanes' best keys [32] -> the place of
    the pick: the high words' maximum, then the low words of its lanes."""
    hi = keys >> np.uint64(32)
    lo = np.where(hi == hi.max(), keys & np.uint64(0xFFFFFFFF), 0)
    return int(0xFFFFFFFF - int(lo.max()))


@pytest.mark.parametrize("top", [127, 511, 1023])
def test_pick_key_orders_score_then_first_place(top):
    """Places up to `top` (buckets of L = top + 1 columns, L up to 1024)."""
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


def ball_test(centers, r2):
    """[B, M, 3] -> pass(b, m, points [n, 3]) as csrc/group.cu tests: d =
    center - point, (dx*dx + dy*dy) + dz*dz <= r2, each step in f32."""
    def f(b, m, pts):
        d = centers[b, m] - pts
        return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2] \
            <= np.float32(r2)
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


def emulate(test, xyz, M, K, L, seed, tile, rng, per_warp, score=hash23):
    """The two launches of csrc/bucket_scan.cuh in numpy, for a grid of
    `tile` centers x `rng` buckets per block: each block stages its columns
    and NaN up to its last bucket's end, and a warp tests whole buckets."""
    B, N, _ = xyz.shape
    nb = -(-N // L)
    nranges = bucket_scan.ranges(N, L, rng)
    idx = np.full((B, M, K), -7, np.int64)          # never-written marker
    owner = np.zeros((B, M, K), np.int64)
    partial = np.full((B, M, nranges), -7, np.int64)
    groups = tile // per_warp
    per_group = WARPS // groups
    for b in range(B):
        for t_id in range(-(-M // tile)):
            for r_id in range(nranges):
                col0 = r_id * rng * L
                cols = min(rng * L, N - col0)
                staged = np.full((-(-cols // L) * L, 3), np.nan, np.float32)
                staged[:cols] = xyz[b, col0:col0 + cols]
                s_cnt = np.zeros(tile, np.int64)
                for warp in range(WARPS):
                    sub, g = warp % per_group, warp // per_group
                    m0 = t_id * tile + g * per_warp
                    if m0 >= M:
                        continue
                    for c in range(per_warp):
                        m = min(m0 + c, M - 1)
                        for kk in range(sub, -(-cols // L), per_group):
                            rel = np.arange(L)
                            col = col0 + kk * L
                            hit = test(b, m, staged[kk * L:(kk + 1) * L])
                            s_cnt[g * per_warp + c] += int(hit.sum())
                            pick = -1
                            if hit.any():
                                lanes = np.zeros(32, np.uint64)
                                sc = score(m0 + c, seed, col + rel)
                                for r in rel[hit]:
                                    lanes[r % 32] = max(lanes[r % 32],
                                                        key64(sc[r], r))
                                pick = col + warp_rel(lanes)
                            if m0 + c < M:
                                idx[b, m0 + c, col // L] = pick
                                owner[b, m0 + c, col // L] += 1
                rows = t_id * tile + np.arange(tile)
                ok = rows < M
                partial[b, rows[ok], r_id] = s_cnt[ok]
    # every scanned slot has exactly one owner; the others were never written
    assert (owner[..., :nb] == 1).all() and (owner[..., nb:] == 0).all()
    assert (partial >= 0).all()
    count = partial.sum(-1)
    scanned = idx[..., :nb]
    has = scanned >= 0
    first = np.where(has.any(-1), np.take_along_axis(
        scanned, has.argmax(-1)[..., None], -1)[..., 0], 0)
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
