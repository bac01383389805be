"""The served region grouping (K12, ``csrc/grid_group.cu``), on the CPU.

On the full scan the port groups as the JAX package does on every backend:
its chunked XLA path (``geometry/region.py:160-185``), since the JAX
package's Pallas grouping is off (``_PALLAS_GROUP_THRESHOLD = None``).  The
JAX side runs unpatched.  K12 computes that function on the card; here its
plain version (the chunked loop) is held against the JAX package, and an
emulation of K12's grid pass (the grid, cells and visit boxes of
`ops/group.grid_plan`, `grid_cells` and `grid_visits`, which compute the
kernel's f32 and f64 arithmetic; the records of the visited cells, the
expansion-form test, the chunked hash compared as f32 and packed with the
complemented column into the 64-bit key whose maximum a bucket keeps; the
query launches of at most `MAX_CHUNKS` seeds) against the plain version:
at the shapes of the old scan, at the f32 neighbours of the radius, on
cell boundaries, 50-100 m from the origin (where the reach exceeds the
radius most), in one cell, and with far or non-finite centers and
points.  Every pair in radius must lie among the center's candidates.
K11, the fused grouping, is
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
import re
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_torch.geometry import region
from regnet_for_3d_grasping_torch.ops import group, sampling
from regnet_for_3d_grasping_torch.ops.distances import bpdist2
from regnet_for_3d_grasping_torch.utils.scene import tabletop_cloud

from test_torch_port_bucket_scan import CSRC, cxx_constant, key64
jregion = importlib.import_module("regnet_for_3d_grasping_tpu.geometry.region")

MAX_CHUNKS = cxx_constant("grid_group.cu", "kMaxChunks")


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


# --- K12's grid pass, emulated ---------------------------------------------

def lowbias32(x):
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        for _ in range(2):
            x = x ^ (x >> np.uint32(16))
            x = x * np.uint32(0x45D9F3B)
        return x ^ (x >> np.uint32(16))


def chunk_row(b, m, n, chunk, seed):
    """The query's hash row: the chunk's linear index of (b, m, column 0)
    times 2654435761 plus the chunk's seed times 0x9E3779B9, in uint32."""
    with np.errstate(over="ignore"):
        lin = (np.uint32(b) * np.uint32(chunk)
               + np.uint32(m - m // chunk * chunk)) * np.uint32(n)
        return lin * np.uint32(2654435761) \
            + np.uint32(seed) * np.uint32(0x9E3779B9)


def chunk_score(row, j):
    """The mix's float, as its bits (they order as the floats do)."""
    with np.errstate(over="ignore"):
        x = np.uint32(row) + np.asarray(j, np.uint32) * np.uint32(2654435761)
    return lowbias32(x).astype(np.float32).view(np.uint32)


def expansion_test(centers):
    """The query's test: (|c|^2 - 2 cross) + |p|^2 <= r2, cross = fma(cz,
    pz, fma(cy, py, cx*px)), the fused multiply-adds in f64 and rounded
    once (exact here: no operand of these tests is small enough for the
    f64 sum to round)."""
    def f(b, m, pts, r2):
        c = centers[b, m]
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        with np.errstate(invalid="ignore", over="ignore"):
            cross = np.float32(np.float64(c[2]) * z + np.float32(
                np.float64(c[1]) * y + (c[0] * x)))
            c2 = (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]
            p2 = (x * x + y * y) + z * z
            d2 = np.float32(np.float64(c2) - 2.0 * cross.astype(np.float64)
                            ) + p2
            return d2 <= np.float32(r2)
    return f


class Emulated(NamedTuple):
    index: np.ndarray      # [B, M, K] int32
    count: np.ndarray      # [B, M] int32
    tested: np.ndarray     # [B, M]: records a center tested
    launches: int          # query launches


def emulate_k12(xyz, centers, seeds, r2, K, chunk,
                direct=False) -> Emulated:
    """K12's grid pass in numpy: the grid, each point's cell and each
    center's visit box from `ops/group` (the kernel's arithmetic); a center
    tests the records of the cells in its box with the expansion test,
    keeps for each bucket the maximum of its passes' 64-bit keys (the
    score's bits plus one over the complemented column) and counts them;
    empty buckets take the first non-empty bucket's pick, 0 where there is
    none.  The query runs in launches of at most MAX_CHUNKS seeds.  Every
    pair that the test passes over the whole cloud must be a candidate.
    `direct`: the direct pass, one launch in which a center tests every
    point (at most MAX_CHUNKS seeds)."""
    B, N, _ = xyz.shape
    M = centers.shape[1]
    L = sampling.bucket_stride(N, K)
    plan = group.grid_plan(t(xyz), r2)
    cells = group.grid_cells(t(xyz), plan).numpy()
    box, visits = (a.numpy() for a in group.grid_visits(t(centers), plan,
                                                        r2))
    if direct:
        assert len(seeds) <= MAX_CHUNKS
        visits = np.ones_like(visits)
        box = np.stack([np.full_like(box[..., 0], -1),
                        np.full_like(box[..., 1], 1 << 40)], -1)
    test = expansion_test(centers)
    idx = np.full((B, M, K), -7, np.int64)
    count = np.full((B, M), -7, np.int64)
    tested = np.zeros((B, M), np.int64)
    launches = 0
    for k0 in range(0, len(seeds), MAX_CHUNKS):
        launch_seeds = seeds[k0:k0 + MAX_CHUNKS]
        launches += 1
        m0, m1 = k0 * chunk, min(M, (k0 + len(launch_seeds)) * chunk)
        for b in range(B):
            for m in range(m0, m1):
                keys = np.zeros(K, np.uint64)
                hit = np.zeros(0, np.int64)
                if visits[b, m]:
                    inside = ((cells[b] >= box[b, m, :, 0])
                              & (cells[b] <= box[b, m, :, 1])).all(-1)
                    cand = np.flatnonzero(inside & (
                        (cells[b, :, 0] >= 0) | direct))
                    tested[b, m] = len(cand)
                    hit = cand[test(b, m, xyz[b, cand], r2)]
                every = np.flatnonzero(test(b, m, xyz[b], r2))
                assert np.isin(every, hit).all(), \
                    f"center {m} of cloud {b} missed a pair in radius"
                # the lemma the kernel's visit rests on: every pass lies
                # within the center's reach on each axis
                c = centers[b, m].astype(np.float64)
                rho = float(group.reach(torch.tensor(np.sqrt(
                    (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2])),
                    plan.p_norm[b], r2))
                assert (np.abs(xyz[b, every] - c) <= rho).all()
                row = chunk_row(b, m, N, chunk, launch_seeds[m // chunk - k0])
                for j, sc in zip(hit, chunk_score(row, hit)):
                    keys[j // L] = max(keys[j // L], key64(sc, j))
                has = keys != 0
                picks = 0xFFFFFFFF - (keys & np.uint64(0xFFFFFFFF)).astype(
                    np.int64)
                fill = picks[has.argmax()] if has.any() else 0
                idx[b, m] = np.where(has, picks, fill)
                count[b, m] = len(hit)
    assert (idx != -7).all() and (count != -7).all()
    return Emulated(idx.astype(np.int32), count.astype(np.int32), tested,
                    launches)


def hold(xyz, centers, seeds, radius, K, chunk) -> Emulated:
    """The grid pass's emulation against `group_regions_chunked_plain`,
    index for index, its candidates against `grid_candidates`, and, where
    a call of these seeds may take it, the direct pass's emulation too."""
    ref = group.group_regions_chunked_plain(t(xyz), t(centers), seeds,
                                            radius, K, chunk)
    r2 = group.radius2(radius)
    got = emulate_k12(xyz, centers, seeds, r2, K, chunk)
    np.testing.assert_array_equal(got.count, ref[1].numpy())
    np.testing.assert_array_equal(got.index, ref[0].numpy())
    pairs, _ = group.grid_candidates(t(xyz), t(centers), r2)
    np.testing.assert_array_equal(got.tested, pairs.numpy())
    if len(seeds) <= MAX_CHUNKS:
        direct = emulate_k12(xyz, centers, seeds, r2, K, chunk, direct=True)
        np.testing.assert_array_equal(direct.count, ref[1].numpy())
        np.testing.assert_array_equal(direct.index, ref[0].numpy())
        assert (direct.tested == xyz.shape[1]).all()
    return got


def seeds_for(M, chunk):
    return [0x9E3779B9 * (i + 3) & 0xFFFFFFFF for i in range(-(-M // chunk))]


@pytest.mark.parametrize("B,N,M,K,chunk,radius", [
    (2, 1100, 130, 16, 50, 0.1),    # L 69, 3 chunks, the last short
    (1, 700, 20, 256, 8, 0.15),     # L 3, K*L > N
    (1, 2600, 9, 2, 4, 0.12),       # L 1,300
    (1, 9000, 3, 2, 2, 0.08),       # L 4,500
])
def test_k12_emulation_matches_the_plain_chunked_path(B, N, M, K, chunk,
                                                      radius):
    xyz, centers = cloud(B, N, M, 7 * N + M, 0.25)
    centers[:, -1] = 5.0      # a center far from every point
    got = hold(xyz, centers, seeds_for(M, chunk), radius, K, chunk)
    assert (got.count[:, -1] == 0).all() and (got.count > 0).sum() > B


def neighbours_of_the_radius(c, r2, direction, steps=24):
    """Points c + t * direction at consecutive f32 steps of each coordinate
    around the radius, with the expansion test's answer for each: where it
    flips, the points just in and just out."""
    d = np.asarray(direction, np.float64) / np.linalg.norm(direction)
    p = (c + np.sqrt(r2) * d).astype(np.float32)
    toward = np.where(d > 0, np.inf, -np.inf).astype(np.float32)
    back = -toward
    for _ in range(steps):
        p = np.where(d != 0, np.nextafter(p, back), p)
    pts = []
    for _ in range(2 * steps):
        pts.append(p.copy())
        p = np.where(d != 0, np.nextafter(p, toward), p)
    pts = np.stack(pts).astype(np.float32)
    inside = expansion_test(c[None, None])(0, 0, pts, r2)
    return pts, inside


@pytest.mark.parametrize("direction", [(1, 0, 0), (0, -1, 0),
                                       (1, 1, 1), (-1, 1, -1)])
def test_k12_points_at_the_f32_neighbours_of_the_radius(direction):
    """Points at the f32 neighbours of a center's radius under the
    expansion test, along an axis and along a diagonal, just in and just
    out: the grid keeps every one that passes."""
    rng = np.random.RandomState(3)
    xyz = (rng.rand(1, 1500, 3) * 0.6 + 0.1).astype(np.float32)
    c = np.float32([0.3, 0.4, 0.35])
    r2 = group.radius2(0.02)
    pts, inside = neighbours_of_the_radius(c, r2, direction)
    assert inside.any() and not inside.all()
    flips = np.flatnonzero(inside[1:] != inside[:-1])
    assert len(flips)            # just in and just out, side by side
    xyz[0, 100:100 + len(pts)] = pts
    centers = np.stack([c, xyz[0, 7], xyz[0, 900]])[None]
    got = hold(xyz, centers, [11], 0.02, 32, 1024)
    ref_mask = (bpdist2(t(centers), t(xyz)) <= r2)[0, 0].numpy()
    np.testing.assert_array_equal(ref_mask[100:100 + len(pts)], inside)
    assert got.count[0, 0] >= inside.sum()


def boundary_values(lo, inv_h, k):
    """The least f32 x whose cell (`ops/group._cell_axis`) is k, and the
    f32 below it, whose cell is k - 1."""
    x = np.float32(lo + k / np.float64(inv_h))
    cell = lambda v: np.floor((np.float32(v) - lo) * inv_h)  # noqa: E731
    while cell(x) >= k:
        x = np.nextafter(x, np.float32(-np.inf))
    while cell(x) < k:
        x = np.nextafter(x, np.float32(np.inf))
    return x, np.nextafter(x, np.float32(-np.inf))


def test_k12_points_and_reach_on_cell_boundaries():
    """Points on both sides of cell boundaries, and centers whose box ends
    at the first or the last f32 of a cell: the corners of the cloud fix
    its extent and largest norm, so the grid does not move."""
    rng = np.random.RandomState(5)
    xyz = (rng.rand(1, 2000, 3) * 0.5 + 0.1).astype(np.float32)
    xyz[0, 0], xyz[0, 1] = 0.1, 0.6
    r2 = group.radius2(0.03)
    plan = group.grid_plan(t(xyz), r2)
    lo = plan.lo[0].numpy()
    inv_h = np.float32(plan.inv_h[0])
    rho = np.float32(group.reach(torch.tensor(0.5), plan.p_norm[0], r2))
    assert (plan.dims[0] > 4).all()
    pts, centers = [], []
    for k in (2, 3):
        on, below = boundary_values(lo[0], inv_h, k)
        for y in (0.3, 0.31):
            pts += [[on, y, 0.3], [below, y, 0.3]]
        # a center whose box starts at `on`, and one whose box ends at
        # `below`: the reach of a center near 0.5 from the origin
        for end, sign in ((on, 1), (below, -1)):
            c = np.float32(end + sign * rho)
            for _ in range(64):
                lo_v = np.nextafter(np.float32(c - rho), np.float32(-np.inf))
                hi_v = np.nextafter(np.float32(c + rho), np.float32(np.inf))
                v = lo_v if sign > 0 else hi_v
                if v == end:
                    break
                c = np.nextafter(c, np.float32(np.inf if v < end
                                               else -np.inf))
            centers.append([c, 0.3, 0.3])
    xyz[0, 2:2 + len(pts)] = pts
    after = group.grid_plan(t(xyz), r2)
    assert all(torch.equal(a, b) for a, b in zip(plan, after))
    centers = np.float32(centers)[None]
    box, _ = group.grid_visits(t(centers), plan, r2)
    cells = group.grid_cells(t(xyz), plan)[0, 2:2 + len(pts), 0].numpy()
    assert set(cells) == {1, 2, 3}      # both sides of each boundary
    assert {2, 3} <= set(box[0, :, 0].flatten().tolist())
    hold(xyz, centers, [4], 0.03, 16, 1024)


@pytest.mark.parametrize("offset", [50.0, 100.0])
def test_k12_cloud_far_from_the_origin(offset):
    """A 3 m cloud 50-100 m from the origin: the expansion form's rounding
    there passes points well beyond the radius, and the reach covers
    them."""
    rng = np.random.RandomState(int(offset))
    base = rng.rand(1, 2500, 3) * 3.0
    centers = base[:, :40] + 0.001
    near = centers[:, rng.randint(0, 40, 600)] + (rng.rand(1, 600, 3) - 0.5) \
        * 0.12
    xyz = (np.concatenate([base, near], 1) + offset).astype(np.float32)
    centers = (centers + offset).astype(np.float32)
    got = hold(xyz, centers, [77, 78, 79], 0.05, 16, 16)
    passed = (bpdist2(t(centers), t(xyz)) <= group.radius2(0.05))[0].numpy()
    true_d = np.linalg.norm(centers[0, :, None].astype(np.float64)
                            - xyz[0, None].astype(np.float64), axis=-1)
    assert true_d[passed].max() > 0.06         # the rounding matters here
    assert got.tested.max() < xyz.shape[1]     # and the grid still prunes


@pytest.mark.parametrize("extent", [0.0, 2e-4])
def test_k12_every_point_in_one_cell(extent):
    rng = np.random.RandomState(9)
    xyz = (0.4 + rng.rand(2, 600, 3) * extent).astype(np.float32)
    centers = xyz[:, :5] + np.float32(0.0004)
    plan = group.grid_plan(t(xyz), group.radius2(0.01))
    assert (plan.dims == 1).all()
    got = hold(xyz, centers, [1], 0.01, 8, 1024)
    assert (got.tested == 600).all() and (got.count == 600).all()


def test_k12_far_and_non_finite_centers_and_points():
    """Far centers (5 m, 1e10, 1e30) and centers with a NaN or an infinite
    coordinate get index 0 and count 0 and visit no cell; points with a
    non-finite coordinate get no record and pass no test."""
    xyz, centers = cloud(2, 800, 12, 17, 0.25)
    xyz[:, :6] = [[np.nan, 0.1, 0.1], [np.inf, 0.1, 0.1],
                  [0.1, -np.inf, 0.1], [0.1, 0.1, np.nan],
                  [np.inf, np.inf, np.inf], [np.nan] * 3]
    xyz[1, 6:] = np.nan        # cloud 1: two finite points
    xyz[1, 6:8] = [[0.1, 0.1, 0.1], [0.11, 0.1, 0.1]]
    bad = [[5.0, 5.0, 5.0], [1e10, 0.1, 0.1], [1e30, 1e30, 0.0],
           [np.nan, 0.1, 0.1], [0.1, np.inf, 0.1], [-np.inf, 0.1, 0.1]]
    centers[:, 6:] = bad
    centers[1, 0] = [0.1, 0.1, 0.1]
    plan = group.grid_plan(t(xyz), group.radius2(0.05))
    assert plan.points.tolist() == [794, 2]
    assert (group.grid_cells(t(xyz), plan)[:, :6] == -1).all()
    _, visits = group.grid_visits(t(centers), plan, group.radius2(0.05))
    assert not visits[:, 6:].any()
    got = hold(xyz, centers, [3, 4], 0.05, 16, 8)
    assert (got.count[:, 6:] == 0).all() and (got.index[:, 6:] == 0).all()
    assert got.count[1, 0] == 2 and (got.count[0, :6] > 0).all()


def test_k12_more_chunks_than_a_launch_takes():
    """65 chunks of 2 centers: two query launches after one build, the
    second keyed by its own seeds."""
    xyz, centers = cloud(2, 900, 130, 21, 0.25)
    got = hold(xyz, centers, seeds_for(130, 2), 0.06, 16, 2)
    assert -(-130 // 2) > MAX_CHUNKS and got.launches == 2


def test_k12_ties_in_f32_go_to_the_first_column():
    """Two hashes that round to one f32 tie (argmax over the uniforms picks
    the first), though their u32 values differ: a seed where the largest
    scores of one bucket collide, found by search (about one seed in
    20,000), and both the plain path and the packed key's maximum pick
    the first."""
    N, K = 400, 4                        # buckets of 100 columns
    n_found = 0
    for seed in range(20000):
        row = chunk_row(0, 0, N, 1, seed)
        bits = chunk_score(row, np.arange(100))
        raw = lowbias32(np.uint32(row) + np.arange(100, dtype=np.uint32)
                        * np.uint32(2654435761))
        top = np.flatnonzero(bits == bits.max())
        if len(top) < 2:
            continue
        assert len(set(raw[top])) == len(top)   # different u32, one f32
        assert key64(bits[top[0]], top[0]) > key64(bits[top[1]], top[1])
        n_found += 1
        # every column of bucket 0 in radius of the one center, none else
        xyz = np.full((1, N, 3), 9.0, np.float32)
        xyz[0, :100] = np.float32(0.5)
        centers = np.full((1, 1, 3), 0.5, np.float32)
        got = hold(xyz, centers, [seed], 0.01, K, 1)
        assert got.index[0, 0, 0] == top[0] and got.count[0, 0] == 100
        break
    assert n_found == 1


def test_k12_constants_and_grid():
    """The kernel's constants as the wrapper and the scratch read them, and
    the grid at the serving shape: a 25,600-point tabletop cloud, 4,000
    centers in radius 8 mm, each visiting at most 3 cells an axis and
    testing well under 1 % of the cloud on average."""
    src = (CSRC / "grid_group.cu").read_text()
    assert group.GRID_CELLS == cxx_constant("grid_group.cu", "kMaxCells")
    assert group.GRID_WORDS == cxx_constant("grid_group.cu", "kGridWords")
    assert group.MAX_CHUNKS == MAX_CHUNKS == 64
    # one build cluster size; its blocks share the cells evenly
    assert cxx_constant("grid_group.cu", "kCluster") == 16
    assert group.GRID_CELLS % 16 == 0
    assert re.search(rf"kMaxDirectSmem = {group.DIRECT_KEY_BYTES // 1024} "
                     r"\* 1024;", src)
    # the direct pass's centers a block are the kernel's instances
    assert tuple(int(c) for c in re.findall(
        r"case (\d+): return launch_direct<\1>", src)) \
        == group.DIRECT_PER_BLOCK
    B, N = 2, 300
    scratch = group.grid_scratch(B, N, "cpu")
    records, grids, starts, ranks = group.grid_views(scratch, B, N)
    assert records.shape == (B, N, 4) and grids.shape == (B, 16)
    assert starts.shape == (B, group.GRID_CELLS + 1) and ranks.shape == (B, N)
    assert (grids.data_ptr() - scratch.data_ptr()) % 8 == 0
    assert records.data_ptr() == scratch.data_ptr()
    grids[:, 8:10] = torch.tensor([1.5], dtype=torch.float64).view(
        torch.int32)
    assert group.grid_read(grids).p_norm.tolist() == [1.5, 1.5]
    xyz = torch.tensor(tabletop_cloud(np.random.RandomState(0), 25600)[0],
                       dtype=torch.float32)[None]
    centers = xyz[:, torch.randperm(25600,
                                    generator=torch.Generator().manual_seed(0)
                                    )[:4000]]
    r2 = group.radius2(0.008)
    plan = group.grid_plan(xyz, r2)
    assert int(plan.dims.prod()) <= group.GRID_CELLS
    rho = float(group.reach(plan.p_norm, plan.p_norm, r2))
    assert 0.008 < rho < 0.0082 and 1 / float(plan.inv_h) >= rho
    pairs, cells = group.grid_candidates(xyz, centers, r2)
    assert int(cells.max()) <= 27 and int(cells.min()) >= 1
    assert float(pairs.double().mean()) < 0.01 * 25600


@pytest.mark.parametrize("B,M,N,K,chunks,want", [
    (1, 4000, 25600, 256, 4, ("grid", 0)),      # serving
    (12, 64, 25600, 256, 1, ("direct", 4)),     # a training batch
    (1, 64, 25600, 256, 1, ("direct", 1)),      # a validation forward
    (1, 130, 1100, 16, 65, ("grid", 0)),        # more seeds than a launch
    (2, 77, 5000, 64, 2, ("direct", 1)),
    (1, 600, 25600, 256, 1, ("direct", 4)),     # over two blocks an SM at 1
    (1, 64, 25600, 26000, 1, ("grid", 0)),      # keys past shared memory
])
def test_k12_route(B, M, N, K, chunks, want):
    """Few pairs take the direct pass (one launch, no grid), with the
    fewest centers a block that keep the blocks within two an SM; more, or
    more seeds than one launch takes, the grid."""
    assert group.route(B, M, N, K, chunks, 132) == want
