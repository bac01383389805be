"""Parity of the PyTorch port's sorted-slab path with the JAX package, on
the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages.  The
JAX side runs its Pallas kernels in interpret mode (and the model with
``region.SLAB_INTERPRET``); the port runs the kernels' plain PyTorch
versions.  The randomness the JAX model draws from its keys (the sort noise
u, SA1's seed, the grouping and crop seeds) is captured by wrapping the JAX
functions and handed to the port.

Tolerances: orders, indices, counts, masks, span tables and pooled values
exact; 3-NN distances rtol 1e-6 (same f32 arithmetic, the compiled JAX side
may fuse a multiply-add); layer and model floats rtol 1e-4 / atol 1e-5 (the
same f32 layers, matrix products summed in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.models import REGNet as JREGNet
from regnet_for_3d_grasping_tpu.models import ScoreNet as JScoreNet
from regnet_for_3d_grasping_tpu.models.backbone import (
    FeaturePropagation as JFeaturePropagation)
from regnet_for_3d_grasping_tpu.ops import fps as jfps
from regnet_for_3d_grasping_tpu.ops import slab as jslab
from regnet_for_3d_grasping_tpu.ops.fps_pallas import fps_pallas_grouped
from regnet_for_3d_grasping_tpu.utils.config import tiny_config as jtiny

from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.config import infer_config, tiny_config
from regnet_for_3d_grasping_torch.geometry import region
from regnet_for_3d_grasping_torch.models.backbone import FeaturePropagation
from regnet_for_3d_grasping_torch.models.regnet import REGNet
from regnet_for_3d_grasping_torch.ops import _cuda, fps, slab

jregion = importlib.import_module("regnet_for_3d_grasping_tpu.geometry.region")
jregnet = importlib.import_module("regnet_for_3d_grasping_tpu.models.regnet")

CELL = 0.04
TOL = dict(rtol=1e-4, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def seed_of(key) -> int:
    return int(np.asarray(jax.random.key_data(key)).reshape(-1)[-1])


def flat_cloud(B, N, seed, extent=0.35):
    """A 2.5-D tabletop-like cloud (tests/test_slab.py's)."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-extent, extent, (B, N, 3)).astype(np.float32)
    pts[..., 2] *= 0.1
    return pts


def sorted_centers(pts, M, rng, far=0):
    """M rows of each cloud, x-sorted; the last `far` moved off the table
    (no point within any radius of them)."""
    out = []
    for b in range(pts.shape[0]):
        c = pts[b][rng.choice(pts.shape[1], M, False)].copy()
        if far:
            c[-far:] = [5.0, 0.0, 0.0]
        out.append(c[np.argsort(c[:, 0], kind="stable")])
    return np.stack(out)


def jsort(pts, key_seed):
    """(JAX SortedCloud, the port's over the same arrays)."""
    _, jsc = jslab.sort_cloud(jax.random.PRNGKey(key_seed), jnp.asarray(pts),
                              CELL)
    sc = slab.SortedCloud(t(jsc.xyz), t(jsc.cell_row), t(jsc.order))
    return jsc, sc


def assert_all_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# --- twins of the card's decomposition of K6 / K7 ---------------------------
# csrc/slab_select.cu builds a call's span table on the card, selects with
# one block per (tile, scan block, group of 32 queries) and fills the empty
# slots in a last pass.  These emulate those three launches step for step.

def _cell_id32(x, cell) -> int:
    return int(np.clip(np.floor(np.float32(x) / np.float32(cell)), -1e6, 1e6))


def _warp_search(row: np.ndarray, key: int, upper: bool) -> int:
    """`warp_search`: 32 evenly spaced probes a pass, keeping the stretch
    between the last probe below the answer and the next."""
    lo, hi = 0, len(row)
    while lo < hi:
        step = -(-(hi - lo) // 32)
        p = lo + np.arange(32) * step
        v = row[np.minimum(p, len(row) - 1)]
        c = int(((p < hi) & ((v <= key) if upper else (v < key))).sum())
        if c == 0:
            hi = lo
        else:
            hi, lo = min(lo + c * step, hi), lo + (c - 1) * step + 1
    return lo


def spans_twin(cell_row, qx, bound, cell, nblk, span_b) -> np.ndarray:
    """`slab_spans_kernel`: qx [B, Mp] (pad queries at 1e10) -> [B, T, 3]
    int32, per tile the real queries' x-range widened by `bound` in f32,
    its cell ids, the two searches and the kernel's integer rules."""
    cell_row, qx = np.asarray(cell_row), np.asarray(qx, np.float32)
    B, Mp = qx.shape
    out = np.zeros((B, Mp // 128, 3), np.int32)
    for b in range(B):
        for t in range(Mp // 128):
            q = qx[b, t * 128:(t + 1) * 128]
            real = q < np.float32(1e9)
            lo = hi = np.float32(1e9)
            if real.any():
                lo = q[real].min() - np.float32(bound)
                hi = q[real].max() + np.float32(bound)
            srow = _warp_search(cell_row[b], _cell_id32(lo, cell), False)
            erow = _warp_search(cell_row[b], _cell_id32(hi, cell), True)
            start = min(srow // 2048, nblk - 1)
            stop = min(max(-(-erow // 2048), start + 1), nblk)
            mid = (srow + erow) // 4096
            off = (min(start, nblk - span_b) if stop - start <= span_b
                   else min(max(mid - span_b // 2, 0), nblk - span_b))
            out[b, t] = start, stop, off
    return out


def blocked_select(xyz, ss, seed, M, K, win, spw, distinct, test):
    """`slab_select_kernel` then `slab_fill_kernel`: each (tile, scan block
    kb, group of 32 queries) inside its tile's [start, stop) adds its
    partial counts, and when kb lies in [off, off + span) writes every slot
    it owns, (kb - off, window, stream), its pick or -1: the window's
    largest key (23-bit hash + 1) << 8 | (255 - place in window), the
    stream's reshuffle or the previous winner dropped.  Slots no block
    writes hold garbage (-7) until the fill pass, which reads only the
    scanned span blocks' slots.  Returns (index, count, sel_any, off)."""
    B, N, _ = xyz.shape
    nblk, nwin = -(-N // 2048), 2048 // win
    rps = nwin * spw
    span_b = K // rps
    idx = torch.full((B, M, K), -7, dtype=torch.int64)
    cnt = torch.zeros(B, M, dtype=torch.int64)
    place = torch.arange(2048) % win
    for b in range(B):
        for t, (start, stop, off) in enumerate(np.asarray(ss[b]).tolist()):
            for kb in range(nblk):
                for q0 in range(t * 128, t * 128 + 128, 32):
                    q1 = min(q0 + 32, M)
                    if q0 >= M or not start <= kb < stop:
                        continue
                    r0, r1 = kb * 2048, min(kb * 2048 + 2048, N)
                    mask = torch.zeros(q1 - q0, 2048, dtype=torch.bool)
                    mask[:, :r1 - r0] = test(b, q0, q1, xyz[b, r0:r1])
                    cnt[b, q0:q1] += mask.sum(-1)
                    if not off <= kb < off + span_b:
                        continue
                    h = slab._hash23(torch.arange(q0, q1)[:, None],
                                     torch.arange(r0, r0 + 2048)[None], seed)
                    key = torch.where(mask, ((h + 1) << 8) | (255 - place), 0)
                    key = key.reshape(q1 - q0, nwin, win)
                    slots = (kb - off) * rps + torch.arange(nwin) * spw
                    for s in range(spw):
                        k = key
                        if s and not distinct:
                            k = torch.where(key > 0, (((((key >> 8) - 1)
                                            * slab._STREAM_ODD[s]) & 0x7FFFFF)
                                            + 1) << 8 | (key & 255), 0)
                        best = k.amax(-1)
                        row = r0 + torch.arange(nwin) * win + 255 - (best & 255)
                        idx[b, q0:q1, slots + s] = torch.where(best > 0, row,
                                                               -1)
                        if distinct:
                            key = torch.where((key == best[..., None])
                                              & (best[..., None] > 0), 0, key)
    # the fill pass
    tile = torch.as_tensor(np.asarray(ss))[:, torch.arange(M) // 128]
    start, stop, off = tile[..., 0:1], tile[..., 1:2], tile[..., 2:3]
    j = torch.arange(K)
    scanned = ((j >= (start - off).clamp(min=0) * rps)
               & (j < torch.minimum(stop - off, torch.tensor(span_b)) * rps))
    raw = torch.where(scanned, idx, -1)
    has = raw >= 0
    first = torch.where(has.any(-1), torch.gather(
        raw, -1, has.to(torch.uint8).argmax(-1, keepdim=True))[..., 0], -1)
    out = torch.where(has, raw, first.clamp(min=0)[..., None])
    return (out.to(torch.int32), cnt.to(torch.int32), first >= 0,
            torch.as_tensor(np.asarray(ss))[..., 2].contiguous())


def ball_test(centers, r2):
    def test(b, q0, q1, x):
        d = [x[None, :, i] - centers[b, q0:q1, None, i] for i in range(3)]
        return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2] <= r2
    return test


def box_test(frames, centers, box):
    xlo, xhi, yabs, zabs = (float(np.float32(v)) for v in box)

    def test(b, q0, q1, x):
        f = frames[b, q0:q1].reshape(-1, 9)
        r = [x[None, :, i] - centers[b, q0:q1, None, i] for i in range(3)]
        loc = [(f[:, j, None] * r[0] + f[:, 3 + j, None] * r[1])
               + f[:, 6 + j, None] * r[2] for j in range(3)]
        return ((loc[0] > xlo) & (loc[0] < xhi) & (loc[1].abs() < yabs)
                & (loc[2].abs() < zabs))
    return test


def card_decomposition(sc, centers, bound, K, win, spw, distinct, seed,
                       test):
    """The three launches' twins on the port's SortedCloud: (index, count,
    sel_any, off) and the span table."""
    M = centers.shape[1]
    qx = np.pad(np.asarray(centers)[..., 0], ((0, 0), (0, (-M) % 128)),
                constant_values=1e10)
    ss = spans_twin(sc.cell_row, qx, bound, CELL,
                    slab.n_scan_blocks(sc.xyz.shape[1]),
                    slab.span_blocks_for(K, win, spw))
    return blocked_select(sc.xyz, ss, seed, M, K, win, spw, distinct,
                          test), ss


# --- sort_cloud, slab_bounds ------------------------------------------------

@pytest.mark.parametrize("channels", [3, 6])
def test_sort_cloud_matches_jax(channels):
    B, N = 2, 3000
    rng = np.random.RandomState(1)
    pc = np.concatenate([flat_cloud(B, N, 2), rng.rand(B, N, 3)],
                        -1).astype(np.float32)[..., :channels]
    pc[0, :40, 0] = pc[0, 40:80, 0]          # equal x values
    key = jax.random.PRNGKey(11)
    u = np.array(jax.random.uniform(key, (B, N)))
    u[1, :50] = u[1, 50:100]                 # equal sort keys within cells
    ref_pc, ref = jslab.sort_cloud(key, jnp.asarray(pc), CELL)
    got_pc, got = slab.sort_cloud(t(pc), CELL, u=t(np.asarray(
        jax.random.uniform(key, (B, N)))))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(ref.order))
    np.testing.assert_array_equal(got.cell_row.numpy(),
                                  np.asarray(ref.cell_row))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(ref.xyz))
    np.testing.assert_array_equal(got_pc.numpy(), np.asarray(ref_pc))
    assert got.order.dtype == torch.int32
    assert got.cell_row.dtype == torch.int32
    # tied keys keep their original order (a stable sort)
    _, tied = slab.sort_cloud(t(pc), CELL, u=t(u))
    o = tied.order[1].numpy()
    pos = np.empty(N, np.int64)
    pos[o] = np.arange(N)
    same_cell = np.floor(pc[1, :50, 0] / np.float32(CELL)) == np.floor(
        pc[1, 50:100, 0] / np.float32(CELL))
    assert same_cell.any()
    assert (pos[:50][same_cell] < pos[50:100][same_cell]).all()


def test_sort_cloud_draws_from_the_generator():
    pc = t(flat_cloud(1, 512, 3))
    a = slab.sort_cloud(pc, CELL, generator=torch.Generator().manual_seed(5))
    b = slab.sort_cloud(pc, CELL, generator=torch.Generator().manual_seed(5))
    c = slab.sort_cloud(pc, CELL, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a[1].order, b[1].order)
    assert not torch.equal(a[1].order, c[1].order)
    assert (a[1].cell_row.diff(dim=-1) >= 0).all()
    with pytest.raises(ValueError):
        slab.sort_cloud(pc, CELL)


@pytest.mark.parametrize("M,bound,span", [(256, 0.03, 4), (200, 0.0514, 8),
                                          (1000, 0.02, 1), (130, 0.3, 2)])
def test_slab_bounds_matches_jax(M, bound, span):
    pts = flat_cloud(2, 18432, 4)
    jsc, sc = jsort(pts, 3)
    c = sorted_centers(pts, M, np.random.RandomState(M), far=3)
    qx = np.pad(c[..., 0], ((0, 0), (0, (-M) % 128)), constant_values=1e10)
    ref = jslab.slab_bounds(jsc.cell_row, jnp.asarray(qx), bound, CELL, 9,
                            span)
    got = slab.slab_bounds(sc.cell_row, t(qx), bound, CELL, 9, span)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the card's span table, built per tile with two warp searches
    np.testing.assert_array_equal(
        spans_twin(sc.cell_row, qx, bound, CELL, 9, span), np.asarray(ref))


def test_slab_bounds_all_pad_tile():
    """A tile of pad queries only scans one block."""
    pts = flat_cloud(1, 4096, 4)
    jsc, sc = jsort(pts, 3)
    qx = np.full((1, 256), 1e10, np.float32)
    qx[0, :128] = np.sort(pts[0, :128, 0])
    ref = jslab.slab_bounds(jsc.cell_row, jnp.asarray(qx), 0.03, CELL, 2, 1)
    got = slab.slab_bounds(sc.cell_row, t(qx), 0.03, CELL, 2, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0, 1, 1] - got[0, 1, 0] == 1
    np.testing.assert_array_equal(
        spans_twin(sc.cell_row, qx, 0.03, CELL, 2, 1), np.asarray(ref))


@pytest.mark.parametrize("span", [1, 4])
def test_span_table_twin_queries_at_both_ends(span):
    """Tiles whose queries reach the cloud's first and last rows (and
    beyond, by the bound): the searches return 0 and N, the table clamps
    to [0, nblk), and a span wider than `span` blocks is centred."""
    pts = flat_cloud(2, 18432, 12)
    jsc, sc = jsort(pts, 8)
    xs = np.asarray(jsc.xyz)[..., 0]
    rng = np.random.RandomState(span)
    qx = np.stack([np.sort(np.concatenate([
        xs[b, :40], xs[b, -40:], rng.choice(xs[b], 120, False)]))
        for b in range(2)]).astype(np.float32)
    qx = np.pad(qx, ((0, 0), (0, 56)), constant_values=1e10)
    ref = np.asarray(jslab.slab_bounds(jsc.cell_row, jnp.asarray(qx), 0.05,
                                       CELL, 9, span))
    got = spans_twin(sc.cell_row, qx, 0.05, CELL, 9, span)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        slab.slab_bounds(sc.cell_row, t(qx), 0.05, CELL, 9, span).numpy(),
        ref)
    assert got[:, 0, 0].max() == 0 and got[:, -1, 1].min() == 9
    assert (got[..., 1] - got[..., 0] > span).any()


def test_span_block_rules():
    for k, win, spw in ((256, 128, 4), (64, 256, 2), (64, 256, 1)):
        assert slab.span_blocks_for(k, win, spw) == jslab.span_blocks_for(
            k, win, spw)
    assert slab.group_span_blocks(256) == jslab.group_span_blocks(256) == 4
    assert slab.crop_span_blocks(64) == jslab.crop_span_blocks(64) == 8
    assert slab.n_scan_blocks(25600) == jslab.n_scan_blocks(25600) == 13
    assert slab.n_scan_blocks_k(5120) == jslab.n_scan_blocks_k(5120) == 5
    with pytest.raises(ValueError):
        slab.span_blocks_for(100, 128, 4)


def test_hash23_matches_jax():
    rows = np.arange(0, 5000, 7, dtype=np.int32)[:, None]
    cols = np.arange(0, 26624, 13, dtype=np.int32)[None, :]
    ref = jslab._hash23(jnp.asarray(rows), jnp.asarray(cols),
                        jnp.uint32(0xDEADBEEF))
    got = slab._hash23(t(rows).long(), t(cols).long(), 0xDEADBEEF)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --- K7 crop_slab (K6: test_torch_port_slab_k6.py) ------------------------

@pytest.fixture(scope="module")
def crop_data():
    pts = flat_cloud(1, 18432, 1)
    jsc, sc = jsort(pts, 5)
    rng = np.random.RandomState(11)
    centers = sorted_centers(pts, 300, rng, far=2)
    frames = np.stack([np.stack(
        [np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
         for _ in range(300)])])
    return jsc, sc, centers, frames


@pytest.mark.parametrize("grid_span", [None, 6])
def test_k7_crop_slab_matches_pallas(crop_data, grid_span):
    jsc, sc, centers, frames = crop_data
    box = (0.0, 0.03, 0.04, 0.005)
    ref = jslab.crop_slab(jsc, jnp.asarray(frames), jnp.asarray(centers),
                          jnp.uint32(9), box, 64, CELL, grid_span=grid_span,
                          interpret=True)
    got = slab.crop_slab(sc, t(frames), t(centers), 9, box, 64, CELL)
    assert_all_equal(got, ref)
    emu, _ = card_decomposition(sc, t(centers), slab.crop_bound(box), 64,
                                slab.CROP_WIN, slab.CROP_SPW, False, 9,
                                box_test(t(frames), t(centers), box))
    assert_all_equal(emu, ref)
    assert got[2].any() and not got[2].all()


# --- K8 three_nn_slab --------------------------------------------------------

def nn_data(seed, NK):
    pts = flat_cloud(2, 4096, seed)
    jsc, _ = jsort(pts, 2)
    rng = np.random.RandomState(seed + 1)
    keys = np.stack([pts[b][rng.choice(4096, NK, False)] for b in range(2)])
    keys = np.stack([k[np.argsort(k[:, 0], kind="stable")] for k in keys])
    return np.asarray(jsc.xyz), keys


@pytest.mark.parametrize("kw", [dict(), dict(grid_span=1),
                                dict(grid_span=99)],
                         ids=["default", "clamped", "unclamped"])
def test_k8_three_nn_slab_matches_pallas(kw):
    """The keys are a subset of the queries, as at FP3."""
    q, keys = nn_data(6, 4096)
    ri, rd, rp = jslab.three_nn_slab(jnp.asarray(q), jnp.asarray(keys),
                                     bound=0.08, interpret=True, **kw)
    gi, gd, gp = slab.three_nn_slab(t(q), t(keys), bound=0.08, **kw)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))
    assert gi.dtype == torch.int32 and gp.dtype == torch.bool
    if kw == dict(grid_span=1):
        assert not gp.all()           # the clamp bit: some batch unproven
    if kw == dict(grid_span=99):
        assert gp.all()
        assert (gd[..., 0] == 0).all()    # every key is also a query


def test_k8_three_nn_slab_sparse_keys_unproven():
    """Keys far from some queries: the certificate refuses; an empty slot
    holds (1e38, 0) on both sides."""
    rng = np.random.RandomState(8)
    pts = rng.uniform(-0.3, 0.3, (1, 2048, 3)).astype(np.float32)
    jsc, _ = jsort(pts, 3)
    keys = rng.uniform(0.25, 0.3, (1, 2050, 3)).astype(np.float32)
    keys = keys[:, np.argsort(keys[0, :, 0], kind="stable")]
    ri, rd, rp = jslab.three_nn_slab(jsc.xyz, jnp.asarray(keys), bound=0.05,
                                     interpret=True)
    gi, gd, gp = slab.three_nn_slab(t(jsc.xyz), t(keys), bound=0.05)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-6, atol=0)
    assert not bool(gp[0]) and not bool(np.asarray(rp)[0])


# --- K9 gather_max_slab ------------------------------------------------------

def test_k9_gather_max_slab_crop_geometry(crop_data):
    """win 256 / spw 1, S not a multiple of 128."""
    jsc, sc, centers, frames = crop_data
    idx, _, sel, off = slab.crop_slab(sc, t(frames), t(centers), 9,
                                      (0.0, 0.03, 0.04, 0.005), 64, CELL)
    idx = torch.where(sel[..., None], idx, 0)
    feat = np.random.RandomState(14).randn(1, 18432, 40).astype(np.float32)
    ref = jslab.gather_max_slab(jnp.asarray(feat), jnp.asarray(idx.numpy()),
                                jnp.asarray(off.numpy()), jslab.CROP_WIN,
                                jslab.CROP_SPW, interpret=True)
    got = slab.gather_max_slab(t(feat), idx, off, slab.CROP_WIN,
                               slab.CROP_SPW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[0][~sel[0]] == -1e38).any()


# --- K10 grouped FPS ---------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_k10_grouped_fps_matches_jax(masked):
    B, N, S, G = 2, 2048, 64, 4
    xyz = flat_cloud(B, N, 21)
    mask = None
    if masked:
        mask = np.random.RandomState(22).rand(B, N) < 0.3
        mask[1, N // G:2 * N // G] = False    # one slice fully masked
    jm = None if mask is None else jnp.asarray(mask)
    ref = np.asarray(jfps.farthest_point_sample(jnp.asarray(xyz), S, jm,
                                                groups=G))
    L = N // G
    dist = jfps._dist_init(jnp.asarray(xyz).reshape(B * G, L, 3),
                           None if jm is None else jm.reshape(B * G, L))
    pal = np.asarray(fps_pallas_grouped(jnp.asarray(xyz), dist.reshape(B, N),
                                        S, G, interpret=True))
    np.testing.assert_array_equal(pal, ref)
    got = fps.farthest_point_sample(t(xyz), S,
                                    None if mask is None else t(mask),
                                    groups=G)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # slice-major: the picks of slice g lie in [g*L, (g+1)*L)
    g_of = got.reshape(B, G, S // G) // L
    assert (g_of == torch.arange(G)[None, :, None]).all()
    with pytest.raises(ValueError):
        fps.farthest_point_sample(t(xyz), S, groups=3)


# --- the slab FeaturePropagation ---------------------------------------------

@pytest.mark.parametrize("scale,fallback", [(1.0, 0), (20.0, 1)])
def test_slab_feature_propagation_matches_flax(scale, fallback):
    """The certificate holding (the cloud in meters) and failing (scaled by
    20: the 0.06 bound no longer covers the neighbours, so the full scan
    runs)."""
    rng = np.random.RandomState(30)
    pts = flat_cloud(1, 4096, 30) * scale
    pts = pts[:, np.argsort(pts[0, :, 0], kind="stable")]
    keys = flat_cloud(1, 4000, 31) * scale
    sfeat = rng.randn(1, 4000, 8).astype(np.float32)
    old = jregion.SLAB_INTERPRET
    jregion.SLAB_INTERPRET = True
    try:
        jfp = JFeaturePropagation(mlp_channels=(16,), use_slab=True,
                                  nn_bound=0.06)
        args = (jnp.asarray(pts), jnp.asarray(keys), None, jnp.asarray(sfeat))
        variables = jfp.init(jax.random.PRNGKey(0), *args)
        ref, inter = jfp.apply(variables, *args, mutable=["intermediates"])
        ref_count = int(inter["intermediates"]["fp3_slab_fallback"][0])
        # the exact path on the x-sorted keys, op by op: what the fallback
        # computes.  Inside the slab layer JAX compiles it (lax.cond), and
        # the compiled bpdist2 rounds differently (see ROADMAP.md C), which
        # at 20x the coordinates moves the interpolation weights by 1e-3
        order = np.argsort(keys[0, :, 0], kind="stable")
        exact = JFeaturePropagation(mlp_channels=(16,)).apply(
            variables, jnp.asarray(pts), jnp.asarray(keys[:, order]), None,
            jnp.asarray(sfeat[:, order]))
    finally:
        jregion.SLAB_INTERPRET = old
    fp = FeaturePropagation(8, (16,), 3, nn_bound=0.06)
    weights.load_into(fp, jax.tree.map(np.array, dict(variables)))
    fp.eval()
    _cuda.reset_launches()
    with torch.no_grad():
        got = fp(t(pts), t(keys), None, t(sfeat), use_slab=True)
    assert _cuda.fallbacks["fp3_slab"] == fallback == min(ref_count, 1)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(exact if fallback else ref), **TOL)
    if fallback:        # JAX's own bound between its two paths
        d = np.abs(got.numpy() - np.asarray(ref))
        assert np.quantile(d, 0.99) < 2e-3 and (d > 1e-2).mean() < 0.005
    _cuda.reset_launches()
    assert _cuda.fallbacks["fp3_slab"] == 0


# --- the dispatch rules -------------------------------------------------------

def test_slab_dispatch_rules_match_jax(monkeypatch):
    monkeypatch.setattr(jregion, "SLAB_INTERPRET", True)
    for n, k in ((25600, 256), (25600, 64), (4096, 64), (4096, 256),
                 (512, 16), (2048, 128), (25600, 100)):
        assert region._use_slab_group(n, k) == jregion._use_slab_group(n, k)
    for n, k in ((25600, 64), (4096, 16), (4096, 8), (512, 8), (2048, 32),
                 (25600, 48)):
        assert region.use_slab_backbone(n, k) == jregion.use_slab_backbone(
            n, k)
    for n, k in ((25600, 64), (4096, 8), (512, 16), (2048, 16), (25600, 12)):
        assert region._use_slab_crop(n, k) == jregion._use_slab_crop(n, k)
    assert region.group_seed_count(4000, 25600, 256, True) == 1
    assert region.group_seed_count(4000, 25600, 256) == 4     # 4 chunks
    assert region.group_seed_count(2100, 256, 8) == 3         # plain path
    assert region.crop_seed_count(4000, 25600, 64, True) == 1
    assert region.crop_seed_count(128, 512, 16, True) == 1   # plain path


# --- the slice as a whole -----------------------------------------------------

SLICE = {
    "model.num_centroids": (512, 128, 32),
    "region.num_points": 4096, "region.center_num": 128,
    "region.group_num": 64, "region.gripper_num": 8,
    "region.slab_cell": CELL,
    "model.fps_groups": 4, "region.center_fps_groups": 4,
}
# SA1's K decides the sort placement: 16 qualifies for the slab backbone
# (sort before it), 8 does not (sort after it, outputs re-gathered)
PLACEMENTS = {"sort-first": (16, 16, 16), "sort-last": (8, 8, 8)}


def slice_cloud(B=2, N=4096, seed=0):
    """A 24 x 24 x 2.4 cm slab of points above the table: dense enough that
    the 8 mm regions and the gripper boxes hold points, wide enough for
    several x-cells."""
    rng = np.random.RandomState(seed)
    xyz = flat_cloud(B, N, seed, extent=0.12)
    xyz[..., 2] += 0.75
    return np.concatenate([xyz, rng.rand(B, N, 3).astype(np.float32)], -1)


def run_slice(neighbours, dtype=None):
    """Both models on the same cloud, weights and randomness, at compute
    dtype `dtype` (JAX's); returns (JAX output, port output, port model
    launches of the fallback counter)."""
    over = dict(SLICE, **{"model.num_neighbours": neighbours})
    jcfg = jtiny(**over)
    port_over = {k: v for k, v in over.items() if k != "region.num_points"}
    cfg = tiny_config(**port_over, **{
        "model.compute_dtype": jnp.dtype(dtype or jnp.float32).name})
    pc = slice_cloud()
    # slab mode adds no parameter: initialise on the full-scan path
    plain = jtiny(**dict(over, **{"region.slab_cell": 0.0,
                                  "model.fps_groups": 1,
                                  "region.center_fps_groups": 1}))
    variables = jax.jit(JREGNet(plain).init)(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.asarray(pc))
    variables = jax.tree.map(np.array, variables)
    # spread the fresh scores around score_thre = 0.5 (see
    # tests/test_torch_port_model.py, tiny_variables)
    bb = variables["params"]["score_net"]["backbone"]
    bb["score_dense"]["kernel"] = np.abs(bb["score_dense"]["kernel"])
    _, s = jax.jit(JScoreNet(plain.model, dtype=dtype).apply)(
        {c: variables[c]["score_net"] for c in variables}, jnp.asarray(pc))
    logit = np.log(np.asarray(s) / (1.0 - np.asarray(s)))
    k = 16.0 / np.ptp(logit)
    bb["score_bn"]["scale"] *= k
    bb["score_bn"]["bias"] -= k * np.median(logit)

    B, N = pc.shape[:2]
    R, M = cfg.region, cfg.model
    slab_backbone = region.use_slab_backbone(N, M.num_neighbours[0])
    n_group = region.group_seed_count(R.center_num, N, R.group_num, True)
    n_crop = region.crop_seed_count(R.center_num, N, R.gripper_num, True)
    assert n_group == 1 and n_crop == 1      # the slab kernels qualify
    seen = {"crop": []}
    orig = dict(sort=jslab.sort_cloud, ball=jslab.ball_query_slab,
                group=jregion.group_regions,
                crop=jregion.closing_region_crop_dense)

    def sort_spy(key, pc_, cell):
        seen["u"] = np.asarray(jax.random.uniform(key, pc_.shape[:2]))
        return orig["sort"](key, pc_, cell)

    def ball_spy(sc, centers, seed, *a, **kw):
        seen["sa1"] = int(seed)
        return orig["ball"](sc, centers, seed, *a, **kw)

    def group_spy(key, *a, **kw):
        seen["group"] = [seed_of(key)]
        return orig["group"](key, *a, **kw)

    def crop_spy(key, *a, **kw):
        seen["crop"].append([seed_of(key)])
        return orig["crop"](key, *a, **kw)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jregion, "SLAB_INTERPRET", True)
        mp.setattr(jslab, "sort_cloud", sort_spy)
        mp.setattr(jslab, "ball_query_slab", ball_spy)
        mp.setattr(jregnet, "group_regions", group_spy)
        mp.setattr(jregnet, "closing_region_crop_dense", crop_spy)
        # op by op, as tests/test_torch_port_model.py runs the JAX model
        ref = JREGNet(jcfg, dtype=dtype).apply(variables, jnp.asarray(pc),
                                  rngs={"sampling": jax.random.PRNGKey(3)})
    finally:
        mp.undo()
    assert ("sa1" in seen) == slab_backbone

    model = REGNet(cfg)
    weights.load_into(model, variables)
    model.eval()
    _cuda.reset_launches()
    with torch.no_grad():
        out = model(t(pc), group_seeds=seen["group"],
                    crop_seeds=seen["crop"], sort_u=t(seen["u"]),
                    sa1_seed=seen.get("sa1"))
    return ref, out, _cuda.fallbacks["fp3_slab"]


@pytest.fixture(scope="module", params=list(PLACEMENTS))
def slab_run(request):
    return run_slice(PLACEMENTS[request.param])


def test_slab_slice_scores_clear_of_the_threshold(slab_run):
    """No score close enough to 0.5 for f32 rounding to flip the FPS mask;
    the certificate held, so no forward fell back to the full scan."""
    ref, _, fallbacks = slab_run
    s = np.asarray(ref.score)
    assert np.abs(s - 0.5).min() > 2e-5
    assert 0.2 < (s > 0.5).mean() < 0.8
    assert fallbacks == 0


@pytest.mark.parametrize("field", ["point_order", "center_index",
                                   "region_valid", "anchor_index",
                                   "crop_valid", "refine_accept"])
def test_slab_slice_selections_exact(slab_run, field):
    ref, out, _ = slab_run
    np.testing.assert_array_equal(getattr(out, field).numpy(),
                                  np.asarray(getattr(ref, field)))


@pytest.mark.parametrize("field", ["score", "centers", "cls_logits", "reg",
                                   "proposals", "refine_logits",
                                   "final_grasps"])
def test_slab_slice_values_close(slab_run, field):
    ref, out, _ = slab_run
    np.testing.assert_allclose(getattr(out, field).numpy(),
                               np.asarray(getattr(ref, field)), **TOL)


def test_slab_slice_exercises_both_outcomes(slab_run):
    _, out, _ = slab_run
    assert out.region_valid.any()
    assert out.crop_valid.any() and not out.crop_valid.all()
    o = out.point_order.long()
    assert torch.equal(o.sort(-1).values,
                       torch.arange(o.shape[1]).expand_as(o))


def test_slab_forward_draws_its_randomness_from_the_generator():
    cfg = tiny_config(**{k: v for k, v in SLICE.items()
                         if k != "region.num_points"},
                      **{"model.num_neighbours": (16, 16, 16)})
    torch.manual_seed(0)
    model = REGNet(cfg).eval()
    pc = t(slice_cloud(B=1))
    a = model(pc, generator=torch.Generator().manual_seed(1))
    b = model(pc, generator=torch.Generator().manual_seed(1))
    c = model(pc, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a.point_order, b.point_order)
    assert torch.equal(a.final_grasps, b.final_grasps)
    assert not torch.equal(a.point_order, c.point_order)
    # the scores are those of the full-scan model, permuted: only SA1's
    # neighbour picks and the grouped FPS differ
    assert a.score.shape == (1, 4096)
    with pytest.raises(ValueError):
        model(pc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_width_slab_config_builds(dtype):
    """The f32 slab serving configuration and, since the bf16 compute
    dtype was ported, the JAX configuration of record (bf16 + slab + G = 8,
    which raised before)."""
    over = {"region.slab_cell": 0.04, "model.fps_groups": 8,
            "region.center_fps_groups": 8, "model.compute_dtype": dtype}
    model = REGNet(infer_config(**over))
    assert model.score_net.backbone.sa0.fps_groups == 8
    assert model.score_net.backbone.sa1.fps_groups == 1
    assert model.grn_head.stem.dense.compute == getattr(torch, dtype)
    assert region.use_slab_backbone(25600, 64)
    assert region._use_slab_group(25600, 256)
    assert region._use_slab_crop(25600, 64)


def test_infer_cli_slab_flags(tmp_path):
    """--slab-cell and --fps-groups reach the configuration; the scores in
    the pickle are the model's rows (slab order), as the JAX CLI writes
    them."""
    import pickle
    from regnet_for_3d_grasping_torch.cli import infer
    folder = tmp_path / "scene_data"
    folder.mkdir()
    pc = slice_cloud(B=1)[0]
    with open(folder / "0000.p", "wb") as f:
        pickle.dump({"view_cloud": pc[:, :3].astype(np.float64),
                     "view_cloud_color": pc[:, 3:]}, f)
    recs = infer.main(["--folder-name", str(folder), "--center-num", "128",
                       "--all-points-num", "4096", "--device", "cpu",
                       "--no-eval", "--slab-cell", "0.04", "--fps-groups",
                       "4"])
    out = recs[0]["out"]
    assert out.point_order is not None
    with open(tmp_path / "scene_data_predict" / "0000.p", "rb") as f:
        pred = pickle.load(f)
    np.testing.assert_array_equal(pred["scores"][:, 0], out.score[0].numpy())
    # --fast serves the bf16 configuration of record on the same cloud
    recs = infer.main(["--folder-name", str(folder), "--center-num", "128",
                       "--all-points-num", "4096", "--device", "cpu",
                       "--no-eval", "--fast"])
    out = recs[0]["out"]
    assert out.point_order is not None and out.reg.dtype == torch.bfloat16
    assert torch.isfinite(out.final_grasps).all()
