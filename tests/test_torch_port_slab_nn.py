"""K8's span table, split scan, merge and certificate
(``csrc/three_nn_slab.cu``), on the CPU.

A K8 call runs three launches and reads nothing on the host: a warp per
(batch, 256-query tile) builds the tile's span table entry (the x-range of
its real queries widened by the bound, both ends searched over the x-sorted
keys 32 probes at a time, JAX's clamp to `grid_span` blocks recentred) and
the x of the nearest unscanned key on each side; blocks of 128 threads x Q
queries scan one part of one block of their tile's span with K3's scan
walked outward from the block's middle query: up with strict compares,
then down with ties going ahead (blocks past the span's stop return at
once); a thread per query merges the span's parts in block order and tests
the certificate, which sets the call's fallback flag.  The kernels run
only on the card; here a numpy emulation of each launch is held against
the plain twins
(`slab.three_nn_spans`, `slab.three_nn_slab_plain`,
`slab.three_nn_certificate`) and against the JAX package's
`three_nn_slab(interpret=True)`; the pure grid rule
`slab.three_nn_slab_grid` is checked at the paths' shapes.

Tolerances: spans, indices and `proven` exact; distances bit-equal between
the port's twins and emulations, and bit-equal to the JAX kernel's formula
``(dx*dx + dy*dy) + dz*dz`` (d = key - query) rounded step by step, which
numpy evaluates on the JAX result's own indices.  The JAX kernel's output
itself differs from that formula by up to 1 ulp on the CPU (XLA contracts
its multiply-adds, even with `interpret=True` under `jax.disable_jit`: 1,974
of 9,000 distances in one case), so it is held to rtol 1e-6, as the K8
tests of ``test_torch_port_slab.py`` hold it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_knn_split import CHUNK, MAX_Q, STEP, THREADS, Best3

from regnet_for_3d_grasping_tpu.ops import slab as jslab

from regnet_for_3d_grasping_torch.ops import knn, slab

H100_SMS = 132
TILE, SCAN = 256, 1024
BIG = np.float32(1e38)


def t(a):
    return torch.from_numpy(np.array(a))


def flat_cloud(B, N, seed, extent=0.35):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-extent, extent, (B, N, 3)).astype(np.float32)
    pts[..., 2] *= 0.1
    return pts


def x_sorted(a):
    return np.stack([c[np.argsort(c[:, 0], kind="stable")] for c in a])


# --- emulations of the three launches ---------------------------------------

def warp_search(x, v, right):
    """The warp's 32-way search: the count of x < v (x <= v if `right`)."""
    lo, hi = 0, len(x)
    while lo < hi:
        step = -(-(hi - lo) // 32)
        p = lo + np.arange(32) * step
        ok = p < hi
        kp = x[np.minimum(p, len(x) - 1)]
        inside = ok & ((kp <= v) if right else (kp < v))
        c = int(inside.sum())
        assert (inside[:c]).all()        # the lanes that hold form a prefix
        if c == 0:
            hi = lo
        else:
            lo, hi = lo + (c - 1) * step + 1, min(lo + c * step, hi)
    return lo


def emulate_spans(query, key, bound, grid_span):
    B, Nq, _ = query.shape
    NK = key.shape[1]
    T, nkb = -(-Nq // TILE), -(-NK // SCAN)
    cap = min(grid_span, nkb)
    ss = np.zeros((B, T, 2), np.int64)
    lr = np.zeros((B, T, 2), np.float32)
    for b in range(B):
        kx = key[b, :, 0]
        for tl in range(T):
            x = query[b, tl * TILE:(tl + 1) * TILE, 0]
            x = x[x < np.float32(1e9)]
            if len(x):
                lo = np.float32(x.min() - np.float32(bound))
                hi = np.float32(x.max() + np.float32(bound))
            else:
                lo = hi = np.float32(1e9)
            srow = warp_search(kx, lo, False)
            erow = warp_search(kx, hi, True)
            assert srow == np.searchsorted(kx, lo, "left")
            assert erow == np.searchsorted(kx, hi, "right")
            start_u = min(srow // SCAN, nkb - 1)
            stop_u = min(max(-(-erow // SCAN), start_u + 1), nkb)
            start, stop = start_u, stop_u
            if cap < nkb:
                mid = (srow + erow) // (2 * SCAN)
                s_ctr = min(max(mid - cap // 2, 0), nkb - cap)
                if stop_u - start_u > cap:
                    start = s_ctr
                stop = min(stop_u, start + cap)
            assert 0 <= start < stop <= nkb and stop - start <= cap
            ss[b, tl] = start, stop
            left, right = start * SCAN - 1, stop * SCAN
            lr[b, tl] = (kx[left] if left >= 0 else -BIG,
                         kx[right] if right < NK else BIG)
    return ss, lr


class Best3Below(Best3):
    """Best3 with `insert_below` (three_nn.cuh)."""

    def insert_below(self, d, j):
        ok = d < BIG
        c0, c1, c2 = (ok & (d <= self.d[:, 0]), ok & (d <= self.d[:, 1]),
                      ok & (d <= self.d[:, 2]))
        d0, d1, d2 = self.d.T.copy()
        i0, i1, i2 = self.i.T.copy()
        self.d[:, 2] = np.where(c1, d1, np.where(c2, d, d2))
        self.i[:, 2] = np.where(c1, i1, np.where(c2, j, i2))
        self.d[:, 1] = np.where(c0, d0, np.where(c1, d, d1))
        self.i[:, 1] = np.where(c0, i0, np.where(c1, j, i1))
        self.d[:, 0] = np.where(c0, d, d0)
        self.i[:, 0] = np.where(c0, j, i0)


def scan_outward(qs, keys, k0, pivot):
    """`three_nn::scan_keys_outward` for the queries `qs` [n, 3] over
    `keys` (at most CHUNK, from index k0): up from the first key whose x
    is not below `pivot` in steps of STEP keys (strict compares, NaN past
    the end), then down from the key before it (compares with <=, NaN
    before the start); a step's compares come before its insertions."""
    n = len(keys)
    assert n <= CHUNK
    nan = np.full((STEP, 3), np.nan, np.float32)
    staged = np.concatenate([nan, keys, nan])          # key s at STEP + s
    lo = int(np.searchsorted(keys[:, 0], pivot, "left"))
    best = Best3Below(len(qs), BIG)

    def dist(at):
        k = staged[STEP + at]
        d = [k[None, :, c] - qs[:, None, c] for c in range(3)]
        return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]      # [n, STEP]

    for s in range(lo, n, STEP):
        at = s + np.arange(STEP)
        d = dist(at)
        with np.errstate(invalid="ignore"):
            hit = (d < best.d[:, 2:]).any(1)
        for i in range(STEP):
            best.insert(np.where(hit, d[:, i], np.nan), k0 + at[i])
    for s in range(lo - 1, -1, -STEP):
        at = s - np.arange(STEP)
        d = dist(at)
        with np.errstate(invalid="ignore"):
            hit = (d <= best.d[:, 2:]).any(1)
            for i in range(STEP):
                best.insert_below(np.where(hit, d[:, i], np.nan), k0 + at[i])
    return best


def emulate_split(query, key, ss, cap, Q, parts):
    """The split launch: partial lists [B, cap * parts, 3, T * 256] and
    which of them a block wrote."""
    B, Nq, _ = query.shape
    NK = key.shape[1]
    T = ss.shape[1]
    halves = TILE // (THREADS * Q)
    P, Mp = cap * parts, T * TILE
    pidx = np.full((B, P, 3, Mp), -7, np.int64)
    pd = np.full((B, P, 3, Mp), np.nan, np.float32)
    writes = np.zeros((B, P, Mp), np.int64)
    sub = SCAN // parts
    for b in range(B):
        for x in range(T * halves * cap * parts):
            h, rest = x % parts, x // parts
            j, rest = rest % cap, rest // cap
            half, tl = rest % halves, rest // halves
            kb = ss[b, tl, 0] + j
            if kb >= ss[b, tl, 1]:
                continue                  # past the span: returns at once
            q = (tl * TILE + half * THREADS * Q + np.arange(Q)[:, None]
                 * THREADS + np.arange(THREADS)[None]).reshape(-1)
            k0 = kb * SCAN + h * sub
            k1 = min(k0 + sub, NK)
            pivot = query[b, min(q[0] + THREADS * Q // 2, Nq - 1), 0]
            best = scan_outward(query[b, np.minimum(q, Nq - 1)],
                                key[b, k0:max(k0, k1)], k0, pivot)
            ok = q < Nq
            p = j * parts + h
            pidx[b, p][:, q[ok]] = best.i[ok].T
            pd[b, p][:, q[ok]] = best.d[ok].T
            writes[b, p, q[ok]] += 1
    return pidx, pd, writes


def emulate_merge(query, ss, lr, pidx, pd, parts):
    """The merge launch: the live parts in block order from (1e38, 0), and
    the certificate."""
    B, Nq, _ = query.shape
    idx = np.zeros((B, Nq, 3), np.int64)
    d2 = np.zeros((B, Nq, 3), np.float32)
    proven = np.ones(B, bool)
    tile = np.arange(Nq) // TILE
    for b in range(B):
        live = (ss[b, tile, 1] - ss[b, tile, 0]) * parts
        best = Best3(Nq, BIG)
        for p in range(pidx.shape[1]):
            on = p < live
            for e in range(3):
                best.insert(np.where(on, pd[b, p, e, :Nq], np.nan),
                            pidx[b, p, e, :Nq])
        idx[b], d2[b] = best.i, best.d
        qx = query[b, :, 0]
        a = qx - lr[b, tile, 0]
        c = lr[b, tile, 1] - qx
        margin = np.where(np.isnan(a), a, np.where(a < c, a, c))
        margin = np.where(margin < 0, np.float32(0), margin)
        with np.errstate(invalid="ignore", over="ignore"):
            proven[b] = (d2[b, :, 2] <= margin * margin).all()
    return idx, d2, proven


def emulate(query, key, bound, grid_span, Q=None, parts=None):
    B, Nq, _ = query.shape
    T = -(-Nq // TILE)
    cap = min(grid_span, -(-key.shape[1] // SCAN))
    rq, rp = slab.three_nn_slab_grid(B, T, cap, H100_SMS, THREADS, MAX_Q)
    Q, parts = Q or rq, parts or rp
    ss, lr = emulate_spans(query, key, bound, grid_span)
    pidx, pd, writes = emulate_split(query, key, ss, cap, Q, parts)
    tile = np.arange(Nq) // TILE
    live = (ss[:, tile, 1] - ss[:, tile, 0]) * parts          # [B, Nq]
    assert (writes[..., :Nq] == (np.arange(cap * parts)[None, :, None]
                                 < live[:, None])).all()
    return ss, lr, emulate_merge(query, ss, lr, pidx, pd, parts)


# --- cases ------------------------------------------------------------------

@pytest.fixture(scope="module")
def nn_case():
    """1,500 x-sorted queries (6 tiles, the last cut) and 4,700 x-sorted
    keys (5 blocks, the last cut at 604 keys), keys off the query grid,
    as at FP3 (the sparse level's points are a subset of the cloud)."""
    q = x_sorted(flat_cloud(2, 1500, 41))
    keys = x_sorted(flat_cloud(2, 4700, 42))
    keys[:, 100] = q[:, 5]                  # a zero distance
    keys[:, 101] = keys[:, 100]             # tied by the next key
    return q, x_sorted(keys)


def jax_ref(q, keys, bound, grid_span):
    """JAX's (index, d2, proven), d2 recomputed without contraction on its
    indices (empty slots keep 1e38), after checking it against the
    kernel's own to rtol 1e-6."""
    ri, rd, rp = jslab.three_nn_slab(jnp.asarray(q), jnp.asarray(keys),
                                     bound=bound, grid_span=grid_span,
                                     interpret=True)
    ri, rd = np.asarray(ri), np.asarray(rd)
    d = np.stack([keys[b][ri[b]] for b in range(len(q))]) - q[:, :, None]
    d2 = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
          + d[..., 2] * d[..., 2])
    d2 = np.where(rd == BIG, BIG, d2)
    np.testing.assert_allclose(d2, rd, rtol=1e-6, atol=0)
    return ri, d2, np.asarray(rp)


@pytest.mark.parametrize("grid_span", [1, 2, 3, 4, 99])
def test_k8_twins_and_emulation_match_pallas(nn_case, grid_span):
    q, keys = nn_case
    ri, rd, rp = jax_ref(q, keys, 0.08, grid_span)
    ss, lr = slab.three_nn_spans(t(q), t(keys), 0.08, grid_span)
    ess, elr, (ei, ed, ep) = emulate(q, keys, 0.08, grid_span)
    np.testing.assert_array_equal(ss.numpy(), ess)
    np.testing.assert_array_equal(lr.numpy(), elr)
    pi, pd = slab.three_nn_slab_plain(t(q), t(keys), ss)
    pp = slab.three_nn_certificate(t(q), pd, lr)
    for i, d, p in ((pi, pd, pp), (ei, ed, ep)):
        np.testing.assert_array_equal(np.asarray(i), ri)
        np.testing.assert_array_equal(np.asarray(d), rd)
        np.testing.assert_array_equal(np.asarray(p), rp)
    gi, gd, gp = slab.three_nn_slab(t(q), t(keys), 0.08, grid_span)
    assert torch.equal(gi, pi) and torch.equal(gd, pd) and torch.equal(gp, pp)
    # query 5 meets two equal keys at distance 0 (walked down where they lie
    # below the block's middle query): the smaller index first
    assert (rd[:, 5, :2] == 0).all() and (ri[:, 5, 1] == ri[:, 5, 0] + 1).all()
    if grid_span == 1:
        assert not rp.any()          # the clamp leaves keys unscanned
    if grid_span == 99:
        assert rp.all() and (ess[..., 1] - ess[..., 0] > 2).any()


@pytest.mark.parametrize("Q,parts", [(1, 1), (2, 2), (1, 4), (2, 4)])
def test_k8_emulation_at_other_grids(nn_case, Q, parts):
    """Every grid the kernel takes gives the same result (parts of 256 keys
    leave the last block's parts 2 and 3 empty: placeholders)."""
    q, keys = nn_case
    ri, rd, rp = jax_ref(q, keys, 0.08, 3)
    _, _, (ei, ed, ep) = emulate(q, keys, 0.08, 3, Q, parts)
    np.testing.assert_array_equal(ei, ri)
    np.testing.assert_array_equal(ed, rd)
    np.testing.assert_array_equal(ep, rp)


def test_k8_sparse_keys_refused():
    """Keys far from some queries: the certificate refuses; fewer than 3
    keys in a span leave (1e38, 0) slots, on both sides; a tile of one
    query."""
    rng = np.random.RandomState(8)
    q = x_sorted(rng.uniform(-0.3, 0.3, (1, 2049, 3)).astype(np.float32))
    keys = x_sorted(rng.uniform(0.25, 0.3, (1, 2050, 3)).astype(np.float32))
    ri, rd, rp = jax_ref(q, keys, 0.05, 3)
    ss, lr, (ei, ed, ep) = emulate(q, keys, 0.05, 3)
    np.testing.assert_array_equal(ei, ri)
    np.testing.assert_array_equal(ed, rd)
    assert not rp[0] and not ep[0]
    gi, gd, gp = slab.three_nn_slab(t(q), t(keys), 0.05)
    np.testing.assert_array_equal(gi.numpy(), ri)
    np.testing.assert_array_equal(gd.numpy(), rd)
    assert not bool(gp[0])


def test_k8_pad_queries_do_not_widen_a_tile():
    """Real queries at x >= 1e9 count as pad queries (JAX's `realq`): a
    tile of them alone gets the span of x = 1e9, past every key."""
    q = x_sorted(flat_cloud(1, 300, 5))
    q[0, 256:, 0] = np.float32(2e9)
    keys = x_sorted(flat_cloud(1, 2100, 6))
    ri, rd, rp = jax_ref(q, keys, 0.06, 3)
    ss, lr = slab.three_nn_spans(t(q), t(keys), 0.06, 3)
    ess, elr, (ei, ed, ep) = emulate(q, keys, 0.06, 3)
    np.testing.assert_array_equal(ss.numpy(), ess)
    assert tuple(ess[0, 1]) == (2, 3)
    np.testing.assert_array_equal(ei, ri)
    np.testing.assert_array_equal(ed, rd)
    np.testing.assert_array_equal(ep, rp)


# --- the grid rule ----------------------------------------------------------

@pytest.mark.parametrize("batch,tiles,cap,want", [
    (1, 100, 3, (1, 4)),    # FP3 at serving: 2,400 blocks, 4 parts a block
    (12, 100, 3, (2, 1)),   # FP3 in a training step: 3,600 blocks
    (2, 100, 3, (2, 4)),    # the card-vs-CPU training step
    (4, 100, 3, (2, 2)),
    (1, 6, 3, (1, 4)),      # too few tiles at any grid: most parts
    (1, 100, 1, (1, 4)),
])
def test_three_nn_slab_grid_at_path_shapes(batch, tiles, cap, want):
    q, parts = slab.three_nn_slab_grid(batch, tiles, cap, H100_SMS, THREADS,
                                       MAX_Q)
    assert (q, parts) == want
    blocks = batch * tiles * (TILE // (THREADS * q)) * cap * parts
    assert blocks >= H100_SMS
    assert parts == 1 or blocks // 2 < slab.NN_BLOCKS_PER_SM * H100_SMS
    assert SCAN // parts >= knn.MIN_RANGE_KEYS


def test_three_nn_slab_grid_refuses_empty():
    with pytest.raises(ValueError):
        slab.three_nn_slab_grid(1, 0, 3, H100_SMS, THREADS, MAX_Q)
