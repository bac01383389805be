"""K8 flat (``three_nn_slab(flat=True)``, ``csrc/three_nn_slab.cu``
``regnet_three_nn_slab_flat``), on the CPU.

JAX's flat grid scans every tile's unclamped key-block span where the spans
sum to at most ``G = B*T*5 // 2`` (tile, block) pairs, and the bounded grid
(spans clamped to `grid_span` blocks) elsewhere, one decision a call; the
certificate is taken over the spans scanned.  Both grids walk a span's
blocks upward from its start and insert with strict compares, so either
gives the three smallest (distance, index) pairs over the spans it scans.

On the card the span launch also writes the unclamped spans and adds them
up with an integer atomic; the scan and merge read that total and pick the
span table.  Here the port's plain version (`slab.three_nn_spans(...,
flat=True)` and `slab.three_nn_slab_plain`) and a numpy emulation of the
three launches (the K8 emulation of ``test_torch_port_slab_nn.py`` on the
chosen spans, over the flat grid's `slab.flat_grid_span` blocks a tile) are
held against JAX's `three_nn_slab(flat=True, interpret=True)`.

Tolerances as in ``test_torch_port_slab_nn.py``: spans, indices and
`proven` exact; distances bit-equal to JAX's formula on JAX's indices, and
JAX's contracted output within rtol 1e-6 of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_knn_split import MAX_Q, THREADS
from test_torch_port_slab_nn import (BIG, H100_SMS, SCAN, TILE,
                                     emulate_merge, emulate_spans,
                                     emulate_split, flat_cloud, t, x_sorted)

from regnet_for_3d_grasping_tpu.ops import slab as jslab

from regnet_for_3d_grasping_torch.ops import slab


def jax_flat(q, keys, bound, grid_span):
    """JAX's flat (index, d2, proven), d2 recomputed without contraction
    on its indices, after checking the kernel's own to rtol 1e-6."""
    ri, rd, rp = jslab.three_nn_slab(jnp.asarray(q), jnp.asarray(keys),
                                     bound=bound, grid_span=grid_span,
                                     flat=True, interpret=True)
    ri, rd = np.asarray(ri), np.asarray(rd)
    d = np.stack([keys[b][ri[b]] for b in range(len(q))]) - q[:, :, None]
    d2 = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
          + d[..., 2] * d[..., 2])
    d2 = np.where(rd == BIG, BIG, d2)
    np.testing.assert_allclose(d2, rd, rtol=1e-6, atol=0)
    return ri, d2, np.asarray(rp)


def emulate_flat(query, key, bound, grid_span):
    """The flat entry point's three launches: (ss, lr scanned, flat taken,
    (idx, d2, proven))."""
    B, Nq, _ = query.shape
    T, nkb = -(-Nq // TILE), -(-key.shape[1] // SCAN)
    cap = min(grid_span, nkb)
    gcap = slab.flat_grid_span(B, T, cap, nkb)
    ssb, lrb = emulate_spans(query, key, bound, grid_span)
    ssu, lru = emulate_spans(query, key, bound, nkb)
    taken = int((ssu[..., 1] - ssu[..., 0]).sum()) <= slab.flat_steps(B, T)
    ss, lr = (ssu, lru) if taken else (ssb, lrb)
    Q, parts = slab.three_nn_slab_grid(B, T, gcap, H100_SMS, THREADS, MAX_Q)
    pidx, pd, _ = emulate_split(query, key, ss, gcap, Q, parts)
    return ss, lr, taken, emulate_merge(query, ss, lr, pidx, pd, parts)


@pytest.fixture(scope="module")
def case():
    """1,500 x-sorted queries (6 tiles) against 4,700 x-sorted keys (5
    blocks), a zero distance tied by the next key."""
    q = x_sorted(flat_cloud(2, 1500, 41))
    keys = x_sorted(flat_cloud(2, 4700, 42))
    keys[:, 100] = q[:, 5]
    keys[:, 101] = keys[:, 100]
    return q, x_sorted(keys)


# bound 0.02: the unclamped spans sum to 24 of G = 30 pairs (flat taken);
# bound 0.08: to 31 (> 30, the bounded grid)
@pytest.mark.parametrize("bound,grid_span,taken", [
    (0.02, 1, True), (0.02, 2, True), (0.02, 3, True),
    (0.08, 1, False), (0.08, 2, False)])
def test_k8_flat_matches_pallas(case, bound, grid_span, taken):
    q, keys = case
    ri, rd, rp = jax_flat(q, keys, bound, grid_span)
    ss, lr = slab.three_nn_spans(t(q), t(keys), bound, grid_span, flat=True)
    ess, elr, etaken, (ei, ed, ep) = emulate_flat(q, keys, bound, grid_span)
    assert etaken == taken
    np.testing.assert_array_equal(ss.numpy(), ess)
    np.testing.assert_array_equal(lr.numpy(), elr)
    pi, pd = slab.three_nn_slab_plain(t(q), t(keys), ss)
    pp = slab.three_nn_certificate(t(q), pd, lr)
    for i, d, p in ((pi, pd, pp), (ei, ed, ep)):
        np.testing.assert_array_equal(np.asarray(i), ri)
        np.testing.assert_array_equal(np.asarray(d), rd)
        np.testing.assert_array_equal(np.asarray(p), rp)
    gi, gd, gp = slab.three_nn_slab(t(q), t(keys), bound, grid_span,
                                    flat=True)
    assert torch.equal(gi, pi) and torch.equal(gd, pd) and torch.equal(gp, pp)
    bss, _ = slab.three_nn_spans(t(q), t(keys), bound, grid_span)
    cut = bool((ess[..., 1] - ess[..., 0] > grid_span).any())
    assert cut == (taken and grid_span < 3)
    if taken and cut:
        # the clamp cut a span: the flat grid scans more than the bounded
        bi, bd, bp = jslab.three_nn_slab(jnp.asarray(q), jnp.asarray(keys),
                                         bound=bound, grid_span=grid_span,
                                         interpret=True)
        assert not torch.equal(ss, bss)
        assert (np.asarray(bi) != ri).any() or (np.asarray(bp) != rp).any()
    else:
        assert torch.equal(ss, bss)


def test_k8_flat_does_nothing_without_a_clamp(case):
    """grid_span at or past the key blocks: no clamp, the bounded grid."""
    q, keys = case
    ss, _ = slab.three_nn_spans(t(q), t(keys), 0.02, 5, flat=True)
    bss, _ = slab.three_nn_spans(t(q), t(keys), 0.02, 5)
    assert torch.equal(ss, bss)
    assert slab.flat_grid_span(2, 6, 5, 5) == 5


@pytest.mark.parametrize("batch,tiles,cap,nkb,want", [
    (1, 100, 3, 5, 5),      # FP3 at serving: room for a whole key row
    (12, 100, 3, 5, 5),     # 12 training clouds
    (1, 2, 1, 20, 4),       # G = 5 leaves one tile at most 4 of 20 blocks
    (1, 1, 3, 20, 3),       # G = 2: at most 2, under the clamp's 3
])
def test_flat_grid_span(batch, tiles, cap, nkb, want):
    g = slab.flat_steps(batch, tiles)
    assert g == batch * tiles * 5 // 2
    got = slab.flat_grid_span(batch, tiles, cap, nkb)
    assert got == want
    assert got >= min(nkb, g - batch * tiles + 1) and cap <= got <= nkb
