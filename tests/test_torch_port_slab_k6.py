"""Parity of the PyTorch port's sorted-slab selection K6 (``group_slab``,
``ball_query_slab``) and the slab pool K9 on K6's group geometry with the
JAX package, on the CPU: the tests of ``test_torch_port_slab.py`` over its
``group_data`` cloud (18,432 points, 9 scan blocks) and K6's other
geometries, in a file of their own so that the two files run side by side.

Inputs are made with numpy from fixed seeds and fed to both packages; the
JAX side runs its Pallas kernels in interpret mode, the port the kernels'
plain PyTorch versions and the twins of the card's launches
(`card_decomposition`).  Orders, indices, counts, masks, span tables and
pooled values exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.ops import slab as jslab

from regnet_for_3d_grasping_torch.ops import slab
from test_torch_port_slab import (CELL, assert_all_equal, ball_test,
                                  card_decomposition, flat_cloud, jsort,
                                  sorted_centers, t)


# --- K6 group_slab / ball_query_slab ----------------------------------------

@pytest.fixture(scope="module")
def group_data():
    pts = flat_cloud(1, 18432, 9)        # 9 scan blocks
    jsc, sc = jsort(pts, 4)
    centers = sorted_centers(pts, 384, np.random.RandomState(17), far=5)
    return jsc, sc, centers


@pytest.mark.parametrize("grid_span", [None, 6])
def test_k6_group_slab_matches_pallas(group_data, grid_span):
    """win 128 / spw 4 against the full grid and the flat grid."""
    jsc, sc, centers = group_data
    ref = jslab.group_slab(jsc, jnp.asarray(centers), jnp.uint32(5), 0.03,
                           256, CELL, grid_span=grid_span, interpret=True)
    got = slab.group_slab(sc, t(centers), 5, 0.03, 256, CELL)
    assert_all_equal(got, ref)
    r2 = float(np.float32(0.03 ** 2))
    emu, _ = card_decomposition(sc, t(centers), 0.03, 256, slab.GROUP_WIN,
                                slab.GROUP_SPW, False, 5,
                                ball_test(t(centers), r2))
    assert_all_equal(emu, ref)
    idx, cnt, sel, off = got
    assert idx.dtype == cnt.dtype == off.dtype == torch.int32
    assert sel.dtype == torch.bool
    assert not sel[0, -5:].any() and sel[0, :-5].all()
    assert (idx[0, -5:] == 0).all()


def test_k6_group_slab_unaligned_queries_and_batch():
    """M not a multiple of 128 (pad queries in the last tile), B = 2, a
    cloud that is not a whole number of blocks."""
    pts = flat_cloud(2, 9000, 10)
    jsc, sc = jsort(pts, 6)
    centers = sorted_centers(pts, 200, np.random.RandomState(19))
    ref = jslab.group_slab(jsc, jnp.asarray(centers), jnp.uint32(3), 0.03,
                           128, CELL, interpret=True)
    got = slab.group_slab(sc, t(centers), 3, 0.03, 128, CELL)
    assert_all_equal(got, ref)
    emu, _ = card_decomposition(sc, t(centers), 0.03, 128, slab.GROUP_WIN,
                                slab.GROUP_SPW, False, 3, ball_test(
                                    t(centers), float(np.float32(0.03 ** 2))))
    assert_all_equal(emu, ref)


def test_k6_ball_query_slab_matches_pallas():
    """win 256 / spw 2, without replacement (the SA1 geometry)."""
    pts = flat_cloud(1, 9216, 3)
    jsc, sc = jsort(pts, 7)
    c = sorted_centers(np.asarray(jsc.xyz), 640, np.random.RandomState(4))
    ref = jslab.ball_query_slab(jsc, jnp.asarray(c), jnp.uint32(9), 0.04, 64,
                                CELL, interpret=True)
    got = slab.ball_query_slab(sc, t(c), 9, 0.04, 64, CELL)
    assert_all_equal(got, ref)
    emu, _ = card_decomposition(sc, t(c), 0.04, 64, slab.BALL_WIN,
                                slab.BALL_SPW, True, 9, ball_test(
                                    t(c), float(np.float32(0.04 ** 2))))
    assert_all_equal((emu[0], torch.clamp(emu[1], max=64)), ref)
    # without replacement: more distinct rows than with replacement
    rep = slab.group_slab(sc, t(c), 9, 0.04, 64, CELL, win=slab.BALL_WIN,
                          spw=slab.BALL_SPW, distinct=False)[0]

    def n_distinct(idx):
        return np.array([len(np.unique(r)) for r in idx[0].numpy()])

    assert (n_distinct(got[0]) >= n_distinct(rep)).all()
    assert n_distinct(got[0]).sum() > n_distinct(rep).sum()


@pytest.mark.parametrize("grid_span", [None, 6])
def test_k6_distinct_matches_pallas_and_card_decomposition(group_data,
                                                          grid_span):
    """win 256 / spw 2 without replacement (SA1's geometry) over both of
    the JAX grids, with its span table: the plain version, the twins of
    the card's three launches and the Pallas kernel agree exactly."""
    jsc, sc, centers = group_data
    ref = jslab.group_slab(jsc, jnp.asarray(centers), jnp.uint32(7), 0.03,
                           64, CELL, win=256, spw=2, distinct=True,
                           grid_span=grid_span, interpret=True)
    got = slab.group_slab_with_spans(sc, t(centers), 7, 0.03, 64, CELL,
                                     win=256, spw=2, distinct=True)
    assert_all_equal(got[:4], ref)
    emu, ss = card_decomposition(sc, t(centers), 0.03, 64, 256, 2, True, 7,
                                 ball_test(t(centers),
                                           float(np.float32(0.03 ** 2))))
    assert_all_equal(emu, ref)
    np.testing.assert_array_equal(got[4].numpy(), ss)
    assert (got[0] >= 0).all() and got[2][:-5].all()


def test_k6_seed_changes_the_picks(group_data):
    _, sc, centers = group_data
    a = slab.group_slab(sc, t(centers), 5, 0.03, 256, CELL)
    b = slab.group_slab(sc, t(centers), 6, 0.03, 256, CELL)
    assert torch.equal(a[1], b[1]) and torch.equal(a[3], b[3])
    assert not torch.equal(a[0], b[0])


def test_select_wrappers_reject_bad_shapes(group_data):
    _, sc, centers = group_data
    with pytest.raises(ValueError):
        slab.group_slab(sc, t(centers), 1, 0.03, 100, CELL)   # K % 64
    small = slab.SortedCloud(sc.xyz[:, :2048], sc.cell_row[:, :2048],
                             sc.order[:, :2048])
    with pytest.raises(ValueError):
        slab.group_slab(small, t(centers), 1, 0.03, 256, CELL)  # span > cloud


# --- K9 gather_max_slab on K6's group geometry -----------------------------

def test_k9_gather_max_slab_group_geometry(group_data):
    """win 128 / spw 4; the far centers have no covered slot."""
    jsc, sc, centers = group_data
    idx, _, sel, off = slab.group_slab(sc, t(centers), 5, 0.03, 256, CELL)
    feat = np.random.RandomState(13).randn(1, 18432, 48).astype(np.float32)
    ref = jslab.gather_max_slab(jnp.asarray(feat), jnp.asarray(idx.numpy()),
                                jnp.asarray(off.numpy()), jslab.GROUP_WIN,
                                jslab.GROUP_SPW, interpret=True)
    got = slab.gather_max_slab(t(feat), idx, off, slab.GROUP_WIN,
                               slab.GROUP_SPW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[0, -5:] == -1e38).all() and not sel[0, -5:].any()
    # on rows with a pick it is the plain gather + max
    plain = t(feat)[0][idx[0].long()].amax(1)
    assert torch.equal(got[0][sel[0]], plain[sel[0]])


def test_k9_rejects_bad_shapes(group_data):
    _, sc, centers = group_data
    idx, _, _, off = slab.group_slab(sc, t(centers), 5, 0.03, 256, CELL)
    feat = torch.zeros(1, 18432, 8)
    with pytest.raises(ValueError):
        slab.gather_max_slab(feat, idx[..., :100], off, 128, 4)
    with pytest.raises(ValueError):
        slab.gather_max_slab(feat, idx, off[:, :2], 128, 4)
