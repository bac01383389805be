"""K4's compaction rule (``csrc/gather_max.cu``), on the CPU.

The kernel reads only the slots that `ops.pooling.kept_slots` keeps: slot
0 and every slot whose row differs from slot 0's.  One warp owns one
(batch, proposal) row; it compacts the kept slots of each pass of 256 in
slot order (a ballot over 32 slots at a time, each kept lane writing at the
popcount of the kept lanes below it), walks the list in groups of 4 rows
(a group past the list's end repeats its last row) and folds each into the
running max (the forward: ``v > m or v != v``; the argmax form, f32 and
bf16: ``v > m or (v != v and m == m)``, so the lowest slot holding the
maximum, or the first NaN, wins).
The kernel runs only on the card; here the rule goes through the plain
versions restricted to the kept slots, and a numpy emulation of the warp's
passes, compaction and folds, and both are held against the unrestricted
plain versions, against the JAX package's plain pools and, on
bucket-structured indices, against its Pallas kernel in interpret mode.

Tolerances: none.  Pooled values are copies of feature values and winners
are row indices, so every comparison is exact (NaN equal to NaN).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.geometry import region as jregion
from regnet_for_3d_grasping_tpu.ops import pooling as jpool
from regnet_for_3d_grasping_tpu.ops import sampling as jsamp
from regnet_for_3d_grasping_tpu.ops.group_pallas import group_regions_pallas

from regnet_for_3d_grasping_torch.geometry import region
from regnet_for_3d_grasping_torch.ops import group, pooling, sampling

SOURCE = Path(__file__).resolve().parents[1] / "regnet_for_3d_grasping_torch" \
    / "csrc" / "gather_max.cu"


def cxx_constant(name):
    found = re.findall(rf"\b{name} = (\d+);", SOURCE.read_text())
    assert len(found) == 1, f"{name}: {found}"
    return int(found[0])


PASS = cxx_constant("kPass")
IN_FLIGHT = cxx_constant("kInFlight")
PASS_CHANNELS = cxx_constant("kPassChannels")


def t(a):
    return torch.from_numpy(np.array(a))


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- the plain versions restricted to the kept slots -----------------------

def restricted(plain, feature, index):
    """`plain` over each row's kept slots alone, in slot order."""
    keep = pooling.kept_slots(index)
    outs = []
    for b in range(index.shape[0]):
        for s in range(index.shape[1]):
            sel = index[b, s][keep[b, s]][None, None]
            outs.append(plain(feature[b:b + 1], sel))
    B, S = index.shape[:2]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[i] for o in outs], 1).reshape(B, S, -1)
                     for i in range(2))
    return torch.cat(outs, 1).reshape(B, S, -1)


# --- an emulation of the kernel's warp --------------------------------------

def compact(slots, first, n):
    """One pass: the ballot compaction of `slots` (PASS of them, the first
    `n` real, -1 past them) -> the kept rows in slot order."""
    out = np.full(len(slots), -1, np.int64)
    count = 0
    for j in range(0, len(slots), 32):
        lanes = slots[j:j + 32]
        keep = (lanes != first) & (j + np.arange(32) < n)
        mask = sum(1 << lane for lane in range(32) if keep[lane])
        for lane in np.flatnonzero(keep):
            below = mask & ((1 << int(lane)) - 1)
            assert out[count + bin(below).count("1")] == -1
            out[count + bin(below).count("1")] = lanes[lane]
        count += bin(mask).count("1")
    return out[:count]


def emulate(feature, index, argmax):
    """The kernel's passes over channels and slots for every row."""
    B, N, C = feature.shape
    S, K = index.shape[1:]
    out = np.zeros((B, S, C), np.float32)
    win = np.zeros((B, S, C), np.int64)
    for b in range(B):
        for s in range(S):
            idx = index[b, s]
            first = idx[0]
            for c0 in range(0, C, PASS_CHANNELS):
                cs = slice(c0, min(C, c0 + PASS_CHANNELS))
                m = feature[b, first, cs].copy()
                w = np.full(m.shape, first)
                for k0 in range(0, K, PASS):
                    slots = np.full(PASS, -1)
                    part = idx[k0:k0 + PASS]
                    slots[:len(part)] = part
                    kept = compact(slots, first, len(part))
                    for g in range(0, len(kept), IN_FLIGHT):
                        # loads, then folds; past the list's end a group
                        # repeats its last row
                        for q in range(IN_FLIGHT):
                            r = kept[min(g + q, len(kept) - 1)]
                            x = feature[b, r, cs]
                            with np.errstate(invalid="ignore"):
                                up = ((x > m) | ((x != x) & (m == m))
                                      if argmax else (x > m) | (x != x))
                            m = np.where(up, x, m)
                            w = np.where(up, r, w)
                out[b, s, cs], win[b, s, cs] = m, w
    return (out, win) if argmax else out


# --- cases ------------------------------------------------------------------

def relu_grid(rng, B, N, C):
    """Features on a coarse grid, half of them 0: maxima tie across rows."""
    return np.maximum(np.round(rng.randn(B, N, C) * 2) / 2, 0).astype(
        np.float32)


def adversarial(seed, B=2, N=300, S=24, K=40):
    """Random rows; slot 0's row copied to random slots (anywhere, the last
    slot included); other rows copied; two all-zero rows; one row of slot
    0's row alone."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, N, (B, S, K)).astype(np.int32)
    copies = rng.rand(B, S, K) < 0.5
    idx[copies] = np.broadcast_to(idx[..., :1], idx.shape)[copies]
    idx[..., -1] = idx[..., 0]
    if K > 30:                           # copies of rows other than slot 0's
        idx[:, ::3, 7] = idx[:, ::3, 3]
        idx[:, 1::3, 20:30] = idx[:, 1::3, 5:6]
    idx[0, 0] = 0
    idx[1, 2] = 0
    idx[0, 5] = idx[0, 5, 0]
    return idx


@pytest.fixture(scope="module")
def group_cases():
    """Bucket-structured indices of a small cloud: JAX's chunked
    `group_regions` (bucket choice) and the fused grouping K11's plain
    version, which fills every empty slot with the region's first pick."""
    rng = np.random.RandomState(21)
    N, M, K = 1600, 96, 32
    xyz = (rng.rand(2, N, 3) * 0.1).astype(np.float32)
    centers = xyz[:, rng.choice(N, M, False)]
    key = jax.random.PRNGKey(4)
    jg = jregion.group_regions(key, jnp.asarray(xyz), jnp.asarray(centers),
                               K, 0.012, with_points=False)
    seed = int(np.asarray(jax.random.key_data(
        jax.random.split(key, 1)))[0, -1])
    pg = region.group_regions([seed], t(xyz), t(centers), K, 0.012)
    eq(pg.index, jg.index)
    L = sampling.pallas_bucket_stride(N, K)
    fi, fc = group.group_regions_fused_plain(t(xyz), t(centers), 5, 0.012,
                                             K, L)
    ri, rc = group_regions_pallas(jnp.asarray(xyz), jnp.asarray(centers),
                                  jnp.uint32(5), 0.012, K, interpret=True)
    eq(fi, ri)
    eq(fc, rc)
    fused = torch.where((fc > 0)[..., None], fi, 0)
    feature = relu_grid(rng, 2, N, 128)
    return {"bucket choice": (feature, np.asarray(jg.index),
                              jsamp.bucket_stride(N, K)),
            "fused grouping": (feature, fused.numpy(), L)}


@pytest.mark.parametrize("case", ["bucket choice", "fused grouping"])
def test_kept_slots_are_the_distinct_rows_of_groupings(group_cases, case):
    """On grouping output the rule keeps each distinct row exactly once,
    and most slots are copies of slot 0's row."""
    _, idx, _ = group_cases[case]
    keep = pooling.kept_slots(t(idx)).numpy()
    for row, k in zip(idx.reshape(-1, idx.shape[-1]),
                      keep.reshape(-1, idx.shape[-1])):
        assert k[0]
        assert sorted(row[k]) == sorted(set(row.tolist()))
    assert keep.mean() < 0.5


@pytest.mark.parametrize("case", ["bucket choice", "fused grouping"])
def test_kept_slots_pool_equal_to_pallas_on_groupings(group_cases, case):
    feature, idx, stride = group_cases[case]
    f, i = t(feature), t(idx)
    ref = jpool.gather_max_pallas(jnp.asarray(feature), jnp.asarray(idx),
                                  stride, interpret=True)
    rp, rw = jpool.gather_max_pallas(jnp.asarray(feature), jnp.asarray(idx),
                                     stride, with_argmax=True,
                                     interpret=True)
    full = pooling.gather_max_plain(f, i)
    full_a = pooling.gather_max_argmax_plain(f, i)
    eq(full, ref)
    eq(full_a[0], rp)
    eq(full_a[1], rw)
    eq(restricted(pooling.gather_max_plain, f, i), full)
    got = restricted(pooling.gather_max_argmax_plain, f, i)
    eq(got[0], full_a[0])
    eq(got[1], full_a[1])
    eq(emulate(feature, idx, False), full)
    em = emulate(feature, idx, True)
    eq(em[0], full_a[0])
    eq(em[1], full_a[1])
    # ties across different rows do occur
    g = feature[np.arange(2)[:, None, None], idx]
    assert ((g == g.max(2, keepdims=True)).sum(2) > 1).mean() > 0.2


@pytest.mark.parametrize("seed,K", [(1, 40), (2, 33), (3, 300), (4, 1)])
def test_kept_slots_pool_equal_on_adversarial_indices(seed, K):
    """Copies of slot 0 anywhere, copies of other rows, ties, all-zero
    rows; K = 300 takes two passes of the compaction."""
    idx = adversarial(seed, K=K)
    feature = relu_grid(np.random.RandomState(seed), 2, 300, 24)
    f, i = t(feature), t(idx)
    xla = jpool._xla_pooled(jnp.asarray(feature), jnp.asarray(idx))
    xp, xw = jpool._xla_pooled_argmax(jnp.asarray(feature), jnp.asarray(idx))
    full = pooling.gather_max_plain(f, i)
    full_a = pooling.gather_max_argmax_plain(f, i)
    eq(full, xla)
    eq(full_a[0], xp)
    eq(full_a[1], xw)
    eq(restricted(pooling.gather_max_plain, f, i), full)
    got = restricted(pooling.gather_max_argmax_plain, f, i)
    eq(got[0], full_a[0])
    eq(got[1], full_a[1])
    eq(emulate(feature, idx, False), full)
    em = emulate(feature, idx, True)
    eq(em[0], full_a[0])
    eq(em[1], full_a[1])
    assert (full_a[1].numpy()[0, 0] == 0).all()


def test_kept_slots_keep_a_nan():
    """A NaN in a row that is not slot 0's, and one in slot 0's row: the
    forward pools NaN as torch.amax does, and the plain argmax form's first
    NaN slot is kept (it is slot 0 or a row other than slot 0's)."""
    idx = adversarial(7)
    feature = relu_grid(np.random.RandomState(7), 2, 300, 24)
    feature[0, idx[0, 3, 9], 4] = np.nan
    feature[1, idx[1, 4, 0], 6] = np.nan
    f, i = t(feature), t(idx)
    full = pooling.gather_max_plain(f, i)
    assert torch.isnan(full).any()
    eq(full, jpool._xla_pooled(jnp.asarray(feature), jnp.asarray(idx)))
    eq(restricted(pooling.gather_max_plain, f, i), full)
    eq(emulate(feature, idx, False), full)
    full_a = pooling.gather_max_argmax_plain(f, i)
    got = restricted(pooling.gather_max_argmax_plain, f, i)
    eq(got[0], full_a[0])
    eq(got[1], full_a[1])
    # the kernel's argmax fold takes the first NaN, as torch.argmax and
    # jnp.argmax (the JAX package's XLA pool) do
    em = emulate(feature, idx, True)
    eq(em[0], full_a[0])
    eq(em[1], full_a[1])
    eq(full_a[1], jpool._xla_pooled_argmax(jnp.asarray(feature),
                                           jnp.asarray(idx))[1])


@pytest.mark.parametrize("C", [4, 7, 260, 520])
def test_emulation_channel_passes(C):
    """C not a multiple of 4 (the kernel's scalar loads), and C past one
    pass of 256 channels."""
    idx = adversarial(C, S=6)
    feature = relu_grid(np.random.RandomState(C), 2, 300, C)
    f, i = t(feature), t(idx)
    eq(emulate(feature, idx, False), pooling.gather_max_plain(f, i))
    em = emulate(feature, idx, True)
    ref = pooling.gather_max_argmax_plain(f, i)
    eq(em[0], ref[0])
    eq(em[1], ref[1])


def test_kept_slots_rule():
    idx = t(np.array([[[5, 5, 3, 5, 3, 9, 5], [0, 0, 0, 0, 0, 0, 0],
                       [2, 1, 1, 2, 2, 2, 0]]], np.int32))
    eq(pooling.kept_slots(idx),
       [[[1, 0, 1, 0, 1, 1, 0], [1, 0, 0, 0, 0, 0, 0],
         [1, 1, 1, 0, 0, 0, 1]]])
