"""The pools' backward (``csrc/gather_max.cu``), on the CPU.

``dfeature[b, r, c]`` is the sum, in increasing s, of every ``g[b, s, c]``
with ``win[b, s, c] == r``, from +0.0; on bf16 each add is taken in f32 and
rounded to bf16.  The kernel gives each distinct (b, winner, c) one owner,
the first s of its winner in its column, which adds the column's
contributions in s order and stores once.  Its two forms, by S:

- S <= ``kShortRows``: a warp sorts a column's (winner, s) keys (so each
  winner's rows are contiguous and in s order), the first of each run owns
  it and writes its sum at its place in the column's list, in row order,
  with the list's offsets by chunk of ``kBlocksPerChunk`` fill blocks; the
  fill blocks, ``kBlockBytes`` of dfeature each, write zeros and then the
  sums of the owners in their rows, found from those offsets.
- S > ``kShortRows``: a block sorts a column's (winner, g) pairs stably by
  winner, an LSD radix sort of ``kDigitBits`` a pass, ``kSortRows`` rows at
  a time, and each run's first entry stores its sum over the fill's zeros;
  a later segment continues from what the ones before stored.

The kernels run only on the card; here a numpy emulation of both forms is
held bit for bit against the plain version (``scatter_winner_plain``, whose
f32 ``index_add_`` adds in index order on the CPU) and against the JAX
package's backward of both pools (``ops/pooling._gather_max_bwd``, the VJP
of ``gather_max``, also through ``jax.vjp`` on its XLA path, and
``ops/slab._gm_slab_bwd``), at narrow widths.

Tolerances: none.  Every comparison is bit for bit, a NaN equal to any NaN
(the order of the adds is the rule under test).
"""

import re
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.ops import pooling as jpool
from regnet_for_3d_grasping_tpu.ops import slab as jslab

from regnet_for_3d_grasping_torch.ops import _cuda, pooling

SOURCE = Path(__file__).resolve().parents[1] / "regnet_for_3d_grasping_torch" \
    / "csrc" / "gather_max.cu"


def cxx_constant(name):
    found = re.findall(rf"\b{name} = (\d+);", SOURCE.read_text())
    assert len(found) == 1, f"{name}: {found}"
    return int(found[0])


SHORT_ROWS = cxx_constant("kShortRows")
WRITER_CHANNELS = cxx_constant("kWriterChannels")
BLOCK_BYTES = cxx_constant("kBlockBytes")
BLOCKS_PER_CHUNK = cxx_constant("kBlocksPerChunk")
SORT_ROWS = cxx_constant("kSortRows")
DIGIT_BITS = cxx_constant("kDigitBits")

BF = torch.bfloat16


# --- the element type's add ---------------------------------------------------

def bf16_round(x):
    """f32 -> the f32 value of its nearest-even bf16 (a NaN: 0x7fc0), the
    rule of the kernel's `narrow`."""
    u = np.float32(x).view(np.uint32).astype(np.uint64)
    if np.isnan(np.float32(x)):
        return np.uint32(0x7fc00000).view(np.float32)
    r = ((u + 0x7fff + ((u >> 16) & 1)) >> 16) << 16
    return np.uint32(r).view(np.float32)


def accumulate(total, x, bf16):
    s = np.float32(np.float32(total) + np.float32(x))
    return bf16_round(s) if bf16 else s


def owner_sum(values, bf16):
    total = np.float32(0.0)  # +0.0, as the zeros XLA adds to
    for x in values:
        total = accumulate(total, x, bf16)
    return total


# --- the two forms ------------------------------------------------------------

def short_owners(win_col, g_col, bf16):
    """One column, S <= kShortRows: the warp's sort of (winner, s), runs,
    owners -> [(row, sum)] in row order."""
    order = sorted(range(len(win_col)), key=lambda s: (win_col[s], s))
    owners, i = [], 0
    while i < len(order):
        j = i
        while j < len(order) and win_col[order[j]] == win_col[order[i]]:
            j += 1
        owners.append((int(win_col[order[i]]),
                       owner_sum([g_col[s] for s in order[i:j]], bf16)))
        i = j
    return owners


def short_form(g, win, n, bf16):
    """The owners' lists and chunk offsets, then the fill blocks: zeros and
    the sums of the owners in their rows."""
    B, S, C = win.shape
    cw = min(C, WRITER_CHANNELS)
    esize = 2 if bf16 else 4
    block_rows = max(1, BLOCK_BYTES // (cw * esize))
    chunk_rows = block_rows * BLOCKS_PER_CHUNK
    chunks = -(-n // chunk_rows)
    assert chunk_rows >= pooling.CHUNK_ROWS  # the wrapper's scratch suffices
    df = np.full((B, n, C), np.nan, np.float32)  # written only by the blocks
    for b in range(B):
        lists = [short_owners(win[b, :, c], g[b, :, c], bf16)
                 for c in range(C)]
        offset = [np.searchsorted([r for r, _ in lst],
                                  np.arange(chunks + 1) * chunk_rows)
                  for lst in lists]
        for c0 in range(0, C, WRITER_CHANNELS):
            for blk in range(chunks * BLOCKS_PER_CHUNK):
                row0 = blk * block_rows
                rows = min(block_rows, n - row0)
                if rows <= 0:
                    continue
                cs = range(c0, min(C, c0 + WRITER_CHANNELS))
                df[b, row0:row0 + rows, c0:c0 + len(cs)] = 0.0
                for c in cs:
                    k = blk // BLOCKS_PER_CHUNK
                    for row, total in lists[c][offset[c][k]:offset[c][k + 1]]:
                        if row0 <= row < row0 + rows:
                            df[b, row, c] = total
    return df


def radix_sorted(pairs, n):
    """LSD radix on the winner, kDigitBits a pass, stable: as many passes as
    n - 1 has bits."""
    bits = int(n - 1).bit_length() if n > 1 else 0
    for p in range((bits + DIGIT_BITS - 1) // DIGIT_BITS):
        shift = p * DIGIT_BITS
        buckets = [[] for _ in range(1 << DIGIT_BITS)]
        for w, x in pairs:
            buckets[(w >> shift) & ((1 << DIGIT_BITS) - 1)].append((w, x))
        pairs = [e for bucket in buckets for e in bucket]
    return pairs


def sort_form(g, win, n, bf16):
    """The fill, then per column kSortRows rows at a time: sort, runs, each
    owner continuing from what the segments before stored."""
    B, S, C = win.shape
    df = np.zeros((B, n, C), np.float32)
    for b in range(B):
        for c in range(C):
            for s0 in range(0, S, SORT_ROWS):
                seg = radix_sorted(
                    [(int(win[b, s, c]), g[b, s, c])
                     for s in range(s0, min(S, s0 + SORT_ROWS))], n)
                i = 0
                while i < len(seg):
                    j = i
                    while j < len(seg) and seg[j][0] == seg[i][0]:
                        j += 1
                    total = np.float32(0.0) if s0 == 0 else df[b, seg[i][0], c]
                    for _, x in seg[i:j]:
                        total = accumulate(total, x, bf16)
                    df[b, seg[i][0], c] = total
                    i = j
    return df


def emulate(g, win, n, bf16):
    return (short_form if win.shape[1] <= SHORT_ROWS else sort_form)(
        g, win, n, bf16)


# --- cases --------------------------------------------------------------------

def region_like(rng, B, S, C, n, k=6):
    rows = rng.randint(0, n, (B, S, k))
    return np.take_along_axis(rows, rng.randint(0, k, (B, S, C)), 2)


def distinct(rng, B, S, C, n):
    return np.stack([rng.permutation(n)[:S] for _ in range(B * C)]) \
        .reshape(B, C, S).transpose(0, 2, 1)


def signed_zeros_and_nan(rng, shape):
    g = rng.randn(*shape).astype(np.float32)
    g[rng.rand(*shape) < 0.3] = -0.0
    g.flat[3] = np.nan
    return g


CASES = {
    # name: (B, S, C, n, winners, gradient)
    "training shape": (2, 64, 16, 700, region_like, None),
    "4000 rows into 3 (chains of about 1,300)": (
        1, 4000, 2, 3, lambda r, B, S, C, n: r.randint(0, n, (B, S, C)), None),
    "every winner distinct, short": (2, 64, 8, 500, distinct, None),
    "every winner distinct, sorted": (1, 300, 4, 5000, distinct, None),
    "every winner 0, short": (
        2, 64, 8, 300, lambda r, B, S, C, n: np.zeros((B, S, C)), None),
    "every winner 0, 4000 rows": (
        1, 4000, 2, 300, lambda r, B, S, C, n: np.zeros((B, S, C)), None),
    "-0.0 and NaN in g": (2, 64, 8, 40, region_like, signed_zeros_and_nan),
    "-0.0 and NaN in g, sorted": (
        1, 700, 3, 40, region_like, signed_zeros_and_nan),
    "C = 7": (2, 64, 7, 300, region_like, None),
    "past a segment (4,097 rows)": (
        1, SORT_ROWS + 1, 2, 70000,
        lambda r, B, S, C, n: r.randint(0, n, (B, S, C)), None),
}


def make_case(name):
    B, S, C, n, winners, grads = CASES[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    win = np.ascontiguousarray(winners(rng, B, S, C, n).astype(np.int32))
    g = (grads(rng, (B, S, C)) if grads else
         (rng.randn(B, S, C) * 10.0 ** rng.randint(-3, 4, (B, S, C)))
         .astype(np.float32))
    return g, win, n


def as_dtype(g, dtype):
    """g rounded to `dtype`, as numpy f32 values and as a torch tensor."""
    t = torch.from_numpy(g).to(dtype)
    return t.float().numpy(), t


def same(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a.view(np.uint32)[~nan],
                                  b.view(np.uint32)[~nan])


def jax_backwards(g_t, win, n):
    """The JAX package's two backward rules on the same winners and g."""
    jg = jnp.asarray(g_t.float().numpy()).astype(
        jnp.bfloat16 if g_t.dtype == BF else jnp.float32)
    jw = jnp.asarray(win)
    k4 = jpool._gather_max_bwd(0, n, jw, jg)[0]
    k9 = jslab._gm_slab_bwd(128, 4, True, (jw, n), jg)[0]
    return [np.asarray(x.astype(jnp.float32)) for x in (k4, k9)]


# --- tests --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_emulation_is_the_plain_and_the_jax_backward(name, dtype):
    """Each form's emulation equals the plain version and both JAX rules,
    bit for bit; on f32 the plain ``index_add_`` equals the JAX rule too."""
    g, win, n = make_case(name)
    g32, g_t = as_dtype(g, dtype)
    got = emulate(g32, win, n, dtype == BF)
    plain = pooling.scatter_winner_plain(g_t, torch.from_numpy(win), n)
    assert plain.dtype == dtype
    same(got, plain.float().numpy())
    for ref in jax_backwards(g_t, win, n):
        same(got, ref)


def test_short_form_writes_every_entry_once():
    """The fill blocks of the short form cover dfeature exactly: every
    entry is written (zeros or a sum), none twice over another block's."""
    B, S, C, n = 1, 8, 300, 1000
    cw = min(C, WRITER_CHANNELS)
    for esize in (2, 4):
        block_rows = max(1, BLOCK_BYTES // (cw * esize))
        chunks = -(-n // (block_rows * BLOCKS_PER_CHUNK))
        seen = np.zeros((n, C), int)
        for c0 in range(0, C, WRITER_CHANNELS):
            for blk in range(chunks * BLOCKS_PER_CHUNK):
                row0 = blk * block_rows
                seen[row0:row0 + block_rows, c0:c0 + WRITER_CHANNELS] += 1
        assert (seen == 1).all()


def test_order_matters_so_the_rule_is_tested():
    """Another order of the same adds gives other values: the cases above
    hold the order, not only the set of contributions."""
    g, win, n = make_case("4000 rows into 3 (chains of about 1,300)")
    got = emulate(g, win, n, False)
    backwards = emulate(g[:, ::-1].copy(), win[:, ::-1].copy(), n, False)
    assert not np.array_equal(got.view(np.uint32), backwards.view(np.uint32))


def test_pool_gradient_through_jax_vjp_matches():
    """Through ``jax.vjp`` of ``gather_max`` on its XLA path (stride 0): the
    emulation on the port's winners equals JAX's gradient, f32 and bf16."""
    rng = np.random.RandomState(5)
    B, N, C, S, K = 2, 300, 12, 20, 16
    feat = np.maximum(rng.randn(B, N, C), 0).astype(np.float32)
    idx = rng.randint(0, N, (B, S, K)).astype(np.int32)
    gout = rng.randn(B, S, C).astype(np.float32)
    for dtype, jdt in ((torch.float32, jnp.float32), (BF, jnp.bfloat16)):
        f_t = torch.from_numpy(feat).to(dtype)
        _, win = pooling.gather_max_argmax_plain(f_t, torch.from_numpy(idx))
        g32, g_t = as_dtype(gout, dtype)
        got = emulate(g32, win.numpy(), N, dtype == BF)
        _, vjp = jax.vjp(lambda f: jpool.gather_max(f, jnp.asarray(idx), 0),
                         jnp.asarray(f_t.float().numpy()).astype(jdt))
        ref = vjp(jnp.asarray(g32).astype(jdt))[0]
        same(got, np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("S", [64, SHORT_ROWS, SHORT_ROWS + 1, 4000])
def test_wrapper_sizes_the_scratch_for_its_form(S, monkeypatch):
    """Off the CPU the wrapper launches one entry point with the owners'
    scratch the short form needs (none for the sort form), the whole
    backward unless asked for a part.  Tensors on the meta device stand in
    for the card's, with the launch recorded instead of made."""
    seen = []
    monkeypatch.setattr(_cuda, "launch", lambda name, dev, *a: seen.append(
        (name, a)))
    monkeypatch.setattr(_cuda, "check", lambda *a: None)
    meta = torch.device("meta")
    B, C, n = 2, 20, 25600
    g = torch.empty(B, S, C, device=meta)
    win = torch.empty(B, S, C, dtype=torch.int32, device=meta)
    df = pooling.scatter_winner(g, win, n)
    assert df.shape == (B, n, C) and df.dtype == g.dtype
    (name, args), = seen
    assert name == "gather_max_backward"
    scratch = args[3]
    want = (B * C * (2 * S + -(-n // pooling.CHUNK_ROWS) + 1)
            if S <= SHORT_ROWS else 0)
    assert scratch.dtype == torch.int32 and scratch.numel() == want
    assert args[4:] == (B, n, C, S, pooling.BACKWARD_WHOLE)
    assert pooling.SHORT_ROWS == SHORT_ROWS


def test_chunk_rows_is_the_fewest_a_chunk_holds():
    """The wrapper's `CHUNK_ROWS` is the fewest rows a chunk of the short
    form's offsets holds (f32 at kWriterChannels channels), so its scratch
    holds the offsets at every C and dtype."""
    assert pooling.CHUNK_ROWS == BLOCKS_PER_CHUNK * max(
        1, BLOCK_BYTES // (WRITER_CHANNELS * 4))
