"""K5 (the binned Bloom-filter sweep) redesigned: binned with K4's
binning (one count, one scan, one or two partition passes) at K5's own
cells, and hot cells split over several blocks. On the CPU: the pure
planning (the digit split of the partition at every filter size, the
binning scan's second-pass plan and hot-cell slices from given counts,
replayed as the kernels read them) held to its invariants and to the
constants of the CUDA sources; and the plain version against the JAX
sweep in interpret mode on a skewed segment and on keys that hit a
filter's last bit. On a CUDA card: the kernel against its plain version
at the edges of its design, and the scan against its plain form.
Inputs are made from a seed with numpy. Tolerance 0 throughout:
Bloom-filter words are bits. JAX is imported only by the tests that
compare with it, so the `cuda` cases run on a machine without it (`-m
cuda --noconftest`)."""

import os
import re

import numpy as np
import pytest
import torch

from ntsynt_tpu_torch.ops import _kernels, bf_sweep, bloom


def _jax():
    """(jax.numpy, the JAX sweep, the JAX bloom module)."""
    import jax.numpy as jnp
    from ntsynt_tpu.ops import bf_sweep as j_sweep
    from ntsynt_tpu.ops import bloom as j_bloom

    return jnp, j_sweep, j_bloom


def _constant(source: str, name: str) -> int:
    text = open(os.path.join(_kernels.CSRC, source)).read()
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", text).group(1))


def _split(canon):
    jnp = _jax()[0]
    hi = (canon >> np.uint64(32)).astype(np.uint32)
    lo = (canon & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return jnp.asarray(hi), jnp.asarray(lo)


def _t(canon):
    return torch.from_numpy(canon.view(np.int64))


def _words(bits_log2):
    return torch.zeros((1 << bits_log2) // 32, dtype=torch.int32)


def _u32(words):
    return words.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# the wrapper's planning
# ---------------------------------------------------------------------------


def test_k5_constants_match_the_source():
    assert bf_sweep.CELL_LOG2 == _constant("bf_sweep.cu", "MAX_CELL_LOG2")
    assert bloom.PART_TILE == _constant("bf_insert.cu", "PART_THREADS") * _constant(
        "bf_insert.cu", "PART_ITEMS")
    assert bloom.MAX_DIGITS_LOG2 == _constant("bf_insert.cu", "MAX_DIGITS_LOG2")
    # new's and prev's cells fit one block's shared memory
    assert 2 * 4 << bf_sweep.CELL_LOG2 <= 227 * 1024
    # a hot cell's slice is its fair share of the blocks, never below the cell
    assert bf_sweep.split_chunk(1 << 26, 1 << 14, 396) == 169_467
    assert bf_sweep.split_chunk(1 << 22, 1 << 14, 396) == 1 << 14
    assert bf_sweep.split_chunk(5, 1 << 11, 0) == 1 << 11


@pytest.mark.parametrize("bits_log2", list(range(16, 33)))
def test_k5_digit_split(bits_log2):
    """Every word of the filter is in one cell, the partition takes one
    pass of at most 2^8 digits or two, and the count's 16-bit histogram
    and the scan's one block (a thread a first-pass range) hold every
    cell."""
    n_words, cell_log2, n_cells = bf_sweep.geometry(bits_log2)
    assert bloom.insert_geometry(bits_log2, bf_sweep.CELL_LOG2)[0] == cell_log2
    digits_a, digits_b = bloom.insert_geometry(bits_log2, bf_sweep.CELL_LOG2)[1:]
    assert n_cells << cell_log2 == n_words
    assert n_cells == 1 << (digits_a + digits_b)
    assert digits_a + digits_b <= _constant("bf_insert.cu", "MAX_CELLS_LOG2")
    assert 0 <= digits_b <= digits_a <= bloom.MAX_DIGITS_LOG2
    # the scan's one block holds every first-pass range in a thread
    assert 1 << digits_a <= _constant("bf_insert.cu", "SCAN_THREADS")
    # one pass up to 2^27 bits; at 2^32 bits 8192 cells take 7 and 6 bits
    assert (digits_b == 0) == (bits_log2 <= 27)
    if bits_log2 == 32:
        assert (digits_a, digits_b) == (7, 6)
    # K4's own geometry is unchanged by the cell_log2 argument's default
    assert bloom.insert_geometry(bits_log2) == bloom.insert_geometry(bits_log2, bloom.CELL_LOG2)


_BINS_CASES = {
    # name: (counts per cell, digits_b, blocks per range as K4 gives them)
    "uniform": ([1000] * 128, 4, 5),
    "one hot range": ([3] * 60 + [1 << 20] * 4 + [7] * 64, 2, 5),
    "every key in one cell": ([0] * 77 + [1 << 22] + [0] * 50, 6, 264),
    "no key": ([0] * 64, 3, 9),
    "ragged": ([0, 5, 4096, 1, 0, 0, 70_000, 12] * 16, 3, 33),
}


@pytest.mark.parametrize("case", list(_BINS_CASES))
def test_k5_second_pass_plan(case):
    """The second pass's plan covers each first-pass range's keys once,
    in shares of at most `share` keys that start on a range's first key
    or a tile past the last share, within the grid of n_ranges + parts
    blocks; a range holding most keys gets most blocks."""
    counts, digits_b, k = _BINS_CASES[case]
    counts = np.asarray(counts, dtype=np.int64)
    n_ranges = counts.shape[0] >> digits_b
    parts = n_ranges * k
    offsets, cursor_a, cursor_b, plan, first = bloom.bin_scan_plain(
        torch.from_numpy(counts.astype(np.int32)), digits_b, n_ranges + parts)
    assert first is None
    ref = np.concatenate([[0], np.cumsum(counts)])
    np.testing.assert_array_equal(offsets.numpy(), ref)
    np.testing.assert_array_equal(cursor_a.numpy(), ref[:-1:1 << digits_b])
    np.testing.assert_array_equal(cursor_b.numpy(), ref[:-1])
    plan = plan.numpy()
    bounds = ref[:: 1 << digits_b]
    total = int(bounds[-1])
    share = (-(-total // parts) + bloom.PART_TILE - 1) // bloom.PART_TILE * bloom.PART_TILE
    hits = np.zeros(total, dtype=np.int64)
    per_range = np.zeros(n_ranges, dtype=np.int64)
    for r, lo, hi, zero in plan:
        assert zero == 0
        if lo >= hi:
            continue
        assert bounds[r] <= lo < hi <= bounds[r + 1] and hi - lo <= share
        assert (lo - bounds[r]) % share == 0
        hits[lo:hi] += 1
        per_range[r] += 1
    assert (hits == 1).all()
    used = int(per_range.sum())
    assert (plan[used:, 1] >= plan[used:, 2]).all()  # the rest return at once
    if total:
        assert per_range.max() == -(-int(np.diff(bounds).max()) // share)


_CELL_WORDS = 1 << bf_sweep.CELL_LOG2
_PLAN_CASES = {
    # name: (counts per cell, invalid keys, units)
    "uniform": ([8192] * 64, 5000, 396),
    "one hot cell": ([10] * 63 + [1 << 22], 0, 396),
    "every key in one cell": ([0] * 100 + [1 << 22] + [0] * 27, 0, 396),
    "single cell": ([1 << 22], 17, 132),
    "no key": ([0] * 128, 100_001, 396),
    "one key": ([0] * 5 + [1] + [0] * 2, 0, 396),
    "few units": ([3 << 20, 1, 0, 5 << 20, 2 << 20], 0, 1),
}


def _replay_plan(counts, invalid, units):
    """The plan as the kernel reads it: each slice index up to the grid's
    bound finds its cell by binary search over first, and its keys."""
    counts = np.asarray(counts, dtype=np.int64)
    n = int(counts.sum()) + invalid
    chunk = bf_sweep.split_chunk(n, _CELL_WORDS, units)
    offsets, _, _, _, first = bloom.bin_scan_plain(torch.from_numpy(counts.astype(np.int32)), 0,
                                                   0, chunk)
    return counts, n, chunk, offsets.numpy().astype(np.int64), first.numpy().astype(np.int64)


@pytest.mark.parametrize("case", list(_PLAN_CASES))
def test_k5_split_plan(case):
    counts, n, chunk, offsets, first = _replay_plan(*_PLAN_CASES[case])
    n_cells = counts.shape[0]
    units = _PLAN_CASES[case][2]
    assert chunk >= _CELL_WORDS and chunk * units >= n  # a fair share, never below a cell
    np.testing.assert_array_equal(np.diff(first), -(-counts // chunk))
    bound = n_cells + n // chunk  # the apply's grid (csrc/bf_sweep.cu)
    assert first[0] == 0 and first[-1] <= bound
    hits = np.zeros(int(offsets[-1]), dtype=np.int64)
    for item in range(bound):
        if item >= first[-1]:
            continue  # surplus blocks return at once
        c = int(np.searchsorted(first[:n_cells], item, side="right")) - 1
        assert first[c] <= item < first[c + 1]
        start = offsets[c] + (item - first[c]) * chunk
        end = min(offsets[c + 1], start + chunk)
        assert 0 < end - start <= chunk
        hits[start:end] += 1
        split = first[c + 1] - first[c] > 1
        assert split == (counts[c] > chunk)
    assert (hits == 1).all()  # every binned key in exactly one slice


def test_k5_split_plan_spreads_a_hot_cell():
    """Every key in one cell of a 2^32-bit filter: the cell is split into
    about one slice per block the card holds, so the apply is not one
    block's work."""
    counts, n, chunk, _, first = _replay_plan([0] * 8191 + [1 << 22], 0, 396)
    assert first[-1] == -(-(1 << 22) // chunk) >= 256
    counts, n, chunk, _, first = _replay_plan([8192] * 8192, 0, 396)
    assert first[-1] == 8192  # a uniform segment splits nothing


# ---------------------------------------------------------------------------
# the plain version against the JAX sweep
# ---------------------------------------------------------------------------


def _skewed(rng, n, bits_log2):
    """Most keys in one 2^19-bit cell (K5's cell), some duplicated, a few
    elsewhere, and keys whose low 32 bits are all ones (the filter's last
    bit)."""
    canon = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    hot = rng.random(n) < 0.9
    cell = np.uint64(3 % (1 << max(bits_log2 - 19, 0)))
    canon[hot] = (canon[hot] & ~np.uint64((1 << bits_log2) - 1)) | (
        cell << np.uint64(19)) | (canon[hot] & np.uint64((1 << 19) - 1))
    canon[10:60] = canon[5]
    canon[100:120] |= np.uint64(0xFFFFFFFF)
    return canon


def test_k5_plain_matches_pallas_on_a_skewed_segment():
    jnp, j_sweep, _ = _jax()
    rng = np.random.default_rng(801)
    bits_log2, n = 22, 30000
    canon = _skewed(rng, n, bits_log2)
    valid = rng.random(n) < 0.95
    hi, lo = _split(canon)
    ref = j_sweep.insert_segment(jnp.zeros((1 << bits_log2) // 32, jnp.uint32), hi, lo,
                                 jnp.asarray(valid), bits_log2, interpret=True)
    got = bf_sweep.sweep_plain(_words(bits_log2), _t(canon), torch.from_numpy(valid), bits_log2)
    np.testing.assert_array_equal(_u32(got), np.asarray(ref))
    assert _u32(got)[-1] >> 31 == 1  # the last bit is set


def test_k5_plain_cascade_matches_pallas_on_a_skewed_segment():
    jnp, j_sweep, _ = _jax()
    rng = np.random.default_rng(802)
    bits_log2, n = 22, 30000
    canon = _skewed(rng, n, bits_log2)
    valid = rng.random(n) < 0.95
    n_words = (1 << bits_log2) // 32
    hh, hl = _split(canon[::3].copy())
    j_prev = j_sweep.insert_segment(jnp.zeros(n_words, jnp.uint32), hh, hl,
                                    jnp.ones(len(canon[::3]), bool), bits_log2, interpret=True)
    hi, lo = _split(canon)
    ref = j_sweep.cascade_segment(j_prev, jnp.zeros(n_words, jnp.uint32), hi, lo,
                                  jnp.asarray(valid), bits_log2, interpret=True)
    prev = torch.from_numpy(np.asarray(j_prev).view(np.int32).copy())
    got = bf_sweep.sweep_plain(_words(bits_log2), _t(canon), torch.from_numpy(valid), bits_log2,
                               prev=prev)
    np.testing.assert_array_equal(_u32(got), np.asarray(ref))
    assert 0 < int(np.unpackbits(_u32(got).view(np.uint8)).sum()) < int(
        np.unpackbits(np.asarray(j_prev).view(np.uint8)).sum())


def test_k5_plain_sets_bit_ffffffff_of_a_2_32_bit_filter():
    """At 2^32 bits the bit 0xFFFFFFFF is the JAX sweep's sort sentinel,
    which it keeps only when a valid key carries it. The JAX sweep takes
    minutes in interpret mode at this size, so the reference is its own
    fallback, the JAX package's sorted-OR insert (place=False)."""
    jnp, _, j_bloom = _jax()
    rng = np.random.default_rng(803)
    n = 3000
    canon = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    canon[:40] |= np.uint64(0xFFFFFFFF)
    valid = rng.random(n) < 0.9
    valid[0] = True
    hi, lo = _split(canon)
    ref = np.asarray(j_bloom.insert_words(jnp.zeros(1 << 27, jnp.uint32), hi, lo,
                                          jnp.asarray(valid), 32, place=False))
    got = _u32(bf_sweep.sweep_plain(_words(32), _t(canon), torch.from_numpy(valid), 32))
    assert got[-1] >> 31 == 1
    nz = np.flatnonzero(ref)
    np.testing.assert_array_equal(np.flatnonzero(got), nz)
    np.testing.assert_array_equal(got[nz], ref[nz])
    # no valid key carries it: the bit stays clear
    valid[:40] = False
    got = _u32(bf_sweep.sweep_plain(_words(32), _t(canon), torch.from_numpy(valid), 32))
    assert got[-1] >> 31 == 0


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")


def _canon_valid(n, seed, p_valid=0.9):
    rng = np.random.default_rng(seed)
    canon = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64))
    return canon.cuda(), torch.from_numpy(rng.random(n) < p_valid).cuda()


def _insert_and_cascade_match_plain(canon, valid, bits):
    """Insert, and cascade over a prev holding every other key, an empty
    prev and a full one, each against the plain version."""
    n_words = (1 << bits) // 32
    half = bf_sweep.sweep_plain(torch.zeros(n_words, dtype=torch.int32, device="cuda"),
                                canon[::2], valid[::2], bits)
    for prev in (None, half, torch.zeros_like(half), torch.full_like(half, -1)):
        words = torch.zeros_like(half)
        if prev is None:
            bf_sweep.insert_segment(words, canon, valid, bits)
        else:
            bf_sweep.cascade_segment(prev, words, canon, valid, bits)
        ref = bf_sweep.sweep_plain(torch.zeros_like(half), canon, valid, bits, prev=prev)
        torch.cuda.synchronize()
        assert torch.equal(words, ref), (bits, canon.shape[0], prev is None)
    del half
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4095, 4097, (1 << 22) + 3])
def test_cuda_k5_sizes_match_plain(n):
    _need_cuda()
    canon, valid = _canon_valid(n, 900 + n % 1000)
    for bits in (16, 20, 28, 32):
        _insert_and_cascade_match_plain(canon, valid, bits)


@pytest.mark.cuda
def test_cuda_k5_edges_match_plain():
    _need_cuda()
    canon, valid = _canon_valid(100_001, 910)
    _insert_and_cascade_match_plain(canon, torch.zeros_like(valid), 32)  # no valid key
    canon, valid = _canon_valid(1 << 22, 911)
    _insert_and_cascade_match_plain(canon, valid, 16)  # a single-cell filter
    _insert_and_cascade_match_plain(canon & ((1 << 19) - 1), valid, 32)  # one cell of 2^32
    _insert_and_cascade_match_plain(canon & ((1 << 19) - 1) | (8191 << 19), valid, 32)
    # views of canon and valid at an odd offset
    _insert_and_cascade_match_plain(canon[1:], valid[1:], 32)
    _insert_and_cascade_match_plain(canon[3 : (1 << 20) + 3], valid[3 : (1 << 20) + 3], 21)


@pytest.mark.cuda
def test_cuda_k5_equals_k4_and_plan_matches_plain():
    _need_cuda()
    canon, valid = _canon_valid(1 << 22, 920)
    for bits in (16, 24, 32):
        swept = torch.zeros((1 << bits) // 32, dtype=torch.int32, device="cuda")
        bf_sweep.insert_segment(swept, canon, valid, bits)
        k4 = torch.zeros_like(swept)
        bloom.insert_words(k4, canon, valid, bits)
        assert torch.equal(swept, k4)
    rng = np.random.default_rng(921)
    # the binning's scan (offsets, cursors, the second pass's plan and the
    # slices) against its plain form, at K4's and K5's cell counts up to
    # 2^36 bits, skewed so that one cell holds 2^22 keys
    for n_cells, digits_b in ((1, 0), (256, 0), (64, 2), (4096, 6), (8192, 6), (65536, 8)):
        counts = rng.integers(0, 3000, n_cells)
        counts[::5] = 0
        counts[rng.integers(0, n_cells)] = 1 << 22
        c = torch.from_numpy(counts.astype(np.int32))
        for chunk in (0, 1, 977, 1 << 14):
            got = bloom.bin_scan(c.cuda(), digits_b, chunk)
            n_plan = 0 if got[3] is None else got[3].shape[0]
            ref = bloom.bin_scan_plain(c, digits_b, n_plan, chunk)
            for g, r in zip(got, ref):
                assert (g is None) == (r is None)
                assert g is None or torch.equal(g.cpu(), r), (n_cells, digits_b, chunk)
