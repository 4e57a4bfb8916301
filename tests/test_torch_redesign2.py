"""K1 (ntHash rolled along runs of k-mers) and K3 (one-pass compaction
with a decoupled look-back): the rolling recurrence and the tiled scan
modelled in NumPy against the plain versions and the JAX package, the
wrappers' host-side sizing checked as pure functions against the CUDA
sources' constants; and, on a CUDA card, both kernels against their
plain versions at the edges of their designs (the cases chip_smoke.py
also runs).
"""

import os
import re

import numpy as np
import pytest
import torch

from ntsynt_tpu_torch.ops import _kernels, nthash, sketch_device

U64 = np.uint64
K_VALUES = [1, 2, 19, 24, 31, 32, 33, 64, 129]


def _constant(source: str, name: str) -> int:
    text = open(os.path.join(_kernels.CSRC, source)).read()
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", text).group(1))


def _codes(rng, n, k):
    """Random codes with N runs (one longer than k), single Ns and codes
    5-255, which count as N."""
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < 0.01] = 4
    junk = rng.random(n) < 0.005
    codes[junk] = rng.integers(5, 256, int(junk.sum()))
    s = n // 3
    codes[s : s + k + 7] = 4
    return codes


def roll_np(codes: np.ndarray, k: int, run: int):
    """K1's schedule in NumPy: k-mers cut into runs of `run`; each run's
    first k-mer hashed by k "in" steps from 0, the others by the rolling
    recurrence with nthash.roll_tables; validity as the run of non-N
    codes ending at the k-mer's last code, saturated at k. Returns
    (canon uint64, key uint64, valid bool)."""
    out_f, in_f, out_r, in_r = nthash.roll_tables(k)
    n = len(codes) - k + 1
    runs = -(-n // run)
    c = np.full(runs * run + k, 4, dtype=np.int64)
    c[: len(codes)] = np.minimum(codes, 4)
    starts = np.arange(runs) * run
    f = np.zeros(runs, U64)
    r = np.zeros(runs, U64)
    good = np.zeros(runs, np.int64)
    for j in range(k):
        cj = c[starts + j]
        f = nthash._srol1_np(f) ^ in_f[cj]
        r = nthash._sror1_np(r) ^ in_r[cj]
        good = np.where(cj < 4, np.minimum(good + 1, k), 0)
    canon = np.zeros((runs, run), U64)
    valid = np.zeros((runs, run), bool)
    for i in range(run):
        canon[:, i] = f + r
        valid[:, i] = good == k
        co, ci = c[starts + i], c[starts + i + k]
        f = nthash._srol1_np(f) ^ out_f[co] ^ in_f[ci]
        r = nthash._sror1_np(r) ^ out_r[co] ^ in_r[ci]
        good = np.where(ci < 4, np.minimum(good + 1, k), 0)
    canon, valid = canon.reshape(-1)[:n], valid.reshape(-1)[:n]
    t = canon * U64(nthash.mix_multiplier(k))
    key = np.where(valid, t ^ (t >> U64(nthash.MULTISHIFT)), U64(0xFFFFFFFFFFFFFFFF))
    return canon, key, valid


# ---------------------------------------------------------------------------
# K1 on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", K_VALUES)
def test_roll_tables_follow_from_the_position_tables(k):
    tf, tr = nthash.hash_tables(k)
    out_f, in_f, out_r, in_r = nthash.roll_tables(k)
    np.testing.assert_array_equal(in_f, tf[k - 1])  # the incoming code's rotation: 0
    np.testing.assert_array_equal(in_r, tr[k - 1])
    np.testing.assert_array_equal(out_f, nthash._srol1_np(tf[0]))
    np.testing.assert_array_equal(out_r, nthash._sror1_np(tr[0]))
    for t in (out_f, in_f, out_r, in_r):
        assert t[4] == 0  # an N adds nothing


def test_split_rotations_invert():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 63, 4096, dtype=np.int64).astype(U64) | (
        rng.integers(0, 2, 4096).astype(U64) << U64(63))
    np.testing.assert_array_equal(nthash._sror1_np(nthash._srol1_np(x)), x)
    np.testing.assert_array_equal(nthash._srol1_np(nthash._sror1_np(x)), x)
    np.testing.assert_array_equal(nthash._srol_np(x, nthash.SROL_PERIOD), x)
    np.testing.assert_array_equal(nthash._srol_np(x, nthash.SROL_PERIOD + 3),
                                  nthash._srol_np(x, 3))


@pytest.mark.parametrize("k", K_VALUES)
@pytest.mark.parametrize("run", [4, 12, 28, 124])
def test_k1_rolling_matches_oracle_and_plain(k, run):
    rng = np.random.default_rng(900 + k)
    n = 3 * run + 5 + 2 * k  # not a multiple of the run
    codes = _codes(rng, n + k - 1, k)
    canon, key, valid = roll_np(codes, k, run)
    o_canon, o_key, o_valid = nthash.hash_sequence_np(codes, k)
    np.testing.assert_array_equal(canon, o_canon)
    np.testing.assert_array_equal(valid, o_valid)
    np.testing.assert_array_equal(key[valid], o_key[valid])
    p_key, p_canon, p_valid = nthash.hash_kmers_plain(torch.from_numpy(codes), k, n)
    np.testing.assert_array_equal(p_canon.numpy().view(U64), canon)
    np.testing.assert_array_equal(p_key.numpy().view(U64), key)
    np.testing.assert_array_equal(p_valid.numpy(), valid)


def test_k1_rolling_matches_pallas():
    import jax.numpy as jnp

    from ntsynt_tpu.ops import nthash_pallas

    k, n = 24, 3071
    rng = np.random.default_rng(924)
    codes = _codes(rng, n + k - 1, k)
    canon, key, valid = roll_np(codes, k, 124)
    key_hi, key_lo, c_hi, c_lo = nthash_pallas.hash_keys(
        jnp.asarray(codes), k, n, want_canon=True, interpret=True)
    u32 = U64(0xFFFFFFFF)
    np.testing.assert_array_equal((key >> U64(32)).astype(np.uint32), np.asarray(key_hi))
    np.testing.assert_array_equal((key & u32).astype(np.uint32), np.asarray(key_lo))
    masked = np.where(valid, canon, U64(0xFFFFFFFFFFFFFFFF))  # Pallas masks canon too
    np.testing.assert_array_equal((masked >> U64(32)).astype(np.uint32), np.asarray(c_hi))
    np.testing.assert_array_equal((masked & u32).astype(np.uint32), np.asarray(c_lo))


def test_k1_constants_match_the_source():
    for name in ("THREADS", "PHASE", "MAX_RUN", "MAX_STAGED_K"):
        assert getattr(nthash, name) == _constant("nthash.cu", name), name
    assert nthash.MAX_RUN % nthash.PHASE == 0
    # the largest block's shared memory (as launch() in the source sizes
    # it: staged codes with the halo, the tile's valid bytes, two rows of
    # PHASE outputs per lane) fits the 227 KB a block may opt into
    tile = nthash.THREADS * nthash.MAX_RUN
    codes = (15 + tile + nthash.MAX_STAGED_K + 3 + 4 + 15) // 16 * 16
    rows = nthash.THREADS // 32 * 2 * 32 * (nthash.PHASE * 8 + 16)
    assert codes + tile + rows <= 232_448


@pytest.mark.parametrize("k", [1, 24, 33, 64, 129, 4096, 4097])
@pytest.mark.parametrize("n", [1, 100, 3_370, 12_102, 1 << 20, 32_940_000, 1 << 26])
def test_k1_plan(n, k):
    sms = 132
    run, tiles, staged = nthash.nthash_plan(n, k, sms)
    assert nthash.PHASE <= run <= nthash.MAX_RUN and run % nthash.PHASE == 0
    tile = nthash.THREADS * run
    assert (tiles - 1) * tile < n <= tiles * tile
    assert staged == (k <= nthash.MAX_STAGED_K)
    # the smallest odd multiple m of PHASE whose direct hash of a run's
    # first k-mer costs at most two steps a k-mer, cut to keep
    # BLOCKS_PER_SM blocks per SM
    m = run // nthash.PHASE
    longest = min(nthash.MAX_RUN // nthash.PHASE, -(-k // (2 * nthash.PHASE)) | 1)
    assert m <= longest and longest % 2 == 1
    assert k <= 2 * nthash.PHASE * longest or longest == nthash.MAX_RUN // nthash.PHASE
    target = nthash.BLOCKS_PER_SM * sms
    if m < longest:
        assert -(-n // (nthash.THREADS * (run + nthash.PHASE))) < target
        assert tiles >= target or m == 1
    if k == 24:
        assert run == nthash.PHASE  # the default k: a warp's stores are contiguous
    if k == 64 and n >= 1 << 26:
        assert run == 3 * nthash.PHASE


def test_k1_table_layout():
    out_f, in_f, out_r, in_r = nthash.roll_tables(24)
    tab = nthash._roll_tables_u64(24)
    assert tab.dtype == U64 and tab.shape == (20,) and tab.flags.c_contiguous
    np.testing.assert_array_equal(tab[0:10:2], out_f)
    np.testing.assert_array_equal(tab[1:10:2], out_r)
    np.testing.assert_array_equal(tab[10::2], in_f)
    np.testing.assert_array_equal(tab[11::2], in_r)


# ---------------------------------------------------------------------------
# K3 on the CPU
# ---------------------------------------------------------------------------


def tiled_compact_np(arg, minv, legit, tile):
    """K3's scan in NumPy: each tile flags its windows with the window
    before it read from memory, counts them, and writes at the sum of the
    counts of the tiles before it."""
    nw = len(arg)
    live = legit & (minv != -1)
    counts, flags = [], []
    for b in range(0, nw, tile):
        e = min(b + tile, nw)
        prev_live = np.concatenate([[live[b - 1] if b else False], live[b : e - 1]])
        prev_arg = np.concatenate([[arg[b - 1] if b else 0], arg[b : e - 1]])
        f = live[b:e] & (~prev_live | (arg[b:e] != prev_arg))
        flags.append(f)
        counts.append(int(f.sum()))
    excl = np.concatenate([[0], np.cumsum(counts)])
    pos = np.zeros(excl[-1], np.int64)
    hsh = np.zeros(excl[-1], np.int64)
    for t, f in enumerate(flags):
        idx = t * tile + np.nonzero(f)[0]
        pos[excl[t] : excl[t + 1]] = arg[idx]
        hsh[excl[t] : excl[t + 1]] = minv[idx]
    return pos, hsh


def _bits(mask: np.ndarray, offset: int = 0) -> torch.Tensor:
    """A bool mask as K3's legit input: little-endian bits, the mask's
    first window at bit offset (the bits before it set)."""
    return torch.from_numpy(np.packbits(np.concatenate([np.ones(offset, bool), mask]),
                                        bitorder="little"))


def _k3_cases(rng, tile):
    """(label, arg, minv, legit) at the edges of K3's design (legit as
    a bool mask)."""
    cases = []
    for nw in (1, 2, tile - 1, tile, tile + 1, 3 * tile + 17):
        arg = np.maximum.accumulate(rng.integers(0, nw + 50, nw)).astype(np.int64)
        minv = rng.integers(-(1 << 62), 1 << 62, nw)
        minv[rng.random(nw) < 0.1] = -1
        cases.append((f"random nw={nw}", arg, minv, rng.random(nw) < 0.95))
    nw = 3 * tile + 5
    arg = np.arange(nw, dtype=np.int64)
    minv = rng.integers(0, 1 << 62, nw)
    cases.append(("every window flagged", arg, minv, np.ones(nw, bool)))
    cases.append(("no valid window", arg, np.full(nw, -1, np.int64), np.ones(nw, bool)))
    cases.append(("no legit window", arg, minv, np.zeros(nw, bool)))
    runs = np.repeat(np.arange(nw // 64 + 1, dtype=np.int64) * 64, 64)[:nw]
    runs[tile:] += 1  # a run change exactly at the second tile's first window
    runs[2 * tile - 3 :] += 1
    cases.append(("run change at a tile's first window", runs, minv, np.ones(nw, bool)))
    legit = np.ones(nw, bool)
    legit[tile - 40 : tile + 40] = False  # a contig gap across a tile boundary
    legit[2 * tile - 1] = False  # the last window before a tile is not live
    cases.append(("legit gaps across tiles", runs, minv, legit))
    return cases


def test_k3_tiled_scan_matches_plain():
    rng = np.random.default_rng(930)
    tile = 256  # the kernel's 4096-window tile, scaled down
    for label, arg, minv, legit in _k3_cases(rng, tile):
        pos, hsh = tiled_compact_np(arg, minv, legit, tile)
        ppos, phsh = sketch_device.compact_plain(
            torch.from_numpy(arg), torch.from_numpy(minv), _bits(legit))
        np.testing.assert_array_equal(pos, ppos.numpy(), err_msg=label)
        np.testing.assert_array_equal(hsh, phsh.numpy(), err_msg=label)


def test_k3_writes_into_out_and_in_place():
    rng = np.random.default_rng(935)
    for label, arg, minv, legit in _k3_cases(rng, 256):
        a, m, lg = torch.from_numpy(arg), torch.from_numpy(minv), _bits(legit)
        ref = sketch_device.compact_plain(a, m, lg)
        out = (torch.full((len(arg) + 3,), 7), torch.full((len(arg) + 3,), 7))
        got = sketch_device.compact_minimizers(a, m, lg, out=out)
        if got[0].shape[0]:  # views of out
            assert got[0].data_ptr() == out[0].data_ptr()
            assert got[1].data_ptr() == out[1].data_ptr()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), label
        a2, m2 = a.clone(), m.clone()
        got = sketch_device.compact_minimizers(a2, m2, lg, out=(a2, m2))
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), label
    with pytest.raises(ValueError):
        sketch_device.compact_minimizers(a, m, lg, out=(a[:-1], m))


def test_k3_constants_and_scratch():
    warps = _constant("compact.cu", "THREADS") // 32
    assert sketch_device.COMPACT_TILE == warps * 64 * _constant("compact.cu", "STEPS")
    tile = sketch_device.COMPACT_TILE
    for nw, tiles in ((1, 1), (tile, 1), (tile + 1, 2), (1 << 26, (1 << 26) // tile)):
        assert sketch_device.compact_scratch_words(nw) == 2 + tiles


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")


def _k1_equal(codes, k, n):
    got = nthash.hash_kmers(codes, k, n)
    ref = nthash.hash_kmers_plain(codes, k, n)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b), (k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("k", K_VALUES)
def test_cuda_k1_matches_plain(k):
    _need_cuda()
    rng = np.random.default_rng(940 + k)
    sms = _kernels.sm_count(0)
    for n in (1, 1000, (1 << 20) + 3, (1 << 22) + 5):
        run, _, _ = nthash.nthash_plan(n, k, sms)
        tile = nthash.THREADS * run
        codes = _codes(rng, n + k - 1, k)
        for p in (0, tile - 1, tile, tile + k // 2, 2 * tile + k - 1, n + k - 2):
            if p < len(codes):
                codes[p] = 4  # a tile's first and last code, its halo, the end
        _k1_equal(torch.from_numpy(codes).cuda(), k, n)
    _k1_equal(torch.full((5000 + k,), 4, dtype=torch.uint8, device="cuda"), k, 5001)
    view = torch.from_numpy(_codes(rng, 70_002 + k, k)).cuda()[3:]  # an odd offset
    _k1_equal(view, k, 70_000)


@pytest.mark.cuda
def test_cuda_k1_beyond_the_staged_halo():
    _need_cuda()
    rng = np.random.default_rng(950)
    for k in (nthash.MAX_STAGED_K, nthash.MAX_STAGED_K + 1, 10_000):
        n = 40_000
        _k1_equal(torch.from_numpy(_codes(rng, n + k - 1, k)).cuda(), k, n)


@pytest.mark.cuda
def test_cuda_k3_matches_plain():
    _need_cuda()
    rng = np.random.default_rng(960)
    tile = sketch_device.COMPACT_TILE
    cases = _k3_cases(rng, tile)
    # more tiles than the card holds blocks at once
    nw = 1 << 24
    arg = np.maximum.accumulate(rng.integers(0, nw, nw)).astype(np.int64)
    cases.append(("2^24 windows", arg, rng.integers(-(1 << 62), 1 << 62, nw),
                  rng.random(nw) < 0.99))
    for label, arg, minv, legit in cases:
        a, m, lg = torch.from_numpy(arg).cuda(), torch.from_numpy(minv).cuda(), _bits(legit).cuda()
        got = sketch_device.compact_minimizers(a, m, lg)
        ref = sketch_device.compact_plain(a, m, lg)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), label
        # the mask at an odd bit offset, as a mesh share reads it
        got = sketch_device.compact_minimizers(a, m, _bits(legit, 5).cuda(), 5)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), label
        # in place, as sketch_stream compacts
        got = sketch_device.compact_minimizers(a, m, lg, out=(a, m))
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), label
