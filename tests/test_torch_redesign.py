"""K4 (binned Bloom-filter insert) and K2 (window argmin staged in shared
memory): the host-side choices of their wrappers, which are pure
functions checked here on the CPU against the constants of the CUDA
sources; and, on a CUDA card, both kernels against their plain versions
at the edges of their designs (the same cases chip_smoke.py runs).
"""

import os
import re

import numpy as np
import pytest
import torch

from ntsynt_tpu_torch.ops import _kernels, bloom, winmin


def _constant(source: str, name: str) -> int:
    text = open(os.path.join(_kernels.CSRC, source)).read()
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", text).group(1))


# ---------------------------------------------------------------------------
# K4's choices
# ---------------------------------------------------------------------------


def test_k4_constants_match_the_source():
    assert bloom.CELL_LOG2 == _constant("bf_insert.cu", "MAX_CELL_LOG2")
    assert bloom.MAX_DIGITS_LOG2 == _constant("bf_insert.cu", "MAX_DIGITS_LOG2")
    assert bloom.DIRECT_WORDS_PER_KEY == _constant("bf_insert.cu", "DIRECT_WORDS_PER_KEY")


@pytest.mark.parametrize("bits_log2", list(range(5, 37)))
def test_k4_geometry_covers_the_filter(bits_log2):
    cell_log2, digits_a, digits_b = bloom.insert_geometry(bits_log2)
    words_log2 = bits_log2 - 5
    assert cell_log2 == min(bloom.CELL_LOG2, words_log2)
    assert cell_log2 + digits_a + digits_b == words_log2  # every word in one cell
    assert 0 <= digits_b <= digits_a <= bloom.MAX_DIGITS_LOG2
    # 16-bit counters: the count's histogram of 2^36 bits' 65,536 cells is 128 KiB
    assert digits_a + digits_b <= _constant("bf_insert.cu", "MAX_CELLS_LOG2")
    # one pass up to 2^28 bits; 2^32 bits: 64 x 64 cells; 2^36: 256 x 256
    assert (digits_b == 0) == (bits_log2 <= 28)
    assert {32: (6, 6), 33: (7, 6), 36: (8, 8)}.get(bits_log2, (digits_a, digits_b)) == (
        digits_a, digits_b)


def test_k4_route_by_density():
    seg = 1 << 26  # bf_build.SEG_KMERS
    assert bloom.insert_route(seg, 32) == "binned"  # the main path's segment
    assert bloom.insert_route(seg, 34) == "binned"  # gigabase genomes
    assert bloom.insert_route(1 << 20, 33) == "direct"  # the repeat walk
    assert bloom.insert_route(1 << 23, 33) == "direct"  # make-repeat-bf's segment
    assert bloom.insert_route(1, 16) == "direct"
    for bits in (16, 20, 32, 36):
        edge = (1 << (bits - 5)) // bloom.DIRECT_WORDS_PER_KEY
        assert bloom.insert_route(edge - 1, bits) == "direct"
        assert bloom.insert_route(edge, bits) == "binned"
    assert bloom.insert_route(1 << 31, 36) == "direct"  # 32-bit slots


# ---------------------------------------------------------------------------
# K2's choices
# ---------------------------------------------------------------------------


def test_k2_constants_match_the_source():
    assert winmin.TILE_KEYS <= _constant("winmin.cu", "MAX_TILE_KEYS")
    threads = _constant("winmin.cu", "THREADS")
    smem = winmin.TILE_KEYS * 10  # keys + 16-bit results
    assert threads // 32 * 32 * winmin.STREAM_LANES * 18 <= smem


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 10, 37, 100, 250, 1000, 2047, 4095, 4096,
                               10_000, 1 << 20])
@pytest.mark.parametrize("n_windows", [1, 3_370, 12_102, 1 << 26])
def test_k2_plan_fits_the_tile(w, n_windows):
    n = n_windows + w - 1
    tile, g, tw, cs = winmin.winmin_plan(n, w, 132)
    assert tile == winmin.TILE_KEYS
    assert tw & (tw - 1) == 0 and 1 <= tw <= 32
    assert cs % 2 == 1  # odd strides: a warp's shared loads hit distinct banks
    if w <= 4095:
        full = (tile - 2) // w - 1  # w-blocks a tile holds
        assert 1 <= g <= full and tw * cs >= w
        assert (full + 1) * w + 2 <= tile < (full + 2) * w + 2
        # the fewest w-blocks per block that keep the grid within
        # BLOCKS_PER_SM blocks per SM, unless a tile holds fewer
        nb, target = -(-n_windows // w), winmin.BLOCKS_PER_SM * 132
        if g < full:
            assert -(-nb // g) <= target
            assert g == 1 or -(-nb // (g - 1)) > target
    else:
        assert (g, tw, cs) == (0, 32, winmin.STREAM_LANES)
    if (n_windows, w) == (1 << 26, 1000):
        assert g == 7  # (1 + 1/7) x 8 bytes of keys read per window
    if (n_windows, w) == (12_102, 250):
        assert g == 1  # 49 w-blocks spread over 49 blocks


# ---------------------------------------------------------------------------
# the build digest
# ---------------------------------------------------------------------------


def test_digest_hashes_headers(tmp_path, monkeypatch):
    for src in _kernels.sources():
        (tmp_path / os.path.basename(src)).write_bytes(open(src, "rb").read())
    monkeypatch.setattr(_kernels, "CSRC", str(tmp_path))
    base = _kernels.source_digest()
    (tmp_path / "shared.cuh").write_text("#pragma once\n")
    with_header = _kernels.source_digest()
    assert with_header != base
    (tmp_path / "shared.cuh").write_text("#pragma once\n// edited\n")
    assert _kernels.source_digest() != with_header
    assert [os.path.basename(s) for s in _kernels.sources()] == [
        "bf_insert.cu", "bf_sweep.cu", "compact.cu", "nthash.cu", "unpack.cu", "winmin.cu"
    ]  # headers are hashed, not compiled


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")


def _canon_valid(n, seed, p_valid=0.9):
    rng = np.random.default_rng(seed)
    canon = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64))
    valid = torch.from_numpy(rng.random(n) < p_valid)
    return canon.cuda(), valid.cuda()


def _both_routes_match_plain(canon, valid, bits):
    ref = bloom.insert_words_plain(
        torch.zeros((1 << bits) // 32, dtype=torch.int32, device="cuda"), canon, valid, bits)
    for insert in (bloom.insert_direct, bloom.insert_binned, bloom.insert_words):
        words = torch.zeros_like(ref)
        insert(words, canon, valid, bits)
        torch.cuda.synchronize()
        assert torch.equal(words, ref), (insert.__name__, bits, canon.shape[0])
    del ref
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 20, 32, 33, 34, 35, 36])
def test_cuda_k4_routes_match_plain(bits):
    _need_cuda()
    canon, valid = _canon_valid((1 << 22) + 3, 700 + bits)  # not a multiple of a tile
    _both_routes_match_plain(canon, valid, bits)


@pytest.mark.cuda
def test_cuda_k4_edges_match_plain():
    _need_cuda()
    canon, valid = _canon_valid(1, 710)
    _both_routes_match_plain(canon, valid, 32)
    canon, valid = _canon_valid(100_001, 711)
    _both_routes_match_plain(canon, torch.zeros_like(valid), 32)  # all keys invalid
    # every key in one 2^20-bit cell of a 2^32-bit filter
    canon, valid = _canon_valid(1 << 22, 712)
    _both_routes_match_plain(canon & ((1 << 20) - 1) | (5 << 20), valid, 32)
    # the repeat walk's segment: sparse, so insert_words goes direct
    canon, valid = _canon_valid(1 << 20, 713)
    assert bloom.insert_route(1 << 20, 33) == "direct"
    _both_routes_match_plain(canon, valid, 33)


def _tie_keys(n, seed):
    rng = np.random.default_rng(seed)
    keys = (rng.integers(0, 5, n, dtype=np.int64) << 60).astype(np.int64)
    keys[rng.random(n) < 0.3] = -1
    return torch.from_numpy(keys).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 10, 37, 100, 250, 1000, 4095, 10_000])
def test_cuda_k2_matches_plain(w):
    _need_cuda()
    rng = np.random.default_rng(800 + w)
    g = max((winmin.TILE_KEYS - 2) // w - 1, 1)  # w-blocks in a full tile
    for n in (w, w + 1, 3 * g * w + 17, (1 << 20) + 3):
        for keys in (torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                                   dtype=np.int64)).cuda(), _tie_keys(n, w)):
            got = winmin.window_argmin(keys, w)
            ref = winmin.window_argmin_plain(keys, w)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (w, n)
    # a view that is not 16-byte aligned
    keys = _tie_keys(5 * w + 9, w)[1:]
    got, ref = winmin.window_argmin(keys, w), winmin.window_argmin_plain(keys, w)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
