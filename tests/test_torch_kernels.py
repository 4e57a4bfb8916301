"""The port's kernels (plain PyTorch versions) against the JAX package's
Pallas kernels run in interpret mode, bit for bit; and, on a CUDA card,
each CUDA kernel against its plain version.

K1 ntHash (nthash_pallas.hash_keys), K2 window argmin
(winmin_pallas.block_scans_pallas via winmin.sliding_block_argmin),
K3 compaction (sketch_device.compact_rows), K4 Bloom-filter insert
(bf_place via bloom.insert_words). Inputs are made from a seed with
numpy and handed to both packages.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntsynt_tpu.ops import bloom as jbloom
from ntsynt_tpu.ops import nthash_pallas, winmin as jwinmin, winmin_pallas
from ntsynt_tpu.ops import sketch_device as jsketch_device
from ntsynt_tpu_torch.ops import bloom, nthash, sketch_device, winmin

U32 = np.uint64(0xFFFFFFFF)


def _halves(u64: np.ndarray):
    return (u64 >> np.uint64(32)).astype(np.uint32), (u64 & U32).astype(np.uint32)


def _bits(mask) -> torch.Tensor:
    """A bool mask as K3's legit input: little-endian bits."""
    return torch.from_numpy(np.packbits(np.asarray(mask, dtype=bool), bitorder="little"))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _codes(rng, n, n_rate=0.01):
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < n_rate] = 4
    codes[n // 3 : n // 3 + 40] = 4  # an N run longer than k
    return codes


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [19, 20, 24, 31])
@pytest.mark.parametrize("n_kmers", [1500, 3071])
def test_k1_hash_matches_pallas(k, n_kmers):
    rng = np.random.default_rng(100 + k)
    codes = _codes(rng, n_kmers + k - 1)
    key_hi, key_lo, c_hi, c_lo = nthash_pallas.hash_keys(
        jnp.asarray(codes), k, n_kmers, want_canon=True, interpret=True
    )
    key, canon, valid = nthash.hash_kmers(torch.from_numpy(codes), k, n_kmers)
    kh, kl = _halves(_u64(key))
    np.testing.assert_array_equal(kh, np.asarray(key_hi))
    np.testing.assert_array_equal(kl, np.asarray(key_lo))
    # the Pallas kernel writes the all-ones sentinel into canon too
    masked = np.where(valid.numpy(), _u64(canon), np.uint64(0xFFFFFFFFFFFFFFFF))
    ch, cl = _halves(masked)
    np.testing.assert_array_equal(ch, np.asarray(c_hi))
    np.testing.assert_array_equal(cl, np.asarray(c_lo))
    # validity and the unmasked canonical hash against the NumPy oracle
    o_canon, _, o_valid = nthash.hash_sequence_np(codes, k)
    np.testing.assert_array_equal(valid.numpy(), o_valid[:n_kmers])
    np.testing.assert_array_equal(_u64(canon), o_canon[:n_kmers])
    i = int(np.argmax(o_valid))
    kmer = "".join("ACGT"[c] for c in codes[i : i + k])
    assert nthash.hash_kmer_np(kmer, k) == int(_u64(key)[i])


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def _keys_with_ties(rng, n, w):
    keys = (rng.integers(0, 6, n).astype(np.uint64) << np.uint64(58)) | rng.integers(
        0, 3, n
    ).astype(np.uint64)
    keys[rng.random(n) < 0.1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    keys[n // 2 : n // 2 + 2 * w] = np.uint64(0xFFFFFFFFFFFFFFFF)  # all-invalid windows
    return keys


@pytest.fixture
def pallas_scans(monkeypatch):
    """Route winmin.sliding_block_argmin through the Pallas scan kernel
    in interpret mode (as tests/test_sketch.py does)."""
    monkeypatch.setattr(jwinmin, "_use_pallas", lambda: True)
    monkeypatch.setattr(
        winmin_pallas, "block_scans_pallas",
        functools.partial(winmin_pallas.block_scans_pallas, interpret=True),
    )


@pytest.mark.parametrize("w", [10, 100, 1000])
def test_k2_window_argmin_matches_pallas(w, pallas_scans):
    rng = np.random.default_rng(200 + w)
    n = 5 * w + 37
    keys = _keys_with_ties(rng, n, w)
    hi, lo = _halves(keys)
    arg_b, mh_b, ml_b = jwinmin.sliding_block_argmin(jnp.asarray(hi), jnp.asarray(lo), w)
    nw = n - w + 1
    j_arg = np.asarray(arg_b)[:, :w].reshape(-1)[:nw]
    j_min = (np.asarray(mh_b)[:, :w].reshape(-1)[:nw].astype(np.uint64) << np.uint64(32)) | (
        np.asarray(ml_b)[:, :w].reshape(-1)[:nw]
    )
    arg, minv = winmin.window_argmin(torch.from_numpy(keys.view(np.int64)), w)
    np.testing.assert_array_equal(arg.numpy(), j_arg)
    np.testing.assert_array_equal(_u64(minv), j_min)
    # leftmost argmin by brute force
    ref = np.array([j + int(np.argmin(keys[j : j + w])) for j in range(nw)])
    np.testing.assert_array_equal(arg.numpy(), ref)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def test_k3_compaction_matches_pallas():
    """Same (position, hash) sets per 8-row tile as the CAP-slot Pallas
    compaction; one tile holds more run starts than CAP, where the port
    keeps them all and the Pallas tile keeps CAP of them plus the count."""
    w, cap, tile = 100, jsketch_device.CAP, jsketch_device.ROW_TILE
    rng = np.random.default_rng(300)
    n = 40 * w + 55
    keys = rng.integers(0, 1 << 62, n, dtype=np.int64).astype(np.uint64)
    keys[rng.random(n) < 0.05] = np.uint64(0xFFFFFFFFFFFFFFFF)
    keys[1000:1500] = np.uint64(0xFFFFFFFFFFFFFFFF)  # windows with no valid k-mer
    # strictly increasing keys: every window of tile 2 starts a new run
    keys[16 * w : 26 * w] = np.arange(10 * w, dtype=np.uint64) + np.uint64(5)
    hi, lo = _halves(keys)
    nw = n - w + 1
    arg_b, mh_b, ml_b = jwinmin.sliding_block_argmin(jnp.asarray(hi), jnp.asarray(lo), w)
    flag = jsketch_device._run_start_flag(arg_b, mh_b, ml_b, w, nw)
    vals, hh, hl, cnt = jsketch_device.compact_rows(flag, arg_b, mh_b, ml_b, w, interpret=True)
    vals, hh, hl, cnt = (np.asarray(x) for x in (vals, hh, hl, cnt))

    arg, minv = winmin.window_argmin(torch.from_numpy(keys.view(np.int64)), w)
    pos, hsh = sketch_device.compact_minimizers(arg, minv, _bits(np.ones(nw, bool)))
    pos, hsh = pos.numpy(), _u64(hsh)
    assert (np.diff(pos) > 0).all()
    win = np.searchsorted(arg.numpy(), pos)  # first window of each selection
    over = 0
    for t in range(len(cnt)):
        in_t = (win >= t * tile * w) & (win < (t + 1) * tile * w)
        c = int(cnt[t])
        assert in_t.sum() == c
        m = min(c, cap)
        j_pairs = set(zip(vals[t, :m].astype(np.int64).tolist(),
                          ((hh[t, :m].astype(np.uint64) << np.uint64(32)) | hl[t, :m]).tolist()))
        p_pairs = set(zip(pos[in_t].tolist(), hsh[in_t].tolist()))
        if c > cap:
            over += 1
            assert j_pairs < p_pairs
        else:
            assert j_pairs == p_pairs
    assert over >= 1


def test_k3_legit_mask_and_contig_starts():
    """A live run that begins after a non-legit window is flagged at its
    first legit window (the JAX package recomputes those on the host)."""
    arg = torch.tensor([3, 3, 3, 3, 7, 7, 9, 9], dtype=torch.int64)
    minv = torch.tensor([5, 5, 5, 5, 2, -1, 1, 1], dtype=torch.int64)
    legit = _bits([0, 0, 1, 1, 1, 1, 1, 0])
    pos, hsh = sketch_device.compact_minimizers(arg, minv, legit)
    assert pos.tolist() == [3, 7, 9]
    assert hsh.tolist() == [5, 2, 1]


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

BITS = 26


def test_k4_insert_matches_pallas_placement():
    rng = np.random.default_rng(400)
    n = 5000
    canon = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    canon[100:200] = canon[0]  # duplicate keys
    canon[300] = np.uint64(0xFFFFFFFFFFFFFFFF)
    valid = rng.random(n) < 0.9
    hi, lo = _halves(canon)
    j_words = jbloom.insert_words(
        jnp.zeros((1 << BITS) // 32, jnp.uint32), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(valid), BITS, place="interpret",
    )
    words = torch.zeros((1 << BITS) // 32, dtype=torch.int32)
    bloom.insert_words(words, torch.from_numpy(canon.view(np.int64)), torch.from_numpy(valid), BITS)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(j_words))
    # inserting again over existing bits is an OR
    more = rng.integers(0, 1 << 64, 3000, dtype=np.uint64)
    mh, ml = _halves(more)
    j_words = jbloom.insert_words(
        j_words, jnp.asarray(mh), jnp.asarray(ml), jnp.ones(3000, bool), BITS, place="interpret"
    )
    bloom.insert_words(words, torch.from_numpy(more.view(np.int64)), torch.ones(3000, dtype=torch.bool), BITS)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(j_words))
    # probe and popcount
    np.testing.assert_array_equal(
        bloom.bf_probe(words, torch.from_numpy(canon.view(np.int64)), BITS).numpy(),
        np.asarray(jbloom.bf_probe(j_words, jnp.asarray(hi), jnp.asarray(lo), BITS)),
    )
    assert bloom.popcount_words(words) == int(
        np.unpackbits(np.asarray(j_words).view(np.uint8)).sum()
    )


@pytest.mark.parametrize("bits_log2", [16, 24, 31, 32, 33, 34])
def test_k4_bit_index_matches_reference(bits_log2):
    """Word and mask of the 32-bit and the 33/34-bit branches of
    ntsynt_tpu/ops/bloom._bit_index, on the index math alone (a 2^34-bit
    filter is 2 GiB)."""
    rng = np.random.default_rng(500 + bits_log2)
    canon = rng.integers(0, 1 << 64, 20000, dtype=np.uint64)
    canon[:4] = [0, 0xFFFFFFFFFFFFFFFF, 0xFFFFFFFF, 0x100000000]
    hi, lo = _halves(canon)
    j_word, j_mask = jbloom._bit_index(jnp.asarray(hi), jnp.asarray(lo), bits_log2)
    word, bit = bloom.bit_index(torch.from_numpy(canon.view(np.int64)), bits_log2)
    np.testing.assert_array_equal(word.numpy(), np.asarray(j_word).astype(np.int64))
    np.testing.assert_array_equal(
        (np.uint32(1) << bit.numpy().astype(np.uint32)), np.asarray(j_mask)
    )


def test_pow2_sizing_matches_reference():
    from ntsynt_tpu.ops import bloom as ref

    for g in (10_000, 200_000, 1_000_003, 100_000_000, 3_000_000_000):
        for fpr in (0.01, 0.025, 0.1):
            assert bloom.reference_bf_bits(g, fpr) == ref.reference_bf_bits(g, fpr)
            r = ref.reference_bf_bits(g, fpr)
            assert bloom.pow2_bits(r) == ref.pow2_bits(r)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no interpret mode)")


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    _need_cuda()
    rng = np.random.default_rng(600)
    k, n = 24, 1 << 20
    codes = torch.from_numpy(_codes(rng, n + k - 1)).cuda()
    got = nthash.hash_kmers(codes, k, n)
    for a, b in zip(got, nthash.hash_kmers_plain(codes, k, n)):
        assert torch.equal(a, b)
    key, canon, valid = got
    for w in (1, 10, 37, 100, 1000):
        for a, b in zip(winmin.window_argmin(key, w), winmin.window_argmin_plain(key, w)):
            assert torch.equal(a, b)
    arg, minv = winmin.window_argmin(key, 1000)
    legit = _bits(rng.random(arg.shape[0]) < 0.9).cuda()
    for a, b in zip(sketch_device.compact_minimizers(arg, minv, legit),
                    sketch_device.compact_plain(arg, minv, legit)):
        assert torch.equal(a, b)
    for bits in (20, 34):
        words = torch.zeros((1 << bits) // 32, dtype=torch.int32, device="cuda")
        bloom.insert_words(words, canon, valid, bits)
        ref = bloom.insert_words_plain(torch.zeros_like(words), canon, valid, bits)
        assert torch.equal(words, ref)
