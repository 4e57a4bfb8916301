"""The port's Bloom-filter paths against the JAX package on the CPU:
the repeat filter at a small segment and at both callers' segments, the
filtered sketch with a repeat filter (and with a non-pow2 btllib filter
probed on the host), native and btllib .bf files crossing between the
packages, and the 35- and 36-bit index math (the make-bf CLIs are in
tests/test_torch_make_bf.py). Inputs are made from a seed with numpy;
tolerance 0 throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntsynt_tpu.io.fasta import read_fasta as j_read_fasta
from ntsynt_tpu.ops import bf_build as j_bf_build
from ntsynt_tpu.ops import bloom as j_bloom
from ntsynt_tpu.ops import nthash as j_nthash
from ntsynt_tpu.ops import sketch as j_sketch
from ntsynt_tpu_torch.io.fasta import read_fasta
from ntsynt_tpu_torch.ops import bf_build, bloom, sketch

K = 24
DEC = np.array(list("ACGTN"))


def _write(path, contigs):
    with open(path, "w") as f:
        for name, codes in contigs:
            f.write(f">{name}\n")
            s = "".join(DEC[codes])
            f.write("\n".join(s[i : i + 60] for i in range(0, len(s), 60)) + "\n")
    return str(path)


def _split(canon):
    return (jnp.asarray((canon >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((canon & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


@pytest.fixture(scope="module")
def repeat_genomes(tmp_path_factory):
    """Two genomes with tandem repeats, one of them across the 2^12-k-mer
    segment border, and an N run, a short contig and a second contig."""
    rng = np.random.default_rng(31)
    tmp = tmp_path_factory.mktemp("torch_bf_paths")
    a = rng.integers(0, 4, 20_000).astype(np.uint8)
    a[3_000:3_400] = a[2_600:3_000]  # tandem repeat inside segment 0
    a[4_000:4_300] = a[3_900:4_200]  # overlapping copy across the 4096 border
    a[9_000:9_500] = a[1_000:1_500]  # repeat in a later segment of an earlier one
    a[12_000:12_060] = 4
    b = a.copy()
    snp = rng.random(len(b)) < 0.003
    b[snp] = (b[snp] + rng.integers(1, 4, snp.sum())) % 4
    c2 = rng.integers(0, 4, 6_000).astype(np.uint8)
    c2[5_000:5_800] = c2[200:1_000]  # a repeat of contig 2 within itself
    pa = _write(tmp / "a.fa", [("c1", a), ("c2", c2), ("short", a[:40])])
    pb = _write(tmp / "b.fa", [("c1", b), ("c2", c2[::-1].copy())])
    return pa, pb


@pytest.mark.parametrize("chunk", [1 << 12, 1 << 20, 1 << 23],
                         ids=["small", "pipeline", "make_repeat_bf"])
def test_repeat_bf_matches_jax(repeat_genomes, chunk):
    """Bit-identical repeat filters at one segment size, including both
    callers' sizes (the pipeline's 2^20, make-repeat-bf's 2^23)."""
    jg = [j_read_fasta(p) for p in repeat_genomes]
    ref = j_bf_build.build_repeat_bf(jg, K, chunk=chunk)
    got = bf_build.build_repeat_bf([read_fasta(p) for p in repeat_genomes], K, chunk=chunk,
                                   device="cpu")
    assert got.num_bits == ref.num_bits
    np.testing.assert_array_equal(got.words_u32(), np.asarray(ref.words))
    assert got.popcount() > 100  # the engineered repeats are in


def test_repeat_segment_semantics_match_jax():
    """One segment with duplicates, invalid entries that share a valid
    key's hash, and a seen filter that already holds some keys."""
    rng = np.random.default_rng(5)
    bits = 18
    n = 3000
    canon = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    canon[10:20] = canon[5]  # duplicates after the first
    canon[50] = canon[60]  # an invalid copy before a valid one
    valid = rng.random(n) < 0.9
    valid[50], valid[60] = False, True
    seen_keys = canon[rng.integers(0, n, 200)]
    j_seen = j_bloom.insert_words(jnp.zeros((1 << bits) // 32, jnp.uint32), *_split(seen_keys),
                                  jnp.ones(200, bool), bits)
    hi, lo = _split(canon)
    j_rep, j_seen2 = j_bf_build.repeat_segment_update(
        jnp.zeros((1 << bits) // 32, jnp.uint32), j_seen, hi, lo, jnp.asarray(valid), bits
    )
    rep = bloom.BloomFilter(1 << bits, K, device="cpu")
    seen = bloom.BloomFilter.from_u32(np.asarray(j_seen), 1 << bits, K, device="cpu")
    t_canon = torch.from_numpy(canon.view(np.int64))
    bf_build.repeat_segment_update(rep, seen, t_canon, torch.from_numpy(valid))
    np.testing.assert_array_equal(rep.words_u32(), np.asarray(j_rep))
    np.testing.assert_array_equal(seen.words_u32(), np.asarray(j_seen2))
    first = bf_build.first_occurrence(t_canon).numpy()
    assert first[5] and not first[10:20].any() and first[50] and not first[60]


@pytest.mark.parametrize("w", [100, 10])
def test_sketch_with_repeat_bf_matches_jax(repeat_genomes, w):
    jg = [j_read_fasta(p) for p in repeat_genomes]
    j_common = j_bf_build.build_common_bf(jg, K, chunk=1 << 14)
    j_rep = j_bf_build.build_repeat_bf(jg, K, chunk=1 << 12)
    common = bloom.BloomFilter.from_u32(np.asarray(j_common.words), j_common.num_bits, K,
                                        device="cpu")
    rep = bloom.BloomFilter.from_u32(np.asarray(j_rep.words), j_rep.num_bits, K, device="cpu")
    for path, g in zip(repeat_genomes, jg):
        ref = j_sketch.sketch_genome(g, K, w, common_bf=j_common, repeat_bf=j_rep,
                                     chunk=1 << 14, engine="chunk")
        got = sketch.sketch_genome(read_fasta(path), K, w, common_bf=common, repeat_bf=rep,
                                   device="cpu")
        for f in ("contig_idx", "positions", "hashes", "canon"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
        unfiltered = sketch.sketch_genome(read_fasta(path), K, w, common_bf=common,
                                          device="cpu")
        assert unfiltered.n_minimizers > got.n_minimizers


def test_sketch_with_host_mod_filters_matches_jax(repeat_genomes, tmp_path):
    """Non-pow2 (reference-shaped) btllib filters load as
    HostModBloomFilter in both packages and give the same sketch; the
    port probes them on the host."""
    jg = [j_read_fasta(p) for p in repeat_genomes]
    g = jg[0]
    canon = j_nthash.hash_sequence_np(g.codes, K)[0]
    rng = np.random.default_rng(2)
    common = j_bloom.HostModBloomFilter(1_000_008, K, np.zeros(1_000_008 // 8, np.uint8))
    common.insert_np(canon[rng.random(len(canon)) < 0.7])
    rep = j_bloom.HostModBloomFilter(80_000, K, np.zeros(10_000, np.uint8))
    rep.insert_np(canon[rng.random(len(canon)) < 0.05])
    paths = [common.save(str(tmp_path / "c.bf")), rep.save(str(tmp_path / "r.bf"))]
    t_common, t_rep = (bloom.load_bf(p, device="cpu") for p in paths)
    assert isinstance(t_common, bloom.HostModBloomFilter)
    ref = j_sketch.sketch_genome(g, K, 100, common_bf=j_bloom.load_bf(paths[0]),
                                 repeat_bf=j_bloom.load_bf(paths[1]), chunk=1 << 14)
    got = sketch.sketch_genome(read_fasta(repeat_genomes[0]), K, 100, common_bf=t_common,
                               repeat_bf=t_rep, device="cpu")
    for f in ("contig_idx", "positions", "hashes", "canon"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)


def test_bf_files_cross_load(tmp_path):
    """Native and btllib containers written by either package load in the
    other to the same words, and re-save to the same bytes; so does a
    non-pow2 HostModBloomFilter."""
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 1 << 64, 4000, dtype=np.uint64)
    j_bf = j_bloom.DeviceBloomFilter(1 << 18, k=21)
    j_bf.insert(*_split(keys))
    t_bf = bloom.BloomFilter(1 << 18, 21, device="cpu")
    t_bf.insert(torch.from_numpy(keys.view(np.int64)), torch.ones(4000, dtype=torch.bool))
    for fmt in ("native", "btllib"):
        jp = j_bf.save(str(tmp_path / f"j.{fmt}.bf"), fmt=fmt)
        tp = t_bf.save(str(tmp_path / f"t.{fmt}.bf"), fmt=fmt)
        assert open(jp, "rb").read() == open(tp, "rb").read(), fmt
        from_j = bloom.load_bf(jp, device="cpu")
        assert (from_j.num_bits, from_j.k) == (j_bf.num_bits, 21)
        np.testing.assert_array_equal(from_j.words_u32(), np.asarray(j_bf.words))
        np.testing.assert_array_equal(np.asarray(j_bloom.load_bf(tp).words), t_bf.words_u32())
        assert isinstance(bloom.BloomFilter.load(tp, device="cpu"), bloom.BloomFilter)
    # a non-pow2 btllib filter
    hm = j_bloom.HostModBloomFilter(123_456, 24, np.zeros(123_456 // 8, np.uint8))
    hm.insert_np(keys)
    jp = hm.save(str(tmp_path / "hm_j.bf"))
    t_hm = bloom.load_bf(jp, device="cpu")
    assert isinstance(t_hm, bloom.HostModBloomFilter) and t_hm.num_bits == 123_456
    probes = np.concatenate([keys, rng.integers(0, 1 << 64, 4000, dtype=np.uint64)])
    np.testing.assert_array_equal(t_hm.probe_np(probes), hm.probe_np(probes))
    np.testing.assert_array_equal(
        t_hm.probe(torch.from_numpy(probes.view(np.int64))).numpy(), hm.probe_np(probes)
    )
    tp = t_hm.save(str(tmp_path / "hm_t.bf"))
    assert open(tp, "rb").read() == open(jp, "rb").read()
    with pytest.raises(ValueError, match="non-pow2"):
        bloom.BloomFilter.load(jp, device="cpu")


@pytest.mark.parametrize("bits_log2", [35, 36])
def test_bit_index_35_36_matches_reference(bits_log2):
    """Word and mask of the >32-bit branch of ntsynt_tpu/ops/bloom._bit_index
    at the explicit --bf sizes (a 2^36-bit filter is 8 GiB)."""
    rng = np.random.default_rng(600 + bits_log2)
    canon = rng.integers(0, 1 << 64, 20000, dtype=np.uint64)
    canon[:4] = [0, 0xFFFFFFFFFFFFFFFF, 0xFFFFFFFF, 0xF00000000]
    j_word, j_mask = j_bloom._bit_index(*_split(canon), bits_log2)
    word, bit = bloom.bit_index(torch.from_numpy(canon.view(np.int64)), bits_log2)
    np.testing.assert_array_equal(word.numpy(), np.asarray(j_word).astype(np.int64))
    np.testing.assert_array_equal(np.uint32(1) << bit.numpy().astype(np.uint32),
                                  np.asarray(j_mask))
    assert int(word.max()) >= 1 << (bits_log2 - 6)  # the top index bits are used


def test_sizing_with_explicit_bytes_matches_reference(repeat_genomes):
    jg = [j_read_fasta(p) for p in repeat_genomes]
    tg = [read_fasta(p) for p in repeat_genomes]
    for fpr, bf_bytes in ((0.025, None), (0.01, None), (0.025, 64_000), (0.025, 1 << 33),
                          (0.025, 1 << 40), (0.025, 1)):
        assert bf_build.bf_size_bits(tg, fpr, bf_bytes) == j_bf_build.bf_size_bits(
            jg, fpr, bf_bytes
        )
    for r in (1, 1 << 30, 3 << 33, 1 << 40):
        for cap in (34, 36):
            assert bloom.pow2_bits(r, max_log2=cap) == j_bloom.pow2_bits(r, max_log2=cap)
    bloom.BloomFilter(1 << 16, K, device="cpu")
    with pytest.raises(ValueError):
        bloom.BloomFilter(1 << 37, K, device="cpu")
