"""The port's common-BF cascade and filtered genome sketch against the
JAX package on the CPU: identical filter words, and identical (contig,
position, hash, canonical hash) minimizers when both sketch with the
same filter. Genomes are made from a seed with numpy: several contigs,
N runs, and contigs shorter than one window."""

import os

import numpy as np
import pytest
import torch

from ntsynt_tpu.io.fasta import read_fasta as j_read_fasta
from ntsynt_tpu.ops import bf_build as j_bf_build
from ntsynt_tpu.ops import sketch as j_sketch
from ntsynt_tpu_torch import convert
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


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Two related multi-contig genomes with Ns and short contigs."""
    rng = np.random.default_rng(77)
    tmp = tmp_path_factory.mktemp("torch_sketch")
    lens = [30_000, 12_000, 900, 300, 20, 25_000]
    base = [rng.integers(0, 4, n).astype(np.uint8) for n in lens]
    base[0][5000:5100] = 4  # an N run
    base[5][rng.random(lens[5]) < 0.002] = 4  # scattered Ns
    other = []
    for c in base:
        m = c.copy()
        snp = rng.random(len(m)) < 0.003
        m[snp] = (m[snp] + rng.integers(1, 4, snp.sum())) % 4
        other.append(m)
    pa = _write(tmp / "a.fa", [(f"c{i}", c) for i, c in enumerate(base)])
    pb = _write(tmp / "b.fa", [(f"c{i}", c) for i, c in enumerate(other)])
    return pa, pb


def test_fasta_reader_matches(genomes):
    for p in genomes:
        j, t = j_read_fasta(p), read_fasta(p)
        assert j.contig_names == t.contig_names
        for f in ("lengths", "offsets", "codes", "raw", "fai_offsets", "fai_linebases",
                  "fai_linewidth"):
            np.testing.assert_array_equal(getattr(j, f), getattr(t, f))


def test_common_bf_cascade_matches(genomes):
    jg = [j_read_fasta(p) for p in genomes]
    tg = [read_fasta(p) for p in genomes]
    j_bf = j_bf_build.build_common_bf(jg, K, fpr=0.025, chunk=1 << 15)
    t_bf = bf_build.build_common_bf(tg, K, fpr=0.025, device="cpu")
    assert t_bf.num_bits == j_bf.num_bits
    np.testing.assert_array_equal(t_bf.words_u32(), np.asarray(j_bf.words))
    assert t_bf.fpr() == j_bf.fpr()


@pytest.mark.parametrize("w", [1000, 100, 10])
def test_filtered_sketch_matches(genomes, w):
    jg = [j_read_fasta(p) for p in genomes]
    j_bf = j_bf_build.build_common_bf(jg, K, fpr=0.025, chunk=1 << 15)
    t_bf = convert.bf_from_numpy(np.asarray(j_bf.words), j_bf.num_bits, K, device="cpu")
    for path, g in zip(genomes, jg):
        ref = j_sketch.sketch_genome(g, K, w, common_bf=j_bf, chunk=1 << 14, engine="chunk")
        got = convert.sketch_to_numpy(
            sketch.sketch_genome(read_fasta(path), K, w, common_bf=t_bf, device="cpu")
        )
        assert got["contig_names"] == ref.contig_names
        for f in ("contig_idx", "positions", "hashes", "canon"):
            np.testing.assert_array_equal(got[f], getattr(ref, f), err_msg=f)
        assert got["positions"].dtype == ref.positions.dtype


def test_unfiltered_sketch_and_segments_match(genomes):
    """No filter, and segments far smaller than the stream (windows
    straddling segment boundaries are deduplicated)."""
    from ntsynt_tpu_torch.ops import sketch_device

    g = read_fasta(genomes[0])
    ref = j_sketch.sketch_genome(j_read_fasta(genomes[0]), K, 100, chunk=1 << 14, engine="chunk")
    whole = sketch.sketch_genome(g, K, 100, device="cpu")
    ds = sketch.DeviceStream(g, K, 100, "cpu")
    pos, h = sketch_device.sketch_stream(ds.codes, ds.legit, K, 100, seg=1 << 12)
    for f in ("contig_idx", "positions", "hashes", "canon"):
        np.testing.assert_array_equal(getattr(whole, f), getattr(ref, f), err_msg=f)
    cidx, cpos = ds.stream.to_contig_pos(pos)
    long_rows = ~np.isin(whole.contig_idx, ds.stream.short_contigs())
    np.testing.assert_array_equal(cpos, whole.positions[long_rows])
    np.testing.assert_array_equal(cidx, whole.contig_idx[long_rows])


def test_bloom_filter_roundtrip_and_probe():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, (1 << 16) // 32, dtype=np.uint64).astype(np.uint32)
    bf = convert.bf_from_numpy(words, 1 << 16, K, device="cpu")
    np.testing.assert_array_equal(bf.words_u32(), words)
    canon = rng.integers(0, 1 << 64, 1000, dtype=np.uint64)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little").astype(bool)
    np.testing.assert_array_equal(bf.probe_np(canon), bits[(canon & np.uint64(0xFFFF)).astype(int)])
    assert bf.popcount() == int(bits.sum())
    with pytest.raises(ValueError):
        bloom.BloomFilter(3 << 16, K, device="cpu")


def test_device_argument_is_explicit():
    import ntsynt_tpu_torch

    assert ntsynt_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        ntsynt_tpu_torch.resolve_device("mps")
    if not torch.cuda.is_available():  # cuda is every entry point's default
        with pytest.raises(RuntimeError, match="CUDA"):
            ntsynt_tpu_torch.resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            ntsynt_tpu_torch.resolve_device("cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            bloom.BloomFilter(1 << 16, K)


def test_wrappers_reject_bad_input():
    from ntsynt_tpu_torch.ops import nthash, winmin

    with pytest.raises(ValueError):
        nthash.hash_kmers(torch.zeros(10, dtype=torch.int64), K, 1)
    with pytest.raises(ValueError):
        nthash.hash_kmers(torch.zeros(10, dtype=torch.uint8), K, 5)
    with pytest.raises(ValueError):
        winmin.window_argmin(torch.zeros(5, dtype=torch.int64), 6)
    with pytest.raises(ValueError):
        bloom.insert_words(torch.zeros(7, dtype=torch.int32), torch.zeros(1, dtype=torch.int64),
                           torch.ones(1, dtype=torch.bool), 16)


def test_kernel_sources_carry_their_notes():
    """Every CUDA source names the TPU kernel it replaces and its bound."""
    from ntsynt_tpu_torch.ops import _kernels

    srcs = _kernels.sources()
    assert [os.path.basename(s) for s in srcs] == [
        "bf_insert.cu", "compact.cu", "nthash.cu", "winmin.cu"
    ]
    for s in srcs:
        text = open(s).read()
        assert "Replaces the Pallas TPU kernel" in text
        assert "Bound on the H100" in text
        assert 'extern "C"' in text
        assert "torch/extension.h" not in text
    assert len(_kernels.source_digest()) == 64
