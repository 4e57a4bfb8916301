"""The generator: deterministic by seed, with the contigs, the inversion
and the SNPs its configuration and traffic state."""

import json
import os

import numpy as np
import pytest

from synbench import gen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(kind, name):
    with open(os.path.join(ROOT, kind, f"{name}.json")) as fin:
        return json.load(fin)


TINY = {"genomes": 3, "genome_bp": 400_000, "contigs": 4}
SEED = (1 << 31) + 12345


@pytest.mark.parametrize("traffic", ["div01", "div13"])
def test_same_seed_same_genomes(traffic):
    t = _load("traffic", traffic)
    a = gen.make_genomes(TINY, t, SEED)
    b = gen.make_genomes(TINY, t, SEED)
    c = gen.make_genomes(TINY, t, SEED + 1)
    for x, y in zip(a, b):
        assert np.array_equal(x.letters, y.letters)
        assert np.array_equal(x.contig_lengths, y.contig_lengths)
        assert x.contig_names == y.contig_names
    assert not np.array_equal(a[0].letters, c[0].letters)


@pytest.mark.parametrize("traffic", ["div01", "div13"])
def test_planted_snps_and_inversion(traffic):
    t = _load("traffic", traffic)
    gs = gen.make_genomes(TINY, t, SEED)
    a, b, c = gs
    n_snp = round(t["snp_rate"] * TINY["genome_bp"])
    # genome C: a copy of A with exactly n_snp changed bases, at its SNPs
    diff = np.nonzero(a.letters != c.letters)[0]
    assert len(diff) == n_snp and np.array_equal(diff, c.snp_positions)
    assert set(np.unique(c.letters)) <= set(b"ACGT")
    # genome B: the inversion at inversion_at of the length, 1000 bp at least
    s = int(TINY["genome_bp"] * t["inversion_at"])
    assert b.inversion == (s, s + max(int(TINY["genome_bp"] * t["inversion_len_frac"]), 1000))
    assert c.inversion is None and a.inversion is None
    s, e = b.inversion
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    undone = b.letters.copy()
    undone[s:e] = np.frombuffer(b.letters[s:e][::-1].tobytes().translate(comp), np.uint8)
    assert np.array_equal(np.nonzero(undone != a.letters)[0], b.snp_positions)
    # the inversion lies inside one contig
    ends = np.cumsum(b.contig_lengths)
    assert np.searchsorted(ends, s, side="right") == np.searchsorted(ends, e - 1, side="right")


def test_shared_contig_boundaries():
    gs = gen.make_genomes(TINY, _load("traffic", "div01"), SEED)
    for g in gs:
        assert g.contig_names == ["chr1", "chr2", "chr3", "chr4"]
        assert g.contig_lengths.tolist() == [100_000] * 4


def test_fasta_round_trip(tmp_path):
    g = gen.make_genomes(TINY, _load("traffic", "div01"), SEED)[1]
    path = gen.write_fasta(g, str(tmp_path / g.name))
    names, seqs = [], []
    for line in open(path, "rb").read().split(b"\n"):
        if line.startswith(b">"):
            names.append(line[1:].decode())
            seqs.append(b"")
        elif line:
            assert len(line) <= gen.FASTA_WIDTH
            seqs[-1] += line
    assert names == g.contig_names
    assert b"".join(seqs) == g.letters.tobytes()
    assert os.path.getsize(path) == gen.fasta_bytes(g)


def test_interval_truth():
    g = gen.make_genomes(TINY, _load("traffic", "div01"), SEED)[1]
    s, e = g.inversion
    ts, te, refl = gen.to_a(g, [s + 10, 10, s - 1], [s + 110, 50, e + 1])
    assert ts.tolist() == [e - 110, 10, s - 1] and te.tolist() == [e - 10, 50, e + 1]
    assert refl.tolist() == [True, False, True]
