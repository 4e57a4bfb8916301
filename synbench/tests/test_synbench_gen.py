"""The generator: deterministic by seed, with the contigs, the inversion
and the SNPs its configuration and traffic state, and with a
configuration's ``sequence`` the repeats, soft-mask and N gaps of a
published human assembly."""

import hashlib
import json
import os

import numpy as np
import pytest

from synbench import gen, reference

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


def _digest(genomes) -> str:
    h = hashlib.md5()
    for g in genomes:
        h.update(g.name.encode())
        h.update(g.letters.tobytes())
        h.update(np.asarray(g.contig_lengths, np.int64).tobytes())
        h.update(b"-" if g.snp_positions is None else
                 np.asarray(g.snp_positions, np.int64).tobytes())
        h.update(repr(g.inversion).encode())
    return h.hexdigest()


# make_genomes of the shipped configurations cut to 300 kb a genome, as
# the generator made them before it took a ``sequence``: the cells'
# genomes, and so their FASTA bytes, may not move
RECORDED = {
    ("human2_1g", "div01", (1 << 31) + 12345): "0f752fef8fb8d0ce7a303cba228d3951",
    ("human2_1g", "div01", 5): "cc06a39f24c43453ff8eeffbf010f434",
    ("human2_1g", "div13", (1 << 31) + 12345): "b88818bc1b6f9a87d6cf7a17c891c56c",
    ("human2_1g", "div13", 5): "0276d08df091fa435e63e00e301a1b5d",
    ("apes4_500m", "div01", (1 << 31) + 12345): "b9123230537edc305ff140403b2a9a1f",
    ("apes4_500m", "div01", 5): "a8b72c6262691015d07d4b29d962a862",
    ("apes4_500m", "div13", (1 << 31) + 12345): "4e68ba1d470fab9baf1922fbf44c0b7c",
    ("apes4_500m", "div13", 5): "be2eb9f2b9af5be1d0b36d77e072e3e6",
}


@pytest.mark.parametrize("config,traffic,seed", sorted(RECORDED))
def test_shipped_configurations_unchanged(config, traffic, seed):
    conf = dict(_load("configs", config), genome_bp=300_000)
    gs = gen.make_genomes(conf, _load("traffic", traffic), seed)
    assert _digest(gs) == RECORDED[config, traffic, seed]
    assert all(g.repeats is None and g.gaps is None for g in gs)


SM = _load("tests/data", "tiny_sm")  # soft-masked, gapped, IHGSC's repeat shares
SM_SEED = (1 << 31) + 777


def _mask(intervals, total) -> np.ndarray:
    """bool [total]: True inside the intervals (start, end first)."""
    d = np.zeros(total + 1, np.int64)
    np.add.at(d, intervals[:, 0], 1)
    np.add.at(d, intervals[:, 1], -1)
    return np.cumsum(d[:-1]) > 0


@pytest.mark.parametrize("seed", [SM_SEED, 3])
def test_repeat_shares(seed):
    """Each family holds its genome_frac of the non-N bases, within half
    a percentage point, at 10 Mbp; the N share is the gaps'."""
    conf = dict(SM, genomes=1, genome_bp=10_000_000, contigs=5,
                sequence=dict(SM["sequence"], gaps=dict(end_bp=10_000, genome_frac=0.05,
                                                       mean_bp=200_000)))
    a = gen.make_genomes(conf, _load("traffic", "div01"), seed)[0]
    non_n = a.total - a.gap_bp
    for j, fam in enumerate(conf["sequence"]["repeats"]):
        r = a.repeats[a.repeats[:, 2] == j]
        share = (r[:, 1] - r[:, 0]).sum() / non_n
        assert abs(share - fam["genome_frac"]) <= 0.005, (fam["name"], share)
    assert 0.045 <= a.gap_bp / a.total <= 0.05
    assert np.count_nonzero(a.letters == ord("N")) == a.gap_bp
    # every contig starts and ends with end_bp of N
    for off, ln in zip(a.offsets, a.contig_lengths):
        assert (a.letters[off:off + 10_000] == ord("N")).all()
        assert (a.letters[off + ln - 10_000:off + ln] == ord("N")).all()


def test_copies_on_both_strands():
    """Full-length, undiverged copies: the family's untouched copies read
    as the consensus on one strand or its reverse complement, and both
    occur."""
    fam = dict(name="x", consensus_bp=300, genome_frac=0.1, copy_mean_bp=300,
               copy_div_pct=[0, 0])
    conf = dict(SM, genomes=1, genome_bp=1_000_000, sequence={"repeats": [fam]})
    a = gen.make_genomes(conf, _load("traffic", "div01"), SM_SEED)[0]
    whole = a.repeats[a.repeats[:, 1] - a.repeats[:, 0] == 300]
    seqs = {a.letters[s:e].tobytes() for s, e, _ in whole.tolist()}
    assert len(whole) > 100 and len(seqs) == 2
    x, y = seqs
    assert x[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA")) == y
    assert set(x) <= set(b"ACGT")  # no soft_mask: uppercase


@pytest.mark.parametrize("traffic", ["div01", "div13"])
def test_lowercase_is_the_repeats(traffic):
    """In every genome, SNPs and the inversion applied, the lowercase
    bases are exactly its repeat intervals, the N exactly its gaps, and
    every other base is one of ACGT; SNPs keep the case."""
    t = _load("traffic", traffic)
    conf = dict(SM, genomes=3)
    gs = gen.make_genomes(conf, t, SM_SEED)
    a = gs[0]
    for g in gs:
        lower = np.isin(g.letters, np.frombuffer(b"acgt", np.uint8))
        assert np.array_equal(lower, _mask(g.repeats, g.total))
        assert np.array_equal(g.letters == ord("N"), _mask(g.gaps, g.total))
        upper = np.isin(g.letters, np.frombuffer(b"ACGT", np.uint8))
        assert (lower | upper | (g.letters == ord("N"))).all()
    c = gs[2]
    diff = np.nonzero(a.letters != c.letters)[0]
    assert np.array_equal(diff, c.snp_positions)
    assert len(diff) > 0.9 * round(t["snp_rate"] * conf["genome_bp"])
    assert np.array_equal(a.letters[diff] >= ord("a"), c.letters[diff] >= ord("a"))
    # B: the inversion undone gives A with its SNPs
    b = gs[1]
    s, e = b.inversion
    comp = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
    undone = b.letters.copy()
    undone[s:e] = np.frombuffer(b.letters[s:e][::-1].tobytes().translate(comp), np.uint8)
    assert np.array_equal(np.nonzero(undone != a.letters)[0], b.snp_positions)
    assert _digest(gs) == _digest(gen.make_genomes(conf, t, SM_SEED))


def test_sequence_keeps_the_bases_and_snp_draws():
    """Repeats and gaps draw from streams of their own: outside them, the
    genomes are those of the same configuration without ``sequence``."""
    t = _load("traffic", "div13")
    plain = gen.make_genomes(dict(SM, sequence=None), t, SM_SEED)
    sm = gen.make_genomes(SM, t, SM_SEED)
    for p, s in zip(plain, sm):
        keep = ~(_mask(s.repeats, s.total) | _mask(s.gaps, s.total))
        assert keep.mean() > 0.6
        assert np.array_equal(p.letters[keep], s.letters[keep])
        assert p.inversion == s.inversion


def test_duplicate_minimizers_reached():
    """A soft-masked, gapped pair at k = 24, w = 100: the plain
    reference's sketch holds minimizers that occur more than once in an
    assembly (the ones read_minimizers drops), some in lowercase, none
    across N."""
    gs = gen.make_genomes(SM, _load("traffic", "div01"), SM_SEED)
    bloom, bits, _ = reference.cascade(gs, 24, 0.025, "cpu")
    for g in gs:
        ci, pos, h = reference.sketch(g, 24, 100, bloom, bits)
        _, counts = np.unique(h, return_counts=True)
        assert (counts > 1).sum() > 0
        kmers = g.letters[(g.offsets[ci] + pos)[:, None] + np.arange(24)]
        assert (kmers >= ord("a")).any()
        assert not (kmers == ord("N")).any()
