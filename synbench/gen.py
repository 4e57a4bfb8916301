"""Genomes of a cell, made from the seed: the one generator every
traffic mix feeds.

A configuration (configs/<name>.json) fixes how many genomes there are,
how long each is and how its contigs are laid out; a traffic mix
(traffic/<name>.json) fixes what the sequences hold. Genome A is random;
every other genome is a copy of A with ``snp_rate`` of its bases changed
(each to one of the three other bases, at distinct positions), and the
second genome (B) also carries one inversion (reverse complement) of
``inversion_len_frac`` of the length at ``inversion_at`` of the length.
No indels, so a base of any genome sits at the same global coordinate in
A, except inside B's inversion, where it is reflected.

Each genome is ``contigs`` equal contigs with the same boundaries in
every genome (chromosome-level assemblies of one species).

Every genome draws from its own stream of the seed (numpy SeedSequence
with the genome's index as spawn key), so a genome does not depend on how
many come before it.
"""

from dataclasses import dataclass
import os

import numpy as np

LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)
# two random bytes -> two letters at once (a uint16 table of letter pairs)
_PAIR = np.arange(1 << 16, dtype=np.uint32)
_LUT16 = (LETTERS[_PAIR & 3].astype(np.uint16)
          | (LETTERS[(_PAIR >> 8) & 3].astype(np.uint16) << 8))
_COMP = np.arange(256, dtype=np.uint8)
_COMP[list(b"ACGT")] = list(b"TGCA")
FASTA_WIDTH = 80


@dataclass
class Genome:
    """One generated assembly: its bases as ASCII letters, contigs end to
    end, and what was planted in it."""

    name: str  # FASTA file name, the assembly's key in the outputs
    letters: np.ndarray  # uint8 [total] of b"ACGT"
    contig_names: list
    contig_lengths: np.ndarray  # int64
    inversion: tuple | None  # (start, end) in global coordinates, or None
    snp_positions: np.ndarray | None  # int64, sorted; None for genome A

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.contig_lengths)[:-1]]).astype(np.int64)

    @property
    def total(self) -> int:
        return int(self.contig_lengths.sum())


def _seed_seq(seed: int, key: int) -> np.random.SeedSequence:
    return np.random.SeedSequence(int(seed) % (1 << 64), spawn_key=(key,))


def random_letters(rng: np.random.Generator, n: int) -> np.ndarray:
    """n uniform random letters of ACGT."""
    raw = rng.bit_generator.random_raw(-(-n // 8)).view(np.uint16)
    return _LUT16[raw].view(np.uint8)[:n].copy()


def _distinct(x: np.ndarray) -> np.ndarray:
    """Sorted distinct values of x (a sort and a compare)."""
    x = np.sort(x)
    keep = np.ones(len(x), dtype=bool)
    np.not_equal(x[1:], x[:-1], out=keep[1:])
    return x[keep]


def layout(config: dict, total: int):
    """(contig names, lengths) of every genome."""
    n = config["contigs"]
    lengths = np.full(n, total // n, dtype=np.int64)
    lengths[-1] += total - lengths.sum()
    return [f"chr{i + 1}" for i in range(n)], lengths


def genome_name(gi: int) -> str:
    return f"g{gi:02d}.fa"


def make_genomes(config: dict, traffic: dict, seed: int):
    """The cell's genomes for seed."""
    total = int(config["genome_bp"])
    a = random_letters(np.random.default_rng(_seed_seq(seed, 0)), total)
    names, lengths = layout(config, total)
    out = []
    for gi in range(config["genomes"]):
        inversion, snps = None, None
        if gi == 0:
            letters = a
        else:
            rng = np.random.default_rng(_seed_seq(seed, gi))
            letters = a.copy()
            n_snp = int(round(traffic["snp_rate"] * total))
            snps = _distinct(rng.integers(0, total, n_snp))
            while len(snps) < n_snp:
                snps = _distinct(np.concatenate([snps, rng.integers(0, total, n_snp - len(snps))]))
            codes = np.searchsorted(LETTERS, letters[snps])  # A<C<G<T
            letters[snps] = LETTERS[(codes + rng.integers(1, 4, len(snps))) % 4]
            if gi == 1:
                s = int(total * traffic["inversion_at"])
                e = s + max(int(total * traffic["inversion_len_frac"]), 1000)
                letters[s:e] = _COMP[letters[s:e][::-1]]
                inversion = (s, e)
        out.append(Genome(genome_name(gi), letters, names, lengths, inversion, snps))
    return out


def fasta_bytes(genome: Genome, width: int = FASTA_WIDTH) -> int:
    n = genome.contig_lengths
    return int(sum(len(f">{c}\n") for c in genome.contig_names) + n.sum() + (-(-n // width)).sum())


def write_fasta(genome: Genome, path: str, width: int = FASTA_WIDTH) -> str:
    """Write the genome as FASTA (lines of width bases) from one buffer
    laid out whole, in one write."""
    buf = np.empty(fasta_bytes(genome, width), dtype=np.uint8)
    at = 0
    for name, off, ln in zip(genome.contig_names, genome.offsets, genome.contig_lengths):
        head = np.frombuffer(f">{name}\n".encode(), dtype=np.uint8)
        buf[at:at + len(head)] = head
        at += len(head)
        seq = genome.letters[off:off + ln]
        full = int(ln) // width
        rows = buf[at:at + full * (width + 1)].reshape(full, width + 1)
        rows[:, :width] = seq[:full * width].reshape(full, width)
        rows[:, width] = ord("\n")
        at += full * (width + 1)
        tail = int(ln) - full * width
        if tail:
            buf[at:at + tail] = seq[full * width:]
            buf[at + tail] = ord("\n")
            at += tail + 1
    assert at == len(buf)
    with open(path, "wb") as fout:
        fout.write(memoryview(buf))
    return path


def write_all(genomes, directory: str) -> list:
    os.makedirs(directory, exist_ok=True)
    return [write_fasta(g, os.path.join(directory, g.name)) for g in genomes]


def to_a(genome: Genome, start, end):
    """Genome's half-open intervals [start, end) of global coordinates in
    genome A's coordinates: (start, end, reflected). An interval whose
    middle lies inside the inversion is reflected whole, so a block that
    the inversion's edge bases extend by chance (its first bases
    complementing the bases past its other end) still maps onto itself."""
    start, end = np.asarray(start, np.int64), np.asarray(end, np.int64)
    if genome.inversion is None:
        return start, end, np.zeros(len(start), dtype=bool)
    s, e = genome.inversion
    mid2 = start + end  # twice the middle
    inside = (mid2 >= 2 * s) & (mid2 < 2 * e)
    return np.where(inside, s + e - end, start), np.where(inside, s + e - start, end), inside
