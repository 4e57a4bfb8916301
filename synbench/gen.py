"""Genomes of a cell, made from the seed: the one generator every
traffic mix feeds.

A configuration (configs/<name>.json) fixes how many genomes there are,
how long each is, how its contigs are laid out and, with its optional
``sequence`` object, what kind of sequence genome A holds; a traffic mix
(traffic/<name>.json) fixes how the genomes differ. Genome A is random;
every other genome is a copy of A with ``snp_rate`` of its bases changed
(each to one of the three other bases, at distinct positions, keeping the
letter's case; an N stays N), and the second genome (B) also carries one
inversion (reverse complement) of ``inversion_len_frac`` of the length at
``inversion_at`` of the length. No indels, so a base of any genome sits
at the same global coordinate in A, except inside B's inversion, where it
is reflected.

Each genome is ``contigs`` equal contigs with the same boundaries in
every genome (chromosome-level assemblies of one species).

``sequence`` (leave it out for uniform random bases with no N) makes A
like a soft-masked, gapped assembly as published:

  - ``repeats``: interspersed repeat families, each ``{"name",
    "consensus_bp", "genome_frac", "copy_mean_bp", "copy_div_pct": [lo,
    hi]}``. A family's consensus is random. Its copies are 5'-truncated:
    a copy is the consensus's last ``ceil(consensus_bp * U ** a)`` bases,
    U uniform on (0, 1] and a = consensus_bp / copy_mean_bp - 1, so the
    mean length is ``copy_mean_bp`` (full length when it equals
    ``consensus_bp``); each base of a copy is substituted with the copy's
    own chance, drawn uniformly from ``copy_div_pct`` percent; a copy
    lies on either strand with equal chance, at a uniform random place.
    Copies are written in order, family after family, later ones over
    earlier ones (as nested insertions lie), in numbers such that family
    j ends up holding ``genome_frac`` of the genome's non-N bases
    (_raw_coverage).
  - ``soft_mask``: the repeats' bases in lowercase ``acgt``.
  - ``gaps``: runs of N over the repeats: ``end_bp`` at each contig end
    and interior runs of exponential length (mean ``mean_bp``, rescaled
    so they sum to what is left of ``genome_frac``, the N share in all),
    each inside one contig, at uniform random places.

Repeats and gaps are planted in A, so every genome shares them (reflected
inside B's inversion) and carries them in its truth, ``Genome.repeats``
and ``Genome.gaps``.

Every genome draws from its own stream of the seed (numpy SeedSequence
with the genome's index as spawn key), so a genome does not depend on how
many come before it; each repeat family and the gaps draw from streams of
their own (spawn keys (_REPEAT_STREAM, family index) and (_GAP_STREAM,)),
so genome A's random bases and the SNP and inversion draws are the same
with ``sequence`` as without it. The soft-mask draws nothing.
"""

from dataclasses import dataclass
import math
import os

import numpy as np

LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)
# two random bytes -> two letters at once (a uint16 table of letter pairs)
_PAIR = np.arange(1 << 16, dtype=np.uint32)
_LUT16 = (LETTERS[_PAIR & 3].astype(np.uint16)
          | (LETTERS[(_PAIR >> 8) & 3].astype(np.uint16) << 8))
_COMP = np.arange(256, dtype=np.uint8)
_COMP[list(b"ACGTacgt")] = list(b"TGCAtgca")
_CODE = np.full(256, 255, dtype=np.uint8)  # letter -> A0 C1 G2 T3 in either case; 255 else
_CODE[list(b"ACGT")] = range(4)
_CODE[list(b"acgt")] = range(4)
_CASE = 0x20  # the bit that makes a letter lowercase
_N = ord("N")
_REPEAT_STREAM, _GAP_STREAM = 1 << 16, (1 << 16) + 1  # spawn keys; genomes take 0, 1, ...
FASTA_WIDTH = 80


@dataclass
class Genome:
    """One generated assembly: its bases as ASCII letters, contigs end to
    end, and what was planted in it."""

    name: str  # FASTA file name, the assembly's key in the outputs
    letters: np.ndarray  # uint8 [total] of b"ACGT" (b"acgtN" too with ``sequence``)
    contig_names: list
    contig_lengths: np.ndarray  # int64
    inversion: tuple | None  # (start, end) in global coordinates, or None
    snp_positions: np.ndarray | None  # int64, sorted; None for genome A
    # int64 [n, 3] (start, end, family index): runs of one repeat family's
    # bases, sorted, in this genome's global coordinates; None without
    # ``sequence.repeats``
    repeats: np.ndarray | None = None
    gaps: np.ndarray | None = None  # int64 [n, 2] runs of N, sorted; None without gaps

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.contig_lengths)[:-1]]).astype(np.int64)

    @property
    def total(self) -> int:
        return int(self.contig_lengths.sum())

    @property
    def gap_bp(self) -> int:
        return 0 if self.gaps is None else int((self.gaps[:, 1] - self.gaps[:, 0]).sum())


def _seed_seq(seed: int, *key: int) -> np.random.SeedSequence:
    return np.random.SeedSequence(int(seed) % (1 << 64), spawn_key=key)


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


def _raw_coverage(fracs) -> list:
    """Each family's copies' summed length over the genome's so that,
    with copies at uniform random places and each family written over
    the ones before it, family j holds fracs[j] of the genome. Copies of
    coverage r leave exp(-r) of the bases uncovered (a Boolean model), so
    the last family needs 1 - exp(-r) = f, and each earlier one
    (1 - exp(-r)) exp(-R) = f with R the coverage of the ones after it."""
    out, later = [], 0.0
    for f in reversed(fracs):
        left = f * math.exp(later)
        if left >= 1:
            raise ValueError("sequence.repeats: the families' genome_frac leave no room")
        out.append(-math.log1p(-left))
        later += out[-1]
    return out[::-1]


def _copy_lengths(rng, consensus_bp: int, mean_bp: float, target: int) -> np.ndarray:
    """Copy lengths, drawn until they sum to target or more."""
    a = consensus_bp / mean_bp - 1
    out, have = [], 0
    while have < target:
        n = int((target - have) / mean_bp) + 16
        ln = np.ceil(consensus_bp * (1.0 - rng.random(n)) ** a).astype(np.int64)
        ln = np.clip(ln, 1, consensus_bp)
        cut = int(np.searchsorted(np.cumsum(ln), target - have)) + 1
        out.append(ln[:cut])
        have += int(out[-1].sum())
    return np.concatenate(out)


def _plant_family(a, tag, j: int, fam: dict, coverage: float, soft: bool, seed: int):
    """Family j's copies written over a (letters) and tag (family + 1),
    copy after copy."""
    rng = np.random.default_rng(_seed_seq(seed, _REPEAT_STREAM, j))
    total, cbp = len(a), int(fam["consensus_bp"])
    cons = random_letters(rng, cbp)
    # the consensus, then its reverse complement: a copy of length n is
    # src[cbp - n:cbp] on the plus strand and src[cbp:cbp + n] on the minus
    src = np.concatenate([cons, _COMP[cons[::-1]]])
    if soft:
        src |= _CASE
    ln = np.minimum(_copy_lengths(rng, cbp, float(fam["copy_mean_bp"]),
                                  int(round(coverage * total))), total)
    pos = rng.integers(0, total - ln + 1)
    minus = rng.random(len(ln)) < 0.5
    lo, hi = fam["copy_div_pct"]
    n_sub = rng.binomial(ln, rng.uniform(lo, hi, len(ln)) / 100)
    # the copies end to end in buf, then their substitutions: n_sub[i] at
    # uniform places of copy i (a place drawn twice is substituted once)
    at = np.cumsum(ln) - ln
    buf = np.empty(int(ln.sum()), np.uint8)
    for o, f, n in zip(at.tolist(), np.where(minus, cbp, cbp - ln).tolist(), ln.tolist()):
        buf[o:o + n] = src[f:f + n]
    sub = np.repeat(at, n_sub) + (rng.random(int(n_sub.sum()))
                                  * np.repeat(ln, n_sub)).astype(np.int64)
    old = buf[sub]
    buf[sub] = LETTERS[(_CODE[old] + rng.integers(1, 4, len(sub))) % 4] | (old & _CASE)
    for o, p, n in zip(at.tolist(), pos.tolist(), ln.tolist()):
        a[p:p + n] = buf[o:o + n]
        tag[p:p + n] = j + 1


def _gap_runs(spec: dict, lengths, seed: int) -> np.ndarray:
    """int64 [n, 2]: sorted, disjoint runs of N (gaps)."""
    rng = np.random.default_rng(_seed_seq(seed, _GAP_STREAM))
    total = int(lengths.sum())
    offsets = np.cumsum(lengths) - lengths
    end = np.minimum(int(spec["end_bp"]), lengths // 2)
    ce = offsets + lengths
    runs = [np.stack([offsets, offsets + end], 1), np.stack([ce - end, ce], 1)]
    left = int(round(spec["genome_frac"] * total)) - 2 * int(end.sum())
    n = int(round(left / spec["mean_bp"])) if left > 0 else 0
    if n:
        ln = rng.exponential(spec["mean_bp"], n)
        ln = np.maximum(np.round(ln * left / ln.sum()), 1).astype(np.int64)
        s = rng.integers(0, total, n)
        ci = np.searchsorted(ce, s, side="right")
        s = np.maximum(s, offsets[ci] + end[ci])
        e = np.minimum(s + ln, ce[ci] - end[ci])
        runs.append(np.stack([s, e], 1)[e > s])
    iv = np.concatenate(runs)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    iv = iv[iv[:, 1] > iv[:, 0]]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    return np.stack([iv[new, 0], np.maximum.reduceat(iv[:, 1], np.flatnonzero(new))], 1)


def _runs(tag: np.ndarray) -> np.ndarray:
    """int64 [n, 3] (start, end, tag - 1) of tag's runs of one nonzero value."""
    edge = np.flatnonzero(tag[1:] != tag[:-1]) + 1
    starts = np.concatenate([[0], edge]).astype(np.int64)
    ends = np.concatenate([edge, [len(tag)]]).astype(np.int64)
    fam = tag[starts].astype(np.int64)
    keep = fam > 0
    return np.stack([starts[keep], ends[keep], fam[keep] - 1], 1)


def _plant(a: np.ndarray, sequence: dict, lengths, seed: int):
    """The configuration's ``sequence`` written over genome A's letters
    a: (repeats, gaps), each None where the configuration has none."""
    families = sequence.get("repeats") or []
    repeats = gaps = None
    tag = np.zeros(len(a), np.uint8) if families else None
    cover = _raw_coverage([f["genome_frac"] for f in families])
    for j, (fam, c) in enumerate(zip(families, cover)):
        _plant_family(a, tag, j, fam, c, bool(sequence.get("soft_mask")), seed)
    if sequence.get("gaps"):
        gaps = _gap_runs(sequence["gaps"], lengths, seed)
        for s, e in gaps.tolist():
            a[s:e] = _N
            if tag is not None:
                tag[s:e] = 0
    if tag is not None:
        repeats = _runs(tag)
    return repeats, gaps


def _in_genome(iv, inversion):
    """Intervals of A (start, end first) in the coordinates of a genome
    with this inversion: the parts inside it reflected, sorted."""
    if iv is None or inversion is None:
        return iv
    s, e = inversion
    lo, hi = iv[:, 0], iv[:, 1]
    parts = []
    for x, y, refl in ((lo, np.minimum(hi, s), False), (np.maximum(lo, s), np.minimum(hi, e), True),
                       (np.maximum(lo, e), hi, False)):
        keep = y > x
        p = iv[keep].copy()
        p[:, 0], p[:, 1] = (s + e - y[keep], s + e - x[keep]) if refl else (x[keep], y[keep])
        parts.append(p)
    out = np.concatenate(parts)
    return out[np.argsort(out[:, 0], kind="stable")]


def make_genomes(config: dict, traffic: dict, seed: int):
    """The cell's genomes for seed."""
    total = int(config["genome_bp"])
    a = random_letters(np.random.default_rng(_seed_seq(seed, 0)), total)
    names, lengths = layout(config, total)
    repeats = gaps = None
    if config.get("sequence"):
        repeats, gaps = _plant(a, config["sequence"], lengths, seed)
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
            old = letters[snps]
            code = _CODE[old]
            new = LETTERS[(code + rng.integers(1, 4, len(snps))) % 4] | (old & _CASE)
            base = code != 255  # an N stays N
            letters[snps] = np.where(base, new, old)
            snps = snps[base]
            if gi == 1:
                s = int(total * traffic["inversion_at"])
                e = s + max(int(total * traffic["inversion_len_frac"]), 1000)
                letters[s:e] = _COMP[letters[s:e][::-1]]
                inversion = (s, e)
        out.append(Genome(genome_name(gi), letters, names, lengths, inversion, snps,
                          _in_genome(repeats, inversion), _in_genome(gaps, inversion)))
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
