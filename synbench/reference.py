"""Plain reference of what one CLI job computes up to its sketches, in
plain PyTorch (any device) and NumPy, written from the published
definitions and sharing no code with the program:

  - ntHash (ntHash2's split rotate) of every k-mer: forward, reverse and
    canonical hash, and the printed hash indexlr orders minimizers by;
  - the common Bloom filter: one hash, bit = canonical hash mod m, m the
    power of two nearest to ntSynt's ceil(-G / ln(1 - fpr)) for the first
    genome by path (at most 2^34 bits), and the cascade over the genomes
    in path order, which keeps the bits every genome sets;
  - the minimizer sketch (indexlr -k -w --long --seq --pos -s): per
    contig, each window of w k-mers selects its leftmost k-mer of least
    printed hash among the valid k-mers the filter holds, every selected
    k-mer is reported once; a contig with fewer than w k-mers is one
    window.

It works from the letters the generator made (gen.Genome), never from
anything the program made.
"""

import math

import numpy as np
import torch

SEED = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324, 0x295549F54BE24456)
MULTISEED = 0x90B45D39FB6DA1FA
MULTISHIFT = 27
M64 = (1 << 64) - 1
MAX_BITS_LOG2 = 34
CHUNK = 1 << 24  # k-mers hashed at once


def srol(x: int) -> int:
    """ntHash2's split rotate left by one: bits 0-32 and bits 33-63
    rotate on their own."""
    lo, hi = x & ((1 << 33) - 1), x >> 33
    lo = ((lo << 1) | (lo >> 32)) & ((1 << 33) - 1)
    hi = ((hi << 1) | (hi >> 30)) & ((1 << 31) - 1)
    return (hi << 33) | lo


def _signed(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


def tables(k: int):
    """int64 [k, 5] forward and reverse tables: forward position j of
    base b adds srol^(k-1-j)(SEED[b]), reverse adds srol^j(SEED[3-b]);
    column 4 (not ACGT) adds nothing."""
    rot = [list(SEED)]
    for _ in range(k - 1):
        rot.append([srol(x) for x in rot[-1]])
    fwd = [[_signed(rot[k - 1 - j][b]) for b in range(4)] + [0] for j in range(k)]
    rev = [[_signed(rot[j][3 - b]) for b in range(4)] + [0] for j in range(k)]
    return torch.tensor(fwd, dtype=torch.int64), torch.tensor(rev, dtype=torch.int64)


def codes_of(letters: torch.Tensor) -> torch.Tensor:
    """uint8 letters -> int64 codes A0 C1 G2 T3, anything else 4."""
    lut = torch.full((256,), 4, dtype=torch.int64, device=letters.device)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
        lut[c + 32] = i
    return lut[letters.long()]


def hash_kmers(codes: torch.Tensor, k: int, tabs):
    """(canonical, printed, valid) of the len(codes) - k + 1 k-mers of
    codes (int64 codes on one device)."""
    n = codes.shape[0] - k + 1
    fwd, rev = (t.to(codes.device) for t in tabs)
    f = torch.zeros(n, dtype=torch.int64, device=codes.device)
    r = torch.zeros_like(f)
    bad = torch.zeros(n, dtype=torch.bool, device=codes.device)
    for j in range(k):
        c = codes[j:j + n]
        f ^= fwd[j][c]
        r ^= rev[j][c]
        bad |= c == 4
    canon = f + r
    t = canon * _signed((1 ^ (k * MULTISEED)) & M64)
    out = t ^ ((t >> MULTISHIFT) & ((1 << (64 - MULTISHIFT)) - 1))
    return canon, out, ~bad


def filter_bits_log2(first_genome_bp: int, fpr: float) -> int:
    requested = math.ceil(-first_genome_bp / math.log(1.0 - fpr))
    return min(max(int(round(math.log2(max(requested, 1 << 16)))), 16), MAX_BITS_LOG2)


class _Kmers:
    """A genome's k-mers a chunk at a time on device: (start, canonical,
    printed, valid) with k-mers across a contig end invalid."""

    def __init__(self, genome, k: int, device, tabs):
        self.g, self.k, self.device, self.tabs = genome, k, device, tabs
        self.ends = torch.tensor(genome.offsets + genome.contig_lengths, device=device)

    def chunks(self, extra: int = 0):
        """Chunks of CHUNK k-mers, each followed by `extra` more k-mers
        (the next chunk's first ones) where the genome has them."""
        total, k = self.g.total, self.k
        n_all = total - k + 1
        for a in range(0, max(n_all, 0), CHUNK):
            n = min(CHUNK + extra, n_all - a)
            letters = torch.from_numpy(self.g.letters[a:a + n + k - 1]).to(self.device)
            canon, out, valid = hash_kmers(codes_of(letters), k, self.tabs)
            start = torch.arange(a, a + n, device=self.device)
            end_of = self.ends[torch.searchsorted(self.ends, start, right=True)]
            valid &= start + k <= end_of
            yield a, canon, out, valid


def popcount(bits: torch.Tensor, step: int = 1 << 26) -> int:
    """Set entries of a bool tensor, summed a slice at a time (a sum of
    the whole would first widen it to int64)."""
    return sum(int(bits[i:i + step].sum()) for i in range(0, bits.shape[0], step))


def cascade(genomes, k: int, fpr: float, device, bits_log2: int | None = None):
    """The common filter (bool [2^bits_log2] on device) and its
    occupancy after each genome, in path order."""
    tabs = tables(k)
    ordered = sorted(genomes, key=lambda g: g.name)
    if bits_log2 is None:
        bits_log2 = filter_bits_log2(ordered[0].total, fpr)
    mask = (1 << bits_log2) - 1
    acc, occ = None, []
    for g in ordered:
        level = torch.zeros(1 << bits_log2, dtype=torch.bool, device=device)
        for _, canon, _, valid in _Kmers(g, k, device, tabs).chunks():
            level[canon[valid] & mask] = True
        if acc is not None:
            level &= acc
        del acc
        acc = level
        occ.append(popcount(acc) / (1 << bits_log2))
    return acc, bits_log2, occ


def sketch(genome, k: int, w: int, bloom: torch.Tensor, bits_log2: int):
    """(contig index int64, position int64, printed hash uint64) of the
    genome's selected minimizers, by contig then position."""
    device = bloom.device
    tabs = tables(k)
    mask = (1 << bits_log2) - 1
    sign = -(1 << 63)  # x ^ sign orders int64 as the uint64 bits
    none = -1 ^ sign  # the uint64 maximum: no candidate
    starts = torch.tensor(genome.offsets, device=device)
    ends = starts + torch.tensor(genome.contig_lengths, device=device)
    picked, picked_h = [], []
    for a, canon, out, valid in _Kmers(genome, k, device, tabs).chunks(extra=w - 1):
        cand = valid & bloom[canon & mask]
        key = torch.where(cand, out ^ sign, torch.full_like(out, none))
        del canon, valid, cand
        if key.shape[0] >= w:
            minv, arg = key.unfold(0, w, 1).min(dim=1)
            first = torch.arange(a, a + minv.shape[0], device=device)
            ci = torch.searchsorted(ends, first, right=True)
            whole = first + w - 1 + k <= ends[ci]  # all w k-mers in one contig
            live = whole & (minv != none)
            # a contig's argmins never decrease: keep each once
            pos = torch.unique_consecutive((arg + first)[live])
            picked.append(pos)
            picked_h.append(out[pos - a])
    for ci in np.nonzero(genome.contig_lengths - k + 1 < w)[0]:
        lo, n = int(genome.offsets[ci]), int(genome.contig_lengths[ci]) - k + 1
        if n < 1:
            continue
        letters = torch.from_numpy(genome.letters[lo:lo + n + k - 1]).to(device)
        canon, out, valid = hash_kmers(codes_of(letters), k, tabs)
        cand = valid & bloom[canon & mask]
        if bool(cand.any()):
            key = torch.where(cand, out ^ sign, torch.full_like(out, none))
            j = int(torch.argmin(key))  # leftmost least
            picked.append(torch.tensor([lo + j], device=device))
            picked_h.append(out[j:j + 1])
    if not picked:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z.astype(np.uint64)
    pos = torch.cat(picked)
    h = torch.cat(picked_h)
    pos, first = torch.unique(pos, return_inverse=True)
    hh = torch.empty_like(pos)
    hh[first] = h
    pos, hh = pos.cpu().numpy(), hh.cpu().numpy().view(np.uint64)
    ci = np.searchsorted(genome.offsets, pos, side="right") - 1
    return ci.astype(np.int64), pos - genome.offsets[ci], hh


def sketch_tsv(genome, k: int, ci, pos, h) -> bytes:
    """The sketch as indexlr's TSV: one line a contig, in genome order,
    ``name<TAB>hash:pos:seq ...``."""
    gpos = genome.offsets[ci] + pos
    seqs = genome.letters[gpos[:, None] + np.arange(k)].tobytes().decode()
    recs = [f"{hv}:{p}:{seqs[i * k:(i + 1) * k]}"
            for i, (hv, p) in enumerate(zip(h.tolist(), pos.tolist()))]
    bounds = np.searchsorted(ci, np.arange(len(genome.contig_names) + 1))
    lines = [f"{name}\t{' '.join(recs[bounds[c]:bounds[c + 1]])}\n"
             for c, name in enumerate(genome.contig_names)]
    return "".join(lines).encode()
