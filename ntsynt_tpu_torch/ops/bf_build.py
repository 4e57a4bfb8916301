"""Cascading common-k-mer Bloom filter on the device.

The reference's builder (src/ntsynt_make_common_bf.cpp:105-165) puts
every k-mer of the lexicographically first genome into level 1; each
later genome inserts a k-mer into the next level only if the previous
level holds it; the last level approximates the k-mer intersection of
all genomes. For a one-hash filter that equals, bit for bit: insert the
genome's whole k-mer set into a fresh level, then AND it with the
previous level (bit b survives iff some k-mer of this genome maps to b
and the previous level holds b). Each level is K1 (hash) + K4 (atomic
OR insert) over the genome's device-resident stream, then a dense AND.
"""

import math

import numpy as np
import torch

from . import bloom, nthash
from .. import resolve_device
from ..utils import log

SEG_KMERS = 1 << 26  # k-mers hashed and inserted per kernel launch


def bf_size_bits(genomes, fpr: float) -> int:
    """Reference sizing from the first (path-sorted) genome's length
    (src/ntsynt_make_common_bf.cpp:109-117), rounded to a power of two
    and capped at 2^34 bits."""
    first = sorted(genomes, key=lambda g: g.path)[0]
    requested = bloom.reference_bf_bits(first.total_bases, fpr)
    bits = bloom.pow2_bits(requested)
    if bits < requested / 1.5:  # the cap engaged, not mere pow2 rounding
        eff = 1.0 - math.exp(-first.total_bases / bits)
        log(
            f"Bloom filter capped at {bits // 8} bytes; "
            f"effective FPR ~{eff:.3f} (requested {fpr})"
        )
    return bits


def insert_stream(bf, codes: torch.Tensor, k: int) -> None:
    """Insert every valid k-mer of a device code stream into bf."""
    n_kmers = max(codes.shape[0] - k + 1, 0)
    for s in range(0, n_kmers, SEG_KMERS):
        m = min(SEG_KMERS, n_kmers - s)
        _, canon, valid = nthash.hash_kmers(codes[s : s + m + k - 1], k, m)
        bf.insert(canon, valid)


def build_common_bf_from_device(entries, k: int, num_bits: int, device) -> bloom.BloomFilter:
    """Cascade over [(name, codes uint8 tensor on device) ...], already in
    the reference's lexicographic path order. Any stream layout with at
    least k-1 code-4 separators between contigs inserts exactly the
    genome's k-mer set (k-mers over a separator are invalid)."""
    log(f"Building common Bloom filter ({num_bits // 8} bytes) over {len(entries)} genomes")
    bf = None
    for i, (name, codes) in enumerate(entries):
        level = bloom.BloomFilter(num_bits, k, device=device)
        insert_stream(level, codes, k)
        if bf is not None:
            level.words &= bf.words
        bf = level
        occ = bf.fpr()
        if i == 0:
            log(f"Level-1 BF occupancy/FPR: {occ:.4f}")
        else:
            log(f"Cascade BF occupancy/FPR after {name}: {occ:.4f}")
    return bf


def stream_buffer(genome, k: int, codes: np.ndarray | None = None) -> np.ndarray:
    """Contigs joined by k-1 N codes: the genome's k-mer set as a stream."""
    src = genome.codes if codes is None else codes
    sep = np.full(k - 1, 4, dtype=np.uint8)
    parts = []
    for i in range(genome.n_contigs):
        o, ln = int(genome.offsets[i]), int(genome.lengths[i])
        parts += [src[o : o + ln], sep]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def build_common_bf(genomes, k: int, fpr: float = 0.025, device="cuda"):
    """Cascading common-k-mer Bloom filter over all genomes, in
    lexicographic path order (src/ntsynt_make_common_bf.cpp:105-107)."""
    device = resolve_device(device)
    ordered = sorted(genomes, key=lambda g: g.path)
    num_bits = bf_size_bits(genomes, fpr)
    entries = [
        (g.name, torch.from_numpy(stream_buffer(g, k)).to(device)) for g in ordered
    ]
    return build_common_bf_from_device(entries, k, num_bits, device)
