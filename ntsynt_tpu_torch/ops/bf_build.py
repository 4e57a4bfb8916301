"""Whole-genome Bloom filters on the device: the common-k-mer cascade and
the repeat filter.

The reference's common-BF tool (src/ntsynt_make_common_bf.cpp:105-165)
puts every k-mer of the lexicographically first genome into level 1;
each later genome inserts a k-mer into the next level only if the
previous level holds it; the last level approximates the k-mer
intersection of all genomes. For a one-hash filter that equals, bit for
bit: insert the genome's whole k-mer set into a fresh level, then AND it
with the previous level (bit b survives iff some k-mer of this genome
maps to b and the previous level holds b). Each level is K1 (hash) + an
insert over the genome's device-resident stream, taken a group at a time
as its packed upload lands (ops/sketch.PackedUpload), then a dense AND. The
insert is K4 (atomic OR), or K5 (the binned sweep, ops/bf_sweep) when
``NTSYNT_BF_SWEEP`` asks for it and the filter has at most 2^32 bits.

The repeat filter (bin/ntsynt_make_repeat_bfs.py:56-67) keeps the
k-mers of multiplicity >= 2 within any single genome; duplicates are
found inside each segment with a sort, so the segment size is part of
the result (``repeat_segment_update``).
"""

import math

import torch

from . import bf_sweep, bloom, nthash
from .sketch import PackedUpload, _Stream
from .. import resolve_device
from ..utils import StageTimer, log

SEG_KMERS = 1 << 26  # k-mers hashed and inserted per kernel launch
# the repeat walk's segment (duplicates are found within a segment, so
# it is part of the result): the JAX package's make-repeat-bf CLI uses
# 2^23, its pipeline its sketch chunk, 2^20
DEFAULT_CHUNK = 1 << 23
PIPELINE_CHUNK = 1 << 20


def bf_size_bits(genomes, fpr: float, bf_bytes: int | None = None) -> int:
    """Reference sizing from the first (path-sorted) genome's length
    (src/ntsynt_make_common_bf.cpp:109-117), rounded to a power of two
    and capped at 2^34 bits. An explicit bf_bytes escapes the cap, up to
    2^36 bits."""
    if bf_bytes is not None:
        return bloom.pow2_bits(bf_bytes * 8, max_log2=36)
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


def insert_stream(bf, codes, k: int, sweep: bool = False) -> None:
    """Insert every valid k-mer of a device code stream into bf, through
    K5 when sweep is set, else K4, SEG_KMERS k-mers a launch. codes: a
    PackedUpload, whose groups are inserted each as it lands (the JAX
    package's bf_groups walk; with groups of whole segments the launches
    are a whole stream's)."""
    for view in codes.groups():
        n_kmers = max(view.shape[0] - k + 1, 0)
        for s in range(0, n_kmers, SEG_KMERS):
            m = min(SEG_KMERS, n_kmers - s)
            _, canon, valid = nthash.hash_kmers(view[s : s + m + k - 1], k, m)
            if sweep:
                bf_sweep.insert_segment(bf.words, canon, valid, bf.bits_log2)
            else:
                bf.insert(canon, valid)


def build_common_bf_from_device(entries, k: int, num_bits: int, device,
                                release=None, timer=None) -> bloom.BloomFilter:
    """Cascade over [(name, get) ...], already in the reference's
    lexicographic path order: get() returns the genome's code stream on
    the device (as insert_stream takes it: a DeviceStream, whose groups
    are inserted as they land), and is called only when that genome's level
    starts, so a caller reading genomes ahead on another thread overlaps
    genome i+1's read with level i. Any stream layout with at least k-1
    code-4 separators between contigs inserts exactly the genome's k-mer
    set (k-mers over a separator are invalid). release(name), when
    given, is called right after that genome's level is inserted and
    ANDed, once this function holds no reference to its stream: the
    caller may then drop the stream (ntsynt_tpu/ops/bf_build.py, the
    callable form of build_common_bf_from_device). With a StageTimer
    ``timer``, each level is a ``bf.level:<name>`` span, from get()
    through the insert, the AND and the occupancy read, which waits for
    the device, so the span ends when the level is done there."""
    timer = timer or StageTimer()
    log(f"Building common Bloom filter ({num_bits // 8} bytes) over {len(entries)} genomes")
    sweep = bf_sweep.mode() is not None and bf_sweep.supported(num_bits.bit_length() - 1)
    bf = None
    for i, (name, get) in enumerate(entries):
        with timer.stage(f"bf.level:{name}"):
            codes = get()
            level = bloom.BloomFilter(num_bits, k, device=device)
            insert_stream(level, codes, k, sweep=sweep)
            del codes
            if bf is not None:
                level.words &= bf.words
            bf = level
            if release is not None:
                release(name)
            occ = bf.fpr()
        if i == 0:
            log(f"Level-1 BF occupancy/FPR: {occ:.4f}")
        else:
            log(f"Cascade BF occupancy/FPR after {name}: {occ:.4f}")
    return bf


def kmer_stream(genome, k: int, device, hi: int | None = None) -> PackedUpload:
    """The genome's k-mer set as a stream on device: contigs each followed
    by k-1 N codes (k-mers over a separator are invalid), codes [0, hi)
    (N codes past the contigs; all of them by default), sent packed."""
    return PackedUpload(_Stream(genome, k, 1, sep=k - 1), device, hi=hi)


def build_common_bf(genomes, k: int, fpr: float = 0.025, bf_bytes=None, device="cuda"):
    """Cascading common-k-mer Bloom filter over all genomes, in
    lexicographic path order (src/ntsynt_make_common_bf.cpp:105-107)."""
    device = resolve_device(device)
    ordered = sorted(genomes, key=lambda g: g.path)
    num_bits = bf_size_bits(genomes, fpr, bf_bytes)
    entries = [(g.name, lambda g=g: kmer_stream(g, k, device)) for g in ordered]
    return build_common_bf_from_device(entries, k, num_bits, device)


def first_occurrence(canon: torch.Tensor) -> torch.Tensor:
    """bool [n]: entry i is the first (lowest index) of its exact hash in
    the segment. Only equality matters, so a stable sort of the int64
    bit patterns gives the JAX package's (hi, lo, index) sort groups."""
    n = canon.shape[0]
    s, order = torch.sort(canon, stable=True)
    first_sorted = torch.ones(n, dtype=torch.bool, device=canon.device)
    first_sorted[1:] = s[1:] != s[:-1]
    first = torch.empty_like(first_sorted)
    first[order] = first_sorted
    return first


def repeat_segment_update(rep, seen, canon, valid) -> None:
    """One segment of the repeat-filter walk, in place on rep and seen
    (ntsynt_tpu/ops/bf_build.repeat_segment_update): a valid k-mer goes
    into rep iff seen already holds it (an earlier segment, or a bit
    collision: PARITY.md #3) or it is not the first occurrence of its
    exact hash in this segment. "First" is taken over all entries, the
    invalid ones included, with their (unmasked) canonical hashes; seen
    is probed before the segment's own insert."""
    already = seen.probe(canon)
    rep.insert(canon, valid & (already | ~first_occurrence(canon)))
    seen.insert(canon, valid)


def build_repeat_bf(genomes, k: int, fpr: float = 0.01, bf_bytes=None,
                    chunk: int = DEFAULT_CHUNK, device="cuda") -> bloom.BloomFilter:
    """Bloom filter of the k-mers with multiplicity >= 2 within any single
    genome (bin/ntsynt_make_repeat_bfs.py:56-67), walked in segments of
    ``chunk`` k-mers; each genome has its own seen filter."""
    device = resolve_device(device)
    num_bits = bf_size_bits(genomes, fpr, bf_bytes)
    rep = bloom.BloomFilter(num_bits, k, device=device)
    for genome in genomes:
        # the JAX package's segment layout (ntsynt_tpu/ops/bf_build
        # _stream_buffer): every segment [i*chunk, i*chunk + chunk + k - 1)
        # in range, N codes past the genome's k-mers
        n_kmers = max(genome.total_bases + genome.n_contigs * (k - 1) - k + 1, 0)
        if n_kmers == 0:
            continue
        n_segs = -(-n_kmers // chunk)
        codes = kmer_stream(genome, k, device, hi=n_segs * chunk + k - 1).codes
        seen = bloom.BloomFilter(num_bits, k, device=device)
        for i in range(n_segs):
            s = i * chunk
            _, canon, valid = nthash.hash_kmers(codes[s : s + chunk + k - 1], k, chunk)
            repeat_segment_update(rep, seen, canon, valid)
        del codes, seen
    log(f"Repeat BF occupancy/FPR: {rep.fpr():.4f}")
    return rep
