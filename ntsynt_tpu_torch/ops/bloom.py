"""Bit-packed one-hash Bloom filters on the device (CUDA kernel K4).

One hash function, like the reference (HASH_FNS=1): the key is the
canonical ntHash value, the bit is ``key mod m`` with m a power of two
(so the modulo is a mask), and the bits are packed little-endian into
32-bit words held in an ``int32`` tensor: bit i is bit (i & 31) of
word i >> 5. The reference sizes m as ceil(-G / ln(1 - fpr))
(src/ntsynt_make_common_bf.cpp:28-40); ``pow2_bits`` rounds that to the
nearest power of two in [2^16, 2^34], or up to 2^36 for an explicit size.

``insert_words`` launches the CUDA kernel (csrc/bf_insert.cu: the keys
binned by filter region, then each region ORed in shared memory; a
sparse segment takes one global ``atomicOr`` per key) for CUDA tensors
and runs ``insert_words_plain`` for CPU tensors. Probing is a plain
gather.

Filters are saved in the JAX package's containers (``ntsynt_tpu_bf1``
native, or btllib's KmerBloomFilter v6), so files cross-load between the
packages; ``load_bf`` sniffs the container. A btllib filter whose size
is not a power of two loads as a ``HostModBloomFilter``, probed on the
host with an exact ``h % num_bits``.
"""

import json
import math

import numpy as np
import torch

from . import _kernels
from .. import resolve_device


def reference_bf_bits(genome_size: int, fpr: float) -> int:
    """Bit count the reference would use: ceil(-G / ln(1-fpr))
    (src/ntsynt_make_common_bf.cpp:28-40, one hash function)."""
    return int(math.ceil(-genome_size / math.log(1.0 - fpr)))


def pow2_bits(requested_bits: int, max_log2: int = 34) -> int:
    """Round a bit count to the nearest power of two in [2^16, 2^max_log2].
    The default cap of 2^34 bits (2 GiB of words) is the JAX package's;
    an explicit size (``--bf``) may go up to 2^36."""
    requested_bits = max(requested_bits, 1 << 16)
    b = int(round(math.log2(requested_bits)))
    b = min(max(b, 16), max_log2)
    return 1 << b


def bit_index(canon: torch.Tensor, bits_log2: int):
    """(word int64, bit-in-word int64) of bit canon mod 2^bits_log2.

    Equal to ntsynt_tpu/ops/bloom._bit_index in both of its branches: for
    bits_log2 <= 32 it takes canon_lo's low bits, for 33..36 it prepends
    canon_hi's low bits_log2 - 32 bits to canon_lo >> 5. Masking to at
    most 36 bits leaves a non-negative int64, so >> is logical here.
    """
    bit = canon & ((1 << bits_log2) - 1)
    return bit >> 5, canon & 31


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def insert_words_plain(words, canon, valid, bits_log2: int) -> torch.Tensor:
    """Plain PyTorch K4, in place: ORs the bit of every valid key into
    words. Distinct bits of one word sum to their OR, so the unique bit
    indices are summed per word."""
    bits = torch.unique(canon[valid] & ((1 << bits_log2) - 1))
    acc = torch.zeros(words.shape[0], dtype=torch.int64, device=words.device)
    acc.index_add_(0, bits >> 5, torch.ones_like(bits) << (bits & 31))
    words |= _as_int32_bits(acc)
    return words


# K4's geometry (csrc/bf_insert.cu): a cell is one block's shared
# memory, 2^15 words (2^20 bits, 128 KiB); the keys are partitioned by
# cell in one pass of at most 2^8 digits, or two, in tiles of
# PART_TILE keys. A segment, or a cell, with fewer keys than one per
# DIRECT_WORDS_PER_KEY words takes global atomics instead of the
# shared-memory sweep (the same constants as in the source).
CELL_LOG2 = 15
MAX_DIGITS_LOG2 = 8
DIRECT_WORDS_PER_KEY = 16
PART_TILE = 4096


def insert_geometry(bits_log2: int, cell_log2: int = CELL_LOG2):
    """(cell_log2, digits_a, digits_b) of the binning: 2^cell_log2 words
    per cell (K4's by default, K5 passes its own; a filter under one cell
    is one cell), and the cell index split into the first partition
    pass's top digits_a bits and the second's low digits_b bits
    (digits_b == 0: one pass)."""
    words_log2 = bits_log2 - 5
    cell_log2 = min(cell_log2, words_log2)
    cells_log2 = words_log2 - cell_log2
    digits_b = 0 if cells_log2 <= MAX_DIGITS_LOG2 else cells_log2 // 2
    return cell_log2, cells_log2 - digits_b, digits_b


def insert_route(n: int, bits_log2: int) -> str:
    """"binned" (count, partition, shared-memory apply) or "direct" (one
    global atomicOr per key) for a segment of n keys, invalid ones
    included: direct below one key per DIRECT_WORDS_PER_KEY filter words,
    where sweeping the filter costs more than the atomics, and for
    segments of 2^31 keys or more (32-bit offsets)."""
    n_words = 1 << (bits_log2 - 5)
    if n * DIRECT_WORDS_PER_KEY < n_words or n >= 1 << 31:
        return "direct"
    return "binned"


def _check_insert(words, canon, valid, bits_log2: int) -> None:
    if not 5 <= bits_log2 <= 36:
        raise ValueError("insert_words: bits_log2 must be in 5..36")
    if words.dtype != torch.int32 or words.shape != ((1 << bits_log2) // 32,):
        raise ValueError("insert_words: words must be int32 [2^bits_log2 / 32]")
    if canon.dtype != torch.int64 or valid.dtype != torch.bool or canon.shape != valid.shape:
        raise ValueError("insert_words: canon int64 [n] and valid bool [n] expected")


def insert_direct(words, canon, valid, bits_log2: int) -> None:
    """K4's direct route on CUDA tensors: one global atomicOr per valid
    key. Not counted as a launch."""
    _kernels.require_cuda("insert_direct", words, canon, valid)
    rc = _kernels.lib().ntsynt_bf_insert(
        words.data_ptr(), canon.data_ptr(), valid.data_ptr(), canon.shape[0], bits_log2,
        _kernels.stream_ptr(words.device),
    )
    _kernels.check("bf_insert", rc)


def bin_scan_plain(counts: torch.Tensor, digits_b: int, n_plan: int, chunk: int = 0):
    """Plain form of the binning's scan (csrc/bf_insert.cu:bin_scan_kernel)
    from the cells' counts (int32 [n_cells]): (offsets int32 [n_cells +
    1], cursor_a int32 [n_cells >> digits_b], cursor_b int32 [n_cells] or
    None, plan int32 [n_plan, 4] or None, first int32 [n_cells + 1] or
    None). offsets are the cells' exclusive prefix and the total;
    cursor_a and cursor_b the partition passes' cursors (each range's,
    each cell's first key). For a second pass (digits_b > 0) the ranges
    of 2^digits_b cells get one block per `share` keys, share being the
    total over parts = n_plan - n_ranges rounded up to a tile, block i
    working keys plan[i, 1] .. plan[i, 2] of range plan[i, 0] (zeros past
    the last). For chunk > 0, cell c's slices of at most chunk keys are
    first[c] .. first[c + 1]."""
    counts = counts.long()
    n_cells = counts.shape[0]
    offsets = torch.zeros(n_cells + 1, dtype=torch.int64)
    offsets[1:] = torch.cumsum(counts, 0)
    cursor_a = offsets[:-1:1 << digits_b].int()
    cursor_b = plan = first = None
    if digits_b:
        cursor_b = offsets[:-1].int()
        bounds = offsets[:: 1 << digits_b]
        total = int(bounds[-1])
        parts = n_plan - (bounds.shape[0] - 1)
        share = (-(-total // parts) + PART_TILE - 1) // PART_TILE * PART_TILE
        plan = torch.zeros((n_plan, 4), dtype=torch.int32)
        i = 0
        for r in range(bounds.shape[0] - 1):
            for start in range(int(bounds[r]), int(bounds[r + 1]), max(share, 1)):
                plan[i] = torch.tensor([r, start, min(int(bounds[r + 1]), start + share), 0])
                i += 1
    if chunk:
        first = torch.zeros(n_cells + 1, dtype=torch.int64)
        first[1:] = torch.cumsum(torch.div(counts + (chunk - 1), chunk, rounding_mode="floor"), 0)
        first = first.int()
    return offsets.int(), cursor_a, cursor_b, plan, first


def bin_scan(counts: torch.Tensor, digits_b: int, chunk: int = 0):
    """bin_scan_plain's outputs from CUDA counts, by one one-block launch
    on the stream (no host sync), with the second pass's plan as long as
    the card's grid for it (csrc/bf_insert.cu:ntsynt_bf_plan_size). Not
    counted as a launch."""
    _kernels.require_cuda("bin_scan", counts)
    dev = counts.device
    n_cells = counts.shape[0]
    n_ranges = n_cells >> digits_b
    lib = _kernels.lib()
    n_plan = lib.ntsynt_bf_plan_size(n_ranges) if digits_b else 0

    def buf(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    offsets, cursor_a = buf(n_cells + 1), buf(n_ranges)
    cursor_b = buf(n_cells) if digits_b else None
    plan = buf(n_plan, 4) if digits_b else None
    first = buf(n_cells + 1) if chunk else None
    rc = lib.ntsynt_bf_bin_scan(
        counts.data_ptr(), n_cells, digits_b, chunk, offsets.data_ptr(), cursor_a.data_ptr(),
        None if cursor_b is None else cursor_b.data_ptr(),
        None if plan is None else plan.data_ptr(), n_plan,
        None if first is None else first.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.check("bf_bin_scan", rc)
    return offsets, cursor_a, cursor_b, plan, first


def bin_keys(canon, valid, bits_log2: int, cell_log2: int = CELL_LOG2, chunk: int = 0):
    """Steps 1-2 of the binned route on CUDA tensors (canon 16-byte and
    valid 2-byte aligned, 0 < n < 2^31), at 2^cell_log2-word cells (K4's
    by default; K5 bins at its own): the count, the scan and the
    partition passes. Returns (binned int32 [n], offsets int32 [n_cells +
    1], first): cell c's keys' bits within the cell are
    binned[offsets[c] .. offsets[c + 1]), and for chunk > 0 its slices of
    at most chunk keys are first[c] .. first[c + 1] (else first is None).
    Not counted as a launch."""
    dev = canon.device
    n = canon.shape[0]
    cell_log2, digits_a, digits_b = insert_geometry(bits_log2, cell_log2)
    lib = _kernels.lib()
    stream = _kernels.stream_ptr(dev)
    counts = torch.zeros(1 << (digits_a + digits_b), dtype=torch.int32, device=dev)
    rc = lib.ntsynt_bf_cell_count(canon.data_ptr(), valid.data_ptr(), n, bits_log2, cell_log2,
                                  counts.data_ptr(), stream)
    _kernels.check("bf_cell_count", rc)
    offsets, cursor_a, cursor_b, plan, first = bin_scan(counts, digits_b, chunk)
    # the first pass: by the cell's top digits_a bits, at its range's start
    binned = torch.empty(n, dtype=torch.int32, device=dev)
    rc = lib.ntsynt_bf_partition_keys(canon.data_ptr(), valid.data_ptr(), n, bits_log2,
                                      digits_a, bits_log2 - digits_a, cursor_a.data_ptr(),
                                      binned.data_ptr(), stream)
    _kernels.check("bf_partition_keys", rc)
    if digits_b == 0:
        return binned, offsets, first
    # the second: within each range, by the low digits_b bits, as planned
    src, binned = binned, torch.empty(n, dtype=torch.int32, device=dev)
    rc = lib.ntsynt_bf_partition_bins(src.data_ptr(), plan.data_ptr(), plan.shape[0], digits_b,
                                      cell_log2 + 5, cursor_b.data_ptr(), binned.data_ptr(),
                                      stream)
    _kernels.check("bf_partition_bins", rc)
    return binned, offsets, first


def apply_bins(words, binned, offsets, bits_log2: int) -> None:
    """Step 3 of K4's binned route on CUDA tensors: one block per cell ORs
    its keys into words (16-byte aligned). Not counted as a launch."""
    rc = _kernels.lib().ntsynt_bf_apply(
        words.data_ptr(), binned.data_ptr(), offsets.data_ptr(), bits_log2,
        insert_geometry(bits_log2)[0], _kernels.stream_ptr(words.device),
    )
    _kernels.check("bf_apply", rc)


def insert_binned(words, canon, valid, bits_log2: int) -> None:
    """K4's binned route on CUDA tensors (words 16-byte aligned, 0 < n <
    2^31), whatever the segment's density. Not counted as a launch."""
    _kernels.require_cuda("insert_binned", words, canon, valid)
    if words.data_ptr() % 16:
        raise ValueError("insert_binned: words must be 16-byte aligned")
    if canon.data_ptr() % 16 or valid.data_ptr() % 2:
        canon, valid = canon.clone(), valid.clone()  # fresh blocks are aligned
    binned, offsets, _ = bin_keys(canon, valid, bits_log2)
    apply_bins(words, binned, offsets, bits_log2)


def insert_words(words, canon, valid, bits_log2: int) -> torch.Tensor:
    """OR the bit of every valid canonical hash into words, in place.

    Args:
      words: int32 [2^bits_log2 / 32] filter words.
      canon: int64 [n] canonical hashes.
      valid: bool [n]; only valid keys are inserted.
    Returns words.
    """
    _check_insert(words, canon, valid, bits_log2)
    if words.device.type == "cpu":
        return insert_words_plain(words, canon, valid, bits_log2)
    _kernels.require_cuda("insert_words", words, canon, valid)
    n = canon.shape[0]
    if n == 0:
        return words
    if insert_route(n, bits_log2) == "direct":
        insert_direct(words, canon, valid, bits_log2)
    else:
        insert_binned(words, canon, valid, bits_log2)
    _kernels.count("bf_insert", n, bits_log2)
    return words


def bf_probe(words: torch.Tensor, canon: torch.Tensor, bits_log2: int) -> torch.Tensor:
    """Membership test of canonical hashes: a gather of one bit each."""
    word, bit = bit_index(canon, bits_log2)
    return ((words[word].long() >> bit) & 1) != 0


def popcount_words(words: torch.Tensor) -> int:
    """Set bits of an int32 word tensor (SWAR per word, summed per chunk
    so the temporaries stay small)."""
    total = 0
    chunk = 1 << 26
    for s in range(0, words.shape[0], chunk):
        x = words[s : s + chunk].long() & 0xFFFFFFFF
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        x = (x * 0x01010101) & 0xFFFFFFFF
        total += int((x >> 24).sum())
    return total


NATIVE_MAGIC = "ntsynt_tpu_bf1"


class BloomFilter:
    """A one-hash bit-packed Bloom filter whose words live on a torch
    device."""

    def __init__(self, num_bits: int, k: int, device="cuda", words=None):
        if num_bits & (num_bits - 1) or not 1 << 16 <= num_bits <= 1 << 36:
            raise ValueError("num_bits must be a power of two in [2^16, 2^36]")
        self.num_bits = num_bits
        self.k = k
        self.n_words = num_bits // 32
        if words is None:
            words = torch.zeros(self.n_words, dtype=torch.int32, device=resolve_device(device))
        elif words.dtype != torch.int32 or words.shape != (self.n_words,):
            raise ValueError("words must be int32 [num_bits / 32]")
        self.words = words

    @property
    def bits_log2(self) -> int:
        return self.num_bits.bit_length() - 1

    @property
    def device(self):
        return self.words.device

    def insert(self, canon: torch.Tensor, valid: torch.Tensor) -> None:
        insert_words(self.words, canon, valid, self.bits_log2)

    def probe(self, canon: torch.Tensor) -> torch.Tensor:
        return bf_probe(self.words, canon, self.bits_log2)

    def probe_np(self, canon: np.ndarray) -> np.ndarray:
        """Probe uint64 canonical hashes held on the host."""
        c = torch.from_numpy(np.ascontiguousarray(canon, dtype=np.uint64).view(np.int64))
        return self.probe(c.to(self.device)).cpu().numpy()

    def popcount(self) -> int:
        return popcount_words(self.words)

    def fpr(self) -> float:
        """Occupancy = FPR for a one-hash filter."""
        return self.popcount() / self.num_bits

    def words_u32(self) -> np.ndarray:
        """The words as a host uint32 array."""
        return self.words.cpu().numpy().view(np.uint32)

    def save(self, path: str, fmt: str = "native") -> str:
        """Save the filter: fmt="native" writes the JAX package's
        container (8-byte header length, a JSON header, then the words as
        little-endian uint32); fmt="btllib" writes btllib's
        KmerBloomFilter v6 container, which is lossless for power-of-two
        filters (h % 2^n == h & (2^n - 1))."""
        if fmt == "btllib":
            from ..io.btllib_bf import write_btllib_bf

            return write_btllib_bf(path, self.words_u32(), self.num_bits, self.k)
        if fmt != "native":
            raise ValueError(f"unknown Bloom filter format {fmt!r}: use 'native' or 'btllib'")
        header = dict(magic=NATIVE_MAGIC, num_bits=self.num_bits, k=self.k, hash_fns=1)
        with open(path, "wb") as fout:
            hdr = json.dumps(header).encode() + b"\n"
            fout.write(len(hdr).to_bytes(8, "little"))
            fout.write(hdr)
            fout.write(self.words_u32().astype("<u4").tobytes())
        return path

    @classmethod
    def load(cls, path: str, device="cuda") -> "BloomFilter":
        """Load a native or a power-of-two btllib .bf onto device."""
        bf = load_bf(path, device=device)
        if not isinstance(bf, cls):
            raise ValueError(
                f"{path}: non-pow2 btllib filter ({bf.num_bits} bits): use "
                "bloom.load_bf, which returns a HostModBloomFilter for it"
            )
        return bf

    @classmethod
    def _load_native(cls, path: str, device="cuda") -> "BloomFilter":
        with open(path, "rb") as fin:
            hlen = int.from_bytes(fin.read(8), "little")
            header = json.loads(fin.read(hlen).decode())
            if header.get("magic") != NATIVE_MAGIC:
                raise ValueError(f"{path}: not an ntsynt_tpu Bloom filter")
            words = np.frombuffer(fin.read(), dtype="<u4")
        return cls.from_u32(words, header["num_bits"], header["k"], device=device)

    @classmethod
    def from_u32(cls, words_u32: np.ndarray, num_bits: int, k: int, device="cuda"):
        """A filter from its uint32 words held on the host."""
        words = np.ascontiguousarray(words_u32, dtype=np.uint32)
        if words.shape != (num_bits // 32,):
            raise ValueError(f"expected {num_bits // 32} words, got {words.shape}")
        t = torch.from_numpy(words.view(np.int32).copy()).to(resolve_device(device))
        return cls(num_bits, k, words=t)


def load_bf(path: str, device="cuda"):
    """Load a .bf of either package or of btllib, sniffing the container:
    btllib KmerBloomFilter v6 -> BloomFilter when its size is a power of
    two, else HostModBloomFilter; the native container -> BloomFilter."""
    from ..io import btllib_bf

    if btllib_bf.sniff_btllib(path):
        return btllib_bf.load_btllib_bf(path, device=device)
    return BloomFilter._load_native(path, device=device)


class HostModBloomFilter:
    """Exact ``h % num_bits`` Bloom filter for any bit count: the shape of
    reference-built btllib filters (src/ntsynt_make_common_bf.cpp sizes
    by -genome/ln(1-fpr)). The device's mask-modulo needs a power of two,
    so these are probed on the host (NumPy uint64 modulo is exact); the
    sketch probes each segment's canonical hashes through ``probe``."""

    def __init__(self, num_bits: int, k: int, bits: np.ndarray):
        self.num_bits = int(num_bits)
        self.k = k
        self.bits = bits  # packed uint8, btllib layout (bit i -> byte i//8, 1<<(i%8))

    @classmethod
    def from_bytes(cls, data: bytes, num_bits: int, k: int) -> "HostModBloomFilter":
        return cls(num_bits, k, np.frombuffer(data, dtype=np.uint8).copy())

    @property
    def bits_log2(self):
        raise ValueError(
            "HostModBloomFilter is not pow2-sized; device mask-modulo "
            "probing does not apply (probe on host via probe_np)"
        )

    def probe_np(self, canon: np.ndarray) -> np.ndarray:
        canon = np.asarray(canon, dtype=np.uint64)
        idx = canon % np.uint64(self.num_bits)
        byte = (idx >> np.uint64(3)).astype(np.int64)
        return (self.bits[byte] >> (idx & np.uint64(7)).astype(np.uint8)) & 1 != 0

    def probe(self, canon: torch.Tensor) -> torch.Tensor:
        """Probe int64 canonical hashes (any device) on the host; the
        verdicts come back on canon's device."""
        hit = self.probe_np(canon.cpu().numpy().view(np.uint64))
        return torch.from_numpy(hit).to(canon.device)

    def save(self, path: str, fmt: str = "btllib") -> str:
        """btllib is the only container that keeps a non-pow2 modulus."""
        from ..io.btllib_bf import write_btllib_bf_bytes

        if fmt != "btllib":
            raise ValueError("HostModBloomFilter only serializes as btllib")
        if self.num_bits % 8 != 0:
            raise ValueError(
                f"num_bits {self.num_bits} not a byte multiple: btllib "
                "probes h % (bytes*8), which would change membership"
            )
        return write_btllib_bf_bytes(path, self.bits[: self.num_bits // 8].tobytes(), self.k)
