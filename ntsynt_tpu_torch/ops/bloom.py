"""Bit-packed one-hash Bloom filters on the device (CUDA kernel K4).

One hash function, like the reference (HASH_FNS=1): the key is the
canonical ntHash value, the bit is ``key mod m`` with m a power of two
(so the modulo is a mask), and the bits are packed little-endian into
32-bit words held in an ``int32`` tensor: bit i is bit (i & 31) of
word i >> 5. The reference sizes m as ceil(-G / ln(1 - fpr))
(src/ntsynt_make_common_bf.cpp:28-40); ``pow2_bits`` rounds that to the
nearest power of two in [2^16, 2^34].

``insert_words`` launches the CUDA kernel (csrc/bf_insert.cu, one
``atomicOr`` per valid key) for CUDA tensors and runs
``insert_words_plain`` for CPU tensors. Probing is a plain gather.
"""

import math

import numpy as np
import torch

from . import _kernels
from .. import resolve_device


def reference_bf_bits(genome_size: int, fpr: float) -> int:
    """Bit count the reference would use: ceil(-G / ln(1-fpr))
    (src/ntsynt_make_common_bf.cpp:28-40, one hash function)."""
    return int(math.ceil(-genome_size / math.log(1.0 - fpr)))


def pow2_bits(requested_bits: int) -> int:
    """Round a bit count to the nearest power of two in [2^16, 2^34]."""
    requested_bits = max(requested_bits, 1 << 16)
    b = int(round(math.log2(requested_bits)))
    b = min(max(b, 16), 34)
    return 1 << b


def bit_index(canon: torch.Tensor, bits_log2: int):
    """(word int64, bit-in-word int64) of bit canon mod 2^bits_log2.

    Equal to ntsynt_tpu/ops/bloom._bit_index in both of its branches: for
    bits_log2 <= 32 it takes canon_lo's low bits, for 33 and 34 it
    prepends canon_hi's low bits_log2 - 32 bits to canon_lo >> 5. Masking
    to at most 34 bits leaves a non-negative int64, so >> is logical here.
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


def insert_words(words, canon, valid, bits_log2: int) -> torch.Tensor:
    """OR the bit of every valid canonical hash into words, in place.

    Args:
      words: int32 [2^bits_log2 / 32] filter words.
      canon: int64 [n] canonical hashes.
      valid: bool [n]; only valid keys are inserted.
    Returns words.
    """
    if words.dtype != torch.int32 or words.shape != ((1 << bits_log2) // 32,):
        raise ValueError("insert_words: words must be int32 [2^bits_log2 / 32]")
    if canon.dtype != torch.int64 or valid.dtype != torch.bool or canon.shape != valid.shape:
        raise ValueError("insert_words: canon int64 [n] and valid bool [n] expected")
    if words.device.type == "cpu":
        return insert_words_plain(words, canon, valid, bits_log2)
    _kernels.require_cuda("insert_words", words, canon, valid)
    if canon.shape[0] == 0:
        return words
    rc = _kernels.lib().ntsynt_bf_insert(
        words.data_ptr(), canon.data_ptr(), valid.data_ptr(), canon.shape[0], bits_log2,
        _kernels.stream_ptr(words.device),
    )
    _kernels.check("bf_insert", rc)
    _kernels.count("bf_insert", canon.shape[0], bits_log2)
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


class BloomFilter:
    """A one-hash bit-packed Bloom filter whose words live on a torch
    device."""

    def __init__(self, num_bits: int, k: int, device="cuda", words=None):
        if num_bits & (num_bits - 1) or not 1 << 16 <= num_bits <= 1 << 34:
            raise ValueError("num_bits must be a power of two in [2^16, 2^34]")
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
