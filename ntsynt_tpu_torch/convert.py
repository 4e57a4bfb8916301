"""Carry state between the JAX package and this port.

The system has no weights; its state is the Bloom-filter words and the
minimizer sketches. Both packages lay the filter out the same way (bit i
is bit i & 31 of 32-bit word i >> 5), so a filter moves as its words.
"""

import numpy as np
import torch

from . import resolve_device
from .ops.bloom import BloomFilter


def bf_from_numpy(words_u32: np.ndarray, num_bits: int, k: int, device="cuda") -> BloomFilter:
    """A port BloomFilter from a filter's uint32 words (e.g. a JAX
    DeviceBloomFilter's ``np.asarray(bf.words)``)."""
    words = np.ascontiguousarray(words_u32, dtype=np.uint32)
    if words.shape != (num_bits // 32,):
        raise ValueError(f"expected {num_bits // 32} words, got {words.shape}")
    words = torch.from_numpy(words.view(np.int32).copy()).to(resolve_device(device))
    return BloomFilter(num_bits, k, words=words)


def sketch_to_numpy(sk) -> dict:
    """A port GenomeSketch as the keyword fields of the JAX package's
    GenomeSketch (host arrays with its dtypes)."""
    return dict(
        name=sk.name,
        k=sk.k,
        w=sk.w,
        contig_names=list(sk.contig_names),
        contig_idx=np.asarray(sk.contig_idx, dtype=np.int32),
        positions=np.asarray(sk.positions, dtype=np.int64),
        hashes=np.asarray(sk.hashes, dtype=np.uint64),
        canon=np.asarray(sk.canon, dtype=np.uint64),
    )
