"""Binned Bloom-filter sweep (CUDA kernel K5).

One segment's insert into a one-hash filter, and the cascade's fused
probe + insert (src/ntsynt_make_common_bf.cpp:140-160: a k-mer goes into
the next level only if the previous level holds it), for filters of at
most 2^32 bits, whose bit index fits 32 bits.

The keys are binned by filter cell (``CELL_LOG2`` words) with K4's
binning (``bloom.bin_keys``: count, one-block scan, partition passes, no
global atomic per key), and one CUDA block per cell ORs its keys in
shared memory (csrc/bf_sweep.cu). A cell with more keys than a block's
fair share of the segment is split over several blocks, its slices
numbered by the binning's scan on the card (``split_chunk`` sizes them).
The JAX package's sort, dedupe and one-hot MXU formulation
(ntsynt_tpu/ops/bf_sweep.py) and its overflow fallback to the scatter
path have no counterpart: the CUDA kernel has no per-cell capacity.

Off unless ``NTSYNT_BF_SWEEP`` is set, read as the JAX package reads it
(``mode``), so one environment drives both packages.
"""

import ctypes
import functools
import os

import torch

from . import _kernels, bloom
from .bloom import _as_int32_bits

CELL_LOG2 = 14  # words per cell: 64 KiB, so prev's and new's cells fit one block


def supported(bits_log2: int) -> bool:
    """The binned sweep covers filters whose bit index fits in u32."""
    return bits_log2 <= 32


def mode() -> str | None:
    """None (off, the default), "tpu" (NTSYNT_BF_SWEEP=tpu or 1) or
    "interpret" (NTSYNT_BF_SWEEP=interpret); NTSYNT_NO_PALLAS turns it
    off. Either value turns the sweep on here: a CUDA tensor launches
    the kernel, a CPU tensor runs the plain version."""
    if os.environ.get("NTSYNT_NO_PALLAS"):
        return None
    env = os.environ.get("NTSYNT_BF_SWEEP")
    if env == "interpret":
        return "interpret"
    if env in ("tpu", "1"):
        return "tpu"
    return None


def geometry(bits_log2: int):
    """(n_words, cell_log2, n_cells): filters under one cell are one cell
    of n_words words."""
    n_words = (1 << bits_log2) // 32
    cell_log2 = min(CELL_LOG2, bits_log2 - 5)
    return n_words, cell_log2, n_words >> cell_log2


def split_chunk(n: int, cell_words: int, units: int) -> int:
    """Keys per slice of a hot cell: n keys' fair share over the blocks
    the card holds at once (units), and never below the cell's words,
    which a split slice zeroes and merges."""
    return max(-(-n // max(units, 1)), cell_words)


def sweep_plain(words, canon, valid, bits_log2: int, prev=None) -> torch.Tensor:
    """Plain PyTorch K5, in place on words: OR in the bit of every valid
    key (whose bit prev holds, when prev is given). Distinct bits of one
    word sum to their OR."""
    bit = canon[valid] & ((1 << bits_log2) - 1)
    if prev is not None:
        bit = bit[((prev[bit >> 5].long() >> (bit & 31)) & 1) != 0]
    bit = torch.unique(bit)
    acc = torch.zeros(words.shape[0], dtype=torch.int64, device=words.device)
    acc.index_add_(0, bit >> 5, torch.ones_like(bit) << (bit & 31))
    words |= _as_int32_bits(acc)
    return words


def _check(words, canon, valid, bits_log2: int, prev=None) -> None:
    if not supported(bits_log2) or bits_log2 < 16:
        raise ValueError("bf_sweep: filters of 2^16..2^32 bits only")
    n_words = (1 << bits_log2) // 32
    for name, t in (("words", words), ("prev", prev)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (n_words,)):
            raise ValueError(f"bf_sweep: {name} must be int32 [2^bits_log2 / 32]")
    if canon.dtype != torch.int64 or valid.dtype != torch.bool or canon.shape != valid.shape:
        raise ValueError("bf_sweep: canon int64 [n] and valid bool [n] expected")
    if canon.dim() != 1 or canon.shape[0] >= 1 << 31:
        raise ValueError("bf_sweep: one segment holds fewer than 2^31 keys")


@functools.lru_cache(maxsize=None)
def units(index: int, cascade: bool, cell_log2: int) -> int:
    """Apply blocks CUDA device index holds at once: its SMs times the
    blocks one SM holds given the apply's shared memory and threads
    (csrc/bf_sweep.cu asks the occupancy API)."""
    per_sm = ctypes.c_int(0)
    rc = _kernels.lib().ntsynt_bf_sweep_blocks_per_sm(int(cascade), cell_log2,
                                                      ctypes.byref(per_sm))
    _kernels.check("bf_sweep_blocks_per_sm", rc)
    return per_sm.value * _kernels.sm_count(index)


def bin_keys(canon, valid, bits_log2: int, cascade: bool = False):
    """The kernel's first half on CUDA tensors (canon 16-byte and valid
    2-byte aligned, 0 < n < 2^31): K4's binning at K5's cells, with the
    apply's slices for that mode. Returns (binned, offsets, first, chunk)
    for apply_bins. Not counted as a launch."""
    n = canon.shape[0]
    _, cell_log2, _ = geometry(bits_log2)
    chunk = split_chunk(n, 1 << cell_log2, units(canon.device.index, cascade, cell_log2))
    return (*bloom.bin_keys(canon, valid, bits_log2, cell_log2, chunk), chunk)


def apply_bins(words, binned, offsets, first, chunk: int, bits_log2: int, prev=None) -> None:
    """The kernel's second half on CUDA tensors: one block per slice of a
    cell ORs its binned keys into words (those prev holds, when given).
    Not counted as a launch."""
    _, cell_log2, n_cells = geometry(bits_log2)
    rc = _kernels.lib().ntsynt_bf_sweep_apply(
        words.data_ptr(), None if prev is None else prev.data_ptr(), binned.data_ptr(),
        offsets.data_ptr(), first.data_ptr(), binned.shape[0], n_cells, chunk, cell_log2,
        _kernels.stream_ptr(words.device),
    )
    _kernels.check("bf_sweep_apply", rc)


def _sweep(words, canon, valid, bits_log2: int, prev=None) -> torch.Tensor:
    _check(words, canon, valid, bits_log2, prev)
    if words.device.type == "cpu":
        return sweep_plain(words, canon, valid, bits_log2, prev)
    tensors = (words, canon, valid) + ((prev,) if prev is not None else ())
    _kernels.require_cuda("bf_sweep", *tensors)
    if words.data_ptr() % 16 or (prev is not None and prev.data_ptr() % 16):
        raise ValueError("bf_sweep: words and prev must be 16-byte aligned")
    if canon.shape[0] == 0:
        return words
    if canon.data_ptr() % 16 or valid.data_ptr() % 2:
        canon, valid = canon.clone(), valid.clone()  # fresh blocks are aligned
    apply_bins(words, *bin_keys(canon, valid, bits_log2, prev is not None), bits_log2, prev)
    _kernels.count("bf_sweep", canon.shape[0], bits_log2, "insert" if prev is None else "cascade")
    return words


def insert_segment(words, canon, valid, bits_log2: int) -> torch.Tensor:
    """OR the bit of every valid canonical hash into words, in place
    (ntsynt_tpu/ops/bf_sweep.insert_segment).

    Args:
      words: int32 [2^bits_log2 / 32] filter words, bits_log2 in 16..32.
      canon: int64 [n] canonical hashes.
      valid: bool [n]; only valid keys are inserted.
    Returns words.
    """
    return _sweep(words, canon, valid, bits_log2)


def cascade_segment(prev, new, canon, valid, bits_log2: int) -> torch.Tensor:
    """OR into new, in place, the bit of every valid key whose bit prev
    holds (ntsynt_tpu/ops/bf_sweep.cascade_segment). Returns new."""
    return _sweep(new, canon, valid, bits_log2, prev=prev)
