"""Filtered minimizer sketch of one device-resident code stream.

Per segment of windows: hash every k-mer (K1, ops/nthash), drop k-mers
that are invalid, absent from the common Bloom filter or present in the
repeat Bloom filter by setting their key to the all-ones sentinel (a
plain gather probe, ops/bloom; a HostModBloomFilter is probed on the
host instead), take
each window's leftmost argmin and min hash (K2, ops/winmin), and compact
the run starts of the argmin sequence over live windows (legit and
holding a valid k-mer) into dense (position, hash) arrays (K3, this
module: one launch, a chained scan with decoupled look-back). The
legit-window mask stays one bit a window on the device (little-endian
bits, ops/sketch._Stream.legit_bits), and K3 reads it at a bit offset,
as the JAX package keeps 1-bit legit words (_pack_legit_planar). The
host then maps stream positions to contigs (ops/sketch).

Every k-mer is probed, which gives the same selections as the JAX
package's iterative exclusion of non-solid window winners
(ntsynt_tpu/ops/sketch_device.py, point 3 of its docstring); that
exclusion, the CAP=128 per-tile compaction with its host recompute and
the chunked dispatch/collect overlap are TPU workarounds with no
counterpart here. Stream offsets are Python ints and tensors are int64,
so streams past 2^31 bases index correctly.
"""

import numpy as np
import torch

from . import _kernels, nthash, winmin

SEG_WINDOWS = 1 << 26  # windows per segment: bounds the per-segment
# temporaries (key, canon, probe, arg, minv: ~3 GB at this size)


def legit_from_bits(bits: torch.Tensor, offset: int, n: int) -> torch.Tensor:
    """bool [n]: bits offset .. offset + n - 1 of the little-endian bit
    array bits (uint8; byte b holds bits 8b .. 8b + 7, lowest first)."""
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=bits.device)
    return ((bits[idx >> 3] >> (idx & 7).to(torch.uint8)) & 1).bool()


def compact_plain(arg, minv, legit, legit_offset: int = 0):
    """Plain PyTorch K3: (pos int64, hash int64) of the flagged windows
    in window order (see compact_minimizers)."""
    legit = legit_from_bits(legit, legit_offset, arg.shape[0])
    live = legit & (minv != nthash.SENTINEL)
    prev_live = torch.cat([live.new_zeros(1), live[:-1]])
    prev_arg = torch.cat([arg.new_full((1,), -1), arg[:-1]])
    flag = live & (~prev_live | (arg != prev_arg))
    idx = torch.nonzero(flag).squeeze(1)
    return arg[idx], minv[idx]


# K3's tile (csrc/compact.cu): windows per block, each block one tile
COMPACT_TILE = 4096


def compact_scratch_words(nw: int) -> int:
    """64-bit scratch words K3 needs for nw windows: its tile ticket, the
    total, and one status word per tile."""
    return 2 + -(-nw // COMPACT_TILE)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()  # K3 loads 16 bytes at a time


def compact_launch(arg, minv, legit, legit_offset: int = 0, out=None):
    """Launch K3 once, without a host sync: returns (pos, hash, scratch),
    pos and hash of at least nw entries (out, or new tensors of nw) of
    which the first scratch[1] are the flagged windows' (see
    compact_minimizers). Checked CUDA tensors, nw >= 1."""
    nw = arg.shape[0]
    dev = arg.device
    arg, minv = _aligned(arg), _aligned(minv)
    # cleared by the entry point on the stream (a memset, not a kernel)
    scratch = torch.empty(compact_scratch_words(nw), dtype=torch.int64, device=dev)
    if out is None:
        out = (torch.empty(nw, dtype=torch.int64, device=dev),
               torch.empty(nw, dtype=torch.int64, device=dev))
    pos, hsh = out
    rc = _kernels.lib().ntsynt_compact(
        arg.data_ptr(), minv.data_ptr(), legit.data_ptr(), legit_offset, legit.shape[0], nw,
        scratch.data_ptr(), pos.data_ptr(), hsh.data_ptr(), _kernels.stream_ptr(dev),
    )
    _kernels.check("compact", rc)
    _kernels.count("compact", nw)
    return pos, hsh, scratch


def compact_minimizers(arg, minv, legit, legit_offset: int = 0, out=None):
    """Compact the selected minimizers of a run of windows.

    Args:
      arg: int64 [nw] each window's leftmost argmin position.
      minv: int64 [nw] each window's min hash (all-ones = no valid k-mer).
      legit: uint8 little-endian bits; bit legit_offset + j is set when
        window j lies inside one contig (at least legit_offset + nw bits).
      out: optional (pos, hash) int64 tensors of at least nw entries, on
        arg's device, to write the result into. They may be arg and minv
        themselves: each result lands at or before the window it comes
        from, after every tile that reads that place has read it (the
        windows are then overwritten), so no nw-entry buffer is needed.
    A window is live when legit and valid, and flagged when it is live
    and its argmin differs from the previous window's, or the previous
    window is not live. Returns (pos int64, hash int64) of the flagged
    windows in window order: each selected position appears once. On the
    card they are views of nw-entry buffers (out, or new ones), sized by
    the one host sync, which reads the kernel's total.
    """
    nw = arg.shape[0]
    if arg.dtype != torch.int64 or minv.dtype != torch.int64 or legit.dtype != torch.uint8:
        raise ValueError("compact_minimizers: int64 arg/minv and uint8 legit bits expected")
    if minv.shape != (nw,) or legit.dim() != 1 or legit_offset < 0 \
            or 8 * legit.shape[0] < legit_offset + nw:
        raise ValueError("compact_minimizers: arg and minv must have one length, and legit "
                         "must hold bits legit_offset .. legit_offset + nw - 1")
    if out is not None and any(t.dtype != torch.int64 or t.dim() != 1 or t.shape[0] < nw
                               or t.device != arg.device for t in out):
        raise ValueError("compact_minimizers: out must be two int64 tensors of >= nw entries")
    if arg.device.type == "cpu":
        pos, hsh = compact_plain(arg, minv, legit, legit_offset)
        if out is None:
            return pos, hsh
        m = pos.shape[0]
        out[0][:m], out[1][:m] = pos, hsh
        return out[0][:m], out[1][:m]
    _kernels.require_cuda("compact_minimizers", arg, minv, legit, *(out or ()))
    if nw == 0:
        return arg.new_empty(0), minv.new_empty(0)
    pos, hsh, scratch = compact_launch(arg, minv, legit, legit_offset, out)
    m = int(scratch[1].item())
    return pos[:m], hsh[:m]


def dedupe_pos_hash(pos: np.ndarray, h: np.ndarray):
    """Sort by position and drop duplicates, keeping hashes aligned
    (duplicates carry identical hashes: the hash is a function of the
    position)."""
    if len(pos) == 0:
        return pos.astype(np.int64), h.astype(np.uint64)
    order = np.argsort(pos, kind="stable")
    pos, h = pos[order], h[order]
    new = np.empty(len(pos), dtype=bool)
    new[0] = True
    np.not_equal(pos[1:], pos[:-1], out=new[1:])
    return pos[new], h[new]


def sketch_stream(codes, legit, k: int, w: int, common_bf=None, repeat_bf=None,
                  seg: int = SEG_WINDOWS, legit_offset: int = 0):
    """Selected minimizers of a code stream.

    Args:
      codes: uint8 [n_windows + w + k - 2] code stream on the device.
      legit: uint8 little-endian legit-window bits on the same device:
        bit legit_offset + j for window j (compact_minimizers).
      common_bf: optional ops.bloom.BloomFilter or HostModBloomFilter:
        k-mers it does not hold are not candidates (indexlr -s).
      repeat_bf: optional filter of the same kinds: k-mers it holds are
        not candidates (indexlr -r).
    Returns (positions int64, hashes uint64) as host arrays: the sorted
    unique selected k-mer stream positions and their printed hashes.
    """
    nwin = max(codes.shape[0] - (w + k - 1) + 1, 0)
    pos_l, hash_l = [], []
    for s in range(0, nwin, seg):
        m = min(seg, nwin - s)
        nk = m + w - 1
        key, canon, valid = nthash.hash_kmers(codes[s : s + nk + k - 1], k, nk)
        if common_bf is not None or repeat_bf is not None:
            solid = valid
            if common_bf is not None:
                solid = solid & common_bf.probe(canon)
            if repeat_bf is not None:
                solid = solid & ~repeat_bf.probe(canon)
            key = torch.where(solid, key, torch.full_like(key, nthash.SENTINEL))
        del canon, valid
        arg, minv = winmin.window_argmin(key, w)
        del key
        # compacted in place: the results overwrite the windows
        pos, hsh = compact_minimizers(arg, minv, legit, legit_offset + s, out=(arg, minv))
        pos_l.append((pos + s).cpu().numpy())
        hash_l.append(hsh.cpu().numpy().view(np.uint64))
    if not pos_l:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    return dedupe_pos_hash(np.concatenate(pos_l), np.concatenate(hash_l))
