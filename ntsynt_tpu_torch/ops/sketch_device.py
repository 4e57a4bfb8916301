"""Filtered minimizer sketch of one device-resident code stream.

Per segment of windows: hash every k-mer (K1, ops/nthash), drop k-mers
that are invalid or absent from the common Bloom filter by setting their
key to the all-ones sentinel (a plain gather probe, ops/bloom), take
each window's leftmost argmin and min hash (K2, ops/winmin), and compact
the run starts of the argmin sequence over live windows (legit and
holding a valid k-mer) into dense (position, hash) arrays (K3, this
module). The host then maps stream positions to contigs (ops/sketch).

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


def compact_plain(arg, minv, legit):
    """Plain PyTorch K3: (pos int64, hash int64) of the flagged windows
    in window order (see compact_minimizers)."""
    live = legit & (minv != nthash.SENTINEL)
    prev_live = torch.cat([live.new_zeros(1), live[:-1]])
    prev_arg = torch.cat([arg.new_full((1,), -1), arg[:-1]])
    flag = live & (~prev_live | (arg != prev_arg))
    idx = torch.nonzero(flag).squeeze(1)
    return arg[idx], minv[idx]


def compact_minimizers(arg, minv, legit):
    """Compact the selected minimizers of a run of windows.

    Args:
      arg: int64 [nw] each window's leftmost argmin position.
      minv: int64 [nw] each window's min hash (all-ones = no valid k-mer).
      legit: bool [nw] windows lying inside one contig.
    A window is live when legit and valid, and flagged when it is live
    and its argmin differs from the previous window's, or the previous
    window is not live. Returns (pos int64, hash int64) of the flagged
    windows in window order: each selected position appears once.
    """
    nw = arg.shape[0]
    if arg.dtype != torch.int64 or minv.dtype != torch.int64 or legit.dtype != torch.bool:
        raise ValueError("compact_minimizers: int64 arg/minv and bool legit expected")
    if minv.shape != (nw,) or legit.shape != (nw,):
        raise ValueError("compact_minimizers: arg, minv and legit must have one length")
    if arg.device.type == "cpu":
        return compact_plain(arg, minv, legit)
    _kernels.require_cuda("compact_minimizers", arg, minv, legit)
    dev = arg.device
    if nw == 0:
        return arg.new_empty(0), minv.new_empty(0)
    lib = _kernels.lib()
    stream = _kernels.stream_ptr(dev)
    offsets = torch.empty(-(-nw // 1024), dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    rc = lib.ntsynt_compact_count(
        arg.data_ptr(), minv.data_ptr(), legit.data_ptr(), nw,
        offsets.data_ptr(), total.data_ptr(), stream,
    )
    _kernels.check("compact_count", rc)
    m = int(total.item())
    pos = torch.empty(m, dtype=torch.int64, device=dev)
    hsh = torch.empty(m, dtype=torch.int64, device=dev)
    rc = lib.ntsynt_compact_scatter(
        arg.data_ptr(), minv.data_ptr(), legit.data_ptr(), nw,
        offsets.data_ptr(), pos.data_ptr(), hsh.data_ptr(), stream,
    )
    _kernels.check("compact_scatter", rc)
    _kernels.count("compact", nw)
    return pos, hsh


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


def sketch_stream(codes, legit, k: int, w: int, common_bf=None, seg: int = SEG_WINDOWS):
    """Selected minimizers of a code stream.

    Args:
      codes: uint8 [>= n_windows + w + k - 2] code stream on the device.
      legit: bool [n_windows] legit-window mask on the same device.
      common_bf: optional ops.bloom.BloomFilter: k-mers it does not hold
        are not candidates (indexlr -s).
    Returns (positions int64, hashes uint64) as host arrays: the sorted
    unique selected k-mer stream positions and their printed hashes.
    """
    nwin = legit.shape[0]
    pos_l, hash_l = [], []
    for s in range(0, nwin, seg):
        m = min(seg, nwin - s)
        nk = m + w - 1
        key, canon, valid = nthash.hash_kmers(codes[s : s + nk + k - 1], k, nk)
        if common_bf is not None:
            solid = valid & common_bf.probe(canon)
            key = torch.where(solid, key, torch.full_like(key, nthash.SENTINEL))
        del canon, valid
        arg, minv = winmin.window_argmin(key, w)
        del key
        pos, hsh = compact_minimizers(arg, minv, legit[s : s + m])
        pos_l.append((pos + s).cpu().numpy())
        hash_l.append(hsh.cpu().numpy().view(np.uint64))
    if not pos_l:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    return dedupe_pos_hash(np.concatenate(pos_l), np.concatenate(hash_l))
