"""Sliding-window leftmost argmin + min hash (PyTorch + CUDA kernel K2).

For keys[n] (64-bit hashes in int64 holding the uint64 bit pattern;
invalid k-mers carry the all-ones sentinel) and a window size w, window
j in [0, n - w + 1) covers keys[j .. j + w - 1]. Its argmin is the
leftmost position of its minimum, i.e. the minimum under the unsigned
(key, position) order, which is what a <-comparison monotone queue
(indexlr) selects.

``window_argmin`` launches the CUDA kernel (csrc/winmin.cu, keys staged
in shared memory) for a CUDA tensor and runs ``window_argmin_plain`` for
a CPU tensor.
"""

import torch

from . import _kernels

# K2's shared-memory tile (csrc/winmin.cu): (G + 1) * w + 2 keys staged
# per block, so w up to 4095 is staged whole; larger w is streamed in
# pieces of 32 * STREAM_LANES lanes per warp. A launch aims at
# BLOCKS_PER_SM blocks per SM before it packs more w-blocks into one.
TILE_KEYS = 8192
STREAM_LANES = 15
BLOCKS_PER_SM = 2

_SIGN = -(1 << 63)  # xor with this maps uint64 order onto int64 order
_PMAX = (1 << 63) - 1


def _combine(a, b):
    """Lexicographic min of (signed-order key, pos) pairs."""
    a_less = (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))
    return torch.where(a_less, a[0], b[0]), torch.where(a_less, a[1], b[1])


def _shift(x, s: int, fill: int, left: bool):
    pad = torch.full((x.shape[0], s), fill, dtype=x.dtype, device=x.device)
    if left:
        return torch.cat([x[:, s:], pad], dim=1)
    return torch.cat([pad, x[:, :-s]], dim=1)


def _scan(key, pos, w: int, reverse: bool):
    """Inclusive prefix (or suffix) min along dim 1, log2(w) steps."""
    s = 1
    while s < w:
        prev = (_shift(key, s, _PMAX, reverse), _shift(pos, s, _PMAX, reverse))
        key, pos = _combine((key, pos), prev)
        s <<= 1
    return key, pos


def window_argmin_plain(keys: torch.Tensor, w: int):
    """Plain PyTorch K2: (arg int64, minv int64), each [n - w + 1]."""
    n = keys.shape[0]
    nw = n - w + 1
    dev = keys.device
    nb = -(-n // w) + 1  # one spare block so block b+1 always exists
    skey = torch.full((nb * w,), _PMAX, dtype=torch.int64, device=dev)
    skey[:n] = keys ^ _SIGN
    pos = torch.arange(nb * w, dtype=torch.int64, device=dev)
    pos[n:] = _PMAX
    skey, pos = skey.view(nb, w), pos.view(nb, w)
    suf = _scan(skey, pos, w, reverse=True)
    pre = _scan(skey, pos, w, reverse=False)
    j = torch.arange(nw, dtype=torch.int64, device=dev)
    b, c = j // w, j % w
    s_key, s_pos = suf[0][b, c], suf[1][b, c]
    # prefix of block b+1 up to lane c-1 (empty for c == 0)
    has_p = c > 0
    pc = (c - 1).clamp(min=0)
    p_key = torch.where(has_p, pre[0][b + 1, pc], _PMAX)
    p_pos = torch.where(has_p, pre[1][b + 1, pc], _PMAX)
    mkey, arg = _combine((s_key, s_pos), (p_key, p_pos))
    return arg, mkey ^ _SIGN


def winmin_plan(n: int, w: int, sm_count: int):
    """(tile, G, tw, cs) of K2 for n keys at window w on a card of
    sm_count SMs. Staged (G >= 1): a block stages G w-blocks and the
    next one in a tile of TILE_KEYS keys, G as large as the tile holds
    but no larger than fills BLOCKS_PER_SM blocks per SM (so a few
    thousand keys still spread over many blocks); a group of tw threads
    (a power of two <= 32, about w/4) scans one w-block, cs lanes each,
    cs odd so that a warp's strided shared loads hit distinct banks.
    Streamed (G == 0, w > 4095): one warp per w-block, cs = STREAM_LANES."""
    g = (TILE_KEYS - 2) // w - 1
    if g < 1:
        return TILE_KEYS, 0, 32, STREAM_LANES
    nb = -(-(n - w + 1) // w)
    g = max(1, min(g, -(-nb // (BLOCKS_PER_SM * sm_count))))
    tw = 1
    while tw < 32 and tw * 4 < w:
        tw <<= 1
    return TILE_KEYS, g, tw, -(-w // tw) | 1


def window_argmin(keys: torch.Tensor, w: int):
    """Leftmost argmin and min key of every length-w window of keys.

    Args:
      keys: int64 [n], n >= w >= 1.
    Returns (arg int64, minv int64), each [n - w + 1]; arg holds
    positions in [0, n).
    """
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError("window_argmin: keys must be a 1-D int64 tensor")
    n = keys.shape[0]
    if not 1 <= w <= n:
        raise ValueError(f"window_argmin: need 1 <= w <= n, got w={w}, n={n}")
    if keys.device.type == "cpu":
        return window_argmin_plain(keys, w)
    _kernels.require_cuda("window_argmin", keys)
    if keys.data_ptr() % 16:
        keys = keys.clone()  # the kernel stages keys with 16-byte loads
    nw = n - w + 1
    arg = torch.empty(nw, dtype=torch.int64, device=keys.device)
    minv = torch.empty(nw, dtype=torch.int64, device=keys.device)
    plan = winmin_plan(n, w, _kernels.sm_count(keys.device.index))
    rc = _kernels.lib().ntsynt_winmin(
        keys.data_ptr(), n, w, *plan, arg.data_ptr(), minv.data_ptr(),
        _kernels.stream_ptr(keys.device),
    )
    _kernels.check("winmin", rc)
    _kernels.count("winmin", n, w)
    return arg, minv
