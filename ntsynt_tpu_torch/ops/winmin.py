"""Sliding-window leftmost argmin + min hash (PyTorch + CUDA kernel K2).

For keys[n] (64-bit hashes in int64 holding the uint64 bit pattern;
invalid k-mers carry the all-ones sentinel) and a window size w, window
j in [0, n - w + 1) covers keys[j .. j + w - 1]. Its argmin is the
leftmost position of its minimum, i.e. the minimum under the unsigned
(key, position) order, which is what a <-comparison monotone queue
(indexlr) selects.

``window_argmin`` launches the CUDA kernel (csrc/winmin.cu) for a CUDA
tensor and runs ``window_argmin_plain`` for a CPU tensor.
"""

import torch

from . import _kernels

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
    nw = n - w + 1
    arg = torch.empty(nw, dtype=torch.int64, device=keys.device)
    minv = torch.empty(nw, dtype=torch.int64, device=keys.device)
    rc = _kernels.lib().ntsynt_winmin(
        keys.data_ptr(), n, w, arg.data_ptr(), minv.data_ptr(),
        _kernels.stream_ptr(keys.device),
    )
    _kernels.check("winmin", rc)
    _kernels.count("winmin", n, w)
    return arg, minv
