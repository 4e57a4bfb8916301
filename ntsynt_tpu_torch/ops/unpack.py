"""Unpack of the code stream's upload format on the device.

A stream of n codes (n % 8 == 0) travels as planar 2-bit codes (uint8
[n/4]: byte b holds positions b, b + n/4, b + n/2, b + 3n/4 at bits 0,
2, 4, 6) and a planar N bitmap (uint8 [n/8]: bit j of byte c is set
where position c + j*n/8 holds code 4), 0.375 bytes a code
(io/fasta.pack_stream). ``unpack`` restores the uint8 codes, on the card
with the kernel in csrc/unpack.cu, which replaces the JAX package's
``_unpack_stream_fn`` (ntsynt_tpu/ops/sketch.py) and ``_unpack_row``
(ntsynt_tpu/parallel/mesh.py).
"""

import torch

from . import _kernels


def unpack_plain(packed2: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch unpack: uint8 [8 * len(nbits)] codes, 4 where the N
    bit is set, else the 2-bit code (the JAX package's _unpack_stream_fn)."""
    p = packed2
    codes = torch.cat([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3])
    isn = torch.cat([(nbits >> j) & 1 for j in range(8)])
    return torch.where(isn != 0, torch.full_like(codes, 4), codes)


def unpack(packed2: torch.Tensor, nbits: torch.Tensor, out: torch.Tensor | None = None
           ) -> torch.Tensor:
    """Codes of the packed stream (packed2 uint8 [n/4], nbits uint8
    [n/8]) written into out (uint8 [n], contiguous; may be a view into
    the assembled stream at any offset; a new tensor when None) and
    returned. CUDA tensors launch the kernel; CPU tensors take
    unpack_plain."""
    m = nbits.shape[0]
    n = 8 * m
    if packed2.dtype != torch.uint8 or nbits.dtype != torch.uint8 or packed2.dim() != 1 \
            or nbits.dim() != 1 or packed2.shape[0] != 2 * m:
        raise ValueError("unpack: packed2 uint8 [n/4] and nbits uint8 [n/8] expected")
    if out is None:
        out = torch.empty(n, dtype=torch.uint8, device=nbits.device)
    if out.dtype != torch.uint8 or out.shape != (n,):
        raise ValueError(f"unpack: out must be uint8 [{n}]")
    if nbits.device.type == "cpu":
        out.copy_(unpack_plain(packed2, nbits))
        return out
    _kernels.require_cuda("unpack", packed2, nbits, out)
    if n == 0:
        return out
    rc = _kernels.lib().ntsynt_unpack(packed2.data_ptr(), nbits.data_ptr(), n, out.data_ptr(),
                                      _kernels.stream_ptr(out.device))
    _kernels.check("unpack", rc)
    _kernels.count("unpack", n)
    return out
