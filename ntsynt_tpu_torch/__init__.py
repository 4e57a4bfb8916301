"""ntsynt_tpu_torch: the multi-genome synteny engine on PyTorch and CUDA.

A port of the JAX package ``ntsynt_tpu`` (which stays the reference):
minimizer sketching -> common-k-mer Bloom filter -> minimizer graph ->
linear synteny paths -> refinement rounds -> collinear merging, with the
hot loops as hand-written CUDA kernels for Hopper (``csrc/*.cu``: k-mer
hashing, window argmin, minimizer compaction, Bloom-filter insert) and
plain PyTorch versions of each kernel for CPU tensors.

Entry points take an explicit ``device``; the default is ``"cuda"``, and
asking for CUDA on a machine without it raises instead of falling back.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The torch device to compute on: "cuda" (default) or "cpu".
    Raises when CUDA is asked for but unavailable."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev
