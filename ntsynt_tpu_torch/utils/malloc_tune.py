"""glibc malloc tuning for large-array churn.

NumPy's big temporaries (>= the default 128 KB..32 MB dynamic mmap
threshold) are mmap'd by glibc and munmap'd on free, so every fresh
array pays first-touch page faults again. On fault-throttled VMs this
dominates: measured here, faulting fresh pages runs at ~35 MB/s while
re-used pages copy at ~2.9 GB/s — an ~80x gap on an
alloc+copy+add+sort cycle over 18M-element arrays.

Raising M_MMAP_THRESHOLD and M_TRIM_THRESHOLD keeps multi-hundred-MB
buffers in the heap across free/alloc cycles, so the graph/blocks
stages (and the pipeline's host-side pack/prep) touch already-faulted
memory. Called once at package import; opt out with
NTSYNT_NO_MALLOC_TUNE=1.
"""

import ctypes
import os

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_DONE = False


def tune_glibc_malloc(threshold: int = 2**31 - 1) -> bool:
    """Keep allocations below ``threshold`` bytes heap-resident."""
    global _DONE
    if _DONE or os.environ.get("NTSYNT_NO_MALLOC_TUNE"):
        return False
    _DONE = True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = libc.mallopt(_M_MMAP_THRESHOLD, threshold)
        ok &= libc.mallopt(_M_TRIM_THRESHOLD, threshold)
        return bool(ok)
    except Exception:  # non-glibc platform: nothing to tune
        return False
