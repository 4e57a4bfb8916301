"""Build, load and count the port's CUDA kernels.

All kernels live in ``ntsynt_tpu_torch/csrc/*.cu`` behind plain C entry
points (raw pointers, sizes and a ``cudaStream_t``; each returns the
``cudaGetLastError()`` of its launch). On first use one ``nvcc`` call
compiles every source into ``ntsynt_tpu_torch/_build/libntsynt_kernels.so``
for ``sm_90a``, and ``ctypes`` loads it. No PyTorch header is compiled:
that keeps the build to seconds instead of the minutes a
``torch.utils.cpp_extension`` build of the same sources takes. The build
is redone only when the SHA-256 of the sources and flags changes.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on
the card, and ``SHAPES`` holds each such launch's sizes; the plain
PyTorch versions used for CPU tensors do not count.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libntsynt_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

LAUNCHES = {"nthash": 0, "winmin": 0, "compact": 0, "bf_insert": 0}
# per kernel, the sizes of every counted launch: nthash (n_kmers, k),
# winmin (n, w), compact (nw,), bf_insert (n, bits_log2)
SHAPES = {name: [] for name in LAUNCHES}

# the last build's wall seconds and whether it was reused from _build/
BUILD_INFO = {"seconds": None, "cached": None}

_LIB = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    # codes, n_kmers, k, tables, mult, key, canon, valid, stream
    "ntsynt_nthash": [_P, _I64, ctypes.c_int, _P, ctypes.c_uint64, _P, _P, _P, _P],
    # keys, n, w, arg, minv, stream
    "ntsynt_winmin": [_P, _I64, _I64, _P, _P, _P],
    # arg, minv, legit, nw, block_counts, total, stream
    "ntsynt_compact_count": [_P, _P, _P, _I64, _P, _P, _P],
    # arg, minv, legit, nw, block_offsets, out_pos, out_hash, stream
    "ntsynt_compact_scatter": [_P, _P, _P, _I64, _P, _P, _P, _P],
    # words, canon, valid, n, bits_log2, stream
    "ntsynt_bf_insert": [_P, _P, _P, _I64, ctypes.c_int, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        SHAPES[name].clear()


def count(name: str, *shape) -> None:
    """Record one launch of kernel name with its sizes."""
    LAUNCHES[name] += 1
    SHAPES[name].append(shape)


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fin:
            h.update(fin.read())
    return h.hexdigest()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def build() -> str:
    """Compile every csrc/*.cu with one nvcc call unless the library for
    the current source digest is already in _build/. Returns its path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = os.path.join(BUILD_DIR, LIB_NAME + ".sha256")
    digest = source_digest()
    t0 = time.perf_counter()
    if os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as fin:
            if fin.read().strip() == digest:
                BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=True)
                return lib_path
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, lib_path)
    with open(stamp, "w") as fout:
        fout.write(digest + "\n")
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False)
    return lib_path


def lib():
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
        return _LIB


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def require_cuda(name: str, *tensors) -> None:
    """Kernel inputs must be contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
