"""Build, load and count the port's CUDA kernels.

All kernels live in ``ntsynt_tpu_torch/csrc/*.cu`` behind plain C entry
points (raw pointers, sizes and a ``cudaStream_t``; each returns the
``cudaGetLastError()`` of its launch). On first use one ``nvcc`` call
compiles every source into ``ntsynt_tpu_torch/_build/libntsynt_kernels.so``
for ``sm_90a``, and ``ctypes`` loads it. No PyTorch header is compiled:
that keeps the build to seconds instead of the minutes a
``torch.utils.cpp_extension`` build of the same sources takes. The build
is redone only when the SHA-256 of the sources and flags changes.

The host helpers (``csrc/host/*.cpp``: the OpenMP FASTA packer and the
chain walker, the JAX package's ``csrc/fastaio.cpp`` and
``csrc/graphwalk.cpp``) are built apart from the kernels, by ``g++``
(``$CXX`` if set; no ``-march``, so the library runs on any CPU of the
build host's architecture) into ``_build/libntsynt_host.so``, linked
against torch's OpenMP runtime; ``build_host`` needs no CUDA.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on
the card, and ``SHAPES`` holds each such launch's sizes; the plain
PyTorch versions used for CPU tensors do not count.
"""

import ctypes
import functools
import glob
import hashlib
import os
import shlex
import shutil
import subprocess
import tempfile
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

LAUNCHES = {"nthash": 0, "winmin": 0, "compact": 0, "bf_insert": 0, "bf_sweep": 0, "unpack": 0}
# per kernel, the sizes of every counted launch: nthash (n_kmers, k),
# winmin (n, w), compact (nw,), bf_insert (n, bits_log2), bf_sweep
# (n, bits_log2, "insert" | "cascade"), unpack (n_codes,)
SHAPES = {name: [] for name in LAUNCHES}

HOST_SRC = os.path.join(CSRC, "host")
HOST_LIB_NAME = "libntsynt_host.so"
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-fopenmp"]

# the last build's wall seconds and whether it was reused from _build/
BUILD_INFO = {"seconds": None, "cached": None}
HOST_BUILD_INFO = {"seconds": None, "cached": None}

_LIB = None
_HOST_LIB = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    # codes, n_kmers, k, tables (host), mult, run, key, canon, valid, stream
    "ntsynt_nthash": [_P, _I64, ctypes.c_int, _P, ctypes.c_uint64, ctypes.c_int, _P, _P, _P, _P],
    # keys, n, w, tile, g, tw, cs, arg, minv, stream
    "ntsynt_winmin": [_P, _I64, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      _P, _P, _P],
    # arg, minv, legit bits, legit bit offset, legit bytes, nw, scratch, out_pos, out_hash,
    # stream
    "ntsynt_compact": [_P, _P, _P, _I64, _I64, _I64, _P, _P, _P, _P],
    # packed2, nbits, n, out, stream
    "ntsynt_unpack": [_P, _P, _I64, _P, _P],
    # words, canon, valid, n, bits_log2, stream
    "ntsynt_bf_insert": [_P, _P, _P, _I64, ctypes.c_int, _P],
    # canon, valid, n, bits_log2, cell_log2, counts, stream
    "ntsynt_bf_cell_count": [_P, _P, _I64, ctypes.c_int, ctypes.c_int, _P, _P],
    # canon, valid, n, bits_log2, digits_log2, shift, cursor, dst, stream
    "ntsynt_bf_partition_keys": [_P, _P, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
                                 _P],
    # n_ranges -> n_plan
    "ntsynt_bf_plan_size": [ctypes.c_int],
    # counts, n_cells, digits_b, chunk, offsets, cursor_a, cursor_b, plan, n_plan, first,
    # stream
    "ntsynt_bf_bin_scan": [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P,
                           ctypes.c_int, _P, _P],
    # src, plan, n_plan, digits_log2, shift, cursor, dst, stream
    "ntsynt_bf_partition_bins": [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P],
    # words, binned, offsets, bits_log2, cell_log2, stream
    "ntsynt_bf_apply": [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P],
    # cascade, cell_log2, blocks (out)
    "ntsynt_bf_sweep_blocks_per_sm": [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    # words, prev (NULL: insert), binned, offsets, first, n, n_cells, chunk, cell_log2, stream
    "ntsynt_bf_sweep_apply": [_P, _P, _P, _P, _P, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              _P],
}


_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)
# host library: name -> (restype, argtypes)
_HOST_SIGNATURES = {
    "fastaio_parse": (_P, [ctypes.c_char_p, ctypes.c_int]),
    "fastaio_n_contigs": (_I64, [_P]),
    "fastaio_total": (_I64, [_P]),
    "fastaio_names_len": (_I64, [_P]),
    "fastaio_lengths": (_I64P, [_P]),
    "fastaio_offsets": (_I64P, [_P]),
    "fastaio_fai_offsets": (_I64P, [_P]),
    "fastaio_fai_linebases": (_I64P, [_P]),
    "fastaio_fai_linewidth": (_I64P, [_P]),
    "fastaio_codes": (_U8P, [_P]),
    "fastaio_raw": (_U8P, [_P]),
    "fastaio_names": (ctypes.POINTER(ctypes.c_char), [_P]),
    "fastaio_free": (None, [_P]),
    # codes, offsets, lengths, starts, n_contigs, out_len, packed2, nbits, threads
    "fastaio_pack_stream": (None, [_P, _P, _P, _P, _I64, _I64, _P, _P, ctypes.c_int]),
    # nxt, du, dv, poison, starts, n_starts, m2, out_nodes, out_offsets, out_cap
    "graphwalk_chains": (_I64, [_P, _P, _P, _P, _P, _I64, _I64, _P, _P, _I64]),
    # the OpenMP runtime the library links (the calling thread's ICV)
    "omp_get_max_threads": (ctypes.c_int, []),
    "omp_set_num_threads": (None, [ctypes.c_int]),
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
    """The translation units nvcc compiles."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def source_digest() -> str:
    """SHA-256 of the flags, the sources and the headers they include
    (csrc/*.cuh), so an edited header rebuilds too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
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


def _build_cached(lib_name: str, digest: str, commands, info: dict, build_dir: str) -> str:
    """Run the argument lists commands() gives, in a fresh directory
    inside build_dir (the last writes lib_name there), unless build_dir
    already holds lib_name for this digest. The library is moved into place
    whole, so concurrent builds (test workers) never load a
    half-written one. Returns its path; a failed build raises with the
    compiler's output."""
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, lib_name)
    stamp = os.path.join(build_dir, lib_name + ".sha256")
    t0 = time.perf_counter()
    if os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as fin:
            if fin.read().strip() == digest:
                info.update(seconds=time.perf_counter() - t0, cached=True)
                return lib_path
    work = tempfile.mkdtemp(prefix=f".{lib_name}.", dir=build_dir)
    try:
        for cmd in commands():
            proc = subprocess.run(cmd, capture_output=True, text=True, cwd=work)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{os.path.basename(cmd[0])} failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stderr}{proc.stdout}"
                )
        os.replace(os.path.join(work, lib_name), lib_path)
        with open(os.path.join(work, "stamp"), "w") as fout:
            fout.write(digest + "\n")
        os.replace(os.path.join(work, "stamp"), stamp)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    info.update(seconds=time.perf_counter() - t0, cached=False)
    return lib_path


def build() -> str:
    """Compile every csrc/*.cu with one nvcc call unless the library for
    the current source digest is already in _build/. Returns its path."""
    return _build_cached(LIB_NAME, source_digest(),
                         lambda: [[_nvcc(), *NVCC_FLAGS, "-o", LIB_NAME, *sources()]],
                         BUILD_INFO, BUILD_DIR)


def host_sources() -> list:
    """The host helpers' translation units g++ compiles."""
    return sorted(glob.glob(os.path.join(HOST_SRC, "*.cpp")))


def _openmp_runtime() -> str:
    """The OpenMP runtime the host library links: torch's own
    libgomp.so.1 where its wheel ships one (the loader then maps that one
    runtime for both, and the link checks the symbol versions the process
    will have), else the compiler's -lgomp."""
    import torch

    bundled = os.path.join(os.path.dirname(torch.__file__), "lib", "libgomp.so.1")
    return bundled if os.path.exists(bundled) else "-lgomp"


def _host_commands() -> list:
    """Compile csrc/host/*.cpp with $CXX (g++ by default) and
    HOST_FLAGS in one call, then link them and the OpenMP runtime into
    HOST_LIB_NAME in a second: the link names the runtime, since a
    toolchain may compile -fopenmp without shipping the spec file that
    lets -fopenmp link it."""
    cxx = shlex.split(os.environ.get("CXX") or "g++")
    objects = [os.path.splitext(os.path.basename(p))[0] + ".o" for p in host_sources()]
    return [[*cxx, *HOST_FLAGS, "-c", *host_sources()],
            [*cxx, "-shared", "-Wl,--no-undefined", "-o", HOST_LIB_NAME, *objects,
             _openmp_runtime()]]


def build_host(build_dir: str = BUILD_DIR) -> str:
    """Build the host library (no nvcc needed) unless the one for the
    current commands and sources is already in build_dir. Returns its
    path."""
    commands = _host_commands()
    h = hashlib.sha256(repr(commands).encode())
    for path in host_sources():
        with open(path, "rb") as fin:
            h.update(fin.read())
    return _build_cached(HOST_LIB_NAME, h.hexdigest(), lambda: commands, HOST_BUILD_INFO,
                         build_dir)


def host_lib():
    """The loaded host library (built on first call)."""
    global _HOST_LIB
    with _LOCK:
        if _HOST_LIB is None:
            handle = ctypes.CDLL(build_host())
            for name, (restype, argtypes) in _HOST_SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _HOST_LIB = handle
        return _HOST_LIB


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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device index (cached: the query
    costs more host time than a small kernel's launch)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


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
