"""Records of the text artifacts, formatted by the host library.

The sketch TSVs and the ``.mx.dot`` are written on background threads
beside host synteny. Their records are formatted by
``csrc/host/textfmt.cpp`` from whole arrays, a bounded buffer at a time,
in ctypes calls, which release the interpreter lock: no Python object is
made per record, so a writer holds the lock only between calls.
The bytes are the JAX package's Python writers' (tests compare them).
"""

import ctypes

import numpy as np

# bytes of the buffer a file's records are formatted into, a chunk at a
# time (read at each call)
CHUNK_BYTES = 1 << 22


def _lib():
    from ..ops import _kernels

    return _kernels.host_lib()


def _write(fout, fn, args, n: int) -> int:
    """Format records 0 .. n - 1 with the host formatter fn(*args,
    first, n, out, cap, &n_bytes), a chunk at a time, and write them to
    the binary file fout. Returns n."""
    buf = np.empty(CHUNK_BYTES, np.uint8)
    n_bytes = ctypes.c_int64()
    first = 0
    while first < n:
        done = fn(*args, first, n, buf.ctypes.data, len(buf), ctypes.byref(n_bytes))
        if done <= 0:
            raise ValueError(f"textfmt: a record does not fit in {len(buf)} bytes")
        fout.write(buf[: n_bytes.value])
        first += done
    return n


def sketch_records(fout, hashes, positions, seqs) -> int:
    """One contig's sketch records, ``hash:pos:seq`` separated by spaces,
    to fout. hashes u64 [n], positions int [n], seqs the k-mers' bytes,
    uint8 [n, k]. Returns n."""
    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    positions = np.ascontiguousarray(positions, dtype=np.int64)
    n = len(hashes)
    if len(positions) != n:
        raise ValueError(f"sketch records: {n} hashes, {len(positions)} positions")
    seqs = np.ascontiguousarray(seqs)
    if seqs.dtype != np.uint8 or seqs.ndim != 2 or len(seqs) != n:
        raise TypeError(f"sketch records: k-mers must be uint8 [{n}, k], got {seqs.dtype} "
                        f"{seqs.shape}")
    args = (hashes.ctypes.data, positions.ctypes.data, seqs.ctypes.data, seqs.shape[1])
    return _write(fout, _lib().textfmt_sketch, args, n)


def dot_lines(fout, node_hash, eu, ev, weight) -> int:
    """A graph's Graphviz node lines, then its edge lines, to fout.
    Returns the lines written."""
    node_hash = np.ascontiguousarray(node_hash, dtype=np.uint64)
    eu, ev, weight = (np.ascontiguousarray(a, dtype=np.int32) for a in (eu, ev, weight))
    if not len(eu) == len(ev) == len(weight):
        raise ValueError(f"dot edges: {len(eu)}, {len(ev)}, {len(weight)} ends and weights")
    lib = _lib()
    n = _write(fout, lib.textfmt_dot_nodes, (node_hash.ctypes.data,), len(node_hash))
    return n + _write(fout, lib.textfmt_dot_edges,
                      (eu.ctypes.data, ev.ctypes.data, weight.ctypes.data), len(eu))
