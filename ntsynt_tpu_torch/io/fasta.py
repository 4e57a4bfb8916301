"""FASTA input -> packed base-code arrays + contig table.

Replacement for the reference's file-oriented sequence layer
(btllib SeqReader + `samtools faidx`, SURVEY.md §2.2 items 5-6):
one parse produces

  * ``codes``: uint8 per base, A=0 C=1 G=2 T=3, anything else=4
    (case-insensitive, so soft-masked genomes hash like indexlr's), and
  * ``raw``: the original sequence bytes (needed to emit the ``seq``
    column of sketch TSVs byte-identically), and
  * a contig table equivalent to a `samtools faidx` .fai (name, length,
    byte offset, linebases, linewidth) so we can write a matching .fai
    without shelling out (rule faidx, bin/ntsynt_run_pipeline.smk:48-53).

Plain files are parsed by the host library's OpenMP packer
(``csrc/host/fastaio.cpp``, built by ops/_kernels.build_host); gzip
files, and any file under ``native=False``, by NumPy.
"""

import contextlib
from dataclasses import dataclass
import gzip
import os

import numpy as np

CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE_LUT[_c] = _i
    CODE_LUT[_c + 32] = _i  # lowercase

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)


@dataclass
class PackedGenome:
    """One genome assembly, packed for device-side sketching."""

    path: str
    name: str  # file basename (used as the assembly key, like the reference)
    contig_names: list
    lengths: np.ndarray  # int64 [n_contigs]
    offsets: np.ndarray  # int64 [n_contigs] start of each contig in `codes`
    codes: np.ndarray  # uint8 [total_bases]
    raw: np.ndarray | None  # uint8 [total_bases] original bytes (or None)
    fai_offsets: np.ndarray  # int64 byte offset of first base in file
    fai_linebases: np.ndarray  # int64 bases per line
    fai_linewidth: np.ndarray  # int64 bytes per line (incl newline)

    @property
    def n_contigs(self) -> int:
        return len(self.contig_names)

    @property
    def total_bases(self) -> int:
        return int(self.lengths.sum())

    def kmer_strings(self, contig_idx: int, positions, k: int) -> list:
        """Batch k-mer decode: one gather + bytes view instead of a
        per-minimizer Python loop (the sketch-TSV writer decodes ~2L/w
        k-mers per genome; the loop's GIL time contended with the
        synteny stage when the writer runs on a background thread)."""
        pos = np.asarray(positions, dtype=np.int64)
        if len(pos) == 0:
            return []
        o = int(self.offsets[contig_idx])
        gather = (o + pos)[:, None] + np.arange(k, dtype=np.int64)[None, :]
        if self.raw is not None:
            mat = self.raw[gather]
        else:
            mat = _DECODE[np.minimum(self.codes[gather], 4)]
        return [s.decode() for s in mat.reshape(-1).view(f"S{k}")]


def _native_lib():
    """The host library (csrc/host/fastaio.cpp's OpenMP packer), built on
    first use; a failed build raises."""
    from ..ops import _kernels

    return _kernels.host_lib()


@contextlib.contextmanager
def _omp_threads(lib, threads: int):
    """Calls inside run with ``threads`` > 0 set the calling thread's
    OpenMP thread count (omp_set_num_threads, which the packer calls);
    it is restored on exit, since torch's CPU ops share the runtime when
    both load one libgomp.so.1, and a read at -t 1 would leave them on
    one thread."""
    if threads <= 0:
        yield
        return
    prev = lib.omp_get_max_threads()
    try:
        yield
    finally:
        lib.omp_set_num_threads(prev)


def pack_stream(codes, offsets, lengths, starts, out_len: int, threads: int = 0, out=None):
    """The device upload's packing of an ``out_len``-code stream (out_len
    a multiple of 8) holding contig i (``codes[offsets[i]:offsets[i] +
    lengths[i]]``) at ``starts[i]`` and code 4 everywhere else: planar
    2-bit codes (uint8 [out_len / 4]) and a planar N bitmap (uint8
    [out_len / 8]), the JAX package's pack_stream_native
    (ntsynt_tpu/io/fasta.py). The host library packs in one OpenMP pass
    that never lays the 1-byte stream out (fastaio_pack_stream). out:
    optional (packed2, nbits) uint8 arrays of those sizes to write into
    (a pinned staging buffer's views). Returns (packed2, nbits)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n = len(lengths)
    if len(offsets) != n or len(starts) != n:
        raise ValueError("pack_stream: offsets, lengths and starts differ in length")
    if out_len < 0 or out_len % 8:
        raise ValueError(f"pack_stream: out_len {out_len} is not a multiple of 8")
    ends = starts + lengths
    if n and (
        (lengths < 0).any() or (offsets < 0).any() or (offsets + lengths > len(codes)).any()
        or starts[0] < 0 or (starts[1:] < ends[:-1]).any() or ends[-1] > out_len
    ):
        raise ValueError("pack_stream: contigs out of range or overlapping")
    if out is None:
        out = (np.empty(out_len // 4, np.uint8), np.empty(out_len // 8, np.uint8))
    packed2, nbits = out
    if (packed2.dtype != np.uint8 or nbits.dtype != np.uint8 or packed2.shape != (out_len // 4,)
            or nbits.shape != (out_len // 8,) or not packed2.flags.c_contiguous
            or not nbits.flags.c_contiguous):
        raise ValueError("pack_stream: out must be contiguous uint8 [out_len/4], [out_len/8]")
    lib = _native_lib()
    with _omp_threads(lib, threads):
        lib.fastaio_pack_stream(
            codes.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, starts.ctypes.data,
            n, out_len, packed2.ctypes.data, nbits.ctypes.data, threads,
        )
    return packed2, nbits


def _read_fasta_native(path: str, keep_raw: bool, lib, threads: int = 0) -> PackedGenome | None:
    import ctypes

    with _omp_threads(lib, threads):
        h = lib.fastaio_parse(path.encode(), threads)
    if not h:
        return None
    try:
        n = int(lib.fastaio_n_contigs(h))
        total = int(lib.fastaio_total(h))

        def arr64(fn):
            ptr = fn(h)
            return np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n else np.zeros(0, np.int64)

        lengths = arr64(lib.fastaio_lengths)
        offsets = arr64(lib.fastaio_offsets)
        fai_off = arr64(lib.fastaio_fai_offsets)
        fai_lb = arr64(lib.fastaio_fai_linebases)
        fai_lw = arr64(lib.fastaio_fai_linewidth)
        names_blob = ctypes.string_at(lib.fastaio_names(h), int(lib.fastaio_names_len(h)))
        names = names_blob.decode().split("\x00")[:-1]
        codes = (
            np.ctypeslib.as_array(lib.fastaio_codes(h), shape=(total,)).copy()
            if total
            else np.zeros(0, np.uint8)
        )
        raw = (
            np.ctypeslib.as_array(lib.fastaio_raw(h), shape=(total,)).copy()
            if (keep_raw and total)
            else (np.zeros(0, np.uint8) if keep_raw else None)
        )
    finally:
        lib.fastaio_free(h)
    return PackedGenome(
        path=path,
        name=os.path.basename(path),
        contig_names=names,
        lengths=lengths.astype(np.int64),
        offsets=offsets.astype(np.int64),
        codes=codes,
        raw=raw,
        fai_offsets=fai_off.astype(np.int64),
        fai_linebases=fai_lb.astype(np.int64),
        fai_linewidth=fai_lw.astype(np.int64),
    )


def read_fasta(path: str, keep_raw: bool = True, native: bool | None = None,
               threads: int = 0) -> PackedGenome:
    """Parse a FASTA(.gz) file into a PackedGenome.

    Plain (non-gzip) files go through the host library's OpenMP packer
    (``threads`` > 0 sets its thread count; 0 leaves OpenMP's). A .gz
    file, or native=False, takes the NumPy path; so does a file the
    packer cannot map (empty or unreadable) under native=None, while
    native=True raises for it.
    """
    if native is not False and not path.endswith(".gz"):
        g = _read_fasta_native(path, keep_raw, _native_lib(), threads=threads)
        if g is not None:
            return g
        if native:
            raise IOError(f"native FASTA parse failed for {path}")
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as fin:
            data = fin.read()
    else:
        with open(path, "rb") as fin:
            data = fin.read()

    names, seq_parts = [], []
    lengths, base_offsets = [], []
    fai_off, fai_lb, fai_lw = [], [], []
    cur_parts = None
    byte_pos = 0
    cur_len = 0
    cur_lb = cur_lw = 0
    total = 0

    def _finish():
        nonlocal cur_parts, cur_len, cur_lb, cur_lw, total
        if cur_parts is None:
            return
        lengths.append(cur_len)
        base_offsets.append(total)
        fai_lb.append(cur_lb)
        fai_lw.append(cur_lw)
        total += cur_len
        cur_parts = None

    for line in data.splitlines(keepends=True):
        stripped = line.rstrip(b"\r\n")
        if stripped.startswith(b">"):
            _finish()
            names.append(stripped[1:].split()[0].decode())
            byte_pos += len(line)
            fai_off.append(byte_pos)
            cur_parts = []
            seq_parts.append(cur_parts)
            cur_len = 0
            cur_lb = cur_lw = 0
        else:
            if cur_parts is not None and stripped:
                cur_parts.append(stripped)
                if cur_lb == 0:
                    cur_lb = len(stripped)
                    cur_lw = len(line)
                cur_len += len(stripped)
            byte_pos += len(line)
    _finish()

    raw = np.frombuffer(b"".join(b"".join(p) for p in seq_parts), dtype=np.uint8).copy()
    codes = CODE_LUT[raw]
    return PackedGenome(
        path=path,
        name=os.path.basename(path),
        contig_names=names,
        lengths=np.asarray(lengths, dtype=np.int64),
        offsets=np.asarray(base_offsets, dtype=np.int64),
        codes=codes,
        raw=raw if keep_raw else None,
        fai_offsets=np.asarray(fai_off, dtype=np.int64),
        fai_linebases=np.asarray(fai_lb, dtype=np.int64),
        fai_linewidth=np.asarray(fai_lw, dtype=np.int64),
    )


def write_fai(genome: PackedGenome, out_path: str | None = None) -> str:
    """Write a samtools-compatible .fai for the genome.

    Matches the 5-column format of `samtools faidx`
    (cf. tests/expected_result/*.fai in the reference).
    """
    out_path = out_path or f"{genome.name}.fai"
    with open(out_path, "w", encoding="utf-8") as fout:
        for i, name in enumerate(genome.contig_names):
            fout.write(
                f"{name}\t{genome.lengths[i]}\t{genome.fai_offsets[i]}"
                f"\t{genome.fai_linebases[i]}\t{genome.fai_linewidth[i]}\n"
            )
    return out_path
