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

Supports plain and gzip FASTA, parsed in NumPy.
"""

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


def read_fasta(path: str, keep_raw: bool = True) -> PackedGenome:
    """Parse a FASTA(.gz) file into a PackedGenome (NumPy only: the
    JAX package's optional OpenMP reader, csrc/libfastaio.so, is built
    for one host CPU and is not loaded by this package)."""
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
