"""Minimizer sketch TSV read/write (indexlr-compatible).

Format (observed at
tests/expected_result/celegans-chrII-III.fa.k24.w1000.tsv):
one line per contig: ``contig_name<TAB>hash:pos:seq hash:pos:seq ...``
with space-separated records and no trailing separator. ``hash`` is the
printed ntHash value (see ops/nthash.py), ``pos`` the 0-based k-mer
start, ``seq`` the raw k-mer bases.
"""

import numpy as np

from . import textfmt


def write_sketch_tsv(path: str, contig_records) -> int:
    """Write a sketch TSV, its records formatted by the host library
    (io/textfmt.py).

    Args:
      path: output filename.
      contig_records: iterable of (contig_name, hashes u64[n], positions
        int64[n], seqs uint8[n, k], the k-mers' bytes) — one tuple per
        contig, in genome order. Contigs with zero minimizers still get a
        line (name + tab).
    Returns the number of records written.
    """
    written = 0
    with open(path, "wb") as fout:
        for name, hashes, positions, seqs in contig_records:
            fout.write(f"{name}\t".encode())
            written += textfmt.sketch_records(fout, hashes, positions, seqs)
            fout.write(b"\n")
    return written


def read_sketch_tsv(path: str):
    """Read a sketch TSV.

    Returns a list of (contig_name, hashes u64[n], positions int64[n],
    seqs list[str]) tuples, one per line.
    """
    out = []
    with open(path, "r", encoding="utf-8") as fin:
        for line in fin:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            name = parts[0]
            if len(parts) < 2 or not parts[1]:
                out.append((name, np.zeros(0, np.uint64), np.zeros(0, np.int64), []))
                continue
            hashes, positions, seqs = [], [], []
            for rec in parts[1].split(" "):
                h, p, s = rec.split(":")
                hashes.append(int(h))
                positions.append(int(p))
                seqs.append(s)
            out.append(
                (
                    name,
                    np.array(hashes, dtype=np.uint64),
                    np.array(positions, dtype=np.int64),
                    seqs,
                )
            )
    return out
