"""Minimizer sketch TSV read/write (indexlr-compatible).

Format (observed at
tests/expected_result/celegans-chrII-III.fa.k24.w1000.tsv):
one line per contig: ``contig_name<TAB>hash:pos:seq hash:pos:seq ...``
with space-separated records and no trailing separator. ``hash`` is the
printed ntHash value (see ops/nthash.py), ``pos`` the 0-based k-mer
start, ``seq`` the raw k-mer bases.
"""

import numpy as np


def write_sketch_tsv(path: str, contig_records) -> str:
    """Write a sketch TSV.

    Args:
      path: output filename.
      contig_records: iterable of (contig_name, hashes u64[n], positions
        int64[n], seqs list[str]) — one tuple per contig, in genome order.
        Contigs with zero minimizers still get a line (name + tab).
    """
    with open(path, "w", encoding="utf-8") as fout:
        for name, hashes, positions, seqs in contig_records:
            recs = " ".join(
                f"{int(h)}:{int(p)}:{s}" for h, p, s in zip(hashes, positions, seqs)
            )
            fout.write(f"{name}\t{recs}\n")
    return path


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
