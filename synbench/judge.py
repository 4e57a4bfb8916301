"""What decides ``correct``: each job's outputs against the plain
reference (reference.py) and the generator's planted truth (gen.py).

Numbers compared, each against its limit (limits.json):
  - ``cascade_diff``: cascade levels whose occupancy, as the job's log
    prints it (4 decimals), differs from the reference filter's;
  - ``sketch_diff``: minimizer records (hash:pos:seq of a contig) in a
    job's sketch TSV and not in the reference's, or the other way round;
  - ``block_err_bp``: over every block and every genome but A, how far
    the genome's row lies from where the truth puts A's row (contig,
    start, end and relative strand; gen.to_a); a row on the wrong contig
    or strand, or across the end of the contig the truth puts it on,
    counts the block's length;
  - ``uncovered_pct``: the largest share of a genome's non-N bases
    outside every block, in percent (a run of N holds no k-mer, so no
    block can cover it; a block that spans one is not held to it).
"""

import json
import os
import re

import numpy as np

from . import gen

_OCC = re.compile(rb"(?:Level-1 BF occupancy/FPR|Cascade BF occupancy/FPR after \S+): "
                  rb"([0-9.]+)")


def limits() -> dict:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "limits.json")
    with open(path) as fin:
        return {k: v for k, v in json.load(fin).items() if not k.startswith("_")}


def cascade_diff(log_bytes: bytes, ref_occ: list) -> int:
    """Levels whose printed occupancy is not the reference's (a missing
    or extra level counts)."""
    got = [m.decode() for m in _OCC.findall(log_bytes)]
    want = [f"{x:.4f}" for x in ref_occ]
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))


def _records(tsv: bytes) -> set:
    out = set()
    for line in tsv.splitlines():
        name, _, recs = line.partition(b"\t")
        out.update((name, r) for r in recs.split())
        out.add((name, None))  # the contig's line itself
    return out


def sketch_diff(got: bytes, want: bytes) -> int:
    """Records in one TSV and not the other (0 when byte-identical)."""
    if got == want:
        return 0
    return len(_records(got) ^ _records(want))


def read_blocks(path: str):
    """{block id: {assembly: (contig, start, end, strand)}}."""
    blocks = {}
    with open(path) as fin:
        for line in fin:
            f = line.rstrip("\n").split("\t")
            if len(f) < 6:
                continue
            blocks.setdefault(f[0], {})[f[1]] = (f[2], int(f[3]), int(f[4]), f[5])
    return blocks


def block_errors(blocks: dict, genomes) -> tuple:
    """(block_err_bp, uncovered_pct) of one job's blocks."""
    a = genomes[0]
    off = {g.name: dict(zip(g.contig_names, g.offsets.tolist())) for g in genomes}
    covered = {g.name: [] for g in genomes}
    worst = 0
    for rows in blocks.values():
        if a.name not in rows or len(rows) != len(genomes):
            worst = max(worst, max(e - s for _, s, e, _ in rows.values()) if rows else 1)
            continue
        ca, sa, ea, oa = rows[a.name]
        length = ea - sa
        ga = off[a.name].get(ca)
        for g in genomes:
            c, s, e, o = rows[g.name]
            if off[g.name].get(c) is None or ga is None:
                worst = max(worst, length)
                continue
            covered[g.name].append((off[g.name][c] + s, off[g.name][c] + e))
            if g is a:
                continue
            ts, te, refl = gen.to_a(g, [ga + sa], [ga + ea])
            ts, te = int(ts[0]), int(te[0])
            ci = int(np.searchsorted(g.offsets, ts, side="right")) - 1
            want_c = g.contig_names[ci]
            cs = int(g.offsets[ci])
            same = (o == oa) != bool(refl[0])
            if te > cs + int(g.contig_lengths[ci]) or c != want_c or not same or o not in "+-":
                worst = max(worst, length)
                continue
            worst = max(worst, abs(s - (ts - cs)), abs(e - (te - cs)))
    uncovered = 0.0
    for g in genomes:
        iv = sorted(covered[g.name])
        tot, reach, merged = 0, 0, []
        for s, e in iv:
            s = max(s, reach)
            if e > s:
                tot += e - s
                reach = e
                merged.append((s, e))
        if g.gaps is not None:
            tot -= _overlap(merged, g.gaps)
        uncovered = max(uncovered, 100.0 * (1 - tot / (g.total - g.gap_bp)))
    return worst, uncovered


def _overlap(merged: list, gaps: np.ndarray) -> int:
    """Bases that the disjoint intervals merged and gaps share."""
    if not merged or len(gaps) == 0:
        return 0
    iv = np.asarray(merged, np.int64)
    lo = np.maximum(iv[:, None, 0], gaps[None, :, 0])
    hi = np.minimum(iv[:, None, 1], gaps[None, :, 1])
    return int(np.clip(hi - lo, 0, None).sum())
