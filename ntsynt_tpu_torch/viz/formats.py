"""Visualization-input formatters.

Reimplements the reference's three pure-Python viz preprocessing tools
(visualization_scripts/, SURVEY.md §2.1) with the same file contracts:

  * sort_blocks        — reorder assemblies within each block
                         (sort_ntsynt_blocks.py)
  * gggenomes files    — <prefix>.sequence_lengths.tsv + <prefix>.links.tsv
                         (format_blocks_gggenomes.py)
  * chromosome painting— blocks re-expressed relative to a target
                         assembly (format_blocks_chromosome_painting.py)

Plot rendering itself lives in viz/plot.py (matplotlib replaces the
reference's R/gggenomes/ggplot2 scripts).
"""

import os
import re
from collections import namedtuple

Row = namedtuple("Row", ["id", "genome", "chrom", "start", "end", "strand", "rest"])


def _read_rows(path):
    rows = []
    with open(path, "r", encoding="utf-8") as fin:
        for line in fin:
            p = line.rstrip("\n").split("\t")
            rows.append(Row(p[0], p[1], p[2], p[3], p[4], p[5], p[6:]))
    return rows


def _group_by_block(rows):
    groups, cur, cur_id = [], [], None
    for r in rows:
        if cur_id is not None and r.id != cur_id:
            groups.append(cur)
            cur = []
        cur.append(r)
        cur_id = r.id
    if cur:
        groups.append(cur)
    return groups


# ---------------------------------------------------------------------------
def sort_blocks(blocks_tsv: str, sort_order, out=None):
    """Reorder the assemblies within each block (sort_ntsynt_blocks.py).

    sort_order: list of assembly names in the desired order.
    Writes lines to `out` (a file object) or returns them as a list.
    """
    order = {asm: i for i, asm in enumerate(sort_order)}
    lines = []
    for group in _group_by_block(_read_rows(blocks_tsv)):
        for r in sorted(group, key=lambda x: order[x.genome]):
            lines.append("\t".join([r.id, r.genome, r.chrom, r.start, r.end, r.strand] + r.rest))
    if out is not None:
        out.write("\n".join(lines) + "\n")
        return None
    return lines


# ---------------------------------------------------------------------------
def write_sequence_lengths(fai_paths, prefix: str) -> str:
    """<prefix>.sequence_lengths.tsv (format_blocks_gggenomes.py:14-24)."""
    path = f"{prefix}.sequence_lengths.tsv"
    with open(path, "w", encoding="utf-8") as fout:
        fout.write("bin_id\tseq_id\tlength\n")
        for fai in fai_paths:
            base = os.path.basename(fai)
            m = re.search(r"^(\S+)\.fai$", base)
            name = m.group(1) if m else base
            with open(fai, "r", encoding="utf-8") as fin:
                for line in fin:
                    p = line.rstrip("\n").split("\t")
                    fout.write(f"{name}\t{p[0]}\t{p[1]}\n")
    return path


def write_links(blocks_tsv: str, prefix: str, min_length: int = 10000, colour_assembly: str | None = None) -> str:
    """<prefix>.links.tsv: pairwise links between consecutive assemblies
    of each block (format_blocks_gggenomes.py:26-61).

    Streaming semantics replicated exactly:
      * valid ids = any row of the block with end-start >= min_length
        (find_valid_block_ids);
      * colour_block = the *last-seen* chromosome of the colour assembly
        at flush time — state persists across blocks, so a block with no
        colour-assembly row inherits the previous block's chromosome, and
        a leading block before any colour row prints "None"
        (format_blocks_gggenomes.py:52-55);
      * the block inversion flag ignores the block's FIRST row (only rows
        compared against a previous same-id row set it,
        format_blocks_gggenomes.py:40);
      * the final (EOF) flush reuses the block_type computed at the last
        id boundary — the previous block's flag — mirroring the reference
        (block_type is only reassigned on id change, line 48 vs 58-60).
        For a single-block file (block_type never assigned; reference
        would NameError) we compute it fresh instead of crashing.
    """
    rows = _read_rows(blocks_tsv)
    valid = {r.id for r in rows if int(r.end) - int(r.start) >= min_length}
    if colour_assembly is None and rows:
        colour_assembly = rows[0].genome
    path = f"{prefix}.links.tsv"
    with open(path, "w", encoding="utf-8") as fout:
        fout.write(
            "block_id\tseq_id\tbin_id\tstart\tend\t"
            "seq_id2\tbin_id2\tstart2\tend2\tstrand\tblock_ori\tcolour_block\n"
        )
        prev = None
        pending: list[str] = []
        cur_inv = False
        block_type = None
        target_chrom = None

        def flush():
            if prev is not None and prev.id in valid:
                bt = block_type if block_type is not None else ("-" if cur_inv else "+")
                for line in pending:
                    fout.write(f"{line}\t{bt}\t{target_chrom}\n")

        for r in rows:
            if prev is not None and prev.id == r.id:
                if r.strand == "-":
                    cur_inv = True
                rel = "-" if r.strand != prev.strand else "+"
                pending.append(
                    f"{r.id}\t{prev.chrom}\t{prev.genome}\t{prev.start}\t{prev.end}\t"
                    f"{r.chrom}\t{r.genome}\t{r.start}\t{r.end}\t{rel}"
                )
            if prev is not None and prev.id != r.id:
                block_type = "-" if cur_inv else "+"
                flush()
                pending = []
                cur_inv = False
            if r.genome == colour_assembly:
                target_chrom = r.chrom
            prev = r
        if prev is not None:
            flush()
    return path


# ---------------------------------------------------------------------------
def write_chromosome_painting(blocks_tsv: str, target: str, out_path: str, convert=None) -> str:
    """Re-express blocks relative to a target assembly
    (format_blocks_chromosome_painting.py:19-61)."""
    conv = convert or {}
    with open(out_path, "w", encoding="utf-8") as fout:
        fout.write(
            "block_id\ttarget_species\ttarget_chrom\ttarget_start\ttarget_end\t"
            "relative_ori\tother_species\tother_chrom\tother_start\tother_end\n"
        )
        for group in _group_by_block(_read_rows(blocks_tsv)):
            tgt = next((r for r in group if r.genome == target), None)
            if tgt is None:
                continue
            t_name = conv.get(tgt.genome, tgt.genome)
            for other in group:
                if other.genome == target:
                    continue
                o_name = conv.get(other.genome, other.genome)
                rel = "+" if other.strand == tgt.strand else "-"
                fout.write(
                    f"{group[0].id}\t{t_name}\t{tgt.chrom}\t{tgt.start}\t{tgt.end}\t"
                    f"{rel}\t{o_name}\t{other.chrom}\t{other.start}\t{other.end}\n"
                )
    return out_path
