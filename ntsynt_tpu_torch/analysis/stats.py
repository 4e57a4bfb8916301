"""De novo synteny block statistics.

Equivalent of analysis_scripts/denovo_synteny_block_stats.py:75-115:
given a blocks TSV and the genomes' .fai files, report block counts,
coverage, length moments and NG50/N50, averaged over assemblies.
"""

import argparse
import os
import re
from collections import defaultdict

import numpy as np


def read_blocks(tsv_path):
    """asm -> list[(length, block_id)], plus block_id -> #assemblies."""
    lengths = defaultdict(list)
    tallies = defaultdict(set)
    with open(tsv_path, "r", encoding="utf-8") as fin:
        for line in fin:
            p = line.rstrip("\n").split("\t")
            block_id, asm, start, end = p[0], p[1], int(p[3]), int(p[4])
            lengths[asm].append((end - start, block_id))
            tallies[block_id].add(asm)
    return lengths, {b: len(s) for b, s in tallies.items()}


def genome_sizes_from_fais(fai_paths):
    sizes = {}
    for fai in fai_paths:
        m = re.search(r"^(\S+)\.fai$", fai)
        name = os.path.basename(m.group(1)) if m else os.path.basename(fai)
        total = 0
        with open(fai, "r", encoding="utf-8") as fin:
            for line in fin:
                total += int(line.split("\t")[1])
        sizes[name] = total
    return sizes


def ng50(lengths, target_total: float) -> int:
    """Length at which the cumulative sorted-desc sum crosses half of
    target_total (analysis_scripts/denovo_synteny_block_stats.py:44-52)."""
    half = target_total * 0.5
    acc = 0
    for ln in sorted(lengths, reverse=True):
        acc += ln
        if acc >= half:
            return ln
    return 0


def compute_stats(blocks_tsv: str, fai_paths) -> dict:
    lengths, tallies = read_blocks(blocks_tsv)
    sizes = genome_sizes_from_fais(fai_paths)
    n_asm = len(fai_paths)

    def all_asm_lengths(asm):
        return [ln for ln, b in lengths[asm] if tallies[b] >= n_asm]

    per_asm = {asm: [ln for ln, _ in lens] for asm, lens in lengths.items()}
    num_blocks = sum(len(v) for v in per_asm.values()) / n_asm
    num_blocks_all = sum(len(all_asm_lengths(a)) for a in lengths) / n_asm
    total_length = sum(sum(v) for v in per_asm.values()) / n_asm
    avg_cov = sum(sum(per_asm[a]) / sizes[a] * 100 for a in per_asm) / n_asm
    avg_cov_all = sum(sum(all_asm_lengths(a)) / sizes[a] * 100 for a in lengths) / n_asm
    min_size, min_asm = min((sz, a) for a, sz in sizes.items())
    cov_min = sum(per_asm[min_asm]) / min_size * 100 if min_asm in per_asm else 0.0
    avg_len = sum(float(np.mean(v)) for v in per_asm.values()) / n_asm
    med_len = sum(float(np.median(v)) for v in per_asm.values()) / n_asm
    avg_ng50 = sum(ng50(per_asm[a], sizes[a]) for a in per_asm) / n_asm
    avg_n50 = sum(ng50(v, sum(v)) for v in per_asm.values()) / n_asm
    return dict(
        Number_blocks=int(num_blocks),
        Number_blocks_all_asm=int(num_blocks_all),
        Average_coverage=avg_cov,
        Average_coverage_all_asm=avg_cov_all,
        Coverage_min_genome_size=cov_min,
        Average_length=avg_len,
        Median_length=med_len,
        Total_length=total_length,
        NG50_length=int(avg_ng50),
        N50_length=int(avg_n50),
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="Compute de novo stats on synteny blocks")
    parser.add_argument("--tsv", required=True, help="ntSynt-format synteny block TSV")
    parser.add_argument("--fai", required=True, nargs="+", help="FAI files of compared genomes")
    args = parser.parse_args(argv)
    stats = compute_stats(args.tsv, args.fai)
    print(*stats.keys(), sep="\t")
    print(
        f"{stats['Number_blocks']}\t{stats['Number_blocks_all_asm']}\t"
        f"{stats['Average_coverage']}\t{stats['Average_coverage_all_asm']}\t"
        f"{stats['Coverage_min_genome_size']}\t{stats['Average_length']}\t"
        f"{stats['Median_length']}\t{stats['Total_length']}\t"
        f"{stats['NG50_length']}\t{stats['N50_length']}"
    )


if __name__ == "__main__":
    main()
