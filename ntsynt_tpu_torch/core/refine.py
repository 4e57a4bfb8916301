"""Refinement-round helpers: masking, interval indexes, candidate filters.

Implements the coarse-to-fine w_rounds machinery of
refine_block_coordinates (bin/ntsynt_synteny.py:476-541) without the
reference's bedtools/seqtk/indexlr subprocess round-trips: masking is
interval arithmetic on the packed code arrays, the NCLS interval store
is a sorted-array index, and re-sketching calls the device sketcher on
the masked codes.
"""

from collections import defaultdict

import numpy as np


class IntervalIndex:
    """Sorted-interval overlap index (replaces ncls.NCLS,
    bin/ntsynt_synteny.py:222-226). Half-open [start, end) semantics."""

    def __init__(self, starts, ends):
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        order = np.argsort(starts, kind="stable")
        self.starts = starts[order]
        self.cummax_end = np.maximum.accumulate(ends[order]) if len(ends) else ends

    def has_overlap(self, start: int, end: int) -> bool:
        """True iff any stored [s, e) intersects [start, end)."""
        idx = np.searchsorted(self.starts, end, side="left")
        return idx > 0 and int(self.cummax_end[idx - 1]) > start

    def has_overlap_vec(self, starts, ends):
        idx = np.searchsorted(self.starts, np.asarray(ends, np.int64), side="left")
        prior_max = np.where(idx > 0, self.cummax_end[np.maximum(idx - 1, 0)], np.int64(-(1 << 62)))
        return (idx > 0) & (prior_max > np.asarray(starts, np.int64))


def find_mx_in_blocks(blocks, assembly_keys):
    """Terminal/internal minimizer sets + per-(assembly, contig) interval
    index of block interiors (bin/ntsynt_synteny.py:205-226).

    Returns (terminal_mx set-as-array, internal_mx sorted array,
    intervals: dict (asm_idx, ctg_idx) -> IntervalIndex).
    """
    terminal = []
    internal = []
    pending = defaultdict(lambda: ([], []))  # (a, ctg) -> (starts, ends)
    for block in blocks:
        terminal.append(int(block.mx[0]))
        terminal.append(int(block.mx[-1]))
        if block.n_minimizers > 2:
            internal.extend(block.mx[1:-1].tolist())
        for a in range(block.pos.shape[0]):
            p0, p1 = int(block.pos[a, 0]), int(block.pos[a, -1])
            start, end = (p0, p1) if p0 <= p1 else (p1, p0)
            if end - start < 2:  # too short to store (update_intervals :195-203)
                continue
            st, en = pending[(a, int(block.ctg[a]))]
            st.append(start + 1)
            en.append(end)
    intervals = {key: IntervalIndex(st, en) for key, (st, en) in pending.items()}
    return (
        np.asarray(terminal, dtype=np.uint64),
        np.unique(np.asarray(internal, dtype=np.uint64)),
        intervals,
    )


def synteny_mask_intervals(blocks, n_asm: int, prev_w: int, k: int):
    """Per-assembly mask intervals from block extents
    (get_synteny_bed_lists + mask_assemblies_with_synteny_extents,
    bin/ntsynt_synteny.py:118-157).

    Only extents longer than max(2*prev_w, prev_w+k+1) are considered;
    each is shrunk by (prev_w + k) on both sides (the reference's
    negative bedtools slop), and degenerate results are skipped. Returns
    a list (per assembly) of dict ctg_idx -> list[(mask_start, mask_end)].
    """
    min_len = max(2 * prev_w, prev_w + k + 1)
    shrink = prev_w + k
    out = [defaultdict(list) for _ in range(n_asm)]
    for block in blocks:
        starts, ends = block.starts(), block.ends()
        for a in range(n_asm):
            s, e = int(starts[a]), int(ends[a])
            if e - s > min_len:
                ms, me = s + shrink, e - shrink
                if me > ms:
                    out[a][int(block.ctg[a])].append((ms, me))
    return out


def apply_mask(genome, mask_by_ctg) -> np.ndarray:
    """Return a masked copy of genome.codes with intervals set to N-code
    (replaces BedTool.mask_fasta + seqtk round-trip,
    bin/ntsynt_synteny.py:144-154)."""
    codes = genome.codes.copy()
    for ctg_idx, ivs in mask_by_ctg.items():
        off = int(genome.offsets[ctg_idx])
        ln = int(genome.lengths[ctg_idx])
        for s, e in ivs:
            s = max(0, min(s, ln))
            e = max(0, min(e, ln))
            if e > s:
                codes[off + s : off + e] = 4
    return codes


def condensed_genome(genome, mask_by_ctg, w: int, k: int):
    """A compacted stand-in for the masked genome, sketch-equivalent.

    Re-sketching rounds only produce minimizers from unmasked material,
    but the masked copy is still genome-sized; at w=10 on mammal-scale
    genomes the device sweeps ~90% dead sequence. This builds a small
    synthetic genome holding just the live material, exactly preserving
    indexlr-over-masked-fasta window semantics:

      * masks shorter than w+k bases stay INLINE as N runs (windows can
        span them, selecting valid k-mers on both sides);
      * masks of >= w+k bases split segments (no window spans them), and
        each cut boundary is padded with w+k-2 N bases so the partial
        windows that slide into the mask in the original coordinate
        system exist as full windows of the synthetic contig;
      * true contig ends get no padding (indexlr emits no partial
        windows there).

    Returns (synthetic PackedGenome, seg_ctg int32 [n_segs], seg_off
    int64 [n_segs]) with original_position = synthetic_position +
    seg_off[synthetic_contig].
    """
    from ..io.fasta import PackedGenome

    long_mask = w + k
    pad = w + k - 2
    seg_codes, seg_ctg, seg_off, names = [], [], [], []
    for ci in range(genome.n_contigs):
        ln = int(genome.lengths[ci])
        if ln <= 0:
            continue
        base = int(genome.offsets[ci])
        ivs = sorted(
            (max(0, min(s, ln)), max(0, min(e, ln)))
            for s, e in mask_by_ctg.get(ci, [])
            if min(e, ln) > max(s, 0)
        )
        # merge overlapping masks
        merged = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        long_runs = [(s, e) for s, e in merged if e - s >= long_mask]
        cuts = [0] + [x for s, e in long_runs for x in (s, e)] + [ln]
        for a, b in zip(cuts[::2], cuts[1::2]):
            if b - a < k:  # no k-mer can fit
                continue
            piece = genome.codes[base + a : base + b].copy()
            # short masks inside stay as N runs
            for s, e in merged:
                if e - s < long_mask and e > a and s < b:
                    piece[max(s, a) - a : min(e, b) - a] = 4
            lp = pad if a > 0 else 0
            rp = pad if b < ln else 0
            if lp or rp:
                piece = np.concatenate(
                    [np.full(lp, 4, np.uint8), piece, np.full(rp, 4, np.uint8)]
                )
            seg_codes.append(piece)
            seg_ctg.append(ci)
            seg_off.append(a - lp)
            names.append(f"seg{len(names)}")
    if not seg_codes:
        seg_codes = [np.zeros(0, np.uint8)]
        seg_ctg, seg_off, names = [0], [0], ["seg0"]
    lengths = np.asarray([len(c) for c in seg_codes], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    synthetic = PackedGenome(
        path=genome.path + ".condensed",
        name=genome.name,
        contig_names=names,
        lengths=lengths,
        offsets=offsets,
        codes=np.concatenate(seg_codes),
        raw=None,
        fai_offsets=np.zeros(len(names), np.int64),
        fai_linebases=lengths.copy(),
        fai_linewidth=lengths + 1,
    )
    return (
        synthetic,
        np.asarray(seg_ctg, dtype=np.int32),
        np.asarray(seg_off, dtype=np.int64),
    )


def filter_new_minimizer_lists(per_ctg_lists, black_list, intervals_for_asm, contig_of_list):
    """filter_minimizers_synteny_blocks for one assembly
    (bin/ntsynt_synteny.py:256-280).

    Walks each new per-contig minimizer list (hashes + positions),
    dropping minimizers that are in the black list (existing internal
    minimizers) or positioned inside an existing block interior, and
    splitting a list whenever the segment between the previous kept
    minimizer and the current one overlaps a block interior.

    Args:
      per_ctg_lists: list of (hashes u64[m], pos int64[m]) per contig.
      black_list: sorted uint64 array of internal minimizers.
      intervals_for_asm: dict ctg_idx -> IntervalIndex.
      contig_of_list: contig index per input list.

    Returns list of uint64 segment arrays (order preserved).
    """
    segments = []
    for (hashes, pos), ctg_idx in zip(per_ctg_lists, contig_of_list):
        iv = intervals_for_asm.get(int(ctg_idx))
        if len(black_list):
            loc = np.searchsorted(black_list, hashes)
            loc = np.minimum(loc, len(black_list) - 1)
            in_black = black_list[loc] == hashes
        else:
            in_black = np.zeros(len(hashes), dtype=bool)
        if iv is not None:
            in_block = iv.has_overlap_vec(pos, pos + 1)
        else:
            in_block = np.zeros(len(hashes), dtype=bool)

        keep = ~in_black & ~in_block
        kept_h = hashes[keep]
        kept_p = pos[keep]
        if iv is None or len(kept_h) < 2:
            segments.append(kept_h.astype(np.uint64))
            continue
        # Positions within a contig list are ascending, so the reference's
        # per-minimizer walk (which checks every minimizer — kept or
        # dropped — against the last KEPT one and splits on the first
        # overlap) reduces to: split between consecutive kept minimizers
        # (A, B) iff [A.pos, B.pos) overlaps a block interior. Any
        # triggering sub-interval [A.pos, M.pos) is contained in it, so
        # the outcomes coincide exactly.
        split_after = iv.has_overlap_vec(kept_p[:-1], kept_p[1:])
        bounds = np.where(split_after)[0] + 1
        for seg in np.split(kept_h, bounds):
            segments.append(seg.astype(np.uint64))
    return segments
