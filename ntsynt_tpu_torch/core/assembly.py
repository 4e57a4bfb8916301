"""Per-assembly minimizer tables (ntjoin read/filter semantics).

Reconstructs the missing ntJoin layer's data contracts
(SURVEY.md §2.4) with vectorized NumPy:

  * read_minimizers: one flat table per assembly, its hashes, contig
    indexes and positions in (contig, position) order, with
    within-assembly duplicate hashes dropped entirely;
  * filter_minimizers: keep only minimizers present in ALL assemblies.

No hash -> (contig, position) index (ntjoin's) is built: the graph's
nodes carry each assembly's contig and position
(graph/mxgraph.MinimizerGraph), taken from these tables and from each
refinement round's, which is where the reference's merges into that
index (bin/ntsynt_synteny.py:282-290) land.

Assembly keys are the genome file basenames (the reference keys by the
sketch TSV filename; we strip the .k<k>.w<w>.tsv suffix at print time
either way, so the basename is the stable identity).
"""

import contextlib
from dataclasses import dataclass

import numpy as np


def _dedupe_mask(hashes: np.ndarray):
    """(keep, dup_hashes, dropped): True where the hash occurs exactly
    once in the array; how many hashes occur more than once, and how many
    entries hold them (the entries that keep drops)."""
    uniq, counts = np.unique(hashes, return_counts=True)
    repeated = counts > 1
    dup = uniq[repeated]
    if len(dup) == 0:
        return np.ones(len(hashes), dtype=bool), 0, 0
    loc = np.searchsorted(dup, hashes)
    loc = np.minimum(loc, len(dup) - 1)
    return dup[loc] != hashes, len(dup), int(counts[repeated].sum())


def _membership(hashes: np.ndarray, sorted_set: np.ndarray) -> np.ndarray:
    if len(sorted_set) == 0:
        return np.zeros(len(hashes), dtype=bool)
    loc = np.searchsorted(sorted_set, hashes)
    loc = np.minimum(loc, len(sorted_set) - 1)
    return sorted_set[loc] == hashes


@dataclass
class AssemblyMinimizers:
    """One assembly's sketch, post read_minimizers semantics: three
    aligned columns in (contig, position) order, each hash once. Synteny
    filters them to the common minimizers and drops them (None) once the
    first graph holds them."""

    key: str  # assembly key (genome basename)
    contig_names: list
    hashes: np.ndarray  # uint64 [M]
    ctg: np.ndarray  # int32 [M], index into contig_names
    pos: np.ndarray  # int64 [M]
    genome: object | None = None  # io.fasta.PackedGenome when available

    @classmethod
    def from_sketch(cls, sk, genome=None, repeat_canon_filter=None,
                    timer=None) -> "AssemblyMinimizers":
        """Build from ops.sketch.GenomeSketch.

        repeat_canon_filter: optional callable(canon u64[m]) -> bool mask
        of minimizers to DROP (the --filter Filter repeat-BF path,
        bin/ntsynt_synteny.py:605-607). timer: as in from_arrays.
        """
        hashes, cidx, pos = sk.hashes, sk.contig_idx, sk.positions
        if repeat_canon_filter is not None:
            keep = ~repeat_canon_filter(sk.canon)
            hashes, cidx, pos = hashes[keep], cidx[keep], pos[keep]
        return cls.from_arrays(sk.name, sk.contig_names, hashes, cidx, pos, genome, timer)

    @classmethod
    def from_arrays(cls, key, contig_names, hashes, cidx, pos, genome=None, timer=None,
                    tag=None) -> "AssemblyMinimizers":
        """Build from flat (hash, contig_idx, position) arrays already
        ordered by (contig, position); applies read_minimizers dedupe.

        timer: a utils.StageTimer, or None. With one, the dedupe and its
        gathers are the span ``assembly.dedupe:<tag>``, and the counters
        ``assembly.records:<tag>``, ``assembly.dup_dropped:<tag>`` and
        ``assembly.dup_hashes:<tag>`` get the entries in, the entries
        dropped and the hashes found more than once (tag: the key unless
        given; a refinement round's is ``w<w>:<key>``)."""
        tag = tag or key
        span = timer.stage(f"assembly.dedupe:{tag}") if timer else contextlib.nullcontext()
        with span:
            hashes = np.asarray(hashes, np.uint64)
            keep, dup_hashes, dropped = _dedupe_mask(hashes)
            table = cls(
                key=key,
                contig_names=list(contig_names),
                hashes=hashes[keep],
                ctg=np.asarray(cidx, np.int32)[keep],
                pos=np.asarray(pos, np.int64)[keep],
                genome=genome,
            )
        if timer:
            timer.count(f"assembly.records:{tag}", len(hashes))
            timer.count(f"assembly.dup_dropped:{tag}", dropped)
            timer.count(f"assembly.dup_hashes:{tag}", dup_hashes)
        return table

    @classmethod
    def from_tsv_records(
        cls, key, records, genome=None, repeat_out_filter=None, timer=None
    ) -> "AssemblyMinimizers":
        """Build from io.sketch_tsv.read_sketch_tsv output.

        repeat_out_filter: optional callable(printed u64[m]) -> bool mask
        of minimizers to DROP (--filter Filter at TSV load time,
        read_minimizers(repeat_bf), bin/ntsynt_synteny.py:604-607).
        timer: as in from_arrays.
        """
        names = [r[0] for r in records]
        hashes = np.concatenate([r[1] for r in records]) if records else np.zeros(0, np.uint64)
        cidx = np.concatenate(
            [np.full(len(r[1]), i, np.int32) for i, r in enumerate(records)]
        ) if records else np.zeros(0, np.int32)
        pos = np.concatenate([r[2] for r in records]) if records else np.zeros(0, np.int64)
        if repeat_out_filter is not None and len(hashes):
            keep = ~repeat_out_filter(hashes)
            hashes, cidx, pos = hashes[keep], cidx[keep], pos[keep]
        return cls.from_arrays(key, names, hashes, cidx, pos, genome, timer)


def filter_common(hash_arrays) -> list:
    """Keep masks for the minimizers present in every assembly
    (ntjoin_utils.filter_minimizers contract; SURVEY.md §2.4): the first
    graph's and each refinement round's (bin/ntsynt_synteny.py:539).

    `hash_arrays` holds each assembly's hashes, each array
    duplicate-free (read_minimizers dedupe); returns one bool mask per
    array, True where its hash is in the intersection, so each table
    keeps its order.
    """
    # ONE argsort per assembly gives the sorted view for sequential
    # membership probes (np.intersect1d would re-sort the concatenation);
    # the arrays are duplicate-free, so the default sort's order is the
    # only one, and it is several times faster than a stable sort
    orders = [np.argsort(h) for h in hash_arrays]
    sorteds = [h[o] for h, o in zip(hash_arrays, orders)]
    common = sorteds[0]
    for s in sorteds[1:]:
        common = common[_membership(common, s)]
    masks = []
    for order, sf in zip(orders, sorteds):
        keep = np.empty(len(sf), dtype=bool)
        keep[order] = _membership(sf, common)
        masks.append(keep)
    return masks
