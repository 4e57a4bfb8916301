"""Per-assembly minimizer indexes (ntjoin read/filter semantics).

Reconstructs the missing ntJoin layer's data contracts
(SURVEY.md §2.4) with vectorized NumPy:

  * read_minimizers: per-contig ordered minimizer lists with
    within-assembly duplicate hashes dropped entirely;
  * filter_minimizers: keep only minimizers present in ALL assemblies;
  * list_mx_info: hash -> (contig, position), updatable across
    refinement rounds (update_list_mx_info, bin/ntsynt_synteny.py:282-290).

Assembly keys are the genome file basenames (the reference keys by the
sketch TSV filename; we strip the .k<k>.w<w>.tsv suffix at print time
either way, so the basename is the stable identity).
"""

from dataclasses import dataclass

import numpy as np


def _dedupe_mask(hashes: np.ndarray) -> np.ndarray:
    """True where the hash occurs exactly once in the array."""
    uniq, counts = np.unique(hashes, return_counts=True)
    dup = uniq[counts > 1]
    if len(dup) == 0:
        return np.ones(len(hashes), dtype=bool)
    loc = np.searchsorted(dup, hashes)
    loc = np.minimum(loc, len(dup) - 1)
    return dup[loc] != hashes


def _membership(hashes: np.ndarray, sorted_set: np.ndarray) -> np.ndarray:
    if len(sorted_set) == 0:
        return np.zeros(len(hashes), dtype=bool)
    loc = np.searchsorted(sorted_set, hashes)
    loc = np.minimum(loc, len(sorted_set) - 1)
    return sorted_set[loc] == hashes


def _split_lists(hashes: np.ndarray, cidx: np.ndarray, n_contigs: int) -> list:
    """Per-contig hash lists from (contig, position)-ordered flat arrays
    — one searchsorted over the sorted contig column instead of a
    boolean mask per contig (O(C*M) -> O(M + C log M); refinement-round
    condensed genomes and stress-scale inputs have 10^4+ segments)."""
    bounds = np.searchsorted(cidx, np.arange(1, n_contigs))
    return np.split(hashes, bounds)


@dataclass
class MxInfo:
    """hash -> (contig index, position) lookup for one assembly."""

    sorted_hash: np.ndarray  # uint64 [M], sorted
    ctg: np.ndarray  # int32 [M] aligned with sorted_hash
    pos: np.ndarray  # int64 [M]

    @classmethod
    def from_arrays(cls, hashes, ctg, pos) -> "MxInfo":
        """Build from parallel arrays. ``hashes`` MUST be duplicate-free:
        lookup()'s >=2^18 sort-merge fast path resolves table duplicates
        last-write-wins while the searchsorted path returns the first
        match, so duplicates would make results batch-size-dependent.
        All construction paths dedupe first (read_minimizers semantics);
        this check keeps a future caller from silently violating that."""
        return cls.from_arrays_with_order(hashes, ctg, pos)[0]

    @classmethod
    def from_arrays_with_order(cls, hashes, ctg, pos):
        """from_arrays that also returns the argsort permutation, so
        callers holding the pre-sort layout (AssemblyMinimizers.lists)
        can reuse it (filter_common's sorted-view cache)."""
        sh = np.asarray(hashes, np.uint64)
        order = np.argsort(sh, kind="stable")
        sh = sh[order]
        if len(sh) > 1 and (sh[1:] == sh[:-1]).any():
            raise ValueError("MxInfo.from_arrays requires duplicate-free hashes")
        return (
            cls(
                sh,
                np.asarray(ctg, np.int32)[order],
                np.asarray(pos, np.int64)[order],
            ),
            order,
        )

    def lookup(self, hashes):
        """Vectorized lookup; raises KeyError on a missing hash.

        Large batches switch to a sort-merge join: binary-searching 10^6
        random-order queries costs ~20 random DRAM touches each, while
        sorting the queries once and scanning the (already sorted) table
        with ascending probes is cache-sequential — ~3x faster at the
        6M-node stress scale (tests/test_scale.py)."""
        hashes = np.asarray(hashes, dtype=np.uint64)
        n = len(self.sorted_hash)
        if len(hashes) == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int64)
        if n == 0:
            raise KeyError("minimizer hash not in mx_info")
        if len(hashes) >= (1 << 18):
            uq, inv = np.unique(hashes, return_inverse=True)
            ctg_u, pos_u = self.lookup_unique_sorted(uq)
            return ctg_u[inv], pos_u[inv]
        loc = np.searchsorted(self.sorted_hash, hashes)
        if ((loc >= n) | (self.sorted_hash[np.minimum(loc, n - 1)] != hashes)).any():
            raise KeyError("minimizer hash not in mx_info")
        return self.ctg[loc], self.pos[loc]

    def lookup_unique_sorted(self, uq):
        """Sort-merge lookup of an already-sorted duplicate-free query
        array (the >=2^18 fast path of lookup(), with the query sort
        hoisted so multi-assembly callers pay it once — see
        SyntenyDetector._lookup)."""
        loc_u = np.minimum(np.searchsorted(uq, self.sorted_hash), len(uq) - 1)
        hit = uq[loc_u] == self.sorted_hash  # ascending probes
        tgt = loc_u[hit]
        ctg_u = np.empty(len(uq), np.int32)
        pos_u = np.empty(len(uq), np.int64)
        found = np.zeros(len(uq), dtype=bool)
        ctg_u[tgt] = self.ctg[hit]
        pos_u[tgt] = self.pos[hit]
        found[tgt] = True
        if not found.all():
            raise KeyError("minimizer hash not in mx_info")
        return ctg_u, pos_u

    def update(self, hashes, ctg, pos) -> "MxInfo":
        """Merge in new entries; on duplicate hash the NEW value wins
        (update_list_mx_info overwrites, bin/ntsynt_synteny.py:287-290)."""
        if len(hashes) == 0:
            return self
        old_keep = ~_membership(self.sorted_hash, np.unique(np.asarray(hashes, np.uint64)))
        return MxInfo.from_arrays(
            np.concatenate([self.sorted_hash[old_keep], np.asarray(hashes, np.uint64)]),
            np.concatenate([self.ctg[old_keep], np.asarray(ctg, np.int32)]),
            np.concatenate([self.pos[old_keep], np.asarray(pos, np.int64)]),
        )


@dataclass
class AssemblyMinimizers:
    """One assembly's sketch, post read_minimizers semantics."""

    key: str  # assembly key (genome basename)
    contig_names: list
    # per-contig ordered, deduped minimizer hashes / positions
    lists: list  # list of uint64 arrays (one per contig, contig order)
    mx_info: MxInfo
    genome: object | None = None  # io.fasta.PackedGenome when available
    # argsort permutation of concat(lists) (== the mx_info table order)
    # from construction; filter_common reuses it while lists are intact
    sort_order: np.ndarray | None = None
    # per-contig positions aligned with `lists` (construction layout);
    # refinement rounds read these instead of per-contig mx_info
    # lookups (10^3-10^4 binary-search batches per round otherwise)
    pos_lists: list | None = None

    @classmethod
    def from_sketch(cls, sk, genome=None) -> "AssemblyMinimizers":
        """Build from ops.sketch.GenomeSketch."""
        hashes, cidx, pos = sk.hashes, sk.contig_idx, sk.positions
        keep = _dedupe_mask(hashes)
        hashes, cidx, pos = hashes[keep], cidx[keep], pos[keep]
        lists = _split_lists(hashes, cidx, len(sk.contig_names))
        pos_lists = _split_lists(pos, cidx, len(sk.contig_names))
        mx_info, order = MxInfo.from_arrays_with_order(hashes, cidx, pos)
        return cls(
            key=sk.name,
            contig_names=list(sk.contig_names),
            lists=lists,
            mx_info=mx_info,
            genome=genome,
            sort_order=order,
            pos_lists=pos_lists,
        )

    @classmethod
    def from_arrays(cls, key, contig_names, hashes, cidx, pos, genome=None) -> "AssemblyMinimizers":
        """Build from flat (hash, contig_idx, position) arrays already
        ordered by (contig, position); applies read_minimizers dedupe."""
        hashes = np.asarray(hashes, np.uint64)
        cidx = np.asarray(cidx, np.int32)
        pos = np.asarray(pos, np.int64)
        keep = _dedupe_mask(hashes)
        hashes, cidx, pos = hashes[keep], cidx[keep], pos[keep]
        lists = _split_lists(hashes, cidx, len(contig_names))
        pos_lists = _split_lists(pos, cidx, len(contig_names))
        mx_info, order = MxInfo.from_arrays_with_order(hashes, cidx, pos)
        return cls(
            key=key,
            contig_names=list(contig_names),
            lists=lists,
            mx_info=mx_info,
            genome=genome,
            sort_order=order,
            pos_lists=pos_lists,
        )

    @classmethod
    def from_tsv_records(cls, key, records, genome=None) -> "AssemblyMinimizers":
        """Build from io.sketch_tsv.read_sketch_tsv output."""
        names = [r[0] for r in records]
        hashes = np.concatenate([r[1] for r in records]) if records else np.zeros(0, np.uint64)
        cidx = np.concatenate(
            [np.full(len(r[1]), i, np.int32) for i, r in enumerate(records)]
        ) if records else np.zeros(0, np.int32)
        pos = np.concatenate([r[2] for r in records]) if records else np.zeros(0, np.int64)
        keep = _dedupe_mask(hashes)
        hashes, cidx, pos = hashes[keep], cidx[keep], pos[keep]
        lists = _split_lists(hashes, cidx, len(names))
        pos_lists = _split_lists(pos, cidx, len(names))
        mx_info, order = MxInfo.from_arrays_with_order(hashes, cidx, pos)
        return cls(
            key=key,
            contig_names=names,
            lists=lists,
            mx_info=mx_info,
            genome=genome,
            sort_order=order,
            pos_lists=pos_lists,
        )


def filter_common(assemblies: dict) -> None:
    """Keep only minimizers present in every assembly, in place
    (ntjoin_utils.filter_minimizers contract; SURVEY.md §2.4).

    `assemblies` maps key -> AssemblyMinimizers; each assembly's lists
    are filtered to the cross-assembly intersection. mx_info is left
    as-is (the reference keeps full mx_info too).
    """
    flats = [
        np.concatenate(a.lists) if a.lists else np.zeros(0, np.uint64)
        for a in assemblies.values()
    ]
    # each flat is duplicate-free (read_minimizers dedupe, enforced by
    # MxInfo.from_arrays), so ONE argsort per assembly gives the sorted
    # view for sequential membership probes; successive membership
    # filters replace np.intersect1d (which re-sorts the concatenation).
    # When flat still matches the construction-time arrays, reuse the
    # argsort MxInfo already paid for (a.sort_order).
    orders = [
        a.sort_order
        if a.sort_order is not None and len(a.sort_order) == len(f)
        else np.argsort(f, kind="stable")
        for a, f in zip(assemblies.values(), flats)
    ]
    sorteds = [f[o] for f, o in zip(flats, orders)]
    common = sorteds[0]
    for s in sorteds[1:]:
        common = common[_membership(common, s)]
    for a, flat, order, sf in zip(assemblies.values(), flats, orders, sorteds):
        if not a.lists:
            continue  # keep lists == [] (np.split would yield [empty array])
        # one batched membership + re-split (a per-list loop costs 10^5
        # small searchsorted calls at stress scale)
        lens = np.asarray([len(l) for l in a.lists], dtype=np.int64)
        keep = np.empty(len(flat), dtype=bool)
        keep[order] = _membership(sf, common)
        kept_cum = np.concatenate([[0], np.cumsum(keep)])
        bounds = np.concatenate([[0], np.cumsum(lens)])
        kept_per_list = kept_cum[bounds[1:]] - kept_cum[bounds[:-1]]
        a.lists = np.split(flat[keep], np.cumsum(kept_per_list)[:-1])
        if not keep.all():
            a.sort_order = None  # lists changed; cached order is stale
            a.pos_lists = None  # positions no longer align with lists


def filter_segments_common(segments_per_asm: dict) -> dict:
    """filter_minimizers over refinement segment lists.

    segments_per_asm: key -> list of uint64 arrays (split segments).
    Returns the same structure filtered to the cross-assembly
    intersection (bin/ntsynt_synteny.py:539).
    """
    sets = []
    for segs in segments_per_asm.values():
        flat = np.concatenate(segs) if segs else np.zeros(0, np.uint64)
        sets.append(np.unique(flat))
    common = sets[0]
    for s in sets[1:]:
        common = np.intersect1d(common, s, assume_unique=True)
    return {
        key: [seg[_membership(seg, common)] for seg in segs]
        for key, segs in segments_per_asm.items()
    }
