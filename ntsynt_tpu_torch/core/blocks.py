"""Synteny-block machinery (array-backed SyntenyBlock/AssemblyBlock).

Replaces the reference's per-minimizer Python object model
(bin/synteny_block.py, bin/assembly_block.py) with per-block NumPy
arrays: one Block holds the shared minimizer path plus an
[n_assemblies, L] position matrix, so orientation votes, indel scans and
coordinate queries are vectorized. Semantics are kept exactly:

  * start = min(first, last position), end = max + k
    (assembly_block.py:17-23)
  * orientation: all-increasing '+', all-decreasing '-', else m% vote
    (synteny_block.py:48-65)
  * lexicographic sort by (contig, start) of the lexicographically
    smallest assembly (synteny_block.py:102-109)
  * 7/8-column TSV rows sorted by assembly name, with the .k<k>.w<w>.tsv
    suffix stripped (synteny_block.py:72-85)
"""

from dataclasses import dataclass, field
import re

import numpy as np

_TSV_SUFFIX_RE = re.compile(r"^(\S+)\.k\d+\.w\d+\.tsv$")


def strip_assembly_key(key: str) -> str:
    """TSV filename -> fasta name, like synteny_block.py:75-77."""
    m = _TSV_SUFFIX_RE.search(key)
    return m.group(1) if m else key


@dataclass
class Block:
    """One synteny block: a shared minimizer path across all assemblies.

    Assemblies are indexed in canonical FILES order; `names[a]` is the
    assembly key, `ctg[a]` the per-assembly contig index, `pos[a, i]`
    the position of minimizer i in assembly a.
    """

    mx: np.ndarray  # uint64 [L]
    pos: np.ndarray  # int64 [n_asm, L]
    ctg: np.ndarray  # int32 [n_asm]
    k: int
    ori: list = field(default_factory=list)  # per-assembly '+'/'-'/'?'
    broken_reason: str | None = None

    @property
    def n_minimizers(self) -> int:
        return self.mx.shape[0]

    def starts(self) -> np.ndarray:
        """Per-assembly block start (assembly_block.py:17-19)."""
        return np.minimum(self.pos[:, 0], self.pos[:, -1])

    def ends(self) -> np.ndarray:
        """Per-assembly block end (assembly_block.py:21-23)."""
        return np.maximum(self.pos[:, 0], self.pos[:, -1]) + self.k

    def lengths(self) -> np.ndarray:
        return self.ends() - self.starts()

    def determine_orientations(self, m_threshold: float) -> None:
        """Orientation vote per assembly (synteny_block.py:48-65)."""
        self.ori = []
        d = np.sign(np.diff(self.pos.astype(np.int64), axis=1))
        for a in range(self.pos.shape[0]):
            da = d[a]
            if (da > 0).all():
                self.ori.append("+")
            elif (da < 0).all():
                self.ori.append("-")
            else:
                pos_perc = float((da > 0).sum()) / len(da) * 100.0
                if pos_perc >= m_threshold:
                    self.ori.append("+")
                elif 100.0 - pos_perc >= m_threshold:
                    self.ori.append("-")
                else:
                    self.ori.append("?")

    def all_oriented(self) -> bool:
        return all(o in ("+", "-") for o in self.ori)

    def slice(self, begin: int, end: int) -> "Block":
        """Sub-block on minimizer index range [begin, end)."""
        return Block(
            mx=self.mx[begin:end],
            pos=self.pos[:, begin:end],
            ctg=self.ctg,
            k=self.k,
            ori=list(self.ori),
            broken_reason=None,
        )


class BlockSet:
    """All blocks of a round plus the assembly naming context."""

    def __init__(self, assembly_keys, contig_names_per_asm, k: int):
        self.keys = list(assembly_keys)  # canonical FILES order
        self.contig_names = contig_names_per_asm  # list of per-asm name lists
        self.k = k
        # output rows are sorted by assembly key; precompute that order
        self.print_order = sorted(range(len(self.keys)), key=lambda a: self.keys[a])
        self.smallest_asm = self.print_order[0]

    def contig_name(self, a: int, ctg_idx: int) -> str:
        return self.contig_names[a][ctg_idx]

    # -- ordering (synteny_block.py:102-109) ---------------------------
    def sort_key(self, block: Block):
        a = self.smallest_asm
        return (
            self.contig_name(a, int(block.ctg[a])),
            int(min(block.pos[a, 0], block.pos[a, -1])),
        )

    def sorted_blocks(self, blocks):
        return sorted(blocks, key=self.sort_key)

    # -- serialization (synteny_block.py:72-85) ------------------------
    def block_rows(self, block: Block, num: int, verbose: bool = False):
        rows = []
        starts, ends = block.starts(), block.ends()
        for a in self.print_order:
            name = strip_assembly_key(self.keys[a])
            row = (
                f"{num}\t{name}\t{self.contig_name(a, int(block.ctg[a]))}"
                f"\t{starts[a]}\t{ends[a]}\t{block.ori[a]}\t{block.n_minimizers}"
            )
            if verbose:
                row += f"\t{block.broken_reason}"
            rows.append(row + "\n")
        return "".join(rows)

    def write_blocks_tsv(self, path: str, blocks, min_length: int, verbose: bool = False):
        """Write blocks (already sorted) with the >=z length filter
        applied per assembly (bin/ntsynt_synteny.py:496-503,516-523)."""
        with open(path, "w", encoding="utf-8") as fout:
            num = 0
            for block in blocks:
                if not (block.lengths() >= min_length).all():
                    continue
                fout.write(self.block_rows(block, num, verbose=verbose))
                num += 1
        return path


# ---------------------------------------------------------------------------
# Block construction and refinement transforms
# ---------------------------------------------------------------------------


def blocks_from_path(path_mx, lookup, k: int, m_threshold: float):
    """Turn ONE graph path into its surviving synteny block (scalar
    oracle; production uses blocks_from_paths_batch — the two are
    differential-tested in tests/test_blocks.py).

    Replicates find_synteny_blocks (bin/ntsynt_synteny.py:66-106)
    *including its quirk*: `past_start_flag` is never set there, so when
    a path's contig set changes mid-way, every segment before the LAST
    one is silently discarded (kept out of the output without having its
    nodes removed from the graph). Only the final segment becomes a
    block; it is returned, or its minimizer hashes are returned for
    removal if its orientation vote fails. With the default minimum edge
    weight (= #assemblies) a path can never change contigs mid-way, so
    the quirk is unreachable — but we mirror it for non-default -n runs.

    Args:
      path_mx: uint64 [L] ordered minimizer hashes.
      lookup: callable(hashes u64[L]) -> (ctg int32 [n_asm, L],
        pos int64 [n_asm, L]) in canonical FILES order.
      k, m_threshold: block parameters.

    Returns:
      (block or None, to_remove_hashes or None)
    """
    ctg, pos = lookup(path_mx)
    # find the last contig-change point in any assembly
    if ctg.shape[1] > 1:
        change = (ctg[:, 1:] != ctg[:, :-1]).any(axis=0)
        change_points = np.where(change)[0]
        start = int(change_points[-1]) + 1 if len(change_points) else 0
    else:
        start = 0
    block = Block(
        mx=path_mx[start:],
        pos=pos[:, start:],
        ctg=ctg[:, start].astype(np.int32),
        k=k,
    )
    block.determine_orientations(m_threshold)
    if block.all_oriented():
        return block, None
    return None, block.mx


def blocks_from_paths_batch(paths, lookup, rep_a: int, k: int, m_threshold: float):
    """Vectorized find_synteny_blocks over ALL paths at once
    (bin/ntsynt_synteny.py:543-546 + 66-106 semantics, incl. the
    past_start_flag quirk and the representative-ascends direction
    normalization). One batched ``lookup`` over the concatenation of all
    paths replaces the per-path lookups (each a searchsorted over every
    assembly's full minimizer table — the dominant cost at ~10^5 paths),
    and the trim/orientation votes run as segmented NumPy reductions.

    Args:
      paths: list of uint64 arrays (ordered minimizer hashes).
      lookup: callable(hashes u64[T]) -> (ctg int32 [n_asm, T],
        pos int64 [n_asm, T]) in canonical FILES order.
      rep_a: FILES index of the representative (lexicographically
        smallest) assembly; paths are flipped so it ascends.
      k, m_threshold: block parameters.

    Returns (blocks, to_remove_hashes): surviving Blocks in path order
    plus the concatenated minimizers of orientation-vote failures.
    """
    paths = [np.asarray(p, dtype=np.uint64) for p in paths if len(p) >= 2]
    if not paths:
        return [], np.zeros(0, np.uint64)
    lens = np.asarray([len(p) for p in paths], dtype=np.int64)
    off = np.concatenate([[0], np.cumsum(lens)])
    cat = np.concatenate(paths)
    t = len(cat)
    n_paths = len(paths)
    pid = np.repeat(np.arange(n_paths, dtype=np.int64), lens)

    ctg, pos = lookup(cat)

    # -- direction normalization: representative assembly ascends ------
    first, last = off[:-1], off[1:] - 1
    flip = pos[rep_a, first] > pos[rep_a, last]
    if flip.any():
        idx = np.arange(t, dtype=np.int64)
        rev = off[pid] + (off[pid + 1] - 1) - idx
        idx = np.where(flip[pid], rev, idx)
        cat, ctg, pos = cat[idx], ctg[:, idx], pos[:, idx]

    # -- past_start_flag quirk: keep only the segment after the LAST
    #    contig change in any assembly ------------------------------
    internal = pid[1:] == pid[:-1]  # adjacency (i, i+1) within one path
    chg = (ctg[:, 1:] != ctg[:, :-1]).any(axis=0) & internal
    seg_start = off[:-1].copy()
    cps = np.where(chg)[0]
    if len(cps):
        np.maximum.at(seg_start, pid[cps], cps + 1)

    # -- orientation votes (synteny_block.py:48-65), segmented ---------
    live = internal.copy()
    live[np.arange(t - 1) < seg_start[pid[:-1]]] = False  # pre-trim diffs
    # segmented counts via add.reduceat over int32 (bincount with float
    # weights materialized three 8 B/pair float64 temps per assembly);
    # cross-path pairs contribute 0 through the live mask
    seg_idx = off[:-1]
    n_d = np.add.reduceat(live.astype(np.int32), seg_idx).astype(np.int64)
    n_pos = np.empty((pos.shape[0], n_paths), dtype=np.int64)
    n_neg = np.empty_like(n_pos)
    for a in range(pos.shape[0]):  # per assembly (few), not per path
        inc = (pos[a, 1:] > pos[a, :-1]) & live
        dec = (pos[a, 1:] < pos[a, :-1]) & live
        n_pos[a] = np.add.reduceat(inc.astype(np.int32), seg_idx)
        n_neg[a] = np.add.reduceat(dec.astype(np.int32), seg_idx)
    all_inc = n_pos == n_d  # vacuously '+' when n_d == 0, like .all()
    all_dec = (n_neg == n_d) & (n_d > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        pos_perc = np.where(n_d > 0, n_pos / np.maximum(n_d, 1) * 100.0, 100.0)
    vote_plus = pos_perc >= m_threshold
    vote_minus = (100.0 - pos_perc) >= m_threshold
    ori_code = np.where(
        all_inc, 0, np.where(all_dec, 1, np.where(vote_plus, 0, np.where(vote_minus, 1, 2)))
    )  # 0='+', 1='-', 2='?'
    oriented = (ori_code != 2).all(axis=0)

    ori_chars = np.array(["+", "-", "?"])
    # one fancy-index + tolist for ALL paths (a per-path
    # ori_chars[...].tolist() costs ~5 us x 10^5 paths)
    ori_lists = ori_chars[ori_code.T].tolist()
    seg_start_l = seg_start.tolist()
    end_l = off[1:].tolist()
    ctg_starts = ctg[:, seg_start].astype(np.int32).T  # [n_paths, n_asm]
    oriented_l = oriented.tolist()
    blocks, removed = [], []
    for p in range(n_paths):
        s, e = seg_start_l[p], end_l[p]
        block = Block(
            mx=cat[s:e],
            pos=pos[:, s:e],
            ctg=ctg_starts[p],
            k=k,
            ori=ori_lists[p],
        )
        if oriented_l[p]:
            blocks.append(block)
        else:
            removed.append(block.mx)
    removed = np.concatenate(removed) if removed else np.zeros(0, np.uint64)
    return blocks, removed


def check_for_indels(blocks, bp: int):
    """Break blocks at indel positions (bin/ntsynt_synteny.py:364-409).

    A break occurs between minimizers i, i+1 when the spread of
    per-assembly interarrival distances exceeds bp. Returns
    (new_blocks, removed_edge_hash_pairs).

    Batched: ONE segmented spread test over the concatenation of all
    blocks (a per-block numpy loop cost ~2 s at the 10^5-block stress
    scale, tests/test_scale.py); only blocks that actually break pay
    per-block Python.
    """
    if not blocks:
        return [], []
    lens = np.asarray([b.n_minimizers for b in blocks], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    cat_pos = np.concatenate([b.pos for b in blocks], axis=1).astype(np.int64, copy=False)
    bid = np.repeat(np.arange(len(blocks), dtype=np.int64), lens)
    internal = bid[1:] == bid[:-1]
    d = np.abs(np.diff(cat_pos, axis=1))
    spread = d.max(axis=0) - d.min(axis=0)
    brk = internal & (spread > bp)
    if not brk.any():
        return list(blocks), []
    cat_mx = np.concatenate([b.mx for b in blocks])
    brk_idx = np.flatnonzero(brk)
    removed_edges = list(
        zip(cat_mx[brk_idx].tolist(), cat_mx[brk_idx + 1].tolist())
    )
    breaks_per_block = np.split(brk_idx, np.searchsorted(brk_idx, offs[1:-1]))
    out = []
    for b, (o, blk_breaks) in zip(blocks, zip(offs[:-1], breaks_per_block)):
        if len(blk_breaks) == 0:
            out.append(b)
            continue
        bounds = [0] + (blk_breaks - o + 1).tolist() + [b.n_minimizers]
        for b0, b1 in zip(bounds, bounds[1:]):
            out.append(b.slice(b0, b1))
    return out, removed_edges


def filter_blocks_min_mx(blocks, mx_threshold: int):
    """Drop blocks with fewer than mx_threshold minimizers
    (bin/ntsynt_synteny.py:411-426). Returns (kept, removed_hashes)."""
    kept, removed = [], []
    for block in blocks:
        if block.n_minimizers >= mx_threshold:
            kept.append(block)
        else:
            removed.extend(block.mx.tolist())
    return kept, removed


def _difference_between(b1: Block, b2: Block, a: int) -> int:
    """Gap on assembly a (get_difference_between_blocks,
    bin/ntsynt_synteny.py:428-432)."""
    s1, e1 = int(min(b1.pos[a, 0], b1.pos[a, -1])), int(max(b1.pos[a, 0], b1.pos[a, -1])) + b1.k
    s2, e2 = int(min(b2.pos[a, 0], b2.pos[a, -1])), int(max(b2.pos[a, 0], b2.pos[a, -1])) + b2.k
    if b1.ori[a] == "-" and b2.ori[a] == "-":
        return s1 - e2
    return s2 - e1


def merge_collinear_blocks(blocks, bp: int, k: int, collinear_merge: int):
    """Merge consecutive collinear blocks (bin/ntsynt_synteny.py:434-472).

    Blocks must arrive in final sorted order. Records broken_reason on
    each block that starts a new run (id_change / ori_change /
    inconsistent_order / indel / merge).
    """
    if not blocks:
        return []
    out = []
    curr = blocks[0]
    n_asm = curr.pos.shape[0]
    for block in blocks[1:]:
        same_ori = all(curr.ori[a] == block.ori[a] for a in range(n_asm))
        same_ctg = all(int(curr.ctg[a]) == int(block.ctg[a]) for a in range(n_asm))
        diffs = [_difference_between(curr, block, a) for a in range(n_asm)]
        if (
            not same_ori
            or not same_ctg
            or (max(diffs) - min(diffs) > bp - k)
            or max(diffs) >= collinear_merge
        ):
            if not same_ctg:
                block.broken_reason = "id_change"
            elif not same_ori:
                block.broken_reason = "ori_change"
            elif any(d < 0 for d in diffs):
                block.broken_reason = "inconsistent_order"
            elif max(diffs) - min(diffs) > bp - k:
                block.broken_reason = "indel"
            elif max(diffs) >= collinear_merge:
                block.broken_reason = "merge"
            out.append(curr)
            curr = block
        else:
            curr = Block(
                mx=np.concatenate([curr.mx, block.mx]),
                pos=np.concatenate([curr.pos, block.pos], axis=1),
                ctg=curr.ctg,
                k=curr.k,
                ori=list(curr.ori),
                broken_reason=curr.broken_reason,
            )
    out.append(curr)
    return out
