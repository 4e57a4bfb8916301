"""The ntSynt synteny-detection algorithm, end-to-end in memory.

Drives the full reference flow (NtSyntSynteny.main_synteny +
refine_block_coordinates, bin/ntsynt_synteny.py:593-647,476-541) over
the device sketcher, the array graph and the array block machinery:

  load sketches -> minimizer graph -> [simplify] -> weight filter ->
  linear paths -> blocks -> indel breaks -> >=4-mx filter -> initial TSV
  -> per w in w_rounds: mask block interiors, re-sketch at w, filter
  candidates, extend graph (terminal black-list), filter (+ erosion on
  the last round), re-extract blocks, write pre-merge TSV; on the last
  round: two-pass collinear merge + final TSV.

Determinism mirrors the reference: assemblies processed in
reverse-sorted key order (bin/ntsynt_synteny.py:34), path direction
normalized so the representative (lexicographically smallest) assembly
ascends — the property observed in every golden block — and block
output lexicographically sorted (synteny_block.py:102-109).
"""

import contextlib
from dataclasses import dataclass
import sys
import time

import numpy as np

from ..graph.mxgraph import MinimizerGraph
from ..ops import sketch as sketch_ops
from ..utils import log
from . import blocks as blk
from . import refine as rf
from .assembly import AssemblyMinimizers, filter_common, filter_segments_common


@dataclass
class SyntenyParams:
    k: int = 24
    w: int = 1000
    n: int = 0  # min edge weight; 0 -> #assemblies (bin/ntsynt_run.py:15)
    m: float = 90.0  # orientation vote threshold (:35-37)
    z: int = 500  # min block size (:20)
    bp: int = 500  # indel threshold (:28-29)
    collinear_merge: str = "1w"  # '<num>w' or bp (:30-32)
    w_rounds: tuple = (100, 10)  # (:26-27)
    simplify_graph: bool = True
    dev: bool = False
    interarrivals: bool = False
    prefix: str = "out"
    # sketching filters: ops.bloom.BloomFilter, HostModBloomFilter or None
    common_bf: object = None
    repeat_bf: object = None
    # None | 'Filter' | 'Indexlr' (bin/ntsynt_run.py:21): 'Indexlr'
    # excludes repeat k-mers from minimizer CANDIDACY in refinement
    # re-sketches (indexlr -r); 'Filter' drops selected minimizers
    # post-hoc (read_minimizers(repeat_bf)). With a repeat_bf and no
    # mode set, 'Indexlr' semantics apply (the initial-sketch -r path).
    repeat_filter: str = None
    # torch device of the refinement-round re-sketches (the filter's)
    device: str = "cuda"
    # a parallel.mesh.Mesh: the refinement re-sketches are sharded over
    # its ranks (selections equal the single-device sketch's); None: one
    # device
    mesh: object = None
    # multi-process runs: every rank computes the same blocks, only
    # rank 0 writes the TSV and dot artifacts (parallel/multihost.py)
    write_output: bool = True

    def resolve_collinear_merge(self) -> int:
        """'<num>w' -> num * w, else bp int (bin/ntsynt_synteny.py:37-42)."""
        s = str(self.collinear_merge)
        if s.endswith("w") and s[:-1].isdigit():
            return int(s[:-1]) * self.w
        if s.isdigit() or (s.startswith("-") and s[1:].isdigit()):
            return int(s)
        raise ValueError(
            "--collinear-merge must be an integer or a string like '<num>w'"
        )


@contextlib.contextmanager
def _substage(label: str):
    """--dev sub-stage wall print: the synteny stage is host-side NumPy
    and grows with genome count x minimizer density; these splits make
    the profile actionable without a profiler run."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log(f"  [synteny] {label}: {time.perf_counter() - t0:.2f}s", dev_only=True)


class SyntenyDetector:
    """One synteny run over N assemblies."""

    def __init__(self, assemblies, params: SyntenyParams):
        """
        Args:
          assemblies: dict key -> AssemblyMinimizers (genomes attached
            when refinement rounds must re-sketch).
          params: SyntenyParams.
        """
        # canonical FILES order: reverse-sorted keys (bin/ntsynt_synteny.py:34)
        self.files = sorted(assemblies.keys(), reverse=True)
        self.assemblies = {k: assemblies[k] for k in self.files}
        self.params = params
        if params.n == 0:
            params.n = len(self.files)
        self.weights = {k: 1 for k in self.files}  # (:32)
        self.max_edge_weight = sum(self.weights.values())
        self.collinear_merge_bp = params.resolve_collinear_merge()
        self.rep = self.files[-1]  # lexicographically smallest assembly
        self.graph = MinimizerGraph.empty()
        self.block_ctx = blk.BlockSet(
            self.files,
            [self.assemblies[k].contig_names for k in self.files],
            params.k,
        )

    # ------------------------------------------------------------------
    # lookups
    # ------------------------------------------------------------------
    def _lookup(self, hashes):
        """(ctg, pos) matrices [n_asm, L] in FILES order.

        Large batches sort/unique the queries ONCE and reuse the sorted
        view for every assembly's sort-merge join (the per-assembly
        np.unique re-sorts were ~2/3 of the lookup cost at the 6M-node
        stress scale). Batch queries that are entirely graph nodes (the
        path concatenation — the only gigabase-sized caller) reuse the
        graph's cached sorted node table instead of re-sorting the
        queries."""
        hashes = np.asarray(hashes, dtype=np.uint64)
        ctgs, poss = [], []
        if len(hashes) >= (1 << 18):
            with _substage("    lookup(batch)"):
                g = self.graph
                g._ensure_lookup()
                sh = g._sorted_hash
                if len(sh):
                    loc = np.minimum(np.searchsorted(sh, hashes), len(sh) - 1)
                    if bool((sh[loc] == hashes).all()):
                        uq, inv = sh, loc  # queries are all graph nodes
                    else:
                        uq, inv = np.unique(hashes, return_inverse=True)
                else:
                    uq, inv = np.unique(hashes, return_inverse=True)
                for key in self.files:
                    c, p = self.assemblies[key].mx_info.lookup_unique_sorted(uq)
                    ctgs.append(c[inv])
                    poss.append(p[inv])
                return np.stack(ctgs), np.stack(poss)
        for key in self.files:
            c, p = self.assemblies[key].mx_info.lookup(hashes)
            ctgs.append(c)
            poss.append(p)
        return np.stack(ctgs), np.stack(poss)

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------
    def make_minimizer_graph(self):
        log("Building the minimizer graph")
        adj = [(k, self.assemblies[k].lists) for k in self.files]
        self.graph = MinimizerGraph.build(adj, self.weights)

    def write_dot(self, path: str, graph=None):
        """Emit the minimizer graph as Graphviz (the reference's
        <prefix>.mx.dot artifact from make_minimizer_graph)."""
        g = self.graph if graph is None else graph
        with open(path, "w", encoding="utf-8") as f:
            f.write("graph {\n")
            f.writelines(
                f'  n{i} [label="{h}"];\n' for i, h in enumerate(g.node_hash)
            )
            f.writelines(
                f"  n{u} -- n{v} [weight={w}];\n"
                for u, v, w in zip(g.eu, g.ev, g.weight)
            )
            f.write("}\n")

    def write_dot_async(self, path: str):
        """Start write_dot on a background thread (gigabase graphs
        format millions of text lines — seconds of host wall that
        nothing downstream waits on); returns the thread. run() joins
        it before returning so the artifact contract holds. The graph is
        snapshotted HERE, on the caller thread: run() reassigns
        self.graph (simplify_bubbles / filter_global) right after
        scheduling, and the artifact must capture the
        make_minimizer_graph output the reference emits."""
        import threading

        g = self.graph  # snapshot before run() reassigns self.graph
        t = threading.Thread(target=self.write_dot, args=(path, g))
        t.start()
        return t

    def paths_to_blocks(self, paths):
        """find_paths_synteny_blocks (bin/ntsynt_synteny.py:543-546),
        batched: ONE lookup over the concatenation of all paths +
        segmented trim/orientation votes (core/blocks.py
        blocks_from_paths_batch) instead of per-path lookups."""
        log("Finding synteny blocks")
        rep_a = self.files.index(self.rep)
        with _substage("  blocks_from_paths"):
            out, removed = blk.blocks_from_paths_batch(
                paths, self._lookup, rep_a, self.params.k, self.params.m
            )
        if len(removed):
            if self.params.dev:
                log(
                    "Not oriented:", len(removed), "minimizers across",
                    len(paths) - len(out), "paths", dev_only=True,
                )
            self.graph = self.graph.delete_nodes_by_hash(removed)
        return out

    def indel_pass(self, blocks):
        """check_for_indels + graph edge removal (bin/ntsynt_synteny.py:391-409)."""
        blocks, removed_edges = blk.check_for_indels(blocks, self.params.bp)
        if removed_edges:
            edge_ids = [self.graph.edge_id(u, v) for u, v in removed_edges]
            self.graph = self.graph.delete_edges(edge_ids)
        return blocks

    def min_mx_pass(self, blocks, threshold=4):
        """filter_synteny_blocks (bin/ntsynt_synteny.py:411-426)."""
        blocks, removed = blk.filter_blocks_min_mx(blocks, threshold)
        if removed:
            self.graph = self.graph.delete_nodes_by_hash(
                np.asarray(removed, dtype=np.uint64)
            )
        return blocks

    # -- erosion (last refinement round) --------------------------------
    def _erode_edges(self, src_idx: int, tgt_idx: int, indptr, eids, other):
        """erode_edges (bin/ntsynt_synteny.py:312-340): walk inward from a
        sub-threshold edge's endpoints while the two frontier minimizers
        physically overlap (< k apart in any assembly), alternating
        sides, collecting incident edges to remove."""
        g = self.graph
        k = self.params.k

        def overlaps(h1, h2):
            _, p = self._lookup(np.asarray([h1, h2], dtype=np.uint64))
            return bool((np.abs(p[:, 0] - p[:, 1]) < k).any())

        erode_target = True
        cur_s, cur_t = src_idx, tgt_idx
        return_edges = set()
        visited = {cur_s, cur_t}
        name_s = int(g.node_hash[cur_s])
        name_t = int(g.node_hash[cur_t])
        while overlaps(name_s, name_t):
            v = cur_t if erode_target else cur_s
            ids_v = eids[indptr[v] : indptr[v + 1]]
            nb_v = other[indptr[v] : indptr[v + 1]]
            return_edges.update(int(e) for e in ids_v)
            candidates = [int(n) for n in nb_v if int(n) not in visited]
            if not candidates:
                break
            if len(candidates) > 1:
                # the reference asserts len==1 here (bin/ntsynt_synteny.py
                # :327, inherently true post-filter in its runs); rather
                # than crash on a degree-3 frontier we continue along the
                # smallest-hash neighbour deterministically and warn
                candidates.sort(key=lambda n: int(g.node_hash[n]))
                print(
                    "WARNING: erosion walk hit a branching frontier node; "
                    "continuing along the smallest-hash neighbour",
                    file=sys.stderr,
                    flush=True,
                )
            nxt = candidates[0]
            visited.add(nxt)
            if erode_target:
                cur_t = nxt
                name_t = int(g.node_hash[cur_t])
            else:
                cur_s = nxt
                name_s = int(g.node_hash[cur_s])
            erode_target = not erode_target
        return return_edges

    def refine_graph_erosion(self, flagged_pairs):
        """refine_graph (bin/ntsynt_synteny.py:343-362).

        flagged_pairs is the (u_hashes, v_hashes) array pair from
        filter_global(flag=True). Both-degree-1 eligibility is computed
        as a vectorized mask FIRST — the last refinement round can flag
        millions of dropped edges at gigabase scale, and only a handful
        survive the degree test — so the Python-level erosion walk loops
        over survivors only (the reference loops all pairs,
        bin/ntsynt_synteny.py:346-358; its scale never hurt)."""
        hu_all, hv_all = flagged_pairs
        if len(hu_all) == 0:
            return
        iu = self.graph.node_index(np.asarray(hu_all, dtype=np.uint64))
        iv = self.graph.node_index(np.asarray(hv_all, dtype=np.uint64))
        deg = self.graph.degree()
        ok = (iu >= 0) & (iv >= 0)
        ok &= deg[np.maximum(iu, 0)] == 1
        ok &= deg[np.maximum(iv, 0)] == 1
        if not ok.any():
            return
        indptr, eids, other = self.graph.incident_csr()
        to_remove = []
        for j in np.where(ok)[0]:
            hu, hv = int(hu_all[j]), int(hv_all[j])
            ju, jv = int(iu[j]), int(iv[j])
            # normalize by hash STRING comparison for determinism (:350-352)
            if str(hu) > str(hv):
                ju, jv = jv, ju
            to_remove.extend(self._erode_edges(ju, jv, indptr, eids, other))
        if to_remove:
            self.graph = self.graph.delete_edges(set(to_remove))

    # ------------------------------------------------------------------
    # refinement rounds
    # ------------------------------------------------------------------
    def generate_additional_minimizers(self, blocks, new_w: int, prev_w: int):
        """generate_additional_minimizers (bin/ntsynt_synteny.py:532-541)."""
        p = self.params
        n_asm = len(self.files)
        mask_ivs = rf.synteny_mask_intervals(blocks, n_asm, prev_w, p.k)
        terminal, internal, intervals = rf.find_mx_in_blocks(blocks, self.files)

        import time as _time

        segments_per_asm = {}
        new_info = {}
        for a, key in enumerate(self.files):
            asm = self.assemblies[key]
            if asm.genome is None:
                raise RuntimeError(
                    f"assembly {key} has no genome attached; refinement "
                    "rounds need the sequences to re-sketch"
                )
            t0 = _time.perf_counter()
            # sketch only the live (unmasked) material: condensed_genome
            # is window-semantics-equivalent to sketching the full
            # masked genome but ~10x smaller after the first round
            cond, seg_ctg, seg_off = rf.condensed_genome(
                asm.genome, mask_ivs[a], new_w, p.k
            )
            t_cond = _time.perf_counter() - t0
            # generate_new_minimizers (bin/ntsynt_synteny.py:167-189):
            # 'Indexlr' passes the repeat BF to the sketcher (-r,
            # excluded from candidacy); 'Filter' re-sketches without it
            # and drops selected minimizers post-hoc via read_minimizers
            sketch_repeat = p.repeat_bf if p.repeat_filter != "Filter" else None
            if p.mesh is not None:
                from ..parallel import mesh as pmesh

                sk = pmesh.sharded_sketch_genome(
                    cond, p.k, new_w, mesh=p.mesh, common_bf=p.common_bf,
                    repeat_bf=sketch_repeat,
                )
            else:
                sk = sketch_ops.sketch_genome(
                    cond, p.k, new_w, common_bf=p.common_bf, repeat_bf=sketch_repeat,
                    device=p.device,
                )
            if p.repeat_filter == "Filter" and p.repeat_bf is not None:
                sk = sk.subset(~p.repeat_bf.probe_np(sk.canon))
            t_sketch = _time.perf_counter() - t0
            # remap synthetic segments -> original (contig, position);
            # read_minimizers semantics: drop within-assembly duplicates
            tmp = AssemblyMinimizers.from_arrays(
                asm.key,
                asm.contig_names,
                sk.hashes,
                seg_ctg[sk.contig_idx],
                sk.positions + seg_off[sk.contig_idx],
                genome=asm.genome,
            )
            per_ctg = []
            ctg_of_list = []
            for ci in range(len(tmp.contig_names)):
                h = tmp.lists[ci]
                if len(h) == 0:
                    continue
                # positions come straight from the construction layout
                # (pos_lists is split alongside lists) — the previous
                # per-contig mx_info.lookup was 10^3+ binary-search
                # batches per assembly per round on real assemblies
                per_ctg.append((h, tmp.pos_lists[ci]))
                ctg_of_list.append(ci)
            asm_intervals = {
                c: iv for (ai, c), iv in intervals.items() if ai == a
            }
            segments_per_asm[key] = rf.filter_new_minimizer_lists(
                per_ctg, internal, asm_intervals, ctg_of_list
            )
            new_info[key] = tmp.mx_info
            log(
                f"  {key}: condense {t_cond:.1f}s ({cond.total_bases} b), "
                f"re-sketch {t_sketch - t_cond:.1f}s, "
                f"filter {_time.perf_counter() - t0 - t_sketch:.1f}s, "
                f"{sk.n_minimizers} new mx",
                dev_only=True,
            )

        segments_per_asm = filter_segments_common(segments_per_asm)

        # update_list_mx_info (:282-290): merge kept new mx into mx_info
        for key in self.files:
            kept = (
                np.unique(np.concatenate(segments_per_asm[key]))
                if segments_per_asm[key]
                else np.zeros(0, np.uint64)
            )
            if len(kept):
                ctg, pos_arr = new_info[key].lookup(kept)
                self.assemblies[key].mx_info = self.assemblies[key].mx_info.update(
                    kept, ctg, pos_arr
                )
        return segments_per_asm, terminal

    def refine_block_coordinates(self, blocks):
        """refine_block_coordinates (bin/ntsynt_synteny.py:476-530)."""
        p = self.params
        prev_w = p.w
        ctx = self.block_ctx
        for new_w in p.w_rounds:
            log(f"Extending synteny blocks with w = {new_w}")
            with _substage(f"gen_additional_mx w={new_w}"):
                segments, terminal = self.generate_additional_minimizers(
                    blocks, new_w, prev_w
                )
            adj = [(k, segments[k]) for k in self.files]
            with _substage(f"graph_build w={new_w}"):
                graph = MinimizerGraph.build(
                    adj, self.weights, seed=self.graph, black_list=terminal
                )
            # NOTE: the reference nominally re-simplifies here, but its
            # result is immediately overwritten (bin/ntsynt_synteny.py:
            # 484-491 simplifies self.graph, then reassigns self.graph
            # from `graph`), so simplification is a no-op in refinement
            # rounds; we mirror the net behavior.
            if new_w == p.w_rounds[-1]:
                log("Filtering the graph")
                with _substage(f"filter+erosion w={new_w}"):
                    self.graph, pairs = graph.filter_global(p.n, flag=True)
                    self.refine_graph_erosion(pairs)
            else:
                with _substage(f"filter_global w={new_w}"):
                    self.graph = graph.filter_global(p.n)
            with _substage(f"linear_paths+blocks w={new_w}"):
                with _substage("  linear_paths"):
                    paths = self.graph.linear_paths()
                blocks = self.paths_to_blocks(paths)
            with _substage(f"indel+minmx w={new_w}"):
                blocks = self.indel_pass(blocks)
                blocks = self.min_mx_pass(blocks, 4)
            blocks_sorted = ctx.sorted_blocks(blocks)
            if p.write_output:
                ctx.write_blocks_tsv(
                    f"{p.prefix}.pre-collinear-merge.synteny_blocks.tsv",
                    blocks_sorted,
                    p.z,
                )
            if new_w == p.w_rounds[-1]:
                with _substage("collinear_merge x2"):
                    merged = blk.merge_collinear_blocks(
                        blocks_sorted, p.bp, p.k, self.collinear_merge_bp
                    )
                    merged = [b for b in merged if (b.lengths() >= p.z).all()]
                    merged = blk.merge_collinear_blocks(
                        merged, p.bp, p.k, self.collinear_merge_bp
                    )
                if p.dev:
                    self.check_non_overlapping(merged)
                if p.write_output:
                    ctx.write_blocks_tsv(
                        f"{p.prefix}.synteny_blocks.tsv", merged, p.z, verbose=True
                    )
            prev_w = new_w
        log("Done extended synteny blocks")
        log(f"Final synteny blocks can be found in: {p.prefix}.synteny_blocks.tsv")

    def check_non_overlapping(self, blocks):
        """--dev sanity pass (bin/ntsynt_synteny.py:234-253)."""
        seen = {}
        for block in blocks:
            if not (block.lengths() >= self.params.z).all():
                continue
            starts, ends = block.starts(), block.ends()
            for a in range(len(self.files)):
                key = (a, int(block.ctg[a]))
                for s0, e0 in seen.get(key, []):
                    lo = max(int(starts[a]), s0)
                    hi = min(int(ends[a]), e0)
                    if hi - lo >= self.params.z:
                        print(
                            "WARNING: detected overlapping segments for this block:",
                            self.files[a],
                            self.block_ctx.contig_name(a, int(block.ctg[a])),
                            int(starts[a]),
                            int(ends[a]),
                            "\n",
                            file=sys.stderr,
                            flush=True,
                        )
                        break
                seen.setdefault(key, []).append((int(starts[a]), int(ends[a])))

    # ------------------------------------------------------------------
    # main
    # ------------------------------------------------------------------
    def print_parameters(self):
        """Parameter echo (print_parameters_synteny, bin/ntsynt_synteny.py:44-63)."""
        p = self.params
        print("Parameters:")
        print("\tAssemblies: ", self.files)
        for label, val in [
            ("-n", p.n), ("-p", p.prefix), ("-k", p.k), ("-w", p.w),
            ("--w-rounds", list(p.w_rounds)), ("-m", p.m), ("-z", p.z),
            ("--bp", p.bp), ("--collinear-merge", self.collinear_merge_bp),
        ]:
            print(f"\t{label} {val}")
        if p.common_bf is not None:
            print(f"\t--common BF({p.common_bf.num_bits} bits)")
        if p.repeat_bf is not None:
            print(f"\t--repeat BF({p.repeat_bf.num_bits} bits)")
        sys.stdout.flush()

    def print_interarrivals(self, blocks):
        """--interarrivals diagnostic (bin/ntsynt_synteny.py:557-564)."""
        with open(f"{self.params.prefix}.interarrivals.tsv", "w", encoding="utf-8") as f:
            for block in blocks:
                d = np.abs(np.diff(block.pos.astype(np.int64), axis=1))
                for a in range(d.shape[0]):
                    for v in d[a]:
                        f.write(f"{v}\n")

    def run(self):
        """main_synteny (bin/ntsynt_synteny.py:593-647)."""
        p = self.params
        self.print_parameters()
        if len(p.w_rounds) != len(set(p.w_rounds)):
            raise ValueError("duplicate values found in w_rounds!")

        with _substage("filter_common"):
            filter_common(self.assemblies)
        with _substage("make_minimizer_graph"):
            self.make_minimizer_graph()
        # the reference always emits the graph artifact from
        # make_minimizer_graph (expected-result listing, SURVEY.md §2.4)
        dot_thread = self.write_dot_async(f"{p.prefix}.mx.dot") if p.write_output else None
        if p.simplify_graph:
            log("Running graph simplification")
            with _substage("simplify_bubbles"):
                self.graph = self.graph.simplify_bubbles(self.max_edge_weight)
        with _substage("filter_global"):
            self.graph = self.graph.filter_global(p.n)

        with _substage("linear_paths+blocks"):
            with _substage("  linear_paths"):
                paths = self.graph.linear_paths()
            blocks = self.paths_to_blocks(paths)
        with _substage("indel+minmx"):
            blocks = self.indel_pass(blocks)
            blocks = self.min_mx_pass(blocks, 4)
        if p.interarrivals and p.write_output:
            self.print_interarrivals(blocks)
        blocks_sorted = self.block_ctx.sorted_blocks(blocks)
        if not blocks_sorted:
            raise RuntimeError(
                "no paths found. Try adjusting the specified k/w parameters."
            )
        if p.write_output:
            self.block_ctx.write_blocks_tsv(
                f"{p.prefix}.synteny_blocks.tsv", blocks_sorted, p.z
            )
        log("Done initial synteny blocks")

        self.refine_block_coordinates(blocks)
        if dot_thread is not None:
            dot_thread.join()
        log("DONE!")
        return f"{p.prefix}.synteny_blocks.tsv"
