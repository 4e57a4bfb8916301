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

from dataclasses import dataclass
import sys
import threading

import numpy as np

from ..graph.mxgraph import MinimizerGraph
from ..io import textfmt
from ..ops import sketch as sketch_ops
from ..utils import StageTimer, log
from . import blocks as blk
from . import refine as rf
from .assembly import AssemblyMinimizers, filter_common


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
    # records the run's spans (synteny.*, the re-sketches' uploads,
    # write.dot); None: a timer of the run's own
    timer: StageTimer | None = None

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
        # host-side NumPy that grows with genome count x minimizer
        # density: its synteny.* spans say which part costs the time
        self.timer = params.timer or StageTimer()
        if params.n == 0:
            params.n = len(self.files)
        # every assembly adds 1 to an edge's weight (:32)
        self.max_edge_weight = len(self.files)
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
    def _gather(self, ids, suffix: str = ""):
        """(hashes [L], ctg [n_asm, L], pos [n_asm, L]) of graph nodes by
        id, assemblies in FILES order, read from the node columns: each
        node's minimizer in each assembly's table, or in the latest
        round's table that kept it (the reference's hash index with each
        round's merge, bin/ntsynt_synteny.py:282-290). A synteny.lookup
        span, each assembly's gather a synteny.join:<a> span inside it;
        the synteny.gathered<suffix> counter counts the nodes."""
        g = self.graph
        ctg = np.empty((len(self.files), len(ids)), np.int32)
        pos = np.empty((len(self.files), len(ids)), np.int64)
        with self.timer.stage("synteny.lookup"):
            for a, key in enumerate(self.files):
                with self.timer.stage(f"synteny.join:{key}"):
                    np.take(g.node_ctg[a], ids, out=ctg[a])
                    np.take(g.node_pos[a], ids, out=pos[a])
            hashes = g.node_hash[ids]
        self.timer.count(f"synteny.gathered{suffix}", len(ids))
        return hashes, ctg, pos

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------
    def make_minimizer_graph(self):
        """The first graph, from the assemblies' tables: a contig is a
        run of adjacent minimizers. The graph's nodes and columns then
        hold every table's rows, so the tables are dropped: nothing reads
        them again, and their memory (20 B a minimizer) would otherwise
        stay held to the end of synteny."""
        log("Building the minimizer graph")
        asms = list(self.assemblies.values())
        self.graph = MinimizerGraph.build([(a.hashes, a.ctg, a.pos, a.ctg) for a in asms])
        for a in asms:
            a.hashes = a.ctg = a.pos = None
        self._count_graph(self.graph)

    def _count_graph(self, graph, suffix: str = ""):
        """The synteny.nodes, synteny.edges and synteny.branch_nodes
        (nodes of degree > 2) counters of a graph as built, before it is
        simplified or filtered (``suffix``: the refinement round's
        ":w<w>")."""
        self.timer.count(f"synteny.nodes{suffix}", graph.n_nodes)
        self.timer.count(f"synteny.edges{suffix}", graph.n_edges)
        self.timer.count(f"synteny.branch_nodes{suffix}",
                         int(np.count_nonzero(graph.degree() > 2)))

    def write_dot(self, path: str, graph=None) -> int:
        """Emit the minimizer graph as Graphviz (the reference's
        <prefix>.mx.dot artifact from make_minimizer_graph), its node and
        edge lines formatted by the host library (io/textfmt.py).
        Returns the node and edge lines written."""
        g = self.graph if graph is None else graph
        with open(path, "wb") as f:
            f.write(b"graph {\n")
            n = textfmt.dot_lines(f, g.node_hash, g.eu, g.ev, g.weight)
            f.write(b"}\n")
        return n

    def write_dot_async(self, path: str):
        """Start write_dot on a background thread (gigabase graphs
        write millions of lines, which nothing downstream waits on);
        returns the thread. run() joins
        it before returning so the artifact contract holds. The graph is
        snapshotted HERE, on the caller thread: run() reassigns
        self.graph (simplify_bubbles / filter_global) right after
        scheduling, and the artifact must capture the
        make_minimizer_graph output the reference emits."""
        g = self.graph  # snapshot before run() reassigns self.graph

        def write():
            with self.timer.stage("write.dot"):
                n = self.write_dot(path, g)
            self.timer.count("write.records:dot", n)

        t = threading.Thread(target=write, name="write.dot")
        t.start()
        return t

    def paths_to_blocks(self, paths, suffix: str = ""):
        """find_paths_synteny_blocks (bin/ntsynt_synteny.py:543-546),
        batched: ONE gather over the concatenation of all paths +
        segmented trim/orientation votes (core/blocks.py
        blocks_from_paths_batch) instead of per-path lookups. Returns
        the blocks and the node ids of the paths that failed the vote."""
        log("Finding synteny blocks")
        rep_a = self.files.index(self.rep)
        out, removed = blk.blocks_from_paths_batch(
            paths, lambda ids: self._gather(ids, suffix), rep_a,
            self.params.k, self.params.m,
        )
        if len(removed) and self.params.dev:
            log(
                "Not oriented:", len(removed), "minimizers across",
                len(paths) - len(out), "paths", dev_only=True,
            )
        return out, removed

    # -- erosion (last refinement round) --------------------------------
    def _erode_edges(self, src_idx: int, tgt_idx: int, indptr, eids, other):
        """erode_edges (bin/ntsynt_synteny.py:312-340): walk inward from a
        sub-threshold edge's endpoints while the two frontier minimizers
        physically overlap (< k apart in any assembly), alternating
        sides, collecting incident edges to remove. Returns the edge-id
        arrays collected (an edge may repeat) and the node positions
        gathered."""
        g = self.graph
        k = self.params.k
        pos = g.node_pos
        gathered = 0

        def overlaps(u, v):
            nonlocal gathered
            gathered += 2
            return bool((np.abs(pos[:, u] - pos[:, v]) < k).any())

        erode_target = True
        cur_s, cur_t = src_idx, tgt_idx
        return_edges = []
        visited = {cur_s, cur_t}
        while overlaps(cur_s, cur_t):
            v = cur_t if erode_target else cur_s
            ids_v = eids[indptr[v] : indptr[v + 1]]
            nb_v = other[indptr[v] : indptr[v + 1]]
            return_edges.append(ids_v)
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
            else:
                cur_s = nxt
            erode_target = not erode_target
        return return_edges, gathered

    def refine_graph_erosion(self, flagged_pairs, suffix: str = ""):
        """refine_graph (bin/ntsynt_synteny.py:343-362).

        flagged_pairs is the (u, v) node-id array pair from
        filter_global(flag=True). Both-degree-1 eligibility is computed
        as a vectorized mask FIRST — the last refinement round can flag
        millions of dropped edges at gigabase scale, and only a handful
        survive the degree test — so the Python-level erosion walk loops
        over survivors only (the reference loops all pairs,
        bin/ntsynt_synteny.py:346-358; its scale never hurt). The walk's
        positions are node-column gathers, counted in
        synteny.gathered<suffix>."""
        iu_all, iv_all = flagged_pairs
        if len(iu_all) == 0:
            return
        deg = self.graph.degree()
        ok = (deg[iu_all] == 1) & (deg[iv_all] == 1)
        if not ok.any():
            return
        indptr, eids, other = self.graph.incident_csr()
        to_remove = []
        gathered = 0
        for j in np.where(ok)[0]:
            ju, jv = int(iu_all[j]), int(iv_all[j])
            # normalize by hash STRING comparison for determinism (:350-352)
            if str(int(self.graph.node_hash[ju])) > str(int(self.graph.node_hash[jv])):
                ju, jv = jv, ju
            edges, n = self._erode_edges(ju, jv, indptr, eids, other)
            to_remove += edges
            gathered += n
        self.timer.count(f"synteny.gathered{suffix}", gathered)
        if to_remove:
            self.graph = self.graph.delete_edges(np.concatenate(to_remove))

    # ------------------------------------------------------------------
    # refinement rounds
    # ------------------------------------------------------------------
    def generate_additional_minimizers(self, blocks, new_w: int, prev_w: int):
        """generate_additional_minimizers (bin/ntsynt_synteny.py:532-541).

        Returns (tables, terminal): one (hashes, ctg, pos, segment) table
        of the round's kept minimizers per assembly in FILES order, each
        hash once, for the round's graph, whose node columns take their
        (contig, position) as the reference merges them into its hash
        index (bin/ntsynt_synteny.py:282-290)."""
        p = self.params
        n_asm = len(self.files)
        mask_ivs = rf.synteny_mask_intervals(blocks, n_asm, prev_w, p.k)
        terminal, internal, intervals = rf.find_mx_in_blocks(blocks, self.files)

        tables = []
        for a, key in enumerate(self.files):
            asm = self.assemblies[key]
            if asm.genome is None:
                raise RuntimeError(
                    f"assembly {key} has no genome attached; refinement "
                    "rounds need the sequences to re-sketch"
                )
            # sketch only the live (unmasked) material: condensed_genome
            # is window-semantics-equivalent to sketching the full
            # masked genome but ~10x smaller after the first round
            with self.timer.stage(f"synteny.condense:w{new_w}"):
                cond, seg_ctg, seg_off = rf.condensed_genome(
                    asm.genome, mask_ivs[a], new_w, p.k
                )
            # generate_new_minimizers (bin/ntsynt_synteny.py:167-189):
            # 'Indexlr' passes the repeat BF to the sketcher (-r,
            # excluded from candidacy); 'Filter' re-sketches without it
            # and drops selected minimizers post-hoc via read_minimizers
            sketch_repeat = p.repeat_bf if p.repeat_filter != "Filter" else None
            with self.timer.stage(f"synteny.resketch:w{new_w}"):
                if p.mesh is not None:
                    from ..parallel import mesh as pmesh

                    sk = pmesh.sharded_sketch_genome(
                        cond, p.k, new_w, mesh=p.mesh, common_bf=p.common_bf,
                        repeat_bf=sketch_repeat,
                    )
                else:
                    sk = sketch_ops.sketch_genome(
                        cond, p.k, new_w, common_bf=p.common_bf, repeat_bf=sketch_repeat,
                        device=p.device, timer=self.timer,
                    )
                if p.repeat_filter == "Filter" and p.repeat_bf is not None:
                    sk = sk.subset(~p.repeat_bf.probe_np(sk.canon))
            with self.timer.stage(f"synteny.filter_mx:w{new_w}"):
                # remap synthetic segments -> original (contig, position);
                # read_minimizers semantics: drop within-assembly duplicates
                new = AssemblyMinimizers.from_arrays(
                    asm.key,
                    asm.contig_names,
                    sk.hashes,
                    seg_ctg[sk.contig_idx],
                    sk.positions + seg_off[sk.contig_idx],
                    timer=self.timer,
                    tag=f"w{new_w}:{asm.key}",
                )
                asm_intervals = {
                    c: iv for (ai, c), iv in intervals.items() if ai == a
                }
                keep, seg = rf.filter_new_minimizer_lists(
                    new.hashes, new.ctg, new.pos, internal, asm_intervals
                )
                tables.append((new.hashes[keep], new.ctg[keep], new.pos[keep], seg))
            log(f"  {key}: {cond.total_bases} b condensed, {sk.n_minimizers} new mx",
                dev_only=True)

        masks = filter_common([h for h, _, _, _ in tables])
        tables = [tuple(col[m] for col in t) for t, m in zip(tables, masks)]
        for key, (hashes, _, _, _) in zip(self.files, tables):
            self.timer.count(f"synteny.new_mx:w{new_w}:{key}", len(hashes))
        return tables, terminal

    def extract_blocks(self, suffix: str = ""):
        """Linear paths -> blocks -> indel and >=4-mx passes over the
        current graph, each a synteny.* span (``suffix``: the refinement
        round's ":w<w>").

        The graph loses the vote failures' nodes (find_paths_synteny_blocks),
        the indel breaks' edges (check_for_indels, bin/ntsynt_synteny.py
        :391-409) and the short blocks' nodes (filter_synteny_blocks,
        :411-426) once, at the end: deleting nodes and edges commute,
        and until then every node id is the paths' own."""
        with self.timer.stage(f"synteny.paths{suffix}"):
            paths = self.graph.linear_path_ids()
        with self.timer.stage(f"synteny.blocks{suffix}"):
            blocks, failed = self.paths_to_blocks(paths, suffix)
        with self.timer.stage(f"synteny.indel_minmx{suffix}"):
            blocks, broken = blk.check_for_indels(blocks, self.params.bp)
            blocks, short = blk.filter_blocks_min_mx(blocks, 4)
            self.graph = self.graph.delete_edges(
                self.graph.edge_ids(*broken)
            ).delete_nodes(np.concatenate([failed, short]))
        self.timer.count(f"synteny.paths{suffix}", len(paths))
        self.timer.count(f"synteny.blocks{suffix}", len(blocks))
        return blocks

    def refine_block_coordinates(self, blocks):
        """refine_block_coordinates (bin/ntsynt_synteny.py:476-530)."""
        p = self.params
        prev_w = p.w
        ctx = self.block_ctx
        for new_w in p.w_rounds:
            log(f"Extending synteny blocks with w = {new_w}")
            rnd = f":w{new_w}"
            with self.timer.stage(f"synteny.new_mx{rnd}"):
                tables, terminal = self.generate_additional_minimizers(
                    blocks, new_w, prev_w
                )
            with self.timer.stage(f"synteny.graph{rnd}"):
                graph = MinimizerGraph.build(tables, seed=self.graph, black_list=terminal)
            self._count_graph(graph, rnd)
            # NOTE: the reference nominally re-simplifies here, but its
            # result is immediately overwritten (bin/ntsynt_synteny.py:
            # 484-491 simplifies self.graph, then reassigns self.graph
            # from `graph`), so simplification is a no-op in refinement
            # rounds; we mirror the net behavior.
            with self.timer.stage(f"synteny.filter{rnd}"):
                if new_w == p.w_rounds[-1]:
                    log("Filtering the graph")
                    self.graph, pairs = graph.filter_global(p.n, flag=True)
                    self.refine_graph_erosion(pairs, rnd)
                else:
                    self.graph = graph.filter_global(p.n)
            blocks = self.extract_blocks(rnd)
            with self.timer.stage(f"synteny.write_blocks{rnd}"):
                blocks_sorted = ctx.sorted_blocks(blocks)
                if p.write_output:
                    ctx.write_blocks_tsv(
                        f"{p.prefix}.pre-collinear-merge.synteny_blocks.tsv",
                        blocks_sorted,
                        p.z,
                    )
            if new_w == p.w_rounds[-1]:
                with self.timer.stage(f"synteny.merge{rnd}"):
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
                    with self.timer.stage(f"synteny.write_blocks{rnd}"):
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

        asms = self.assemblies.values()
        with self.timer.stage("synteny.filter_common"):
            for a, keep in zip(asms, filter_common([a.hashes for a in asms])):
                a.hashes, a.ctg, a.pos = a.hashes[keep], a.ctg[keep], a.pos[keep]
        for key, a in self.assemblies.items():
            self.timer.count(f"synteny.common_mx:{key}", len(a.hashes))
        with self.timer.stage("synteny.graph"):
            self.make_minimizer_graph()
        # the reference always emits the graph artifact from
        # make_minimizer_graph (expected-result listing, SURVEY.md §2.4)
        dot_thread = self.write_dot_async(f"{p.prefix}.mx.dot") if p.write_output else None
        if p.simplify_graph:
            log("Running graph simplification")
            with self.timer.stage("synteny.simplify"):
                self.graph = self.graph.simplify_bubbles(self.max_edge_weight)
        with self.timer.stage("synteny.filter_global"):
            self.graph = self.graph.filter_global(p.n)

        blocks = self.extract_blocks()
        if p.interarrivals and p.write_output:
            self.print_interarrivals(blocks)
        with self.timer.stage("synteny.write_blocks"):
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
            with self.timer.stage("synteny.dot_join"):
                dot_thread.join()
        log("DONE!")
        return f"{p.prefix}.synteny_blocks.tsv"
