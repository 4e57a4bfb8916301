"""Array-based undirected minimizer graph (igraph replacement).

The reference stores the minimizer graph in python-igraph
(SURVEY.md §2.4) with vertices named by minimizer hash and
weighted edges from per-assembly adjacency. This module reimplements
exactly the operations ntSynt uses, on flat NumPy arrays:

  * build/extend from per-assembly adjacency lists with weight
    accumulation (ntjoin_utils.build_graph contract, incl. ``graph=``
    seeding and ``black_list=`` suppression of terminal-terminal edges;
    bin/ntsynt_synteny.py:483),
  * global weight filtering, with or without flagging removed edges
    (Ntjoin.filter_graph_global / filter_graph_global_flag_overlaps,
    bin/ntsynt_synteny.py:292-303),
  * bubble simplification (run_graph_simplification,
    bin/ntsynt_synteny.py:566-590),
  * degree/incidence queries and edge/vertex deletion used by block
    filtering and erosion (bin/ntsynt_synteny.py:312-362,391-425),
  * linear-path extraction (ntjoin_find_paths contract): maximal chains
    walked from degree-1 endpoints.

Nodes are identified by their uint64 minimizer hash. Edge order is kept
in first-insertion order (matching igraph's insertion-ordered edge list)
because graph simplification mutates weights while scanning edges in
that order.

Scale note: with default parameters the graph holds ~2·L/w shared
minimizers (~6M nodes for mammal-scale genomes at w=1000). Build,
path extraction (pointer doubling, NumPy only: the JAX package's
native chain walker, csrc/libgraphwalk.so, is not loaded here) and the
path->block machinery are fully vectorized; tests/test_scale.py stress-runs the graph+blocks
stage at 6M nodes / 100k paths.
"""

from dataclasses import dataclass, field

import numpy as np


@dataclass
class MinimizerGraph:
    # nodes
    node_hash: np.ndarray  # uint64 [n] (insertion order)
    # edges as indices into node arrays, first-insertion order
    eu: np.ndarray  # int32 [m]
    ev: np.ndarray  # int32 [m]
    weight: np.ndarray  # int32 [m]
    # caches
    _sorted_hash: np.ndarray | None = field(default=None, repr=False)
    _sorted_perm: np.ndarray | None = field(default=None, repr=False)
    _degree: np.ndarray | None = field(default=None, repr=False)

    # ------------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return len(self.node_hash)

    @property
    def n_edges(self) -> int:
        return len(self.eu)

    def _ensure_lookup(self):
        if self._sorted_hash is None:
            self._sorted_perm = np.argsort(self.node_hash, kind="stable")
            self._sorted_hash = self.node_hash[self._sorted_perm]

    def node_index(self, hashes) -> np.ndarray:
        """Vectorized hash -> node index (-1 if absent)."""
        hashes = np.asarray(hashes, dtype=np.uint64)
        if self.n_nodes == 0:
            return np.full(len(hashes), -1, dtype=np.int64)
        self._ensure_lookup()
        loc = np.searchsorted(self._sorted_hash, hashes)
        loc = np.minimum(loc, len(self._sorted_hash) - 1)
        found = self._sorted_hash[loc] == hashes
        return np.where(found, self._sorted_perm[loc], -1).astype(np.int64)

    def degree(self) -> np.ndarray:
        if self._degree is None:
            d = np.zeros(self.n_nodes, dtype=np.int32)
            np.add.at(d, self.eu, 1)
            np.add.at(d, self.ev, 1)
            self._degree = d
        return self._degree

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def empty(cls) -> "MinimizerGraph":
        z32 = np.zeros(0, dtype=np.int32)
        return cls(np.zeros(0, dtype=np.uint64), z32, z32.copy(), z32.copy())

    @classmethod
    def build(
        cls,
        adjacency_lists,
        weights,
        seed: "MinimizerGraph | None" = None,
        black_list=None,
    ) -> "MinimizerGraph":
        """Build/extend the graph from per-assembly adjacency.

        Args:
          adjacency_lists: iterable of (assembly_key, list of uint64
            arrays) — for each assembly, its ordered minimizer lists
            (one per contig / split segment). Must be iterated in the
            pipeline's canonical FILES order so edge insertion order is
            deterministic.
          weights: dict assembly_key -> weight (ntSynt forces all 1,
            bin/ntsynt_synteny.py:32).
          seed: existing graph to extend (refinement rounds).
          black_list: uint64 hashes (block-terminal minimizers). New
            adjacency pairs whose BOTH endpoints are black-listed are
            skipped, so two existing blocks are never bridged without
            new interior evidence — and a block's own terminals (made
            adjacent in refinement lists because interior minimizers are
            filtered out) don't get a spurious chord.
        """
        # ---- nodes: first-appearance order over [seed nodes] + lists --
        hash_parts = [seed.node_hash] if seed is not None else []
        list_cat = []
        for _, mx_lists in adjacency_lists:
            for mx_list in mx_lists:
                list_cat.append(np.asarray(mx_list, dtype=np.uint64))
        all_hashes = np.concatenate(hash_parts + list_cat) if (hash_parts or list_cat) else np.zeros(0, np.uint64)
        # ONE stable argsort yields unique hashes, first-appearance
        # ranks AND the node id of every occurrence position — replacing
        # np.unique + per-assembly searchsorted re-joins (at 6M nodes /
        # 3 assemblies those were ~3x the cost of the sort itself).
        # Everything id-sized runs in int32 (occurrence counts < 2^31 in
        # any real genome set): on the dev VM fresh pages fault at
        # ~40 MB/s, so halving the working set nearly halves the cold
        # wall (tests/test_scale.py).
        t = len(all_hashes)
        if t >= (1 << 31):  # explicit raise: survives python -O
            raise ValueError("graph occurrence count exceeds int32")
        if t:
            order = np.argsort(all_hashes, kind="stable").astype(np.int32, copy=False)
            sh = all_hashes[order]
            new_grp = np.empty(t, dtype=bool)
            new_grp[0] = True
            np.not_equal(sh[1:], sh[:-1], out=new_grp[1:])
            first_occ = order[new_grp]  # stable => min position per group
            appear = np.argsort(first_occ, kind="stable").astype(np.int32, copy=False)
            n_nodes = len(first_occ)
            node_hash = sh[new_grp][appear]
            del first_occ, sh
            rank_of_group = np.empty(n_nodes, dtype=np.int32)
            rank_of_group[appear] = np.arange(n_nodes, dtype=np.int32)
            del appear
            grp = np.cumsum(new_grp, dtype=np.int32)
            del new_grp
            grp -= 1
            ids = np.empty(t, dtype=np.int32)
            ids[order] = rank_of_group[grp]
            del order, grp, rank_of_group
        else:
            node_hash = np.zeros(0, np.uint64)
            ids = np.zeros(0, np.int32)

        # node id of occurrence slices: list_cat entries follow the
        # (optional) seed prefix inside all_hashes/ids
        id_base = len(hash_parts[0]) if hash_parts else 0

        # ---- adjacency pair occurrences, in insertion order ----------
        occ_u, occ_v, occ_w = [], [], []
        if seed is not None and seed.n_edges:
            seed_ids = ids[:id_base]  # node id per seed node
            occ_u.append(seed_ids[seed.eu])
            occ_v.append(seed_ids[seed.ev])
            occ_w.append(seed.weight.astype(np.int64))
        bl_sorted = (
            np.unique(np.asarray(black_list, dtype=np.uint64))
            if black_list is not None
            else None
        )

        def in_bl(hs):
            if bl_sorted is None or len(bl_sorted) == 0:
                return np.zeros(len(hs), dtype=bool)
            loc = np.minimum(np.searchsorted(bl_sorted, hs), len(bl_sorted) - 1)
            return bl_sorted[loc] == hs

        # one batched pass per assembly (not per list): adjacency pairs
        # are consecutive positions of the concatenated lists, masked at
        # list boundaries — identical pair order to the per-list loop,
        # with node ids sliced straight out of `ids` (no re-joins)
        pos = 0
        base = id_base
        for asm_key, mx_lists in adjacency_lists:
            wt = weights[asm_key]
            arrs = list_cat[pos : pos + len(mx_lists)]
            pos += len(mx_lists)
            lens = np.asarray([len(a) for a in arrs], dtype=np.int64)
            total = int(lens.sum())
            if total < 2:
                base += total
                continue
            idx_all = ids[base : base + total]
            base += total
            lid = np.repeat(np.arange(len(arrs), dtype=np.int32), lens)
            adj = lid[1:] == lid[:-1]  # pair (i, i+1) within one list
            del lid
            if bl_sorted is not None:
                blv = in_bl(np.concatenate(arrs))
                adj &= ~(blv[:-1] & blv[1:])
                del blv
            occ_u.append(idx_all[:-1][adj])
            occ_v.append(idx_all[1:][adj])
            occ_w.append(np.full(len(occ_u[-1]), wt, dtype=np.int32))
            del adj

        if not occ_u:
            return cls(node_hash, *(np.zeros(0, np.int32) for _ in range(3)))
        u = np.concatenate(occ_u)
        occ_u.clear()
        v = np.concatenate(occ_v)
        occ_v.clear()
        wts = np.concatenate(occ_w)
        occ_w.clear()
        lo = np.minimum(u, v).astype(np.int64)
        lo *= np.int64(len(node_hash))
        key = lo
        key += np.maximum(u, v)  # in place: key = lo * n + hi
        del lo
        # dedupe + weight-sum via ONE stable argsort (np.unique with
        # return_index/inverse re-sorts and re-gathers several times)
        korder = np.argsort(key, kind="stable").astype(np.int32, copy=False)
        ks = key[korder]
        del key
        newk = np.empty(len(ks), dtype=bool)
        newk[0] = True
        np.not_equal(ks[1:], ks[:-1], out=newk[1:])
        del ks
        kfirst = korder[newk]  # stable => first occurrence per edge
        csum = np.cumsum(wts[korder], dtype=np.int64)
        del korder
        ends = np.flatnonzero(np.concatenate([newk[1:], [True]]))
        wsum = np.diff(np.concatenate([[0], csum[ends]])).astype(np.int32)
        del csum, ends, newk
        worder = np.argsort(kfirst, kind="stable").astype(np.int32, copy=False)
        # endpoints in their first-seen orientation
        eu = u[kfirst][worder]
        ev = v[kfirst][worder]
        ew = wsum[worder]
        return cls(node_hash, eu, ev, ew)

    # ------------------------------------------------------------------
    # mutation (functional: return new graph)
    # ------------------------------------------------------------------
    def delete_edges(self, edge_ids) -> "MinimizerGraph":
        edge_ids = list(edge_ids)
        if not edge_ids:
            return self
        keep = np.ones(self.n_edges, dtype=bool)
        keep[np.asarray(edge_ids, dtype=np.int64)] = False
        return MinimizerGraph(self.node_hash, self.eu[keep], self.ev[keep], self.weight[keep])

    def delete_nodes_by_hash(self, hashes) -> "MinimizerGraph":
        """Remove nodes (and incident edges) by minimizer hash."""
        hashes = np.asarray(list(hashes), dtype=np.uint64)
        if len(hashes) == 0:
            return self
        doomed_idx = self.node_index(hashes)
        doomed = np.zeros(self.n_nodes, dtype=bool)
        doomed[doomed_idx[doomed_idx >= 0]] = True
        keep_nodes = ~doomed
        remap = np.cumsum(keep_nodes, dtype=np.int32)
        remap -= 1
        keep_edges = keep_nodes[self.eu] & keep_nodes[self.ev]
        return MinimizerGraph(
            self.node_hash[keep_nodes],
            remap[self.eu[keep_edges]],
            remap[self.ev[keep_edges]],
            self.weight[keep_edges],
        )

    def filter_global(self, min_weight: int, flag: bool = False):
        """Drop edges with weight < min_weight.

        With flag=True also return the (u_hashes, v_hashes) uint64
        endpoint arrays of removed edges in edge order
        (filter_graph_global_flag_overlaps, bin/ntsynt_synteny.py:292-303).
        Arrays, not Python tuples: the last refinement round can drop
        millions of edges at gigabase scale, and the erosion pre-filter
        (core/synteny.refine_graph_erosion) reduces them with vectorized
        degree masks before any Python-level loop.
        """
        keep = self.weight >= min_weight
        g = MinimizerGraph(self.node_hash, self.eu[keep], self.ev[keep], self.weight[keep])
        if not flag:
            return g
        dropped = ~keep
        return g, (self.node_hash[self.eu[dropped]], self.node_hash[self.ev[dropped]])

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def incident_csr(self):
        """CSR of incidences: (indptr, edge_ids, other_node), sorted by node."""
        m = self.n_edges
        src = np.concatenate([self.eu, self.ev])
        other = np.concatenate([self.ev, self.eu])
        eid = np.concatenate([np.arange(m, dtype=np.int32)] * 2)
        order = np.argsort(src, kind="stable").astype(np.int32, copy=False)
        src, other, eid = src[order], other[order], eid[order]
        indptr = np.zeros(self.n_nodes + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, eid, other

    def edge_id(self, hu, hv) -> int:
        """Edge id between two node hashes (ntjoin_utils.edge_index)."""
        iu, iv = self.node_index(np.array([hu, hv], dtype=np.uint64))
        hits = np.where(
            ((self.eu == iu) & (self.ev == iv)) | ((self.eu == iv) & (self.ev == iu))
        )[0]
        if len(hits) == 0:
            raise KeyError(f"no edge between {hu} and {hv}")
        return int(hits[0])

    # ------------------------------------------------------------------
    # simplification (bubbles)
    # ------------------------------------------------------------------
    def simplify_bubbles(self, max_edge_weight: int) -> "MinimizerGraph":
        """Remove simple 2-step bubbles (run_graph_simplification,
        bin/ntsynt_synteny.py:566-590).

        For each edge (in insertion order) whose endpoints both have
        degree 3 and are "partially anchored" (exactly one incident edge
        of max weight), if there is exactly one alternative 2-step path,
        delete its middle node and promote this edge to max weight. The
        weight promotion is visible to later iterations, matching the
        reference's in-place mutation during the edge scan.
        """
        if self.n_edges == 0:
            return self
        deg = self.degree()
        weight = self.weight.copy()
        indptr, eids, other = self.incident_csr()

        def incident(v):
            return eids[indptr[v] : indptr[v + 1]], other[indptr[v] : indptr[v + 1]]

        to_remove_nodes = []
        # vectorized prefilter: only deg-3/deg-3 edges can be bubble
        # chords (the Python scan below is order-dependent — weight
        # promotion is visible to later candidates — but candidates are
        # a tiny fraction of edges, so the loop stays short)
        cand = np.where((deg[self.eu] == 3) & (deg[self.ev] == 3))[0]
        for e in cand:
            s, t = int(self.eu[e]), int(self.ev[e])
            ids_s, ns = incident(s)
            ids_t, nt = incident(t)
            if int((weight[ids_s] == max_edge_weight).sum()) != 1:
                continue
            if int((weight[ids_t] == max_edge_weight).sum()) != 1:
                continue
            common = np.intersect1d(ns, nt)
            common = common[(common != s) & (common != t)]
            # exactly 2 simple paths of <=2 steps: the edge itself + one bubble
            if len(common) == 1:
                to_remove_nodes.append(int(common[0]))
                weight[e] = max_edge_weight

        g = MinimizerGraph(self.node_hash, self.eu, self.ev, weight)
        if to_remove_nodes:
            g = g.delete_nodes_by_hash(self.node_hash[np.asarray(to_remove_nodes, np.int64)])
        return g

    # ------------------------------------------------------------------
    # path extraction
    # ------------------------------------------------------------------
    def linear_paths(self):
        """Extract maximal simple chains (ntjoin_find_paths contract).

        Returns a list of uint64 arrays — each the ordered minimizer
        hashes of one maximal path walked between degree-1 endpoints.
        Each undirected chain is returned ONCE, in an arbitrary of its
        two directions (the caller normalizes direction against the
        representative assembly). Chains that run into a node of degree
        > 2 are dropped (the reference's traversal only handles simple
        paths; with the default min-edge-weight = #assemblies, degree
        > 2 cannot occur — see SURVEY.md §3.2). Pure cycles have no
        degree-1 endpoint and are dropped. Isolated nodes yield nothing.

        Vectorized as list ranking on directed edges: successor of
        (u -> v) is (v -> w) with w = v's other neighbor; pointer
        doubling resolves each edge's chain end + distance in log2(n)
        NumPy passes, then all chains materialize with two scatters.
        """
        m = self.n_edges
        if m == 0:
            return []
        deg = self.degree()
        indptr, eids, other = self.incident_csr()

        # directed edges: id e is eu->ev, id e+m is ev->eu.
        # Everything id-sized is int32 (2m < 2^31): the doubling loop
        # makes ~log2(2m) passes over these arrays, and on the dev VM
        # fresh pages fault ~80x slower than they copy.
        if 2 * m >= (1 << 31):  # explicit raise: survives python -O
            raise ValueError("edge count exceeds int32 path extraction")
        du = np.concatenate([self.eu, self.ev])
        dv = np.concatenate([self.ev, self.eu])
        # neighbor table for nodes of degree <= 2 (vectorized from CSR)
        nb1 = np.full(self.n_nodes, -1, dtype=np.int32)
        nb2 = np.full(self.n_nodes, -1, dtype=np.int32)
        has1 = indptr[1:] - indptr[:-1] >= 1
        has2 = indptr[1:] - indptr[:-1] >= 2
        nb1[has1] = other[indptr[:-1][has1]]
        nb2[has2] = other[indptr[:-1][has2] + 1]
        e1 = np.full(self.n_nodes, -1, dtype=np.int32)
        e2 = np.full(self.n_nodes, -1, dtype=np.int32)
        e1[has1] = eids[indptr[:-1][has1]]
        e2[has2] = eids[indptr[:-1][has2] + 1]

        # successor directed edge of each directed edge (-1 at chain end)
        w_next = np.where(nb1[dv] == du, nb2[dv], nb1[dv])
        ue_next = np.where(nb1[dv] == du, e2[dv], e1[dv])  # undirected id
        cont = (deg[dv] == 2) & (w_next >= 0)
        # directed id of (dv -> w_next): ue_next with orientation
        fwd_is_uv = np.zeros(2 * m, dtype=bool)
        fwd_is_uv[cont] = self.eu[ue_next[cont]] == dv[cont]
        nxt = np.where(
            cont, np.where(fwd_is_uv, ue_next, ue_next + np.int32(m)), np.int32(-1)
        )
        del w_next, ue_next, cont, fwd_is_uv
        poison = deg[dv] > 2  # chain runs into a branch node

        # pointer doubling: end edge + hop distance for every edge.
        # The unresolved set is carried as a compacted worklist — the
        # first doublings leave most edges live, but every pass over
        # full 2m arrays (mask + where) cost more than the gathers.
        end = np.where(nxt < 0, np.arange(2 * m, dtype=np.int32), np.int32(-1))
        dist = (nxt >= 0).astype(np.int32)
        bad = poison.copy()
        ptr = nxt.copy()
        wl = np.where(ptr >= 0)[0].astype(np.int32)
        for _ in range(66):  # > log2(2m) always; leftovers are pure cycles
            if not len(wl):
                break
            p = ptr[wl]
            bad[wl] |= bad[p]
            dist[wl] += dist[p]
            e_p = end[p]
            ptr_p = ptr[p]  # read BEFORE any writes (p may alias wl)
            resolved = e_p >= 0
            end[wl[resolved]] = e_p[resolved]
            ptr[wl] = np.where(resolved, np.int32(-1), ptr_p)
            wl = wl[~resolved]

        # chain starts: directed edges whose source has degree 1
        starts = np.where((deg[du] == 1) & ~bad)[0]
        if len(starts) == 0:
            return []
        # each chain appears twice (both directions): keep the start
        # whose reverse of its end edge is the other start; dedupe by id
        rev_end = np.where(end[starts] < m, end[starts] + m, end[starts] - m)
        keep = starts <= rev_end
        starts = starts[keep]
        L_edges = dist[starts].astype(np.int64) + 1  # edges per chain
        n_nodes_out = L_edges + 1
        offsets = np.concatenate([[0], np.cumsum(n_nodes_out)[:-1]])
        total = int(n_nodes_out.sum())

        # map every edge to its (kept) traversal via its end edge
        kept_end = end[starts]
        order = np.argsort(kept_end, kind="stable").astype(np.int32, copy=False)
        sorted_end = kept_end[order]
        loc = np.searchsorted(sorted_end, end)
        loc = np.minimum(loc, len(sorted_end) - 1)
        # cycle edges keep end == -1 and can never match a kept end
        on_kept = (~bad) & (sorted_end[loc] == end)
        tr = np.full(2 * m, -1, dtype=np.int32)
        tr[on_kept] = order[loc[on_kept]]
        del loc, sorted_end, kept_end

        out = np.empty(total, dtype=np.int64)
        es = np.where(on_kept)[0]
        t_es = tr[es]
        pos_in_chain = (L_edges[t_es] - 1) - dist[es]
        out[offsets[t_es] + pos_in_chain] = du[es]
        # last node of each chain = dest of its end edge
        out[offsets + L_edges] = dv[end[starts]]

        return [
            self.node_hash[out[offsets[i] : offsets[i] + int(n_nodes_out[i])]]
            for i in range(len(starts))
        ]
