// Native linear-path walker for the minimizer graph: the JAX package's
// csrc/graphwalk.cpp, with its logic and C ABI unchanged, built for the
// host it runs on (ops/_kernels.build_host: g++, no -march).
//
// Role: chain extraction (ntjoin find_paths contract; see
// graph/mxgraph.py linear_paths). The vectorized pointer-doubling
// formulation costs O(2m log L) NumPy passes — at gigabase scale the
// graph is a handful of ~10^6-edge chains, so log L ~ 20 near-full
// passes of random gathers (~4 s, measured for the JAX package on its
// development host); a sequential chase visits each directed edge once
// (~60 ns a step there). Chains are
// independent, so long chains split across OpenMP threads would also
// work, but the single-thread walk is already far off the critical
// path.
//
// C ABI (ctypes; caller owns all numpy buffers):
//   graphwalk_chains(nxt, du, dv, poison, starts, n_starts, m2,
//                    out_nodes, out_offsets, out_cap) -> n_chains
//     nxt:      int32 [2m]  successor directed edge id, -1 at chain end
//     du/dv:    int32 [2m]  directed edge endpoints (node ids)
//     poison:   uint8 [2m]  1 where the edge runs into a branch node
//     starts:   int32 [ns]  directed edges whose source has degree 1,
//                           ascending
//     out_nodes:   int32 [out_cap]  concatenated chain node ids
//     out_offsets: int64 [ns+1]     chain o boundaries (n_chains+1 used)
//   Returns the number of emitted chains, or -1 if out_cap would
//   overflow (caller re-allocates; cannot happen when out_cap >= 2m+ns).
//
// Semantics mirror the NumPy path exactly: a chain containing any
// poisoned edge is dropped whole; each undirected chain is emitted
// once (kept iff its start id <= the reverse of its end edge's id);
// pure cycles have no degree-1 start and are never visited.

#include <cstdint>

extern "C" {

int64_t graphwalk_chains(const int32_t* nxt, const int32_t* du,
                         const int32_t* dv, const uint8_t* poison,
                         const int32_t* starts, int64_t n_starts,
                         int64_t m2, int32_t* out_nodes,
                         int64_t* out_offsets, int64_t out_cap) {
    const int64_t m = m2 / 2;
    int64_t n_chains = 0;
    int64_t w = 0;
    out_offsets[0] = 0;
    for (int64_t si = 0; si < n_starts; ++si) {
        const int32_t s = starts[si];
        // walk once to find the end edge + poison status
        int32_t e = s;
        bool bad = poison[e] != 0;
        int64_t steps = 1;
        while (nxt[e] >= 0) {
            e = nxt[e];
            bad |= poison[e] != 0;
            ++steps;
            if (steps > m2) return -2;  // corrupt input (cycle with start)
        }
        if (bad) continue;
        // keep one direction per undirected chain: start id <= reverse
        // of its end edge (matches the NumPy keep rule)
        const int32_t rev_end = (e < m) ? e + (int32_t)m : e - (int32_t)m;
        if (s > rev_end) continue;
        if (w + steps + 1 > out_cap) return -1;
        int32_t cur = s;
        out_nodes[w++] = du[cur];
        for (;;) {
            out_nodes[w++] = dv[cur];
            const int32_t nx = nxt[cur];
            if (nx < 0) break;
            cur = nx;
        }
        out_offsets[++n_chains] = w;
    }
    return n_chains;
}

}  // extern "C"
