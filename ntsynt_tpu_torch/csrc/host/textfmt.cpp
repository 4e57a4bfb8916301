// Text formatters for the port's artifacts: the sketch TSVs' records and
// the .mx.dot's node and edge lines, written byte for byte as the JAX
// package's Python writers write them (io/sketch_tsv.write_sketch_tsv,
// SyntenyDetector.write_dot). Called through ctypes, which releases the
// interpreter lock for the whole call, so the writer threads format
// without holding up the main thread. Single-threaded on purpose: the
// writers run beside host synteny and must take no cores from it.
//
// C ABI (ctypes; caller owns all numpy buffers). Each formatter writes
// records first, first + 1, ... < n into out[0, cap) while the next one
// surely fits, stores the bytes written in *n_bytes and returns the
// number of records written (0 only when cap holds no record):
//   textfmt_sketch(hashes, positions, seqs, k, first, n, out, cap, n_bytes)
//     hashes u64 [n], positions i64 [n], seqs u8 [n, k]: one contig's
//     records "hash:pos:seq", a space before each but the contig's first
//   textfmt_dot_nodes(hashes, first, n, out, cap, n_bytes)
//     hashes u64 [n]: lines "  n<i> [label=\"<hash>\"];\n"
//   textfmt_dot_edges(eu, ev, weight, first, n, out, cap, n_bytes)
//     eu, ev, weight i32 [n]: lines "  n<u> -- n<v> [weight=<w>];\n"
// and the sketch records' k-mer bytes, from a genome's codes:
//   textfmt_kmers(codes, soft, starts, n, k, out)
//     codes u8 (0-3 ACGT, 4 N), soft u8 bit set (bit i % 8 of byte i / 8:
//     base i is lowercase; NULL: none), starts i64 [n] (caller checks
//     starts[i] + k <= the codes' length): out u8 [n, k], the letters

#include <charconv>
#include <cstdint>
#include <cstring>

namespace {

// decimal digits of an int64 or uint64, sign included
constexpr int64_t kNum = 20;

template <typename T>
inline char* put_num(char* p, T v) {
    return std::to_chars(p, p + kNum, v).ptr;
}

template <size_t N>
inline char* put_lit(char* p, const char (&s)[N]) {
    std::memcpy(p, s, N - 1);
    return p + N - 1;
}

}  // namespace

extern "C" {

int64_t textfmt_sketch(const uint64_t* hashes, const int64_t* positions,
                       const uint8_t* seqs, int64_t k, int64_t first,
                       int64_t n, char* out, int64_t cap,
                       int64_t* n_bytes) {
    const int64_t most = 1 + kNum + 1 + kNum + 1 + k;
    char* p = out;
    int64_t i = first;
    for (; i < n && (p - out) + most <= cap; ++i) {
        if (i > 0) *p++ = ' ';
        p = put_num(p, hashes[i]);
        *p++ = ':';
        p = put_num(p, positions[i]);
        *p++ = ':';
        std::memcpy(p, seqs + i * k, k);
        p += k;
    }
    *n_bytes = p - out;
    return i - first;
}

int64_t textfmt_dot_nodes(const uint64_t* hashes, int64_t first, int64_t n,
                          char* out, int64_t cap, int64_t* n_bytes) {
    const int64_t most = 3 + kNum + 9 + kNum + 4;
    char* p = out;
    int64_t i = first;
    for (; i < n && (p - out) + most <= cap; ++i) {
        p = put_lit(p, "  n");
        p = put_num(p, i);
        p = put_lit(p, " [label=\"");
        p = put_num(p, hashes[i]);
        p = put_lit(p, "\"];\n");
    }
    *n_bytes = p - out;
    return i - first;
}

int64_t textfmt_dot_edges(const int32_t* eu, const int32_t* ev,
                          const int32_t* weight, int64_t first, int64_t n,
                          char* out, int64_t cap, int64_t* n_bytes) {
    const int64_t most = 3 + kNum + 5 + kNum + 9 + kNum + 3;
    char* p = out;
    int64_t i = first;
    for (; i < n && (p - out) + most <= cap; ++i) {
        p = put_lit(p, "  n");
        p = put_num(p, eu[i]);
        p = put_lit(p, " -- n");
        p = put_num(p, ev[i]);
        p = put_lit(p, " [weight=");
        p = put_num(p, weight[i]);
        p = put_lit(p, "];\n");
    }
    *n_bytes = p - out;
    return i - first;
}

void textfmt_kmers(const uint8_t* codes, const uint8_t* soft,
                   const int64_t* starts, int64_t n, int64_t k,
                   uint8_t* out) {
    // code | soft-mask bit << 3 -> letter
    static const char kLetter[16] = {'A', 'C', 'G', 'T', 'N', 0, 0, 0,
                                     'a', 'c', 'g', 't', 'n', 0, 0, 0};
    // k-mers lie far apart in the genome: fetch a few ahead, so the
    // cache misses overlap
    constexpr int64_t kAhead = 16;
    for (int64_t i = 0; i < n; ++i, out += k) {
        if (i + kAhead < n) {
            const int64_t a = starts[i + kAhead];
            __builtin_prefetch(codes + a);
            __builtin_prefetch(codes + a + k - 1);
            if (soft) __builtin_prefetch(soft + (a >> 3));
        }
        const int64_t s = starts[i];
        for (int64_t j = 0; j < k; ++j) {
            const int64_t b = s + j;
            const int lower = soft ? (soft[b >> 3] >> (b & 7)) & 1 : 0;
            out[j] = kLetter[(codes[b] & 7) | lower << 3];
        }
    }
}

}  // extern "C"
