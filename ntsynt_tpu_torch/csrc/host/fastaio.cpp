// Native FASTA reader/packer for ntsynt_tpu_torch: the JAX package's
// csrc/fastaio.cpp, built for the host it runs on
// (ops/_kernels.build_host: g++, no -march). Its parse is split in two
// calls so that it writes into the arrays the caller keeps, and it keeps
// each base's case as one bit instead of the raw byte; its two upload
// helpers are fused into one (fastaio_pack_stream, below).
//
// Role: the host-side data loader feeding the sketching kernels —
// the analog of the reference's threaded btllib SeqReader layer
// (SURVEY.md §2.2 item 5). Parsing multi-GB FASTA in Python
// is the kind of host bottleneck that starves the device, so this does
// an mmap'd two-pass parse with OpenMP:
//
//   fastaio_scan (serial, memchr): map the file, locate headers and line
//     structure: the contig table, its .fai fields and `total` bases;
//   fastaio_fill (parallel over contigs): strip newlines and write the
//     base codes (A=0 C=1 G=2 T=3 other=4, via a LUT) and the soft-mask
//     bits (bit i of soft[i / 8], at i % 8: base i is one of a c g t)
//     into the caller's buffers, counting the bases of code 4 and the
//     soft-masked ones as it goes.
//
// Exposed as a tiny C ABI consumed through ctypes (no pybind11 in the
// image). The handle owns the mapping and the contig table until
// fastaio_free; the base arrays are the caller's.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct Contig {
  const char* header;   // points into the mapping, after '>'
  size_t header_len;    // up to first whitespace or EOL
  size_t seq_begin;     // file offset of first sequence byte
  size_t seq_end;       // file offset past the contig's last line
  size_t length;        // bases
  size_t out_offset;    // offset into the packed arrays
  int64_t linebases;    // bases in first line
  int64_t linewidth;    // bytes in first line incl newline
};

struct Parsed {
  // file mapping
  char* map = nullptr;
  size_t map_len = 0;
  int fd = -1;
  std::vector<Contig> contigs;
  // outputs
  std::vector<int64_t> lengths;
  std::vector<int64_t> offsets;
  std::vector<int64_t> fai_offsets;
  std::vector<int64_t> fai_linebases;
  std::vector<int64_t> fai_linewidth;
  std::string names;           // '\0'-separated contig names
  size_t total = 0;
};

// A soft-mask byte that a contig covers only in part: another contig
// (another thread) may hold its other bits.
struct EdgeByte {
  int64_t index = -1;
  uint8_t bits = 0;
};

uint8_t g_lut[256];
uint8_t g_soft[256];  // 1 for a c g t
uint8_t g_pop[256];   // set bits of a byte (built without -march, popcount is a call)

void init_lut() {
  static bool done = false;
  if (done) return;
  memset(g_lut, 4, sizeof(g_lut));
  memset(g_soft, 0, sizeof(g_soft));
  const char* upper = "ACGT";
  const char* lower = "acgt";
  for (int i = 0; i < 4; ++i) {
    g_lut[(unsigned char)upper[i]] = (uint8_t)i;
    g_lut[(unsigned char)lower[i]] = (uint8_t)i;
    g_soft[(unsigned char)lower[i]] = 1;
  }
  for (int v = 0; v < 256; ++v) g_pop[v] = (uint8_t)__builtin_popcount(v);
  done = true;
}

void close_parsed(Parsed* p) {
  if (p->map && p->map != MAP_FAILED) munmap(p->map, p->map_len);
  if (p->fd >= 0) close(p->fd);
  delete p;
}

}  // namespace

extern "C" {

// Map a plain (non-gzip) FASTA file and read its line structure.
// Returns an opaque handle or nullptr on failure (unreadable or empty).
void* fastaio_scan(const char* path) {
  init_lut();
  auto* p = new Parsed();
  p->fd = open(path, O_RDONLY);
  if (p->fd < 0) { delete p; return nullptr; }
  struct stat st;
  if (fstat(p->fd, &st) != 0 || st.st_size == 0) { close_parsed(p); return nullptr; }
  p->map_len = (size_t)st.st_size;
  p->map = (char*)mmap(nullptr, p->map_len, PROT_READ, MAP_PRIVATE, p->fd, 0);
  if (p->map == MAP_FAILED) { close_parsed(p); return nullptr; }
  madvise(p->map, p->map_len, MADV_SEQUENTIAL);

  const char* data = p->map;
  const size_t n = p->map_len;
  std::vector<Contig>& contigs = p->contigs;
  size_t pos = 0;
  while (pos < n) {
    const char* nl = (const char*)memchr(data + pos, '\n', n - pos);
    size_t line_end = nl ? (size_t)(nl - data) : n;          // excl newline
    size_t next = nl ? line_end + 1 : n;
    size_t raw_end = line_end;
    if (raw_end > pos && data[raw_end - 1] == '\r') raw_end--;  // CRLF
    if (raw_end > pos || line_end > pos) {
      if (data[pos] == '>') {
        Contig c{};
        c.header = data + pos + 1;
        size_t hl = 0;
        while (pos + 1 + hl < raw_end) {
          char ch = c.header[hl];
          if (ch == ' ' || ch == '\t') break;
          hl++;
        }
        c.header_len = hl;
        c.seq_begin = next;
        c.seq_end = next;
        c.length = 0;
        c.linebases = 0;
        c.linewidth = 0;
        contigs.push_back(c);
      } else if (!contigs.empty()) {
        Contig& c = contigs.back();
        size_t bases = raw_end - pos;
        if (bases > 0 && c.linebases == 0) {
          c.linebases = (int64_t)bases;
          c.linewidth = (int64_t)(next - pos);
        }
        c.length += bases;
        c.seq_end = next;
      }
    }
    pos = next;
  }

  size_t total = 0;
  for (auto& c : contigs) {
    c.out_offset = total;
    total += c.length;
    p->lengths.push_back((int64_t)c.length);
    p->offsets.push_back((int64_t)c.out_offset);
    p->fai_offsets.push_back((int64_t)c.seq_begin);
    p->fai_linebases.push_back(c.linebases);
    p->fai_linewidth.push_back(c.linewidth);
    p->names.append(c.header, c.header_len);
    p->names.push_back('\0');
  }
  p->total = total;
  return p;
}

// Write the scanned file's bases into codes (uint8 [total]) and, unless
// soft is null, their soft-mask bits into soft (uint8 [ceil(total / 8)];
// the padding bits of its last byte are 0). counts (int64 [2]) gets the
// bases of code 4 (N and every other letter that is no base) and the
// lowercase acgt bases, counted in the same pass and summed over threads.
void fastaio_fill(void* h, uint8_t* codes, uint8_t* soft, int threads, int64_t* counts) {
  const Parsed* p = (const Parsed*)h;
  const char* data = p->map;
  const std::vector<Contig>& contigs = p->contigs;
  const int64_t n_contigs = (int64_t)contigs.size();
  // each contig's first and last soft byte when it covers them in part;
  // every other soft byte of a contig is its thread's alone
  std::vector<EdgeByte> edges(soft ? 2 * (size_t)n_contigs : 0);
#if defined(_OPENMP)
  if (threads > 0) omp_set_num_threads(threads);
#endif
  int64_t n_bases = 0, soft_bases = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : n_bases, soft_bases)
  for (int64_t i = 0; i < n_contigs; ++i) {
    const Contig& c = contigs[(size_t)i];
    uint8_t* out_code = codes + c.out_offset;
    size_t written = 0;
    size_t g = c.out_offset;  // stream position of the next base
    uint8_t acc = 0;          // soft bits of byte g / 8 so far
    size_t sp = c.seq_begin;
    while (sp < c.seq_end && written < c.length) {
      const char* nl = (const char*)memchr(data + sp, '\n', c.seq_end - sp);
      size_t le = nl ? (size_t)(nl - data) : c.seq_end;
      size_t re = le;
      if (re > sp && data[re - 1] == '\r') re--;
      const size_t bases = re - sp;
      const unsigned char* src = (const unsigned char*)data + sp;
      // per-line sums in locals, so the loops keep them in registers
      int64_t line_n = 0, line_soft = 0;
      for (size_t b = 0; b < bases; ++b) out_code[written + b] = g_lut[src[b]];
      {  // code 4 is the one code with bit 2 set: 8 codes a word, in cache
        const uint8_t* c8 = out_code + written;
        size_t b = 0;
        while (b + 8 <= bases) {
          uint64_t lanes = 0;  // per-byte sums, at most 31 each
          for (int w = 0; w < 31 && b + 8 <= bases; ++w, b += 8) {
            uint64_t x;
            memcpy(&x, c8 + b, 8);
            lanes += (x >> 2) & 0x0101010101010101ULL;
          }
          line_n += (int64_t)((lanes * 0x0101010101010101ULL) >> 56);
        }
        for (; b < bases; ++b) line_n += c8[b] >> 2;
      }
      if (soft) {
        size_t b = 0;
        for (; b < bases && (g & 7); ++b) {  // up to the next whole byte
          line_soft += g_soft[src[b]];
          acc |= (uint8_t)(g_soft[src[b]] << (g & 7));
          if ((++g & 7) == 0) {
            if (g - 8 >= c.out_offset) {
              soft[(g >> 3) - 1] = acc;
            } else {  // the contig starts inside this byte
              edges[2 * (size_t)i] = EdgeByte{(int64_t)(g >> 3) - 1, acc};
            }
            acc = 0;
          }
        }
        for (; b + 8 <= bases; b += 8, g += 8) {  // whole bytes, the contig's alone
          uint8_t v = 0;
          for (int j = 0; j < 8; ++j) v |= (uint8_t)(g_soft[src[b + j]] << j);
          soft[g >> 3] = v;
          line_soft += g_pop[v];
        }
        for (; b < bases; ++b, ++g) {  // the line ends inside this byte
          line_soft += g_soft[src[b]];
          acc |= (uint8_t)(g_soft[src[b]] << (g & 7));
        }
      } else {
        for (size_t b = 0; b < bases; ++b) line_soft += g_soft[src[b]];
      }
      n_bases += line_n;
      soft_bases += line_soft;
      written += bases;
      sp = nl ? le + 1 : c.seq_end;
    }
    if (soft && c.length > 0 && (g & 7) != 0)  // the contig ends inside this byte
      edges[2 * (size_t)i + 1] = EdgeByte{(int64_t)(g >> 3), acc};
  }
  // the shared bytes, once each, on one thread
  for (const EdgeByte& e : edges)
    if (e.index >= 0) soft[e.index] = 0;
  for (const EdgeByte& e : edges)
    if (e.index >= 0) soft[e.index] |= e.bits;
  counts[0] = n_bases;
  counts[1] = soft_bases;
}

int64_t fastaio_n_contigs(void* h) { return (int64_t)((Parsed*)h)->lengths.size(); }
int64_t fastaio_total(void* h) { return (int64_t)((Parsed*)h)->total; }
const int64_t* fastaio_lengths(void* h) { return ((Parsed*)h)->lengths.data(); }
const int64_t* fastaio_offsets(void* h) { return ((Parsed*)h)->offsets.data(); }
const int64_t* fastaio_fai_offsets(void* h) { return ((Parsed*)h)->fai_offsets.data(); }
const int64_t* fastaio_fai_linebases(void* h) { return ((Parsed*)h)->fai_linebases.data(); }
const int64_t* fastaio_fai_linewidth(void* h) { return ((Parsed*)h)->fai_linewidth.data(); }
const char* fastaio_names(void* h) { return ((Parsed*)h)->names.c_str(); }
int64_t fastaio_names_len(void* h) { return (int64_t)((Parsed*)h)->names.size(); }

void fastaio_free(void* h) {
  if (h) close_parsed((Parsed*)h);
}

}  // extern "C"

// The device upload's host side (ops/sketch.PackedUpload), the JAX
// package's fastaio_build_stream + fastaio_pack2_nbits fused into one
// OpenMP pass that never lays the 1-byte stream out: contig i
// (codes[offsets[i], offsets[i] + lengths[i])) stands at stream position
// starts[i] of an out_len-code buffer (out_len % 8 == 0; code 4 wherever
// no contig stands), and the pass writes that buffer's planar packing
// (ntsynt_tpu/ops/sketch._pack_stream_host / _pack_nbits_host):
//   packed2[b] = codes b, b + q, b + 2q, b + 3q at bits 0, 2, 4, 6 (& 3),
//     q = out_len / 4 (code 4 packs as 0);
//   nbits[c] = bit j set where code c + j*m is 4, m = out_len / 8.
// Plane j of the bitmap is positions [j*m, (j+1)*m), and packed2 byte c
// (c < m) holds planes 0, 2, 4, 6 at c, byte m + c planes 1, 3, 5, 7.
// So a block [c0, c1) of c is packed from the eight ranges
// [j*m + c0, j*m + c1): each thread lays those out in a buffer of its
// own (8 x BLOCK codes), which is itself the planar stream of the block.
// Contigs must be sorted by start and must not overlap.
namespace {

constexpr int64_t PACK_BLOCK = 4096;

// codes [lo, hi) of the stream into out (code 4 outside every contig)
void layout_range(const uint8_t* codes, const int64_t* offsets, const int64_t* lengths,
                  const int64_t* starts, int64_t n_contigs, int64_t lo, int64_t hi,
                  uint8_t* out) {
  // the last contig starting at or before lo, else the first
  int64_t a = 0, b = n_contigs;
  while (a < b) {
    int64_t mid = (a + b) / 2;
    if (starts[mid] <= lo) a = mid + 1; else b = mid;
  }
  int64_t i = a > 0 ? a - 1 : 0;
  int64_t pos = lo;
  for (; pos < hi && i < n_contigs; ++i) {
    int64_t s = starts[i], e = starts[i] + lengths[i];
    if (e <= pos) continue;
    if (s >= hi) break;
    if (s > pos) {
      memset(out + (pos - lo), 4, (size_t)(s - pos));
      pos = s;
    }
    int64_t stop = e < hi ? e : hi;
    memcpy(out + (pos - lo), codes + offsets[i] + (pos - s), (size_t)(stop - pos));
    pos = stop;
  }
  if (pos < hi) memset(out + (pos - lo), 4, (size_t)(hi - pos));
}

}  // namespace

extern "C" void fastaio_pack_stream(const uint8_t* codes, const int64_t* offsets,
                         const int64_t* lengths, const int64_t* starts, int64_t n_contigs,
                         int64_t out_len, uint8_t* packed2, uint8_t* nbits, int threads) {
#if defined(_OPENMP)
  if (threads > 0) omp_set_num_threads(threads);
#endif
  const int64_t m = out_len / 8;
  const int64_t n_blocks = (m + PACK_BLOCK - 1) / PACK_BLOCK;
#pragma omp parallel
  {
    std::vector<uint8_t> buf(8 * PACK_BLOCK);
    uint8_t* t = buf.data();
#pragma omp for schedule(static)
    for (int64_t blk = 0; blk < n_blocks; ++blk) {
      const int64_t c0 = blk * PACK_BLOCK;
      const int64_t len = (m - c0) < PACK_BLOCK ? (m - c0) : PACK_BLOCK;
      for (int j = 0; j < 8; ++j)
        layout_range(codes, offsets, lengths, starts, n_contigs, j * m + c0, j * m + c0 + len,
                     t + j * PACK_BLOCK);
      for (int64_t c = 0; c < len; ++c) {
        const uint8_t* p = t + c;
        uint8_t v = 0;
        for (int j = 0; j < 8; ++j) v |= (uint8_t)((p[j * PACK_BLOCK] == 4) << j);
        nbits[c0 + c] = v;
        packed2[c0 + c] = (uint8_t)((p[0] & 3) | ((p[2 * PACK_BLOCK] & 3) << 2) |
                                    ((p[4 * PACK_BLOCK] & 3) << 4) |
                                    ((p[6 * PACK_BLOCK] & 3) << 6));
        packed2[m + c0 + c] = (uint8_t)((p[PACK_BLOCK] & 3) | ((p[3 * PACK_BLOCK] & 3) << 2) |
                                        ((p[5 * PACK_BLOCK] & 3) << 4) |
                                        ((p[7 * PACK_BLOCK] & 3) << 6));
      }
    }
  }
}
