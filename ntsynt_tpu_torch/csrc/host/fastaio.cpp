// Native FASTA reader/packer for ntsynt_tpu_torch: the JAX package's
// csrc/fastaio.cpp, built for the host it runs on
// (ops/_kernels.build_host: g++, no -march). Its parse is unchanged; its
// two upload helpers are fused into one (fastaio_pack_stream, below).
//
// Role: the host-side data loader feeding the sketching kernels —
// the analog of the reference's threaded btllib SeqReader layer
// (SURVEY.md §2.2 item 5). Parsing multi-GB FASTA in Python
// is the kind of host bottleneck that starves the device, so this does
// an mmap'd two-pass parse with OpenMP:
//
//   pass 1 (serial, memchr): locate headers and line structure,
//   pass 2 (parallel over contigs): strip newlines, copy raw bytes and
//     write 2-bit-ish base codes (A=0 C=1 G=2 T=3 other=4) via a LUT.
//
// Exposed as a tiny C ABI consumed through ctypes (no pybind11 in the
// image). All buffers are allocated here and freed by fastaio_free.

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
  // outputs
  std::vector<int64_t> lengths;
  std::vector<int64_t> offsets;
  std::vector<int64_t> fai_offsets;
  std::vector<int64_t> fai_linebases;
  std::vector<int64_t> fai_linewidth;
  std::string names;           // '\0'-separated contig names
  uint8_t* codes = nullptr;    // [total]
  uint8_t* raw = nullptr;      // [total]
  size_t total = 0;
};

uint8_t g_lut[256];

void init_lut() {
  static bool done = false;
  if (done) return;
  memset(g_lut, 4, sizeof(g_lut));
  g_lut[(unsigned char)'A'] = 0; g_lut[(unsigned char)'a'] = 0;
  g_lut[(unsigned char)'C'] = 1; g_lut[(unsigned char)'c'] = 1;
  g_lut[(unsigned char)'G'] = 2; g_lut[(unsigned char)'g'] = 2;
  g_lut[(unsigned char)'T'] = 3; g_lut[(unsigned char)'t'] = 3;
  done = true;
}

}  // namespace

extern "C" {

// Parse a plain (non-gzip) FASTA file. Returns an opaque handle or
// nullptr on failure.
void* fastaio_parse(const char* path, int threads) {
  init_lut();
  auto* p = new Parsed();
  p->fd = open(path, O_RDONLY);
  if (p->fd < 0) { delete p; return nullptr; }
  struct stat st;
  if (fstat(p->fd, &st) != 0 || st.st_size == 0) { close(p->fd); delete p; return nullptr; }
  p->map_len = (size_t)st.st_size;
  p->map = (char*)mmap(nullptr, p->map_len, PROT_READ, MAP_PRIVATE, p->fd, 0);
  if (p->map == MAP_FAILED) { close(p->fd); delete p; return nullptr; }
  madvise(p->map, p->map_len, MADV_SEQUENTIAL);

  const char* data = p->map;
  const size_t n = p->map_len;

  // pass 1: line structure
  std::vector<Contig> contigs;
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

  // allocate outputs
  size_t total = 0;
  for (auto& c : contigs) { c.out_offset = total; total += c.length; }
  p->total = total;
  p->codes = (uint8_t*)malloc(total ? total : 1);
  p->raw = (uint8_t*)malloc(total ? total : 1);
  if (!p->codes || !p->raw) {
    free(p->codes); free(p->raw);
    munmap(p->map, p->map_len); close(p->fd); delete p; return nullptr;
  }
  for (auto& c : contigs) {
    p->lengths.push_back((int64_t)c.length);
    p->offsets.push_back((int64_t)c.out_offset);
    p->fai_offsets.push_back((int64_t)c.seq_begin);
    p->fai_linebases.push_back(c.linebases);
    p->fai_linewidth.push_back(c.linewidth);
    p->names.append(c.header, c.header_len);
    p->names.push_back('\0');
  }

#if defined(_OPENMP)
  if (threads > 0) omp_set_num_threads(threads);
#endif
  // pass 2: strip newlines + code in parallel over contigs
  const int64_t n_contigs = (int64_t)contigs.size();
#pragma omp parallel for schedule(dynamic)
  for (int64_t i = 0; i < n_contigs; ++i) {
    const Contig& c = contigs[(size_t)i];
    uint8_t* out_raw = p->raw + c.out_offset;
    uint8_t* out_code = p->codes + c.out_offset;
    size_t written = 0;
    size_t sp = c.seq_begin;
    while (sp < c.seq_end && written < c.length) {
      const char* nl = (const char*)memchr(data + sp, '\n', c.seq_end - sp);
      size_t le = nl ? (size_t)(nl - data) : c.seq_end;
      size_t re = le;
      if (re > sp && data[re - 1] == '\r') re--;
      size_t bases = re - sp;
      memcpy(out_raw + written, data + sp, bases);
      for (size_t b = 0; b < bases; ++b)
        out_code[written + b] = g_lut[(unsigned char)data[sp + b]];
      written += bases;
      sp = nl ? le + 1 : c.seq_end;
    }
  }
  return p;
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
const uint8_t* fastaio_codes(void* h) { return ((Parsed*)h)->codes; }
const uint8_t* fastaio_raw(void* h) { return ((Parsed*)h)->raw; }

void fastaio_free(void* h) {
  auto* p = (Parsed*)h;
  if (!p) return;
  free(p->codes);
  free(p->raw);
  if (p->map && p->map != MAP_FAILED) munmap(p->map, p->map_len);
  if (p->fd >= 0) close(p->fd);
  delete p;
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
