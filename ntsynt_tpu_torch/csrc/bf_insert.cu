// K4: Bloom-filter insert for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ntsynt_tpu/ops/bf_place.py
// (_place_kernel, launched by _place_call / place_sorted), which ORs a
// SORTED list of (word, single-bit mask) pairs into the filter words in
// one streaming pass; the sort itself (ntsynt_tpu/ops/bloom.insert_words)
// exists only to feed that kernel and is not ported.
//
// For every i with valid[i] != 0, with b = bits_log2 (5..36):
//   bit  = canon[i] mod 2^b
//   word = bit >> 5,  mask = 1 << (canon[i] & 31)
//   words[word] |= mask
// which is ntsynt_tpu/ops/bloom._bit_index for both its <= 32-bit and
// its 33..36-bit branch (the latter builds the same word from canon_hi's
// low b-32 bits and canon_lo >> 5).
//
// Bound on the H100: memory. It reads 8 + 1 bytes per key, and reads and
// writes each distinct filter word that a valid key hits (4 bytes each
// way; words no key hits need not move), at 3.35 TB/s. 2^26 random keys
// hit about 39% of a 2^32-bit filter's 2^27 words. One global atomicOr
// per key instead makes every insert a random 32-byte sector
// read-modify-write that misses the 50 MB L2 (the filter is 512 MiB):
// about 14 G atomics/s, 16x the bound. Scattering each key's 4-byte bit
// index straight to its cell's list costs about as much: one
// partial-sector write per key.
//
// Design: the Hopper counterpart of the TPU's sorted streaming pass is a
// cheap partition of the keys by filter cell followed by a shared-memory
// apply. A cell is 2^cell_log2 words (2^15: 2^20 bits, 128 KiB, one
// block's shared memory; K5, csrc/bf_sweep.cu, bins at 2^14 with the
// same entry points); a filter under one cell is one cell. With 2^c
// cells (c up to 16: 65,536 cells at 2^36 bits):
//   (1) count: persistent blocks histogram the cells of sub-chunks of at
//       most 65,534 keys in shared memory with 16-bit counters (two to a
//       word, so 2^16 cells take 128 KiB) and add the non-zero ones to
//       the global per-cell counts; then one block scans them into the
//       cells' offsets and the partition passes' cursors, and plans the
//       second pass (and, for K5, each cell's slices).
//   (2) partition, one pass for c <= 8, else two (an MSD radix
//       partition): the first by the top c_a = c - c/2 bits of the cell,
//       the second, within each of those 2^c_a ranges, by the low c/2
//       bits. Each pass sorts a tile of 4,096 items by digit (at most 256)
//       in shared memory, reserves each digit's run with one global
//       atomicAdd on that digit's cursor, and writes the runs coalesced.
//       Keys are read with 16-byte loads marked streaming; the second
//       pass loads its next tile while it sorts the current one, and its
//       blocks follow the scan's plan, so a range gets blocks by its size
//       (keys crowded into one range still spread over the card).
//   (3) apply: one block per cell. A cell with fewer keys than one per 16
//       of its words ORs them with direct global atomics: loading and
//       storing 128 KiB (8 bytes a word) costs more than a 32-byte sector
//       atomic per key below that density (measured on the H100: 0.004
//       ns per word swept by K5's apply, 0.07 ns per direct atomic). A denser
//       cell is loaded with 16-byte loads (eight in flight per thread),
//       its keys are ORed in with shared-memory atomicOr, and it is stored
//       back.
// A whole segment below that density (n < words / 16: the repeat walk's
// 2^20 keys into 2^33 bits) skips the partition and takes one global
// atomicOr per key (ntsynt_bf_insert); the wrapper chooses by n and b
// alone. OR is commutative and idempotent, so neither the order within a
// cell nor duplicates change the result. Word offsets are 64-bit (2^31
// words at 2^36 bits).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COUNT_THREADS = 1024;
constexpr int COUNT_SUB = 65534;      // keys per 16-bit histogram
constexpr int PART_THREADS = 512;
constexpr int PART_ITEMS = 8;         // items per thread per tile
constexpr int PART_TILE = PART_THREADS * PART_ITEMS;
constexpr int MAX_DIGITS_LOG2 = 8;
constexpr int APPLY_BATCH = 8;        // 16-byte loads in flight per thread
constexpr int MAX_CELL_LOG2 = 15;     // 128 KiB of shared-memory words
constexpr int MAX_CELLS_LOG2 = 16;    // 128 KiB of 16-bit counters
constexpr int DIRECT_WORDS_PER_KEY = 16;
constexpr int SCAN_THREADS = 1024;
constexpr unsigned NONE = 0xFFFFFFFFu;

__global__ void bf_insert_kernel(unsigned int* __restrict__ words,
                                 const long long* __restrict__ canon,
                                 const uint8_t* __restrict__ valid, int64_t n, int bits_log2) {
  const unsigned long long bit_mask = (1ull << bits_log2) - 1ull;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (!valid[i]) continue;
    unsigned long long h = (unsigned long long)canon[i];
    atomicOr(words + ((h & bit_mask) >> 5), 1u << (unsigned)(h & 31ull));
  }
}

// Two keys at i, i + 1 (i even) with one 16-byte and one 2-byte load,
// marked streaming: the keys are read once. *bits gets each valid key's
// bit (mod 2^b), or NONE's 64-bit form.
__device__ __forceinline__ void load_pair(const long long* __restrict__ canon,
                                          const uint8_t* __restrict__ valid, int64_t i,
                                          int64_t n, unsigned long long bit_mask,
                                          unsigned long long* bits) {
  bits[0] = bits[1] = ~0ull;
  if (i + 1 < n) {
    longlong2 c = __ldcs(reinterpret_cast<const longlong2*>(canon + i));
    uchar2 v = __ldcs(reinterpret_cast<const uchar2*>(valid + i));
    if (v.x) bits[0] = (unsigned long long)c.x & bit_mask;
    if (v.y) bits[1] = (unsigned long long)c.y & bit_mask;
  } else if (i < n && valid[i]) {
    bits[0] = (unsigned long long)canon[i] & bit_mask;
  }
}

__global__ void cell_count_kernel(const long long* __restrict__ canon,
                                  const uint8_t* __restrict__ valid, int64_t n,
                                  unsigned long long bit_mask, int cell_shift, int n_cells,
                                  int* __restrict__ counts) {
  extern __shared__ unsigned hist[];  // 16-bit counters, two per word
  const int n_words = (n_cells + 1) / 2;
  for (int64_t s0 = (int64_t)blockIdx.x * COUNT_SUB; s0 < n; s0 += (int64_t)gridDim.x * COUNT_SUB) {
    for (int c = threadIdx.x; c < n_words; c += blockDim.x) hist[c] = 0;
    __syncthreads();
    const int64_t s1 = s0 + COUNT_SUB < n ? s0 + COUNT_SUB : n;
    for (int64_t i = s0 + 2 * threadIdx.x; i < s1; i += 2 * blockDim.x) {
      unsigned long long bits[2];
      load_pair(canon, valid, i, s1, bit_mask, bits);
      for (int u = 0; u < 2; ++u) {
        if (bits[u] == ~0ull) continue;
        unsigned c = (unsigned)(bits[u] >> cell_shift);
        atomicAdd(hist + (c >> 1), 1u << (16 * (c & 1)));
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < n_cells; c += blockDim.x) {
      unsigned v = (hist[c >> 1] >> (16 * (c & 1))) & 0xFFFFu;
      if (v) atomicAdd(counts + c, (int)v);
    }
    __syncthreads();
  }
}

// One tile of at most PART_TILE items, each (digit, value) or NONE:
// sort by digit in shared memory, reserve each digit's run at
// cursor[digit], write the runs to dst coalesced.
struct PartSmem {
  unsigned hist[1 << MAX_DIGITS_LOG2];
  unsigned start[1 << MAX_DIGITS_LOG2];
  unsigned base[1 << MAX_DIGITS_LOG2];
  unsigned total;
  unsigned val[PART_TILE];
  unsigned char dig[PART_TILE];
};

__device__ __forceinline__ void partition_tile(PartSmem& sm, const unsigned (&digit)[PART_ITEMS],
                               const unsigned (&value)[PART_ITEMS], int n_digits,
                               int* __restrict__ cursor, unsigned* __restrict__ dst) {
  const int tid = threadIdx.x;
  for (int d = tid; d < n_digits; d += PART_THREADS) sm.hist[d] = 0;
  __syncthreads();
  unsigned rank[PART_ITEMS];
#pragma unroll
  for (int u = 0; u < PART_ITEMS; ++u)
    if (digit[u] != NONE) rank[u] = atomicAdd(sm.hist + digit[u], 1u);
  __syncthreads();
  if (tid < 32) {  // exclusive scan of the digit counts by warp 0
    const int per = (n_digits + 31) / 32;
    unsigned sum = 0;
    for (int k = 0; k < per; ++k) {
      int d = tid * per + k;
      if (d < n_digits) sum += sm.hist[d];
    }
    unsigned inc = sum;
    for (int s = 1; s < 32; s <<= 1) {
      unsigned o = __shfl_up_sync(0xFFFFFFFFu, inc, s);
      if (tid >= s) inc += o;
    }
    unsigned run = inc - sum;
    for (int k = 0; k < per; ++k) {
      int d = tid * per + k;
      if (d < n_digits) {
        sm.start[d] = run;
        run += sm.hist[d];
      }
    }
    if (tid == 31) sm.total = inc;
  }
  for (int d = tid; d < n_digits; d += PART_THREADS)
    if (sm.hist[d]) sm.base[d] = (unsigned)atomicAdd(cursor + d, (int)sm.hist[d]);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < PART_ITEMS; ++u) {
    if (digit[u] == NONE) continue;
    unsigned p = sm.start[digit[u]] + rank[u];
    sm.val[p] = value[u];
    sm.dig[p] = (unsigned char)digit[u];
  }
  __syncthreads();
  for (unsigned p = tid; p < sm.total; p += PART_THREADS) {
    unsigned d = sm.dig[p];
    dst[sm.base[d] + (p - sm.start[d])] = sm.val[p];
  }
  __syncthreads();
}

// One tile's keys. (Loading them a tile ahead, as the second pass does
// its values, needs about 70 registers a thread and made this pass
// slower on the H100.)
struct KeyTile {
  longlong2 c[PART_ITEMS / 2];
  uchar2 v[PART_ITEMS / 2];
};

__device__ __forceinline__ void load_key_tile(const long long* __restrict__ canon,
                                              const uint8_t* __restrict__ valid, int64_t n,
                                              int64_t t0, KeyTile& k) {
#pragma unroll
  for (int u = 0; u < PART_ITEMS / 2; ++u) {
    const int64_t i = t0 + 2 * ((int64_t)u * PART_THREADS + threadIdx.x);
    if (i + 1 < n) {
      k.c[u] = __ldcs(reinterpret_cast<const longlong2*>(canon + i));
      k.v[u] = __ldcs(reinterpret_cast<const uchar2*>(valid + i));
    } else {
      k.c[u].x = i < n ? canon[i] : 0;
      k.c[u].y = 0;
      k.v[u].x = i < n ? valid[i] : 0;
      k.v[u].y = 0;
    }
  }
}

// The first pass: keys -> (digit = bit >> shift, value = bit mod 2^shift).
__global__ void partition_keys_kernel(const long long* __restrict__ canon,
                                      const uint8_t* __restrict__ valid, int64_t n,
                                      unsigned long long bit_mask, int shift, int n_digits,
                                      int* __restrict__ cursor, unsigned* __restrict__ dst) {
  __shared__ PartSmem sm;
  const unsigned long long vmask = (1ull << shift) - 1ull;
  const int64_t step = (int64_t)gridDim.x * PART_TILE;
  for (int64_t t0 = (int64_t)blockIdx.x * PART_TILE; t0 < n; t0 += step) {
    KeyTile cur;
    load_key_tile(canon, valid, n, t0, cur);
    unsigned digit[PART_ITEMS], value[PART_ITEMS];
#pragma unroll
    for (int u = 0; u < PART_ITEMS / 2; ++u) {
      const unsigned long long b0 = (unsigned long long)cur.c[u].x & bit_mask;
      const unsigned long long b1 = (unsigned long long)cur.c[u].y & bit_mask;
      digit[2 * u] = cur.v[u].x ? (unsigned)(b0 >> shift) : NONE;
      digit[2 * u + 1] = cur.v[u].y ? (unsigned)(b1 >> shift) : NONE;
      value[2 * u] = (unsigned)(b0 & vmask);
      value[2 * u + 1] = (unsigned)(b1 & vmask);
    }
    partition_tile(sm, digit, value, n_digits, cursor, dst);
  }
}

// One block's share src[lo .. hi) of range r in the second pass: each
// value goes to digit v >> shift (cursor r * n_digits + digit) as v mod
// 2^shift. Values are loaded a tile ahead.
__device__ __forceinline__ void partition_share(PartSmem& sm,
                                                const unsigned* __restrict__ src, int64_t lo,
                                                int64_t hi, int r, int shift, int n_digits,
                                                int* __restrict__ cursor,
                                                unsigned* __restrict__ dst) {
  const unsigned vmask = (unsigned)((1ull << shift) - 1ull);
  unsigned next[PART_ITEMS];
#pragma unroll
  for (int u = 0; u < PART_ITEMS; ++u) {
    const int64_t i = lo + u * PART_THREADS + threadIdx.x;
    next[u] = i < hi ? __ldcs(src + i) : NONE;
  }
  for (int64_t t0 = lo; t0 < hi; t0 += PART_TILE) {  // uniform over the block
    unsigned digit[PART_ITEMS], value[PART_ITEMS];
#pragma unroll
    for (int u = 0; u < PART_ITEMS; ++u) {
      digit[u] = next[u] == NONE ? NONE : next[u] >> shift;
      value[u] = next[u] & vmask;
      const int64_t i = t0 + PART_TILE + u * PART_THREADS + threadIdx.x;
      next[u] = i < hi ? __ldcs(src + i) : NONE;
    }
    partition_tile(sm, digit, value, n_digits, cursor + (int64_t)r * n_digits, dst);
  }
}

// The second pass as planned by the binning's scan: block b works
// src[plan[b].y .. plan[b].z) of range plan[b].x (a range gets blocks by
// its size, so keys crowded into one range still spread over the card);
// a block with an empty share returns at once.
__global__ void partition_bins_kernel(const unsigned* __restrict__ src,
                                      const int4* __restrict__ plan, int shift, int n_digits,
                                      int* __restrict__ cursor, unsigned* __restrict__ dst) {
  __shared__ PartSmem sm;
  const int4 p = plan[blockIdx.x];
  if (p.y >= p.z) return;
  partition_share(sm, src, p.y, p.z, p.x, shift, n_digits, cursor, dst);
}

// The exclusive prefix of v over the block (at most 1024 threads), and
// the block's total in *total; every thread must call it.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_run[33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += o;
  }
  __syncthreads();  // a previous call's readers are done with warp_run
  if (lane == 31) warp_run[warp] = inc;
  __syncthreads();
  if (warp == 0) {  // the warps' exclusive prefix
    const int w = lane < (int)(blockDim.x >> 5) ? warp_run[lane] : 0;
    int iw = w;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xFFFFFFFFu, iw, d);
      if (lane >= d) iw += o;
    }
    warp_run[lane] = iw - w;
    if (lane == 31) warp_run[32] = iw;
  }
  __syncthreads();
  *total = warp_run[32];
  return warp_run[warp] + inc - v;
}

__device__ __forceinline__ int slices_of(int count, int chunk) {
  return count > 0 ? (count - 1) / chunk + 1 : 0;
}

// The binning's scan, one block, each thread a contiguous run of cells:
// offsets[c] = the sum of counts[i < c] (offsets[n_cells] the total);
// the first pass's cursors cursor_a[c >> digits_b] = offsets[c] at each
// range's first cell (a range is 2^digits_b cells); for a second pass
// (digits_b > 0) its cursors cursor_b[c] = offsets[c] and its plan: each
// range gets one block per `share` keys, share being the total over
// `parts` rounded up to a tile, and block i works plan[i] = (range,
// first key, end), zeros past the last (the sum of ceil(size / share)
// is at most n_ranges + parts = n_plan); and for chunk > 0, each cell's
// slices of at most chunk keys (K5's apply), first[c] = the sum of
// ceil(counts[i] / chunk) over i < c (first[n_cells] the total).
__global__ void bin_scan_kernel(const int* __restrict__ counts, int n_cells, int digits_b,
                                int parts, int chunk, int* __restrict__ offsets,
                                int* __restrict__ cursor_a, int* __restrict__ cursor_b,
                                int4* __restrict__ plan, int n_plan, int* __restrict__ first) {
  __shared__ int range_start[(1 << MAX_DIGITS_LOG2) + 1];
  const int per = (n_cells + blockDim.x - 1) / blockDim.x;
  const int c0 = min(n_cells, (int)threadIdx.x * per), c1 = min(n_cells, c0 + per);
  int sum = 0, slices = 0;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) {
    const int x = counts[c];
    sum += x;
    if (chunk > 0) slices += slices_of(x, chunk);
  }
  int total, n_slices;
  int run = block_exclusive_scan(sum, &total);
  int slice = block_exclusive_scan(slices, &n_slices);
  const int mask = (1 << digits_b) - 1;
  for (int c = c0; c < c1; ++c) {
    const int x = counts[c];
    offsets[c] = run;
    if ((c & mask) == 0) {
      cursor_a[c >> digits_b] = run;
      range_start[c >> digits_b] = run;
    }
    if (digits_b > 0) cursor_b[c] = run;
    if (chunk > 0) {
      first[c] = slice;
      slice += slices_of(x, chunk);
    }
    run += x;
  }
  const int n_ranges = n_cells >> digits_b;
  if (threadIdx.x == 0) {
    offsets[n_cells] = total;
    if (chunk > 0) first[n_cells] = n_slices;
    range_start[n_ranges] = total;
  }
  if (digits_b == 0) return;  // uniform over the block
  __syncthreads();
  const int share = (int)((((int64_t)total + parts - 1) / parts + PART_TILE - 1) / PART_TILE *
                          PART_TILE);
  int lo = 0, hi = 0, blocks = 0;
  if ((int)threadIdx.x < n_ranges) {
    lo = range_start[threadIdx.x];
    hi = range_start[threadIdx.x + 1];
    blocks = hi > lo ? (hi - lo - 1) / share + 1 : 0;
  }
  int used;
  const int b0 = block_exclusive_scan(blocks, &used);
  for (int j = 0; j < blocks; ++j) {
    const int start = lo + j * share;
    const int end = (int)min((int64_t)hi, (int64_t)start + share);
    plan[b0 + j] = make_int4((int)threadIdx.x, start, end, 0);
  }
  for (int i = used + threadIdx.x; i < n_plan; i += blockDim.x) plan[i] = make_int4(0, 0, 0, 0);
}

// words[b >> 5] |= 1 << (b & 31) for the block's share of binned[start ..
// end), APPLY_BATCH loads in flight per thread.
__device__ __forceinline__ void or_keys(unsigned* words, const unsigned* __restrict__ binned,
                                        int start, int end) {
  for (int j0 = start + threadIdx.x; j0 < end; j0 += blockDim.x * APPLY_BATCH) {
    unsigned b[APPLY_BATCH];
#pragma unroll
    for (int u = 0; u < APPLY_BATCH; ++u) {
      const int j = j0 + u * blockDim.x;
      b[u] = j < end ? binned[j] : NONE;
    }
#pragma unroll
    for (int u = 0; u < APPLY_BATCH; ++u)
      if (b[u] != NONE) atomicOr(words + (b[u] >> 5), 1u << (b[u] & 31u));
  }
}

__global__ void apply_kernel(unsigned* __restrict__ words, const unsigned* __restrict__ binned,
                             const int* __restrict__ offsets, int cell_log2) {
  extern __shared__ uint4 cell4[];
  const int64_t c = blockIdx.x;
  const int start = offsets[c], end = offsets[c + 1];
  if (start == end) return;
  const int cell_words = 1 << cell_log2;
  unsigned* g_cell = words + (c << cell_log2);
  if ((int64_t)(end - start) * DIRECT_WORDS_PER_KEY < cell_words) {
    or_keys(g_cell, binned, start, end);
    return;
  }
  unsigned* cell = reinterpret_cast<unsigned*>(cell4);
  uint4* g_cell4 = reinterpret_cast<uint4*>(g_cell);
  const int n4 = cell_words / 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += blockDim.x * APPLY_BATCH) {
    uint4 v[APPLY_BATCH];
#pragma unroll
    for (int u = 0; u < APPLY_BATCH; ++u) {
      int i = i0 + u * blockDim.x;
      if (i < n4) v[u] = g_cell4[i];
    }
#pragma unroll
    for (int u = 0; u < APPLY_BATCH; ++u) {
      int i = i0 + u * blockDim.x;
      if (i < n4) cell4[i] = v[u];
    }
  }
  for (int i = 4 * n4 + threadIdx.x; i < cell_words; i += blockDim.x) cell[i] = g_cell[i];
  __syncthreads();
  or_keys(cell, binned, start, end);
  __syncthreads();
  for (int i = threadIdx.x; i < n4; i += blockDim.x) g_cell4[i] = cell4[i];
  for (int i = 4 * n4 + threadIdx.x; i < cell_words; i += blockDim.x) g_cell[i] = cell[i];
}

// the current device's SMs (1 if the query fails: a smaller grid, the
// same result)
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    return 1;
  return sms;
}

// cells_log2 = bits_log2 - 5 - cell_log2 cells of 2^cell_log2 words
bool bad_cells(int bits_log2, int cell_log2) {
  return bits_log2 < 5 || bits_log2 > 36 || cell_log2 < 0 || cell_log2 > MAX_CELL_LOG2 ||
         cell_log2 > bits_log2 - 5 || bits_log2 - 5 - cell_log2 > MAX_CELLS_LOG2;
}

}  // namespace

// The direct route: one global atomicOr per valid key.
extern "C" int ntsynt_bf_insert(void* words, const void* canon, const void* valid, int64_t n,
                                int bits_log2, void* stream) {
  if (n <= 0) return 0;
  if (bits_log2 < 5 || bits_log2 > 36) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  bf_insert_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (unsigned int*)words, (const long long*)canon, (const uint8_t*)valid, n, bits_log2);
  return (int)cudaGetLastError();
}

// Step (1): counts [2^cells_log2] int, zeroed by the caller, get each
// cell's valid keys. canon must be 16-byte and valid 2-byte aligned.
extern "C" int ntsynt_bf_cell_count(const void* canon, const void* valid, int64_t n,
                                    int bits_log2, int cell_log2, void* counts, void* stream) {
  if (bad_cells(bits_log2, cell_log2) || n <= 0 || n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int n_cells = 1 << (bits_log2 - 5 - cell_log2);
  const size_t smem = (size_t)(n_cells + 1) / 2 * 4;
  cudaError_t e = cudaFuncSetAttribute(cell_count_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int64_t blocks = (n + COUNT_SUB - 1) / COUNT_SUB;
  const int64_t cap = 2ll * sm_count();
  if (blocks > cap) blocks = cap;
  cell_count_kernel<<<(unsigned)blocks, COUNT_THREADS, smem, (cudaStream_t)stream>>>(
      (const long long*)canon, (const uint8_t*)valid, n, (1ull << bits_log2) - 1ull,
      cell_log2 + 5, n_cells, (int*)counts);
  return (int)cudaGetLastError();
}

// Step (2), first pass: each valid key's bit b goes to digit b >> shift
// (2^digits_log2 digits), at cursor[digit]++ in dst, as b mod 2^shift.
extern "C" int ntsynt_bf_partition_keys(const void* canon, const void* valid, int64_t n,
                                        int bits_log2, int digits_log2, int shift, void* cursor,
                                        void* dst, void* stream) {
  if (n <= 0 || n >= (1ll << 31) || bits_log2 < 5 || bits_log2 > 36 || digits_log2 < 0 ||
      digits_log2 > MAX_DIGITS_LOG2 || shift < 0 || shift > 32 || shift + digits_log2 != bits_log2)
    return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + PART_TILE - 1) / PART_TILE;
  const int64_t cap = 4ll * sm_count();
  if (blocks > cap) blocks = cap;
  partition_keys_kernel<<<(unsigned)blocks, PART_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)canon, (const uint8_t*)valid, n, (1ull << bits_log2) - 1ull, shift,
      1 << digits_log2, (int*)cursor, (unsigned*)dst);
  return (int)cudaGetLastError();
}

// The second pass's plan: its length for 2^digits_a ranges, one block
// a range plus `parts` blocks shared out by size, parts being 4 an SM
// (as the first pass's grid) rounded up to a multiple of the ranges.
extern "C" int ntsynt_bf_plan_size(int n_ranges) {
  if (n_ranges <= 0) return 0;
  const int parts = (4 * sm_count() + n_ranges - 1) / n_ranges * n_ranges;
  return n_ranges + parts;
}

// Between steps (1) and (2), one block (bin_scan_kernel): from counts
// [n_cells] int, offsets [n_cells + 1] and the first pass's cursor_a
// [n_cells >> digits_b]; when digits_b > 0, the second pass's cursor_b
// [n_cells] and plan [n_plan] int4 (n_plan from ntsynt_bf_plan_size);
// when chunk > 0, first [n_cells + 1]: each cell's slices of at most
// chunk keys. All int, on the stream.
extern "C" int ntsynt_bf_bin_scan(const void* counts, int n_cells, int digits_b, int chunk,
                                  void* offsets, void* cursor_a, void* cursor_b, void* plan,
                                  int n_plan, void* first, void* stream) {
  const int n_ranges = digits_b >= 0 && digits_b <= MAX_DIGITS_LOG2 ? n_cells >> digits_b : 0;
  if (n_cells <= 0 || n_cells > (1 << MAX_CELLS_LOG2) || n_ranges <= 0 ||
      n_ranges << digits_b != n_cells || n_ranges > (1 << MAX_DIGITS_LOG2) || chunk < 0 ||
      (digits_b > 0 && n_plan <= n_ranges))
    return (int)cudaErrorInvalidValue;
  bin_scan_kernel<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)counts, n_cells, digits_b, n_plan - n_ranges, chunk, (int*)offsets,
      (int*)cursor_a, (int*)cursor_b, (int4*)plan, n_plan, (int*)first);
  return (int)cudaGetLastError();
}

// Step (2), second pass: block i takes src[plan[i].y .. plan[i].z) of
// range plan[i].x (plan [n_plan] int4 from the scan); its value v goes to
// digit v >> shift, at cursor[range * 2^digits_log2 + digit]++ in dst, as
// v mod 2^shift.
extern "C" int ntsynt_bf_partition_bins(const void* src, const void* plan, int n_plan,
                                        int digits_log2, int shift, void* cursor, void* dst,
                                        void* stream) {
  if (n_plan <= 0 || digits_log2 < 0 || digits_log2 > MAX_DIGITS_LOG2 || shift < 0 ||
      shift + digits_log2 > 32)
    return (int)cudaErrorInvalidValue;
  partition_bins_kernel<<<(unsigned)n_plan, PART_THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned*)src, (const int4*)plan, shift, 1 << digits_log2, (int*)cursor,
      (unsigned*)dst);
  return (int)cudaGetLastError();
}

// Step (3): cell c's bits within the cell are binned[offsets[c] ..
// offsets[c + 1]). words must be 16-byte aligned.
extern "C" int ntsynt_bf_apply(void* words, const void* binned, const void* offsets,
                               int bits_log2, int cell_log2, void* stream) {
  if (bad_cells(bits_log2, cell_log2)) return (int)cudaErrorInvalidValue;
  const int n_cells = 1 << (bits_log2 - 5 - cell_log2);
  const size_t smem = (size_t)4 << cell_log2;
  cudaError_t e = cudaFuncSetAttribute(apply_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // 1024 threads for a 128 KiB cell (one block per SM), 512 below (more)
  const int threads = cell_log2 >= 15 ? 1024 : 512;
  apply_kernel<<<n_cells, threads, smem, (cudaStream_t)stream>>>(
      (unsigned*)words, (const unsigned*)binned, (const int*)offsets, cell_log2);
  return (int)cudaGetLastError();
}
