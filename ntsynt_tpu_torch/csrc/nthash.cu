// K1: ntHash k-mer hashing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ntsynt_tpu/ops/nthash_pallas.py
// (_hash_kernel, launched by _hash_call / hash_keys). On the GPU this one
// kernel also does the Bloom-filter build's hashing, which the JAX
// package runs in XLA (ops/nthash.hash_tile).
//
// For every k-mer start i of a code array (A=0 C=1 G=2 T=3, >=4 = N):
//   f     = XOR_j srol^(k-1-j)(S[c_{i+j}])        forward strand
//   r     = XOR_j srol^j(S[comp c_{i+j}])         reverse strand
//   canon = f + r  (mod 2^64)                     Bloom-filter key
//   t     = canon * mult  (mod 2^64)
//   key   = t ^ (t >> 27)                         printed / minimizer-order hash
// with S the seed table (S[N] = 0) and srol the ntHash2 split rotate. A
// k-mer holding any code >= 4 is invalid: its key is the all-ones
// sentinel and valid[i] = 0 (canon is still written, unmasked).
//
// Bound on the H100: memory. Per k-mer it must read 1 code byte and
// write 8 + 8 + 1 bytes: 18 B/k-mer at 3.35 TB/s.
//
// Design: ntHash's own recurrence, O(1) per k-mer after the first.
//   f_{i+1} = srol(f_i) ^ OUT_F[c_i] ^ IN_F[c_{i+k}]
//   r_{i+1} = sror(r_i) ^ OUT_R[c_i] ^ IN_R[c_{i+k}]
// (five-entry tables built by ops/nthash.roll_tables, passed by value and
// kept in shared memory as (F, R) pairs, one 16-byte load per code). The
// first k-mer of a run is the "in" step applied k times from f = r = 0.
// Validity is the length of the run of non-N codes ending at the k-mer's
// last code, saturated at k.
//   A block of THREADS threads owns THREADS * R consecutive k-mers. It
//   copies their codes and the k-1 halo into shared memory once, with
//   16-byte loads, eight in flight per thread (aligned down, so a codes
//   view at any offset works). Each thread hashes the first k-mer of its
//   run of R directly (k steps, k/R per k-mer) and rolls R-1 times,
//   reading four outgoing and four incoming codes per pair of 4-byte
//   shared loads. After each PHASE = 16 k-mers it parks its 16 keys and
//   16 canons as one shared-memory row each (128 bytes + 16 of padding,
//   so 16-byte accesses hit distinct banks), and the warp writes its 32
//   rows out with 16-byte stores, four whole 128-byte lines per store
//   instruction. Writing each thread's outputs straight from registers
//   (whole 32-byte sectors, but each line finished over many phases, so
//   lines stay half written across the grid) ran at 2.5 ms for 2^26
//   k-mers on an H100; whole lines at once, 0.42 ms. R = 16 (the wrapper's
//   choice at k <= 32) makes a warp's 32 rows one contiguous 4 KiB; a
//   longer k takes R = 16 m with m odd, so that the rows' stride is no
//   power of two. valid bytes gather in shared memory and each warp
//   writes its 32 * R bytes at the end, coalesced. Offsets into device
//   memory are 64-bit. A k above MAX_STAGED_K (a halo too large to
//   stage) reads the incoming codes from device memory instead.
// The TPU kernel's k passes of VMEM lane rolls over uint32 hash halves
// have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int PHASE = 16;             // k-mers a thread rolls between stores
constexpr int ROW = PHASE * 8 + 16;   // bytes of a staged row of PHASE outputs
constexpr int CHUNKS = PHASE / 2;     // 16-byte pieces of a row
constexpr int MAX_RUN = 240;
constexpr int MAX_STAGED_K = 4096;
constexpr int STAGE_BATCH = 8;        // 16-byte loads in flight per thread

struct RollTables {
  unsigned long long v[20];  // (OUT_F, OUT_R) x 5 codes, then (IN_F, IN_R) x 5
};

__device__ __forceinline__ unsigned long long srol(unsigned long long x) {
  return ((x << 1) & 0xFFFFFFFDFFFFFFFFull) | ((x >> 30) & (1ull << 33)) | ((x >> 32) & 1ull);
}

__device__ __forceinline__ unsigned long long sror(unsigned long long x) {
  return ((x >> 1) & 0xFFFFFFFEFFFFFFFFull) | ((x & 1ull) << 32) | ((x << 30) & (1ull << 63));
}

// Codes of one tile: code l (relative to the tile's first k-mer) sits at
// byte shift + l of the staged words; codes past `staged` come from
// device memory (only when the halo is too large to stage).
template <bool STAGED>
struct Codes {
  const uint32_t* words;
  int shift;
  int64_t staged;
  const uint8_t* g;  // the tile's first code in device memory
  int64_t avail;     // codes readable from g

  // codes l .. l+3, packed little-endian; N past the end of the array
  __device__ __forceinline__ uint32_t load4(int64_t l) const {
    if (STAGED || l + 4 <= staged) {
      int off = shift + (int)l;
      uint32_t lo = words[off >> 2], hi = words[(off >> 2) + 1];
      return __funnelshift_r(lo, hi, (off & 3) * 8);
    }
    uint32_t w = 0;
    for (int b = 0; b < 4; ++b) w |= (l + b < avail ? (uint32_t)__ldg(g + l + b) : 4u) << (8 * b);
    return w;
  }
};

__device__ __forceinline__ void store2(long long* p, int64_t i, int64_t n, ulonglong2 v) {
  if (i + 1 < n) {
    *reinterpret_cast<ulonglong2*>(p + i) = v;
  } else if (i < n) {
    p[i] = (long long)v.x;
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS) nthash_kernel(
    const uint8_t* __restrict__ codes, int64_t n_kmers, int k, RollTables tables,
    unsigned long long mult, int run, long long* __restrict__ key,
    long long* __restrict__ canon, uint8_t* __restrict__ valid) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ ulonglong2 tab[10];  // [0, 5) outgoing code, [5, 10) incoming
  const int tile = THREADS * run;
  const int64_t base = (int64_t)blockIdx.x * tile;
  const int64_t n_codes = n_kmers + k - 1;
  const int shift = (int)((uintptr_t)codes & 15);
  const int64_t staged = STAGED ? (int64_t)tile + k + 3 : (int64_t)tile + 3;
  const int stage_bytes = (int)((shift + staged + 4 + 15) & ~15ll);
  uint8_t* vbuf = smem + stage_bytes;  // the tile's valid bytes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this warp's rows of PHASE keys and of PHASE canons
  uint8_t* kbuf = vbuf + tile + warp * 2 * 32 * ROW;
  uint8_t* cbuf = kbuf + 32 * ROW;

  if (threadIdx.x < 10)
    tab[threadIdx.x] = make_ulonglong2(tables.v[2 * threadIdx.x], tables.v[2 * threadIdx.x + 1]);
  // stage the codes from the 16-byte boundary at or below the tile's
  // first, STAGE_BATCH loads in flight per thread
  const uint8_t* g0 = codes + base - shift;
  const uint8_t* end = codes + n_codes;
  const int nq = stage_bytes / 16;
  for (int q0 = threadIdx.x; q0 < nq; q0 += THREADS * STAGE_BATCH) {
    uint4 v[STAGE_BATCH];
#pragma unroll
    for (int i = 0; i < STAGE_BATCH; ++i) {
      const uint8_t* src = g0 + 16 * (int64_t)(q0 + i * THREADS);
      if (q0 + i * THREADS >= nq) break;
      if (src >= codes && src + 16 <= end) {
        v[i] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        union {
          uint4 v;
          uint8_t b[16];
        } u;
        for (int j = 0; j < 16; ++j) u.b[j] = (src + j >= codes && src + j < end) ? src[j] : 4;
        v[i] = u.v;
      }
    }
#pragma unroll
    for (int i = 0; i < STAGE_BATCH; ++i)
      if (q0 + i * THREADS < nq) reinterpret_cast<uint4*>(smem)[q0 + i * THREADS] = v[i];
  }
  __syncthreads();

  const Codes<STAGED> src{reinterpret_cast<const uint32_t*>(smem), shift, staged, codes + base,
                          n_codes - base};
  const ulonglong2* out_t = tab;
  const ulonglong2* in_t = tab + 5;
  const int l0 = threadIdx.x * run;  // the run's first k-mer in the tile

  // the run's first k-mer, directly
  unsigned long long f = 0, r = 0;
  int good = 0;  // non-N codes ending here, at most k
  for (int64_t j = 0; j < k; j += 4) {
    uint32_t w = src.load4(l0 + j);
    int m = k - j < 4 ? (int)(k - j) : 4;
    for (int b = 0; b < m; ++b) {
      unsigned c = (w >> (8 * b)) & 255u;
      ulonglong2 t = in_t[c < 4 ? c : 4];
      f = srol(f) ^ t.x;
      r = sror(r) ^ t.y;
      good = c < 4 ? min(good + 1, k) : 0;
    }
  }

  // roll PHASE k-mers at a time; the warp then writes its 32 threads'
  // lines of key and canon, four whole lines per store instruction
  for (int p = 0; p < run / PHASE; ++p) {
#pragma unroll
    for (int q = 0; q < PHASE / 4; ++q) {
      const int l = l0 + PHASE * p + 4 * q;
      uint32_t wo = src.load4(l);
      uint32_t wi = src.load4(l + (int64_t)k);
      unsigned long long kk[4], cc[4];
      uint32_t vb = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        unsigned long long cn = f + r;
        unsigned long long t = cn * mult;
        bool ok = good == k;
        kk[b] = ok ? (t ^ (t >> 27)) : ~0ull;
        cc[b] = cn;
        vb |= (uint32_t)ok << (8 * b);
        unsigned co = (wo >> (8 * b)) & 255u, ci = (wi >> (8 * b)) & 255u;
        ulonglong2 to = out_t[co < 4 ? co : 4], ti = in_t[ci < 4 ? ci : 4];
        f = srol(f) ^ to.x ^ ti.x;
        r = sror(r) ^ to.y ^ ti.y;
        good = ci < 4 ? min(good + 1, k) : 0;
      }
      ulonglong2* kr = reinterpret_cast<ulonglong2*>(kbuf + lane * ROW + 32 * q);
      ulonglong2* cr = reinterpret_cast<ulonglong2*>(cbuf + lane * ROW + 32 * q);
      kr[0] = make_ulonglong2(kk[0], kk[1]);
      kr[1] = make_ulonglong2(kk[2], kk[3]);
      cr[0] = make_ulonglong2(cc[0], cc[1]);
      cr[1] = make_ulonglong2(cc[2], cc[3]);
      reinterpret_cast<uint32_t*>(vbuf)[l >> 2] = vb;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int row = i * (32 / CHUNKS) + lane / CHUNKS, chunk = lane % CHUNKS;
      const int64_t g = base + (int64_t)(warp * 32 + row) * run + PHASE * p + 2 * chunk;
      store2(key, g, n_kmers, *reinterpret_cast<const ulonglong2*>(kbuf + row * ROW + 16 * chunk));
      store2(canon, g, n_kmers,
             *reinterpret_cast<const ulonglong2*>(cbuf + row * ROW + 16 * chunk));
    }
    __syncwarp();
  }

  // each warp writes its 32 runs' valid bytes, coalesced
  const int wbytes = 32 * run;
  const int64_t gw = base + (int64_t)warp * wbytes;
  for (int q = lane; q < wbytes / 16; q += 32) {
    int64_t g = gw + 16 * (int64_t)q;
    const uint8_t* s = vbuf + warp * wbytes + 16 * q;
    if (g + 16 <= n_kmers) {
      *reinterpret_cast<uint4*>(valid + g) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int b = 0; b < 16; ++b)
        if (g + b < n_kmers) valid[g + b] = s[b];
    }
  }
}

template <bool STAGED>
int launch(const void* codes, int64_t n_kmers, int k, const RollTables& tabs,
           unsigned long long mult, int run, void* key, void* canon, void* valid,
           cudaStream_t s) {
  const int tile = THREADS * run;
  int64_t blocks = (n_kmers + tile - 1) / tile;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  int64_t codes_len = STAGED ? (int64_t)tile + k + 3 : (int64_t)tile + 3;
  size_t smem = (size_t)((15 + codes_len + 4 + 15) & ~15ll) + tile + THREADS / 32 * 2 * 32 * ROW;
  // raise the kernel's shared-memory limit once per device and size (the
  // call costs more host time than a small launch)
  static int limit[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || limit[dev] < (int)smem) {
    e = cudaFuncSetAttribute(nthash_kernel<STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) limit[dev] = (int)smem;
  }
  nthash_kernel<STAGED><<<(unsigned)blocks, THREADS, smem, s>>>(
      (const uint8_t*)codes, n_kmers, k, tabs, mult, run, (long long*)key, (long long*)canon,
      (uint8_t*)valid);
  return (int)cudaGetLastError();
}

}  // namespace

// tables: host pointer to the 20 roll-table words; run: k-mers per
// thread (a multiple of PHASE, at most MAX_RUN)
extern "C" int ntsynt_nthash(const void* codes, int64_t n_kmers, int k, const void* tables,
                             unsigned long long mult, int run, void* key, void* canon,
                             void* valid, void* stream) {
  if (n_kmers <= 0) return 0;
  if (k < 1 || run < PHASE || run > MAX_RUN || run % PHASE) return (int)cudaErrorInvalidValue;
  RollTables tabs;
  for (int i = 0; i < 20; ++i) tabs.v[i] = ((const unsigned long long*)tables)[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= MAX_STAGED_K)
    return launch<true>(codes, n_kmers, k, tabs, mult, run, key, canon, valid, s);
  return launch<false>(codes, n_kmers, k, tabs, mult, run, key, canon, valid, s);
}
