// K3: minimizer stream compaction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ntsynt_tpu/ops/sketch_device.py
// (_compact_kernel, launched by _compact_call / compact_rows /
// compact_positions), fused with the run-start flag and legit-window
// mask that the JAX package computes in XLA (_run_start_flag).
//
// Inputs per window j in [0, nw): its leftmost argmin position arg[j],
// its min hash minv[j] (all-ones = no valid k-mer in the window) and its
// legit bit (set when the window lies inside one contig): bit
// legit_off + j of the little-endian bit array legit (byte b holds bits
// 8b..8b+7, lowest first), so a segment or a mesh share may start at any
// window of the stream's mask. A window is live
// when legit and valid; it is flagged when it is live and starts a run
// of the argmin sequence:
//   flag[j] = live[j] && (j == 0 || !live[j-1] || arg[j] != arg[j-1]).
// The flagged (arg, minv) pairs are written densely, in window order.
// The argmin is monotone in j, and a position's live windows are one
// contiguous range, so each selected position is written exactly once.
//
// Bound on the H100: memory. 8 + 8 bytes and one bit read per window
// and 16 bytes written per selected position, at 3.35 TB/s.
//
// Design: one launch, a single-pass chained scan with decoupled
// look-back (Merrill and Garland, 2016), written here.
//   A block takes the next tile of TILE windows from a global ticket (so
//   a tile only ever waits on tiles whose blocks are already running).
//   Its legit bits are staged in shared memory as 128 32-bit words, word
//   q holding the tile's windows 32q..32q+31 (bit i = window 32q + i,
//   assembled from five bytes at any bit offset, zero past nw); each
//   warp owns 512 consecutive windows, and each lane loads two
//   consecutive windows' arg and minv with one 16-byte load each, for
//   eight steps of 64 windows, all issued before any is used. The window
//   before a warp's first is read from device memory. Flags come from
//   warp shuffles and ballots; the block sums the warps' counts, and warp
//   0 publishes the tile's count in a tile-status word (value << 2 |
//   flag: 1 = count, 2 = inclusive prefix), then looks back over 32
//   predecessors at a time, adding counts until it meets a prefix, and
//   publishes its own prefix. Each lane then writes its flagged pairs at
//   its rank. The input is read once; there is no one-block scan and no
//   host sync between passes. The last tile writes the total, which the
//   wrapper reads once to size its result. The status words and ticket
//   are scratch the wrapper allocates and the entry point clears on the
//   stream before the launch. Three blocks per SM
//   (85 registers a thread) measured faster than two (115) or than
//   smaller tiles with more blocks. The output may be the input itself
//   (see compact_kernel), which the sketch uses so that compaction needs
//   no buffer of nw entries.
// The TPU kernel's CAP=128 slots per tile, its one-hot MXU packing and
// the host recompute of overflowing tiles have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STEPS = 8;                     // 64-window steps per warp
constexpr int WARP_WINDOWS = 64 * STEPS;     // 512
constexpr int TILE = WARPS * WARP_WINDOWS;   // windows per tile (4096)
constexpr int BLOCKS_PER_SM = 3;             // at most 85 registers a thread
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned long long ST_COUNT = 1, ST_PREFIX = 2;

__device__ __forceinline__ void st_status(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(FULL, v, s);
  return v;
}

// warp 0: the tile's exclusive offset, by look-back over the status words
__device__ long long look_back(unsigned long long* status, int64_t tile, int lane) {
  long long excl = 0;
  for (int64_t pred = tile - 1;; pred -= 32) {
    int64_t idx = pred - lane;
    unsigned long long s = ST_PREFIX;  // before tile 0: a prefix of 0
    if (idx >= 0) {
      do {
        s = ld_status(status + idx);
      } while ((s & 3) == 0);
    }
    unsigned prefix = __ballot_sync(FULL, (s & 3) == ST_PREFIX);
    long long v = (long long)(s >> 2);
    if (prefix) {
      int nearest = __ffs(prefix) - 1;
      return excl + warp_sum(lane <= nearest ? v : 0);
    }
    excl += warp_sum(v);
  }
}

// arg / out_pos and minv / out_hash may be the same arrays (no
// __restrict__, no read-only loads): a tile reads all its windows, and
// the one before them, before it publishes its count, and it writes only
// after every tile before it has published; a result lands at or before
// its own window, and where it lands on a window a later tile reads (the
// one before that tile) it is that window's own value.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    compact_kernel(const long long* arg, const long long* minv,
                   const uint8_t* __restrict__ legit, int64_t legit_off,
                   int64_t legit_bytes, int64_t nw,
                   unsigned long long* __restrict__ scratch, long long* out_pos,
                   long long* out_hash) {
  __shared__ uint32_t leg[TILE / 32];
  __shared__ long long warp_off[WARPS];
  __shared__ int64_t s_tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_tile = (int64_t)atomicAdd(scratch, 1ull);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t ntiles = (nw + TILE - 1) / TILE;
  const int64_t base = tile * TILE;

  // legit bits, staged; arg and minv, two windows a lane per step
  for (int q = threadIdx.x; q < TILE / 32; q += THREADS) {
    int64_t g = base + 32 * (int64_t)q;
    uint32_t word = 0;
    if (g < nw) {
      int64_t bit = legit_off + g, b = bit >> 3;
      unsigned long long v = 0;
      for (int i = 0; i < 5; ++i)
        if (b + i < legit_bytes) v |= (unsigned long long)__ldg(legit + b + i) << (8 * i);
      word = (uint32_t)(v >> (bit & 7));
      if (nw - g < 32) word &= (1u << (nw - g)) - 1u;
    }
    leg[q] = word;
  }
  const int64_t wbase = base + (int64_t)warp * WARP_WINDOWS;
  longlong2 a[STEPS], m[STEPS];
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    int64_t g = wbase + 64 * j + 2 * lane;
    if (g + 1 < nw) {
      a[j] = *reinterpret_cast<const longlong2*>(arg + g);
      m[j] = *reinterpret_cast<const longlong2*>(minv + g);
    } else {
      a[j] = make_longlong2(g < nw ? arg[g] : 0, 0);
      m[j] = make_longlong2(g < nw ? minv[g] : -1, -1);
    }
  }
  // the window before the warp's first
  long long prev_a = 0;
  bool prev_live = false;
  if (wbase > 0 && wbase <= nw) {
    prev_a = arg[wbase - 1];
    int64_t bit = legit_off + wbase - 1;
    prev_live = ((legit[bit >> 3] >> (bit & 7)) & 1) != 0 && minv[wbase - 1] != -1;
  }
  __syncthreads();

  const uint32_t* lw = leg + warp * (WARP_WINDOWS / 32);
  unsigned b0[STEPS], b1[STEPS];
  long long count = 0;
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    unsigned l2 = (lw[2 * j + (lane >> 4)] >> ((2 * lane) & 31)) & 3u;
    bool live0 = (l2 & 1u) != 0 && m[j].x != -1;
    bool live1 = (l2 & 2u) != 0 && m[j].y != -1;
    long long up_a = __shfl_up_sync(FULL, a[j].y, 1);
    bool up_live = __shfl_up_sync(FULL, (int)live1, 1) != 0;
    if (lane == 0) {
      up_a = prev_a;
      up_live = prev_live;
    }
    b0[j] = __ballot_sync(FULL, live0 && (!up_live || a[j].x != up_a));
    b1[j] = __ballot_sync(FULL, live1 && (!live0 || a[j].y != a[j].x));
    count += __popc(b0[j]) + __popc(b1[j]);
    prev_a = __shfl_sync(FULL, a[j].y, 31);
    prev_live = __shfl_sync(FULL, (int)live1, 31) != 0;
  }
  if (lane == 0) warp_off[warp] = count;
  __syncthreads();

  if (warp == 0) {
    long long c = lane < WARPS ? warp_off[lane] : 0;
    long long incl = c;
    for (int s = 1; s < WARPS; s <<= 1) {
      long long up = __shfl_up_sync(FULL, incl, s);
      if (lane >= s) incl += up;
    }
    long long agg = __shfl_sync(FULL, incl, WARPS - 1);
    unsigned long long* status = scratch + 2;
    long long excl = 0;
    if (tile == 0) {
      if (lane == 0) st_status(status, ((unsigned long long)agg << 2) | ST_PREFIX);
    } else {
      if (lane == 0) st_status(status + tile, ((unsigned long long)agg << 2) | ST_COUNT);
      excl = look_back(status, tile, lane);
      if (lane == 0) st_status(status + tile, ((unsigned long long)(excl + agg) << 2) | ST_PREFIX);
    }
    if (lane == 0 && tile == ntiles - 1) scratch[1] = (unsigned long long)(excl + agg);
    if (lane < WARPS) warp_off[lane] = excl + incl - c;
  }
  __syncthreads();

  long long off = warp_off[warp];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    long long o = off + __popc(b0[j] & below) + __popc(b1[j] & below);
    bool f0 = (b0[j] >> lane) & 1u, f1 = (b1[j] >> lane) & 1u;
    if (f0) {
      out_pos[o] = a[j].x;
      out_hash[o] = m[j].x;
    }
    if (f1) {
      out_pos[o + f0] = a[j].y;
      out_hash[o + f0] = m[j].y;
    }
    off += __popc(b0[j]) + __popc(b1[j]);
  }
}

}  // namespace

// One launch, after clearing scratch: 2 + ceil(nw / TILE) 64-bit words
// (ticket, total, tile status) on the stream. out_pos / out_hash: nw
// entries each (they may be arg and minv), of which the first scratch[1]
// hold the flagged windows. arg and minv must be 16-byte aligned; legit
// holds legit_bytes bytes, at least ceil((legit_off + nw) / 8).
extern "C" int ntsynt_compact(const void* arg, const void* minv, const void* legit,
                              int64_t legit_off, int64_t legit_bytes, int64_t nw, void* scratch,
                              void* out_pos, void* out_hash, void* stream) {
  int64_t tiles = (nw + TILE - 1) / TILE;
  if (tiles <= 0 || tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (legit_off < 0 || legit_bytes * 8 < legit_off + nw) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)arg | (uintptr_t)minv) & 15) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(2 + tiles) * 8, s);
  if (e != cudaSuccess) return (int)e;
  compact_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(
      (const long long*)arg, (const long long*)minv, (const uint8_t*)legit, legit_off,
      legit_bytes, nw,
      (unsigned long long*)scratch, (long long*)out_pos, (long long*)out_hash);
  return (int)cudaGetLastError();
}
