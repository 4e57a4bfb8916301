// K3: minimizer stream compaction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ntsynt_tpu/ops/sketch_device.py
// (_compact_kernel, launched by _compact_call / compact_rows /
// compact_positions), fused with the run-start flag and legit-window
// mask that the JAX package computes in XLA (_run_start_flag).
//
// Inputs per window j in [0, nw): its leftmost argmin position arg[j],
// its min hash minv[j] (all-ones = no valid k-mer in the window) and
// legit[j] (1 when the window lies inside one contig). A window is live
// when legit and valid; it is flagged when it is live and starts a run
// of the argmin sequence:
//   flag[j] = live[j] && (j == 0 || !live[j-1] || arg[j] != arg[j-1]).
// The flagged (arg, minv) pairs are written densely, in window order.
// The argmin is monotone in j, and a position's live windows are one
// contiguous range, so each selected position is written exactly once.
//
// Bound on the H100: memory. 8 + 8 + 1 bytes read per window and
// 16 bytes written per selected position, at 3.35 TB/s.
//
// Design: three launches. (1) each block of 1024 windows counts its
// flags; (2) one block scans the block counts into exclusive offsets and
// the total; (3) each block recomputes its flags, ranks them with warp
// ballots and writes at its offset. There is no per-tile capacity, so
// the TPU kernel's CAP=128 slots, one-hot MXU packing and host
// recompute of overflowing tiles have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 1024;  // windows (= threads) per block

__device__ __forceinline__ bool live(const long long* minv, const uint8_t* legit, int64_t j) {
  return legit[j] != 0 && minv[j] != -1LL;
}

__device__ __forceinline__ bool flag_at(const long long* arg, const long long* minv,
                                        const uint8_t* legit, int64_t nw, int64_t j) {
  if (j >= nw || !live(minv, legit, j)) return false;
  if (j == 0 || !live(minv, legit, j - 1)) return true;
  return arg[j] != arg[j - 1];
}

__global__ void count_kernel(const long long* __restrict__ arg, const long long* __restrict__ minv,
                             const uint8_t* __restrict__ legit, int64_t nw,
                             long long* __restrict__ counts) {
  __shared__ int warp_tot[BLOCK / 32];
  int64_t j = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  bool f = flag_at(arg, minv, legit, nw, j);
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, f);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int i = 0; i < BLOCK / 32; ++i) s += warp_tot[i];
    counts[blockIdx.x] = s;
  }
}

// one block: counts[nblk] -> exclusive offsets (in place) + total
__global__ void scan_kernel(long long* __restrict__ counts, int64_t nblk,
                            long long* __restrict__ total) {
  __shared__ long long buf[BLOCK];
  long long carry = 0;
  for (int64_t base = 0; base < nblk; base += BLOCK) {
    int64_t i = base + threadIdx.x;
    long long v = i < nblk ? counts[i] : 0;
    buf[threadIdx.x] = v;
    __syncthreads();
    for (int s = 1; s < BLOCK; s <<= 1) {
      long long add = threadIdx.x >= s ? buf[threadIdx.x - s] : 0;
      __syncthreads();
      buf[threadIdx.x] += add;
      __syncthreads();
    }
    if (i < nblk) counts[i] = carry + buf[threadIdx.x] - v;
    long long chunk = buf[BLOCK - 1];
    __syncthreads();
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void scatter_kernel(const long long* __restrict__ arg,
                               const long long* __restrict__ minv,
                               const uint8_t* __restrict__ legit, int64_t nw,
                               const long long* __restrict__ offsets,
                               long long* __restrict__ out_pos,
                               long long* __restrict__ out_hash) {
  __shared__ int warp_off[BLOCK / 32];
  int64_t j = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  bool f = flag_at(arg, minv, legit, nw, j);
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, f);
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  if (lane == 0) warp_off[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int i = 0; i < BLOCK / 32; ++i) {
      int c = warp_off[i];
      warp_off[i] = s;
      s += c;
    }
  }
  __syncthreads();
  if (f) {
    int rank = __popc(ballot & ((1u << lane) - 1u));
    int64_t o = offsets[blockIdx.x] + warp_off[warp] + rank;
    out_pos[o] = arg[j];
    out_hash[o] = minv[j];
  }
}

}  // namespace

// launches (1) and (2): block_counts[nblk] becomes the exclusive block
// offsets and *total the number of flagged windows
extern "C" int ntsynt_compact_count(const void* arg, const void* minv, const void* legit,
                                    int64_t nw, void* block_counts, void* total,
                                    void* stream) {
  int64_t nblk = (nw + BLOCK - 1) / BLOCK;
  if (nblk <= 0 || nblk > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  count_kernel<<<(unsigned)nblk, BLOCK, 0, s>>>((const long long*)arg, (const long long*)minv,
                                                (const uint8_t*)legit, nw,
                                                (long long*)block_counts);
  int err = (int)cudaGetLastError();
  if (err) return err;
  scan_kernel<<<1, BLOCK, 0, s>>>((long long*)block_counts, nblk, (long long*)total);
  return (int)cudaGetLastError();
}

// launch (3): write the flagged (arg, minv) pairs at their offsets
extern "C" int ntsynt_compact_scatter(const void* arg, const void* minv, const void* legit,
                                      int64_t nw, const void* block_offsets, void* out_pos,
                                      void* out_hash, void* stream) {
  int64_t nblk = (nw + BLOCK - 1) / BLOCK;
  if (nblk <= 0 || nblk > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  scatter_kernel<<<(unsigned)nblk, BLOCK, 0, (cudaStream_t)stream>>>(
      (const long long*)arg, (const long long*)minv, (const uint8_t*)legit, nw,
      (const long long*)block_offsets, (long long*)out_pos, (long long*)out_hash);
  return (int)cudaGetLastError();
}
