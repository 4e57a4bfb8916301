// K5: binned Bloom-filter sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ntsynt_tpu/ops/bf_sweep.py
// (_sweep_kernel, launched by _sweep_call from insert_segment and
// cascade_segment). For one segment of keys, with b = bits_log2 (16..32)
// and bit(h) = h mod 2^b:
//   insert:  words |= OR over valid keys of (1 << bit(h))
//   cascade: words |= OR over valid keys with prev[bit(h)] set of
//            (1 << bit(h))                (insert-if-present)
// which is the reference's per-k-mer cascade
// (src/ntsynt_make_common_bf.cpp:140-160) for one hash function.
//
// The TPU kernel sorts and dedupes the bit indices so that one-hot bf16
// MXU products of byte planes sum to exact ORs, and sweeps 2^20-bit
// cells through VMEM. Hopper has no need for the sort, the dedupe or the
// matmuls: shared-memory atomicOr is order-free and idempotent.
//
// Bound on the H100: memory. 8 + 1 bytes read per key (canon, valid),
// plus a read and a write of each distinct filter word that a valid key
// hits (and, in cascade mode, a read of the same word of prev), at
// 3.35 TB/s.
//
// Design: three launches and one prefix sum.
//   (1) count: each valid key adds one to its cell's count (global
//       atomicAdd; a cell is 2^cell_log2 words);
//   (2) the wrapper turns the counts into offsets (torch.cumsum);
//   (3) scatter: each valid key takes a slot of its cell (atomicAdd on
//       the cell's cursor) and writes its bit index within the cell;
//   (4) sweep: one block per cell that holds keys loads the cell's words
//       (and in cascade mode prev's) into dynamic shared memory with
//       16-byte loads, applies the cell's keys with shared-memory
//       atomicOr, and writes the cell back. A cell of 2^14 words is
//       64 KiB, so the cascade's two cells (128 KiB) fit one block's
//       227 KB; both need cudaFuncSetAttribute above 48 KB. Cells that
//       no key hits are neither read nor written. The order of keys in a
//       cell is not fixed, and the result does not depend on it; there
//       is no per-cell capacity, so nothing falls back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SWEEP_THREADS = 512;

__global__ void sweep_count_kernel(const long long* __restrict__ canon,
                                   const uint8_t* __restrict__ valid, int64_t n,
                                   unsigned bit_mask, int cell_shift,
                                   int* __restrict__ counts) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (!valid[i]) continue;
    unsigned bit = (unsigned)canon[i] & bit_mask;
    atomicAdd(counts + (bit >> cell_shift), 1);
  }
}

__global__ void sweep_scatter_kernel(const long long* __restrict__ canon,
                                     const uint8_t* __restrict__ valid, int64_t n,
                                     unsigned bit_mask, int cell_shift,
                                     int* __restrict__ cursor, unsigned* __restrict__ binned) {
  const unsigned in_cell = (1u << cell_shift) - 1u;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (!valid[i]) continue;
    unsigned bit = (unsigned)canon[i] & bit_mask;
    int slot = atomicAdd(cursor + (bit >> cell_shift), 1);
    binned[slot] = bit & in_cell;
  }
}

template <bool CASCADE>
__global__ void sweep_apply_kernel(unsigned* __restrict__ words, const unsigned* __restrict__ prev,
                                   const unsigned* __restrict__ binned,
                                   const int* __restrict__ offsets, int cell_words) {
  extern __shared__ uint4 smem4[];
  const int cell = blockIdx.x;
  const int start = offsets[cell];
  const int end = offsets[cell + 1];
  if (start == end) return;
  unsigned* s_new = reinterpret_cast<unsigned*>(smem4);
  unsigned* s_prev = s_new + cell_words;
  const int n4 = cell_words / 4;
  uint4* g_new = reinterpret_cast<uint4*>(words + (int64_t)cell * cell_words);
  const uint4* g_prev =
      CASCADE ? reinterpret_cast<const uint4*>(prev + (int64_t)cell * cell_words) : nullptr;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    smem4[i] = g_new[i];
    if (CASCADE) smem4[n4 + i] = g_prev[i];
  }
  __syncthreads();
  for (int j = start + threadIdx.x; j < end; j += blockDim.x) {
    unsigned b = binned[j];
    unsigned w = b >> 5, m = 1u << (b & 31u);
    if (!CASCADE || (s_prev[w] & m)) atomicOr(s_new + w, m);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n4; i += blockDim.x) g_new[i] = smem4[i];
}

int grid_for(int64_t n) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loops cover the rest
  return (int)blocks;
}

}  // namespace

// Cell of key i: (canon[i] mod 2^bits_log2) >> (cell_log2 + 5); counts
// has one int per cell and must be zeroed by the caller.
extern "C" int ntsynt_bf_sweep_count(const void* canon, const void* valid, int64_t n,
                                     int bits_log2, int cell_log2, void* counts, void* stream) {
  if (n <= 0) return 0;
  if (bits_log2 < 16 || bits_log2 > 32 || cell_log2 < 2 || cell_log2 > bits_log2 - 5)
    return (int)cudaErrorInvalidValue;
  unsigned bit_mask = bits_log2 == 32 ? 0xFFFFFFFFu : ((1u << bits_log2) - 1u);
  sweep_count_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)canon, (const uint8_t*)valid, n, bit_mask, cell_log2 + 5, (int*)counts);
  return (int)cudaGetLastError();
}

// cursor: each cell's first slot (the exclusive prefix of the counts);
// advanced in place. binned gets each valid key's bit within its cell.
extern "C" int ntsynt_bf_sweep_scatter(const void* canon, const void* valid, int64_t n,
                                       int bits_log2, int cell_log2, void* cursor, void* binned,
                                       void* stream) {
  if (n <= 0) return 0;
  if (bits_log2 < 16 || bits_log2 > 32 || cell_log2 < 2 || cell_log2 > bits_log2 - 5)
    return (int)cudaErrorInvalidValue;
  unsigned bit_mask = bits_log2 == 32 ? 0xFFFFFFFFu : ((1u << bits_log2) - 1u);
  sweep_scatter_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)canon, (const uint8_t*)valid, n, bit_mask, cell_log2 + 5, (int*)cursor,
      (unsigned*)binned);
  return (int)cudaGetLastError();
}

// offsets: [n_cells + 1] int, cell c's keys are binned[offsets[c] ..
// offsets[c+1]). prev == NULL selects insert mode, else cascade mode.
// words (and prev) must be 16-byte aligned.
extern "C" int ntsynt_bf_sweep_apply(void* words, const void* prev, const void* binned,
                                     const void* offsets, int n_cells, int cell_log2,
                                     void* stream) {
  if (n_cells <= 0) return 0;
  if (cell_log2 < 2 || cell_log2 > 14) return (int)cudaErrorInvalidValue;
  const int cell_words = 1 << cell_log2;
  cudaStream_t s = (cudaStream_t)stream;
  if (prev == nullptr) {
    size_t smem = (size_t)cell_words * 4;
    cudaError_t e = cudaFuncSetAttribute(sweep_apply_kernel<false>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sweep_apply_kernel<false><<<n_cells, SWEEP_THREADS, smem, s>>>(
        (unsigned*)words, nullptr, (const unsigned*)binned, (const int*)offsets, cell_words);
  } else {
    size_t smem = (size_t)cell_words * 8;
    cudaError_t e = cudaFuncSetAttribute(sweep_apply_kernel<true>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sweep_apply_kernel<true><<<n_cells, SWEEP_THREADS, smem, s>>>(
        (unsigned*)words, (const unsigned*)prev, (const unsigned*)binned, (const int*)offsets,
        cell_words);
  }
  return (int)cudaGetLastError();
}
