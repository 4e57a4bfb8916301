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
// Design. A cell is 2^cell_log2 words (2^14: 64 KiB, so new's and prev's
// cells fit one block). The keys are binned by cell with K4's binning
// (csrc/bf_insert.cu): a shared-memory histogram count, a one-block scan
// (offsets, cursors, the second pass's plan and this apply's slices),
// then one or two partition passes that sort tiles by digit in shared
// memory and write each digit's run coalesced, with one global atomic
// per digit and tile and none per key; the second pass gives each
// first-pass range blocks by its size, so keys crowded into one range
// still spread over the card. Then the apply: one block per cell loads
// the cell's words (and prev's) into shared memory with 16-byte loads,
// ORs its keys in with shared-memory atomicOr, and stores the cell back.
// Cells that no key hits are neither read nor written.
//
// Hot cells. A cell with more keys than `chunk` (the wrapper's fair share
// of the segment per block the card holds at once) is split into slices
// of at most `chunk` keys, one block each: a slice ORs its keys into
// zeroed shared memory and merges each non-zero word into the filter with
// one global atomicOr (a coalesced reduction). A cell of one slice loads,
// ORs and stores its words alone. The slices of every cell are numbered
// by `first` (an exclusive prefix of ceil(count / chunk), from the
// binning's scan on the stream), so no host sync sizes the grid: it
// has n_cells + n / chunk blocks at most, and surplus blocks return at
// once. There is no per-cell capacity, so nothing falls back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int APPLY_BATCH = 8;       // loads in flight per thread
constexpr int MAX_CELL_LOG2 = 14;    // new's and prev's 64 KiB in one block
constexpr unsigned NONE = 0xFFFFFFFFu;

// dst[i] = the i-th 16 bytes at g (zeros for g == nullptr), APPLY_BATCH
// 16-byte loads in flight per thread
__device__ __forceinline__ void load_cell(uint4* dst, const uint4* g, int n4) {
  for (int i0 = threadIdx.x; i0 < n4; i0 += blockDim.x * APPLY_BATCH) {
    uint4 v[APPLY_BATCH];
#pragma unroll
    for (int u = 0; u < APPLY_BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      v[u] = make_uint4(0, 0, 0, 0);
      if (g != nullptr && i < n4) v[u] = g[i];
    }
#pragma unroll
    for (int u = 0; u < APPLY_BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n4) dst[i] = v[u];
    }
  }
}

template <bool CASCADE>
__global__ void sweep_apply_kernel(unsigned* __restrict__ words, const unsigned* __restrict__ prev,
                                   const unsigned* __restrict__ binned,
                                   const int* __restrict__ offsets, const int* __restrict__ first,
                                   int n_cells, int chunk, int cell_log2) {
  extern __shared__ uint4 smem4[];
  const int item = blockIdx.x;  // one slice of one cell
  // the cell c with first[c] <= item < first[c + 1]: c = item while no
  // cell before it is split or empty (a uniform segment), else a search
  int c = min(item, n_cells - 1);
  const int slices = first[n_cells], f0 = first[c], f1 = first[c + 1];
  if (item >= slices) return;
  if (f0 > item || item >= f1) {
    c = 0;
    for (int hi = n_cells - 1; c < hi;) {
      const int mid = (c + hi + 1) >> 1;
      if (first[mid] <= item) c = mid;
      else hi = mid - 1;
    }
  }
  const bool split = first[c + 1] - first[c] > 1;
  const int start = offsets[c] + (item - first[c]) * chunk;
  const int end = min(offsets[c + 1], start + chunk);

  const int cell_words = 1 << cell_log2;
  const int n4 = cell_words / 4;
  unsigned* s_new = reinterpret_cast<unsigned*>(smem4);
  const unsigned* s_prev = s_new + cell_words;
  unsigned* g_new = words + ((int64_t)c << cell_log2);
  // the cell's words (zeros for a slice of a split cell), and prev's
  load_cell(smem4, split ? nullptr : reinterpret_cast<const uint4*>(g_new), n4);
  if (CASCADE)
    load_cell(smem4 + n4, reinterpret_cast<const uint4*>(prev + ((int64_t)c << cell_log2)), n4);
  __syncthreads();
  for (int j0 = start + threadIdx.x; j0 < end; j0 += blockDim.x * APPLY_BATCH) {
    unsigned b[APPLY_BATCH];
#pragma unroll
    for (int u = 0; u < APPLY_BATCH; ++u) {
      const int j = j0 + u * blockDim.x;
      b[u] = j < end ? __ldcs(binned + j) : NONE;
    }
#pragma unroll
    for (int u = 0; u < APPLY_BATCH; ++u) {
      if (b[u] == NONE) continue;
      const unsigned w = b[u] >> 5, m = 1u << (b[u] & 31u);
      if (!CASCADE || (s_prev[w] & m)) atomicOr(s_new + w, m);
    }
  }
  __syncthreads();
  // store: the whole cell for a cell of one slice, else each non-zero
  // word merged into the filter with a global atomic
  if (!split) {
    uint4* g4 = reinterpret_cast<uint4*>(g_new);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) g4[i] = smem4[i];
  } else {
    for (int k = threadIdx.x; k < cell_words; k += blockDim.x)
      if (s_new[k]) atomicOr(g_new + k, s_new[k]);
  }
}

size_t apply_smem(bool cascade, int cell_log2) { return (size_t)(cascade ? 8 : 4) << cell_log2; }

// 1024 threads for 128 KiB of shared memory (one block an SM), 512 below
int apply_threads(bool cascade, int cell_log2) {
  return apply_smem(cascade, cell_log2) >= (128u << 10) ? 1024 : 512;
}

template <bool CASCADE>
cudaError_t set_apply_smem(int cell_log2) {
  return cudaFuncSetAttribute(sweep_apply_kernel<CASCADE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)apply_smem(CASCADE, cell_log2));
}

}  // namespace

// The apply's blocks one SM holds at once in insert (cascade == 0) or
// cascade mode, given its shared memory and threads (at least 1). The
// wrapper sizes the hot-cell slices by it.
extern "C" int ntsynt_bf_sweep_blocks_per_sm(int cascade, int cell_log2, int* blocks) {
  if (cell_log2 < 2 || cell_log2 > MAX_CELL_LOG2) return (int)cudaErrorInvalidValue;
  cudaError_t e = cascade ? set_apply_smem<true>(cell_log2) : set_apply_smem<false>(cell_log2);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, cascade ? sweep_apply_kernel<true> : sweep_apply_kernel<false>,
      apply_threads(cascade, cell_log2), apply_smem(cascade, cell_log2));
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm > 0 ? per_sm : 1;
  return 0;
}

// The apply. Cell c (2^cell_log2 words) holds the bits within the cell
// binned[offsets[c] .. offsets[c + 1]) of the n binned keys; its slices
// are first[c] .. first[c + 1] (first: [n_cells + 1] int, from the
// binning's scan), each of at most chunk keys, so there are at most
// n_cells + n / chunk. prev == NULL selects insert mode, else cascade
// mode. words (and prev) must be 16-byte aligned.
extern "C" int ntsynt_bf_sweep_apply(void* words, const void* prev, const void* binned,
                                     const void* offsets, const void* first, int64_t n,
                                     int n_cells, int chunk, int cell_log2, void* stream) {
  if (n <= 0 || n_cells <= 0) return 0;
  if (cell_log2 < 2 || cell_log2 > MAX_CELL_LOG2 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t max_slices = n_cells + n / chunk;
  if (max_slices >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const bool cascade = prev != nullptr;
  cudaError_t e = cascade ? set_apply_smem<true>(cell_log2) : set_apply_smem<false>(cell_log2);
  if (e != cudaSuccess) return (int)e;
  const int threads = apply_threads(cascade, cell_log2);
  const size_t smem = apply_smem(cascade, cell_log2);
  cudaStream_t s = (cudaStream_t)stream;
  if (cascade)
    sweep_apply_kernel<true><<<(unsigned)max_slices, threads, smem, s>>>(
        (unsigned*)words, (const unsigned*)prev, (const unsigned*)binned, (const int*)offsets,
        (const int*)first, n_cells, chunk, cell_log2);
  else
    sweep_apply_kernel<false><<<(unsigned)max_slices, threads, smem, s>>>(
        (unsigned*)words, nullptr, (const unsigned*)binned, (const int*)offsets,
        (const int*)first, n_cells, chunk, cell_log2);
  return (int)cudaGetLastError();
}
