// K4: Bloom-filter insert for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ntsynt_tpu/ops/bf_place.py
// (_place_kernel, launched by _place_call / place_sorted), which ORs a
// SORTED list of (word, single-bit mask) pairs into the filter words;
// the sort itself (ntsynt_tpu/ops/bloom.insert_words) exists only to
// feed that kernel and is not ported.
//
// For every i with valid[i] != 0, with b = bits_log2 (16..36):
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
// hit about 39% of a 2^32-bit filter's 2^27 words. In practice each
// insert is a random 32-byte sector touched by an atomic, so the kernel
// runs at the L2 atomic rate.
//
// Design: one thread per key, one atomicOr on the 32-bit word. OR is
// commutative and idempotent, so the result is independent of order and
// of duplicates, with no sort and no run merging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bf_insert_kernel(unsigned int* __restrict__ words,
                                 const long long* __restrict__ canon,
                                 const uint8_t* __restrict__ valid, int64_t n, int bits_log2) {
  const unsigned long long bit_mask =
      bits_log2 >= 64 ? ~0ull : ((1ull << bits_log2) - 1ull);
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (!valid[i]) continue;
    unsigned long long h = (unsigned long long)canon[i];
    unsigned long long word = (h & bit_mask) >> 5;
    atomicOr(words + word, 1u << (unsigned)(h & 31ull));
  }
}

}  // namespace

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
