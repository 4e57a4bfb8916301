// K1: ntHash k-mer hashing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ntsynt_tpu/ops/nthash_pallas.py
// (_hash_kernel, launched by _hash_call / hash_keys). On the GPU this one
// kernel also does the Bloom-filter build's hashing, which the JAX
// package runs in XLA (ops/nthash.hash_tile).
//
// For every k-mer start i of a code array (A=0 C=1 G=2 T=3, >=4 = N):
//   f     = XOR_j TF[j][c_{i+j}]           forward strand
//   r     = XOR_j TR[j][c_{i+j}]           reverse strand
//   canon = f + r  (mod 2^64)              Bloom-filter key
//   t     = canon * mult  (mod 2^64)
//   key   = t ^ (t >> 27)                  printed / minimizer-order hash
// A k-mer holding any code >= 4 is invalid: its key is the all-ones
// sentinel and valid[i] = 0 (canon is still written, unmasked).
//
// Bound on the H100: memory. Per k-mer it reads ~1 code byte (the k-1
// overlapping reads hit L1) and writes 8 + 8 + 1 bytes, so
// 18 B/k-mer at 3.35 TB/s; the 2k table XORs are far below the
// integer rate.
//
// Design: one thread per k-mer, 64-bit integers throughout (the TPU
// kernel splits every hash into uint32 halves because the TPU has no
// 64-bit lanes). The 2 x k x 5 seed tables are copied into shared
// memory once per block; codes are read straight from device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void nthash_kernel(const uint8_t* __restrict__ codes, int64_t n_kmers, int k,
                              const unsigned long long* __restrict__ tables,
                              unsigned long long mult, long long* __restrict__ key,
                              long long* __restrict__ canon, uint8_t* __restrict__ valid) {
  extern __shared__ unsigned long long tab[];  // TF [k*5] then TR [k*5]
  for (int t = threadIdx.x; t < 10 * k; t += blockDim.x) tab[t] = tables[t];
  __syncthreads();
  const unsigned long long* tf = tab;
  const unsigned long long* tr = tab + 5 * k;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_kmers; i += stride) {
    unsigned long long f = 0, r = 0;
    bool bad = false;
    for (int j = 0; j < k; ++j) {
      unsigned c = codes[i + j];
      if (c >= 4) {
        bad = true;
        c = 4;
      }
      f ^= tf[j * 5 + c];
      r ^= tr[j * 5 + c];
    }
    unsigned long long cn = f + r;
    unsigned long long t = cn * mult;
    unsigned long long out = t ^ (t >> 27);
    key[i] = bad ? -1LL : (long long)out;
    canon[i] = (long long)cn;
    valid[i] = bad ? 0 : 1;
  }
}

}  // namespace

extern "C" int ntsynt_nthash(const void* codes, int64_t n_kmers, int k, const void* tables,
                             unsigned long long mult, void* key, void* canon, void* valid,
                             void* stream) {
  if (n_kmers <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n_kmers + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  size_t smem = (size_t)10 * k * sizeof(unsigned long long);
  nthash_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, n_kmers, k, (const unsigned long long*)tables, mult,
      (long long*)key, (long long*)canon, (uint8_t*)valid);
  return (int)cudaGetLastError();
}
