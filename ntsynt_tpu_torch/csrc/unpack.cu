// Unpack of the packed code stream for Hopper (sm_90a).
//
// Replaces the XLA op (not a Pallas kernel) with which the JAX package
// unpacks its upload format on the device: ntsynt_tpu/ops/sketch.py
// (_unpack_stream_fn) and ntsynt_tpu/parallel/mesh.py (_unpack_row).
// The host sends a stream of n codes (n % 8 == 0) as planar 2-bit codes
// and a planar N bitmap (ops/sketch.PackedUpload, io/fasta.pack_stream):
//   packed2 [n/4]: plane j of its 2-bit fields holds positions
//     [j*n/4, (j+1)*n/4), i.e. byte b holds b, b + n/4, b + n/2, b + 3n/4;
//   nbits [n/8]: bit j of byte c is set where position c + j*n/8 is N.
// Output: out[i] = 4 if i's N bit is set, else i's 2-bit code.
//
// Bound on the H100: memory. 3/8 byte read and 1 byte written per code,
// at 3.35 TB/s; no arithmetic to speak of.
//
// Design: with m = n/8, byte c of the bitmap and bytes c and m + c of
// packed2 together give the eight codes c + j*m, j = 0..7 (packed2 byte c
// holds planes 0, 2, 4, 6 of the bitmap's layout, byte m + c planes 1, 3,
// 5, 7). When m % 16 == 0 and the pointers are 16-byte aligned (every
// full group of the upload), a thread takes 16 consecutive c: three
// 16-byte loads and eight 16-byte stores, one per plane, each code
// computed in four-byte lanes (SWAR). Otherwise (a stream's last group,
// a mesh slab) a thread takes one c: three byte loads and eight byte
// stores, still coalesced across the warp. Grid-stride loops; 64-bit
// indices, so a stream past 2^31 codes unpacks in place at any offset.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 20;

// four codes from four packed bytes v (fields at bit sh of each byte)
// and their four bitmap bytes nb (flag at bit j of each byte)
__device__ __forceinline__ uint32_t codes4(uint32_t v, uint32_t nb, int sh, int j) {
  uint32_t c = (v >> sh) & 0x03030303u;
  uint32_t isn = (nb >> j) & 0x01010101u;
  return (c & ~(isn * 0xFFu)) | (isn << 2);
}

__global__ void __launch_bounds__(THREADS)
    unpack16_kernel(const uint4* __restrict__ packed2, const uint4* __restrict__ nbits,
                    int64_t m16, uint8_t* __restrict__ out) {
  const int64_t m = 16 * m16;
  for (int64_t t = blockIdx.x * (int64_t)THREADS + threadIdx.x; t < m16;
       t += (int64_t)gridDim.x * THREADS) {
    const uint4 nb = __ldg(nbits + t);
    const uint4 lo = __ldg(packed2 + t);       // planes 0, 2, 4, 6
    const uint4 hi = __ldg(packed2 + m16 + t);  // planes 1, 3, 5, 7
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 v = (j & 1) ? hi : lo;
      const int sh = 2 * (j >> 1);
      uint4 o;
      o.x = codes4(v.x, nb.x, sh, j);
      o.y = codes4(v.y, nb.y, sh, j);
      o.z = codes4(v.z, nb.z, sh, j);
      o.w = codes4(v.w, nb.w, sh, j);
      *reinterpret_cast<uint4*>(out + j * m + 16 * t) = o;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    unpack1_kernel(const uint8_t* __restrict__ packed2, const uint8_t* __restrict__ nbits,
                   int64_t m, uint8_t* __restrict__ out) {
  for (int64_t c = blockIdx.x * (int64_t)THREADS + threadIdx.x; c < m;
       c += (int64_t)gridDim.x * THREADS) {
    const unsigned nb = nbits[c], lo = packed2[c], hi = packed2[m + c];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned v = (j & 1) ? hi : lo;
      out[j * m + c] = ((nb >> j) & 1u) ? 4 : (uint8_t)((v >> (2 * (j >> 1))) & 3u);
    }
  }
}

int64_t blocks_for(int64_t work) {
  int64_t b = (work + THREADS - 1) / THREADS;
  return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

}  // namespace

// out [n] <- the codes packed in packed2 [n/4] and nbits [n/8]; n > 0,
// n % 8 == 0. out may be a view into a larger buffer (any offset).
extern "C" int ntsynt_unpack(const void* packed2, const void* nbits, int64_t n, void* out,
                             void* stream) {
  if (n <= 0 || n % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t m = n / 8;
  const uintptr_t ptrs = (uintptr_t)packed2 | (uintptr_t)nbits | (uintptr_t)out;
  if (m % 16 == 0 && (ptrs & 15) == 0) {
    const int64_t m16 = m / 16;
    unpack16_kernel<<<(unsigned)blocks_for(m16), THREADS, 0, s>>>(
        (const uint4*)packed2, (const uint4*)nbits, m16, (uint8_t*)out);
  } else {
    unpack1_kernel<<<(unsigned)blocks_for(m), THREADS, 0, s>>>(
        (const uint8_t*)packed2, (const uint8_t*)nbits, m, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
