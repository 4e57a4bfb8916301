// K2: sliding-window leftmost argmin + min hash for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ntsynt_tpu/ops/winmin_pallas.py
// (_scan_kernel, launched by _scan_call / block_scans_pallas) together
// with the window combine that ntsynt_tpu/ops/winmin.sliding_block_argmin
// runs after it in XLA.
//
// keys[n] are 64-bit hashes stored in int64 (uint64 bit pattern); the
// order is unsigned on (key, position), so ties resolve to the smaller
// position (leftmost argmin). For each window j in [0, n - w + 1):
//   arg[j]  = leftmost argmin of keys[j .. j + w - 1]
//   minv[j] = keys[arg[j]]
//
// Two-pass block method: cut positions into w-blocks. Window
// j = b*w + c is the suffix of block b from lane c joined with the
// prefix of block b+1 up to lane c-1, so
//   win[j] = min(suffix_b[c], prefix_{b+1}[c-1]).
//
// Bound on the H100: memory. 8 bytes read per key, 16 bytes written per
// window, at 3.35 TB/s. The 64-bit compares are far below the integer
// rate.
//
// Design: each w-block b is owned by a group of TW threads (TW a power
// of two near w/4, so each thread owns a run of about four consecutive
// lanes); a 256-thread CUDA block holds 256/TW groups, so small w still
// fills whole warps. Pass 1 takes each run's minimum over block b and
// over block b+1; shared-memory scans within the group turn these into
// "min over the runs after mine" (block b) and "min over the runs before
// mine" (block b+1). Pass 2 walks the thread's lanes right to left for
// the suffix minimum, parking it in the outputs, and pass 3 walks them
// left to right for the prefix minimum and writes the combined result.
// The TPU kernel's lane-roll log-step scans, (8, 128) tiling and uint32
// hash halves have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned long long UMAX = 0xFFFFFFFFFFFFFFFFull;
constexpr long long PMAX = 0x7FFFFFFFFFFFFFFFll;

struct KP {
  unsigned long long key;
  long long pos;
};

__device__ __forceinline__ KP kmin(KP a, KP b) {
  bool a_less = a.key < b.key || (a.key == b.key && a.pos < b.pos);
  return a_less ? a : b;
}

__device__ __forceinline__ KP load(const long long* keys, int64_t n, int64_t p) {
  KP r;
  if (p < n) {
    r.key = (unsigned long long)keys[p];
    r.pos = p;
  } else {
    r.key = UMAX;
    r.pos = PMAX;
  }
  return r;
}

__global__ void winmin_kernel(const long long* __restrict__ keys, int64_t n, int64_t w,
                              int tw, long long* __restrict__ arg, long long* __restrict__ minv) {
  __shared__ KP suf[THREADS];  // inclusive suffix scan of block-b run minima
  __shared__ KP pre[THREADS];  // inclusive prefix scan of block-(b+1) run minima
  const int64_t nw = n - w + 1;
  const int64_t nb = (nw + w - 1) / w;
  const int i = threadIdx.x;
  const int t = i % tw;  // my run within the group
  const int64_t b = (int64_t)blockIdx.x * (THREADS / tw) + i / tw;
  const bool active = b < nb;
  const int64_t base = b * w;
  const int64_t cs = (w + tw - 1) / tw;
  int64_t c0 = t * cs;
  int64_t c1 = c0 + cs;
  if (c0 > w) c0 = w;
  if (c1 > w) c1 = w;
  const KP inf = {UMAX, PMAX};

  KP sa = inf, pa = inf;
  if (active) {
    for (int64_t c = c0; c < c1; ++c) {
      sa = kmin(sa, load(keys, n, base + c));
      pa = kmin(pa, load(keys, n, base + w + c));
    }
  }
  suf[i] = sa;
  pre[i] = pa;
  __syncthreads();
  for (int s = 1; s < tw; s <<= 1) {
    KP sv = (t + s < tw) ? kmin(suf[i], suf[i + s]) : suf[i];
    KP pv = (t >= s) ? kmin(pre[i], pre[i - s]) : pre[i];
    __syncthreads();
    suf[i] = sv;
    pre[i] = pv;
    __syncthreads();
  }
  if (!active) return;
  KP after = (t + 1 < tw) ? suf[i + 1] : inf;  // runs right of mine, block b
  KP before = (t > 0) ? pre[i - 1] : inf;      // runs left of mine, block b+1

  // suffix minimum of block b at each of my lanes, parked in the outputs
  KP run = after;
  for (int64_t c = c1 - 1; c >= c0; --c) {
    run = kmin(run, load(keys, n, base + c));
    int64_t j = base + c;
    if (j < nw) {
      minv[j] = (long long)run.key;
      arg[j] = run.pos;
    }
  }
  // prefix minimum of block b+1 up to lane c-1, combined with the suffix
  run = before;
  for (int64_t c = c0; c < c1; ++c) {
    int64_t j = base + c;
    if (j < nw) {
      KP s = {(unsigned long long)minv[j], arg[j]};
      KP m = kmin(s, run);
      minv[j] = (long long)m.key;
      arg[j] = m.pos;
    }
    run = kmin(run, load(keys, n, base + w + c));
  }
}

}  // namespace

extern "C" int ntsynt_winmin(const void* keys, int64_t n, int64_t w, void* arg, void* minv,
                             void* stream) {
  if (w < 1 || n < w) return (int)cudaErrorInvalidValue;
  int64_t nw = n - w + 1;
  int64_t nb = (nw + w - 1) / w;
  int tw = 1;  // threads per w-block: a power of two >= w/4, at most THREADS
  while (tw < THREADS && (int64_t)tw * 4 < w) tw <<= 1;
  int64_t groups = THREADS / tw;
  int64_t blocks = (nb + groups - 1) / groups;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  winmin_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, n, w, tw, (long long*)arg, (long long*)minv);
  return (int)cudaGetLastError();
}
