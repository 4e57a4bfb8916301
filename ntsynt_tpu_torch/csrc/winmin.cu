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
// rate, and shared memory moves about 30 bytes per window, a tenth of its
// rate.
//
// Design: keys go through shared memory once, and each output is written
// once, coalesced.
//   Staged (G >= 1, w <= 4095): a 256-thread block owns G consecutive
//   w-blocks. It copies their keys and the next w-block's ((G+1)*w keys,
//   at most the tile the wrapper sizes: 8192 keys, 64 KiB) into shared
//   memory with 16-byte loads, eight in flight per thread. A group of tw threads of one warp (tw a power of two <= 32)
//   scans one w-block; each thread owns cs consecutive lanes (cs odd, so
//   a warp's 8-byte shared loads at stride cs hit distinct banks). Its
//   run minima over block b and over block b+1 are scanned across the
//   group with warp shuffles; a right-to-left walk gives the suffix
//   minima and a left-to-right walk the prefix minima, and the combined
//   result is kept as a 16-bit index into the staged keys. Positions are
//   implicit (tile base + index), so no 64-bit position is stored. Then
//   the block writes arg and minv for its G*w windows, coalesced.
//   Global reads are (1 + 1/G) x 8 bytes per window: G = 7 at w = 1000.
//   Streamed (G == 0, larger w): one warp owns one w-block and walks it in
//   pieces of T = 32*cs lanes, staging block b's and block b+1's lanes of
//   the piece. A first right-to-left pass over block b keeps, for each
//   piece, the minimum of block b's lanes right of the piece, parked in
//   the piece's first output slot (which the second pass reads before it
//   writes it); the second pass carries block b+1's prefix minimum from
//   piece to piece. Results outside the staged lanes are coded 0xFFFF
//   (that suffix minimum) and 0xFFFE (that prefix minimum).
// The TPU kernel's lane-roll log-step scans, (8, 128) tiling and uint32
// hash halves have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TILE_KEYS = 16384;  // 160 KiB of keys and 16-bit results
constexpr int STAGE_BATCH = 8;        // 16-byte loads in flight per thread
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned long long UMAX = 0xFFFFFFFFFFFFFFFFull;
constexpr long long PMAX = 0x7FFFFFFFFFFFFFFFll;
constexpr unsigned short CODE_SUF = 0xFFFF;
constexpr unsigned short CODE_PRE = 0xFFFE;

struct KP {
  unsigned long long key;
  long long pos;
};

__device__ __forceinline__ KP kmin(KP a, KP b) {
  bool a_less = a.key < b.key || (a.key == b.key && a.pos < b.pos);
  return a_less ? a : b;
}

__device__ __forceinline__ KP inf_kp() { return KP{UMAX, PMAX}; }

// lane c of staged keys k whose lane 0 sits at position base
__device__ __forceinline__ KP at(const unsigned long long* k, long long base, int c,
                                 int64_t n) {
  long long p = base + c;
  return p < n ? KP{k[c], p} : inf_kp();
}

__device__ __forceinline__ KP shfl_down(KP v, int s, int width) {
  return KP{__shfl_down_sync(FULL, v.key, s, width), __shfl_down_sync(FULL, v.pos, s, width)};
}

__device__ __forceinline__ KP shfl_up(KP v, int s, int width) {
  return KP{__shfl_up_sync(FULL, v.key, s, width), __shfl_up_sync(FULL, v.pos, s, width)};
}

__device__ __forceinline__ KP warp_min(KP v) {
  for (int s = 16; s > 0; s >>= 1)
    v = kmin(v, KP{__shfl_xor_sync(FULL, v.key, s), __shfl_xor_sync(FULL, v.pos, s)});
  return v;
}

// Maps a result to its 16-bit code in res and back.
struct Codec {
  const unsigned long long* keys;  // staged keys
  long long base;                  // position of keys[0] (staged mode)
  bool streamed;
  int t_lanes;                     // streamed: block b+1's lanes start at keys[t_lanes]
  long long posb, posb1;           // streamed: positions of the two staged lane runs
  KP suf, pre;                     // streamed: the minima outside the piece

  __device__ __forceinline__ unsigned short enc(KP r) const {
    if (!streamed) return (unsigned short)(r.pos - base);
    if (r.pos == suf.pos) return CODE_SUF;
    if (r.pos == pre.pos) return CODE_PRE;
    if (r.pos < posb1) return (unsigned short)(r.pos - posb);
    return (unsigned short)(t_lanes + (r.pos - posb1));
  }
  __device__ __forceinline__ KP dec(unsigned short i) const {
    if (!streamed) return KP{keys[i], base + i};
    if (i == CODE_SUF) return suf;
    if (i == CODE_PRE) return pre;
    if (i < t_lanes) return KP{keys[i], posb + i};
    return KP{keys[i], posb1 + (i - t_lanes)};
  }
};

// One piece of one w-block: windows c in [0, L) of block b, whose lanes
// [0, lanes) of block b start at kb (position posb) and of block b+1 at
// kb1 (position posb1); suf is the minimum of block b right of the piece
// and pre that of block b+1 left of it. Thread t of a group of tw owns
// lanes [t*cs, t*cs + cs). Every thread of the warp calls it (the
// shuffles need the whole warp); lanes == 0 for an idle group.
__device__ void piece(const unsigned long long* kb, const unsigned long long* kb1, int L,
                      int lanes, long long posb, long long posb1, int64_t n, KP suf, KP pre,
                      int tw, int t, int cs, unsigned short* res, const Codec& codec) {
  const int c_lo = t * cs;
  const int c_hi = min(c_lo + cs, lanes);
  KP sa = inf_kp(), pa = inf_kp();
  for (int c = c_lo; c < c_hi; ++c) {
    sa = kmin(sa, at(kb, posb, c, n));
    pa = kmin(pa, at(kb1, posb1, c, n));
  }
  KP s_inc = sa, p_inc = pa;  // inclusive scans of run minima across the group
  for (int s = 1; s < tw; s <<= 1) {
    KP o = shfl_down(s_inc, s, tw);
    KP q = shfl_up(p_inc, s, tw);
    if (t + s < tw) s_inc = kmin(s_inc, o);
    if (t >= s) p_inc = kmin(p_inc, q);
  }
  KP after = shfl_down(s_inc, 1, tw);  // block b, runs right of mine
  KP before = shfl_up(p_inc, 1, tw);   // block b+1, runs left of mine
  if (t + 1 >= tw) after = inf_kp();
  if (t == 0) before = inf_kp();
  KP run = kmin(after, suf);
  for (int c = c_hi - 1; c >= c_lo; --c) {
    run = kmin(run, at(kb, posb, c, n));
    if (c < L) res[c] = codec.enc(run);
  }
  run = kmin(before, pre);
  for (int c = c_lo; c < c_hi && c < L; ++c) {
    res[c] = codec.enc(kmin(codec.dec(res[c]), run));
    run = kmin(run, at(kb1, posb1, c, n));
  }
}

__global__ void winmin_kernel(const long long* __restrict__ keys, int64_t n, int64_t w,
                              int tile, int g, int tw, int cs, long long* __restrict__ arg,
                              long long* __restrict__ minv) {
  extern __shared__ uint4 smem4[];
  unsigned long long* ks = reinterpret_cast<unsigned long long*>(smem4);
  unsigned short* res = reinterpret_cast<unsigned short*>(ks + tile);
  const int64_t nw = n - w + 1;
  const int64_t nb = (nw + w - 1) / w;
  const int tid = threadIdx.x;
  const unsigned long long* ukeys = reinterpret_cast<const unsigned long long*>(keys);

  if (g > 0) {  // staged: this block's g w-blocks and the next one
    const int64_t j0 = (int64_t)blockIdx.x * g * w;
    const int64_t tb = j0 & ~1ll;  // even, for 16-byte loads
    const int m2 = (int)((j0 - tb + (g + 1) * w + 1) & ~1ll);
    for (int p0 = 2 * tid; p0 < m2; p0 += 2 * THREADS * STAGE_BATCH) {
      ulonglong2 v[STAGE_BATCH];
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {  // all loads first, then the stores
        const int64_t pos = tb + p0 + 2 * THREADS * u;
        if (pos + 1 < n) {
          v[u] = *reinterpret_cast<const ulonglong2*>(ukeys + pos);
        } else {
          v[u].x = pos < n ? ukeys[pos] : UMAX;
          v[u].y = UMAX;
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {
        const int p = p0 + 2 * THREADS * u;
        if (p < m2) {
          ks[p] = v[u].x;
          ks[p + 1] = v[u].y;
        }
      }
    }
    __syncthreads();
    const Codec codec{ks, tb, false, 0, 0, 0, inf_kp(), inf_kp()};
    const int groups = THREADS / tw;
    for (int g0 = 0; g0 < g; g0 += groups) {  // uniform over the block
      const int gi = g0 + tid / tw;
      const int64_t posb = j0 + (int64_t)gi * w;
      const bool active = gi < g && posb < nw;
      const int L = active ? (int)min(w, nw - posb) : 0;
      const unsigned long long* kb = ks + (posb - tb);
      piece(kb, kb + w, L, active ? (int)w : 0, posb, posb + w, n, inf_kp(), inf_kp(), tw,
            tid % tw, cs, res + (int64_t)gi * w, codec);
    }
    __syncthreads();
    const int64_t n_out = min((int64_t)g * w, nw - j0);
    for (int j = tid; j < n_out; j += THREADS) {
      unsigned short i = res[j];
      arg[j0 + j] = tb + i;
      minv[j0 + j] = (long long)ks[i];
    }
    return;
  }

  // streamed: one warp per w-block, pieces of t_lanes lanes
  const int warp = tid / 32, lane = tid % 32;
  const int64_t b = (int64_t)blockIdx.x * WARPS + warp;
  if (b >= nb) return;  // uniform over the warp; no block barrier below
  const int t_lanes = 32 * cs;
  unsigned long long* kbuf = ks + (int64_t)warp * 2 * t_lanes;
  unsigned short* rbuf = reinterpret_cast<unsigned short*>(ks + WARPS * 2 * t_lanes) +
                         (int64_t)warp * t_lanes;
  const int64_t bw = b * w;
  const int64_t n_win = min(w, nw - bw);  // windows of block b
  // pass 1: right to left, the minimum of block b right of each piece
  KP run = inf_kp();
  for (int64_t c0 = (w - 1) / t_lanes * t_lanes; c0 >= 0; c0 -= t_lanes) {
    if (c0 < n_win && lane == 0) {
      minv[bw + c0] = (long long)run.key;
      arg[bw + c0] = run.pos;
    }
    KP agg = inf_kp();
    for (int64_t c = c0 + lane; c < min(c0 + t_lanes, w); c += 32)
      agg = kmin(agg, KP{ukeys[bw + c], bw + c});  // block b's lanes all lie below n
    run = kmin(run, warp_min(agg));
  }
  // pass 2: left to right, carrying block b+1's prefix minimum
  KP pre = inf_kp();
  for (int64_t c0 = 0; c0 < n_win; c0 += t_lanes) {
    const int lanes = (int)min((int64_t)t_lanes, w - c0);
    const int L = (int)min((int64_t)lanes, n_win - c0);
    const long long posb = bw + c0, posb1 = posb + w;
    KP suf = KP{0, 0};
    if (lane == 0) suf = KP{(unsigned long long)minv[posb], arg[posb]};
    suf = KP{__shfl_sync(FULL, suf.key, 0), __shfl_sync(FULL, suf.pos, 0)};
    for (int c = lane; c < lanes; c += 32) {
      kbuf[c] = ukeys[posb + c];
      kbuf[t_lanes + c] = posb1 + c < n ? ukeys[posb1 + c] : UMAX;
    }
    __syncwarp();
    const Codec codec{kbuf, 0, true, t_lanes, posb, posb1, suf, pre};
    piece(kbuf, kbuf + t_lanes, L, lanes, posb, posb1, n, suf, pre, 32, lane, cs, rbuf, codec);
    __syncwarp();
    for (int c = lane; c < L; c += 32) {
      KP r = codec.dec(rbuf[c]);
      arg[posb + c] = r.pos;
      minv[posb + c] = (long long)r.key;
    }
    KP agg = inf_kp();
    for (int c = lane; c < lanes; c += 32) agg = kmin(agg, at(kbuf + t_lanes, posb1, c, n));
    pre = kmin(pre, warp_min(agg));
    __syncwarp();
  }
}

}  // namespace

// g >= 1: staged, g w-blocks per block in a tile of `tile` keys, groups
// of tw threads with cs lanes each (tw a power of two <= 32, tw * cs >=
// w, (g + 1) * w + 2 <= tile); g == 0: streamed, tw == 32, pieces of
// 32 * cs lanes. Shared memory: 10 bytes per tile key. keys must be
// 16-byte aligned.
extern "C" int ntsynt_winmin(const void* keys, int64_t n, int64_t w, int tile, int g, int tw,
                             int cs, void* arg, void* minv, void* stream) {
  if (w < 1 || n < w || tw < 1 || tw > 32 || (tw & (tw - 1)) || cs < 1 || g < 0 ||
      tile < 2 || tile > MAX_TILE_KEYS || tile % 2)
    return (int)cudaErrorInvalidValue;
  const int64_t nw = n - w + 1;
  const int64_t nb = (nw + w - 1) / w;
  const size_t smem = (size_t)tile * 10;
  int64_t blocks;
  if (g > 0) {
    if ((int64_t)tw * cs < w || (int64_t)(g + 1) * w + 2 > tile)
      return (int)cudaErrorInvalidValue;
    blocks = (nb + g - 1) / g;
  } else {
    if (tw != 32 || (size_t)WARPS * 32 * cs * (2 * 8 + 2) > smem || 64 * cs > 0xFFFE)
      return (int)cudaErrorInvalidValue;
    blocks = (nb + WARPS - 1) / WARPS;
  }
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(winmin_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  winmin_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const long long*)keys, n, w, tile, g, tw, cs, (long long*)arg, (long long*)minv);
  return (int)cudaGetLastError();
}
