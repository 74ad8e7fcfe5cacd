// Sum of the four int8 path-cost volumes of a full search and the winner
// statistics of the sum, in one read of each volume: for each pixel of
// (H, W, D) hf, hb, vf, vb, with s[d] = hf[d] + hb[d] + vf[d] + vb[d] and
// s[d] = 2^21 for d >= d_valid,
//   key[d] = min(s[d], 2^30/dp - 1) * dp + d     (dp: next power of two >= D)
//   best = key_min / dp, idx = key_min mod dp    (ties to the smallest d)
//   cm = s[idx-1], cp = s[idx+1], comp = min over |d - idx| > 1 of s[d],
// each 2^29 where no such plane exists; best, cm, cp and comp as float32,
// idx as int32. emit 1 ("hwd") also writes min(s, 30000) as int16
// (H, W, D), the summed volume the LR check reads; emit 2 ("dhw") writes it
// as (D, H, W); emit 0 ("none") writes no volume.
//
// Replaces: scripts/bench_sumwta.py:110 (make_pallas, body :53-84), the TPU's
// fused sum + WTA kernel, which reads the horizontal pair as (W, H, D)
// transposes and transposes them in VMEM. The port's volumes are all
// (H, W, D), so no transpose is needed. The key's cap 2^30/dp - 1 is the
// script's; wta_stats.cu caps at 2^23/dp - 1, and the two agree while the
// least sum stays under the smaller cap (it is at most 4 * 127 here).
//
// Bound on this card: bytes, 4*H*W*D read + 2*H*W*D written (hwd, dhw) +
// 20*H*W: 1787.8 MB at 720x1280, D=320 (~0.534 ms at 3.35 TB/s), against the
// plain torch sum_wta's int32 passes over the volume. Design: one warp per
// pixel, the layout of wta_stats.cu: lane l holds planes l, l + 32, ... (V
// of them, D <= 1024), so each plane row of each volume is one coalesced
// 32-byte read, and hwd's stores are coalesced 64-byte rows; the minima are
// five-round __shfl_xor butterflies. dhw's stores are one plane apart per
// lane (32 separate sectors a warp); neighbouring warps fill the sectors in
// L2.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define WARPS_PER_BLOCK 8

static constexpr int kMasked = 1 << 21;
static constexpr int kNone = 1 << 29;
static constexpr int kClamp = 30000;

enum : int { kEmitNone = 0, kEmitHWD = 1, kEmitDHW = 2 };

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

template <int V, int EMIT>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
sum_wta_kernel(const int8_t* __restrict__ hf, const int8_t* __restrict__ hb,
               const int8_t* __restrict__ vf, const int8_t* __restrict__ vb,
               int16_t* __restrict__ s_o, float* __restrict__ best_o, int32_t* __restrict__ idx_o,
               float* __restrict__ cm_o, float* __restrict__ cp_o, float* __restrict__ comp_o,
               long long npix, int D, int d_valid, int log2dp) {
  const long long pix = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pix >= npix) return;  // warp-uniform
  const long long base = pix * D;
  const int cap = (1 << (30 - log2dp)) - 1;
  int s[V];
  int kmin = INT_MAX;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int d = v * 32 + lane;
    if (d < D) {
      const long long i = base + d;
      s[v] = d < d_valid ? (int)hf[i] + (int)hb[i] + (int)vf[i] + (int)vb[i] : kMasked;
      if constexpr (EMIT == kEmitHWD) s_o[i] = (int16_t)min(s[v], kClamp);
      if constexpr (EMIT == kEmitDHW) s_o[(long long)d * npix + pix] = (int16_t)min(s[v], kClamp);
      kmin = min(kmin, min(s[v], cap) * (1 << log2dp) + d);
    }
  }
  kmin = warp_min(kmin);
  const int best = kmin >> log2dp;  // floor division by the power of two dp
  const int idx = kmin - best * (1 << log2dp);
  int cm = kNone, cp = kNone, comp = kNone;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int d = v * 32 + lane;
    if (d < D) {
      if (d == idx - 1) cm = s[v];
      if (d == idx + 1) cp = s[v];
      if (abs(d - idx) > 1) comp = min(comp, s[v]);
    }
  }
  cm = warp_min(cm);
  cp = warp_min(cp);
  comp = warp_min(comp);
  if (lane == 0) {
    best_o[pix] = (float)best;
    idx_o[pix] = idx;
    cm_o[pix] = (float)cm;
    cp_o[pix] = (float)cp;
    comp_o[pix] = (float)comp;
  }
}

template <int EMIT>
static int launch(const int8_t* hf, const int8_t* hb, const int8_t* vf, const int8_t* vb,
                  int16_t* s, float* best, int32_t* idx, float* cm, float* cp, float* comp,
                  long long npix, int D, int d_valid, int log2dp, cudaStream_t stream) {
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid((unsigned)((npix + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK));
  // planes a lane holds: ceil(D/32) rounded up to 1, 2, 4, 8, 12, 16, 24 or
  // 32 (the extra ones are past D and skipped)
  const int need = (D + 31) / 32;
  const int V = need <= 2 ? need : need <= 4 ? 4 : need <= 8 ? 8 : need <= 16 ? (need + 3) / 4 * 4
                                                                               : (need + 7) / 8 * 8;
#define SVT_SUM_CASE(VV)                                                                     \
  case VV:                                                                                   \
    sum_wta_kernel<VV, EMIT><<<grid, block, 0, stream>>>(hf, hb, vf, vb, s, best, idx, cm, cp, \
                                                         comp, npix, D, d_valid, log2dp);    \
    break;
  switch (V) {
    SVT_SUM_CASE(1) SVT_SUM_CASE(2) SVT_SUM_CASE(4) SVT_SUM_CASE(8)
    SVT_SUM_CASE(12) SVT_SUM_CASE(16) SVT_SUM_CASE(24) SVT_SUM_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;  // D > 1024
  }
#undef SVT_SUM_CASE
  return 0;
}

// emit: 0 none (s null), 1 (H, W, D) int16, 2 (D, H, W) int16
extern "C" int svt_sum_wta(const void* hf, const void* hb, const void* vf, const void* vb, void* s,
                           void* best, void* idx, void* cm, void* cp, void* comp, long long npix,
                           int D, int d_valid, int emit, void* stream) {
  int log2dp = 0;
  while ((1 << log2dp) < D) ++log2dp;
  const int8_t *a = (const int8_t*)hf, *b = (const int8_t*)hb;
  const int8_t *c = (const int8_t*)vf, *d = (const int8_t*)vb;
  int16_t* so = (int16_t*)s;
  float *bo = (float*)best, *mo = (float*)cm, *po = (float*)cp, *co = (float*)comp;
  int32_t* io = (int32_t*)idx;
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  switch (emit) {
    case kEmitNone:
      err = launch<kEmitNone>(a, b, c, d, so, bo, io, mo, po, co, npix, D, d_valid, log2dp, st);
      break;
    case kEmitHWD:
      err = launch<kEmitHWD>(a, b, c, d, so, bo, io, mo, po, co, npix, D, d_valid, log2dp, st);
      break;
    case kEmitDHW:
      err = launch<kEmitDHW>(a, b, c, d, so, bo, io, mo, po, co, npix, D, d_valid, log2dp, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return err != 0 ? err : (int)cudaGetLastError();
}
