// Winner statistics of an (H, W, D) float32 aggregated volume: for each
// pixel, best = min_d s[d], idx = the smallest d with s[d] == best,
// cm = s[idx-1], cp = s[idx+1] and comp = min over |d - idx| > 1 of s[d],
// each min'd with BIG (1e9), so a neighbour outside [0, D) and a missing
// competitor come back as BIG. best, cm, cp and comp are float32, idx int32.
//
// Replaces: stereovision_tpu/ops/sgm_pallas.py:wta (_wta_kernel, the
// _wta_stats of sgm_pallas.py:500-511), which stereo.sgm._wta calls on a
// volume under a kernel impl. The reference pads D to 128 lanes with 1e9;
// with exactly D planes the neighbours and the competitor past D are the
// same BIG.
//
// Bound on this card: bytes, read 4*H*W*D + write 20*H*W (1.20 GB at
// 1280x720, D=320: ~0.36 ms at 3.35 TB/s). Design: one warp per pixel,
// the layout of wta_stats.cu: lane l holds planes l, l + 32, ... (a warp's
// load of one plane row is 128 consecutive bytes; V >= ceil(D/32) planes a
// lane, exact up to 16 and a multiple of 4 above, up to 32: D <= 1024);
// best, idx, cm, cp and comp are five-round __shfl_xor butterflies.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define WARPS_PER_BLOCK 8

static constexpr float kBig = 1e9f;

__device__ __forceinline__ float warp_minf(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ int warp_mini(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

template <int V>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
wta_kernel(const float* __restrict__ agg, float* __restrict__ best_o, int32_t* __restrict__ idx_o,
           float* __restrict__ cm_o, float* __restrict__ cp_o, float* __restrict__ comp_o,
           long long npix, int D) {
  const long long pix = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pix >= npix) return;  // warp-uniform
  const long long base = pix * D;
  float s[V];
  float m = INFINITY;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int d = v * 32 + lane;
    s[v] = d < D ? agg[base + d] : INFINITY;
    m = fminf(m, s[v]);
  }
  const float best = warp_minf(m);
  int first = INT_MAX;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int d = v * 32 + lane;
    if (d < D && s[v] == best) first = min(first, d);
  }
  const int idx = warp_mini(first);
  float cm = kBig, cp = kBig, comp = kBig;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int d = v * 32 + lane;
    if (d < D) {
      if (d == idx - 1) cm = fminf(cm, s[v]);
      if (d == idx + 1) cp = fminf(cp, s[v]);
      if (abs(d - idx) > 1) comp = fminf(comp, s[v]);
    }
  }
  cm = warp_minf(cm);
  cp = warp_minf(cp);
  comp = warp_minf(comp);
  if (lane == 0) {
    best_o[pix] = best;
    idx_o[pix] = idx;
    cm_o[pix] = cm;
    cp_o[pix] = cp;
    comp_o[pix] = comp;
  }
}

extern "C" int svt_wta(const void* agg, void* best, void* idx, void* cm, void* cp, void* comp,
                       long long npix, int D, void* stream) {
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid((unsigned)((npix + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK));
  // planes a lane holds: ceil(D/32), a multiple of 4 past 16 (the extra
  // ones are past D and skipped)
  int V = (D + 31) / 32;
  if (V > 16) V = (V + 3) / 4 * 4;
#define SVT_WTA_CASE(VV)                                                                    \
  case VV:                                                                                  \
    wta_kernel<VV><<<grid, block, 0, (cudaStream_t)stream>>>(                               \
        (const float*)agg, (float*)best, (int32_t*)idx, (float*)cm, (float*)cp, (float*)comp, \
        npix, D);                                                                           \
    break;
  switch (V) {
    SVT_WTA_CASE(1) SVT_WTA_CASE(2) SVT_WTA_CASE(3) SVT_WTA_CASE(4)
    SVT_WTA_CASE(5) SVT_WTA_CASE(6) SVT_WTA_CASE(7) SVT_WTA_CASE(8)
    SVT_WTA_CASE(9) SVT_WTA_CASE(10) SVT_WTA_CASE(11) SVT_WTA_CASE(12)
    SVT_WTA_CASE(13) SVT_WTA_CASE(14) SVT_WTA_CASE(15) SVT_WTA_CASE(16)
    SVT_WTA_CASE(20) SVT_WTA_CASE(24) SVT_WTA_CASE(28) SVT_WTA_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;  // D > 1024
  }
#undef SVT_WTA_CASE
  return (int)cudaGetLastError();
}
