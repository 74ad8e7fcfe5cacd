// Winner statistics of the sum of two int8 or int16 dual path-cost volumes
// (the horizontal pair): for each pixel of (H, W, D) hf and hb, with
// s[d] = hf[d] + hb[d] and s[d] = 2^21 for d >= d_valid,
//   key[d] = min(s[d], 2^23/dp - 1) * dp + d     (dp: next power of two >= D)
//   best = key_min / dp, idx = key_min mod dp    (ties to the smallest d)
//   cm = s[idx-1], cp = s[idx+1], comp = min over |d - idx| > 1 of s[d],
// each 2^29 where no such plane exists. best, cm, cp and comp are written as
// float32, idx as int32.
//
// Replaces: stereovision_tpu/ops/sgm_pallas.py:wta_stats_from_duals
// (_wta_lanes_kernel). The TPU kernel reads (W, H, D) transposed volumes in
// 128-lane groups (pack strips), and computes in float32 because int32 lane
// reductions are slow there; its values are exact small integers, so the
// integer arithmetic here is bit-identical. The port has no lane packing:
// each of its volumes holds exactly D planes of one search. int16 volumes
// (per-direction costs above 127, e.g. a 7x7 census) take the same kernel.
//
// Bound on this card: bytes, 2*H*W*D*itemsize read + 20*H*W written (103 MB
// for the int8 960x1280x32 refine stack: ~31 us at 3.35 TB/s). Design: one
// warp per pixel; lane l holds planes l, l + 32, ... (a warp's load of one
// plane row is 32 consecutive elements; V >= ceil(D/32) of them, exact up to
// 16 and a multiple of 4 above, up to 32: D <= 1024), and the four minima
// (key, cm, cp, comp) are five-round __shfl_xor butterflies. With D = 32
// each lane holds one plane.
//
// Built with -DSVT_VARIANTS, the library also holds svt_wta_stats_variant:
// the ablations of scripts/bench_wta_variants.py (TPU kernel at :149, the
// measurement script of _wta_lanes_kernel) as compile-time variants of this
// kernel on int8 volumes: kBase is the shipping kernel, the others drop or
// change one ingredient (see the enum), and WPB (warps per block) is the
// script's block size. The script's packed output layout is a TPU store
// layout with no counterpart here (the port writes five maps).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define WARPS_PER_BLOCK 8

static constexpr int kMasked = 1 << 21;
static constexpr int kNone = 1 << 29;

// Variant forms; kBase is the shipping kernel, the only one the shipping
// entry instantiates.
enum : int {
  kBase = 0,      // packed key, cm/cp/comp
  kF32Sum = 1,    // the same statistics in float32 (sentinel 1e9, no key cap)
  kBestOnly = 2,  // best and idx only
  kNoKey = 3,     // min, then the first d at the min: two butterflies for the key's one
  kSumOnly = 4,   // the min alone, written to best and (as an int) to idx
};

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_minf(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

template <typename T, int V, int VAR = kBase, int WPB = WARPS_PER_BLOCK>
__global__ void __launch_bounds__(32 * WPB)
wta_stats_kernel(const T* __restrict__ hf, const T* __restrict__ hb,
                 float* __restrict__ best_o, int32_t* __restrict__ idx_o,
                 float* __restrict__ cm_o, float* __restrict__ cp_o, float* __restrict__ comp_o,
                 long long npix, int D, int d_valid, int log2dp) {
  const long long pix = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pix >= npix) return;  // warp-uniform
  const long long base = pix * D;
  if constexpr (VAR == kF32Sum) {
    const float dp = (float)(1 << log2dp);
    float s[V];
    float kmin = INFINITY;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int d = v * 32 + lane;
      if (d < D) {
        s[v] = d < d_valid ? (float)hf[base + d] + (float)hb[base + d] : (float)kMasked;
        kmin = fminf(kmin, __fadd_rn(__fmul_rn(s[v], dp), (float)d));
      }
    }
    kmin = warp_minf(kmin);
    const float best = floorf(kmin / dp);
    const int idx = (int)__fsub_rn(kmin, __fmul_rn(best, dp));
    float cm = 1e9f, cp = 1e9f, comp = 1e9f;
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
    return;
  }
  const int cap = (1 << (23 - log2dp)) - 1;
  int s[V];
  int kmin = INT_MAX;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int d = v * 32 + lane;
    if (d < D) {
      s[v] = d < d_valid ? (int)hf[base + d] + (int)hb[base + d] : kMasked;
      if constexpr (VAR == kNoKey || VAR == kSumOnly)
        kmin = min(kmin, s[v]);
      else
        kmin = min(kmin, min(s[v], cap) * (1 << log2dp) + d);
    }
  }
  kmin = warp_min(kmin);
  if constexpr (VAR == kSumOnly) {
    if (lane == 0) {
      best_o[pix] = (float)kmin;
      idx_o[pix] = kmin;
    }
    return;
  }
  int best, idx;
  if constexpr (VAR == kNoKey) {
    best = kmin;
    int first = INT_MAX;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int d = v * 32 + lane;
      if (d < D && s[v] == best) first = min(first, d);
    }
    idx = warp_min(first);
  } else {
    best = kmin >> log2dp;  // floor division by the power of two dp
    idx = kmin - best * (1 << log2dp);
  }
  if constexpr (VAR == kBestOnly) {
    if (lane == 0) {
      best_o[pix] = (float)best;
      idx_o[pix] = idx;
    }
    return;
  }
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

template <typename T>
static int launch(const void* hf, const void* hb, void* best, void* idx, void* cm, void* cp,
                  void* comp, int npix, int D, int d_valid, int log2dp, cudaStream_t stream) {
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid((unsigned)((npix + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK));
  // planes a lane holds: ceil(D/32), a multiple of 4 past 16 (the extra
  // ones are past D and skipped)
  int V = (D + 31) / 32;
  if (V > 16) V = (V + 3) / 4 * 4;
#define SVT_WTA_CASE(VV)                                                                      \
  case VV:                                                                                    \
    wta_stats_kernel<T, VV><<<grid, block, 0, stream>>>(                                      \
        (const T*)hf, (const T*)hb, (float*)best, (int32_t*)idx, (float*)cm, (float*)cp,      \
        (float*)comp, npix, D, d_valid, log2dp);                                              \
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
  return 0;
}

static int log2_ceil(int D) {
  int log2dp = 0;
  while ((1 << log2dp) < D) ++log2dp;
  return log2dp;
}

// itemsize: 1 (int8 volumes) or 2 (int16)
extern "C" int svt_wta_stats_from_duals(const void* hf, const void* hb, void* best, void* idx,
                                        void* cm, void* cp, void* comp, int npix, int D,
                                        int d_valid, int itemsize, void* stream) {
  const int log2dp = log2_ceil(D);
  int err;
  if (itemsize == 1)
    err = launch<int8_t>(hf, hb, best, idx, cm, cp, comp, npix, D, d_valid, log2dp,
                         (cudaStream_t)stream);
  else if (itemsize == 2)
    err = launch<int16_t>(hf, hb, best, idx, cm, cp, comp, npix, D, d_valid, log2dp,
                          (cudaStream_t)stream);
  else
    return (int)cudaErrorInvalidValue;
  return err != 0 ? err : (int)cudaGetLastError();
}

#ifdef SVT_VARIANTS

template <int V>
static int launch_variant(const int8_t* hf, const int8_t* hb, float* best, int32_t* idx,
                          float* cm, float* cp, float* comp, int npix, int D, int d_valid,
                          int log2dp, int variant, int wpb, cudaStream_t stream) {
#define SVT_VAR_LAUNCH(VAR, WPBV)                                                               \
  wta_stats_kernel<int8_t, V, VAR, WPBV>                                                        \
      <<<(unsigned)((npix + (WPBV) - 1) / (WPBV)), 32 * (WPBV), 0, stream>>>(                   \
          hf, hb, best, idx, cm, cp, comp, npix, D, d_valid, log2dp)
  if (wpb != WARPS_PER_BLOCK) {
    if (variant != kBase) return (int)cudaErrorInvalidValue;
    switch (wpb) {
      case 2: SVT_VAR_LAUNCH(kBase, 2); return 0;
      case 32: SVT_VAR_LAUNCH(kBase, 32); return 0;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (variant) {
    case kBase: SVT_VAR_LAUNCH(kBase, WARPS_PER_BLOCK); return 0;
    case kF32Sum: SVT_VAR_LAUNCH(kF32Sum, WARPS_PER_BLOCK); return 0;
    case kBestOnly: SVT_VAR_LAUNCH(kBestOnly, WARPS_PER_BLOCK); return 0;
    case kNoKey: SVT_VAR_LAUNCH(kNoKey, WARPS_PER_BLOCK); return 0;
    case kSumOnly: SVT_VAR_LAUNCH(kSumOnly, WARPS_PER_BLOCK); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVT_VAR_LAUNCH
}

// One measurement variant on int8 (npix, D) volumes, D <= 128: a form of the
// enum, and wpb warps per block (8 unless kBase: 2 or 32). kBestOnly and
// kSumOnly write best and idx only.
extern "C" int svt_wta_stats_variant(const void* hf, const void* hb, void* best, void* idx,
                                     void* cm, void* cp, void* comp, int npix, int D, int d_valid,
                                     int variant, int wpb, void* stream) {
  const int log2dp = log2_ceil(D);
  const int8_t* a = (const int8_t*)hf;
  const int8_t* b = (const int8_t*)hb;
  float* bo = (float*)best;
  int32_t* io = (int32_t*)idx;
  float* mo = (float*)cm;
  float* po = (float*)cp;
  float* co = (float*)comp;
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
#define SVT_VAR_CASE(VV)                                                                   \
  case VV:                                                                                 \
    err = launch_variant<VV>(a, b, bo, io, mo, po, co, npix, D, d_valid, log2dp, variant, wpb, \
                             st);                                                         \
    break;
  switch ((D + 31) / 32) {
    SVT_VAR_CASE(1) SVT_VAR_CASE(2) SVT_VAR_CASE(3) SVT_VAR_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;  // the variants take D <= 128
  }
#undef SVT_VAR_CASE
  return err != 0 ? err : (int)cudaGetLastError();
}

#endif  // SVT_VARIANTS
