// One SGM path direction along one axis of an (H, W, D) float32 cost volume
// -> float32 path costs, written to a new volume or added in place onto a
// float32 running sum (acc); optionally (wta_out) also the winner statistics
// of every pixel of the volume it wrote.
//
// Replaces: stereovision_tpu/ops/sgm_pallas.py:aggregate_dir (_agg_kernel),
// which stereo.sgm.aggregate calls four times (-> <- down up) on the float32
// volume of census_cost_volume, each call adding onto the previous ones' sum
// through input/output aliasing. axis 1 scans each row along W, axis 0 each
// column along H; reverse scans from the far end. The TPU kernel pads D to
// 128 lanes with cost 1e9 and the scan to its block multiple with a constant
// row (a fresh start); exactly D planes and exactly S steps give the same
// sums. Its wta_out mode (sgm_pallas.py:574-581: the _wta_stats of the final
// summed block, axis 0 only) is the WTA template argument here; its
// emit_transposed mode is not needed (the LR check reads the (H, W, D) sum
// in place).
//
// Semantics, exactly those of _sgm_step_norm/_renorm (sgm_pallas.py:426-479),
// in float32: L = c at the first step, then
//   L[d] = c[d] + min(n[d], P2, min(n[d-1], n[d+1]) + P1),  n = L_prev - min(L_prev),
// with n[-1] and n[D] at +BIG; with acc, acc[i] = acc[i] + L[i], the
// reference's order of the running sum.
//
// Bound on this card: bytes, read 4*H*W*D (+ 4*H*W*D of acc) and write
// 4*H*W*D (+ 20*H*W with wta_out): 3.54 GB with acc at 1280x720, D=320,
// ~1.06 ms at 3.35 TB/s. Design: one warp per line, the layout of
// aggregate.cu (lane l keeps V >= ceil(D/32) consecutive disparities in
// registers, V exact up to 16 and a multiple of 4 above, up to 32; one
// __shfl_up, one __shfl_down and a five-round __shfl_xor min per step; the
// next step's cost and acc are loaded before the current step's arithmetic).
// With wta_out the statistics of each row are taken from the registers just
// stored, with wta.cu's butterflies (best, the first d at best, cm, cp and
// the competitor), so the volume is not read again. A line is a serial
// chain, so this kernel is latency-bound by design for now: axis 1 has only
// H = 720 warps and axis 0 W = 1280, far too few to fill 132 SMs (about 5
// and 10 warps an SM).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define WARPS_PER_BLOCK 4

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

template <int V, bool WTA>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
agg_dir_kernel(const float* __restrict__ cost, float* __restrict__ out, int H, int W, int D,
               int axis, int reverse, float p1, float p2, int accumulate,
               float* __restrict__ best_o, int32_t* __restrict__ idx_o, float* __restrict__ cm_o,
               float* __restrict__ cp_o, float* __restrict__ comp_o) {
  const int line = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int nlines = axis == 0 ? W : H;
  if (line >= nlines) return;  // warp-uniform
  const int S = axis == 0 ? H : W;
  const long long step = axis == 0 ? (long long)W * D : (long long)D;
  const long long base = axis == 0 ? (long long)line * D : (long long)line * W * D;
  const int ds = reverse ? -1 : 1;
  int s = reverse ? S - 1 : 0;
  const int d0 = lane * V;

  float c[V], cn[V], a[V], an[V], n[V], l[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const long long i = base + s * step + d0 + v;
    c[v] = d0 + v < D ? cost[i] : kBig;
    a[v] = accumulate && d0 + v < D ? out[i] : 0.0f;
  }

  for (int it = 0; it < S; ++it) {
    if (it + 1 < S) {
      const long long off = base + (long long)(s + ds) * step;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        cn[v] = d0 + v < D ? cost[off + d0 + v] : kBig;
        an[v] = accumulate && d0 + v < D ? out[off + d0 + v] : 0.0f;
      }
    }
    if (it == 0) {
#pragma unroll
      for (int v = 0; v < V; ++v) l[v] = c[v];
    } else {
      float lo = __shfl_up_sync(FULL_MASK, n[V - 1], 1);
      float hi = __shfl_down_sync(FULL_MASK, n[0], 1);
      if (lane == 0) lo = kBig;
      if (lane == 31) hi = kBig;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float sm = v == 0 ? lo : n[v - 1];
        const float sp = v == V - 1 ? hi : n[v + 1];
        l[v] = c[v] + fminf(fminf(n[v], p2), fminf(sm, sp) + p1);
      }
    }
    float m = l[0];
#pragma unroll
    for (int v = 1; v < V; ++v) m = fminf(m, l[v]);
    m = warp_minf(m);
    const long long off = base + (long long)s * step;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      n[v] = l[v] - m;
      if (d0 + v < D) out[off + d0 + v] = accumulate ? a[v] + l[v] : l[v];
    }
    if constexpr (WTA) {
      // the statistics of the values just stored (acc + L, or L)
      float w[V];
      float bm = INFINITY;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        w[v] = accumulate ? a[v] + l[v] : l[v];
        if (d0 + v < D) bm = fminf(bm, w[v]);
      }
      const float best = warp_minf(bm);
      int first = INT_MAX;
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (d0 + v < D && w[v] == best) first = min(first, d0 + v);
      const int idx = warp_mini(first);
      float cm = kBig, cp = kBig, comp = kBig;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int d = d0 + v;
        if (d < D) {
          if (d == idx - 1) cm = fminf(cm, w[v]);
          if (d == idx + 1) cp = fminf(cp, w[v]);
          if (abs(d - idx) > 1) comp = fminf(comp, w[v]);
        }
      }
      cm = warp_minf(cm);
      cp = warp_minf(cp);
      comp = warp_minf(comp);
      if (lane == 0) {
        const long long pix = axis == 0 ? (long long)s * W + line : (long long)line * W + s;
        best_o[pix] = best;
        idx_o[pix] = idx;
        cm_o[pix] = cm;
        cp_o[pix] = cp;
        comp_o[pix] = comp;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      c[v] = cn[v];
      a[v] = an[v];
    }
    s += ds;
  }
}

template <bool WTA>
static int launch(const float* c, float* o, int H, int W, int D, int axis, int reverse, float p1,
                  float p2, int accumulate, float* best, int32_t* idx, float* cm, float* cp,
                  float* comp, cudaStream_t stream) {
  const int nlines = axis == 0 ? W : H;
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid((nlines + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  // values a lane keeps: ceil(D/32), a multiple of 4 past 16 (the extra ones
  // are past D and carry BIG)
  int V = (D + 31) / 32;
  if (V > 16) V = (V + 3) / 4 * 4;
#define SVT_DIR_CASE(VV)                                                                   \
  case VV:                                                                                 \
    agg_dir_kernel<VV, WTA><<<grid, block, 0, stream>>>(c, o, H, W, D, axis, reverse, p1, p2, \
                                                        accumulate, best, idx, cm, cp, comp); \
    break;
  switch (V) {
    SVT_DIR_CASE(1) SVT_DIR_CASE(2) SVT_DIR_CASE(3) SVT_DIR_CASE(4)
    SVT_DIR_CASE(5) SVT_DIR_CASE(6) SVT_DIR_CASE(7) SVT_DIR_CASE(8)
    SVT_DIR_CASE(9) SVT_DIR_CASE(10) SVT_DIR_CASE(11) SVT_DIR_CASE(12)
    SVT_DIR_CASE(13) SVT_DIR_CASE(14) SVT_DIR_CASE(15) SVT_DIR_CASE(16)
    SVT_DIR_CASE(20) SVT_DIR_CASE(24) SVT_DIR_CASE(28) SVT_DIR_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;  // D > 1024
  }
#undef SVT_DIR_CASE
  return (int)cudaGetLastError();
}

// out: a new (H, W, D) float32 volume, or with accumulate the running sum
// itself, updated in place. best/cm/cp/comp (float32) and idx (int32): the
// (H, W) statistics maps of wta_out, or all null.
extern "C" int svt_aggregate_dir(const void* cost, void* out, int H, int W, int D, int axis,
                                 int reverse, float p1, float p2, int accumulate, void* best,
                                 void* idx, void* cm, void* cp, void* comp, void* stream) {
  const float* c = (const float*)cost;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (best != nullptr)
    return launch<true>(c, o, H, W, D, axis, reverse, p1, p2, accumulate, (float*)best,
                        (int32_t*)idx, (float*)cm, (float*)cp, (float*)comp, st);
  return launch<false>(c, o, H, W, D, axis, reverse, p1, p2, accumulate, nullptr, nullptr,
                       nullptr, nullptr, nullptr, st);
}
