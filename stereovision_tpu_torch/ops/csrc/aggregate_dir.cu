// One SGM path direction along one axis of an (H, W, D) float32 cost volume
// -> float32 path costs, written to a new volume or added in place onto a
// float32 running sum (acc).
//
// Replaces: stereovision_tpu/ops/sgm_pallas.py:aggregate_dir (_agg_kernel),
// which stereo.sgm.aggregate calls four times (-> <- down up) on the float32
// volume of census_cost_volume, each call adding onto the previous ones' sum
// through input/output aliasing. axis 1 scans each row along W, axis 0 each
// column along H; reverse scans from the far end. The TPU kernel pads D to
// 128 lanes with cost 1e9 and the scan to its block multiple with a constant
// row (a fresh start); exactly D planes and exactly S steps give the same
// sums. Its wta_out and emit_transposed modes have no caller and are not
// ported.
//
// Semantics, exactly those of _sgm_step_norm/_renorm (sgm_pallas.py:426-479),
// in float32: L = c at the first step, then
//   L[d] = c[d] + min(n[d], P2, min(n[d-1], n[d+1]) + P1),  n = L_prev - min(L_prev),
// with n[-1] and n[D] at +BIG; with acc, acc[i] = acc[i] + L[i], the
// reference's order of the running sum.
//
// Bound on this card: bytes, read 4*H*W*D (+ 4*H*W*D of acc) and write
// 4*H*W*D: 3.54 GB with acc at 1280x720, D=320, ~1.06 ms at 3.35 TB/s.
// Design: one warp per line, the layout of aggregate.cu (lane l keeps
// V = ceil(D/32) consecutive disparities in registers; one __shfl_up, one
// __shfl_down and a five-round __shfl_xor min per step; the next step's cost
// and acc are loaded before the current step's arithmetic). A line is a
// serial chain, so this kernel is latency-bound by design for now: axis 1
// has only H = 720 warps and axis 0 W = 1280, far too few to fill 132 SMs
// (about 5 and 10 warps an SM).

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define WARPS_PER_BLOCK 4

static constexpr float kBig = 1e9f;

template <int V>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
agg_dir_kernel(const float* __restrict__ cost, float* __restrict__ out, int H, int W, int D,
               int axis, int reverse, float p1, float p2, int accumulate) {
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
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(FULL_MASK, m, o));
    const long long off = base + (long long)s * step;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      n[v] = l[v] - m;
      if (d0 + v < D) out[off + d0 + v] = accumulate ? a[v] + l[v] : l[v];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      c[v] = cn[v];
      a[v] = an[v];
    }
    s += ds;
  }
}

// out: a new (H, W, D) float32 volume, or with accumulate the running sum
// itself, updated in place.
extern "C" int svt_aggregate_dir(const void* cost, void* out, int H, int W, int D, int axis,
                                 int reverse, float p1, float p2, int accumulate,
                                 void* stream) {
  const int nlines = axis == 0 ? W : H;
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid((nlines + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  const int V = (D + 31) / 32;
  const float* c = (const float*)cost;
  float* o = (float*)out;
#define SVT_DIR_CASE(VV)                                                                 \
  case VV:                                                                               \
    agg_dir_kernel<VV><<<grid, block, 0, (cudaStream_t)stream>>>(c, o, H, W, D, axis,    \
                                                                 reverse, p1, p2,        \
                                                                 accumulate);            \
    break;
  switch (V) {
    SVT_DIR_CASE(1) SVT_DIR_CASE(2) SVT_DIR_CASE(3) SVT_DIR_CASE(4)
    SVT_DIR_CASE(5) SVT_DIR_CASE(6) SVT_DIR_CASE(7) SVT_DIR_CASE(8)
    SVT_DIR_CASE(9) SVT_DIR_CASE(10) SVT_DIR_CASE(11) SVT_DIR_CASE(12)
    SVT_DIR_CASE(13) SVT_DIR_CASE(14) SVT_DIR_CASE(15) SVT_DIR_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;  // D > 512
  }
#undef SVT_DIR_CASE
  return (int)cudaGetLastError();
}
