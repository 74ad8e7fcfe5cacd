// Dual-direction SGM path aggregation along one axis of an (H, W, D) int8
// cost volume -> two (H, W, D) path-cost volumes (forward, backward), int8 or
// int16.
//
// Replaces: stereovision_tpu/ops/sgm_pallas.py:aggregate_dual
// (_agg_dual_kernel), forward and backward scans of one axis in one launch.
// axis 1 scans each row along W (the horizontal pair), axis 0 scans each
// column along H (the vertical pair): both read the same volume, where each
// step of a line is D contiguous bytes, so the TPU's transposed copy of the
// cost is not needed.
//
// Semantics, exactly those of _sgm_step_norm/_renorm (sgm_pallas.py:426-479),
// in float32: the first step is L = c; then
//   L[d] = c[d] + min(n[d], P2, min(n[d-1], n[d+1]) + P1),  n = L_prev - min(L_prev),
// with n[-1] and n[D] at +BIG. The carry is never clamped; the int8 store
// clamps at 127 explicitly (a float -> int8 conversion does not saturate).
//
// Chain mode (axis 0 only; the cross-tile vertical chain of
// parallel/disparity_exact): each direction starts from a (W, D) float32
// min-normalised seed row (bf forward, bb backward) instead of L = c, so its
// first row takes the step too (a zero seed gives c + min(0, P2, P1) = c, a
// fresh start), and writes its normalised carry after its last row (row H-1
// forward, row 0 backward) to ff / fb, the next tile's seed. The backward
// scan may read another volume (cost_b: the pipelined chain aggregates a
// different frame in each direction). The TPU kernel pads the scan to its
// block multiple (forward at the end, backward at the front) so that both
// scans start on real rows; a warp here walks exactly the H rows and needs
// no padding.
//
// Bound on this card: bytes per launch, read H*W*D + write 2*H*W*D*itemsize
// (885 MB at 1280x720, D=320, int8: ~0.26 ms at 3.35 TB/s). But each line's
// steps form a serial chain, so the latency of one step times the line
// length is the other floor, and it is what this simple design meets first.
// Design: one warp per (line, direction): 2*H warps for axis 1, 2*W for
// axis 0. Lane l keeps V = ceil(D/32) consecutive disparities in registers
// (10 at D=320), so d-1/d+1 are registers except at a lane's two ends (one
// __shfl_up and one __shfl_down per step), and the per-step min over D -- the
// latency floor of a step -- is a local min over V values plus a five-round
// __shfl_xor butterfly. The next step's cost bytes are loaded before the
// current step's arithmetic, so the load latency overlaps it. Lanes past D
// carry cost BIG (and seed BIG), which never reaches a real lane's min or
// neighbour term.

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define WARPS_PER_BLOCK 4

static constexpr float kBig = 1e9f;

template <typename OutT>
__device__ __forceinline__ OutT store_value(float l, bool clamp) {
  return (OutT)__float2int_rz(clamp ? fminf(l, 127.0f) : l);
}

template <int V, typename OutT>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
agg_dual_kernel(const int8_t* __restrict__ cost_f, const int8_t* __restrict__ cost_b,
                const float* __restrict__ seed_f, const float* __restrict__ seed_b,
                OutT* __restrict__ out_f, OutT* __restrict__ out_b, float* __restrict__ final_f,
                float* __restrict__ final_b, int H, int W, int D, int axis, float p1, float p2,
                int clamp) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int nlines = axis == 0 ? W : H;
  const int line = warp >> 1;
  const int dir = warp & 1;  // 0: forward, 1: backward
  if (line >= nlines) return;  // warp-uniform
  const int S = axis == 0 ? H : W;
  const long long step = axis == 0 ? (long long)W * D : (long long)D;
  const long long base = axis == 0 ? (long long)line * D : (long long)line * W * D;
  const int8_t* cost = dir ? cost_b : cost_f;
  OutT* out = dir ? out_b : out_f;
  const float* seed = dir ? seed_b : seed_f;  // chain mode: axis 0, line = column
  float* final_carry = dir ? final_b : final_f;
  const int ds = dir ? -1 : 1;
  int s = dir ? S - 1 : 0;
  const int d0 = lane * V;

  float c[V], cn[V], n[V], l[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    c[v] = d0 + v < D ? (float)cost[base + s * step + d0 + v] : kBig;
    n[v] = seed != nullptr && d0 + v < D ? seed[(long long)line * D + d0 + v] : kBig;
  }

  for (int it = 0; it < S; ++it) {
    if (it + 1 < S) {
      const long long off = base + (long long)(s + ds) * step;
#pragma unroll
      for (int v = 0; v < V; ++v) cn[v] = d0 + v < D ? (float)cost[off + d0 + v] : kBig;
    }
    if (it == 0 && seed == nullptr) {
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
      if (d0 + v < D) out[off + d0 + v] = store_value<OutT>(l[v], clamp != 0);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) c[v] = cn[v];
    s += ds;
  }
  if (final_carry != nullptr) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (d0 + v < D) final_carry[(long long)line * D + d0 + v] = n[v];
  }
}

template <typename OutT>
static int launch(const int8_t* cost_f, const int8_t* cost_b, const float* seed_f,
                  const float* seed_b, OutT* out_f, OutT* out_b, float* final_f, float* final_b,
                  int H, int W, int D, int axis, float p1, float p2, int clamp,
                  cudaStream_t stream) {
  const int nlines = axis == 0 ? W : H;
  const int warps = 2 * nlines;
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid((warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  const int V = (D + 31) / 32;
#define SVT_AGG_CASE(VV)                                                                   \
  case VV:                                                                                 \
    agg_dual_kernel<VV, OutT><<<grid, block, 0, stream>>>(                                 \
        cost_f, cost_b, seed_f, seed_b, out_f, out_b, final_f, final_b, H, W, D, axis, p1, p2, \
        clamp);                                                                            \
    break;
  switch (V) {
    SVT_AGG_CASE(1) SVT_AGG_CASE(2) SVT_AGG_CASE(3) SVT_AGG_CASE(4)
    SVT_AGG_CASE(5) SVT_AGG_CASE(6) SVT_AGG_CASE(7) SVT_AGG_CASE(8)
    SVT_AGG_CASE(9) SVT_AGG_CASE(10) SVT_AGG_CASE(11) SVT_AGG_CASE(12)
    SVT_AGG_CASE(13) SVT_AGG_CASE(14) SVT_AGG_CASE(15) SVT_AGG_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;  // D > 512
  }
#undef SVT_AGG_CASE
  return (int)cudaGetLastError();
}

// out_bytes: 1 (int8, clamped at 127) or 2 (int16). cost_b: the backward
// scan's volume (cost itself outside chain mode). seed_f/seed_b and
// final_f/final_b: (W, D) float32 rows of chain mode (axis 0), else null.
extern "C" int svt_aggregate_dual(const void* cost, const void* cost_b, const void* seed_f,
                                  const void* seed_b, void* out_f, void* out_b, void* final_f,
                                  void* final_b, int H, int W, int D, int axis, float p1,
                                  float p2, int out_bytes, void* stream) {
  if ((seed_f != nullptr || final_f != nullptr) && axis != 0)
    return (int)cudaErrorInvalidValue;  // chain mode scans columns only
  const int8_t* cf = (const int8_t*)cost;
  const int8_t* cb = (const int8_t*)cost_b;
  const float* sf = (const float*)seed_f;
  const float* sb = (const float*)seed_b;
  float* ff = (float*)final_f;
  float* fb = (float*)final_b;
  if (out_bytes == 1)
    return launch<int8_t>(cf, cb, sf, sb, (int8_t*)out_f, (int8_t*)out_b, ff, fb, H, W, D, axis,
                          p1, p2, 1, (cudaStream_t)stream);
  return launch<int16_t>(cf, cb, sf, sb, (int16_t*)out_f, (int16_t*)out_b, ff, fb, H, W, D,
                         axis, p1, p2, 0, (cudaStream_t)stream);
}
