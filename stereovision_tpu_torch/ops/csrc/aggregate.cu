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
// axis 0. Lane l keeps V >= ceil(D/32) consecutive disparities in registers
// (10 at D=320; V is exact up to 16 and a multiple of 4 above, up to 32, so
// D <= 1024), so d-1/d+1 are registers except at a lane's two ends (one
// __shfl_up and one __shfl_down per step), and the per-step min over D -- the
// latency floor of a step -- is a local min over V values plus a five-round
// __shfl_xor butterfly. The next step's cost bytes are loaded before the
// current step's arithmetic, so the load latency overlaps it. Lanes past D
// carry cost BIG (and seed BIG), which never reaches a real lane's min or
// neighbour term.
//
// Built with -DSVT_VARIANTS, the library also holds svt_aggregate_dual_variant:
// the ablations of scripts/bench_agg_step.py (TPU kernel at :216, the
// measurement script of _agg_dual_kernel's recurrence) as compile-time
// variants of this kernel, on axis 0 (the script scans the outer axis of a
// (W, X, D) volume). Variant kShip is the shipping kernel itself; the others
// each change one ingredient (see the enum). gm_interleave5 is a kernel of
// its own (agg_interleave_kernel).

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define WARPS_PER_BLOCK 4

static constexpr float kBig = 1e9f;

// Forms of the recurrence (the variant parameter); kShip is the shipping
// kernel, and the only one the shipping entry instantiates.
enum : int {
  kShip = 0,        // normalised carry, L stored
  kRaw = 1,         // raw carry L, the previous row's min taken inside the step
  kNormStoreN = 2,  // normalised carry, the carry stored (the first row's carry is c)
  kNoGroupMin = 3,  // no min butterfly: the carry is L itself (another function)
  kNoShifts = 4,    // no d-1/d+1 terms, raw carry (another function)
  kNoStore = 5,     // every bs-th row's L stored, into a compact volume
  kCopy = 6,        // the same loads and stores, no recurrence
  kFormMask = 15,
  kFwdOnly = 16,    // flag: the forward direction alone
};

template <typename OutT>
__device__ __forceinline__ OutT store_value(float l, bool clamp) {
  return (OutT)__float2int_rz(clamp ? fminf(l, 127.0f) : l);
}

template <int V>
__device__ __forceinline__ float warp_min_of(const float (&x)[V]) {
  float m = x[0];
#pragma unroll
  for (int v = 1; v < V; ++v) m = fminf(m, x[v]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(FULL_MASK, m, o));
  return m;
}

template <int V, typename OutT, int VAR = kShip, typename InT = int8_t,
          int WPB = WARPS_PER_BLOCK>
__global__ void __launch_bounds__(32 * WPB)
agg_dual_kernel(const InT* __restrict__ cost_f, const InT* __restrict__ cost_b,
                const float* __restrict__ seed_f, const float* __restrict__ seed_b,
                OutT* __restrict__ out_f, OutT* __restrict__ out_b, float* __restrict__ final_f,
                float* __restrict__ final_b, int H, int W, int D, int axis, float p1, float p2,
                int clamp, int bs) {
  constexpr int kForm = VAR & kFormMask;
  constexpr bool kDual = (VAR & kFwdOnly) == 0;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int nlines = axis == 0 ? W : H;
  const int line = kDual ? warp >> 1 : warp;
  const int dir = kDual ? warp & 1 : 0;  // 0: forward, 1: backward
  if (line >= nlines) return;  // warp-uniform
  const int S = axis == 0 ? H : W;
  const long long step = axis == 0 ? (long long)W * D : (long long)D;
  const long long base = axis == 0 ? (long long)line * D : (long long)line * W * D;
  const InT* cost = dir ? cost_b : cost_f;
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
    const bool first = it == 0 && seed == nullptr;
    if (first || kForm == kCopy) {
#pragma unroll
      for (int v = 0; v < V; ++v) l[v] = c[v];
    } else if constexpr (kForm == kNoShifts) {
      const float mp = warp_min_of<V>(n);
#pragma unroll
      for (int v = 0; v < V; ++v) l[v] = c[v] + fminf(n[v], mp + p2) - mp;
    } else {
      float lo = __shfl_up_sync(FULL_MASK, n[V - 1], 1);
      float hi = __shfl_down_sync(FULL_MASK, n[0], 1);
      if (lane == 0) lo = kBig;
      if (lane == 31) hi = kBig;
      // raw carry: the previous row's min, whose butterfly overlaps the shuffles
      const float mp = kForm == kRaw ? warp_min_of<V>(n) : 0.0f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float sm = v == 0 ? lo : n[v - 1];
        const float sp = v == V - 1 ? hi : n[v + 1];
        if constexpr (kForm == kRaw)
          l[v] = c[v] + fminf(fminf(n[v], mp + p2), fminf(sm, sp) + p1) - mp;
        else
          l[v] = c[v] + fminf(fminf(n[v], p2), fminf(sm, sp) + p1);
      }
    }
    constexpr bool kNormalised = kForm == kShip || kForm == kNormStoreN || kForm == kNoStore;
    const float m = kNormalised ? warp_min_of<V>(l) : 0.0f;
    const long long off = base + (long long)s * step;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float stored = l[v];
      if constexpr (kForm == kNormStoreN) {
        n[v] = first ? l[v] : l[v] - m;
        stored = n[v];
      } else if constexpr (kNormalised) {
        n[v] = l[v] - m;
      } else {
        n[v] = l[v];
      }
      if constexpr (kForm != kNoStore) {
        if (d0 + v < D) out[off + d0 + v] = store_value<OutT>(stored, clamp != 0);
      }
    }
    if constexpr (kForm == kNoStore) {
      // a block of bs rows keeps its last L: forward at its last row, backward at its first
      if (dir ? s % bs == 0 : (s % bs == bs - 1 || s == S - 1)) {
        const long long offc = base + (long long)(s / bs) * step;
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (d0 + v < D) out[offc + d0 + v] = store_value<OutT>(l[v], clamp != 0);
      }
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

// Values a lane keeps: ceil(D/32), rounded up to a multiple of 4 past 16
// (a lane's extra values are past D and carry BIG); 0 past D = 1024.
static int lane_values(int D) {
  const int V = (D + 31) / 32;
  if (V <= 16) return V;
  return V <= 32 ? (V + 3) / 4 * 4 : 0;
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
#define SVT_AGG_CASE(VV)                                                                   \
  case VV:                                                                                 \
    agg_dual_kernel<VV, OutT><<<grid, block, 0, stream>>>(                                 \
        cost_f, cost_b, seed_f, seed_b, out_f, out_b, final_f, final_b, H, W, D, axis, p1, p2, \
        clamp, 0);                                                                         \
    break;
  switch (lane_values(D)) {
    SVT_AGG_CASE(1) SVT_AGG_CASE(2) SVT_AGG_CASE(3) SVT_AGG_CASE(4)
    SVT_AGG_CASE(5) SVT_AGG_CASE(6) SVT_AGG_CASE(7) SVT_AGG_CASE(8)
    SVT_AGG_CASE(9) SVT_AGG_CASE(10) SVT_AGG_CASE(11) SVT_AGG_CASE(12)
    SVT_AGG_CASE(13) SVT_AGG_CASE(14) SVT_AGG_CASE(15) SVT_AGG_CASE(16)
    SVT_AGG_CASE(20) SVT_AGG_CASE(24) SVT_AGG_CASE(28) SVT_AGG_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;  // D > 1024
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

#ifdef SVT_VARIANTS

// gm_interleave5 on this card: one warp carries G adjacent lines of D <= 32
// at once (lane l holds plane l of each, one register a line), so the G
// per-line min butterflies are independent and overlap, where the shipping
// kernel gives each D=32 line a warp of its own. The shipping kernel's
// arithmetic (normalised carry, L stored), so its values are bit-exact with
// kShip's; the G lines' planes are one contiguous G*D-byte run a step.
template <int G>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
agg_interleave_kernel(const int8_t* __restrict__ cost, int8_t* __restrict__ out_f,
                      int8_t* __restrict__ out_b, int S, int L, int D, float p1, float p2) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int line0 = (warp >> 1) * G;
  const int dir = warp & 1;
  if (line0 >= L) return;  // warp-uniform
  const long long step = (long long)L * D;
  int8_t* out = dir ? out_b : out_f;
  const int ds = dir ? -1 : 1;
  int s = dir ? S - 1 : 0;
  bool ok[G];
  float c[G], cn[G], n[G], l[G], m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    ok[g] = line0 + g < L && lane < D;
    c[g] = ok[g] ? (float)cost[s * step + (long long)(line0 + g) * D + lane] : kBig;
  }
  for (int it = 0; it < S; ++it) {
    if (it + 1 < S) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        cn[g] = ok[g] ? (float)cost[(s + ds) * step + (long long)(line0 + g) * D + lane] : kBig;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (it == 0) {
        l[g] = c[g];
      } else {
        float lo = __shfl_up_sync(FULL_MASK, n[g], 1);
        float hi = __shfl_down_sync(FULL_MASK, n[g], 1);
        if (lane == 0) lo = kBig;
        if (lane == 31) hi = kBig;
        l[g] = c[g] + fminf(fminf(n[g], p2), fminf(lo, hi) + p1);
      }
      m[g] = l[g];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) m[g] = fminf(m[g], __shfl_xor_sync(FULL_MASK, m[g], o));
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      n[g] = l[g] - m[g];
      if (ok[g])
        out[s * step + (long long)(line0 + g) * D + lane] = store_value<int8_t>(l[g], true);
      c[g] = cn[g];
    }
    s += ds;
  }
}

static constexpr int kInterleave = 7;  // the variant code of agg_interleave_kernel
static constexpr int kInterleaveLines = 4;

template <int V>
static int launch_variant(const void* cost, int8_t* of, int8_t* ob, int S, int L, int D, float p1,
                          float p2, int variant, int wpb, int in_bytes, int bs,
                          cudaStream_t stream) {
  const int8_t* c8 = (const int8_t*)cost;
#define SVT_VAR_LAUNCH(VAR, InT, WPBV, COST, WARPS)                                         \
  agg_dual_kernel<V, int8_t, VAR, InT, WPBV><<<((WARPS) + (WPBV) - 1) / (WPBV), 32 * (WPBV), 0, \
                                               stream>>>(                                   \
      COST, COST, nullptr, nullptr, of, ob, nullptr, nullptr, S, L, D, 0, p1, p2, 1, bs)
  if (in_bytes == 4 || wpb != WARPS_PER_BLOCK) {
    if (variant != kShip) return (int)cudaErrorInvalidValue;
    if (in_bytes == 4) {
      if (wpb != WARPS_PER_BLOCK) return (int)cudaErrorInvalidValue;
      SVT_VAR_LAUNCH(kShip, float, WARPS_PER_BLOCK, (const float*)cost, 2 * L);
      return 0;
    }
    switch (wpb) {
      case 1: SVT_VAR_LAUNCH(kShip, int8_t, 1, c8, 2 * L); return 0;
      case 2: SVT_VAR_LAUNCH(kShip, int8_t, 2, c8, 2 * L); return 0;
      case 8: SVT_VAR_LAUNCH(kShip, int8_t, 8, c8, 2 * L); return 0;
      case 16: SVT_VAR_LAUNCH(kShip, int8_t, 16, c8, 2 * L); return 0;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (variant) {
    case kShip: SVT_VAR_LAUNCH(kShip, int8_t, WARPS_PER_BLOCK, c8, 2 * L); return 0;
    case kRaw: SVT_VAR_LAUNCH(kRaw, int8_t, WARPS_PER_BLOCK, c8, 2 * L); return 0;
    case kNormStoreN:
      SVT_VAR_LAUNCH(kNormStoreN, int8_t, WARPS_PER_BLOCK, c8, 2 * L);
      return 0;
    case kNoGroupMin:
      SVT_VAR_LAUNCH(kNoGroupMin, int8_t, WARPS_PER_BLOCK, c8, 2 * L);
      return 0;
    case kNoShifts: SVT_VAR_LAUNCH(kNoShifts, int8_t, WARPS_PER_BLOCK, c8, 2 * L); return 0;
    case kNoStore: SVT_VAR_LAUNCH(kNoStore, int8_t, WARPS_PER_BLOCK, c8, 2 * L); return 0;
    case kCopy: SVT_VAR_LAUNCH(kCopy, int8_t, WARPS_PER_BLOCK, c8, 2 * L); return 0;
    case kShip | kFwdOnly:
      SVT_VAR_LAUNCH(kShip | kFwdOnly, int8_t, WARPS_PER_BLOCK, c8, L);
      return 0;
    case kCopy | kFwdOnly:
      SVT_VAR_LAUNCH(kCopy | kFwdOnly, int8_t, WARPS_PER_BLOCK, c8, L);
      return 0;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVT_VAR_LAUNCH
}

// One measurement variant on an (S, L, D) volume scanned along S (the
// script's (W, X, D) with L lines of D planes), int8 stores clamped at 127.
// variant: a form of the enum (kFwdOnly or'd in for one direction) or
// kInterleave; wpb: warps per block (4 unless kShip); in_bytes: 1 (int8
// cost) or 4 (float32 cost, kShip only); bs: kNoStore's block of rows, whose
// compact (ceil(S/bs), L, D) outputs hold each block's last L. out_b is
// unused for one direction.
extern "C" int svt_aggregate_dual_variant(const void* cost, void* out_f, void* out_b, int S, int L,
                                          int D, float p1, float p2, int variant, int wpb,
                                          int in_bytes, int bs, void* stream) {
  int8_t* of = (int8_t*)out_f;
  int8_t* ob = (int8_t*)out_b;
  const cudaStream_t st = (cudaStream_t)stream;
  if (variant == kInterleave) {
    if (D > 32) return (int)cudaErrorInvalidValue;
    const int warps = 2 * ((L + kInterleaveLines - 1) / kInterleaveLines);
    agg_interleave_kernel<kInterleaveLines>
        <<<(warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK, 32 * WARPS_PER_BLOCK, 0, st>>>(
            (const int8_t*)cost, of, ob, S, L, D, p1, p2);
    return (int)cudaGetLastError();
  }
  if ((variant & kFormMask) == kNoStore && bs < 1) return (int)cudaErrorInvalidValue;
  int err;
#define SVT_VAR_CASE(VV)                                                                  \
  case VV:                                                                                \
    err = launch_variant<VV>(cost, of, ob, S, L, D, p1, p2, variant, wpb, in_bytes, bs, st); \
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
