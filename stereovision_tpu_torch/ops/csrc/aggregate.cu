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
// steps form a serial chain, so one step's latency times the line length is
// a second floor, and the min/max and conversions of ~7 operations an
// element run at a half and an eighth of the float add rate, a third. A
// design that loads a step's row from device memory one step ahead (the
// earlier one, which the variants below are built on) waits a memory round trip
// every step; this one takes the loads and the stores out of the chain and
// keeps a step's instructions few.
//
// Design (agg_staged_kernel): a block of kLines warps scans kLines adjacent
// lines in one direction (blockIdx.y), a warp a line. Lane l keeps V
// consecutive disparities in registers: ceil(D/32) up to 4, a multiple of 4
// above, up to 32 (D <= 1024), so d-1/d+1 are registers except at a lane's
// two ends (one __shfl_up and one __shfl_down a step).
// - Staging. The block copies its lines' next steps into shared memory, a
//   ring of kRing chunks of T steps (T*D about 1.5 KB a line) filled by
//   16-byte cp.async: chunks k+1 .. k+kRing-1 are in flight while chunk k is
//   scanned (Little's law: 3.35 TB/s x ~1.3 us over 132 SMs is ~32 KB in
//   flight an SM; 11-20 warps an SM here keep 2-3 chunks of ~1.5 KB each).
//   A chunk is a set of runs, each contiguous in the volume, one image row
//   (W*D bytes) apart: on axis 0 one step of the block's adjacent columns
//   (kLines*D bytes), on axis 1 T steps of one row (T*D bytes). A run is
//   copied as the 16-byte-aligned superset of its bytes and read at its
//   offset in it, so an unaligned base (a row crop, a row strip, an odd D)
//   costs a partial granule, not a scalar path.
// - Scan. A step reads its costs from the ring one step ahead (a lane's V
//   bytes as V/4 + 1 words and a funnel shift), and writes L into an output
//   tile that has the output volume's 16-byte phase; when the chunk is done
//   the block flushes the tile in 16-byte stores (bytes at a run's ragged
//   ends). Shared memory is addressed by 32-bit window addresses taken once.
// - Exact integer mode, whenever P1 and P2 are non-negative integers (every
//   value is then an integer below 2^24, exact in float32): bytes become
//   floats by a byte permute into a float's mantissa and one add, L is
//   carried plus 2^20 so that every value is positive and the min over D is
//   a local min over V and one redux.sync (__reduce_min_sync) on the floats'
//   bits, and a store adds 1.5 * 2^23 and keeps the low bits: no int/float
//   conversion and no key transform in a step. Otherwise the same scan
//   without the shift takes the min on order-preserving keys and converts
//   at the store. min is exact in any order, so every value is bit-exact
//   with the plain version either way.
// Lanes past D carry cost BIG (and seed BIG), which never reaches a real
// lane's min or neighbour term.
//
// Built with -DSVT_VARIANTS, the library also holds svt_aggregate_dual_variant:
// the ablations of scripts/bench_agg_step.py (TPU kernel at :216, the
// measurement script of _agg_dual_kernel's recurrence) as compile-time
// variants of the earlier design (agg_dual_kernel: a warp a line and
// direction, the next step's cost loaded from device memory one step ahead,
// the min by butterfly), on axis 0 (the script scans the outer axis of a
// (W, X, D) volume). Variant kShip is that design's shipping kernel; the
// others each change one ingredient (see the enum). gm_interleave5 is a
// kernel of its own (agg_interleave_kernel).

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

static constexpr float kBig = 1e9f;

template <typename OutT>
__device__ __forceinline__ OutT store_value(float l, bool clamp) {
  return (OutT)__float2int_rz(clamp ? fminf(l, 127.0f) : l);
}

// Values a lane of the staged kernel keeps: ceil(D/32) up to 4, rounded up
// to a multiple of 4 above (a lane's extra values are past D and carry BIG),
// so that a lane's values start on a word of the row and lanes 4, 12, 20
// or 28 bytes apart hit distinct banks; 0 past D = 1024.
static int lane_values(int D) {
  const int V = (D + 31) / 32;
  if (V <= 4) return V;
  return V <= 32 ? (V + 3) / 4 * 4 : 0;
}

static constexpr int kLines = 4;  // lines (warps) a block
static constexpr int kRing = 4;   // chunks in the staging ring

// One launch's arguments: _f for the forward scan, _b for the backward one
// (named fields: a parameter indexed by the direction would be copied to
// local memory).
struct AggArgs {
  const int8_t *cost_f, *cost_b;
  const float *seed_f, *seed_b;  // chain mode: (W, D) seed rows, else null
  void *out_f, *out_b;
  float *final_f, *final_b;  // chain mode: (W, D) carries after the last row, else null
  int H, W, D, axis;
  int T;  // steps a chunk
  float p1, p2;
  int exact_ints;  // p1, p2 integers in [0, 2^20): every value is an integer below 2^24
};

// Shared memory of a block: the ring of kRing chunks, then the output tile.
// A run takes a slot of the 16-byte-aligned superset of its bytes.
struct Geometry {
  int runs;      // runs a chunk
  int in_slot;   // bytes a run takes in the ring
  int out_slot;  // bytes a run takes in the output tile
  int in_chunk;  // bytes a chunk takes in the ring
  int bytes;     // dynamic shared memory of a block
};

__host__ __device__ inline int superset_bytes(int nbytes) { return 16 * ((nbytes + 30) / 16); }

__host__ __device__ inline Geometry geometry(int axis, int D, int T, int out_bytes) {
  const int run = (axis == 0 ? kLines : T) * D;  // elements of a full run
  Geometry g;
  g.runs = axis == 0 ? T : kLines;
  g.in_slot = superset_bytes(run);
  g.out_slot = superset_bytes(run * out_bytes);
  g.in_chunk = g.runs * g.in_slot;
  g.bytes = kRing * g.in_chunk + g.runs * g.out_slot;
  return g;
}

// Steps a chunk: about 1.5 KB of cost a line, from 2 to 32 steps.
static int chunk_steps(int D) {
  const int t = 1536 / D;
  return t < 2 ? 2 : (t > 32 ? 32 : t);
}

// The rows [lo, lo + steps) of the scan axis that chunk c of a direction
// covers (the backward scan's chunks run from the far end), and its runs.
struct Chunk {
  int lo, steps;
  long long first;  // element of run 0's first byte; run r starts W*D elements later each
  int runs, run_len;  // runs in this chunk, elements a run
};

__device__ __forceinline__ Chunk chunk_of(int axis, int D, int T, long long row, int dir, int c,
                                          int line0, int nl, int S) {
  Chunk k;
  const int hi = dir ? S - c * T : min(S, (c + 1) * T);
  k.lo = dir ? max(0, hi - T) : c * T;
  k.steps = hi - k.lo;
  k.first = axis == 0 ? k.lo * row + (long long)line0 * D : line0 * row + (long long)k.lo * D;
  k.runs = axis == 0 ? k.steps : nl;
  k.run_len = (axis == 0 ? nl : k.steps) * D;
  return k;
}

// Shared memory is addressed by 32-bit shared-window addresses, taken once
// from the dynamic buffer, so that no access re-derives the window.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds_u8(unsigned a) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint32_t lds_u32(unsigned a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint4 lds_v4(unsigned a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}

template <typename OutT>
__device__ __forceinline__ void sts(unsigned a, int v) {
  if constexpr (sizeof(OutT) == 1)
    asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
  else
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(a), "h"((unsigned short)v) : "memory");
}

// Every thread of the block: start the copy of a chunk's runs into the ring
// slot at shared address dst, 16 bytes a cp.async, the aligned superset of
// each run.
__device__ __forceinline__ void stage(unsigned dst, const int8_t* cost, const Chunk& k,
                                      long long row, int slot) {
  const int per_run = slot / 16;
  for (int i = threadIdx.x; i < k.runs * per_run; i += blockDim.x) {
    const int r = i / per_run, j = i - r * per_run;
    const uintptr_t a = (uintptr_t)(cost + k.first + r * row);
    const uintptr_t src = (a & ~(uintptr_t)15) + 16 * j;
    if (src < a + k.run_len) cp_async16(dst + r * slot + 16 * j, (const void*)src);
  }
}

// Every thread of the block: write the output tile (shared address tile)
// to the volume, 16 bytes a store where a granule lies inside its run,
// bytes at a run's ends.
template <typename OutT>
__device__ __forceinline__ void flush(OutT* out, unsigned tile, const Chunk& k, long long row,
                                      int slot) {
  const int per_run = slot / 16;
  for (int i = threadIdx.x; i < k.runs * per_run; i += blockDim.x) {
    const int r = i / per_run, j = i - r * per_run;
    const uintptr_t a = (uintptr_t)(out + k.first + r * row);
    const uintptr_t e = a + (uintptr_t)k.run_len * sizeof(OutT);
    const uintptr_t g = (a & ~(uintptr_t)15) + 16 * j;
    if (g >= e) continue;
    const unsigned s = tile + r * slot + 16 * j;
    if (g >= a && g + 16 <= e) {
      *(uint4*)g = lds_v4(s);
    } else {
      for (uintptr_t b = g > a ? g : a; b < e && b < g + 16; ++b)
        *(unsigned char*)b = (unsigned char)lds_u8(s + (unsigned)(b - g));
    }
  }
}

// One step's cost bytes for a lane, read from the ring ahead of the step
// that needs them: V/4 + 1 words and the byte shift that aligns them (V a
// multiple of 4; a lane's V bytes start anywhere in a word), or V bytes. A
// lane past D reads nothing: its values are BIG.
template <int V>
struct Raw {
  uint32_t w[V % 4 == 0 ? V / 4 + 1 : V];
  unsigned shift;
};

template <int V>
__device__ __forceinline__ void load_raw(Raw<V>& r, unsigned at, int nv) {
  if (nv <= 0) return;
  if constexpr (V % 4 == 0) {
    const unsigned w = at & ~3u;
    r.shift = (at & 3) * 8;
#pragma unroll
    for (int k = 0; k <= V / 4; ++k) r.w[k] = lds_u32(w + 4 * k);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) r.w[v] = v < nv ? lds_u8(at + v) : 0u;
  }
}

// A lane's costs as floats, each plus the launch's shift (see
// agg_staged_kernel): a signed byte b, offset to b + 128 by an XOR, placed in
// the low mantissa bits of 2^23 (a byte permute), is 2^23 + b + 128 as a
// float; subtracting bias[v] leaves b + 2^23 + 128 - bias[v] exactly, or,
// past D, where bias[v] is -BIG, a value near BIG. No int-to-float
// conversion (an eighth of the add rate on this card) and no test of v
// against D.
template <int V>
__device__ __forceinline__ void unpack(float (&c)[V], const Raw<V>& r, const float (&bias)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const uint32_t a = __funnelshift_r(r.w[k], r.w[k + 1], r.shift) ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        c[4 * k + b] = __int_as_float(__byte_perm(a, 0x4B000000u, 0x7540u | b)) - bias[4 * k + b];
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) c[v] = __int_as_float(r.w[v] ^ 0x4B000080u) - bias[v];
  }
}

// A float's order-preserving int key (no NaN here), and back: the same
// involution.
__device__ __forceinline__ int order_key(int b) { return b ^ ((b >> 31) & 0x7fffffff); }

// The min over a warp's values: a local min over V, then one redux.sync on
// the floats' bits, which order as ints when every value is positive
// (`positive`), else on their order-preserving keys.
template <int V>
__device__ __forceinline__ float warp_min(const float (&x)[V], bool positive) {
  float t[V];
#pragma unroll
  for (int v = 0; v < V; ++v) t[v] = x[v];
#pragma unroll
  for (int w = 1; w < V; w *= 2) {
#pragma unroll
    for (int v = 0; v + w < V; v += 2 * w) t[v] = fminf(t[v], t[v + w]);
  }
  if (positive) return __int_as_float(__reduce_min_sync(FULL_MASK, __float_as_int(t[0])));
  const int k = __reduce_min_sync(FULL_MASK, order_key(__float_as_int(t[0])));
  return __int_as_float(order_key(k));
}

// Exact integer mode (AggArgs::exact_ints): every cost, carry and path cost
// is an integer below 2^24, so float adds are exact in any grouping. The
// scan then carries L + kShift (costs enter with the shift, the carry n =
// L - min L is unchanged): every value is positive, so the min takes the
// floats' bits as they are, and a store adds kStoreMagic, which leaves L's
// two's complement in the low bits of the sum (no float-to-int conversion).
// Otherwise the shift is 0, the min takes keys and a store converts.
static constexpr float kShift = 1048576.0f;        // 2^20
static constexpr float kStoreMagic = 12582912.0f;  // 1.5 * 2^23

// Shared addresses of a chunk's step rows for one lane: on axis 0 run t (its
// own 16-byte phase) and the warp's line in it, on axis 1 the warp's run
// and step t in it.
template <int AXIS, int kOut>
struct Rows {
  unsigned in0, out0;  // axis 1: step 0's rows; axis 0: run 0's start plus the line's offset
  int in_slot, out_slot, in_ph, out_ph, in_rowm, out_rowm, D;
  __device__ __forceinline__ unsigned in(int t) const {
    return AXIS == 0 ? in0 + t * in_slot + ((in_ph + t * in_rowm) & 15) : in0 + t * D;
  }
  __device__ __forceinline__ unsigned out(int t) const {
    return AXIS == 0 ? out0 + t * out_slot + ((out_ph + t * out_rowm) & 15) : out0 + t * D * kOut;
  }
};

// What one lane needs for a step that the whole scan shares.
template <int V>
struct Consts {
  float bias[V];  // unpack: c + shift, or about BIG past D
  float p1, p2, store_add, hi_clamp;
  int lane, nv;   // nv: this lane's values below D (V or more: all)
};

// One step: L (+ shift) from the step's costs and the carry n (CARRIED;
// else L = c, a line's first step), its min (POSITIVE: on the floats' bits,
// else on keys), the next carry, and L stored into the tile at o (INTS: by
// the magic add, else by conversion).
template <int V, typename OutT, bool INTS, bool CARRIED, bool POSITIVE>
__device__ __forceinline__ void step(float (&n)[V], const Raw<V>& raw, const Consts<V>& k,
                                     unsigned o) {
  constexpr bool kClamp = sizeof(OutT) == 1;
  float l[V];
  unpack<V>(l, raw, k.bias);
  if constexpr (CARRIED) {
    float lo = __shfl_up_sync(FULL_MASK, n[V - 1], 1);
    float hi = __shfl_down_sync(FULL_MASK, n[0], 1);
    if (k.lane == 0) lo = kBig;
    if (k.lane == 31) hi = kBig;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float sm = v == 0 ? lo : n[v - 1];
      const float sp = v == V - 1 ? hi : n[v + 1];
      l[v] = l[v] + fminf(fminf(n[v], k.p2), fminf(sm, sp) + k.p1);
    }
  }
  const float m = warp_min<V>(l, POSITIVE);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    n[v] = l[v] - m;
    if (v < k.nv) {
      if constexpr (INTS)
        sts<OutT>(o + v * (int)sizeof(OutT),
                  __float_as_int((kClamp ? fminf(l[v], k.hi_clamp) : l[v]) + k.store_add));
      else
        sts<OutT>(o + v * (int)sizeof(OutT), (int)store_value<OutT>(l[v], kClamp));
    }
  }
}

// The steps of one chunk in scan order; `first` is 0 when the chunk carries
// on a line, 1 when its first step is the line's first (L = c), 2 when that
// step starts from a seed (any values: a keyed min).
template <int V, typename OutT, int AXIS, bool INTS>
__device__ __forceinline__ void scan_chunk(float (&n)[V], const Consts<V>& k,
                                           const Rows<AXIS, (int)sizeof(OutT)>& rows, int steps,
                                           int dir, int first) {
  Raw<V> next{};
  int t = dir ? steps - 1 : 0;
  const int dt = dir ? -1 : 1;
  load_raw<V>(next, rows.in(t), k.nv);
  int i = 0;
  if (first != 0) {
    const Raw<V> raw = next;
    if (steps > 1) load_raw<V>(next, rows.in(t + dt), k.nv);
    if (first == 1)
      step<V, OutT, INTS, false, INTS>(n, raw, k, rows.out(t));
    else
      step<V, OutT, INTS, true, false>(n, raw, k, rows.out(t));
    t += dt;
    i = 1;
  }
  for (; i < steps; ++i, t += dt) {
    const Raw<V> raw = next;
    if (i + 1 < steps) load_raw<V>(next, rows.in(t + dt), k.nv);
    step<V, OutT, INTS, true, INTS>(n, raw, k, rows.out(t));
  }
}

// A block: kLines warps, a line each. Per chunk c every warp waits for
// chunk c's copies, the block starts chunk c + kRing - 1's copies into the
// slot that chunk c - 1 left, each warp scans its line through chunk c into
// the tile, and the block flushes the tile. (One copy warp beside four scan
// warps, flushing a second tile while they fill the first, measured slower
// at every shape: one warp issues the copies and the ragged flushes of four
// lines too slowly; PERF.md.) The minimum of one block an SM is stated so
// that ptxas gives the widest instances (V = 24-32) the registers they
// need: with the thread count alone it held them to 128 and spilled.
template <int V, typename OutT, int AXIS>
__global__ void __launch_bounds__(32 * kLines, 1) agg_staged_kernel(const AggArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kOut = (int)sizeof(OutT);
  const int dir = blockIdx.y;  // 0: forward, 1: backward
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = a.D, T = a.T;
  const bool ints = a.exact_ints != 0;
  const float shift = ints ? kShift : 0.0f;
  const int S = AXIS == 0 ? a.H : a.W;
  const int line0 = blockIdx.x * kLines;
  const int nl = min(kLines, (AXIS == 0 ? a.W : a.H) - line0);
  // warp-uniform; a warp past the last line still stages, flushes and syncs
  const bool active = warp < nl;
  const int line = line0 + warp;
  const long long row = (long long)a.W * D;
  const int8_t* __restrict__ cost = dir ? a.cost_b : a.cost_f;
  OutT* __restrict__ out = (OutT*)(dir ? a.out_b : a.out_f);
  const float* __restrict__ seed = dir ? a.seed_b : a.seed_f;
  float* __restrict__ fin = dir ? a.final_b : a.final_f;
  const Geometry geo = geometry(AXIS, D, T, kOut);
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned tile = sbase + kRing * geo.in_chunk;  // the output tile
  const int chunks = (S + T - 1) / T;
  const int d0 = lane * V;
  Consts<V> k;
  k.p1 = a.p1;
  k.p2 = a.p2;
  k.store_add = kStoreMagic - shift;
  k.hi_clamp = 127.0f + shift;
  k.lane = lane;
  k.nv = D - d0;
#pragma unroll
  for (int v = 0; v < V; ++v) k.bias[v] = v < k.nv ? 8388608.0f + 128.0f - shift : -kBig;
  Rows<AXIS, kOut> rows;
  rows.in_slot = geo.in_slot;
  rows.out_slot = geo.out_slot;
  rows.D = D;
  // runs are W*D elements apart, so run r's 16-byte phase is the chunk's
  // plus r times the row's
  rows.in_rowm = (int)(row & 15);
  rows.out_rowm = (int)((row * kOut) & 15);

  float n[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    n[v] = seed != nullptr && active && v < k.nv ? seed[(long long)line * D + d0 + v] : kBig;

#pragma unroll
  for (int c = 0; c < kRing - 1; ++c) {
    if (c < chunks)
      stage(sbase + c * geo.in_chunk, cost, chunk_of(AXIS, D, T, row, dir, c, line0, nl, S), row,
            geo.in_slot);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // chunk c has landed; chunk c-1's slot and the tile are free
    const int ahead = c + kRing - 1;
    if (ahead < chunks)
      stage(sbase + (ahead % kRing) * geo.in_chunk, cost,
            chunk_of(AXIS, D, T, row, dir, ahead, line0, nl, S), row, geo.in_slot);
    cp_async_commit();
    const Chunk ck = chunk_of(AXIS, D, T, row, dir, c, line0, nl, S);
    if (active) {
      const unsigned ring = sbase + (c % kRing) * geo.in_chunk;
      rows.in_ph = (int)((uintptr_t)(cost + ck.first) & 15);
      rows.out_ph = (int)((uintptr_t)(out + ck.first) & 15);
      if (AXIS == 0) {
        rows.in0 = ring + warp * D + d0;
        rows.out0 = tile + (warp * D + d0) * kOut;
      } else {
        rows.in0 = ring + warp * geo.in_slot + ((rows.in_ph + warp * rows.in_rowm) & 15) + d0;
        rows.out0 =
            tile + warp * geo.out_slot + ((rows.out_ph + warp * rows.out_rowm) & 15) + d0 * kOut;
      }
      const int first = c > 0 ? 0 : (seed == nullptr ? 1 : 2);
      if (ints)
        scan_chunk<V, OutT, AXIS, true>(n, k, rows, ck.steps, dir, first);
      else
        scan_chunk<V, OutT, AXIS, false>(n, k, rows, ck.steps, dir, first);
    }
    __syncthreads();  // the tile holds the chunk's L
    flush<OutT>(out, tile, ck, row, geo.out_slot);
  }
  if (active && fin != nullptr) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < k.nv) fin[(long long)line * D + d0 + v] = n[v];
  }
}

template <int V, typename OutT>
static int launch_staged(const AggArgs& a, cudaStream_t stream) {
  const Geometry geo = geometry(a.axis, a.D, a.T, sizeof(OutT));
  auto kernel = a.axis == 0 ? agg_staged_kernel<V, OutT, 0> : agg_staged_kernel<V, OutT, 1>;
  if (geo.bytes > 48 * 1024) {  // past 48 KB only as opted-in dynamic shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(((a.axis == 0 ? a.W : a.H) + kLines - 1) / kLines, 2);
  kernel<<<grid, 32 * kLines, geo.bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename OutT>
static int launch(const AggArgs& a, cudaStream_t stream) {
#define SVT_AGG_CASE(VV) \
  case VV:               \
    return launch_staged<VV, OutT>(a, stream);
  switch (lane_values(a.D)) {
    SVT_AGG_CASE(1) SVT_AGG_CASE(2) SVT_AGG_CASE(3) SVT_AGG_CASE(4)
    SVT_AGG_CASE(8) SVT_AGG_CASE(12) SVT_AGG_CASE(16) SVT_AGG_CASE(20)
    SVT_AGG_CASE(24) SVT_AGG_CASE(28) SVT_AGG_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;  // D > 1024
  }
#undef SVT_AGG_CASE
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
  if (D < 1) return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return 0;  // no line, or no step
  AggArgs a;
  a.cost_f = (const int8_t*)cost;
  a.cost_b = (const int8_t*)cost_b;
  a.seed_f = (const float*)seed_f;
  a.seed_b = (const float*)seed_b;
  a.out_f = out_f;
  a.out_b = out_b;
  a.final_f = (float*)final_f;
  a.final_b = (float*)final_b;
  a.H = H;
  a.W = W;
  a.D = D;
  a.axis = axis;
  a.T = chunk_steps(D);
  a.p1 = p1;
  a.p2 = p2;
  a.exact_ints = p1 >= 0.0f && p2 >= 0.0f && p1 < kShift && p2 < kShift && p1 == (float)(int)p1 &&
                 p2 == (float)(int)p2;
  const cudaStream_t st = (cudaStream_t)stream;
  return out_bytes == 1 ? launch<int8_t>(a, st) : launch<int16_t>(a, st);
}

#ifdef SVT_VARIANTS

// ---------------------------------------------------------------------------
// The earlier design, kept as the subject of the script's variants
// ---------------------------------------------------------------------------

#define WARPS_PER_BLOCK 4

// Forms of the recurrence (the variant parameter); kShip is the earlier
// design's shipping kernel.
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
// kInterleave; D <= 128 (kShip on int8 with 4 warps a block: D <= 384);
// wpb: warps per block (4 unless kShip); in_bytes: 1 (int8
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
  if (variant == kShip && wpb == WARPS_PER_BLOCK && in_bytes == 1 && D > 128) {
    // the earlier design's shipping kernel up to D = 384, as it shipped (V
    // values a lane, exact), beside the staged kernel at the full search's
    // shapes
#define SVT_SHIP_CASE(VV)                                                                      \
  case VV:                                                                                     \
    agg_dual_kernel<VV, int8_t><<<(2 * L + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK,              \
                                  32 * WARPS_PER_BLOCK, 0, st>>>(                               \
        (const int8_t*)cost, (const int8_t*)cost, nullptr, nullptr, of, ob, nullptr, nullptr, S, \
        L, D, 0, p1, p2, 1, 0);                                                                \
    return (int)cudaGetLastError();
    switch ((D + 31) / 32) {
      SVT_SHIP_CASE(5) SVT_SHIP_CASE(6) SVT_SHIP_CASE(7) SVT_SHIP_CASE(8)
      SVT_SHIP_CASE(9) SVT_SHIP_CASE(10) SVT_SHIP_CASE(11) SVT_SHIP_CASE(12)
      default:
        return (int)cudaErrorInvalidValue;  // shipping takes D <= 384
    }
#undef SVT_SHIP_CASE
  }
  int err;
#define SVT_VAR_CASE(VV)                                                                  \
  case VV:                                                                                \
    err = launch_variant<VV>(cost, of, ob, S, L, D, p1, p2, variant, wpb, in_bytes, bs, st); \
    break;
  switch ((D + 31) / 32) {
    SVT_VAR_CASE(1) SVT_VAR_CASE(2) SVT_VAR_CASE(3) SVT_VAR_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;  // the other variants take D <= 128
  }
#undef SVT_VAR_CASE
  return err != 0 ? err : (int)cudaGetLastError();
}

#endif  // SVT_VARIANTS
