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
// for the int8 960x1280x32 refine stack: ~31 us at 3.35 TB/s). The
// instructions come close behind: ~10 a plane (two element extractions, the
// sum, its key and min, the competitor's test and min), ~13 us of issue for
// the refine stack on 132 SMs.
//
// Design: pixels, not warps, are the unit of work. A block of 256 threads
// takes P consecutive pixels, whose planes are one contiguous span of each
// volume; it copies the span's 16-byte-aligned superset into shared memory
// with 16-byte cp.async (coalesced at every D, also where D*itemsize is no
// multiple of 16, as at the coarse search's D = 107). G lanes share a
// pixel, G the least power of two that leaves at most 32 planes a lane (1
// up to D = 32, 4 at D = 107, 16 at D = 320, 32 at D = 1024; P = 256 / G).
// A lane reads its Q contiguous planes (Q a multiple of 4, the least >=
// D / G) in 16-byte loads where they are 16-byte aligned (as at D = 32),
// else as words funnel-shifted to their start, and reduces them
// into the packed key and then the competitor; the lanes of a pixel combine
// in log2(G) shuffle rounds, none at G = 1. Masked planes (d >= d_valid)
// take no part in either reduction: none can win (d_valid > 0, and a masked
// key exceeds every real one), and the 2^21 they give cp and the competitor
// follows from idx, d_valid and D. cm and cp are read from shared memory at
// idx -/+ 1. Consecutive threads write consecutive pixels of each map: at
// G > 1 the group leaders' results pass through shared memory first.
//
// Built with -DSVT_VARIANTS, the library also holds svt_wta_stats_variant:
// the ablations of scripts/bench_wta_variants.py (TPU kernel at :149, the
// measurement script of _wta_lanes_kernel) as compile-time variants of the
// earlier design of this kernel (one warp a pixel: lane l holds planes l,
// l + 32, ..., and the four minima are five-round __shfl_xor butterflies)
// on int8 volumes: kBase is that design as it shipped, the others drop or
// change one ingredient (see the enum), and WPB (warps per block) is the
// script's block size. The script's packed output layout is a TPU store
// layout with no counterpart here (the port writes five maps).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

static constexpr int kMasked = 1 << 21;
static constexpr int kNone = 1 << 29;

static constexpr int kThreads = 256;  // a block
static constexpr int kMaxQ = 32;      // planes a lane at most
// shared bytes of a volume beyond its P pixels: the granules' alignment at
// both ends, and the word past a lane's last plane (lanes of the last pixel
// read up to Q * itemsize + 4 bytes past its end)
static constexpr int kSlack = 160;

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy bytes [b0, b1) of a volume of `total` bytes to shared memory at dst as
// their 16-byte-aligned superset: 16 bytes a cp.async where the granule lies
// inside the volume, byte by byte where it straddles one of its ends.
// Returns the offset from dst at which byte b0 lands.
__device__ __forceinline__ int stage(unsigned char* dst, const unsigned char* vol,
                                     long long total, long long b0, long long b1) {
  const uintptr_t base = (uintptr_t)vol, end = base + (uintptr_t)total;
  const uintptr_t lo = (base + (uintptr_t)b0) & ~(uintptr_t)15;
  const uintptr_t hi = (base + (uintptr_t)b1 + 15) & ~(uintptr_t)15;
  const int n = (int)((hi - lo) >> 4);
  const unsigned sdst = (unsigned)__cvta_generic_to_shared(dst);
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const uintptr_t a = lo + 16 * (uintptr_t)c;
    if (a >= base && a + 16 <= end) {
      cp_async16(sdst + 16 * c, (const void*)a);
    } else {
      for (int i = 0; i < 16; ++i)
        if (a + i >= base && a + i < end) dst[16 * c + i] = *(const unsigned char*)(a + i);
    }
  }
  return (int)(base + (uintptr_t)b0 - lo);
}

// The Q elements of T starting at shared byte `at` as aligned words: 16
// bytes a load where the run is 16-byte aligned (`vec`, uniform over the
// block), else the words around them, funnel-shifted to their start.
template <typename T, int Q>
__device__ __forceinline__ void load_run(uint32_t (&w)[Q * sizeof(T) / 4],
                                         const unsigned char* smem, int at, bool vec) {
  if constexpr (Q * sizeof(T) % 16 == 0) {
    if (vec) {
      const uint4* p = (const uint4*)(smem + at);
#pragma unroll
      for (int k = 0; k < Q * (int)sizeof(T) / 16; ++k) {
        const uint4 v = p[k];
        w[4 * k] = v.x;
        w[4 * k + 1] = v.y;
        w[4 * k + 2] = v.z;
        w[4 * k + 3] = v.w;
      }
      return;
    }
  }
  const uint32_t* p = (const uint32_t*)(smem + (at & ~3));
  const int sh = 8 * (at & 3);
  uint32_t prev = p[0];
#pragma unroll
  for (int k = 0; k < Q * (int)sizeof(T) / 4; ++k) {
    const uint32_t next = p[k + 1];
    w[k] = __funnelshift_r(prev, next, sh);
    prev = next;
  }
}

// Element e of a run of aligned words, sign-extended.
template <typename T, int N>
__device__ __forceinline__ int elem(const uint32_t (&w)[N], int e) {
  if constexpr (sizeof(T) == 1)
    return (int)(int8_t)(w[e >> 2] >> (8 * (e & 3)));
  else
    return (int)(int16_t)(w[e >> 1] >> (16 * (e & 1)));
}

template <typename T, int Q>
__global__ void __launch_bounds__(kThreads)
wta_stats_staged(const T* __restrict__ hf, const T* __restrict__ hb, float* __restrict__ best_o,
                 int32_t* __restrict__ idx_o, float* __restrict__ cm_o, float* __restrict__ cp_o,
                 float* __restrict__ comp_o, long long npix, int D, int d_valid, int log2dp,
                 int log2g, int region) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = 1 << log2g, P = kThreads >> log2g;
  const long long pix0 = (long long)blockIdx.x * P;
  const int np = (int)min((long long)P, npix - pix0);
  const int row = D * (int)sizeof(T);  // bytes a pixel
  const long long b0 = pix0 * row, b1 = (pix0 + np) * row;
  const int off_f = stage(smem, (const unsigned char*)hf, npix * row, b0, b1);
  const int off_b = region + stage(smem + region, (const unsigned char*)hb, npix * row, b0, b1);
  cp_async_wait_all();
  __syncthreads();

  // lane j of group g holds planes d0 .. d0 + Q - 1 of pixel pix0 + g; the
  // real ones are those below d_valid (<= D)
  const int g = threadIdx.x >> log2g, j = threadIdx.x & (G - 1);
  const bool live = g < np;
  const int d0 = j * Q;
  const int dp = 1 << log2dp;
  int s[Q];
  int kmin = INT_MAX;
  if (live) {
    constexpr int NW = Q * (int)sizeof(T) / 4;
    uint32_t wf[NW], wb[NW];
    const int at = g * row + d0 * (int)sizeof(T);
    const bool vec = ((off_f | off_b | row | Q * (int)sizeof(T)) & 15) == 0;
    load_run<T, Q>(wf, smem, off_f + at, vec);
    load_run<T, Q>(wb, smem, off_b + at, vec);
    // int8 sums (|s| <= 256) never reach the cap, which is >= 8191 at D <= 1024
    const int cap = (1 << (23 - log2dp)) - 1;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      s[i] = elem<T>(wf, i) + elem<T>(wb, i);
      const int key = (sizeof(T) == 1 ? s[i] : min(s[i], cap)) * dp + d0 + i;
      if (d0 + i < d_valid) kmin = min(kmin, key);
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) kmin = min(kmin, __shfl_xor_sync(FULL_MASK, kmin, o));
  const int best = kmin >> log2dp;  // floor division by the power of two dp
  const int idx = kmin & (dp - 1);
  int comp = kNone;
  if (live) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int d = d0 + i;
      if (d < d_valid && (unsigned)(d - idx + 1) > 2u) comp = min(comp, s[i]);  // |d - idx| > 1
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) comp = min(comp, __shfl_xor_sync(FULL_MASK, comp, o));

  int cm = kNone, cp = kNone;
  if (live && j == 0) {
    // a masked plane beyond idx + 1 competes with its 2^21
    if (d_valid < D && D - 1 > idx + 1) comp = min(comp, kMasked);
    const T* pf = (const T*)(smem + off_f + g * row);
    const T* pb = (const T*)(smem + off_b + g * row);
    if (idx > 0) cm = (int)pf[idx - 1] + (int)pb[idx - 1];
    if (idx + 1 < D) cp = idx + 1 < d_valid ? (int)pf[idx + 1] + (int)pb[idx + 1] : kMasked;
  }
  if (log2g == 0) {
    if (live) {
      const long long p = pix0 + g;
      best_o[p] = (float)best;
      idx_o[p] = idx;
      cm_o[p] = (float)cm;
      cp_o[p] = (float)cp;
      comp_o[p] = (float)comp;
    }
    return;
  }
  // the group leaders' results, then one pixel a thread
  float* st = (float*)(smem + 2 * region);  // [5][P]
  if (live && j == 0) {
    st[g] = (float)best;
    ((int*)st)[P + g] = idx;
    st[2 * P + g] = (float)cm;
    st[3 * P + g] = (float)cp;
    st[4 * P + g] = (float)comp;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < np) {
    const long long p = pix0 + t;
    best_o[p] = st[t];
    idx_o[p] = ((const int*)st)[P + t];
    cm_o[p] = st[2 * P + t];
    cp_o[p] = st[3 * P + t];
    comp_o[p] = st[4 * P + t];
  }
}

template <typename T>
static int launch(const void* hf, const void* hb, void* best, void* idx, void* cm, void* cp,
                  void* comp, int npix, int D, int d_valid, int log2dp, cudaStream_t stream) {
  // G = 2^log2g lanes a pixel: the least that leaves at most kMaxQ planes a lane
  int log2g = 0;
  while (((D + (1 << log2g) - 1) >> log2g) > kMaxQ) ++log2g;
  if (log2g > 5) return (int)cudaErrorInvalidValue;  // D > 1024
  const int q = (((D + (1 << log2g) - 1) >> log2g) + 3) / 4 * 4;
  const int P = kThreads >> log2g;
  const int region = (P * D * (int)sizeof(T) + kSlack + 15) & ~15;
  const size_t smem = 2 * (size_t)region + (log2g ? 20 * (size_t)P : 0);  // <= 36 KB
  const unsigned grid = (unsigned)((npix + P - 1) / P);
#define SVT_WTA_CASE(QQ)                                                                      \
  case QQ:                                                                                    \
    wta_stats_staged<T, QQ><<<grid, kThreads, smem, stream>>>(                                \
        (const T*)hf, (const T*)hb, (float*)best, (int32_t*)idx, (float*)cm, (float*)cp,      \
        (float*)comp, npix, D, d_valid, log2dp, log2g, region);                               \
    break;
  switch (q) {
    SVT_WTA_CASE(4) SVT_WTA_CASE(8) SVT_WTA_CASE(12) SVT_WTA_CASE(16)
    SVT_WTA_CASE(20) SVT_WTA_CASE(24) SVT_WTA_CASE(28) SVT_WTA_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
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

#define WARPS_PER_BLOCK 8

// The earlier design (one warp a pixel), which the measurement variants
// take apart; kBase is that design's kernel as it shipped.
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
