// Sum of the four path-cost volumes of a full search and the winner
// statistics of the sum, in one read of each volume: for each pixel of the
// int8 or int16 (H, W, D) volumes hf, hb, vf, vb, with
// s[d] = hf[d] + hb[d] + vf[d] + vb[d] and s[d] = 2^21 for d >= d_valid,
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
// script's. No real plane reaches it (|s| <= 4 * 32768 < 2^20 <= the cap at
// D <= 1024), and no masked plane can win (d_valid > 0, and 2^21 exceeds
// every real sum), so the kernel leaves masked planes out of the key and
// needs no cap; the 2^21 they give cp and the competitor follows from idx,
// d_valid and D.
//
// Bound on this card: bytes, 4*H*W*D*itemsize read + 2*H*W*D written (hwd,
// dhw) + 20*H*W: 1787.8 MB at 720x1280, D=320 int8 hwd (0.5337 ms at
// 3.35 TB/s), 1198.0 MB with no volume (0.3576 ms); int16 volumes double
// the bytes read. The instructions come close behind at int8: ~15 a plane
// (four element extractions and two three-input adds, the key and its min,
// the competitor's test and min, the int16 store), ~0.2 ms of issue at
// D=320 on 132 SMs, and a block's staging and its arithmetic add up rather
// than overlap; a persistent, double-buffered form of this kernel, which
// prefetches its next pixels while it computes, measured no faster on an
// H100. Fewer instructions did help: the extraction is one prmt (or shift)
// an element and the sum one expression a plane (two three-input adds),
// which took the int8 kernel at D=320 on an H100 (700 W) from 0.5512 to
// 0.4699 ms with no volume and from 0.6312 to 0.5847 with hwd.
//
// Design (staged pixels, the design of wta_stats.cu widened to four
// volumes): a block of 256 threads takes P consecutive pixels, whose planes
// are one contiguous span of each volume; it copies each span's
// 16-byte-aligned superset into shared memory with 16-byte cp.async
// (coalesced at every D, also where D*itemsize is no multiple of 16). G
// lanes share a pixel, G the least power of two that leaves at most 32
// planes a lane (1 up to D = 32, 4 at D = 107, 16 at D = 320, 32 at
// D = 1024; P = 256 / G; sgm_cuda.sum_wta_design picks G and Q). A lane
// reads its Q contiguous planes (Q a multiple of 4, the least >= D / G) of
// each volume in 16-byte loads where they are 16-byte aligned, else as
// words funnel-shifted to their start, and sums them; the lanes of a pixel
// combine the key and then the competitor in log2(G) shuffle rounds. cm
// and cp are read from shared memory at idx -/+ 1. The int16 sum leaves
// through shared memory: for hwd a copy of the block's contiguous output
// span placed at the span's 16-byte phase (each lane's Q values as word
// stores where its run is word-aligned, else halves), written out in
// 16-byte stores with its head and tail peeled, as cost.cu's span; for dhw
// a (D, P + 2) transpose, P consecutive int16s a plane written out
// together. Consecutive threads write consecutive pixels of each map: at
// G > 1 the group leaders' results pass through shared memory first.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

static constexpr int kMasked = 1 << 21;
static constexpr int kNone = 1 << 29;
static constexpr int kClamp = 30000;

static constexpr int kThreads = 256;  // a block
// shared bytes of a volume beyond its P pixels: the granules' alignment at
// both ends, and the run and word a lane of the last pixel reads past its end
static constexpr int kSlack = 128;
static constexpr int kMaxShared = 96 * 1024;  // above the largest layout (~87 KB)

enum : int { kEmitNone = 0, kEmitHWD = 1, kEmitDHW = 2 };

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

// x permuted by prmt's selector SEL against zero: a selector nibble with its
// top bit set fills its byte with the sign of the byte it names.
template <int SEL>
__device__ __forceinline__ int prmt_sign(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(x), "n"(SEL));
  return (int)r;
}

// Element e of a run of aligned words, sign-extended by one prmt or shift
// (the casts (int)(int8_t) issue more: see the note at the top).
template <typename T, int N>
__device__ __forceinline__ int elem(const uint32_t (&w)[N], int e) {
  if constexpr (sizeof(T) == 1) {
    const uint32_t x = w[e >> 2];
    switch (e & 3) {
      case 0: return prmt_sign<0x8880>(x);
      case 1: return prmt_sign<0x9991>(x);
      case 2: return prmt_sign<0xAAA2>(x);
      default: return (int)x >> 24;
    }
  } else {
    const uint32_t x = w[e >> 1];
    return (e & 1) ? (int)x >> 16 : prmt_sign<0x9910>(x);
  }
}

// Where a block's parts lie in its dynamic shared memory (bytes): the four
// staged spans `region` apart, the staged int16 output, the leaders' stats.
struct Layout {
  int region, out, stats, bytes;
};

__host__ __device__ __forceinline__ Layout layout(int D, int itemsize, int log2g, int emit) {
  const int P = kThreads >> log2g;
  Layout L;
  L.region = (P * D * itemsize + kSlack + 15) & ~15;
  L.out = 4 * L.region;
  const int out = emit == kEmitHWD   ? (P * D * 2 + 32 + 15) & ~15
                  : emit == kEmitDHW ? (D * (P + 2) * 2 + 15) & ~15
                                     : 0;
  L.stats = L.out + out;
  L.bytes = L.stats + (log2g ? 20 * P : 0);
  return L;
}

template <typename T>
__device__ __forceinline__ int out_value(int s, bool real) {
  // int8 sums (|s| <= 512) never reach the clamp
  return real ? (sizeof(T) == 1 ? s : min(s, kClamp)) : kClamp;
}

template <typename T, int Q, int EMIT>
__global__ void __launch_bounds__(kThreads)
sum_wta_staged(const T* __restrict__ hf, const T* __restrict__ hb, const T* __restrict__ vf,
               const T* __restrict__ vb, int16_t* __restrict__ s_o, float* __restrict__ best_o,
               int32_t* __restrict__ idx_o, float* __restrict__ cm_o, float* __restrict__ cp_o,
               float* __restrict__ comp_o, long long npix, int D, int d_valid, int log2dp,
               int log2g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(D, (int)sizeof(T), log2g, EMIT);
  const int G = 1 << log2g, P = kThreads >> log2g;
  const long long pix0 = (long long)blockIdx.x * P;
  const int np = (int)min((long long)P, npix - pix0);
  const int row = D * (int)sizeof(T);  // bytes a pixel
  const long long total = npix * row, b0 = pix0 * row, b1 = (pix0 + np) * row;
  const T* vols[4] = {hf, hb, vf, vb};
  int off[4];
#pragma unroll
  for (int v = 0; v < 4; ++v)
    off[v] = v * L.region + stage(smem + v * L.region, (const unsigned char*)vols[v], total, b0, b1);
  cp_async_wait_all();
  __syncthreads();

  // lane j of group g holds planes d0 .. d0 + Q - 1 of pixel pix0 + g; the
  // real ones are those below d_valid (<= D), the stored ones those below D
  const int g = threadIdx.x >> log2g, j = threadIdx.x & (G - 1);
  const int d0 = j * Q;
  const bool live = g < np && d0 < D;
  const int lim = d_valid - d0, n = min(Q, D - d0);
  const int dp = 1 << log2dp;
  int16_t* span = s_o + pix0 * D;  // the block's hwd output
  const int ph = (int)((uintptr_t)span & 15);
  int s[Q];
  int kmin = INT_MAX;
  if (live) {
    constexpr int NW = Q * (int)sizeof(T) / 4;
    const int at = g * row + d0 * (int)sizeof(T);
    const bool vec = ((off[0] | off[1] | off[2] | off[3] | row) & 15) == 0;
    // the four runs first, then one sum a plane (two three-input adds)
    uint32_t w0[NW], w1[NW], w2[NW], w3[NW];
    load_run<T, Q>(w0, smem, off[0] + at, vec);
    load_run<T, Q>(w1, smem, off[1] + at, vec);
    load_run<T, Q>(w2, smem, off[2] + at, vec);
    load_run<T, Q>(w3, smem, off[3] + at, vec);
#pragma unroll
    for (int i = 0; i < Q; ++i)
      s[i] = elem<T>(w0, i) + elem<T>(w1, i) + elem<T>(w2, i) + elem<T>(w3, i);
    int kl = INT_MAX;
#pragma unroll
    for (int i = 0; i < Q; ++i)
      if (i < lim) kl = min(kl, s[i] * dp + i);
    if (lim > 0) kmin = kl + d0;
    if constexpr (EMIT == kEmitHWD) {
      // this lane's run of the staged span, at the span's 16-byte phase
      const int at16 = L.out + ph + 2 * (g * D + d0);
      unsigned char* o = smem + at16;
      if (n == Q && (at16 & 3) == 0) {
#pragma unroll
        for (int k = 0; k < Q / 2; ++k)
          ((uint32_t*)o)[k] = (uint32_t)(uint16_t)out_value<T>(s[2 * k], 2 * k < lim) |
                              (uint32_t)out_value<T>(s[2 * k + 1], 2 * k + 1 < lim) << 16;
      } else if (n == Q) {  // a run two bytes off a word: a half, words, a half
        ((int16_t*)o)[0] = (int16_t)out_value<T>(s[0], 0 < lim);
#pragma unroll
        for (int k = 0; k < Q / 2 - 1; ++k)
          ((uint32_t*)(o + 2))[k] =
              (uint32_t)(uint16_t)out_value<T>(s[2 * k + 1], 2 * k + 1 < lim) |
              (uint32_t)out_value<T>(s[2 * k + 2], 2 * k + 2 < lim) << 16;
        ((int16_t*)o)[Q - 1] = (int16_t)out_value<T>(s[Q - 1], Q - 1 < lim);
      } else {  // the pixel's last lane: planes past D belong to the next pixel
#pragma unroll
        for (int i = 0; i < Q; ++i)
          if (i < n) ((int16_t*)o)[i] = (int16_t)out_value<T>(s[i], i < lim);
      }
    }
    if constexpr (EMIT == kEmitDHW) {
      int16_t* t = (int16_t*)(smem + L.out) + g;
#pragma unroll
      for (int i = 0; i < Q; ++i)
        if (i < n) t[(d0 + i) * (P + 2)] = (int16_t)out_value<T>(s[i], i < lim);
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) kmin = min(kmin, __shfl_xor_sync(FULL_MASK, kmin, o));
  const int best = kmin >> log2dp;  // floor division by the power of two dp
  const int idx = kmin & (dp - 1);
  int comp = kNone;
  if (live) {
    const int t = d0 - idx + 1;  // plane i lies outside idx - 1 .. idx + 1 where t + i is not in [0, 2]
#pragma unroll
    for (int i = 0; i < Q; ++i)
      if (i < lim && (unsigned)(t + i) > 2u) comp = min(comp, s[i]);
  }
  for (int o = G >> 1; o > 0; o >>= 1) comp = min(comp, __shfl_xor_sync(FULL_MASK, comp, o));

  int cm = kNone, cp = kNone;
  if (g < np && j == 0) {
    // a masked plane beyond idx + 1 competes with its 2^21
    if (d_valid < D && D - 1 > idx + 1) comp = min(comp, kMasked);
    const int at = g * row;
    auto sum_at = [&](int d) {
      int v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) v += (int)((const T*)(smem + off[k] + at))[d];
      return v;
    };
    if (idx > 0) cm = sum_at(idx - 1);
    if (idx + 1 < D) cp = idx + 1 < d_valid ? sum_at(idx + 1) : kMasked;
  }
  float* st = (float*)(smem + L.stats);  // [5][P]
  if (log2g == 0) {
    if (g < np) {
      const long long p = pix0 + g;
      best_o[p] = (float)best;
      idx_o[p] = idx;
      cm_o[p] = (float)cm;
      cp_o[p] = (float)cp;
      comp_o[p] = (float)comp;
    }
    if constexpr (EMIT == kEmitNone) return;
  } else if (g < np && j == 0) {
    st[g] = (float)best;
    ((int*)st)[P + g] = idx;
    st[2 * P + g] = (float)cm;
    st[3 * P + g] = (float)cp;
    st[4 * P + g] = (float)comp;
  }
  __syncthreads();
  const int tid = threadIdx.x;
  if (log2g && tid < np) {
    const long long p = pix0 + tid;
    best_o[p] = st[tid];
    idx_o[p] = ((const int*)st)[P + tid];
    cm_o[p] = st[2 * P + tid];
    cp_o[p] = st[3 * P + tid];
    comp_o[p] = st[4 * P + tid];
  }
  if constexpr (EMIT == kEmitHWD) {
    // the span, from the 16-byte boundary at or before it, in 16-byte stores
    unsigned char* base = (unsigned char*)span - ph;
    const unsigned char* so = smem + L.out;
    const int end = ph + 2 * np * D;
    for (int c = tid; c < (end + 15) >> 4; c += kThreads) {
      const int lo = 16 * c;
      const uint4 v = *(const uint4*)(so + lo);
      if (lo >= ph && lo + 16 <= end) {
        *(uint4*)(base + lo) = v;
      } else {  // the span's head or tail
        for (int i = max(lo, ph); i < min(lo + 16, end); i += 2)
          *(int16_t*)(base + i) = *(const int16_t*)(so + i);
      }
    }
  }
  if constexpr (EMIT == kEmitDHW) {
    const int16_t* t = (const int16_t*)(smem + L.out);
    const int log2p = 8 - log2g;
    for (int e = tid; e < D * P; e += kThreads) {
      const int d = e >> log2p, p = e & (P - 1);
      if (p < np) s_o[(long long)d * npix + pix0 + p] = t[d * (P + 2) + p];
    }
  }
}

// Raise a kernel's dynamic shared-memory limit, once per instance (the first
// launch; the runtime keeps the setting).
template <typename T, int Q, int EMIT>
static cudaError_t shared_limit_once() {
  static const cudaError_t err =
      cudaFuncSetAttribute(sum_wta_staged<T, Q, EMIT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
  return err;
}

struct Args {
  const void *hf, *hb, *vf, *vb;
  void *s, *best, *idx, *cm, *cp, *comp;
  long long npix;
  int D, d_valid, log2dp, log2g;
};

template <typename T, int Q, int EMIT>
static int launch_q(const Args& a, cudaStream_t stream) {
  const cudaError_t e = shared_limit_once<T, Q, EMIT>();
  if (e != cudaSuccess) return (int)e;
  const int P = kThreads >> a.log2g;
  const Layout L = layout(a.D, (int)sizeof(T), a.log2g, EMIT);
  const unsigned grid = (unsigned)((a.npix + P - 1) / P);
  sum_wta_staged<T, Q, EMIT><<<grid, kThreads, L.bytes, stream>>>(
      (const T*)a.hf, (const T*)a.hb, (const T*)a.vf, (const T*)a.vb, (int16_t*)a.s,
      (float*)a.best, (int32_t*)a.idx, (float*)a.cm, (float*)a.cp, (float*)a.comp, a.npix, a.D,
      a.d_valid, a.log2dp, a.log2g);
  return (int)cudaGetLastError();
}

template <typename T, int EMIT>
static int launch(const Args& a, int q, cudaStream_t stream) {
  switch (q) {
    case 4: return launch_q<T, 4, EMIT>(a, stream);
    case 8: return launch_q<T, 8, EMIT>(a, stream);
    case 12: return launch_q<T, 12, EMIT>(a, stream);
    case 16: return launch_q<T, 16, EMIT>(a, stream);
    case 20: return launch_q<T, 20, EMIT>(a, stream);
    case 24: return launch_q<T, 24, EMIT>(a, stream);
    case 28: return launch_q<T, 28, EMIT>(a, stream);
    case 32: return launch_q<T, 32, EMIT>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

static int log2_ceil(int D) {
  int log2dp = 0;
  while ((1 << log2dp) < D) ++log2dp;
  return log2dp;
}

// The design's lanes a pixel (2^log2g <= 32) and planes a lane (q) must
// cover D.
static bool covers(int D, int log2g, int q) { return log2g >= 0 && log2g <= 5 && (q << log2g) >= D; }

// emit: 0 none (s null), 1 (H, W, D) int16, 2 (D, H, W) int16; itemsize: 1
// (int8 volumes) or 2 (int16); log2g and q: the design
// (sgm_cuda.sum_wta_design): 2^log2g lanes a pixel, q planes a lane.
extern "C" int svt_sum_wta(const void* hf, const void* hb, const void* vf, const void* vb, void* s,
                           void* best, void* idx, void* cm, void* cp, void* comp, long long npix,
                           int D, int d_valid, int emit, int itemsize, int log2g, int q,
                           void* stream) {
  if (!covers(D, log2g, q)) return (int)cudaErrorInvalidValue;
  const Args a{hf, hb, vf, vb, s, best, idx, cm, cp, comp, npix, D, d_valid, log2_ceil(D), log2g};
  const cudaStream_t st = (cudaStream_t)stream;
#define SVT_SUM_EMIT(T)                                                       \
  switch (emit) {                                                             \
    case kEmitNone: return launch<T, kEmitNone>(a, q, st);                    \
    case kEmitHWD: return launch<T, kEmitHWD>(a, q, st);                      \
    case kEmitDHW: return launch<T, kEmitDHW>(a, q, st);                      \
    default: return (int)cudaErrorInvalidValue;                               \
  }
  if (itemsize == 1) SVT_SUM_EMIT(int8_t)
  if (itemsize == 2) SVT_SUM_EMIT(int16_t)
#undef SVT_SUM_EMIT
  return (int)cudaErrorInvalidValue;
}
