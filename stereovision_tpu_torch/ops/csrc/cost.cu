// Census Hamming cost volume: 2 x (nw, H, W) int32 census -> (H, W, D) int8.
//
// Replaces: stereovision_tpu/ops/sgm_pallas.py:cost_volume_planes
// (_cost_kernel). The TPU kernel's 128-lane padding (PAD_COST lanes), its
// reversed-right census, its second (W, H, D) copy, pack and t_seg suited the
// TPU's lanes and its slow axis-1 scans; here one (H, W, D) volume with
// exactly D planes serves both scan axes.
//
// Semantics: cost[y, x, d] = sum_w popc(cl[w, y, x] ^ cr[w, y, x - min_d - d]);
// n_bits where x - min_d - d < 0 or > W - 1 (the latter only for min_d < 0).
//
// Bound on this card: bytes. The int8 volume write (H*W*D: 295 MB at
// 1280x720, D=320) dwarfs the census reads (7.4 MB): ~90 us at 3.35 TB/s.
// The work is one xor and one popc a word for each output byte, and popc
// issues at 16 a clock an SM (compute capability 9.0): at nw = 1 the popc
// floor is 9.4-10.6 us for the production frame's stacked refine
// (960, 1280, 32; byte bound 14.7 us) and 70-80 us at D=320 (byte bound
// 90 us), at 1.98-1.755 GHz on 132 SMs: below the byte bound at every
// production shape.
//
// What held the first port back: issue, and shared-memory bank conflicts.
// A thread made 4 disparities at a time with a runtime division, a bounds
// branch and a runtime nw loop each (~20 instructions an output byte); its
// reads of the staged right window stepped -4 words between neighbouring
// threads (4-way conflicts); a D that is not a multiple of 4 took a path of
// one division and one 1-byte store an output byte.
//
// Design (cost_staged, the shipping path): a block owns TX columns of one
// row (TX a power of two, 32-256, TX*D <= 48 KB where it can) and stages
// their window of right census (TX + D - 1 columns, zero outside the image)
// in shared memory. A warp's lanes take consecutive pixels; each lane holds
// its left census word(s) in registers and makes runs of 16 consecutive
// disparities in a fully unrolled loop: at each disparity the warp reads 32
// consecutive words of the window (no conflicts), one xor and one popc a
// word, no division or branch inside the run. nw is a template parameter
// (1 and 2: windows up to 65 bits; any other nw runs cost_staged<0>, the
// same kernel with a runtime nw loop). The range of disparities whose
// column lies in the image is taken once a pixel; a run that reaches past
// it puts n_bits into those bytes. The block's runs are spread over TX/32
// warps of pixels times up to 256/TX groups of runs. Each run's 16 bytes go
// into a shared-memory copy of the block's output span, the contiguous
// bytes (y*W + x0)*D ... + TX*D, placed with the output's 16-byte phase:
// whole words as 4-byte stores, the words a run shares with its neighbour
// (D not a multiple of 4) byte by byte. A pad word every 2^sh words
// (sgm_cuda.cost_design picks sh by D) keeps the lanes' stores, D bytes
// apart, and the copy-out's loads on distinct banks for the most part. The
// span is then written out as 16-byte stores, coalesced, with its head and
// tail peeled to bytes: one store path for every D.
//
// What bounds it now: the ablations (bench_cuda.cost_volume_ablations)
// show the copy-out alone at the byte bound and popc not setting the pace;
// a block's phases (the window's loads, the runs, the copy-out) add up
// rather than overlap. Direct 16-byte stores of each run (no span) and
// persistent blocks that prefetch their next tile measured slower.
//
// cost_first is the design this kernel replaced, kept for timing beside it
// (svt_cost_volume_first). Built with -DSVT_VARIANTS, the library also holds
// the ablations (svt_cost_volume_ablation).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 16;       // disparities a lane makes at a time
constexpr int kGuard = 16;     // window words before entry 0: a last run's reach
constexpr int kThreads = 256;

// logical word q of the staged span -> its shared-memory word
__device__ __forceinline__ uint32_t phys(uint32_t q, int sh) { return q + (q >> sh); }

// Byte i of a run's 16 bytes (pk) at logical byte o + i of the staged span,
// for i < n (0 < n <= 16).
__device__ __forceinline__ void put_run(uint32_t* s_w, int sh, uint32_t o, int n,
                                        const uint32_t (&pk)[4]) {
  const uint32_t q0 = o >> 2;
  const int s = o & 3;
  if (n < kRun) {  // a last run (D % 16 != 0; warp-uniform): byte by byte
    uint8_t* b = reinterpret_cast<uint8_t*>(s_w);
    for (int i = 0; i < n; ++i)
      b[4 * phys((o + i) >> 2, sh) + ((o + i) & 3)] = (uint8_t)(pk[i >> 2] >> (8 * (i & 3)));
    return;
  }
  if (s == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s_w[phys(q0 + k, sh)] = pk[k];
    return;
  }
  // words 1-3 whole; word 0's bytes s..3 and word 4's 0..s-1 are shared with
  // the neighbouring runs: stored byte by byte, predicated
  const int s8 = 8 * s;
  s_w[phys(q0 + 1, sh)] = __funnelshift_l(pk[0], pk[1], s8);
  s_w[phys(q0 + 2, sh)] = __funnelshift_l(pk[1], pk[2], s8);
  s_w[phys(q0 + 3, sh)] = __funnelshift_l(pk[2], pk[3], s8);
  uint8_t* first = reinterpret_cast<uint8_t*>(s_w + phys(q0, sh));
  uint8_t* last = reinterpret_cast<uint8_t*>(s_w + phys(q0 + 4, sh));
  const uint32_t w0 = pk[0] << s8, w4 = pk[3] >> (32 - s8);
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (i >= s) first[i] = (uint8_t)(w0 >> (8 * i));
    if (i - 1 < s) last[i - 1] = (uint8_t)(w4 >> (8 * (i - 1)));
  }
}

// Ablations (built with -DSVT_VARIANTS; cost_staged<1, form>): the popc
// replaced by a mask of the xor (kNoPopc: the same loads and stores, a
// defined function), no census read and no run made (kNoRuns: the window
// staged, zero runs put into the span, the span written out), the span not
// written out (kNoCopy), the copy-out alone (kCopyOnly: nothing staged, no
// runs), or each run stored straight to device memory as one 16-byte store,
// no span (kDirect: D % 16 == 0 and a 16-byte aligned volume only).
enum { kShip = 0, kNoPopc = 1, kNoRuns = 2, kNoCopy = 3, kCopyOnly = 4, kDirect = 5 };

template <int NW, int AB = kShip>  // census words a pixel (0: runtime nw); ablation
__global__ void __launch_bounds__(kThreads) cost_staged(
    const int32_t* __restrict__ cl, const int32_t* __restrict__ cr, int8_t* __restrict__ out,
    int H, int W, int D, int nw, int min_d, int n_bits, int tx_log2, int sh) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int TX = 1 << tx_log2;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * TX;
  const int nx = min(TX, W - x0);
  const int nwin = TX + D - 1 + kGuard;  // window words a plane
  const int pitch = (nwin + 3) & ~3;
  const int r0 = x0 - min_d - (D - 1) - kGuard;  // image column of window entry 0
  uint32_t* s_cr = smem;
  uint32_t* s_cl = s_cr + nw * pitch;  // runtime nw: the tile's left census
  uint32_t* s_w = s_cl + (NW ? 0 : nw * TX);  // the staged output span
  for (int w = 0; w < (AB == kCopyOnly ? 0 : nw); ++w) {
    const int32_t* row = cr + ((size_t)w * H + y) * W;
    for (int j = threadIdx.x; j < nwin; j += blockDim.x) {
      const int r = r0 + j;
      s_cr[w * pitch + j] = (r >= 0 && r < W) ? (uint32_t)__ldg(row + r) : 0u;
    }
    if (NW == 0)
      for (int j = threadIdx.x; j < nx; j += blockDim.x)
        s_cl[w * TX + j] = (uint32_t)__ldg(cl + ((size_t)w * H + y) * W + x0 + j);
  }
  int8_t* span = out + ((size_t)y * W + x0) * D;
  const uint32_t a0 = (uint32_t)(reinterpret_cast<uintptr_t>(span) & 15);  // output's phase
  __syncthreads();

  const int xx = threadIdx.x & (TX - 1);
  if (AB != kCopyOnly && xx < nx) {
    const int x = x0 + xx;
    uint32_t cw[NW ? NW : 1];
#pragma unroll
    for (int w = 0; w < NW; ++w) cw[w] = (uint32_t)__ldg(cl + ((size_t)w * H + y) * W + x);
    // disparities whose column x - min_d - d lies in [0, W - 1]
    const int d_lo = max(0, x - min_d - (W - 1)), d_hi = min(D - 1, x - min_d);
    const uint32_t nb4 = (uint32_t)(n_bits & 0xff) * 0x01010101u;
    const int nruns = (D + kRun - 1) / kRun;
    for (int r = threadIdx.x >> tx_log2; r < nruns; r += blockDim.x >> tx_log2) {
      const int d0 = r * kRun;
      const uint32_t* wp = s_cr + xx + (D - 1) - d0 + kGuard;  // d0 + t reads wp[-t]
      uint32_t pk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * k + i;
          uint32_t c = 0;
          if (AB == kNoRuns) {
          } else if (AB == kNoPopc) {
            c = (cw[0] ^ wp[-t]) & 0x3fu;
          } else if (NW) {
#pragma unroll
            for (int w = 0; w < NW; ++w) c += __popc(cw[w] ^ wp[w * pitch - t]);
          } else {
            for (int w = 0; w < nw; ++w) c += __popc(s_cl[w * TX + xx] ^ wp[w * pitch - t]);
            c &= 0xffu;
          }
          v[i] = c;
        }
        pk[k] = v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24);
      }
      if (d0 < d_lo || d0 + kRun - 1 > d_hi) {  // the run reaches past the image
#pragma unroll
        for (int t = 0; t < kRun; ++t) {
          const int d = d0 + t;
          const uint32_t m = 0xffu << (8 * (t & 3));
          if (d < d_lo || d > d_hi) pk[t >> 2] = (pk[t >> 2] & ~m) | (nb4 & m);
        }
      }
      if (AB == kDirect)
        *reinterpret_cast<uint4*>(span + xx * D + d0) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      else
        put_run(s_w, sh, a0 + (uint32_t)(xx * D + d0), min(kRun, D - d0), pk);
    }
  }
  if (AB == kDirect) return;
  __syncthreads();
  if (AB == kNoCopy) return;

  // the span, from the 16-byte boundary at or before it, in 16-byte stores
  int8_t* base = span - a0;
  const uint32_t total = a0 + (uint32_t)(nx * D);
  const int nch = (int)((total + 15) >> 4);
  for (int c = threadIdx.x; c < nch; c += blockDim.x) {
    const uint32_t p = phys(4 * c, sh);  // 4 words of a chunk share a pad span
    const uint4 v = make_uint4(s_w[p], s_w[p + 1], s_w[p + 2], s_w[p + 3]);
    const uint32_t lo = 16u * c;
    if (lo >= a0 && lo + 16 <= total) {
      *reinterpret_cast<uint4*>(base + lo) = v;
    } else {  // the span's head or tail
      for (uint32_t i = max(lo, a0); i < min(lo + 16, total); ++i) {
        const uint32_t k = (i - lo) >> 2;
        const uint32_t word = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
        base[i] = (int8_t)(word >> (8 * ((i - lo) & 3)));
      }
    }
  }
}

// The first port: a thread makes 4 disparities at a time (D % 4 == 0) or one
// (else), with a division and a bounds branch each.
constexpr int kFirstTX = 64;

__device__ __forceinline__ int cost_at(const int32_t* s_cl, const int32_t* s_cr, int nr,
                                       int nw, int xx, int d, int x0, int W, int D,
                                       int min_d, int n_bits) {
  const int r = x0 + xx - min_d - d;
  if (r < 0 || r > W - 1) return n_bits;
  const int j = xx + (D - 1) - d;  // column of r in the staged window
  int acc = 0;
  for (int w = 0; w < nw; ++w) acc += __popc(s_cl[w * kFirstTX + xx] ^ s_cr[w * nr + j]);
  return acc;
}

__global__ void cost_first(const int32_t* __restrict__ cl, const int32_t* __restrict__ cr,
                           int8_t* __restrict__ out, int H, int W, int D, int nw, int min_d,
                           int n_bits) {
  extern __shared__ int32_t smem_first[];
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kFirstTX;
  const int nx = min(kFirstTX, W - x0);
  const int nr = kFirstTX + D - 1;
  const int r0 = x0 - min_d - (D - 1);
  int32_t* s_cl = smem_first;
  int32_t* s_cr = smem_first + nw * kFirstTX;
  for (int i = threadIdx.x; i < nw * nx; i += blockDim.x) {
    const int w = i / nx, xx = i - w * nx;
    s_cl[w * kFirstTX + xx] = cl[((size_t)w * H + y) * W + x0 + xx];
  }
  const int nwin = nx + D - 1;
  for (int i = threadIdx.x; i < nw * nwin; i += blockDim.x) {
    const int w = i / nwin, j = i - w * nwin;
    const int r = r0 + j;
    s_cr[w * nr + j] = (r >= 0 && r < W) ? cr[((size_t)w * H + y) * W + r] : 0;
  }
  __syncthreads();
  int8_t* base = out + ((size_t)y * W + x0) * D;
  const int total = nx * D;
  if ((D & 3) == 0) {
    uint32_t* base4 = reinterpret_cast<uint32_t*>(base);
    for (int q = threadIdx.x; q < total / 4; q += blockDim.x) {
      const int i = q * 4;
      const int xx = i / D, d = i - xx * D;
      uint32_t packed = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int v = cost_at(s_cl, s_cr, nr, nw, xx, d + k, x0, W, D, min_d, n_bits);
        packed |= (uint32_t)(v & 0xff) << (8 * k);
      }
      base4[q] = packed;
    }
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int xx = i / D, d = i - xx * D;
      base[i] = (int8_t)cost_at(s_cl, s_cr, nr, nw, xx, d, x0, W, D, min_d, n_bits);
    }
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// One launch of cost_staged<NW, AB> with svt_cost_volume's arguments.
template <int NW, int AB>
int launch_cost(const void* cl, const void* cr, void* out, int H, int W, int D, int nw,
                int min_d, int n_bits, int tx_log2, int sh, cudaStream_t st) {
  const int TX = 1 << tx_log2;
  const int threads = TX * max(1, min(kThreads / TX, (D + kRun - 1) / kRun));
  const size_t span_words = ((size_t)15 + (size_t)TX * D + 3) / 4 + 4;
  const size_t smem = 4 * ((size_t)nw * ((TX + D - 1 + kGuard + 3) & ~3) +
                           (NW ? 0 : (size_t)nw * TX) + span_words + (span_words >> sh) + 4);
  const int e = set_smem((const void*)cost_staged<NW, AB>, smem);
  if (e) return e;
  const dim3 grid((W + TX - 1) / TX, H);
  cost_staged<NW, AB><<<grid, threads, smem, st>>>((const int32_t*)cl, (const int32_t*)cr,
                                                   (int8_t*)out, H, W, D, nw, min_d, n_bits,
                                                   tx_log2, sh);
  return (int)cudaGetLastError();
}

}  // namespace

// form: the instance sgm_cuda.cost_design picks (1 or 2 census words a
// pixel, 0 any nw); tx_log2: log2 of the tile's columns; sh: a pad word
// every 2^sh words of the staged span (2 <= sh).
extern "C" int svt_cost_volume(const void* cl, const void* cr, void* out, int H, int W, int D,
                               int nw, int min_d, int n_bits, int form, int tx_log2, int sh,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (form == 1) return launch_cost<1, kShip>(cl, cr, out, H, W, D, 1, min_d, n_bits, tx_log2, sh, st);
  if (form == 2) return launch_cost<2, kShip>(cl, cr, out, H, W, D, 2, min_d, n_bits, tx_log2, sh, st);
  return launch_cost<0, kShip>(cl, cr, out, H, W, D, nw, min_d, n_bits, tx_log2, sh, st);
}

#ifdef SVT_VARIANTS
// An ablation of cost_staged at nw = 1 (the forms above); the arguments are
// svt_cost_volume's.
extern "C" int svt_cost_volume_ablation(const void* cl, const void* cr, void* out, int H, int W,
                                        int D, int min_d, int n_bits, int ablation, int tx_log2,
                                        int sh, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (ablation) {
    case kNoPopc: return launch_cost<1, kNoPopc>(cl, cr, out, H, W, D, 1, min_d, n_bits, tx_log2, sh, st);
    case kNoRuns: return launch_cost<1, kNoRuns>(cl, cr, out, H, W, D, 1, min_d, n_bits, tx_log2, sh, st);
    case kNoCopy: return launch_cost<1, kNoCopy>(cl, cr, out, H, W, D, 1, min_d, n_bits, tx_log2, sh, st);
    case kCopyOnly: return launch_cost<1, kCopyOnly>(cl, cr, out, H, W, D, 1, min_d, n_bits, tx_log2, sh, st);
    case kDirect:
      if (D % 16 || reinterpret_cast<uintptr_t>(out) % 16) return (int)cudaErrorInvalidValue;
      return launch_cost<1, kDirect>(cl, cr, out, H, W, D, 1, min_d, n_bits, tx_log2, sh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // SVT_VARIANTS

extern "C" int svt_cost_volume_first(const void* cl, const void* cr, void* out, int H, int W,
                                     int D, int nw, int min_d, int n_bits, void* stream) {
  const size_t smem = (size_t)nw * (kFirstTX + kFirstTX + D - 1) * sizeof(int32_t);
  const int e = set_smem((const void*)cost_first, smem);
  if (e) return e;
  const dim3 grid((W + kFirstTX - 1) / kFirstTX, H);
  cost_first<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const int32_t*)cl, (const int32_t*)cr, (int8_t*)out, H, W, D, nw, min_d, n_bits);
  return (int)cudaGetLastError();
}
