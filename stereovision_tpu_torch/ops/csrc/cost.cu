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
// Design (cost_staged): a block owns TX columns of one
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
// What bounds it: the copy-out alone runs at the byte bound and popc does
// not set the pace; a block's phases (the window's loads, the runs, the
// copy-out) add up rather than overlap. Direct 16-byte stores of each run
// (no span) and persistent blocks that prefetch their next tile measured
// slower.

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

template <int NW>  // census words a pixel (0: runtime nw)
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
  for (int w = 0; w < nw; ++w) {
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
  if (xx < nx) {
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
          if (NW) {
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
      put_run(s_w, sh, a0 + (uint32_t)(xx * D + d0), min(kRun, D - d0), pk);
    }
  }
  __syncthreads();

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

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// One launch of cost_staged<NW> with svt_cost_volume's arguments.
template <int NW>
int launch_cost(const void* cl, const void* cr, void* out, int H, int W, int D, int nw,
                int min_d, int n_bits, int tx_log2, int sh, cudaStream_t st) {
  const int TX = 1 << tx_log2;
  const int threads = TX * max(1, min(kThreads / TX, (D + kRun - 1) / kRun));
  const size_t span_words = ((size_t)15 + (size_t)TX * D + 3) / 4 + 4;
  const size_t smem = 4 * ((size_t)nw * ((TX + D - 1 + kGuard + 3) & ~3) +
                           (NW ? 0 : (size_t)nw * TX) + span_words + (span_words >> sh) + 4);
  const int e = set_smem((const void*)cost_staged<NW>, smem);
  if (e) return e;
  const dim3 grid((W + TX - 1) / TX, H);
  cost_staged<NW><<<grid, threads, smem, st>>>((const int32_t*)cl, (const int32_t*)cr,
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
  if (form == 1) return launch_cost<1>(cl, cr, out, H, W, D, 1, min_d, n_bits, tx_log2, sh, st);
  if (form == 2) return launch_cost<2>(cl, cr, out, H, W, D, 2, min_d, n_bits, tx_log2, sh, st);
  return launch_cost<0>(cl, cr, out, H, W, D, nw, min_d, n_bits, tx_log2, sh, st);
}
