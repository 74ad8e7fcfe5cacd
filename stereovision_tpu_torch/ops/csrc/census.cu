// Census transform: (H, W) float32 image -> (nw, H, W) int32 census words.
//
// Replaces: stereovision_tpu/ops/sgm_pallas.py:census_words (_census_kernel),
// without its mirror mode: the GPU cost kernel reads the right census at any
// column, so the flipped form that suited the TPU's lanes is not needed.
//
// Semantics (core/image.py:census_transform): the window is ksize wide and
// wsize high; one bit per neighbour, dy-major then dx, skipping the centre;
// the bit is set where neighbour < centre (strict); the border replicates
// (clamped coordinates).
//
// Bound on this card: bytes. The function reads 4 B and writes 4*nw B per
// pixel (7.4 MB at 1280x720 with one word: ~2.2 us at 3.35 TB/s); its
// compares, ~25 a pixel at 5x5, are below that.
//
// Design (census_staged): a block of 4 warps owns 4 rows
// of 128 pixels. It stages the rows and columns its windows reach, with the
// border replicated once here (clamped addresses), as float32 in shared
// memory by 4-byte cp.async copies (all of a thread's loads in flight at
// once, no registers held; a prefetch of further tiles in a persistent
// block measured slower). Each lane then makes 4 horizontally adjacent
// pixels: per window row it reads the staged values they share into
// registers with 16-byte shared loads (the lanes' loads are consecutive, no
// bank conflicts) and makes every compare with a constant bit position:
// (ksize, wsize) are template parameters for 3x3, 5x5, 7x5, 7x7 and 9x7, and
// the 4 alignments of a row's first column are a warp-uniform switch. Other
// sizes run the same staged kernel with runtime loops (census_staged_any).
// A lane's 4 pixels start on a multiple of 4 of the flat index y*W + x (the
// row's groups shift with y*W mod 4, so a W that is not a multiple of 4
// keeps its stores aligned); each word plane is written once, as one 16-byte
// store, where the 4 pixels lie in the image and the plane's offset keeps
// that alignment, else as single words (a row's ends).
//
// What bounds it: a bit costs two instructions of the ALU pipe (a compare
// and a predicated add), ~3 us of issue (reckoned) at 1280x720, 5x5, above
// the byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;              // warps a block, a row each
constexpr int kTileX = 128;           // pixels a row of the tile: 4 a lane
constexpr int kThreads = 32 * kRows;

// staged columns a row: the tile, 4 columns for the row's shift and the
// 16-byte loads' reach past the window
__host__ __device__ constexpr int staged_width(int k) { return kTileX + 4 * (2 + (k + 6) / 4); }

// One word plane's values of a lane's 4 pixels (flat index f of pixel 0, a
// multiple of 4) into out: one 16-byte store where they all lie in the row
// and the address is 16-byte aligned (a plane of H*W words, H*W not a
// multiple of 4, shifts it), else single words.
__device__ __forceinline__ void store4(int32_t* __restrict__ out, size_t f, int xs, int W,
                                       const uint32_t (&v)[4]) {
  if (xs >= 0 && xs + 3 < W && (reinterpret_cast<uintptr_t>(out + f) & 15) == 0) {
    *reinterpret_cast<int4*>(out + f) = make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
    return;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
    if (xs + p >= 0 && xs + p < W) out[f + p] = (int32_t)v[p];
}

// Rows y_org .. y_org + rows - 1 and columns x_org .. x_org + sw - 1 of
// the image, clamped, into s (pitch sw), as 4-byte cp.async copies (the
// loads all in flight at once, no registers held).
__device__ __forceinline__ void stage_async(const float* __restrict__ img, float* s, int H, int W,
                                            int y_org, int x_org, int rows, int sw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kRows) {
    const float* row = img + (size_t)min(max(y_org + r, 0), H - 1) * W;
    for (int c = lane; c < sw; c += 32) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(s + r * sw + c);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(row + min(max(x_org + c, 0), W - 1)));
    }
  }
}

// The block's tile (4 rows of 128 pixels: blockIdx.y, blockIdx.x) staged
// into s, then body(y, xs, chunk, a) makes a lane's 4 pixels of row y: a =
// (y * W) mod 4 places them at xs = 4 * group - a, so that the flat index of
// pixel 0 is a multiple of 4; their first window column is staged column
// 4 * lane + 4 - a = 4 * chunk + ((4 - a) & 3).
template <class Body>
__device__ __forceinline__ void census_tile(const float* __restrict__ img, float* s, int H, int W,
                                            int px, int py, int sw, int sr, Body body) {
  stage_async(img, s, H, W, blockIdx.y * kRows - py, blockIdx.x * kTileX - px - 4, sr, sw);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.y * kRows + (threadIdx.x >> 5);
  const int a = (int)(((unsigned)y * (unsigned)W) & 3u);
  const int xs = 4 * (blockIdx.x * 32 + lane) - a;
  if (y < H && xs < W) body(y, xs, lane + (a == 0), a);
}

// One lane's 4 pixels at window size (K, WS) and shift S: the pixels' first
// window column is 4 * chunk + S of the staged row.
template <int K, int WS, int S>
__device__ __forceinline__ void census_body(const float* s, int32_t* __restrict__ out, int H,
                                            int W, int y, int xs, int chunk) {
  constexpr int PX = K / 2, PY = WS / 2, NB = K * WS - 1, NW = (NB + 31) / 32;
  constexpr int SW = staged_width(K), NCH = (S + K + 3 + 3) / 4;
  const int warp = threadIdx.x >> 5;
  float c[4];
  {
    const float4* rp = reinterpret_cast<const float4*>(s + (warp + PY) * SW) + chunk;
    float v[4 * NCH];
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const float4 t = rp[i];
      v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) c[p] = v[S + p + PX];
  }
  uint32_t words[NW][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int p = 0; p < 4; ++p) words[w][p] = 0;
#pragma unroll
  for (int dy = 0; dy < WS; ++dy) {
    const float4* rp = reinterpret_cast<const float4*>(s + (warp + dy) * SW) + chunk;
    float v[4 * NCH];
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const float4 t = rp[i];
      v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
    }
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      if (dy == PY && dx == PX) continue;
      const int n = dy * K + dx;
      const int b = n - (n > PY * K + PX);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (v[S + p + dx] < c[p]) words[b >> 5][p] |= 1u << (b & 31);
    }
  }
  const size_t plane = (size_t)H * W, f = (size_t)y * W + xs;
#pragma unroll
  for (int w = 0; w < NW; ++w) store4(out + w * plane, f, xs, W, words[w]);
}

template <int K, int WS>
__global__ void __launch_bounds__(kThreads) census_staged(const float* __restrict__ img,
                                                          int32_t* __restrict__ out, int H,
                                                          int W) {
  constexpr int SW = staged_width(K), SR = kRows + WS - 1;
  __shared__ __align__(16) float s[SR * SW];
  census_tile(img, s, H, W, K / 2, WS / 2, SW, SR, [&](int y, int xs, int chunk, int a) {
    switch (a) {  // warp-uniform: a row's shift
      case 0: census_body<K, WS, 0>(s, out, H, W, y, xs, chunk); break;
      case 1: census_body<K, WS, 3>(s, out, H, W, y, xs, chunk); break;
      case 2: census_body<K, WS, 2>(s, out, H, W, y, xs, chunk); break;
      default: census_body<K, WS, 1>(s, out, H, W, y, xs, chunk); break;
    }
  });
}

// Any other window: the same tile, staging and pixels, runtime loops; a
// word plane is stored when its 32 bits are done.
__global__ void __launch_bounds__(kThreads) census_staged_any(const float* __restrict__ img,
                                                              int32_t* __restrict__ out, int H,
                                                              int W, int ksize, int wsize) {
  extern __shared__ __align__(16) float s_any[];
  const int sw = staged_width(ksize), px = ksize / 2, py = wsize / 2;
  census_tile(img, s_any, H, W, px, py, sw, kRows + wsize - 1,
              [&](int y, int xs, int chunk, int a) {
    const int col = 4 * chunk + ((4 - a) & 3);
    const int warp = threadIdx.x >> 5;
    float c[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) c[p] = s_any[(warp + py) * sw + col + p + px];
    const size_t plane = (size_t)H * W, f = (size_t)y * W + xs;
    uint32_t words[4] = {0, 0, 0, 0};
    int bit = 0;
    for (int dy = 0; dy < wsize; ++dy) {
      const float* row = s_any + (warp + dy) * sw + col;
      for (int dx = 0; dx < ksize; ++dx) {
        if (dy == py && dx == px) continue;
#pragma unroll
        for (int p = 0; p < 4; ++p) words[p] |= (uint32_t)(row[p + dx] < c[p]) << (bit & 31);
        if ((++bit & 31) == 0) {
          store4(out + (size_t)((bit - 1) >> 5) * plane, f, xs, W, words);
#pragma unroll
          for (int p = 0; p < 4; ++p) words[p] = 0;
        }
      }
    }
    if (bit & 31) store4(out + (size_t)(bit >> 5) * plane, f, xs, W, words);
  });
}

// The grid: a block a tile of 4 rows of 32 groups of 4 pixels; a row
// shifted by a = (y * W) mod 4 needs ceil((W + a) / 4) groups.
dim3 tiles(int H, int W) {
  const int groups = (W & 3) ? (W + 6) / 4 : W / 4;
  return dim3((groups + 31) / 32, (H + kRows - 1) / kRows);
}

}  // namespace

// form: the instance sgm_cuda.census_design picks: 0 any size, 1 3x3, 2 5x5,
// 3 7x5, 4 7x7, 5 9x7 (ksize x wsize).
extern "C" int svt_census_words(const void* img, void* out, int H, int W, int ksize, int wsize,
                                int form, void* stream) {
  const dim3 grid = tiles(H, W);
  const float* in = (const float*)img;
  int32_t* o = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (form) {
    case 1: census_staged<3, 3><<<grid, kThreads, 0, st>>>(in, o, H, W); break;
    case 2: census_staged<5, 5><<<grid, kThreads, 0, st>>>(in, o, H, W); break;
    case 3: census_staged<7, 5><<<grid, kThreads, 0, st>>>(in, o, H, W); break;
    case 4: census_staged<7, 7><<<grid, kThreads, 0, st>>>(in, o, H, W); break;
    case 5: census_staged<9, 7><<<grid, kThreads, 0, st>>>(in, o, H, W); break;
    default: {
      const size_t smem = (size_t)(kRows + wsize - 1) * staged_width(ksize) * sizeof(float);
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            census_staged_any, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
      }
      census_staged_any<<<grid, kThreads, smem, st>>>(in, o, H, W, ksize, wsize);
    }
  }
  return (int)cudaGetLastError();
}
