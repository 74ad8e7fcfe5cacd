// k x k median filter with replicate borders (cv2.medianBlur): (H, W) float32
// -> (H, W) float32, k in {3, 5}.
//
// Replaces: no pallas_call. The JAX package's median
// (stereovision_tpu/core/image.py:median_blur) is plain jnp: the pruned Batcher
// network over the k^2 shifted views, which XLA fuses into one TPU kernel. In
// eager PyTorch the same formulation (core/image.py:median_blur, the plain
// version) stacks the 25 views into an (H, W, 25) tensor (92 MB at 720p) and
// launches 113 torch.minimum and 113 torch.maximum calls, each reading two
// strided views and writing a fresh map: ~233 launches and ~1 GB of traffic
// a 720p call, 2.31 ms of device time, and the engine runs it three times a
// production frame.
//
// Semantics: out[y, x] is wire k^2 / 2 after the compare-exchanges of
// _median_pairs(k^2) (core/image.py) on the window's values, dy-major then
// dx, their coordinates clamped into the image. Each compare-exchange is
// torch.minimum / torch.maximum on a card, element for element: a NaN operand
// is returned (the first where both are), else fminf / fmaxf of the two in
// the same order. So the output equals the plain version's bit for bit, NaN,
// +-inf and +-0 included.
//
// Bound on this card: bytes, one read of the map and one write, 7.4 MB at
// 1280x720 (~2.2 us at 3.35 TB/s). The network's operation floor lies above
// that: 226 min/max a pixel for k = 5 (113 pairs; the compiler drops the
// halves no later pair reads), 0.21 G a 720p call, ~13 us at the card's
// min/max rate.
//
// Design: a block of 8 warps owns a tile of 32 columns and 16 rows. It stages
// the tile with its k / 2 halo in shared memory, the coordinates clamped for
// the replicate border, so the map is read about once (1.4x for k = 5, the
// halo), from consecutive addresses. Each thread then takes two pixels of
// its column (rows ty and ty + 8 of the tile), loads each window's k^2
// values into registers (a warp's loads at consecutive words: no bank
// conflict) and runs the network on them, unrolled: the pairs below are
// constant register indices, baked from _median_pairs(9) and
// _median_pairs(25) (a test parses them back). Where no value of the window
// is NaN the NaN tests cannot fire, so the network runs as plain fminf /
// fmaxf; a window holding a NaN takes the same network with the tests.
// Neighbouring outputs share no compare-exchange: the network's first
// stages group wires in powers of two, which the 5-wide rows of two
// neighbouring windows do not share, and another network would move a NaN
// or a signed zero elsewhere.

#include <cuda_runtime.h>
#include <stdint.h>

// the compare-exchanges of core/image.py:_median_pairs(9), in order
#define SVT_MEDIAN_PAIRS_9(X) \
  X(0, 1) X(2, 3) X(0, 2) X(1, 3) X(1, 2) X(4, 5) X(6, 7) X(4, 6) X(5, 7) X(5, 6) X(0, 4) \
  X(2, 6) X(2, 4) X(1, 5) X(3, 7) X(3, 5) X(1, 2) X(3, 4) X(5, 6) X(0, 8) X(4, 8) X(2, 4) \
  X(3, 5) X(3, 4)

// the compare-exchanges of core/image.py:_median_pairs(25), in order
#define SVT_MEDIAN_PAIRS_25(X) \
  X(0, 1) X(2, 3) X(0, 2) X(1, 3) X(1, 2) X(4, 5) X(6, 7) X(4, 6) X(5, 7) X(5, 6) X(0, 4) \
  X(2, 6) X(2, 4) X(1, 5) X(3, 7) X(3, 5) X(1, 2) X(3, 4) X(5, 6) X(8, 9) X(10, 11) X(8, 10) \
  X(9, 11) X(9, 10) X(12, 13) X(14, 15) X(12, 14) X(13, 15) X(13, 14) X(8, 12) X(10, 14) \
  X(10, 12) X(9, 13) X(11, 15) X(11, 13) X(9, 10) X(11, 12) X(13, 14) X(0, 8) X(4, 12) X(4, 8) \
  X(2, 10) X(6, 14) X(6, 10) X(2, 4) X(6, 8) X(10, 12) X(1, 9) X(5, 13) X(5, 9) X(3, 11) \
  X(7, 15) X(7, 11) X(3, 5) X(7, 9) X(11, 13) X(1, 2) X(3, 4) X(5, 6) X(7, 8) X(9, 10) \
  X(11, 12) X(13, 14) X(16, 17) X(18, 19) X(16, 18) X(17, 19) X(17, 18) X(20, 21) X(22, 23) \
  X(20, 22) X(21, 23) X(21, 22) X(16, 20) X(18, 22) X(18, 20) X(17, 21) X(19, 23) X(19, 21) \
  X(17, 18) X(19, 20) X(21, 22) X(16, 24) X(20, 24) X(18, 20) X(22, 24) X(19, 21) X(17, 18) \
  X(19, 20) X(21, 22) X(23, 24) X(0, 16) X(8, 24) X(8, 16) X(4, 20) X(12, 20) X(12, 16) \
  X(2, 18) X(10, 18) X(6, 22) X(6, 10) X(10, 12) X(1, 17) X(9, 17) X(5, 21) X(13, 21) X(13, 17) \
  X(3, 19) X(11, 19) X(7, 23) X(7, 11) X(11, 13) X(11, 12)

static constexpr int kCols = 32;       // a block's output columns: a lane each
static constexpr int kWarps = 8;       // warps a block, stacked down the tile
static constexpr int kPixels = 2;      // output rows a thread, kWarps apart
static constexpr int kRows = kWarps * kPixels;  // a block's output rows
static constexpr unsigned kGridRows = 65535;    // grid rows at most; a block walks the rest

// torch.minimum and torch.maximum of two floats on a card
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

#define SVT_EXCHANGE(i, j)                                  \
  {                                                         \
    const float lo = fminf(v[i], v[j]), hi = fmaxf(v[i], v[j]); \
    v[i] = lo;                                              \
    v[j] = hi;                                              \
  }
#define SVT_EXCHANGE_NAN(i, j)                                    \
  {                                                               \
    const float lo = nan_min(v[i], v[j]), hi = nan_max(v[i], v[j]); \
    v[i] = lo;                                                    \
    v[j] = hi;                                                    \
  }

template <int K>
__device__ __forceinline__ void exchange(float (&v)[K * K], bool nan);

template <>
__device__ __forceinline__ void exchange<3>(float (&v)[9], bool nan) {
  if (nan) {
    SVT_MEDIAN_PAIRS_9(SVT_EXCHANGE_NAN)
  } else {
    SVT_MEDIAN_PAIRS_9(SVT_EXCHANGE)
  }
}

template <>
__device__ __forceinline__ void exchange<5>(float (&v)[25], bool nan) {
  if (nan) {
    SVT_MEDIAN_PAIRS_25(SVT_EXCHANGE_NAN)
  } else {
    SVT_MEDIAN_PAIRS_25(SVT_EXCHANGE)
  }
}

template <int K>
__global__ void __launch_bounds__(kCols * kWarps)
median_tile(const float* __restrict__ in, float* __restrict__ out, int H, int W) {
  constexpr int R = K / 2, SW = kCols + 2 * R, SH = kRows + 2 * R;
  __shared__ float tile[SH][SW];
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int x0 = blockIdx.x * kCols;
  const int x = x0 + threadIdx.x;
  for (int y0 = blockIdx.y * kRows; y0 < H; y0 += gridDim.y * kRows) {
    for (int i = tid; i < SH * SW; i += kCols * kWarps) {
      const int r = i / SW, c = i - r * SW;
      const int gy = min(max(y0 + r - R, 0), H - 1);
      const int gx = min(max(x0 + c - R, 0), W - 1);
      tile[r][c] = in[(long long)gy * W + gx];
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPixels; ++p) {
      const int ty = threadIdx.y + p * kWarps;
      if (x < W && y0 + ty < H) {
        float v[K * K];
        bool nan = false;
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            v[dy * K + dx] = tile[ty + dy][threadIdx.x + dx];
            nan |= v[dy * K + dx] != v[dy * K + dx];
          }
        }
        exchange<K>(v, nan);
        out[(long long)(y0 + ty) * W + x] = v[K * K / 2];
      }
    }
    __syncthreads();
  }
}

extern "C" int svt_median_blur(const void* in, void* out, int H, int W, int ksize,
                               void* stream) {
  if (ksize != 3 && ksize != 5) return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned rows = (unsigned)((H + kRows - 1) / kRows);
  const dim3 grid((W + kCols - 1) / kCols, rows < kGridRows ? rows : kGridRows);
  const dim3 block(kCols, kWarps);
  const float* src = (const float*)in;
  float* dst = (float*)out;
  if (ksize == 5)
    median_tile<5><<<grid, block, 0, st>>>(src, dst, H, W);
  else
    median_tile<3><<<grid, block, 0, st>>>(src, dst, H, W);
  return (int)cudaGetLastError();
}
