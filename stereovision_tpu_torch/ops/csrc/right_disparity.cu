// Right-view disparity from the summed path-cost volume (the LR check's
// second view): out[y, u] = argmin over d < d_valid with u + d < W of
// s[y, u + d, d], strict < so ties go to the smallest d.
//
// Replaces: stereovision_tpu/ops/sgm_pallas.py:right_disparity
// (_rdisp_kernel). The TPU kernel reads a (D, H, W)-transposed copy of the
// sum and aligns each plane with static lane rotates, a dynamic rotate per
// block of planes, and a `groups` grid for lane-packed strips. Here the
// volume stays (H, W, D) (no transposed copy is written), the diagonal is
// read in place, and the strips of the port are plain row ranges, so no
// groups are needed.
//
// Bound on this card: bytes, H*W*D*itemsize read + 4*H*W written (59 MB +
// 3.7 MB for int16 at 720x1280, D=32; 3.7 + 3.7 MB for int8 at D=32 on
// window A's 720 rows). This simple design is one thread per (y, u) looping
// over d: consecutive d of one thread are D + 1 elements apart and
// neighbouring threads D elements apart, so a warp's load touches 32
// separate sectors; one row of the volume (W*D elements, 40 KB at D=32) is
// reused from L1/L2 by the d-loop.
//
// Built with -DSVT_VARIANTS, the library also holds
// svt_right_disparity_variant, the counterparts of scripts/bench_rdisp.py
// (TPU kernel at :84, a log-shear of s (H, W, D) in VMEM, against the
// transposed copy and _rdisp_kernel), all computing the same function:
//   kInPlace:    the shipping kernel;
//   kTransposed: reads a (D, H, W) copy st[d, y, u + d], coalesced across u
//                (the TPU pipeline's layout; the copy is the caller's);
//   kStaged:     the GPU counterpart of the log-shear. A block of 256 threads
//                takes 64 columns u0..u0+63 of one row and stages their band
//                -- the parallelogram s[y, u0 + u + d, d], u < 64, d < D -- in
//                shared memory as band[d][u], in the volume's type: each
//                staging pass reads 64 consecutive planes of one image column
//                (coalesced), a thread keeps 8 loads in flight, and every
//                element of the band belongs to one block only, so the
//                volume's band is read once. Each thread then walks a quarter
//                of one column's diagonal from shared memory (a row pitch of
//                66 elements), and the four partial minima are combined with
//                ties to the smallest d. The band is D * 66 elements (132 KB
//                at D=1024 int16); above 48 KB the kernel takes dynamic
//                shared memory through cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

enum : int { kInPlace = 0, kTransposed = 1, kStaged = 2 };

template <typename T, int VAR = kInPlace>
__global__ void right_disparity_kernel(const T* __restrict__ s, int32_t* __restrict__ out, int H,
                                       int W, int D, int d_valid) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)H * W) return;
  const int y = (int)(i / W);
  const int u = (int)(i - (long long)y * W);
  const int dmax = min(d_valid, W - u);
  int best = INT_MAX, idx = 0;
  if constexpr (VAR == kTransposed) {
    const T* p = s + i;  // st[0, y, u]
    const long long plane = (long long)H * W;
    for (int d = 0; d < dmax; ++d) {
      const int v = p[(long long)d * plane + d];  // st[d, y, u + d]
      if (v < best) {
        best = v;
        idx = d;
      }
    }
  } else {
    const T* p = s + ((long long)y * W + u) * D;  // s[y, u, 0]
    for (int d = 0; d < dmax; ++d) {
      const int v = p[(long long)d * (D + 1)];  // s[y, u + d, d]
      if (v < best) {
        best = v;
        idx = d;
      }
    }
  }
  out[i] = idx;
}

// itemsize: 1 (int8 summed volume, offset by -128) or 2 (int16)
extern "C" int svt_right_disparity(const void* s, void* out, int H, int W, int D, int d_valid,
                                   int itemsize, void* stream) {
  const long long n = (long long)H * W;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (itemsize == 1)
    right_disparity_kernel<int8_t><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)s, (int32_t*)out, H, W, D, d_valid);
  else if (itemsize == 2)
    right_disparity_kernel<int16_t><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int16_t*)s, (int32_t*)out, H, W, D, d_valid);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

#ifdef SVT_VARIANTS

static constexpr int kStagedThreads = 256;
static constexpr int kBandCols = 64;  // image columns of one block
static constexpr int kMaxSharedBytes = 232448;  // what one block may use on Hopper

template <typename T>
__global__ void __launch_bounds__(kStagedThreads)
right_disparity_staged_kernel(const T* __restrict__ s, int32_t* __restrict__ out, int H, int W,
                              int D, int d_valid) {
  extern __shared__ int smem[];
  T* band = (T*)smem;  // band[d * pitch + u] = s[y, u0 + u + d, d]
  constexpr int bw = kBandCols;
  constexpr int pitch = bw + 2;
  constexpr int kstep = kStagedThreads / bw;  // staging rows a pass, and walkers a column
  const int y = blockIdx.y;
  const int u0 = blockIdx.x * bw;
  const int t = threadIdx.x;
  const int dv = min(d_valid, W - u0);        // planes the block's columns can reach
  const int cols = min(bw + dv - 1, W - u0);  // image columns u0 + k the band touches
  const T* row = s + (long long)y * W * D;
  // thread t stages element j = t % bw of image columns k = t / bw, + kstep, ...:
  // plane d = k - (bw - 1) + j of column u = bw - 1 - j (consecutive threads,
  // consecutive planes of one image column)
  const int j = t % bw;
#pragma unroll 8
  for (int k = t / bw; k < cols; k += kstep) {
    const int d = k - (bw - 1) + j;
    if (d >= 0 && d < dv) band[d * pitch + bw - 1 - j] = row[(long long)(u0 + k) * D + d];
  }
  __syncthreads();
  const int u = j;
  const int q = t / bw;
  const int dmax = u0 + u < W ? min(dv, W - u0 - u) : 0;
  int best = INT_MAX, idx = 0;
  for (int d = q; d < dmax; d += kstep) {
    const int v = band[d * pitch + u];
    if (v < best) {
      best = v;
      idx = d;
    }
  }
  __syncthreads();
  smem[t] = best;
  smem[kStagedThreads + t] = idx;
  __syncthreads();
  if (q == 0 && u0 + u < W) {
    for (int g = 1; g < kstep; ++g) {
      const int v = smem[g * bw + u];
      const int i = smem[kStagedThreads + g * bw + u];
      if (v < best || (v == best && i < idx)) {
        best = v;
        idx = i;
      }
    }
    out[(long long)y * W + u0 + u] = idx;
  }
}

template <typename T>
static int launch_variant(const void* s, int32_t* out, int H, int W, int D, int d_valid,
                          int variant, cudaStream_t stream) {
  if (variant == kInPlace || variant == kTransposed) {
    const long long n = (long long)H * W;
    const unsigned blocks = (unsigned)((n + 255) / 256);
    if (variant == kInPlace)
      right_disparity_kernel<T><<<blocks, 256, 0, stream>>>((const T*)s, out, H, W, D, d_valid);
    else
      right_disparity_kernel<T, kTransposed><<<blocks, 256, 0, stream>>>((const T*)s, out, H, W, D,
                                                                        d_valid);
    return 0;
  }
  if (variant != kStaged) return (int)cudaErrorInvalidValue;
  const size_t band = (size_t)D * (kBandCols + 2) * sizeof(T);
  const size_t bytes = band > 2 * kStagedThreads * 4 ? band : 2 * kStagedThreads * 4;
  if (bytes > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(right_disparity_staged_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kBandCols - 1) / kBandCols, H);
  right_disparity_staged_kernel<T><<<grid, kStagedThreads, bytes, stream>>>((const T*)s, out, H, W,
                                                                             D, d_valid);
  return 0;
}

// One measurement variant (the enum): s is (H, W, D), or (D, H, W) for
// kTransposed; itemsize 1 (int8) or 2 (int16).
extern "C" int svt_right_disparity_variant(const void* s, void* out, int H, int W, int D,
                                           int d_valid, int itemsize, int variant, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (itemsize == 1)
    err = launch_variant<int8_t>(s, (int32_t*)out, H, W, D, d_valid, variant, st);
  else if (itemsize == 2)
    err = launch_variant<int16_t>(s, (int32_t*)out, H, W, D, d_valid, variant, st);
  else
    return (int)cudaErrorInvalidValue;
  return err != 0 ? err : (int)cudaGetLastError();
}

#endif  // SVT_VARIANTS
