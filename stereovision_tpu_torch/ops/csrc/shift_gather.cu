// Bounded horizontal gather: out[b, y, x] = src[b, y, x - off[y, x]], 0 where
// off < 0, off >= max_offset or off > x. The B maps (census words, or one
// image) share the offsets. Elements are 4 bytes (float32 or int32): the
// kernel copies bits, so one kernel serves both types.
//
// Replaces: stereovision_tpu/ops/sgm_pallas.py:shift_gather
// (_shift_gather_kernel). A per-pixel lane gather does not exist on the TPU,
// so that kernel rolls each row block by every offset in [0, max_offset) and
// selects, with a data-dependent skip of roll blocks no offset uses. A GPU
// thread loads from any address, so none of that is carried over: one
// indexed load a pixel and map.
//
// Bound on this card: bytes. Per launch it reads the offsets once and each of
// the B maps once and writes B maps: (2B + 1) * 4 * H * W bytes (11 MB for
// one 1280x720 map: ~3.3 us at 3.35 TB/s). The gathered loads of a warp hit
// a few neighbouring cache lines, since the pipeline's offset fields are
// locally smooth.
//
// Design: a 2-D grid, the row from blockIdx.y (no division by W), a thread
// takes kPixels pixels of a row, and each offset is read once for all B
// maps. Where W % 4 == 0 and the offsets and the output are 16-byte aligned,
// a thread's pixels are adjacent: one 16-byte load of their offsets and one
// 16-byte store a map (shift_gather_vec). Otherwise they are strided by the
// block, so that each load and store of a warp is coalesced
// (shift_gather_rows).

#include <cuda_runtime.h>
#include <stdint.h>

static constexpr int kThreads = 128;
static constexpr int kPixels = 4;        // pixels a thread
static constexpr unsigned kRows = 65535;  // grid rows at most; a block walks the rest

__device__ __forceinline__ bool in_range(int o, int x, int max_offset) {
  return o >= 0 && o < max_offset && o <= x;
}

__global__ void __launch_bounds__(kThreads)
shift_gather_vec(const uint32_t* __restrict__ src, const int32_t* __restrict__ off,
                 uint32_t* __restrict__ out, int B, int H, int W, int max_offset) {
  const int x = (blockIdx.x * kThreads + threadIdx.x) * kPixels;
  if (x >= W) return;
  const long long plane = (long long)H * W;
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    const long long i = (long long)y * W + x;
    const int4 o = *(const int4*)(off + i);
    const bool k0 = in_range(o.x, x, max_offset), k1 = in_range(o.y, x + 1, max_offset);
    const bool k2 = in_range(o.z, x + 2, max_offset), k3 = in_range(o.w, x + 3, max_offset);
    for (int b = 0; b < B; ++b) {
      const uint32_t* s = src + b * plane + i;
      uint4 v;
      v.x = k0 ? s[-o.x] : 0u;
      v.y = k1 ? s[1 - o.y] : 0u;
      v.z = k2 ? s[2 - o.z] : 0u;
      v.w = k3 ? s[3 - o.w] : 0u;
      *(uint4*)(out + b * plane + i) = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
shift_gather_rows(const uint32_t* __restrict__ src, const int32_t* __restrict__ off,
                  uint32_t* __restrict__ out, int B, int H, int W, int max_offset) {
  const int x0 = blockIdx.x * kThreads * kPixels + threadIdx.x;
  const long long plane = (long long)H * W;
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    const long long r = (long long)y * W;
#pragma unroll
    for (int p = 0; p < kPixels; ++p) {
      const int x = x0 + p * kThreads;
      if (x >= W) break;
      const int o = off[r + x];
      const bool ok = in_range(o, x, max_offset);
      for (int b = 0; b < B; ++b) out[b * plane + r + x] = ok ? src[b * plane + r + x - o] : 0u;
    }
  }
}

extern "C" int svt_shift_gather(const void* src, const void* off, void* out, int B, int H, int W,
                                int max_offset, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((W + kThreads * kPixels - 1) / (kThreads * kPixels),
                  (unsigned)H < kRows ? (unsigned)H : kRows);
  const uint32_t* s = (const uint32_t*)src;
  const int32_t* o = (const int32_t*)off;
  uint32_t* d = (uint32_t*)out;
  if (W % 4 == 0 && ((uintptr_t)off & 15) == 0 && ((uintptr_t)out & 15) == 0)
    shift_gather_vec<<<grid, kThreads, 0, st>>>(s, o, d, B, H, W, max_offset);
  else
    shift_gather_rows<<<grid, kThreads, 0, st>>>(s, o, d, B, H, W, max_offset);
  return (int)cudaGetLastError();
}
