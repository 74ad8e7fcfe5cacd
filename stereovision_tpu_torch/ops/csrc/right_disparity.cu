// Right-view disparity from the summed path-cost volume (the LR check's
// second view): out[y, u] = argmin over d < d_valid with u + d < W of
// s[y, u + d, d], strict < so ties go to the smallest d.
//
// Replaces: stereovision_tpu/ops/sgm_pallas.py:right_disparity
// (_rdisp_kernel). The TPU kernel reads a (D, H, W)-transposed copy of the
// sum and aligns each plane with static lane rotates, a dynamic rotate per
// block of planes, and a `groups` grid for lane-packed strips. Here the
// volume stays (H, W, D) (no transposed copy is written) and the strips of
// the port are plain row ranges, so no groups are needed.
//
// Bound on this card: bytes. The function reads the band u + d < W, d <
// d_valid, of each row once and writes an int32 map: for the production
// frame's int8 launches 29.1 + 3.7 MB at (720, 1280, 32) (0.0098 ms at
// 3.35 TB/s) and 10.8 + 0.4 MB at the coarse search's (240, 426, 107)
// (0.0030 ms); for the full search with the LR check, int16 at
// (720, 1280, 320), 516.3 + 3.7 MB (0.1552 ms). The diagonal itself is the
// problem: the first design (one thread a right pixel walking d, kept as
// the kInPlace variant below) makes each warp load touch 32 sectors for 1-2
// bytes of each, and ran at 25% (D = 32) and 15% (D = 320) of the bound.
//
// Design (diagonal boxes): the work of right pixels u in [u0, u0 + U) and
// planes d in [d0, d0 + 32) lies in one rectangle of the volume, image
// columns x in [u0 + d0, u0 + d0 + U + 31) by those 32 planes: a run of 32
// contiguous elements for each x. A block of U = 128 threads owns one row
// y and U right pixels (a thread each; past 65535 rows a block takes
// several rows in turn), stages the rectangles of its 32-plane
// tiles into shared memory, and each thread walks its pixel's diagonal
// there: cell (u - u0 + k, k) of tile d0 holds s[y, u + d0 + k, d0 + k].
// It keeps one packed key, (value + 32768) << 16 | d, in a register and
// takes the least: the smallest value, ties to the smallest d, also across
// tiles. Lanes on consecutive pixels read cells one row apart: at the
// rows' natural pitch of 32 elements (8 or 16 words), cells of the same
// plane would meet on a few banks, so lane l walks its row's words in
// turn starting at word l * itemsize / 4 (the planes' order does not
// matter to a min over keys), which puts a warp's 32 reads on 32 banks
// and leaves the rows packed for 16-byte copies. Staging a rectangle
// rather than the band reads (U + 31) / U of the band: the floor is ~1.24x
// the bound at U = 128 (0.0122 ms at (720, 1280, 32) int8, 0.193 ms at
// D = 320 int16). Blocks of 256 read 1.5-4% faster at the production
// launches and 1.4% slower at D = 320 on the card: one block size, one
// set of instances. Three forms, chosen by sgm_cuda.right_disparity_design
// and the alignment:
//   kTilesVec:  tiles double-buffered, copied by 16-byte cp.async while
//               the previous tile is walked, where every run is 16-byte
//               aligned (D * itemsize a multiple of 16, as at D = 32 int8
//               and D = 320 int16);
//   kTilesElem: the same tiles staged by element loads (any other D);
//   kSpan:      the block's whole span (every plane of columns u0 .. u0 + U
//               + dv - 2, rows D elements apart) in one stage of 16-byte
//               cp.async, its aligned superset copied whatever D, walked
//               in order, where it fits 48 KB and the D-element pitch
//               leaves at most 2 reads on a bank (the coarse search's
//               D = 107).
//
// Built with -DSVT_VARIANTS, the library also holds
// svt_right_disparity_variant, the counterparts of scripts/bench_rdisp.py
// (TPU kernel at :84, a log-shear of s (H, W, D) in VMEM, against the
// transposed copy and _rdisp_kernel), all computing the same function:
//   kInPlace:    the first design, one thread a (y, u) looping
//                over d in place: consecutive d of one thread are D + 1
//                elements apart and neighbouring threads D elements apart;
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
//                shared memory, its limit raised once per instance;
//   kBoxes:      the shipping kernel (diagonal boxes), for the script's row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

enum : int { kSpan = 0, kTilesVec = 1, kTilesElem = 2 };
static constexpr int kTile = 32;             // planes a tile
static constexpr int kU = 128;               // right pixels a block, a thread each
static constexpr int kSpanMax = 48 * 1024;   // shared bytes of a kSpan block at most

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy bytes [b0, b1) of a volume of `total` bytes to shared memory at dst
// as their 16-byte-aligned superset: 16 bytes a cp.async where the granule
// lies inside the volume, byte by byte where it straddles one of its ends.
// Returns the offset from dst at which byte b0 lands.
__device__ __forceinline__ int stage_span(unsigned char* dst, const unsigned char* vol,
                                          long long total, long long b0, long long b1) {
  const uintptr_t base = (uintptr_t)vol, end = base + (uintptr_t)total;
  const uintptr_t lo = (base + (uintptr_t)b0) & ~(uintptr_t)15;
  const uintptr_t hi = (base + (uintptr_t)b1 + 15) & ~(uintptr_t)15;
  const int n = (int)((hi - lo) >> 4);
  const unsigned sdst = (unsigned)__cvta_generic_to_shared(dst);
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const uintptr_t a = lo + 16 * (uintptr_t)c;
    if (a >= base && a + 16 <= end) {
      cp_async16(sdst + 16 * c, (const void*)a);
    } else {
      for (int i = 0; i < 16; ++i)
        if (a + i >= base && a + i < end) dst[16 * c + i] = *(const unsigned char*)(a + i);
    }
  }
  cp_async_commit();
  return (int)(base + (uintptr_t)b0 - lo);
}

// One tile of a thread's right pixel in a span, in plane order: planes
// d0 + k for k < kmax, cell k at p + k * step bytes; c = 0x80000000 + d0
// (the key's offset and plane).
template <typename T>
__device__ __forceinline__ void walk_span(const unsigned char* p, int step, int kmax, unsigned c,
                                          unsigned& best) {
  if (kmax >= kTile) {
#pragma unroll
    for (int k = 0; k < kTile; ++k)
      best = min(best, ((unsigned)(int)*(const T*)(p + k * step) << 16) + c + k);
  } else {
#pragma unroll
    for (int k = 0; k < kTile; ++k)
      if (k < kmax) best = min(best, ((unsigned)(int)*(const T*)(p + k * step) << 16) + c + k);
  }
}

// The same in a tile (rows of 32 elements, cell k of the pixel at row0 +
// k * (32 + 1) elements), a word's planes at a time, lane l starting at
// word l / G: a warp's reads fall on 32 banks.
template <typename T>
__device__ __forceinline__ void walk_tile(const unsigned char* row0, int lane, int kmax,
                                          unsigned c, unsigned& best) {
  constexpr int G = 4 / sizeof(T);                 // planes a word
  constexpr int NG = kTile / G;                    // words a row: 8 or 16
  constexpr int STEP = (kTile + 1) * sizeof(T);    // bytes from cell k to cell k + 1
  const int rot = lane / G;
  if (kmax >= kTile) {
#pragma unroll
    for (int s = 0; s < NG; ++s) {
      const int g = (s + rot) & (NG - 1);
      const unsigned char* q = row0 + g * G * STEP;
      const unsigned cg = c + g * G;
#pragma unroll
      for (int i = 0; i < G; ++i)
        best = min(best, ((unsigned)(int)*(const T*)(q + i * STEP) << 16) + cg + i);
    }
  } else {
#pragma unroll
    for (int s = 0; s < NG; ++s) {
      const int g = (s + rot) & (NG - 1);
      const unsigned char* q = row0 + g * G * STEP;
      const unsigned cg = c + g * G;
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (g * G + i < kmax)
          best = min(best, ((unsigned)(int)*(const T*)(q + i * STEP) << 16) + cg + i);
    }
  }
}

// One block's work on row y: right pixels u0 .. u0 + kU - 1.
template <typename T, int FORM>
__device__ __forceinline__ void boxes_row(const T* __restrict__ s, int32_t* __restrict__ out,
                                          unsigned char* smem, int H, int W, int D, int d_valid,
                                          int y, int u0) {
  constexpr int U = kU, NW = kU / 32;
  constexpr int ROWS = U + kTile - 1;    // image columns of a tile's rectangle
  constexpr int ROWB = kTile * sizeof(T);  // bytes a rectangle row
  const int t = threadIdx.x, u = u0 + t;
  const int dv = min(d_valid, W - u0);  // planes the block's first pixel reaches (its most)
  const int du = min(d_valid, W - u);   // planes of this thread's pixel (<= 0 past the row)
  const long long rowel = (long long)y * W;
  unsigned best = 0xffffffffu;
  if constexpr (FORM == kSpan) {
    const long long pix = (long long)D * sizeof(T);  // bytes an image column
    const int x1 = min(W, u0 + U + dv - 1);
    const int off = stage_span(smem, (const unsigned char*)s, (long long)H * W * pix,
                               (rowel + u0) * pix, (rowel + x1) * pix);
    cp_async_wait_all();
    __syncthreads();
    // cell (x - u0, d) at off + ((x - u0) * D + d) * itemsize; the diagonal
    // steps D + 1 elements
    for (int d0 = 0; d0 < dv; d0 += kTile)
      walk_span<T>(smem + off + ((long long)(t + d0) * D + d0) * sizeof(T),
                   (D + 1) * (int)sizeof(T), du - d0, 0x80000000u + d0, best);
  } else {
    // two buffers of ROWS rows of ROWB bytes: row r of tile d0 holds image
    // column u0 + d0 + r, planes d0 .. d0 + 31
    const int tiles = (dv + kTile - 1) / kTile;
    auto stage = [&](int tile) {
      const int d0 = tile * kTile, x0 = u0 + d0;
      const int rows = min(ROWS, W - x0);
      unsigned char* dst = smem + (tile & 1) * ROWS * ROWB;
      const T* src = s + (rowel + x0) * D + d0;
      if constexpr (FORM == kTilesVec) {
        constexpr int CH = ROWB / 16;  // 16-byte chunks a row: 2 or 4
        const int live = min(CH, (D - d0) * (int)sizeof(T) / 16);  // D * itemsize % 16 == 0
        const unsigned sdst = (unsigned)__cvta_generic_to_shared(dst);
        for (int c = t; c < rows * CH; c += U) {
          const int r = c / CH, k = c - r * CH;
          if (k < live) cp_async16(sdst + 16 * c, (const char*)(src + (long long)r * D) + 16 * k);
        }
        cp_async_commit();
      } else {
        const int lane = t & 31, w = t >> 5;
        const bool real = d0 + lane < D;
#pragma unroll 4
        for (int r = w; r < rows; r += NW)
          if (real) *(T*)(dst + r * ROWB + lane * sizeof(T)) = src[(long long)r * D + lane];
      }
    };
    stage(0);
    for (int tile = 0; tile < tiles; ++tile) {
      if constexpr (FORM == kTilesVec) cp_async_wait_all();  // this thread's copies of the tile
      __syncthreads();  // the tile visible; every thread done with the previous tile's buffer
      if constexpr (FORM == kTilesVec) {
        if (tile + 1 < tiles) stage(tile + 1);  // lands while this tile is walked
      }
      const int d0 = tile * kTile;
      walk_tile<T>(smem + (tile & 1) * ROWS * ROWB + t * ROWB, t & 31, du - d0, 0x80000000u + d0,
                   best);
      if constexpr (FORM == kTilesElem) {
        if (tile + 1 < tiles) stage(tile + 1);
      }
    }
  }
  if (u < W) out[rowel + u] = (int32_t)(best & 0xffffu);
}

// A block a span of kU right pixels (grid.x) and a row (grid.y); past
// 65535 rows (grid.y's limit) a block takes rows gridDim.y apart.
template <typename T, int FORM>
__global__ void __launch_bounds__(kU)
right_disparity_boxes(const T* __restrict__ s, int32_t* __restrict__ out, int H, int W, int D,
                      int d_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    if (y != (int)blockIdx.y) __syncthreads();  // every thread done with the last row's stage
    boxes_row<T, FORM>(s, out, smem, H, W, D, d_valid, y, blockIdx.x * kU);
  }
}

static int imin(int a, int b) { return a < b ? a : b; }

// tiles: 0 for the span form, else tiles of 32 planes, by cp.async where
// every run is 16-byte aligned, by element loads elsewhere.
template <typename T>
static int launch_boxes(const void* s, int32_t* out, int H, int W, int D, int d_valid, int tiles,
                        cudaStream_t stream) {
  if (D > 65535) return (int)cudaErrorInvalidValue;  // a key holds d in 16 bits
  if (H == 0 || W == 0) return 0;
  const int form = !tiles ? kSpan
                   : ((uintptr_t)s % 16 == 0 && D * sizeof(T) % 16 == 0) ? kTilesVec
                                                                        : kTilesElem;
  // shared bytes a block takes (a span: its columns, and room for the
  // alignment of its superset)
  const size_t bytes =
      form == kSpan
          ? ((size_t)imin(W, kU + imin(d_valid, W) - 1) * D * sizeof(T) + 31) & ~(size_t)15
          : (size_t)2 * (kU + kTile - 1) * kTile * sizeof(T);
  if (bytes > (size_t)kSpanMax) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kU - 1) / kU, imin(H, 65535));
  const T* v = (const T*)s;
  if (form == kSpan)
    right_disparity_boxes<T, kSpan><<<grid, kU, bytes, stream>>>(v, out, H, W, D, d_valid);
  else if (form == kTilesVec)
    right_disparity_boxes<T, kTilesVec><<<grid, kU, bytes, stream>>>(v, out, H, W, D, d_valid);
  else
    right_disparity_boxes<T, kTilesElem><<<grid, kU, bytes, stream>>>(v, out, H, W, D, d_valid);
  return 0;
}

// itemsize: 1 (int8 summed volume, offset by -128) or 2 (int16); tiles
// from sgm_cuda.right_disparity_design.
extern "C" int svt_right_disparity(const void* s, void* out, int H, int W, int D, int d_valid,
                                   int itemsize, int tiles, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (itemsize == 1)
    err = launch_boxes<int8_t>(s, (int32_t*)out, H, W, D, d_valid, tiles, st);
  else if (itemsize == 2)
    err = launch_boxes<int16_t>(s, (int32_t*)out, H, W, D, d_valid, tiles, st);
  else
    return (int)cudaErrorInvalidValue;
  return err != 0 ? err : (int)cudaGetLastError();
}

#ifdef SVT_VARIANTS

enum : int { kInPlace = 0, kTransposed = 1, kStaged = 2, kBoxes = 3 };

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

static constexpr int kStagedThreads = 256;
static constexpr int kBandCols = 64;  // image columns of one block
static constexpr int kMaxSharedBytes = 232448;  // what one block may use on Hopper

template <typename T>
__global__ void __launch_bounds__(kStagedThreads)
right_disparity_staged_kernel(const T* __restrict__ s, int32_t* __restrict__ out, int H, int W,
                              int D, int d_valid) {
  extern __shared__ int smem_i[];
  T* band = (T*)smem_i;  // band[d * pitch + u] = s[y, u0 + u + d, d]
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
  smem_i[t] = best;
  smem_i[kStagedThreads + t] = idx;
  __syncthreads();
  if (q == 0 && u0 + u < W) {
    for (int g = 1; g < kstep; ++g) {
      const int v = smem_i[g * bw + u];
      const int i = smem_i[kStagedThreads + g * bw + u];
      if (v < best || (v == best && i < idx)) {
        best = v;
        idx = i;
      }
    }
    out[(long long)y * W + u0 + u] = idx;
  }
}

// Raise the staged kernel's dynamic shared-memory limit to what a block may
// use, once per instance (the first launch; the runtime keeps the setting).
template <typename T>
static cudaError_t staged_limit_once() {
  static const cudaError_t err = cudaFuncSetAttribute(
      right_disparity_staged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSharedBytes);
  return err;
}

template <typename T>
static int launch_variant(const void* s, int32_t* out, int H, int W, int D, int d_valid,
                          int tiles, int variant, cudaStream_t stream) {
  if (variant == kBoxes) return launch_boxes<T>(s, out, H, W, D, d_valid, tiles, stream);
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
  const cudaError_t err = staged_limit_once<T>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kBandCols - 1) / kBandCols, H);
  right_disparity_staged_kernel<T><<<grid, kStagedThreads, bytes, stream>>>((const T*)s, out, H, W,
                                                                             D, d_valid);
  return 0;
}

// One measurement variant (the enum): s is (H, W, D), or (D, H, W) for
// kTransposed; itemsize 1 (int8) or 2 (int16); tiles for kBoxes (as
// svt_right_disparity takes it), ignored by the others.
extern "C" int svt_right_disparity_variant(const void* s, void* out, int H, int W, int D,
                                           int d_valid, int itemsize, int tiles, int variant,
                                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (itemsize == 1)
    err = launch_variant<int8_t>(s, (int32_t*)out, H, W, D, d_valid, tiles, variant, st);
  else if (itemsize == 2)
    err = launch_variant<int16_t>(s, (int32_t*)out, H, W, D, d_valid, tiles, variant, st);
  else
    return (int)cudaErrorInvalidValue;
  return err != 0 ? err : (int)cudaGetLastError();
}

#endif  // SVT_VARIANTS
