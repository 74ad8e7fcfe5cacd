// Nearest valid value along each line, from both sides, and their min and
// max: for a line of (H, W) float32 disp, bool valid and float32 d_up,
//   lv[i] = disp[j] for the largest valid j <= i, d_up[i] if there is none
//   rv[i] = disp[j] for the smallest valid j >= i, d_up[i] if there is none
//   lo = min(lv, rv), hi = max(lv, rv).
// axis 1 runs along the rows, axis 0 along the columns.
//
// Replaces: stereovision_tpu/ops/sgm_pallas.py:nearest_valid_lohi
// (_nearest_lohi_kernel). The TPU kernel fills by log2(W) levels of lane
// rotates (jump pointers) along rows only, and the vertical direction runs
// on two XLA transposes. Here a line's fill is a scan of indices, and
// axis 0 reads the columns in place.
//
// Bound on this card: bytes, 3 maps read (float32, bool, float32) and 2
// written: 16.6 MB at 720x1280 (~5 us at 3.35 TB/s) per axis.
//
// Design: a line is cut into chunks of consecutive positions, a thread
// each. The left fill is an inclusive max-scan of (valid ? i : -1) and the
// right fill a suffix min-scan of (valid ? i : n): each thread reduces its
// chunk, the chunk totals give each chunk its carry-ins, a forward walk over
// the chunk writes each position's left value into lo, and a backward walk
// reads it back (the same thread: no barrier), finds the right value and
// writes lo and hi. No per-position array lives in shared memory, so a line
// may have any length. Each pass goes in batches of 8 positions whose loads
// (lo's too) are all issued before the batch's stores: a store to lo may
// not pass a load of it, so one position at a time would wait out a round
// trip each.
//   axis 1 (nearest_lohi_rows): a block of 256 threads a row, thread t the
// t-th chunk; a Hillis-Steele scan over the 256 chunk totals in shared
// memory gives the carry-ins.
//   axis 0 (nearest_lohi_cols): a block takes 32 adjacent columns, a lane
// each, and its 16 warps cut them into 16 chunks of rows, so a warp's every
// load and store is 32 adjacent elements of a row (coalesced; a block a
// column would touch a 32-byte sector for every 4 bytes it uses); a
// thread's carry-ins are the max and the min over the chunk totals above
// and below it in its column.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256  // axis 1: a block a row
#define COLS 32      // axis 0: columns a block, one a lane
#define CHUNKS 16    // axis 0: row chunks a block, one a warp
#define BATCH 8      // positions whose loads a pass issues together

// The last and the first valid position of chunk [i0, i1) of a line (-1 and
// n where there is none).
__device__ __forceinline__ void chunk_ends(const uint8_t* __restrict__ valid, long long base,
                                           long long stride, int i0, int i1, int n, int& last,
                                           int& first) {
  last = -1;
  first = n;
  for (int i = i0; i < i1; i += BATCH) {
    bool ok[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) ok[j] = i + j < i1 && valid[base + (i + j) * stride];
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (ok[j]) {
        last = i + j;
        if (first == n) first = i + j;
      }
  }
}

// Both walks over chunk [i0, i1) of a line, given the nearest valid
// position left of the chunk (cl, -1 for none) and right of it (cr, n for
// none).
__device__ __forceinline__ void walk(const float* __restrict__ disp,
                                     const uint8_t* __restrict__ valid,
                                     const float* __restrict__ d_up, float* __restrict__ lo,
                                     float* __restrict__ hi, long long base, long long stride,
                                     int i0, int i1, int n, int cl, int cr) {
  // forward: the left value of each position, parked in lo
  bool has = cl >= 0;
  float v = has ? disp[base + cl * stride] : 0.0f;
  for (int i = i0; i < i1; i += BATCH) {
    bool ok[BATCH];
    float dv[BATCH], up[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const long long a = base + (i + j) * stride;
      ok[j] = i + j < i1 && valid[a];
      dv[j] = i + j < i1 ? disp[a] : 0.0f;
      up[j] = i + j < i1 ? d_up[a] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (ok[j]) {
        has = true;
        v = dv[j];
      }
      if (i + j < i1) lo[base + (i + j) * stride] = has ? v : up[j];
    }
  }
  // backward: the right value, against the left one read back from lo
  has = cr < n;
  v = has ? disp[base + cr * stride] : 0.0f;
  for (int i = i1 - 1; i >= i0; i -= BATCH) {
    bool ok[BATCH];
    float dv[BATCH], up[BATCH], lv[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const long long a = base + (i - j) * stride;
      ok[j] = i - j >= i0 && valid[a];
      dv[j] = i - j >= i0 ? disp[a] : 0.0f;
      up[j] = i - j >= i0 ? d_up[a] : 0.0f;
      lv[j] = i - j >= i0 ? lo[a] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (ok[j]) {
        has = true;
        v = dv[j];
      }
      if (i - j >= i0) {
        const long long a = base + (i - j) * stride;
        const float rv = has ? v : up[j];
        lo[a] = fminf(lv[j], rv);
        hi[a] = fmaxf(lv[j], rv);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
nearest_lohi_rows(const float* __restrict__ disp, const uint8_t* __restrict__ valid,
                  const float* __restrict__ d_up, float* __restrict__ lo, float* __restrict__ hi,
                  int n) {
  __shared__ int s_l[THREADS];  // prefix max of the chunks' last valid
  __shared__ int s_r[THREADS];  // suffix min of the chunks' first valid
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * n;
  const int c = (n + THREADS - 1) / THREADS;
  const int i0 = min(n, t * c), i1 = min(n, i0 + c);
  int last, first;
  chunk_ends(valid, base, 1, i0, i1, n, last, first);
  s_l[t] = last;
  s_r[t] = first;
  __syncthreads();
  for (int k = 1; k < THREADS; k <<= 1) {
    const int a = t >= k ? s_l[t - k] : -1;
    const int b = t + k < THREADS ? s_r[t + k] : n;
    __syncthreads();
    s_l[t] = max(s_l[t], a);
    s_r[t] = min(s_r[t], b);
    __syncthreads();
  }
  walk(disp, valid, d_up, lo, hi, base, 1, i0, i1, n, t > 0 ? s_l[t - 1] : -1,
       t + 1 < THREADS ? s_r[t + 1] : n);
}

__global__ void __launch_bounds__(COLS * CHUNKS)
nearest_lohi_cols(const float* __restrict__ disp, const uint8_t* __restrict__ valid,
                  const float* __restrict__ d_up, float* __restrict__ lo, float* __restrict__ hi,
                  int H, int W) {
  __shared__ int s_l[CHUNKS][COLS];  // each chunk's last valid row
  __shared__ int s_r[CHUNKS][COLS];  // each chunk's first valid row
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * COLS + tx;
  const bool live = x < W;
  const int c = (H + CHUNKS - 1) / CHUNKS;
  const int i0 = min(H, ty * c), i1 = min(H, i0 + c);
  int last = -1, first = H;
  if (live) chunk_ends(valid, x, W, i0, i1, H, last, first);
  s_l[ty][tx] = last;
  s_r[ty][tx] = first;
  __syncthreads();
  if (!live) return;  // no barrier follows
  int cl = -1, cr = H;
  for (int j = 0; j < ty; ++j) cl = max(cl, s_l[j][tx]);
  for (int j = ty + 1; j < CHUNKS; ++j) cr = min(cr, s_r[j][tx]);
  walk(disp, valid, d_up, lo, hi, x, W, i0, i1, H, cl, cr);
}

extern "C" int svt_nearest_valid_lohi(const void* disp, const void* valid, const void* d_up,
                                      void* lo, void* hi, int H, int W, int axis,
                                      void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float* d = (const float*)disp;
  const uint8_t* v = (const uint8_t*)valid;
  const float* u = (const float*)d_up;
  if (axis == 1)
    nearest_lohi_rows<<<H, THREADS, 0, st>>>(d, v, u, (float*)lo, (float*)hi, W);
  else
    nearest_lohi_cols<<<(W + COLS - 1) / COLS, dim3(COLS, CHUNKS), 0, st>>>(
        d, v, u, (float*)lo, (float*)hi, H, W);
  return (int)cudaGetLastError();
}
