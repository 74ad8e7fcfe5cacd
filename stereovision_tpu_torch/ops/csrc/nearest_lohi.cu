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
// written, 17 bytes a position: 15.7 MB at 720x1280 (0.0047 ms at
// 3.35 TB/s) an axis.
//
// Design (scans in registers): a thread loads P consecutive positions of
// one line once and keeps them in registers. The left fill is an
// inclusive max-scan of (valid ? i : -1) and the right fill a suffix
// min-scan of (valid ? i : n), each carrying the value at its index: over
// the thread's own P positions, then across the threads that hold the
// rest of the tile, then from outside the tile. Each position takes its
// two values from registers, and lo and hi are written once: at most 17
// bytes a position (axis 0 reads d_up only where a side has no valid row).
// The block's threads come from sgm_cuda.nearest_lohi_design.
//   axis 1 (nearest_lohi_rows_scan): a block a row, thread t positions Pt ..
// Pt + P - 1 (P = 4) of a tile of up to 2048, in 16-byte loads and stores
// (scalar ones where a row is not 16-byte aligned; P = 8 was slower at
// 1280 columns); five __shfl_up_sync / __shfl_down_sync rounds join a
// warp, shared memory the warps (one barrier). A row longer than the tile
// loops over tiles inside the block: the left carry goes from tile to
// tile, and the right one comes from a sweep over `valid` alone past the
// tile's end (one byte a position, read again from L2; it stops at the
// first valid position and is reused until a tile passes it), so any
// length runs in one launch.
//   axis 0 (nearest_lohi_cols_tile): a block takes 32 adjacent columns (a
// lane each) and a tile of P * warps rows (P = 8; warp w the w-th chunk of
// P rows), so a warp's load or store is a row's 128 contiguous bytes, and
// the grid tiles the rows too: 480 blocks at 720x1280, where blocks of
// whole columns are either 40 (32 columns each) or read narrow runs of a
// row (4 or 8 columns each; measured slower). The warps' chunk totals go
// through shared memory, no shuffle. A column's nearest valid rows above
// and below the tile come from a sweep over `valid` outside it, 2 rows a
// warp each way a round (16 at 8 warps), until every column of the block
// has found both or the map ends: one round where valid rows are dense, a
// few where the 32 columns hold a longer invalid run (the production
// frame's reach 60 rows), the column's length at worst.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define ROW_THREADS 512   // axis 1: a block at most
#define COL_THREADS 512   // axis 0: a block at most
#define ROW_PER 4         // axis 1: positions a thread
#define COL_PER 8         // axis 0: rows a thread
#define SWEEP 2           // axis 0: rows a warp reads each way a round of the sweep

// The carry into a thread from the warps before it (left: the last valid
// index and its value among warps 0 .. w - 1, else the tile's carry) or
// after it (right: the first among warps w + 1 .. nw - 1); ti and tv hold
// each warp's total at stride st.
__device__ __forceinline__ void carry_left(const int* ti, const float* tv, int st, int w, int& ci,
                                           float& cv) {
  for (int k = 0; k < w; ++k)
    if (ti[k * st] >= 0) ci = ti[k * st], cv = tv[k * st];
}

__device__ __forceinline__ void carry_right(const int* ti, const float* tv, int st, int w, int nw,
                                            int& ci, float& cv) {
  for (int k = nw - 1; k > w; --k)
    if (ti[k * st] != INT_MAX) ci = ti[k * st], cv = tv[k * st];
}

// Both fills over a thread's P positions given its carries (left: index <
// 0 for none; right: INT_MAX for none); up(p) gives d_up at position p,
// asked only where a side has no valid position; put(p, lo, hi) takes each
// position's results, the last position first.
template <int P, typename Up, typename Put>
__device__ __forceinline__ void fill(const float (&dv)[P], unsigned ok, int li, float lv, int ri,
                                     float rv, Up up, Put put) {
  float left[P];
  bool has = li >= 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (ok >> p & 1) has = true, lv = dv[p];
    left[p] = has ? lv : up(p);
  }
  has = ri != INT_MAX;
#pragma unroll
  for (int p = P - 1; p >= 0; --p) {
    if (ok >> p & 1) has = true, rv = dv[p];
    const float r = has ? rv : up(p);
    put(p, fminf(left[p], r), fmaxf(left[p], r));
  }
}

// The thread's own last and first valid positions (and values).
template <int P>
__device__ __forceinline__ void ends(const float (&dv)[P], unsigned ok, int i0, int& li, float& lv,
                                     int& ri, float& rv) {
  li = -1, ri = INT_MAX, lv = rv = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (ok >> p & 1) li = i0 + p, lv = dv[p];
#pragma unroll
  for (int p = P - 1; p >= 0; --p)
    if (ok >> p & 1) ri = i0 + p, rv = dv[p];
}

// Inclusive scans across a warp's lanes (lane t holds the t-th chunk of
// the warp's part of the line), then each lane's exclusive carries from
// its neighbours (none at the ends).
__device__ __forceinline__ void warp_scans(int lane, int& li, float& lv, int& ri, float& rv,
                                           int& xli, float& xlv, int& xri, float& xrv) {
  for (int s = 1; s < 32; s <<= 1) {
    const int oi = __shfl_up_sync(FULL_MASK, li, s);
    const float ov = __shfl_up_sync(FULL_MASK, lv, s);
    if (lane >= s && oi > li) li = oi, lv = ov;
    const int qi = __shfl_down_sync(FULL_MASK, ri, s);
    const float qv = __shfl_down_sync(FULL_MASK, rv, s);
    if (lane + s < 32 && qi < ri) ri = qi, rv = qv;
  }
  xli = __shfl_up_sync(FULL_MASK, li, 1);
  xlv = __shfl_up_sync(FULL_MASK, lv, 1);
  xri = __shfl_down_sync(FULL_MASK, ri, 1);
  xrv = __shfl_down_sync(FULL_MASK, rv, 1);
  if (lane == 0) xli = -1;
  if (lane == 31) xri = INT_MAX;
}

template <int P, bool VEC>
__global__ void __launch_bounds__(ROW_THREADS)
nearest_lohi_rows_scan(const float* __restrict__ disp, const uint8_t* __restrict__ valid,
                       const float* __restrict__ d_up, float* __restrict__ lo,
                       float* __restrict__ hi, int W) {
  static_assert(P % 4 == 0, "4 positions a load");
  // each warp's inclusive totals (left: last valid and its value; right:
  // first), by tile parity; and each warp's first valid in a sweep
  __shared__ int s_li[2][32], s_ri[2][32], s_f[32];
  __shared__ float s_lv[2][32], s_rv[2][32];
  const int n = W, nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int T = P * blockDim.x;  // positions a tile
  const long long row = (long long)blockIdx.x * W;
  int lci = -1, rci = -1;  // carries into the tile; rci -1: not looked for yet
  float lcv = 0.0f, rcv = 0.0f;
  for (int a = 0, par = 0; a < n; a += T, par ^= 1) {
    const int b = min(n, a + T);
    const int i0 = a + P * threadIdx.x;
    float dv[P], up[P];
    unsigned ok = 0;
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const int i = i0 + 4 * q;  // W % 4 == 0: the 4 positions lie in the row together
        float4 d4 = make_float4(0.f, 0.f, 0.f, 0.f), u4 = d4;
        uint32_t v4 = 0;
        if (i < n) {
          d4 = *(const float4*)(disp + row + i);
          u4 = *(const float4*)(d_up + row + i);
          v4 = *(const uint32_t*)(valid + row + i);
        }
        dv[4 * q] = d4.x, dv[4 * q + 1] = d4.y, dv[4 * q + 2] = d4.z, dv[4 * q + 3] = d4.w;
        up[4 * q] = u4.x, up[4 * q + 1] = u4.y, up[4 * q + 2] = u4.z, up[4 * q + 3] = u4.w;
#pragma unroll
        for (int k = 0; k < 4; ++k) ok |= (v4 >> (8 * k) & 1u) << (4 * q + k);
      }
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const bool in = i0 + p < n;
        dv[p] = in ? disp[row + i0 + p] : 0.0f;
        up[p] = in ? d_up[row + i0 + p] : 0.0f;
        ok |= (unsigned)(in && valid[row + i0 + p]) << p;
      }
    }
    // the right carry: the first valid position at or past b (none for a
    // line of one tile; else a sweep over `valid` past the last one found)
    if (n <= T) {
      rci = INT_MAX;
    } else {
      for (int c = b; rci < b && c < n; c += T) {  // rci: the same in every thread
        int f = INT_MAX;
        for (int p = P - 1; p >= 0; --p) {
          const int i = c + P * threadIdx.x + p;
          if (i < n && valid[row + i]) f = i;
        }
        f = __reduce_min_sync(FULL_MASK, f);
        if (lane == 0) s_f[w] = f;
        __syncthreads();
        int m = INT_MAX;
        for (int k = 0; k < nw; ++k) m = min(m, s_f[k]);
        if (m != INT_MAX) rci = m, rcv = disp[row + m];
        __syncthreads();  // s_f is written again by the next chunk
      }
      if (rci < b) rci = INT_MAX;  // no valid position past the tile
    }
    int li, ri, xli, xri;
    float lv, rv, xlv, xrv;
    ends(dv, ok, i0, li, lv, ri, rv);
    warp_scans(lane, li, lv, ri, rv, xli, xlv, xri, xrv);
    if (lane == 31) s_li[par][w] = li, s_lv[par][w] = lv;
    if (lane == 0) s_ri[par][w] = ri, s_rv[par][w] = rv;
    __syncthreads();
    if (xli < 0) {
      xli = lci, xlv = lcv;
      carry_left(s_li[par], s_lv[par], 1, w, xli, xlv);
    }
    if (xri == INT_MAX) {
      xri = rci, xrv = rcv;
      carry_right(s_ri[par], s_rv[par], 1, w, nw, xri, xrv);
    }
    if (b < n) carry_left(s_li[par], s_lv[par], 1, nw, lci, lcv);  // into the next tile
    float olo[P], ohi[P];
    fill(dv, ok, xli, xlv, xri, xrv, [&](int p) { return up[p]; },
         [&](int p, float l, float h) { olo[p] = l, ohi[p] = h; });
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const int i = i0 + 4 * q;
        if (i < n) {
          *(float4*)(lo + row + i) = make_float4(olo[4 * q], olo[4 * q + 1], olo[4 * q + 2],
                                                 olo[4 * q + 3]);
          *(float4*)(hi + row + i) = make_float4(ohi[4 * q], ohi[4 * q + 1], ohi[4 * q + 2],
                                                 ohi[4 * q + 3]);
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (i0 + p < n) lo[row + i0 + p] = olo[p], hi[row + i0 + p] = ohi[p];
    }
  }
}

template <int P>
__global__ void __launch_bounds__(COL_THREADS)
nearest_lohi_cols_tile(const float* __restrict__ disp, const uint8_t* __restrict__ valid,
                       const float* __restrict__ d_up, float* __restrict__ lo,
                       float* __restrict__ hi, int H, int W) {
  // each warp's totals of its chunk (left: last valid row and its value;
  // right: first), and each warp's find in a sweep past the tile
  __shared__ int s_li[COL_THREADS / 32][32], s_ri[COL_THREADS / 32][32];
  __shared__ float s_lv[COL_THREADS / 32][32], s_rv[COL_THREADS / 32][32];
  const int nw = blockDim.x >> 5, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int x = 32 * blockIdx.x + lane;
  const bool live = x < W;
  const int a = blockIdx.y * P * nw, b = min(H, a + P * nw);  // the block's rows
  const int i0 = a + w * P;                                   // the thread's
  const long long e0 = (long long)i0 * W + x;
  float dv[P];
  unsigned ok = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bool in = live && i0 + p < H;
    dv[p] = in ? disp[e0 + (long long)p * W] : 0.0f;
    ok |= (unsigned)(in && valid[e0 + (long long)p * W]) << p;
  }
  // the carries from outside the tile: the column's last valid row above a
  // and first at or below b, found by sweeping `valid` away from the tile,
  // SWEEP rows a warp each way a round, until every column of the block
  // has both or the map ends; a round's loads go out before its barrier,
  // so the first round's fly with the tile's
  // -1: not found yet (lci: or none above); -2 and INT_MAX: none to find
  int lci = live && a > 0 ? -1 : -2, rci = live && b < H ? -1 : INT_MAX;
  for (int o = 0;; o += nw * SWEEP) {  // o: rows swept each way
    const bool more = (lci == -1 && a - 1 - o >= 0) || (rci == -1 && b + o < H);
    int f = -1, g = INT_MAX;
#pragma unroll
    for (int j = 0; j < SWEEP; ++j) {
      const int up = a - 1 - o - w * SWEEP - j, dn = b + o + w * SWEEP + j;
      if (lci == -1 && up >= 0 && valid[(long long)up * W + x]) f = max(f, up);
      if (rci == -1 && dn < H && valid[(long long)dn * W + x]) g = min(g, dn);
    }
    // the barrier also orders the previous round's reads before these writes
    if (!__syncthreads_or(more)) break;
    s_li[w][lane] = f;
    s_ri[w][lane] = g;
    __syncthreads();
    int m = -1, q = INT_MAX;
    for (int k = 0; k < nw; ++k) m = max(m, s_li[k][lane]), q = min(q, s_ri[k][lane]);
    if (lci == -1 && (m >= 0 || a - 1 - o - nw * SWEEP < 0)) lci = m;  // found, or none above
    if (rci == -1 && (q != INT_MAX || b + o + nw * SWEEP >= H)) rci = q;
  }
  float lcv = lci >= 0 ? disp[(long long)lci * W + x] : 0.0f;
  float rcv = rci != INT_MAX && rci >= 0 ? disp[(long long)rci * W + x] : 0.0f;
  lci = max(lci, -1);
  // the tile: the thread's own rows, then the warps before and after it
  int li, ri;
  float lv, rv;
  ends(dv, ok, i0, li, lv, ri, rv);
  s_li[w][lane] = li, s_lv[w][lane] = lv, s_ri[w][lane] = ri, s_rv[w][lane] = rv;
  __syncthreads();
  carry_left(&s_li[0][lane], &s_lv[0][lane], 32, w, lci, lcv);
  carry_right(&s_ri[0][lane], &s_rv[0][lane], 32, w, nw, rci, rcv);
  // d_up is read only where a side has no valid row
  auto upv = [&](int p) { return live && i0 + p < H ? d_up[e0 + (long long)p * W] : 0.0f; };
  fill(dv, ok, lci, lcv, rci, rcv, upv, [&](int p, float l, float h) {
    if (live && i0 + p < H) lo[e0 + (long long)p * W] = l, hi[e0 + (long long)p * W] = h;
  });
}

// threads a block from sgm_cuda.nearest_lohi_design: a multiple of 32 up
// to 512; a row's tile is ROW_PER * threads positions, a block's tile of
// 32 columns COL_PER * threads / 32 rows.
extern "C" int svt_nearest_valid_lohi(const void* disp, const void* valid, const void* d_up,
                                      void* lo, void* hi, int H, int W, int axis, int threads,
                                      void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float* d = (const float*)disp;
  const uint8_t* v = (const uint8_t*)valid;
  const float* u = (const float*)d_up;
  float *l = (float*)lo, *h = (float*)hi;
  if (threads < 32 || threads % 32 || threads > (axis == 1 ? ROW_THREADS : COL_THREADS))
    return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return 0;
  if (axis == 1) {
    // 16-byte loads and stores where every row starts 16-byte aligned (4 for valid)
    const bool vec = W % 4 == 0 && (uintptr_t)d % 16 == 0 && (uintptr_t)u % 16 == 0 &&
                     (uintptr_t)l % 16 == 0 && (uintptr_t)h % 16 == 0 && (uintptr_t)v % 4 == 0;
    if (vec)
      nearest_lohi_rows_scan<ROW_PER, true><<<H, threads, 0, st>>>(d, v, u, l, h, W);
    else
      nearest_lohi_rows_scan<ROW_PER, false><<<H, threads, 0, st>>>(d, v, u, l, h, W);
  } else {
    const int rows = COL_PER * threads / 32;  // a block's tile
    if ((H + rows - 1) / rows > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((W + 31) / 32, (H + rows - 1) / rows);
    nearest_lohi_cols_tile<COL_PER><<<grid, threads, 0, st>>>(d, v, u, l, h, H, W);
  }
  return (int)cudaGetLastError();
}
