// Fused weighted-distance + Matern/RBF correlation matrix for Hopper (sm_90a),
// forward and backward.
//
// Replaces the TPU kernel `matern_pallas` / `_matern_tile_kernel` of
// bayesian_optimization_tpu/ops/pallas_kernels.py. The Pallas kernel has no
// backward (the JAX package differentiates its XLA form); here the gradient
// is a kernel too.
//
//   K[b, i, j] = phi_nu(sqrt(r2[b, i, j])),
//   r2[b, i, j] = sum_d w[b, d] (X[i, d] - Y[j, d])^2,  w = max(theta, 0),
//
// with phi for nu in {1/2, 3/2, 5/2}, or exp(-r2) (RBF). `sym` sets an exact
// unit diagonal (training correlation). Every restart lane of the MLE ladder
// has its own theta, so theta carries a leading batch axis b; X and Y are
// shared by all lanes.
//
// Forward. What bounds it on this card: the bytes it writes. At (B, N, M) =
// (10, 1024, 1024), D = 5, it writes 41.9 MB of K (12.5 us at 3.35 TB/s) and
// reads ~40 KB; an element costs ~25 FP32 instructions and two MUFU ops
// (rsqrt, ex2), under the write time at the card's issue rate. The design:
// - a 64 x 128 output tile per block of 256 threads; each thread holds 8 rows
//   x 4 consecutive columns, and writes each row's 4 columns as one 16-byte
//   store, so one warp store covers 512 contiguous bytes of a row;
// - the tile's X and Y rows are staged once, as compact [row][DC] arrays in
//   shared memory (DC = D for D <= 8, a template parameter, fully unrolled;
//   chunks of 8 features above that), with max(theta, 0) beside them; the
//   thread keeps its 4 Y rows in registers;
// - r2 in the direct form sum_d w_d (x_d - y_d)^2 (no GEMM expansion, no
//   cancellation), r = r2 * rsqrt(r2) and exp(-s) = ex2(-s log2 e) on the
//   MUFU unit, the polynomial in multiplications only;
// - plain stores: the next op reads K at once, and at batch <= 2 all of it
//   fits in the 50 MB L2. The ragged edge is masked (scalar stores when M is
//   not a multiple of 4).
//
// Backward. For G = dL/dK (B, N, M) and A = G * dK/dr2 (zero on the unit
// diagonal and, for Matern, where r2 <= 1e-30, as the JAX package's
// _safe_sqrt makes it), with d_ijk = x_ik - y_jk:
//   dtheta[b, k] = [theta[b, k] > 0] sum_ij A_bij d_ijk^2,
//   dX[i, k]     =  2 sum_b w_bk sum_j A_bij d_ijk,
//   dY[j, k]     = -2 sum_b w_bk sum_i A_bij d_ijk.
// What bounds it: the bytes of G, read once (8.4 MB, 2.5 us, at the warm
// refit's (2, 1024, 1024)). r2 is recomputed in registers in the forward's
// direct form, so nothing of size (B, N, M) but G is read or written, and K
// is not needed. A 32 x 128 tile per block, 4 x 4 elements a thread: the
// thread's G is loaded first, as float4, and stays in registers (64 of
// them for dtheta alone, four blocks an SM) while the tile's X and Y rows
// are staged; each element's differences then give r2, dK/dr2, A and the
// sums in one pass (D <= 8). The sums are deterministic, with no atomics:
// each block reduces its tile (warp shuffles, then shared memory, in a
// fixed order) to partial sums in a scratch buffer -- per lane and feature
// for dtheta, per row for dX, per column for dY -- and a second launch sums
// the partials in a fixed order and applies the weights. Two launches per
// backward.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                    // columns per thread: one 16-byte access
constexpr int kTileN = 32 * kCols;          // 128 columns per block, one warp per row
constexpr int kFwdRows = 8;                 // rows per thread, forward: 64-row tiles
constexpr int kBwdRows = 4;                 // backward: 32-row tiles (G stays in registers)
constexpr int kMaxDC = 8;                   // features per register chunk
constexpr float kR2Floor = 1e-30f;          // the clamp of r2 before the root
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.23606797749979f;

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_mufu(float x) {  // 1/sqrt(x), one MUFU op
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max(x, y) that returns NaN for a NaN x, as torch's clamp_min does
__device__ __forceinline__ float max_nan(float x, float y) {
  float z;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(z) : "f"(x), "f"(y));
  return z;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// CODE: 1 -> nu = 1/2, 3 -> nu = 3/2, 5 -> nu = 5/2, 0 -> RBF.
template <int CODE>
__device__ __forceinline__ float kernel_map(float r2) {
  if (CODE == 0) return ex2(-kLog2e * r2);
  const float rc = max_nan(r2, kR2Floor);
  const float r = rc * rsqrt_mufu(rc);
  if (CODE == 1) return ex2(-kLog2e * r);
  if (CODE == 3) return fmaf(kSqrt3, r, 1.0f) * ex2((-kLog2e * kSqrt3) * r);
  const float s = kSqrt5 * r;
  return fmaf(s, fmaf(s, 1.0f / 3.0f, 1.0f), 1.0f) * ex2((-kLog2e * kSqrt5) * r);
}

// dK/dr2 of the map, zero where r2 <= 1e-30 for Matern (singular for nu = 1/2).
template <int CODE>
__device__ __forceinline__ float dk_dr2(float r2) {
  if (CODE == 0) return -ex2(-kLog2e * r2);
  const float rc = max_nan(r2, kR2Floor);
  const float rs = rsqrt_mufu(rc);
  const float r = rc * rs;
  float h;
  if (CODE == 1) {
    h = -0.5f * rs * ex2(-kLog2e * r);  // -exp(-r) / (2 r)
  } else if (CODE == 3) {
    h = -1.5f * ex2((-kLog2e * kSqrt3) * r);
  } else {
    h = (-5.0f / 6.0f) * fmaf(kSqrt5, r, 1.0f) * ex2((-kLog2e * kSqrt5) * r);
  }
  return r2 > kR2Floor ? h : 0.0f;
}

// Stage features [d0, d0 + DC) of the block's X rows (kWarps * ROWS of
// them) and Y rows as compact [row][DC] arrays, and w = max(theta_b, 0)
// beside them; zeros past the ragged edge and past D, which add nothing.
template <int DC, int ROWS>
__device__ __forceinline__ void stage(float* xs, float* ys, float* ws, const float* __restrict__ X,
                                      const float* __restrict__ Y, const float* __restrict__ th_b,
                                      int i0, int j0, int N, int M, int D, int d0) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kWarps * ROWS * DC; e += kThreads) {
    const int r = e / DC, c = e % DC;
    xs[e] = (i0 + r < N && d0 + c < D) ? X[(size_t)(i0 + r) * D + d0 + c] : 0.0f;
  }
  for (int e = tid; e < kTileN * DC; e += kThreads) {
    const int r = e / DC, c = e % DC;
    ys[e] = (j0 + r < M && d0 + c < D) ? Y[(size_t)(j0 + r) * D + d0 + c] : 0.0f;
  }
  if (tid < DC) ws[tid] = d0 + tid < D ? max_nan(th_b[d0 + tid], 0.0f) : 0.0f;
}

// The thread's 4 Y rows of the staged chunk: column lane * kCols + q.
template <int DC>
__device__ __forceinline__ void load_y(float (&y)[kCols][DC], const float* ys) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kCols; ++q)
#pragma unroll
    for (int c = 0; c < DC; ++c) y[q][c] = ys[(lane * kCols + q) * DC + c];
}

// acc[r][q] += sum_c w_c (x_c - y_c)^2 over the staged chunk, for the
// thread's rows r (row r * kWarps + warp of the tile) and columns q. Rows
// past N are skipped (warp-uniform).
template <int DC, int ROWS>
__device__ __forceinline__ void add_sq_dist(float (&acc)[ROWS][kCols], const float* xs,
                                            const float* ys, const float* ws, int i0, int N) {
  const int warp = threadIdx.x >> 5;
  float w[DC], y[kCols][DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) w[c] = ws[c];
  load_y<DC>(y, ys);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int rr = r * kWarps + warp;
    if (i0 + rr >= N) break;
    float x[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) x[c] = xs[rr * DC + c];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      float a = acc[r][q];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float diff = x[c] - y[q][c];
        a = fmaf(w[c], diff * diff, a);
      }
      acc[r][q] = a;
    }
  }
}

template <int DC, int CODE>
__global__ void __launch_bounds__(kThreads)
matern_fwd_kernel(const float* __restrict__ theta, const float* __restrict__ X,
                  const float* __restrict__ Y, float* __restrict__ K, int N, int M, int Dn,
                  int sym, int vec) {
  const int D = DC < kMaxDC ? DC : Dn;  // DC < 8 means D = DC: a constant, one chunk
  constexpr int kTileM = kWarps * kFwdRows;
  __shared__ float xs[kTileM * DC];
  __shared__ float ys[kTileN * DC];
  __shared__ float ws[DC];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTileM;
  const int j0 = blockIdx.x * kTileN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float acc[kFwdRows][kCols] = {};
  for (int d0 = 0; d0 < D; d0 += DC) {
    if (d0 > 0) __syncthreads();  // the previous chunk is consumed
    stage<DC, kFwdRows>(xs, ys, ws, X, Y, theta + (size_t)b * D, i0, j0, N, M, D, d0);
    __syncthreads();
    add_sq_dist<DC, kFwdRows>(acc, xs, ys, ws, i0, N);
  }

  float* Kb = K + (size_t)b * N * M;
  const int j = j0 + lane * kCols;
  const bool diag = sym && i0 < j0 + kTileN && j0 < i0 + kTileM;
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r) {
    const int i = i0 + r * kWarps + warp;
    if (i >= N) break;
    float v[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      v[q] = kernel_map<CODE>(acc[r][q]);
      if (diag && i == j + q) v[q] = 1.0f;
    }
    float* row = Kb + (size_t)i * M + j;
    if (vec) {
      if (j < M) *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        if (j + q < M) row[q] = v[q];
    }
  }
}

// Px[b][jt][i][d0 + c] = rowp[c] summed over the warp (the tile's columns).
template <int DC>
__device__ __forceinline__ void write_row_partial(float (&rowp)[DC], float* __restrict__ Px,
                                                  int b, int jt, int nJt, int i, int N, int D,
                                                  int d0) {
#pragma unroll
  for (int c = 0; c < DC; ++c) rowp[c] = warp_sum(rowp[c]);
  if ((threadIdx.x & 31) == 0) {
    float* px = Px + (((size_t)b * nJt + jt) * N + i) * D + d0;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (d0 + c < D) px[c] = rowp[c];
  }
}

// The block's partials for features [d0, d0 + DC), warps added in a fixed
// order through shared memory: Pt[b][it][jt][k] from tacc and, with need_y,
// Py[b][it][j][k] from col (column sums over the tile's rows).
template <int DC, bool THETA_ONLY>
__device__ __forceinline__ void write_tile_partials(float (&tacc)[DC], float (&col)[kCols][DC],
                                                    float* red, float* __restrict__ Pt,
                                                    float* __restrict__ Py, int b, int it,
                                                    int jt, int nIt, int nJt, int j0, int M,
                                                    int D, int d0, int need_y) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (!THETA_ONLY && need_y) {
#pragma unroll
    for (int q = 0; q < kCols; ++q)
#pragma unroll
      for (int c = 0; c < DC; ++c) red[(warp * kTileN + lane * kCols + q) * DC + c] = col[q][c];
    __syncthreads();
    for (int e = tid; e < kTileN * DC; e += kThreads) {
      const int jj = e / DC, c = e % DC;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * kTileN * DC + e];
      if (j0 + jj < M && d0 + c < D) Py[(((size_t)b * nIt + it) * M + j0 + jj) * D + d0 + c] = s;
    }
    __syncthreads();  // red is reused below
  }
#pragma unroll
  for (int c = 0; c < DC; ++c) tacc[c] = warp_sum(tacc[c]);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < DC; ++c) red[warp * DC + c] = tacc[c];
  }
  __syncthreads();
  if (tid < DC && d0 + tid < D) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * DC + tid];
    Pt[(((size_t)b * nIt + it) * nJt + jt) * D + d0 + tid] = s;
  }
}

// One block per (b, row tile, column tile). Writes, for its tile:
//   Pt[b][it][jt][k] = sum_ij A d_k^2               (always),
//   Px[b][jt][i][k]  = sum_j A d_k over its columns  (need_x),
//   Py[b][it][j][k]  = sum_i A d_k over its rows     (need_y).
// THETA_ONLY (the fit's case) computes the first alone. For D <= DC (all
// features in registers) each element is visited once: its differences
// give r2, A, and the sums. Above that, r2 is summed over the feature
// chunks first, then the sums are taken chunk by chunk.
template <int DC, int CODE, bool THETA_ONLY>
__global__ void __launch_bounds__(kThreads)
matern_bwd_kernel(const float* __restrict__ theta, const float* __restrict__ X,
                  const float* __restrict__ Y, const float* __restrict__ G,
                  float* __restrict__ Pt, float* __restrict__ Px, float* __restrict__ Py, int N,
                  int M, int Dn, int sym, int vec, int need_x, int need_y) {
  const int D = DC < kMaxDC ? DC : Dn;  // DC < 8 means D = DC: a constant, one chunk
  constexpr int kTileM = kWarps * kBwdRows;
  __shared__ float xs[kTileM * DC];
  __shared__ float ys[kTileN * DC];
  __shared__ float ws[DC];
  __shared__ float red[THETA_ONLY ? kWarps * DC : kWarps * kTileN * DC];
  const int b = blockIdx.z, it = blockIdx.y, jt = blockIdx.x;
  const int nIt = gridDim.y, nJt = gridDim.x;
  const int i0 = it * kTileM, j0 = jt * kTileN;
  const int warp = threadIdx.x >> 5;
  const int j = j0 + (threadIdx.x & 31) * kCols;
  const float* th_b = theta + (size_t)b * D;

  // G, read once, issued first so that the loads overlap the staging
  float a[kBwdRows][kCols];
  const float* Gb = G + (size_t)b * N * M;
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) {
    const int i = i0 + r * kWarps + warp;
    const float* row = Gb + (size_t)i * M + j;
    if (i < N && vec && j < M) {
      const float4 g = *reinterpret_cast<const float4*>(row);
      a[r][0] = g.x;
      a[r][1] = g.y;
      a[r][2] = g.z;
      a[r][3] = g.w;
    } else {
#pragma unroll
      for (int q = 0; q < kCols; ++q) a[r][q] = (i < N && j + q < M) ? row[q] : 0.0f;
    }
  }
  stage<DC, kBwdRows>(xs, ys, ws, X, Y, th_b, i0, j0, N, M, D, 0);
  __syncthreads();

  if (D <= DC) {
    float w[DC], y[kCols][DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) w[c] = ws[c];
    load_y<DC>(y, ys);
    float tacc[DC] = {}, col[kCols][DC] = {};
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const int rr = r * kWarps + warp;
      const int i = i0 + rr;
      if (i >= N) break;
      float x[DC], rowp[DC] = {};
#pragma unroll
      for (int c = 0; c < DC; ++c) x[c] = xs[rr * DC + c];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        float diff[DC], t[DC], r2 = 0.0f;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          diff[c] = x[c] - y[q][c];
          t[c] = diff[c] * diff[c];
          r2 = fmaf(w[c], t[c], r2);
        }
        const float A = (sym && i == j + q) ? 0.0f : a[r][q] * dk_dr2<CODE>(r2);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          tacc[c] = fmaf(A, t[c], tacc[c]);
          if (!THETA_ONLY) {
            const float u = A * diff[c];
            rowp[c] += u;
            col[q][c] += u;
          }
        }
      }
      if (!THETA_ONLY && need_x) write_row_partial<DC>(rowp, Px, b, jt, nJt, i, N, D, 0);
    }
    write_tile_partials<DC, THETA_ONLY>(tacc, col, red, Pt, Py, b, it, jt, nIt, nJt, j0, M, D,
                                        0, need_y);
    return;
  }

  // D > DC: r2 over every chunk, then A = G dK/dr2, then the sums per chunk
  float r2[kBwdRows][kCols] = {};
  add_sq_dist<DC, kBwdRows>(r2, xs, ys, ws, i0, N);
  for (int d0 = DC; d0 < D; d0 += DC) {
    __syncthreads();
    stage<DC, kBwdRows>(xs, ys, ws, X, Y, th_b, i0, j0, N, M, D, d0);
    __syncthreads();
    add_sq_dist<DC, kBwdRows>(r2, xs, ys, ws, i0, N);
  }
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) {
    const int i = i0 + r * kWarps + warp;
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      a[r][q] = (sym && i == j + q) ? 0.0f : a[r][q] * dk_dr2<CODE>(r2[r][q]);
  }
  for (int d0 = 0; d0 < D; d0 += DC) {
    __syncthreads();
    stage<DC, kBwdRows>(xs, ys, ws, X, Y, th_b, i0, j0, N, M, D, d0);
    __syncthreads();
    float y[kCols][DC];
    load_y<DC>(y, ys);
    float tacc[DC] = {}, col[kCols][DC] = {};
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const int rr = r * kWarps + warp;
      const int i = i0 + rr;
      if (i >= N) break;
      float x[DC], rowp[DC] = {};
#pragma unroll
      for (int c = 0; c < DC; ++c) x[c] = xs[rr * DC + c];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float diff = x[c] - y[q][c];
          tacc[c] = fmaf(a[r][q], diff * diff, tacc[c]);
          if (!THETA_ONLY) {
            const float u = a[r][q] * diff;
            rowp[c] += u;
            col[q][c] += u;
          }
        }
      }
      if (!THETA_ONLY && need_x) write_row_partial<DC>(rowp, Px, b, jt, nJt, i, N, D, d0);
    }
    write_tile_partials<DC, THETA_ONLY>(tacc, col, red, Pt, Py, b, it, jt, nIt, nJt, j0, M, D,
                                        d0, need_y);
  }
}

// -2 sum_b w_bk sum_it Py[b][it][j][k]
__device__ __forceinline__ float grad_y(const float* __restrict__ theta,
                                       const float* __restrict__ Py, int B, int M, int D,
                                       int nIt, int j, int k) {
  float g = 0.0f;
  for (int b = 0; b < B; ++b) {
    float s = 0.0f;
    for (int it = 0; it < nIt; ++it) s += Py[(((size_t)b * nIt + it) * M + j) * D + k];
    g += max_nan(theta[b * D + k], 0.0f) * s;
  }
  return -2.0f * g;
}

// Sums the partials of matern_bwd_kernel in a fixed order. Threads, in
// order: one warp per (b, k) of dtheta (need_t), one thread per (i, k) of dX
// (need_x; plus the Y side when Y is X), one per (j, k) of dY (need_y, Y not X).
__global__ void __launch_bounds__(kThreads)
matern_bwd_finalize(const float* __restrict__ theta, const float* __restrict__ Pt,
                    const float* __restrict__ Px, const float* __restrict__ Py,
                    float* __restrict__ dtheta, float* __restrict__ dX, float* __restrict__ dY,
                    int B, int N, int M, int D, int nIt, int nJt, int same, int need_t,
                    int need_x, int need_y) {
  long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n_t = need_t ? (long long)B * D * 32 : 0;
  if (g < n_t) {  // whole warps: n_t and the block are multiples of 32
    const int bk = (int)(g >> 5), lane = threadIdx.x & 31;
    const int b = bk / D, k = bk % D;
    const int tiles = nIt * nJt;
    float s = 0.0f;
    for (int t = lane; t < tiles; t += 32) s += Pt[((size_t)b * tiles + t) * D + k];
    s = warp_sum(s);
    if (lane == 0) dtheta[bk] = s * (theta[bk] > 0.0f ? 1.0f : 0.0f);
    return;
  }
  g -= n_t;
  const long long n_x = need_x ? (long long)N * D : 0;
  if (g < n_x) {
    const int i = (int)(g / D), k = (int)(g % D);
    float gx = 0.0f;
    for (int b = 0; b < B; ++b) {
      float s = 0.0f;
      for (int jt = 0; jt < nJt; ++jt) s += Px[(((size_t)b * nJt + jt) * N + i) * D + k];
      gx += max_nan(theta[b * D + k], 0.0f) * s;
    }
    gx *= 2.0f;
    if (same) gx += grad_y(theta, Py, B, M, D, nIt, i, k);  // Y is X: both sides move
    dX[g] = gx;
    return;
  }
  g -= n_x;
  if (need_y && !same && g < (long long)M * D) {
    dY[g] = grad_y(theta, Py, B, M, D, nIt, (int)(g / D), (int)(g % D));
  }
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<DC>, Int<CODE>) for DC = min(D, 8) and the nu code.
template <int DC, typename F>
int with_code(int code, F&& f) {
  switch (code) {
    case 0: return f(Int<DC>{}, Int<0>{});
    case 1: return f(Int<DC>{}, Int<1>{});
    case 3: return f(Int<DC>{}, Int<3>{});
    default: return f(Int<DC>{}, Int<5>{});
  }
}

template <typename F>
int with_dc_code(int D, int code, F&& f) {
  switch (D < kMaxDC ? D : kMaxDC) {
    case 1: return with_code<1>(code, f);
    case 2: return with_code<2>(code, f);
    case 3: return with_code<3>(code, f);
    case 4: return with_code<4>(code, f);
    case 5: return with_code<5>(code, f);
    case 6: return with_code<6>(code, f);
    case 7: return with_code<7>(code, f);
    default: return with_code<8>(code, f);
  }
}

long long row_tiles(int N, int rows) { return (N + kWarps * rows - 1) / (kWarps * rows); }
long long col_tiles(int M) { return (M + kTileN - 1) / kTileN; }

// Whether rows of M floats from p can be accessed as float4
int rows_vec4(const void* p, int M) {
  return M % kCols == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// theta: (B, D), X: (N, D), Y: (M, D), K: (B, N, M); all float32, contiguous;
// nu_code in {0, 1, 3, 5}; D >= 1. Returns the cudaError_t of the launch.
extern "C" int botorch_matern(const void* theta, const void* X, const void* Y, void* K, int B,
                              int N, int M, int D, int nu_code, int sym, void* stream) {
  const dim3 grid((unsigned)col_tiles(M), (unsigned)row_tiles(N, kFwdRows), B);
  return with_dc_code(D, nu_code, [&](auto dc, auto code) {
    matern_fwd_kernel<decltype(dc)::value, decltype(code)::value>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>((const float*)theta, (const float*)X,
                                                       (const float*)Y, (float*)K, N, M, D, sym,
                                                       rows_vec4(K, M));
    return (int)cudaGetLastError();
  });
}

// Floats of scratch that botorch_matern_bwd needs for these shapes.
extern "C" long long botorch_matern_bwd_scratch(int B, int N, int M, int D) {
  const long long nIt = row_tiles(N, kBwdRows), nJt = col_tiles(M);
  return (long long)B * D * (nIt * nJt + nJt * N + nIt * M);
}

// The gradients of botorch_matern's K for G = dL/dK (B, N, M), float32,
// contiguous. dtheta (B, D), dX (N, D), dY (M, D) are written where
// need_t, need_x, need_y ask (each may be null otherwise); when Y is X
// (same), need_y must be set with need_x, and dX carries both sides while
// dY is not written. scratch holds botorch_matern_bwd_scratch(...) floats.
// Two launches. Returns the first non-zero cudaError_t, or 0.
extern "C" int botorch_matern_bwd(const void* theta, const void* X, const void* Y, const void* G,
                                  void* scratch, void* dtheta, void* dX, void* dY, int B, int N,
                                  int M, int D, int nu_code, int sym, int same, int need_t,
                                  int need_x, int need_y, void* stream) {
  const long long nIt = row_tiles(N, kBwdRows), nJt = col_tiles(M);
  float* Pt = (float*)scratch;
  float* Px = Pt + (size_t)B * nIt * nJt * D;
  float* Py = Px + (size_t)B * nJt * N * D;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)nJt, (unsigned)nIt, B);
  const bool theta_only = !need_x && !need_y;
  const int vec = rows_vec4(G, M);
  int err = with_dc_code(D, nu_code, [&](auto dc, auto code) {
    constexpr int DC = decltype(dc)::value, CODE = decltype(code)::value;
    if (theta_only) {
      matern_bwd_kernel<DC, CODE, true><<<grid, kThreads, 0, s>>>(
          (const float*)theta, (const float*)X, (const float*)Y, (const float*)G, Pt, Px, Py, N,
          M, D, sym, vec, 0, 0);
    } else {
      matern_bwd_kernel<DC, CODE, false><<<grid, kThreads, 0, s>>>(
          (const float*)theta, (const float*)X, (const float*)Y, (const float*)G, Pt, Px, Py, N,
          M, D, sym, vec, need_x, need_y);
    }
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  const long long threads = (need_t ? (long long)B * D * 32 : 0) + (need_x ? (long long)N * D : 0) +
                            (need_y && !same ? (long long)M * D : 0);
  if (threads == 0) return 0;
  matern_bwd_finalize<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      (const float*)theta, Pt, Px, Py, (float*)dtheta, (float*)dX, (float*)dY, B, N, M, D,
      (int)nIt, (int)nJt, same, need_t, need_x, need_y);
  return (int)cudaGetLastError();
}

// Human-readable name of a cudaError_t returned by the entry points above.
extern "C" const char* botorch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
