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
// What bounds it: the bytes of G, read once (33.6 MB, 10.0 us, at the
// sampler's (8, 1024, 1024)); the FP32 work of the fit's dtheta (~30
// instructions an element at D = 5, 8.5 us of issue there at the card's
// peak) is close behind, so the arithmetic has to shrink and overlap the
// reading of G. r2 is recomputed in registers in the forward's direct form,
// so nothing of size (B, N, M) but G is read or written, and K is not
// needed. The design, one launch a call:
// - persistent blocks, two an SM (one when dX or dY is asked, whose sums
//   need ~210 registers at 8 features): P blocks per lane b, each walking a
//   contiguous run of that lane's tiles;
// - G streamed through a ring of shared-memory stages with cp.async: while
//   a tile is computed, the next tiles' G (16-byte copies where G's rows
//   allow, else 4-byte ones, zero-filled past the ragged edge) and their X
//   and Y rows are in flight;
// - the fit's case, dtheta alone of K(X, X) with D <= 8
//   (matern_bwd_sym_kernel): h and d^2 are symmetric in (i, j), so only the
//   64 x 64 blocks on and above the diagonal are computed, each with
//   G_ij + G_ji read from the mirrored block: half the arithmetic, G still
//   read once; a ring of 3 stages;
// - every other case (matern_bwd_kernel): a block owns a row tile of 8 rpw
//   rows (rpw = 4 rows a warp, fewer when that leaves fewer blocks than the
//   card holds, as at the argmax's 25 query rows) and walks up to 8 of its
//   128-column tiles (all of them for one lane: the argmax's case), a ring
//   of 4 stages; each element's differences give r2, dK/dr2, A and the sums
//   in one pass (D <= 8; above that r2 first, then the sums, in chunks of 8
//   features); its rows' dX sums build up in shared memory across its
//   tiles, so a block that holds all of its rows' tiles writes dX itself;
// - the dtheta sums stay in registers across a block's tiles;
// - deterministic sums, no floating-point atomics: whatever is summed
//   across blocks (dtheta partials, dX row sums, dY column sums with the
//   warps added in a fixed order through shared memory, weighted by w_bk)
//   goes to scratch, and the last block of the grid to arrive (an arrival
//   counter in device memory, last_block.cuh) adds it up in a fixed order;
//   a call whose blocks each hold all of their outputs' work (the argmax's
//   dX, a small fit's dtheta) needs no counter at all. Repeated calls are
//   bit-identical.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "last_block.cuh"


namespace {

constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                    // columns per thread: one 16-byte access
constexpr int kTileN = 32 * kCols;          // 128 columns per block, one warp per row
constexpr int kFwdRows = 8;                 // rows per thread, forward: 64-row tiles
constexpr int kBwdRows = 4;                 // backward: at most 4 rows a warp, 32-row tiles
constexpr int kStages = 4;                  // backward: the ring of G tiles in shared memory
constexpr int kBlocksPerSm = 2;             // backward: persistent blocks an SM (bwd_blocks_per_sm)
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

// dK/dr2 of the map, zero where r2 <= 1e-30 for Matern (singular for nu = 1/2;
// r2 is not clamped first, as the select discards whatever a tiny r2 gives).
template <int CODE>
__device__ __forceinline__ float dk_dr2(float r2) {
  if (CODE == 0) return -ex2(-kLog2e * r2);
  const float rs = rsqrt_mufu(r2);
  const float r = r2 * rs;
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

// ------------------------------------------------------------------ backward

constexpr int kRingRows = kWarps * kBwdRows;  // rows of G a ring stage holds

// Blocks an SM of matern_bwd_kernel in mode 0 (dtheta alone), 1 (with dX) or
// 2 (with dY) at DC features: two, within 128 registers a thread, except
// where the sums need more without spilling (mode 2: ~185-235 registers;
// mode 1 at 8 features: 476 bytes of spills at 128).
__host__ __device__ constexpr int bwd_blocks_per_sm(int mode, int dc) {
  return mode == 2 || (mode == 1 && dc == kMaxDC) ? 1 : kBlocksPerSm;
}

// Floats of one ring stage: the G block [32][128], then the tile's X rows
// [32][DC] and Y rows [128][DC] (all features in one chunk).
template <int DC>
__host__ __device__ constexpr int stage_floats() {
  return kRingRows * kTileN + (kRingRows + kTileN) * DC;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global src to shared dst, asynchronously; zeros, nothing read,
// where !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes, the same way
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of a rows x cols block of the row-major A (ld floats a
// row): rows r0 + [0, rows), columns c0 + [0, cols), zeros past n_rows and
// n_cols, into dst as rows of cols floats; 16-byte copies where A's rows
// allow (vec), else 4-byte ones. With swz, 16-byte chunk c of row r lands at
// chunk c ^ (r / 4), so that a warp reading down the block's columns (lane t
// reading rows 4 t + q) meets no bank conflict.
__device__ __forceinline__ void issue_block(float* dst, const float* __restrict__ A, int r0,
                                            int c0, int rows, int cols, int ld, int n_rows,
                                            int n_cols, int vec, bool swz) {
  const int chunks = cols / kCols;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks, c = e % chunks;
    const int i = r0 + r, j = c0 + c * kCols;
    float* d = dst + r * cols + (swz ? c ^ ((r >> 2) & (chunks - 1)) : c) * kCols;
    const float* src = A + (size_t)i * ld + j;
    if (vec) {
      const bool ok = i < n_rows && j < n_cols;
      cp_async16(d, ok ? src : A, ok);
    } else {
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const bool ok = i < n_rows && j + q < n_cols;
        cp_async4(d + q, ok ? src + q : A, ok);
      }
    }
  }
}

// Start the copies of rows r0 + [0, rows) of the (n, DC) matrix X into dst,
// as they lie in memory; zeros past n.
template <int DC>
__device__ __forceinline__ void issue_rows(float* dst, const float* __restrict__ X, int r0,
                                           int rows, int n) {
  const long long x0 = (long long)r0 * DC, nx = (long long)n * DC;
  for (int e = threadIdx.x; e < rows * DC; e += kThreads) {
    const bool ok = x0 + e < nx;
    cp_async4(dst + e, ok ? X + x0 + e : X, ok);
  }
}

// Px[b][jt][i][d0 + c] = ws[c] rowp[c] summed over the warp (the tile's
// columns), ws the lane's weights of the chunk.
template <int DC>
__device__ __forceinline__ void write_row_partial(float (&rowp)[DC], const float* ws,
                                                  float* __restrict__ Px, int b, int jt, int nJt,
                                                  int i, int N, int D, int d0) {
#pragma unroll
  for (int c = 0; c < DC; ++c) rowp[c] = warp_sum(rowp[c]);
  if ((threadIdx.x & 31) == 0) {
    float* px = Px + (((size_t)b * nJt + jt) * N + i) * D + d0;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (d0 + c < D) px[c] = ws[c] * rowp[c];
  }
}

// Py[b][it][j][d0 + c] = ws[c] times the tile's column sums col (each warp's
// over its rows) added over the warps in a fixed order through red, the
// stage's G block (4096 floats, free once every thread is past its reads),
// 4 features a pass. A block-wide call.
template <int DC>
__device__ __forceinline__ void write_col_partials(const float (&col)[kCols][DC], float* red,
                                                   const float* ws, float* __restrict__ Py,
                                                   int b, int it, int nIt, int j0, int M, int D,
                                                   int d0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int c0 = 0; c0 < DC; c0 += 4) {
    __syncthreads();  // red is free
#pragma unroll
    for (int q = 0; q < kCols; ++q)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        if (c0 + cc < DC) red[(warp * kTileN + lane * kCols + q) * 4 + cc] = col[q][c0 + cc];
    __syncthreads();
    for (int e = tid; e < kTileN * 4; e += kThreads) {
      const int jj = e / 4, c = c0 + e % 4;
      if (c >= DC || j0 + jj >= M || d0 + c >= D) continue;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * kTileN * 4 + e];
      Py[(((size_t)b * nIt + it) * M + j0 + jj) * D + d0 + c] = ws[c] * s;
    }
  }
}

// The block's dtheta sums of features [d0, d0 + DC): tacc added over the
// warps in a fixed order through red, then pt[d0 + c] set to the sum or, with
// add, increased by it (thread c always owns feature d0 + c). A block-wide
// call.
template <int DC>
__device__ __forceinline__ void flush_theta(float (&tacc)[DC], float* red, float* pt, int D,
                                            int d0, bool add) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // red is free
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const float v = warp_sum(tacc[c]);
    if (lane == 0) red[warp * DC + c] = v;
  }
  __syncthreads();
  if (tid < DC && d0 + tid < D) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * DC + tid];
    pt[d0 + tid] = add ? pt[d0 + tid] + s : s;
  }
}

// One launch. Block (s, it) takes the rows i0 + [0, tm) of row tile it (tm
// = 8 rpw) and the tiles [s E / S, (s + 1) E / S) of the row tile's E = B nJt
// tiles (e = b nJt + jt: lane by lane, each lane's 128-column tiles in
// turn), G streamed through the ring. It writes
//   Pt[blk][b][k] = sum over its tiles of lane b of A d_k^2 (blk = it S + s;
//                   zero for a lane it has no tile of),
//   dX[i][k] itself when it holds every tile of its rows (S = 1, Y not X),
//     else Px[s][i][k] = sum over its tiles of w_bk sum_j A d_k (D <= DC)
//     or Px[e][i][k] tile by tile (D > DC)                           (need_x),
//   Py[b][it][j][k] = w_bk sum_i A d_k over tile e's rows            (need_y),
// and the sums across blocks, each in a fixed order: a row tile's dX by the
// last of its S blocks to arrive (tile_counter[it]); dtheta, dY, and dX when
// Y is X (it needs every row tile's Py) by the last block of the grid to
// arrive (counter). MODE 0 computes dtheta alone, 1 also dX, 2 everything
// (bwd_blocks_per_sm blocks an SM). With D <= DC each element is visited
// once: its differences
// give r2, A, and the sums. Above that, the tile's X and Y rows are staged
// chunk by chunk: r2 is summed over the chunks first, then the sums are
// taken chunk by chunk.
template <int DC, int CODE, int MODE>
__global__ void __launch_bounds__(kThreads, bwd_blocks_per_sm(MODE, DC))
matern_bwd_kernel(const float* __restrict__ theta, const float* __restrict__ X,
                  const float* __restrict__ Y, const float* __restrict__ G,
                  float* __restrict__ Pt, float* __restrict__ Px, float* __restrict__ Py,
                  unsigned int* __restrict__ counter, unsigned int* __restrict__ tile_counter,
                  float* __restrict__ dtheta,
                  float* __restrict__ dX, float* __restrict__ dY, int B, int N, int M, int Dn,
                  int rpw, int nJt, int sym, int same, int vec, int need_t, int need_x,
                  int need_y) {
  const int D = DC < kMaxDC ? DC : Dn;  // DC < 8 means D = DC: a constant, one chunk
  const bool one_chunk = D <= DC;
  extern __shared__ float4 ring4[];     // kStages stages of stage_floats<DC>()
  float* ring = reinterpret_cast<float*>(ring4);
  __shared__ float red[kWarps * DC];
  __shared__ float ws[DC];
  __shared__ float racc[kRingRows * DC];  // the block's weighted row sums (D <= DC)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x, S = gridDim.x, it = blockIdx.y, nIt = gridDim.y;
  const int tm = kWarps * rpw, i0 = it * tm;
  const long long E = (long long)B * nJt;
  const long long e0 = E * s / S, ne = E * (s + 1) / S - e0;
  const bool direct = one_chunk && S == 1 && !same;  // the block owns its rows' dX
  float* pt = Pt + ((size_t)it * S + s) * B * D;     // [b][k]; thread c owns k = c mod DC
  if (tid < DC)
    for (long long bk = tid; bk < (long long)B * D; bk += DC) pt[bk] = 0.0f;
  if (tid < kRingRows * DC) racc[tid] = 0.0f;

  auto issue = [&](long long n) {  // tile e0 + n into stage n % kStages, if the block has it
    if (n < ne) {
      const long long e = e0 + n;
      const int b = (int)(e / nJt), j0 = (int)(e % nJt) * kTileN;
      float* st = ring + (n % kStages) * stage_floats<DC>();
      issue_block(st, G + (size_t)b * N * M, i0, j0, tm, kTileN, M, N, M, vec, false);
      if (one_chunk) {  // above one chunk, X and Y are staged chunk by chunk
        issue_rows<DC>(st + kRingRows * kTileN, X, i0, tm, N);
        issue_rows<DC>(st + kRingRows * kTileN + kRingRows * DC, Y, j0, kTileN, M);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);

  int b = -1;   // the lane of the tile at hand
  float w[DC];  // max(theta_b, 0) when one_chunk
  float tacc[DC] = {};
  for (long long n = 0; n < ne; ++n) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile n has landed for every thread; stage (n - 1) % kStages is free
    issue(n + kStages - 1);
    const long long e = e0 + n;
    const int jt = (int)(e % nJt), j0 = jt * kTileN;
    if ((int)(e / nJt) != b) {  // a new lane: its weights, and the last lane's dtheta
      if (b >= 0 && one_chunk) flush_theta<DC>(tacc, red, pt + (size_t)b * D, D, 0, true);
      b = (int)(e / nJt);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        w[c] = one_chunk ? max_nan(theta[(size_t)b * D + c], 0.0f) : 0.0f;
        tacc[c] = 0.0f;
      }
      if (one_chunk && tid < DC) ws[tid] = max_nan(theta[(size_t)b * D + tid], 0.0f);
    }
    float* st = ring + (n % kStages) * stage_floats<DC>();
    float* xs = st + kRingRows * kTileN;
    float* ys = xs + kRingRows * DC;
    const int j = j0 + lane * kCols;
    const bool diag = sym && i0 < j0 + kTileN && j0 < i0 + tm;
    const float* th_b = theta + (size_t)b * D;

    if (one_chunk) {
      float y[kCols][DC];
      load_y<DC>(y, ys);
      float col[kCols][DC] = {};
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) {
        const int rr = r * kWarps + warp;
        const int i = i0 + rr;
        if (r >= rpw || i >= N) break;
        const float4 g4 = *reinterpret_cast<const float4*>(st + rr * kTileN + lane * kCols);
        const float g[kCols] = {g4.x, g4.y, g4.z, g4.w};
        float x[DC], rowp[DC] = {};
#pragma unroll
        for (int c = 0; c < DC; ++c) x[c] = xs[rr * DC + c];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          float diff[DC], sq[DC], r2 = 0.0f;
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            diff[c] = x[c] - y[q][c];
            sq[c] = diff[c] * diff[c];
            r2 = fmaf(w[c], sq[c], r2);
          }
          const float A = (diag && i == j + q) ? 0.0f : g[q] * dk_dr2<CODE>(r2);
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            tacc[c] = fmaf(A, sq[c], tacc[c]);
            if (MODE >= 1) {
              const float u = A * diff[c];
              rowp[c] += u;
              if (MODE == 2) col[q][c] += u;
            }
          }
        }
        if (MODE >= 1 && need_x) {  // the row's sum over the tile, into the block's, weighted
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            const float v = warp_sum(rowp[c]);
            if (lane == 0) racc[rr * DC + c] += w[c] * v;
          }
        }
      }
      if (MODE == 2 && need_y) write_col_partials<DC>(col, st, ws, Py, b, it, nIt, j0, M, D, 0);
      continue;
    }

    // D > DC: r2 over every chunk, then A = G dK/dr2, then the sums per chunk
    float r2[kBwdRows][kCols] = {};
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // the previous chunk is consumed
      stage<DC, kBwdRows>(xs, ys, ws, X, Y, th_b, i0, j0, N, M, D, d0);
      __syncthreads();
      add_sq_dist<DC, kBwdRows>(r2, xs, ys, ws, i0, N);
    }
    float a[kBwdRows][kCols];
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const int rr = r * kWarps + warp;
      const int i = i0 + rr;
      const float4 g4 = *reinterpret_cast<const float4*>(st + rr * kTileN + lane * kCols);
      const float g[kCols] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        a[r][q] = (r >= rpw || i >= N || (diag && i == j + q)) ? 0.0f
                                                               : g[q] * dk_dr2<CODE>(r2[r][q]);
    }
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();
      stage<DC, kBwdRows>(xs, ys, ws, X, Y, th_b, i0, j0, N, M, D, d0);
      __syncthreads();
      float y[kCols][DC];
      load_y<DC>(y, ys);
      float tc[DC] = {}, col[kCols][DC] = {};
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) {
        const int rr = r * kWarps + warp;
        const int i = i0 + rr;
        if (r >= rpw || i >= N) break;
        float x[DC], rowp[DC] = {};
#pragma unroll
        for (int c = 0; c < DC; ++c) x[c] = xs[rr * DC + c];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            const float diff = x[c] - y[q][c];
            tc[c] = fmaf(a[r][q], diff * diff, tc[c]);
            if (MODE >= 1) {
              const float u = a[r][q] * diff;
              rowp[c] += u;
              if (MODE == 2) col[q][c] += u;
            }
          }
        }
        if (MODE >= 1 && need_x) write_row_partial<DC>(rowp, ws, Px, b, jt, nJt, i, N, D, d0);
      }
      if (MODE == 2 && need_y)
        write_col_partials<DC>(col, st, ws, Py, b, it, nIt, j0, M, D, d0);
      flush_theta<DC>(tc, red, pt + (size_t)b * D, D, d0, true);
    }
  }
  cp_async_wait<0>();
  if (b >= 0 && one_chunk) flush_theta<DC>(tacc, red, pt + (size_t)b * D, D, 0, true);
  if (MODE >= 1 && need_x) {
    if (one_chunk) {  // the block's row sums: dX, or its partial
      __syncthreads();
      const int rr = tid / D, c = tid % D, i = i0 + rr;
      if (rr < tm && i < N) {
        const float v = racc[rr * DC + c];
        if (direct)
          dX[(size_t)i * D + c] = 2.0f * v;
        else
          Px[((size_t)s * N + i) * D + c] = v;
      }
    }
    // Y not X: the last of the row tile's blocks to arrive sums its rows' dX
    // over the S blocks' partials (D <= DC) or the E tiles' (D > DC)
    const long long ND = (long long)N * D, o0 = (long long)i0 * D, nx = one_chunk ? S : E;
    if (!direct && !same && arrive_last(tile_counter + it, S))
      reduce_outputs(
          (long long)min(tm, N - i0) * D, nx,
          [&](long long o, long long e) { return __ldcg(Px + e * ND + o0 + o); },
          [&](long long o, float v) { dX[o0 + o] = 2.0f * v; });
  }

  if (!(need_t || (MODE == 2 && need_y) || (MODE >= 1 && need_x && same)) || !arrive_last(counter))
    return;
  // the last block: every partial is a [e][o] array over the outputs o
  const long long BD = (long long)B * D, ND = (long long)N * D, MD = (long long)M * D;
  if (need_t)
    reduce_outputs(
        BD, (long long)nIt * S, [&](long long o, long long e) { return __ldcg(Pt + e * BD + o); },
        [&](long long o, float v) { dtheta[o] = v * (theta[o] > 0.0f ? 1.0f : 0.0f); });
  if (MODE >= 1 && need_x && same) {
    // Y is X: the Y side's column sums (Py, M = N) move dX too
    const long long nx = one_chunk ? S : E, ny = (long long)B * nIt;
    reduce_outputs(
        ND, nx + ny,
        [&](long long o, long long e) {
          return e < nx ? __ldcg(Px + e * ND + o) : -__ldcg(Py + (e - nx) * ND + o);
        },
        [&](long long o, float v) { dX[o] = 2.0f * v; });
  }
  if (MODE == 2 && need_y && !same)
    reduce_outputs(
        MD, (long long)B * nIt, [&](long long o, long long e) { return __ldcg(Py + e * MD + o); },
        [&](long long o, float v) { dY[o] = -2.0f * v; });
}

// ------------------------------------------- backward, dtheta of K(X, X)

// The fit's case, dtheta alone of the training matrix K(X, X): h_ij and
// d_ij^2 are symmetric in (i, j), so
//   dtheta_k = sum over i < j of (G_ij + G_ji) h_ij d_ijk^2,
// half the arithmetic, with G still read once. Square blocks of 64 x 64, in
// units of about equal work: each pair of blocks (I, J), I < J, and each two
// diagonal blocks (I, I), (I + 1, I + 1). In a pair, each thread holds 4 rows
// (4 ty + r) x 4 columns (4 tx + q) of (I, J), ty = tid / 16, tx = tid % 16,
// and reads G_ji from the mirror block (J, I) as one float4 for its 4 rows.
// A diagonal block's strict upper triangle is folded into 64 rows x 32
// offsets: element (i, o) is the pair (i, (i + o) mod 64), o in [1, 32] (o =
// 32 for i < 32 only), each thread holding 4 rows x 2 offsets. Blocks are
// stored swizzled (16-byte chunk c of row r at chunk c ^ (r / 4)), so that
// the row reads, the column reads and the folded reads meet few bank
// conflicts.
constexpr int kSq = 64;
constexpr int kSymStages = 3;  // 2 blocks an SM: 3 x 35-37 KB of ring each

// Floats of one ring stage: two blocks of G ((I, J) and (J, I), or (I, I)
// and (I + 1, I + 1)), then X's rows of the first and of the second, [64][DC]
// each.
template <int DC>
__host__ __device__ constexpr int sym_stage_floats() {
  return 2 * kSq * kSq + 2 * kSq * DC;
}

// Offset of element (r, c) of a swizzled 64 x 64 block.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kSq + (((c >> 2) ^ ((r >> 2) & 15)) << 2) + (c & 3);
}

// The unit at hand: the pair (I, J), I < J, or, when I == J, the diagonal
// blocks I and I + 1. Units run over the pairs row by row, then over the
// diagonal ones.
struct SymUnit {
  int I, J;
  __device__ __forceinline__ void next(int nT) {
    if (I == J) {
      J = I += 2;
    } else if (++J == nT) {
      J = ++I + 1;
      if (J >= nT) I = J = 0;
    }
  }
};

// tacc[c] += A d_c^2 over the folded strict upper triangle of one diagonal
// block (g swizzled, its X rows xs): the thread's rows 4 ty + r and offsets
// 1 + 2 tx + v.
template <int DC, int CODE>
__device__ __forceinline__ void sym_diag_block(const float* g, const float* xs, const float (&w)[DC],
                                               float (&tacc)[DC], int tx, int ty) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
    float x[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) x[c] = xs[i * DC + c];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int o = 1 + 2 * tx + v, j = (i + o) & (kSq - 1);
      const float gij = (o < kSq / 2 || i < kSq / 2) ? g[swz(i, j)] + g[swz(j, i)] : 0.0f;
      float sq[DC], r2 = 0.0f;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float diff = x[c] - xs[j * DC + c];
        sq[c] = diff * diff;
        r2 = fmaf(w[c], sq[c], r2);
      }
      const float A = gij * dk_dr2<CODE>(r2);
#pragma unroll
      for (int c = 0; c < DC; ++c) tacc[c] = fmaf(A, sq[c], tacc[c]);
    }
  }
}

// Block (p, b) walks the units [p U / P, (p + 1) U / P) of lane b's U =
// nT (nT - 1) / 2 + ceil(nT / 2), streaming them through a ring of
// kSymStages stages; dtheta in registers across the units, then
// Pt[p][b][k], summed by the last block of the grid to arrive (by the block
// itself when it is its lane's only one, P = 1). D = DC.
template <int DC, int CODE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
matern_bwd_sym_kernel(const float* __restrict__ theta, const float* __restrict__ X,
                      const float* __restrict__ G, float* __restrict__ Pt,
                      unsigned int* __restrict__ counter, float* __restrict__ dtheta, int N,
                      int vec) {
  extern __shared__ float4 ring4[];  // kSymStages stages of sym_stage_floats<DC>()
  float* ring = reinterpret_cast<float*>(ring4);
  __shared__ float red[kWarps * DC];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int p = blockIdx.x, P = gridDim.x, b = blockIdx.y, B = gridDim.y;
  const int nT = (N + kSq - 1) / kSq;
  const long long Uo = (long long)nT * (nT - 1) / 2, U = Uo + (nT + 1) / 2;
  const long long u0 = U * p / P, nu = U * (p + 1) / P - u0;
  const float* Gb = G + (size_t)b * N * N;

  SymUnit cur{0, 0};  // unit u0: a pair (row I holds nT - 1 - I of them), or a diagonal one
  if (u0 < Uo) {
    long long u = u0;
    while (u >= nT - 1 - cur.I) u -= nT - 1 - cur.I++;
    cur.J = cur.I + 1 + (int)u;
  } else {
    cur.I = cur.J = 2 * (int)(u0 - Uo);
  }
  SymUnit iss = cur;  // the unit the next issue copies
  auto issue = [&](long long n) {
    if (n < nu) {
      float* st = ring + (n % kSymStages) * sym_stage_floats<DC>();
      const int r1 = iss.I * kSq;                                 // the first block's rows
      const int r2 = (iss.I == iss.J ? iss.I + 1 : iss.J) * kSq;  // the second's
      const int c1 = iss.I == iss.J ? r1 : r2, c2 = iss.I == iss.J ? r2 : r1;
      issue_block(st, Gb, r1, c1, kSq, kSq, N, N, N, vec, true);
      if (r2 < N) issue_block(st + kSq * kSq, Gb, r2, c2, kSq, kSq, N, N, N, vec, true);
      issue_rows<DC>(st + 2 * kSq * kSq, X, r1, kSq, N);
      issue_rows<DC>(st + 2 * kSq * kSq + kSq * DC, X, r2, kSq, N);
      iss.next(nT);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kSymStages - 1; ++s) issue(s);

  float w[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) w[c] = max_nan(theta[(size_t)b * DC + c], 0.0f);
  float tacc[DC] = {};
  for (long long n = 0; n < nu; ++n) {
    cp_async_wait<kSymStages - 2>();
    __syncthreads();  // unit n has landed for every thread; its stage - 1 is free
    issue(n + kSymStages - 1);
    const float* st = ring + (n % kSymStages) * sym_stage_floats<DC>();
    const float* xs = st + 2 * kSq * kSq;
    const float* ys = xs + kSq * DC;
    if (cur.I == cur.J) {  // two diagonal blocks (the second past N is zeros)
      sym_diag_block<DC, CODE>(st, xs, w, tacc, tx, ty);
      if ((cur.I + 1) * kSq < N) sym_diag_block<DC, CODE>(st + kSq * kSq, ys, w, tacc, tx, ty);
      cur.next(nT);
      continue;
    }
    float g[4][kCols];  // G_ij + G_ji for the thread's rows r and columns q
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // row 4 ty + r of (I, J), chunk tx (swizzled)
      const float4 v = *reinterpret_cast<const float4*>(st + (4 * ty + r) * kSq + 4 * (tx ^ ty));
      g[r][0] = v.x;
      g[r][1] = v.y;
      g[r][2] = v.z;
      g[r][3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) {  // row 4 tx + q of (J, I), chunk ty (swizzled)
      const float4 v =
          *reinterpret_cast<const float4*>(st + kSq * kSq + (4 * tx + q) * kSq + 4 * (ty ^ tx));
      g[0][q] += v.x;
      g[1][q] += v.y;
      g[2][q] += v.z;
      g[3][q] += v.w;
    }
    float y[kCols][DC];
#pragma unroll
    for (int q = 0; q < kCols; ++q)
#pragma unroll
      for (int c = 0; c < DC; ++c) y[q][c] = ys[(4 * tx + q) * DC + c];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float x[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) x[c] = xs[(4 * ty + r) * DC + c];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        float sq[DC], r2 = 0.0f;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float diff = x[c] - y[q][c];
          sq[c] = diff * diff;
          r2 = fmaf(w[c], sq[c], r2);
        }
        const float A = g[r][q] * dk_dr2<CODE>(r2);
#pragma unroll
        for (int c = 0; c < DC; ++c) tacc[c] = fmaf(A, sq[c], tacc[c]);
      }
    }
    cur.next(nT);
  }
  cp_async_wait<0>();
  float* pt = Pt + ((size_t)p * B + b) * DC;
  flush_theta<DC>(tacc, red, pt, DC, 0, false);
  if (P == 1) {  // the lane's only block: no other partial to wait for
    if (tid < DC) dtheta[(size_t)b * DC + tid] = pt[tid] * (theta[(size_t)b * DC + tid] > 0.0f);
    return;
  }
  if (!arrive_last(counter)) return;
  const long long BD = (long long)B * DC;
  reduce_outputs(
      BD, P, [&](long long o, long long e) { return __ldcg(Pt + e * BD + o); },
      [&](long long o, float v) { dtheta[o] = v * (theta[o] > 0.0f ? 1.0f : 0.0f); });
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<DC>, Int<CODE>) for the nu code.
template <int DC, typename F>
int with_code(int code, F&& f) {
  switch (code) {
    case 0: return f(Int<DC>{}, Int<0>{});
    case 1: return f(Int<DC>{}, Int<1>{});
    case 3: return f(Int<DC>{}, Int<3>{});
    default: return f(Int<DC>{}, Int<5>{});
  }
}

// f(Int<DC>) for the feature chunk DC = min(D, 8).
template <typename F>
int with_dc(int D, F&& f) {
  switch (D < kMaxDC ? D : kMaxDC) {
    case 1: return f(Int<1>{});
    case 2: return f(Int<2>{});
    case 3: return f(Int<3>{});
    case 4: return f(Int<4>{});
    case 5: return f(Int<5>{});
    case 6: return f(Int<6>{});
    case 7: return f(Int<7>{});
    default: return f(Int<8>{});
  }
}

long long row_tiles(int N, int rows) { return (N + kWarps * rows - 1) / (kWarps * rows); }
long long col_tiles(int M) { return (M + kTileN - 1) / kTileN; }

// Whether rows of M floats from p can be accessed as float4
int rows_vec4(const void* p, int M) {
  return M % kCols == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The backward's work split for these shapes on a card of `sms` SMs: square
// (dtheta alone of K(X, X), D <= 8: matern_bwd_sym_kernel's units, P blocks a
// lane, as many as the card holds at once, two an SM) or tiled
// (matern_bwd_kernel, mode 0 dtheta alone, 1 with dX, 2 with dY: blocks
// (s, it), rpw rows a warp, 4 halved while even one tile a block leaves
// blocks idle on a card holding bwd_blocks_per_sm an SM, and S blocks a row
// tile, enough to fill the card, at most its E = B nJt tiles); where Px and
// Py start in the scratch, and its size, in floats.
struct BwdPlan {
  bool square;
  int mode, rpw, nIt, nJt, S, P;
  long long px, py, floats;
};

BwdPlan bwd_plan(int B, int N, int M, int D, int same, int need_x, int need_y, int sms) {
  BwdPlan q;
  q.mode = need_y ? 2 : need_x ? 1 : 0;
  q.square = q.mode == 0 && same && D <= kMaxDC;
  const long long blocks =
      (long long)bwd_blocks_per_sm(q.mode, std::min(D, kMaxDC)) * std::max(sms, 1);
  q.nJt = (int)col_tiles(M);
  const long long E = (long long)B * q.nJt;
  q.rpw = kBwdRows;
  while (q.rpw > 1 && row_tiles(N, q.rpw) * E < blocks) q.rpw >>= 1;
  q.nIt = (int)row_tiles(N, q.rpw);
  q.S = (int)std::max(1LL, std::min(E, (blocks + q.nIt - 1) / std::max(q.nIt, 1)));
  const long long nT = (N + kSq - 1) / kSq;
  const long long units = nT * (nT - 1) / 2 + (nT + 1) / 2;  // matern_bwd_sym_kernel's, a lane
  q.P = (int)std::max(1LL, std::min(units, blocks / std::max(B, 1)));
  const long long partials = q.square ? q.P : (long long)q.nIt * q.S;  // dtheta's, per lane
  q.px = partials * B * D;
  q.py = q.px + (need_x ? (D <= kMaxDC ? q.S : E) * N * D : 0);
  q.floats = q.py + (need_y ? (long long)B * q.nIt * M * D : 0);
  return q;
}

}  // namespace

// The build compiles this file once for each feature chunk, -DMATERN_DC=k
// for k = 1..8 (that chunk's 20 kernels, behind launch_fwd<k> and
// launch_bwd<k>), and once with -DMATERN_DC=0 for the entry points, so that
// the 160 kernels compile in parallel. Without MATERN_DC, this file is one
// unit that holds everything.
#ifndef MATERN_DC
#define MATERN_DC -1
#endif

namespace matern_launch {

struct FwdArgs {
  const void *theta, *X, *Y;
  void* K;
  int B, N, M, D, nu_code, sym;
  void* stream;
};

struct BwdArgs {
  const void *theta, *X, *Y, *G;
  void *scratch, *counter, *tile_counter, *dtheta, *dX, *dY;
  int B, N, M, D, nu_code, sym, same, need_t, need_x, need_y, sms;
  void* stream;
};

template <int DC>
int launch_fwd(const FwdArgs& a);
template <int DC>
int launch_bwd(const BwdArgs& a);

#if MATERN_DC != 0
template <int DC>
int launch_fwd(const FwdArgs& a) {
  const dim3 grid((unsigned)col_tiles(a.M), (unsigned)row_tiles(a.N, kFwdRows), a.B);
  return with_code<DC>(a.nu_code, [&](auto, auto code) {
    matern_fwd_kernel<DC, decltype(code)::value><<<grid, kThreads, 0, (cudaStream_t)a.stream>>>(
        (const float*)a.theta, (const float*)a.X, (const float*)a.Y, (float*)a.K, a.N, a.M, a.D,
        a.sym, rows_vec4(a.K, a.M));
    return (int)cudaGetLastError();
  });
}

template <int DC>
int launch_bwd(const BwdArgs& a) {
  const BwdPlan q = bwd_plan(a.B, a.N, a.M, a.D, a.same, a.need_x, a.need_y, a.sms);
  float* Pt = (float*)a.scratch;
  const int vec = rows_vec4(a.G, a.M);
  const cudaStream_t s = (cudaStream_t)a.stream;
  return with_code<DC>(a.nu_code, [&](auto, auto code) {
    constexpr int CODE = decltype(code)::value;
    if (q.square) {
      const int smem = (int)sizeof(float) * kSymStages * sym_stage_floats<DC>();
      const int err = allow_smem((const void*)matern_bwd_sym_kernel<DC, CODE>, smem);
      if (err != 0) return err;
      matern_bwd_sym_kernel<DC, CODE><<<dim3(q.P, a.B), kThreads, smem, s>>>(
          (const float*)a.theta, (const float*)a.X, (const float*)a.G, Pt,
          (unsigned int*)a.counter, (float*)a.dtheta, a.N, vec);
      return (int)cudaGetLastError();
    }
    const int smem = (int)sizeof(float) * kStages * stage_floats<DC>();
    auto kernel = q.mode == 0   ? matern_bwd_kernel<DC, CODE, 0>
                  : q.mode == 1 ? matern_bwd_kernel<DC, CODE, 1>
                                : matern_bwd_kernel<DC, CODE, 2>;
    const int err = allow_smem((const void*)kernel, smem);
    if (err != 0) return err;
    kernel<<<dim3(q.S, q.nIt), kThreads, smem, s>>>(
        (const float*)a.theta, (const float*)a.X, (const float*)a.Y, (const float*)a.G, Pt,
        Pt + q.px, Pt + q.py, (unsigned int*)a.counter, (unsigned int*)a.tile_counter,
        (float*)a.dtheta, (float*)a.dX, (float*)a.dY, a.B, a.N, a.M, a.D, q.rpw, q.nJt, a.sym,
        a.same, vec, a.need_t, a.need_x, a.need_y);
    return (int)cudaGetLastError();
  });
}
#endif

#if MATERN_DC > 0
template int launch_fwd<MATERN_DC>(const FwdArgs&);
template int launch_bwd<MATERN_DC>(const BwdArgs&);
#endif

}  // namespace matern_launch

#if MATERN_DC <= 0
// theta: (B, D), X: (N, D), Y: (M, D), K: (B, N, M); all float32, contiguous;
// nu_code in {0, 1, 3, 5}; D >= 1. Returns the cudaError_t of the launch.
extern "C" int botorch_matern(const void* theta, const void* X, const void* Y, void* K, int B,
                              int N, int M, int D, int nu_code, int sym, void* stream) {
  const matern_launch::FwdArgs a{theta, X, Y, K, B, N, M, D, nu_code, sym, stream};
  return with_dc(D, [&](auto dc) { return matern_launch::launch_fwd<decltype(dc)::value>(a); });
}

// Floats of scratch that botorch_matern_bwd needs for these arguments.
extern "C" long long botorch_matern_bwd_scratch(int B, int N, int M, int D, int same, int need_x,
                                                int need_y, int sms) {
  return bwd_plan(B, N, M, D, same, need_x, need_y, sms).floats;
}

// Row-tile arrival counters (botorch_matern_bwd's tile_counter) that
// botorch_matern_bwd uses for these arguments.
extern "C" int botorch_matern_bwd_row_tiles(int B, int N, int M, int D, int same, int need_x,
                                            int need_y, int sms) {
  return bwd_plan(B, N, M, D, same, need_x, need_y, sms).nIt;
}

// The gradients of botorch_matern's K for G = dL/dK (B, N, M), float32,
// contiguous. dtheta (B, D), dX (N, D), dY (M, D) are written where
// need_t, need_x, need_y ask (each may be null otherwise); when Y is X
// (same), need_y must be set with need_x, and dX carries both sides while
// dY is not written. scratch holds botorch_matern_bwd_scratch(...) floats
// for the same arguments; counter and tile_counter[0,
// botorch_matern_bwd_row_tiles(...)) are unsigned ints in device memory, 0
// and used by no other launch in flight (the kernel leaves them 0); sms the
// card's SM count. One launch (none when nothing is asked). Returns its
// cudaError_t.
extern "C" int botorch_matern_bwd(const void* theta, const void* X, const void* Y, const void* G,
                                  void* scratch, void* counter, void* tile_counter, void* dtheta,
                                  void* dX, void* dY, int B, int N, int M, int D, int nu_code,
                                  int sym, int same, int need_t, int need_x, int need_y, int sms,
                                  void* stream) {
  if (!need_t && !need_x && !need_y) return 0;
  const matern_launch::BwdArgs a{theta, X, Y, G, scratch, counter, tile_counter, dtheta, dX, dY,
                                 B, N, M, D, nu_code, sym, same, need_t, need_x, need_y, sms,
                                 stream};
  return with_dc(D, [&](auto dc) { return matern_launch::launch_bwd<decltype(dc)::value>(a); });
}

// Human-readable name of a cudaError_t returned by the entry points above.
extern "C" const char* botorch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif
