// Blocked Cholesky factor + forward solve for Hopper (sm_90a).
//
// Replaces the TPU kernel `whiten_fused` (body `_whiten_fused_kernel`,
// per-block `_chol128_inkernel`) of bayesian_optimization_tpu/ops/
// pallas_kernels.py. For a batch of SPD matrices R (n x n) and right-hand
// sides B (n x mb) it computes, per batch entry:
//   L      the Cholesky factor R = L L^T, in 128-wide panels (T = min(n, 128));
//   Dinv   the explicit inverse of each T x T diagonal block of L;
//   W      the forward solve L^-1 B;
//   piv    the smallest RAW pivot before the 1e-12 clamp (piv <= 0 or NaN
//          flags a failed factorisation; the clamp keeps it finite).
// All arithmetic is float32 FMA on the CUDA cores: no TF32 anywhere.
//
// Data layout. The wrapper copies R and B^T into one workspace of shape
// (Bt, n + mb, n): rows [0, n) hold R, rows [n, n + mb) hold B^T. Running a
// right-looking Cholesky over the first n columns of this augmented matrix
// leaves L in rows [0, n) and W^T = B^T L^-T in rows [n, n + mb): the
// forward solve is the Cholesky of [[R, B], [B^T, *]] restricted to its
// first n columns, so it needs no kernel of its own. The caller's R is
// only ever read (by the copy), so it cannot be clobbered -- the hazard
// the TPU kernel met with buffer donation does not arise.
//
// What bounds it on this card. The TPU kernel kept R, L, W and Dinv
// resident in tens of MB of VMEM and walked the panels inside one program.
// An SM has 227 KB of shared memory and a 1024^2 float32 matrix is 4 MB, so
// the matrix streams through L2 (50 MB holds the whole batch at the bench
// sizes). The flops are n^3/3 per matrix (0.36 GFLOP at n = 1024), small
// against the card; what bounds it is the sequential depth of the
// factorisation (nb = n/128 panels, each a chain of 128 dependent column
// steps) and, at the ladder's batch sizes of 2..10, how many SMs a step can
// keep busy.
//
// Design: one launch sequence per 128-panel step k, all on the caller's
// stream, with no host synchronisation:
//   1. chol_diag_kernel, one block of 8 warps per batch entry, factors the
//      T x T diagonal block in shared memory by a blocked right-looking
//      Cholesky in 32-wide sub-blocks. For each sub-block s:
//        a. one warp factors the 32 x 32 diagonal sub-block in registers
//           (lane i holds row i; the loop is unrolled so register indices
//           are static) and builds its inverse X_ss by forward substitution
//           in the same sweep. No block barrier inside the sweep;
//        b. all warps, one 32 x 32 register tile each: the sub-panel
//           below, L_rs = A_rs X_ss^T, and the finished rows of the block
//           inverse, X_sj = -X_ss P_sj (j < s);
//        c. all warps, likewise: the trailing update A_rt -= L_rs L_ts^T
//           (lower part) and the pending sums of the inverse,
//           P_rj += L_rs X_sj.
//      So Dinv is assembled from the sub-block inverses by the blocked
//      formula X_ij = -X_ii sum_{k=j}^{i-1} L_ik X_kj, its sum accumulated
//      as each L_ik becomes final. Three block barriers per sub-block. A
//      ragged T (any n <= 128) is masked in the last sub-block: its lanes
//      past the edge carry identity rows, which keeps the unrolled sweep
//      free of branches, and nothing of them is stored or counted;
//   2. panel_solve_kernel, a grid of blocks over 64-row tiles of every row
//      below the diagonal block (RHS rows included): L_ik = A_ik Dinv_k^T,
//      with Dinv_k staged once per block, 4 x 4 outputs per thread, the
//      zero upper half of Dinv_k skipped by whole 8-column groups, and the
//      A tiles brought in by cp.async, double-buffered against the compute
//      when a block walks more than one tile. It also zeroes the strip of
//      L right of the diagonal block;
//   3. trailing_update_kernel, a grid over 64 x 64 tiles of the lower
//      trailing part (and all RHS rows): A -= L_ik L_jk^T, with both panel
//      slices staged by cp.async in two halves of the depth and 4 x 4
//      outputs per thread.
// Steps 2 and 3 hold ~all of the flops and spread over many blocks; only
// step 1 runs on one block per matrix. All three stage their operands in
// dynamic shared memory above 48 KB.
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 128;           // diagonal-block width; T <= kTile
constexpr int kSub = 32;             // sub-block width: one warp's lanes
constexpr int kLd = kTile + 4;       // shared row stride, see chol_diag_kernel
constexpr int kDiagThreads = 256;
constexpr int kDiagWarps = kDiagThreads / 32;
constexpr int kPanelRows = 64;
constexpr int kPanelThreads = 256;
constexpr int kTT = 64;              // trailing-update output tile edge
constexpr int kTrailThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float nan_min(float a, float b) {
  // min that propagates NaN from either side (jnp.minimum semantics)
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One warp, one 32 x 32 tile of a product with depth 32 from shared memory:
// acc[p][q] = sum_{l < 32} A[rg + 8 p][l] * B(l, col(q)), A given by rows at
// Am (stride kLd). Lane (rg, cg) = (lane / 4, lane % 4) owns rows rg + 8 p
// (p < 4) and 8 columns: with kBRows, B(l, c) = Bm[c][l] (B given by rows,
// as L^T) and col(q) = cg + 4 q; else B(l, c) = Bm[l][c] and col(q) =
// 8 cg + q. Every read is a float4 with no bank conflict (eight rows four
// banks apart, or four 16-byte runs of one row), and a depth-4 step reads
// 12 of them for 128 FMAs a lane.
template <bool kBRows>
__device__ __forceinline__ void warp_tile(const float* Am, const float* Bm, int lane,
                                          float (&acc)[4][8]) {
  const int rg = lane >> 2, cg = lane & 3;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;
#pragma unroll 2
  for (int l = 0; l < kSub; l += 4) {
    float4 a[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) a[p] = ld4(Am + (rg + 8 * p) * kLd + l);
    if (kBRows) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 b = ld4(Bm + (cg + 4 * q) * kLd + l);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          float t = acc[p][q];
          t = fmaf(a[p].x, b.x, t);
          t = fmaf(a[p].y, b.y, t);
          t = fmaf(a[p].z, b.z, t);
          acc[p][q] = fmaf(a[p].w, b.w, t);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 b0 = ld4(Bm + (l + t) * kLd + 8 * cg);
        const float4 b1 = ld4(Bm + (l + t) * kLd + 8 * cg + 4);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float av = t == 0 ? a[p].x : t == 1 ? a[p].y : t == 2 ? a[p].z : a[p].w;
          acc[p][0] = fmaf(av, b0.x, acc[p][0]);
          acc[p][1] = fmaf(av, b0.y, acc[p][1]);
          acc[p][2] = fmaf(av, b0.z, acc[p][2]);
          acc[p][3] = fmaf(av, b0.w, acc[p][3]);
          acc[p][4] = fmaf(av, b1.x, acc[p][4]);
          acc[p][5] = fmaf(av, b1.y, acc[p][5]);
          acc[p][6] = fmaf(av, b1.z, acc[p][6]);
          acc[p][7] = fmaf(av, b1.w, acc[p][7]);
        }
      }
    }
  }
}

// v[l] = M[r * kLd + l], l < 32, as eight float4 loads.
__device__ __forceinline__ void load_row(const float* M, int r, float (&v)[kSub]) {
#pragma unroll
  for (int q = 0; q < kSub / 4; ++q) {
    const float4 a = ld4(M + r * kLd + 4 * q);
    v[4 * q + 0] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [r0, r0 + nr) x columns [c0 + cb, c0 + ce) of a row-major matrix
// (leading dimension ld) into shared dst (row r, column c at dst[r * kLd + c]),
// asynchronously. Elements at rows >= rmax or columns >= c0 + T are
// zero-filled. vec: 16-byte copies (cb, ce, ld and c0 multiples of 4), else
// 4-byte copies.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, size_t ld,
                                           int r0, int nr, int rmax, int c0, int cb,
                                           int ce, int T, bool vec, int tid, int nt) {
  if (vec) {
    const int per_row = (ce - cb) / 4;
    for (int e = tid; e < nr * per_row; e += nt) {
      const int r = e / per_row, c = cb + 4 * (e - r * per_row);
      const bool ok = r0 + r < rmax && c < T;
      const float* p = ok ? src + (size_t)(r0 + r) * ld + c0 + c : src;
      cp_async16(dst + r * kLd + c, p, ok ? 16 : 0);
    }
  } else {
    const int per_row = ce - cb;
    for (int e = tid; e < nr * per_row; e += nt) {
      const int r = e / per_row, c = cb + (e - r * per_row);
      const bool ok = r0 + r < rmax && c < T;
      const float* p = ok ? src + (size_t)(r0 + r) * ld + c0 + c : src;
      cp_async4(dst + r * kLd + c, p, ok ? 4 : 0);
    }
  }
}

// Step 1a, one warp: factor the w x w sub-block at (s0, s0) of S in
// registers and write L_ss into S and its inverse X_ss into X. Lane i holds
// row i of both. Step j broadcasts the raw pivot of column j, scales the
// column, and applies the rank-1 updates of the rows below j to the factor
// (columns > j) and to the inverse (columns <= j, forward substitution of
// L X = I). Lanes >= w hold identity rows: with zero off-diagonal entries
// they never touch the live rows, and their pivots are not counted.
//
// One warp runs the sweep while the block waits, so its length is the
// chain of dependent operations per step and the warp's own issue rate.
// What keeps both short:
// - 1/d comes from one rsqrtf of the clamped pivot (d = pivot * 1/d), not
//   from sqrtf and a division;
// - the next step's pivot is computed by its own lane from its own
//   multiplier (r[j+1] - l^2), so it never waits on the broadcast;
// - the column of multipliers goes out through shared memory (one store a
//   lane, then float4 broadcast reads), as does lane j's row of the
//   inverse, which it writes to its place in X: a handful of shared
//   accesses a step where a shuffle per entry took 64 (8.3k against 12.5k
//   cycles a sweep, measured on an H100);
// - the rows of the inverse stay unscaled during the sweep (the rows below
//   eliminate with L[lane][j] / d_j times lane j's unscaled row), and each
//   lane scales its own row by its 1/d once at the end;
// - registers: each lane keeps the raw pivot of its own column, reduced
//   once at the end; every four steps the four finished columns of the
//   factor go out to S as one float4; and column j of the inverse row
//   enters at step j (1 in lane j, else 0). At step j only the 32 - j open
//   entries of the factor row and the j + 1 entries of the inverse row are
//   live (holding both whole rows throughout, the kernel spilled).
// The multiplier of a row at or above j is 0, which leaves the finished
// rows exactly as they are. Entries above the diagonal of S may hold
// anything: they only ever feed entries above it.
__device__ __forceinline__ void sweep_sub_block(float* S, float* X, float* bcast, int s0,
                                                int w, int lane, float& pmin) {
  float r[kSub], x[kSub];
  load_row(S + s0, s0 + lane, r);
  const bool live = lane < w;
#pragma unroll
  for (int c = 0; c < kSub; ++c)
    if (!live || c >= w) r[c] = (c == lane) ? 1.0f : 0.0f;
  float* Xs = X + s0 * kLd + s0;  // X_ss, row j published (unscaled) at step j
  float next = r[0];  // this lane's diagonal entry as it stands before step j
  float own_raw = 0.0f, own_inv = 1.0f;  // the pivot of this lane's column
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const float raw = __shfl_sync(kFull, next, j);
    const float p = raw > 1e-12f ? raw : 1e-12f;
    const float inv = rsqrtf(p);
    const bool below = lane > j, mine = lane == j;
    const float l = below ? r[j] * inv : 0.0f;  // L[lane][j] below the diagonal, else 0
    if (j + 1 < kSub) next = fmaf(-l, l, r[j + 1]);
    r[j] = below ? l : (mine ? p * inv : 0.0f);
    own_raw = mine ? raw : own_raw;
    own_inv = mine ? inv : own_inv;
    if (j % 4 == 3 && live)  // columns j-3..j are final
      *reinterpret_cast<float4*>(S + (s0 + lane) * kLd + s0 + j - 3) =
          make_float4(r[j - 3], r[j - 2], r[j - 1], r[j]);
    float* cj = bcast + (j & 1) * kSub;  // two buffers: step j + 2 reuses this one
    cj[lane] = l;
    x[j] = mine ? 1.0f : 0.0f;  // column j of the inverse row enters at step j
    if (mine && live) {  // rows of X past the edge stay zero
#pragma unroll
      for (int q = 0; q < (j + 1) / 4; ++q)
        *reinterpret_cast<float4*>(Xs + j * kLd + 4 * q) =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
#pragma unroll
      for (int c = (j + 1) / 4 * 4; c <= j; ++c) Xs[j * kLd + c] = x[c];  // columns <= j only
    }
    __syncwarp();
#pragma unroll
    for (int q = (j + 1) / 4; q < kSub / 4; ++q) {
      const float4 v = ld4(cj + 4 * q);
      if (4 * q + 0 > j) r[4 * q + 0] = fmaf(-l, v.x, r[4 * q + 0]);
      if (4 * q + 1 > j) r[4 * q + 1] = fmaf(-l, v.y, r[4 * q + 1]);
      if (4 * q + 2 > j) r[4 * q + 2] = fmaf(-l, v.z, r[4 * q + 2]);
      if (4 * q + 3 > j) r[4 * q + 3] = fmaf(-l, v.w, r[4 * q + 3]);
    }
    const float li = l * inv;
#pragma unroll
    for (int q = 0; q <= j / 4; ++q) {
      const float4 v = ld4(Xs + j * kLd + 4 * q);
      if (4 * q + 0 <= j) x[4 * q + 0] = fmaf(-li, v.x, x[4 * q + 0]);
      if (4 * q + 1 <= j) x[4 * q + 1] = fmaf(-li, v.y, x[4 * q + 1]);
      if (4 * q + 2 <= j) x[4 * q + 2] = fmaf(-li, v.z, x[4 * q + 2]);
      if (4 * q + 3 <= j) x[4 * q + 3] = fmaf(-li, v.w, x[4 * q + 3]);
    }
  }
  float m = live ? own_raw : INFINITY;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nan_min(m, __shfl_xor_sync(kFull, m, o));
  pmin = nan_min(pmin, m);
  __syncwarp();  // every lane has read the unscaled rows before they are replaced
  if (live) {
#pragma unroll
    for (int q = 0; q < kSub / 4; ++q)
      *reinterpret_cast<float4*>(Xs + lane * kLd + 4 * q) =
          make_float4(x[4 * q] * own_inv, x[4 * q + 1] * own_inv, x[4 * q + 2] * own_inv,
                      x[4 * q + 3] * own_inv);
  }
}

// Write L_kk and Dinv_k, both zero above the diagonal, from shared memory to
// the workspace and to dinv.
__device__ __forceinline__ void store_block(const float* S, const float* X, float* A,
                                            float* Db, int n, int kb, int T, bool vec,
                                            int tid) {
  if (vec) {  // T, n and kb are multiples of 4
    const int lt = T / 4;
    for (int t = tid; t < T * lt; t += kDiagThreads) {
      const int i = t / lt, c = 4 * (t - i * lt);
      float4 l = ld4(S + i * kLd + c), x = ld4(X + i * kLd + c);
      l.x = c <= i ? l.x : 0.0f;
      l.y = c + 1 <= i ? l.y : 0.0f;
      l.z = c + 2 <= i ? l.z : 0.0f;
      l.w = c + 3 <= i ? l.w : 0.0f;
      x.x = c <= i ? x.x : 0.0f;
      x.y = c + 1 <= i ? x.y : 0.0f;
      x.z = c + 2 <= i ? x.z : 0.0f;
      x.w = c + 3 <= i ? x.w : 0.0f;
      *reinterpret_cast<float4*>(A + (size_t)(kb + i) * n + kb + c) = l;
      *reinterpret_cast<float4*>(Db + i * T + c) = x;
    }
  } else {
    for (int t = tid; t < T * T; t += kDiagThreads) {
      const int i = t / T, c = t - i * T;
      A[(size_t)(kb + i) * n + kb + c] = c <= i ? S[i * kLd + c] : 0.0f;
      Db[t] = c <= i ? X[i * kLd + c] : 0.0f;
    }
  }
}

// Shared layout of chol_diag_kernel: S (the block, factored in place) and X
// (its inverse; rows of unfinished sub-blocks hold the pending sums P), each
// kTile x kLd floats. S is loaded with cp.async as it stands in the
// workspace; X starts at zero. The row stride kLd = 132 keeps rows 16-byte
// aligned for float4 access, and puts rows i and i+1 four banks apart: a
// float4 access by eight lanes to eight consecutive rows (one shared-memory
// wavefront) touches 32 distinct banks, and a scalar access by 32 lanes to
// 32 consecutive columns of one row is conflict-free.
__global__ void __launch_bounds__(kDiagThreads, 1)
chol_diag_kernel(float* __restrict__ ws, float* __restrict__ dinv,
                 float* __restrict__ piv, int rows, int n, int T, int nb, int k) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  float* X = S + kTile * kLd;
  float* bcast = X + kTile * kLd;  // 2 x 32: the sweep's column broadcast
  const int b = blockIdx.x;
  const int kb = k * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* A = ws + (size_t)b * rows * n;

  const int T4 = (T + 3) & ~3;
  const bool vec = (T % 4 == 0) && (n % 4 == 0);
  float* Db = dinv + ((size_t)b * nb + k) * T * T;
  stage_rows(S, A, n, kb, T, kb + T, kb, 0, T4, T, vec, tid, kDiagThreads);
  cp_async_commit();
  for (int e = tid; e < kTile * kLd / 4; e += kDiagThreads)
    reinterpret_cast<float4*>(X)[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  cp_async_wait<0>();
  __syncthreads();

  float pmin = INFINITY;  // tracked by warp 0, which runs every sweep
  const int nsub = (T + kSub - 1) / kSub;
  for (int s = 0; s < nsub; ++s) {
    const int s0 = s * kSub;
    const int w = min(kSub, T - s0);
    const int e = s0 + w;  // first row below the sub-block
    if (warp == 0) sweep_sub_block(S, X, bcast, s0, w, lane, pmin);
    __syncthreads();

    // 1b, one 32 x 32 tile a warp: items [0, nbelow) are the row tiles of
    // the sub-panel below, L_rs = A_rs X_ss^T, in place; items [nbelow,
    // nbelow + s) the column tiles j < s of the finished rows of the
    // inverse, X_sj = -X_ss P_sj, in place. Rows below exist only when
    // w == 32. Each warp reads all of its tile before it writes it back.
    const int nbelow = nsub - 1 - s;
    const int rg = lane >> 2, cg = lane & 3;
    for (int it = warp; it < nbelow + s; it += kDiagWarps) {
      float acc[4][8];
      if (it < nbelow) {
        const int r0 = e + it * kSub;
        warp_tile<true>(S + r0 * kLd + s0, X + s0 * kLd + s0, lane, acc);
        __syncwarp();
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (r0 + rg + 8 * p < T) S[(r0 + rg + 8 * p) * kLd + s0 + cg + 4 * q] = acc[p][q];
      } else {
        const int c0 = (it - nbelow) * kSub;
        warp_tile<false>(X + s0 * kLd + s0, X + s0 * kLd + c0, lane, acc);
        __syncwarp();
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (rg + 8 * p < w) X[(s0 + rg + 8 * p) * kLd + c0 + 8 * cg + q] = -acc[p][q];
      }
    }
    __syncthreads();
    if (nbelow == 0) continue;

    // 1c, one 32 x 32 tile a warp, for each row tile rt below: the pending
    // sums of the inverse in column tiles ct <= s, P_rj += L_rs X_sj, and
    // the trailing update of the lower part in column tiles s < ct <= rt,
    // A_rt -= L_rs L_ts^T.
    const int nitems = (nsub * (nsub + 1) - (s + 1) * (s + 2)) / 2;
    for (int it = warp; it < nitems; it += kDiagWarps) {
      int rt = s + 1, ct = it;
      while (ct > rt) {  // row tile rt holds rt + 1 items, ct = 0..rt
        ct -= rt + 1;
        ++rt;
      }
      const int r0 = rt * kSub, c0 = ct * kSub;
      float acc[4][8];
      if (ct <= s) {
        warp_tile<false>(S + r0 * kLd + s0, X + s0 * kLd + c0, lane, acc);
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (r0 + rg + 8 * p < T) X[(r0 + rg + 8 * p) * kLd + c0 + 8 * cg + q] += acc[p][q];
      } else {
        warp_tile<true>(S + r0 * kLd + s0, S + c0 * kLd + s0, lane, acc);
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int r = r0 + rg + 8 * p, c = c0 + cg + 4 * q;
            if (r < T && c <= r) S[r * kLd + c] -= acc[p][q];
          }
      }
    }
    __syncthreads();
  }

  store_block(S, X, A, Db, n, kb, T, vec, tid);
  if (tid == 0) piv[b] = nan_min(piv[b], pmin);
}

// Step 2: rows r in [kb + T, rows) of the workspace, A[r][kb + c] =
// sum_{l <= c} A[r][kb + l] Dinv_k[c][l], c < T. Block (x, b) walks the 64-row
// tiles x, x + gridDim.x, ... of matrix b. Warp w owns the 8-column groups w
// and 15 - w (equal work under the triangular bound); within a group, lane
// (rg, ch) = (lane / 2, lane % 2) owns rows rg + 16 p (p < 4) and columns
// 8 g + 4 ch + q (q < 4). The reduction over l stops at the group's last
// column: Dinv_k is zero above its diagonal.
__global__ void __launch_bounds__(kPanelThreads, 1)
panel_solve_kernel(float* __restrict__ ws, const float* __restrict__ dinv, int rows,
                   int n, int T, int nb, int k) {
  extern __shared__ float4 smem4[];
  float* Dk = reinterpret_cast<float*>(smem4);  // kTile x kLd: row c = Dinv_k[c][:]
  float* At = Dk + kTile * kLd;                 // 2 x kPanelRows x kLd
  const int b = blockIdx.y;
  const int kb = k * T;
  const int first = kb + T;
  const int ntiles = (rows - first + kPanelRows - 1) / kPanelRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* A = ws + (size_t)b * rows * n;
  const float* Db = dinv + ((size_t)b * nb + k) * T * T;
  const int T4 = (T + 3) & ~3;
  const bool vec = (T % 4 == 0) && (n % 4 == 0);

  // the strip of L right of the diagonal block, rows [kb, kb + T)
  for (int i = blockIdx.x; i < T; i += gridDim.x)
    for (int c = first + tid; c < n; c += kPanelThreads) A[(size_t)(kb + i) * n + c] = 0.0f;

  stage_rows(Dk, Db, T, 0, T, T, 0, 0, T4, T, vec, tid, kPanelThreads);
  int t = blockIdx.x;
  stage_rows(At, A, n, first + t * kPanelRows, kPanelRows, rows, kb, 0, T4, T, vec, tid,
             kPanelThreads);
  cp_async_commit();

  const int rg = lane >> 1, ch = lane & 1;
  for (int buf = 0; t < ntiles; t += gridDim.x, buf ^= 1) {
    const int tn = t + gridDim.x;
    if (tn < ntiles)
      stage_rows(At + (buf ^ 1) * kPanelRows * kLd, A, n, first + tn * kPanelRows,
                 kPanelRows, rows, kb, 0, T4, T, vec, tid, kPanelThreads);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the prefetch just issued has landed
    __syncthreads();

    const float* Ab = At + buf * kPanelRows * kLd;
    const int r0 = first + t * kPanelRows;
#pragma unroll 1
    for (int gi = 0; gi < 2; ++gi) {
      const int g = gi == 0 ? warp : 15 - warp;
      if (8 * g >= T) continue;
      const int c0 = 8 * g + 4 * ch;
      const int lmax = min(8 * g + 8, T4);
      float acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
#pragma unroll 2
      for (int l = 0; l < lmax; l += 4) {
        float4 a[4], d[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) a[p] = ld4(Ab + (rg + 16 * p) * kLd + l);
#pragma unroll
        for (int q = 0; q < 4; ++q) d[q] = ld4(Dk + (c0 + q) * kLd + l);
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float s = acc[p][q];
            s = fmaf(a[p].x, d[q].x, s);
            s = fmaf(a[p].y, d[q].y, s);
            s = fmaf(a[p].z, d[q].z, s);
            acc[p][q] = fmaf(a[p].w, d[q].w, s);
          }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int r = r0 + rg + 16 * p;
        if (r >= rows) continue;
        float* out = A + (size_t)r * n + kb + c0;
        if (vec) {
          if (c0 < T) *reinterpret_cast<float4*>(out) =
              make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c0 + q < T) out[q] = acc[p][q];
        }
      }
    }
    __syncthreads();  // buffer buf is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();
}

// Step 3: A[i][j] -= sum_{l < T} L[i][l] L[j][l] (L the panel, columns
// [kb, kb + T) of the workspace) for the trailing rows i >= (k + 1) T, RHS
// rows included, and the trailing columns (k + 1) T <= j < n, where j <= i
// or i >= n. Block (x, y, b) owns the 64 x 64 output tile (it0, jt0) of
// matrix b. Both 64 x T panel slices are staged in shared memory by
// cp.async in two halves of the depth, so the copy of the second half
// overlaps the products of the first; the block then runs without a further
// barrier. Thread (tx, ty) owns rows it0 + ty + 16 p and columns
// jt0 + tx + 16 q (p, q < 4) and reads both operands as float4 along the
// depth: two distinct addresses a warp for the rows, sixteen rows four banks
// apart for the columns, so neither read has a bank conflict.
__global__ void __launch_bounds__(kTrailThreads)
trailing_update_kernel(float* __restrict__ ws, int rows, int n, int T, int k) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // kTT x kLd: panel rows it0..
  float* Bs = As + kTT * kLd;                   // kTT x kLd: panel rows jt0..
  const int b = blockIdx.z;
  const int c0 = (k + 1) * T;  // first trailing row/column
  const int it0 = c0 + blockIdx.y * kTT;
  const int jt0 = c0 + blockIdx.x * kTT;
  const int i_end = min(it0 + kTT, rows) - 1;
  // an element (i, j) is needed iff j <= i (lower factor) or i >= n (RHS row)
  if (i_end < n && jt0 > i_end) return;
  const int kb = k * T;
  float* A = ws + (size_t)b * rows * n;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int T4 = (T + 3) & ~3;
  const bool vec = (T % 4 == 0) && (n % 4 == 0);
  const int half = (T4 / 2 + 3) & ~3;
  stage_rows(As, A, n, it0, kTT, rows, kb, 0, half, T, vec, tid, kTrailThreads);
  stage_rows(Bs, A, n, jt0, kTT, n, kb, 0, half, T, vec, tid, kTrailThreads);
  cp_async_commit();
  stage_rows(As, A, n, it0, kTT, rows, kb, half, T4, T, vec, tid, kTrailThreads);
  stage_rows(Bs, A, n, jt0, kTT, n, kb, half, T4, T, vec, tid, kTrailThreads);
  cp_async_commit();

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    if (h == 0) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
#pragma unroll 2
    for (int l = h == 0 ? 0 : half; l < (h == 0 ? half : T4); l += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) a[p] = ld4(As + (ty + 16 * p) * kLd + l);
#pragma unroll
      for (int q = 0; q < 4; ++q) bb[q] = ld4(Bs + (tx + 16 * q) * kLd + l);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float s = acc[p][q];
          s = fmaf(a[p].x, bb[q].x, s);
          s = fmaf(a[p].y, bb[q].y, s);
          s = fmaf(a[p].z, bb[q].z, s);
          acc[p][q] = fmaf(a[p].w, bb[q].w, s);
        }
    }
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = it0 + ty + 16 * p;
    if (i >= rows) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = jt0 + tx + 16 * q;
      if (j < n && (i >= n || j <= i)) A[(size_t)i * n + j] -= acc[p][q];
    }
  }
}

constexpr int kSmemDiag = (2 * kTile * kLd + 2 * kSub) * (int)sizeof(float);
constexpr int kSmemPanel = (kTile + 2 * kPanelRows) * kLd * (int)sizeof(float);
constexpr int kSmemTrail = 2 * kTT * kLd * (int)sizeof(float);

// Per device, once per process: lift the dynamic shared-memory cap of
// the three kernels and read the SM count. The writes are idempotent, so two
// threads racing through it set the same values.
std::atomic<int> g_sms[kMaxDevices];

int device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int known = g_sms[dev].load();
  if (known <= 0) {
    err = cudaFuncSetAttribute(chol_diag_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDiag);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(panel_solve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPanel);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(trailing_update_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemTrail);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&known, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    g_sms[dev].store(known);
  }
  *sms = known;
  return 0;
}

}  // namespace

// ws:   (Bt, rows, n) float32 workspace, rows [0, n) = R, rows [n, rows) = B^T;
//       on return rows [0, n) hold L (upper triangle zeroed) and rows
//       [n, rows) hold W^T.
// dinv: (Bt, n / T, T, T) float32 output; piv: (Bt,) float32, preset to +inf.
// T = min(n, 128) and n % T == 0 (checked by the Python wrapper).
// Returns the first non-zero cudaError_t of the launch sequence, else 0.
extern "C" int botorch_whiten(void* ws, void* dinv, void* piv, int Bt, int rows,
                              int n, int T, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = n / T;
  int sms = 0;
  cudaError_t err = (cudaError_t)device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  // panel blocks per matrix: enough to fill the card once across the batch
  const int panel_per_matrix = sms / Bt > 1 ? sms / Bt : 1;

  for (int k = 0; k < nb; ++k) {
    chol_diag_kernel<<<Bt, kDiagThreads, kSmemDiag, s>>>(
        (float*)ws, (float*)dinv, (float*)piv, rows, n, T, nb, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int nr = rows - (k + 1) * T;  // rows below the diagonal block
    if (nr <= 0) continue;
    const int ntiles = (nr + kPanelRows - 1) / kPanelRows;
    const dim3 pgrid(ntiles < panel_per_matrix ? ntiles : panel_per_matrix, Bt);
    panel_solve_kernel<<<pgrid, kPanelThreads, kSmemPanel, s>>>(
        (float*)ws, (const float*)dinv, rows, n, T, nb, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int nc = n - (k + 1) * T;     // trailing columns
    if (nc <= 0) continue;
    const dim3 tgrid((nc + kTT - 1) / kTT, (nr + kTT - 1) / kTT, Bt);
    trailing_update_kernel<<<tgrid, kTrailThreads, kSmemTrail, s>>>((float*)ws, rows, n, T, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
