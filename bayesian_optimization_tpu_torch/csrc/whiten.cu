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
// that design does not carry over: the matrix streams through L2 (50 MB
// holds the whole batch at the bench sizes). The flops are n^3/3 per matrix
// (0.36 GFLOP at n = 1024), small against the card; what bounds it is the
// sequential depth of the factorisation (nb = n/128 panels, each a chain of
// 128 dependent column steps) and, at the ladder's batch sizes of 2..10,
// how many SMs one step can keep busy.
//
// Design (b): one launch sequence per 128-panel step k, all on the caller's
// stream, with no host synchronisation:
//   1. chol_diag_kernel, one block per batch entry: factors the T x T
//      diagonal block in shared memory by a right-looking column sweep that
//      builds the block's inverse in the same sweep (forward substitution
//      of L X = I, one row of X per column of L), records the raw pivots,
//      writes L_kk and Dinv_k, and zeros the strip of L right of the block;
//   2. panel_solve_kernel, a grid over 32-row tiles of every row below the
//      block (RHS rows included): L_ik = A_ik Dinv_k^T, with Dinv_k staged
//      in shared memory;
//   3. trailing_update_kernel, a grid over 64 x 64 tiles of the lower
//      trailing part (and all RHS rows): A -= L_ik L_jk^T, a tiled GEMM.
// Design (a) -- one block per matrix for the whole factorisation, as on the
// TPU -- would use 2..10 of 132 SMs at the ladder's batch sizes; (b) spreads
// steps 2 and 3, which hold ~all of the flops, over many blocks, and keeps
// only the 128-column sweep on one block per matrix. A block of 128^2 floats
// is 64 KB, so steps 1 and 2 use dynamic shared memory above 48 KB.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kDiagWarps = 8;
constexpr int kPanelRows = 32;
constexpr int kPanelThreads = 256;
constexpr int kTT = 64;   // trailing-update output tile edge
constexpr int kTK = 16;   // trailing-update reduction chunk

__device__ __forceinline__ float nan_min(float a, float b) {
  // min that propagates NaN from either side (jnp.minimum semantics)
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__global__ void chol_diag_kernel(float* __restrict__ ws, float* __restrict__ dinv,
                                 float* __restrict__ piv, int rows, int n, int T,
                                 int nb, int k) {
  // blockDim = (32, kDiagWarps): lane tx walks columns, warp ty walks rows
  extern __shared__ float smem[];
  const int ld = T + 1;
  float* S = smem;           // T x ld: the block, factored in place
  float* Li = smem + T * ld; // T x ld: its inverse, built alongside
  const int b = blockIdx.x;
  const int kb = k * T;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  const int nt = 32 * blockDim.y;
  float* A = ws + (size_t)b * rows * n;

  for (int i = ty; i < T; i += blockDim.y) {
    for (int c = tx; c < T; c += 32) {
      S[i * ld + c] = (c <= i) ? A[(size_t)(kb + i) * n + kb + c] : 0.0f;
      Li[i * ld + c] = (c == i) ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  // Right-looking column sweep. Step j finalizes column j of L (S) and row
  // j of L^-1 (Li, forward substitution of L X = I run in the same sweep),
  // then applies both rank-1 updates to the rows below j.
  float pmin = INFINITY;  // tracked by thread 0
  for (int j = 0; j < T; ++j) {
    const float raw = S[j * ld + j];
    const float d = sqrtf(raw > 1e-12f ? raw : 1e-12f);
    if (tid == 0) pmin = nan_min(pmin, raw);
    __syncthreads();  // every thread has read the pivot before it is replaced
    for (int i = j + 1 + tid; i < T; i += nt) S[i * ld + j] = S[i * ld + j] / d;
    for (int c = tid; c <= j; c += nt) Li[j * ld + c] = Li[j * ld + c] / d;
    if (tid == 0) S[j * ld + j] = d;
    __syncthreads();
    for (int i = j + 1 + ty; i < T; i += blockDim.y) {
      const float lij = S[i * ld + j];
      for (int c = tx; c <= i; c += 32) {
        if (c <= j) {
          Li[i * ld + c] -= lij * Li[j * ld + c];
        } else {
          S[i * ld + c] -= lij * S[c * ld + j];
        }
      }
    }
    __syncthreads();
  }

  float* Db = dinv + ((size_t)b * nb + k) * T * T;
  for (int i = ty; i < T; i += blockDim.y) {
    for (int c = tx; c < T; c += 32) {
      A[(size_t)(kb + i) * n + kb + c] = (c <= i) ? S[i * ld + c] : 0.0f;
      Db[i * T + c] = (c <= i) ? Li[i * ld + c] : 0.0f;
    }
    for (int c = T + tx; c < n - kb; c += 32) {  // the strip right of the block
      A[(size_t)(kb + i) * n + kb + c] = 0.0f;
    }
  }
  if (tid == 0) piv[b] = nan_min(piv[b], pmin);
}

__global__ void panel_solve_kernel(float* __restrict__ ws,
                                   const float* __restrict__ dinv, int rows,
                                   int n, int T, int nb, int k) {
  extern __shared__ float smem[];
  const int ld = T + 1;
  float* Dk = smem;            // T x ld
  float* At = smem + T * ld;   // kPanelRows x ld
  const int b = blockIdx.y;
  const int kb = k * T;
  const int r0 = kb + T + blockIdx.x * kPanelRows;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* A = ws + (size_t)b * rows * n;
  const float* Db = dinv + ((size_t)b * nb + k) * T * T;

  for (int e = tid; e < T * T; e += nt) Dk[(e / T) * ld + e % T] = Db[e];
  for (int e = tid; e < kPanelRows * T; e += nt) {
    const int r = e / T, c = e % T;
    At[r * ld + c] = (r0 + r < rows) ? A[(size_t)(r0 + r) * n + kb + c] : 0.0f;
  }
  __syncthreads();
  for (int e = tid; e < kPanelRows * T; e += nt) {
    const int r = e / T, c = e % T;
    if (r0 + r >= rows) continue;
    float s = 0.0f;
    for (int l = 0; l <= c; ++l) s = fmaf(At[r * ld + l], Dk[c * ld + l], s);
    A[(size_t)(r0 + r) * n + kb + c] = s;
  }
}

__global__ void trailing_update_kernel(float* __restrict__ ws, int rows, int n,
                                       int T, int k) {
  __shared__ float As[kTK][kTT + 4];
  __shared__ float Bs[kTK][kTT + 4];
  const int b = blockIdx.z;
  const int c0 = (k + 1) * T;         // first trailing row/column
  const int it0 = c0 + blockIdx.y * kTT;
  const int jt0 = c0 + blockIdx.x * kTT;
  const int i_end = min(it0 + kTT, rows) - 1;
  // an element (i, j) is needed iff j <= i (lower factor) or i >= n (RHS row)
  if (i_end < n && jt0 > i_end) return;
  const int kb = k * T;
  float* A = ws + (size_t)b * rows * n;
  const int tx = threadIdx.x, ty = threadIdx.y;  // 16 x 16
  const int tid = ty * 16 + tx;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;

  for (int l0 = 0; l0 < T; l0 += kTK) {
    for (int e = tid; e < kTT * kTK; e += 256) {
      const int r = e / kTK, c = e % kTK;
      const int l = l0 + c;
      const int ia = it0 + r, jb = jt0 + r;
      As[c][r] = (ia < rows && l < T) ? A[(size_t)ia * n + kb + l] : 0.0f;
      Bs[c][r] = (jb < n && l < T) ? A[(size_t)jb * n + kb + l] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kTK; ++c) {
      float av[4], bv[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) av[p] = As[c][ty + 16 * p];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = Bs[c][tx + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
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
  const int smem_diag = 2 * T * (T + 1) * (int)sizeof(float);
  const int smem_panel = (T + kPanelRows) * (T + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chol_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_diag);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(panel_solve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_panel);
  if (err != cudaSuccess) return (int)err;

  for (int k = 0; k < nb; ++k) {
    chol_diag_kernel<<<Bt, dim3(32, kDiagWarps), smem_diag, s>>>(
        (float*)ws, (float*)dinv, (float*)piv, rows, n, T, nb, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int nr = rows - (k + 1) * T;  // rows below the diagonal block
    if (nr <= 0) continue;
    const dim3 pgrid((nr + kPanelRows - 1) / kPanelRows, Bt);
    panel_solve_kernel<<<pgrid, kPanelThreads, smem_panel, s>>>(
        (float*)ws, (const float*)dinv, rows, n, T, nb, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int nc = n - (k + 1) * T;     // trailing columns
    if (nc <= 0) continue;
    const dim3 tgrid((nc + kTT - 1) / kTT, (nr + kTT - 1) / kTT, Bt);
    trailing_update_kernel<<<tgrid, dim3(16, 16), 0, s>>>((float*)ws, rows, n, T, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
