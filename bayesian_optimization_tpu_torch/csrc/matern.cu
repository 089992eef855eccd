// Fused weighted-distance + Matern/RBF correlation matrix for Hopper (sm_90a).
//
// Replaces the TPU kernel `matern_pallas` / `_matern_tile_kernel` of
// bayesian_optimization_tpu/ops/pallas_kernels.py.
//
//   K[b, i, j] = phi_nu( sqrt( sum_d max(theta[b, d], 0) (X[i, d] - Y[j, d])^2 ) )
//
// with phi for nu in {1/2, 3/2, 5/2}, or exp(-r^2) (RBF). `sym` sets an exact
// unit diagonal (training correlation). Every restart lane of the MLE ladder
// has its own theta, so theta carries a leading batch axis b; X and Y are
// shared by all lanes.
//
// What bounds it on this card: the output. At the bench shapes (B = 10
// lanes, 1024 x 1024, D = 5) the kernel reads ~40 KB of X/Y and writes 40 MB
// of K, and computes ~15 flops plus one expf per output element, so it is
// bound by the bytes it writes (~12 us at 3.35 TB/s). The design keeps
// everything else out of device memory: the per-element distance is computed
// directly as sum_d theta_d (x - y)^2 (D is small, and the direct form avoids
// the cancellation of the GEMM expansion that the TPU kernel used for its
// matrix unit), the kernel map is applied in registers, and each output
// element is written exactly once, by coalesced 128-byte warp stores. There
// is no (N, M) r^2 intermediate. The ragged edge is masked, so N and M need
// not be multiples of any tile (predict's query counts and the 16/64 buckets
// are not aligned).
//
// Tile: a 32 x 32 output tile per block of 32 x 8 threads, four rows per
// thread; X and Y rows of the tile are staged through shared memory in
// chunks of 32 features, with theta beside them.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;   // blockDim.y = kTile / kRowsPerThread
constexpr int kThreadsY = kTile / kRowsPerThread;
constexpr int kDChunk = 32;

// nu_code: 1 -> nu = 1/2, 3 -> nu = 3/2, 5 -> nu = 5/2, 0 -> RBF.
__device__ __forceinline__ float kernel_map(float r2, int nu_code) {
  if (nu_code == 0) return expf(-r2);
  const float r = sqrtf(fmaxf(r2, 1e-30f));
  if (nu_code == 1) return expf(-r);
  if (nu_code == 3) {
    const float s = 1.7320508075688772f * r;
    return (1.0f + s) * expf(-s);
  }
  const float s = 2.23606797749979f * r;
  return (1.0f + s + s * s / 3.0f) * expf(-s);
}

__global__ void matern_kernel(const float* __restrict__ theta,
                              const float* __restrict__ X,
                              const float* __restrict__ Y,
                              float* __restrict__ K, int N, int M, int D,
                              int nu_code, int sym) {
  __shared__ float xs[kTile][kDChunk + 1];
  __shared__ float ys[kTile][kDChunk + 1];
  __shared__ float th[kDChunk];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const float* th_b = theta + (size_t)b * D;

  float acc[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += kDChunk) {
    const int dc = min(kDChunk, D - d0);
    for (int e = tid; e < kTile * kDChunk; e += kTile * kThreadsY) {
      const int r = e / kDChunk;
      const int c = e % kDChunk;
      float xv = 0.0f, yv = 0.0f;
      if (c < dc) {
        if (i0 + r < N) xv = X[(size_t)(i0 + r) * D + d0 + c];
        if (j0 + r < M) yv = Y[(size_t)(j0 + r) * D + d0 + c];
      }
      xs[r][c] = xv;
      ys[r][c] = yv;
    }
    if (tid < kDChunk) th[tid] = (tid < dc) ? fmaxf(th_b[d0 + tid], 0.0f) : 0.0f;
    __syncthreads();
    for (int c = 0; c < dc; ++c) {
      const float yv = ys[tx][c];
      const float w = th[c];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const float diff = xs[ty + kThreadsY * q][c] - yv;
        acc[q] = fmaf(w * diff, diff, acc[q]);
      }
    }
    __syncthreads();
  }

  const int j = j0 + tx;
  if (j >= M) return;
  float* Kb = K + (size_t)b * N * M;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int i = i0 + ty + kThreadsY * q;
    if (i < N) {
      Kb[(size_t)i * M + j] = (sym && i == j) ? 1.0f : kernel_map(acc[q], nu_code);
    }
  }
}

}  // namespace

// theta: (B, D), X: (N, D), Y: (M, D), K: (B, N, M); all float32, contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int botorch_matern(const void* theta, const void* X, const void* Y,
                              void* K, int B, int N, int M, int D, int nu_code,
                              int sym, void* stream) {
  const dim3 block(kTile, kThreadsY);
  const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile, B);
  matern_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)X, (const float*)Y, (float*)K, N, M,
      D, nu_code, sym);
  return (int)cudaGetLastError();
}

// Human-readable name of a cudaError_t returned by the entry points above.
extern "C" const char* botorch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
