// The Matern/RBF correlation's second derivative in its first argument, for
// Hessians of the GP posterior (GaussianProcess.Hessian) on Hopper (sm_90a).
//
// The TPU kernel `matern_pallas` of bayesian_optimization_tpu/ops/
// pallas_kernels.py has no derivative of its own: the JAX package
// differentiates its XLA form, twice for a Hessian. matern.cu's backward
// gives dX[i, k] = sum_{b,j} G_bij dK_bij/dx_ik. This kernel is that
// backward's own backward in G and X: for V = dL/d(dX) (N, D),
//   gG[b, i, j] = sum_k V_ik dK_bij/dx_ik = 2 h_bij c_bij,
//   gX[i, k]    = sum_{b,j} G_bij sum_l d2K_bij/(dx_ik dx_il) V_il
//               = sum_b w_bk sum_j G_bij (2 h_bij V_ik + 4 h2_bij c_bij d_ijk),
// with d_ijk = x_ik - y_jk, w = max(theta, 0), c_bij = sum_l w_bl d_ijl V_il,
// h = dK/dr2 and h2 = d2K/dr2^2 of the map, both zero where r2 <= 1e-30 for
// Matern (as the JAX package's _safe_sqrt makes them) and, with sym, on the
// unit diagonal.
//
// What bounds it: at a Hessian's shapes, (B, N, M) = (1, 1, 1024), D = 5,
// it reads G and Y and writes gG, ~29 KB (8.6 ns at 3.35 TB/s), and does
// ~56 K FP32 operations (~1 ns at 67 TFLOP/s): one launch's latency is the
// whole call, and a Hessian of dimension D makes D of them. So the design is the
// simplest that is deterministic: one block per row i of X, its threads
// striding over the (b, j) pairs in a fixed order with a register sum per
// feature (in chunks of 8 features, the pair's scalars recomputed per
// chunk), then a fixed-order block reduction (warp shuffles, then the
// warps' sums in order). No atomics, so repeated calls are bit-identical.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;      // features summed in registers at a time
constexpr float kR2Floor = 1e-30f;
constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.23606797749979f;

// (h, h2) = (dK/dr2, d2K/dr2^2) of the map; code as matern.cu's:
// 1 -> nu = 1/2, 3 -> nu = 3/2, 5 -> nu = 5/2, 0 -> RBF exp(-r2).
__device__ __forceinline__ void map_derivs(float r2, int code, float& h, float& h2) {
  if (code == 0) {
    const float k = expf(-r2);
    h = -k;
    h2 = k;
    return;
  }
  if (!(r2 > kR2Floor)) {
    h = 0.0f;
    h2 = 0.0f;
    return;
  }
  const float r = sqrtf(r2);
  if (code == 1) {
    const float e = expf(-r);
    h = -0.5f * e / r;                      // -exp(-r) / (2 r)
    h2 = 0.25f * e * (1.0f + r) / (r2 * r);  // exp(-r) (1 + r) / (4 r^3)
  } else if (code == 3) {
    const float e = expf(-kSqrt3 * r);
    h = -1.5f * e;
    h2 = (0.75f * kSqrt3) * e / r;
  } else {
    const float s = kSqrt5 * r;
    const float e = expf(-s);
    h = (-5.0f / 6.0f) * (1.0f + s) * e;
    h2 = (25.0f / 12.0f) * e;
  }
}

// One block per row i of X. gG (B, N, M) and gX (N, D) are each written
// when not null.
__global__ void __launch_bounds__(kThreads)
matern_bwd2_kernel(const float* __restrict__ theta, const float* __restrict__ X,
                   const float* __restrict__ Y, const float* __restrict__ G,
                   const float* __restrict__ V, float* __restrict__ gG, float* __restrict__ gX,
                   int B, int N, int M, int D, int code, int sym) {
  extern __shared__ float sm[];  // w (B, D), then row i of X and of V
  __shared__ float red[kWarps][kChunk];
  float* w = sm;
  float* xi = w + (size_t)B * D;
  float* vi = xi + D;
  const int i = blockIdx.x;
  for (int t = threadIdx.x; t < B * D; t += kThreads) {
    const float th = theta[t];
    w[t] = (th > 0.0f || th != th) ? th : 0.0f;  // max(theta, 0), NaN kept as torch's clamp
  }
  for (int t = threadIdx.x; t < D; t += kThreads) {
    xi[t] = X[(size_t)i * D + t];
    vi[t] = V[(size_t)i * D + t];
  }
  __syncthreads();
  const long long pairs = (long long)B * M;
  for (int k0 = 0; k0 < D; k0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc[k] = 0.0f;
    for (long long p = threadIdx.x; p < pairs; p += kThreads) {
      const int b = (int)(p / M), j = (int)(p % M);
      const float* wb = w + (size_t)b * D;
      const float* yj = Y + (size_t)j * D;
      float r2 = 0.0f, c = 0.0f;
      for (int l = 0; l < D; ++l) {
        const float d = xi[l] - yj[l];
        const float wd = wb[l] * d;
        r2 = fmaf(wd, d, r2);
        c = fmaf(wd, vi[l], c);
      }
      float h, h2;
      map_derivs(r2, code, h, h2);
      if (sym && i == j) {
        h = 0.0f;
        h2 = 0.0f;
      }
      const size_t g = ((size_t)b * N + i) * M + j;
      if (gG != nullptr && k0 == 0) gG[g] = 2.0f * h * c;
      if (gX != nullptr) {
        const float Gv = G[g];
        const float p1 = 2.0f * Gv * h, q = 4.0f * Gv * h2 * c;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int l = k0 + k;
          if (l < D) acc[k] = fmaf(wb[l], fmaf(p1, vi[l], q * (xi[l] - yj[l])), acc[k]);
        }
      }
    }
    if (gX == nullptr) break;  // gG is written in the first pass
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      float v = acc[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5][k] = v;
    }
    __syncthreads();
    if (threadIdx.x < kChunk && k0 + (int)threadIdx.x < D) {
      float s = 0.0f;
      for (int q = 0; q < kWarps; ++q) s += red[q][threadIdx.x];
      gX[(size_t)i * D + k0 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

}  // namespace

// theta (B, D), X (N, D), Y (M, D), G (B, N, M), V (N, D), float32,
// contiguous; gG (B, N, M) and gX (N, D) are written where not null.
// nu_code in {0, 1, 3, 5}; (B + 2) D floats of dynamic shared memory, at
// most 48 KB (the wrapper checks). One launch; returns its cudaError_t.
extern "C" int botorch_matern_bwd2(const void* theta, const void* X, const void* Y, const void* G,
                                   const void* V, void* gG, void* gX, int B, int N, int M, int D,
                                   int nu_code, int sym, void* stream) {
  if (N == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)B + 2) * D;
  matern_bwd2_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)X, (const float*)Y, (const float*)G, (const float*)V,
      (float*)gG, (float*)gX, B, N, M, D, nu_code, sym);
  return (int)cudaGetLastError();
}
