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
// ~56 K FP32 operations (~1 ns at 67 TFLOP/s): latency is the whole call,
// and a Hessian of dimension D makes D of them, one launch each. So the
// design spreads a row's B M pairs over the card and keeps one launch: S
// blocks per row i of X (S about 2 x 132 / N, none with fewer than 256
// pairs), block s taking a contiguous run of the row's pairs, its threads
// striding over them in a fixed order with a register sum per feature (in
// chunks of 8 features, the pair's scalars recomputed per chunk), then a
// fixed-order block reduction (warp shuffles, then the warps' sums in
// order). gG needs no reduction and is written per pair. With S = 1 the
// block writes gX itself; else it writes its partial to scratch, and the
// last block to arrive (last_block.cuh) sums the S partials of every row in
// a fixed order. No floating-point atomics, so repeated calls are
// bit-identical.
#include <cuda_runtime.h>

#include <algorithm>

#include "last_block.cuh"

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;          // features summed in registers at a time
constexpr int kBlocksPerSm = 2;    // the blocks a call aims at, per SM
constexpr int kMaxSmem = 226 * 1024;  // dynamic shared memory, bytes: w, a row of X and of V
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

// Block (s, i) of row i (blockIdx.x = i S + s) takes the pairs [s P / S,
// (s + 1) P / S) of the row's P = B M and writes its gX sums to gX (S = 1) or
// to part[s][i][k], which the last block sums over s. gG (B, N, M) and gX
// (N, D) are each written when not null.
__global__ void __launch_bounds__(kThreads)
matern_bwd2_kernel(const float* __restrict__ theta, const float* __restrict__ X,
                   const float* __restrict__ Y, const float* __restrict__ G,
                   const float* __restrict__ V, float* __restrict__ gG, float* __restrict__ gX,
                   float* __restrict__ part, unsigned int* __restrict__ counter, int B, int N,
                   int M, int D, int code, int sym, int S) {
  extern __shared__ float sm[];  // w (B, D), then row i of X and of V
  __shared__ float red[kWarps][kChunk];
  float* w = sm;
  float* xi = w + (size_t)B * D;
  float* vi = xi + D;
  const int i = blockIdx.x / S, s = blockIdx.x % S;
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
  const long long p0 = pairs * s / S, p1 = pairs * (s + 1) / S;
  float* out = S == 1 ? gX : part + (size_t)s * N * D;
  for (int k0 = 0; k0 < D; k0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc[k] = 0.0f;
    for (long long p = p0 + threadIdx.x; p < p1; p += kThreads) {
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
        const float p1v = 2.0f * Gv * h, q = 4.0f * Gv * h2 * c;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int l = k0 + k;
          if (l < D) acc[k] = fmaf(wb[l], fmaf(p1v, vi[l], q * (xi[l] - yj[l])), acc[k]);
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
      float v = 0.0f;
      for (int q = 0; q < kWarps; ++q) v += red[q][threadIdx.x];
      out[(size_t)i * D + k0 + threadIdx.x] = v;
    }
    __syncthreads();
  }
  if (gX == nullptr || S == 1 || !arrive_last(counter)) return;
  const long long ND = (long long)N * D;
  reduce_outputs(
      ND, S, [&](long long o, long long e) { return __ldcg(part + e * ND + o); },
      [&](long long o, float v) { gX[o] = v; });
}

// Blocks per row of X: enough that the N rows' blocks fill the card (about
// kBlocksPerSm an SM of `sms`), none with fewer than kThreads pairs.
int row_splits(int B, int N, int M, int sms) {
  const long long by_work = ((long long)B * M + kThreads - 1) / kThreads;
  const long long by_card = (long long)kBlocksPerSm * std::max(sms, 1) / std::max(N, 1);
  return (int)std::max(1LL, std::min(by_work, by_card));
}

}  // namespace

// Floats of scratch that botorch_matern_bwd2 needs for these shapes on a
// card of `sms` SMs.
extern "C" long long botorch_matern_bwd2_scratch(int B, int N, int M, int D, int sms) {
  const int S = row_splits(B, N, M, sms);
  return S > 1 ? (long long)S * N * D : 0;
}

// theta (B, D), X (N, D), Y (M, D), G (B, N, M), V (N, D), float32,
// contiguous; gG (B, N, M) and gX (N, D) are written where not null.
// nu_code in {0, 1, 3, 5}; (B + 2) D floats of dynamic shared memory, at
// most kMaxSmem bytes (the wrapper checks). scratch holds
// botorch_matern_bwd2_scratch(...) floats; counter is an unsigned int in
// device memory, 0 and used by no other launch in flight (the kernel leaves
// it 0); sms the card's SM count. One launch; returns its cudaError_t.
extern "C" int botorch_matern_bwd2(const void* theta, const void* X, const void* Y, const void* G,
                                   const void* V, void* gG, void* gX, void* scratch,
                                   void* counter, int B, int N, int M, int D, int nu_code, int sym,
                                   int sms, void* stream) {
  if (N == 0) return 0;
  const int S = row_splits(B, N, M, sms);
  const size_t smem = sizeof(float) * ((size_t)B + 2) * D;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const int err = allow_smem((const void*)matern_bwd2_kernel, kMaxSmem);
    if (err != 0) return err;
  }
  matern_bwd2_kernel<<<(unsigned)((long long)N * S), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)X, (const float*)Y, (const float*)G, (const float*)V,
      (float*)gG, (float*)gX, (float*)scratch, (unsigned int*)counter, B, N, M, D, nu_code, sym,
      S);
  return (int)cudaGetLastError();
}
