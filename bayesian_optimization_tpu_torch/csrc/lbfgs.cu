// One trip's update of the batched L-BFGS, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package runs `_lbfgs_compact`
// (bayesian_optimization_tpu/ops/optimize.py) under `jit`, where XLA fuses
// the optimizer's own arithmetic into the loop body. The port runs eagerly,
// and the same arithmetic on a few lanes of a few floats each (the
// acceptance tests, the curvature pair, the two-loop recursion over the
// history and the masked rebuild of the lanes' state) was ~180 launches of
// small PyTorch kernels a trip, which the host issues one by one. This
// kernel does that update in one launch. `lbfgs_update_plain`
// (ops/optimize.py) is its twin and defines the semantics.
//
// What bounds it on this card: neither bytes nor operations. A lane's state
// is (3 + 2 m) d + 2 m + 8 floats and ints (~1 KB at d = 5, m = 10), read
// and written once; the work is ~4 m d multiply-adds. What is left is the
// chain of dependent steps of the recursion: 2 m + 5 dot products, each a
// warp-shuffle reduction, one after the other.
//
// Design: one warp a live lane, 4 lanes a block, a grid over the trip's index
// `idx` only, so a lane that is not live is never read or written: neither
// one left out of idx nor one whose entry is -1 (a trip at the full width of
// the lanes names its lanes that are not live so, and its shapes stay fixed). A
// warp's thread owns the elements i = lane, lane + 32, ... of each of the
// lane's d-vectors, so any d runs (a strided loop) and no thread reads an
// element another thread writes; the recursion's working vector lives in
// the lane's own row of p, which the step rewrites anyway, and its m
// coefficients in a scratch row of the workspace, so any history length m
// runs too (a loop over it). The dot products reduce by a butterfly of
// shuffles: every thread ends with the same bits, so each decision is the
// warp's, and a repeated launch on the same inputs gives the same bits.
// The Armijo and curvature tests are rounded as the twin's separate PyTorch
// operations round them (no contraction into an FMA), so the kernel takes
// the twin's decisions wherever its reductions agree with the twin's to
// within a rounding; the values agree to float32 rounding.
//
// The state is two workspaces that `lbfgs_state` allocates once a run, laid
// out field after field, each field (R, ...) contiguous over the R lanes:
//   float32: z, g, p (R, d); S, Y (R, m, d); rho, alpha (R, m); f, gamma,
//            gTp, t (R)
//   int64:   k, n_probe, n_accept, done (R)
// (ops/optimize.py `_LBFGS_FLOAT_FIELDS`, `_LBFGS_INT_FIELDS`).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanesPerBlock = 4;  // one warp an L-BFGS lane

struct State {
  float *z, *g, *p, *S, *Y, *rho, *alpha, *f, *gamma, *gTp, *t;
  long long *k, *n_probe, *n_accept, *done;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float finite_or_zero(float v) { return isfinite(v) ? v : 0.0f; }

__global__ void __launch_bounds__(kLanesPerBlock * 32)
lbfgs_update_kernel(State st, const long long* __restrict__ idx, const float* __restrict__ f_a,
                    const float* __restrict__ g_a, const float* __restrict__ z_trial, int n_live,
                    int d, int m, float c1, long long max_ls) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kLanesPerBlock + (threadIdx.x >> 5);
  if (j >= n_live) return;  // the whole warp: j is the warp's
  const long long r = idx[j];
  if (r < 0) return;  // an entry of -1 names no lane
  const float f = st.f[r], t = st.t[r], ft = f_a[j];
  const long long n_probe = st.n_probe[r];

  // Armijo f_t <= f + (c1 t) gTp, rounded operation by operation; else the
  // line search's cap concludes the step
  const bool armijo = ft <= __fadd_rn(f, __fmul_rn(__fmul_rn(c1, t), st.gTp[r]));
  if (!armijo && n_probe < max_ls) {  // a probe: halve the step and try again
    if (lane == 0) {
      st.t[r] = 0.5f * t;
      st.n_probe[r] = n_probe + 1;
    }
    return;
  }

  float* z = st.z + (size_t)r * d;
  float* g = st.g + (size_t)r * d;
  float* p = st.p + (size_t)r * d;
  const float* zt = z_trial + (size_t)r * d;
  const float* ga = g_a + (size_t)j * d;

  // the step concludes: accepted if finite and not worse
  bool z_finite = true;
  for (int i = lane; i < d; i += 32) z_finite &= isfinite(zt[i]);
  const bool good = __all_sync(kFull, z_finite) && isfinite(ft) && ft <= f;

  // s = z_new - z, y = g_new - g (zero on a rejected step)
  float sy = 0.0f, ss = 0.0f, yy = 0.0f;
  for (int i = lane; i < d; i += 32) {
    const float s = (good ? zt[i] : z[i]) - z[i];
    const float y = (good ? finite_or_zero(ga[i]) : g[i]) - g[i];
    sy += s * y;
    ss += s * s;
    yy += y * y;
  }
  sy = warp_sum(sy);
  ss = warp_sum(ss);
  yy = warp_sum(yy);
  const bool curv_ok =
      good && sy > __fadd_rn(__fmul_rn(__fmul_rn(1e-10f, sqrtf(ss)), sqrtf(yy)), 1e-30f);

  // the pair into slot k mod m where its curvature holds; z and g move on
  const long long k = st.k[r];
  const int slot = (int)(k % m);
  float* S_k = st.S + ((size_t)r * m + slot) * d;
  float* Y_k = st.Y + ((size_t)r * m + slot) * d;
  for (int i = lane; i < d; i += 32) {
    const float zn = good ? zt[i] : z[i];
    const float gn = good ? finite_or_zero(ga[i]) : g[i];
    if (curv_ok) {
      S_k[i] = zn - z[i];
      Y_k[i] = gn - g[i];
    }
    z[i] = zn;
    g[i] = gn;
  }
  float* rho = st.rho + (size_t)r * m;
  float* alpha = st.alpha + (size_t)r * m;
  const long long kn = k + (curv_ok ? 1 : 0);
  const float gamma = curv_ok ? sy / fmaxf(yy, 1e-30f) : st.gamma[r];
  if (curv_ok && lane == 0) rho[slot] = 1.0f / fmaxf(sy, 1e-30f);
  __syncwarp();  // rho[slot] seen by the whole warp

  // -H g by the two-loop recursion, H0 = gamma I, the history in age order
  // (step b reads slot (kn - 1 - b) mod m), valid * rho folded into the
  // dot products and valid into the updates, as the twin's `_direction`
  const long long nv = kn < m ? kn : m;
  for (int i = lane; i < d; i += 32) p[i] = g[i];  // q
  for (int b = 0; b < m; ++b) {
    const int sl = (int)(((kn - 1 - b) % m + m) % m);
    const float vr = (b < nv ? 1.0f : 0.0f) * rho[sl];
    const float* S_b = st.S + ((size_t)r * m + sl) * d;
    const float* Y_b = st.Y + ((size_t)r * m + sl) * d;
    float a = 0.0f;
    for (int i = lane; i < d; i += 32) a += (S_b[i] * vr) * p[i];
    a = warp_sum(a);
    if (lane == 0) alpha[b] = a;
    for (int i = lane; i < d; i += 32) p[i] -= a * Y_b[i];
  }
  __syncwarp();  // alpha seen by the whole warp
  for (int i = lane; i < d; i += 32) p[i] *= gamma;  // r
  for (int b = m - 1; b >= 0; --b) {
    const int sl = (int)(((kn - 1 - b) % m + m) % m);
    const float valid = b < nv ? 1.0f : 0.0f;
    const float vr = valid * rho[sl];
    const float* S_b = st.S + ((size_t)r * m + sl) * d;
    const float* Y_b = st.Y + ((size_t)r * m + sl) * d;
    float bb = 0.0f;
    for (int i = lane; i < d; i += 32) bb += (Y_b[i] * vr) * p[i];
    const float c = alpha[b] - warp_sum(bb);
    for (int i = lane; i < d; i += 32) p[i] += c * (S_b[i] * valid);
  }
  // p = -r where it is a finite descent direction with history, else -g
  float pg = 0.0f;
  bool p_finite = true;
  for (int i = lane; i < d; i += 32) {
    pg += -p[i] * g[i];
    p_finite &= isfinite(p[i]);
  }
  pg = warp_sum(pg);
  const bool ok = __all_sync(kFull, p_finite) && kn > 0 && pg < 0.0f;
  float gtp = 0.0f;
  for (int i = lane; i < d; i += 32) {
    const float pi = ok ? -p[i] : -g[i];
    p[i] = pi;
    gtp += g[i] * pi;
  }
  gtp = warp_sum(gtp);
  if (lane == 0) {
    st.f[r] = good ? ft : f;
    st.k[r] = kn;
    st.gamma[r] = gamma;
    st.gTp[r] = gtp;
    st.t[r] = 1.0f;
    st.n_probe[r] = 0;
    st.n_accept[r] += 1;
    st.done[r] = good ? 0 : 1;  // the stall exit: a concluded step that did not improve
  }
}

}  // namespace

// ws (float32) and iws (int64): the lanes' state, laid out as above, for R
// lanes of d variables and a history of m; idx (n_live,) int64 the live
// lanes, an entry of -1 naming none; f_a (n_live,), g_a (n_live, d) their
// values and gradients at the trial points z_trial (R, d). Returns the
// launch's cudaError_t.
extern "C" int botorch_lbfgs_update(void* ws, void* iws, const void* idx, const void* f_a,
                                    const void* g_a, const void* z_trial, int n_live, int R, int d,
                                    int m, double c1, int max_ls, void* stream) {
  if (n_live <= 0) return 0;
  const size_t Rd = (size_t)R * d, Rm = (size_t)R * m, Rmd = Rm * d;
  float* w = static_cast<float*>(ws);
  long long* iw = static_cast<long long*>(iws);
  State st;
  st.z = w;
  st.g = st.z + Rd;
  st.p = st.g + Rd;
  st.S = st.p + Rd;
  st.Y = st.S + Rmd;
  st.rho = st.Y + Rmd;
  st.alpha = st.rho + Rm;
  st.f = st.alpha + Rm;
  st.gamma = st.f + R;
  st.gTp = st.gamma + R;
  st.t = st.gTp + R;
  st.k = iw;
  st.n_probe = st.k + R;
  st.n_accept = st.n_probe + R;
  st.done = st.n_accept + R;
  const int blocks = (n_live + kLanesPerBlock - 1) / kLanesPerBlock;
  lbfgs_update_kernel<<<blocks, kLanesPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      st, static_cast<const long long*>(idx), static_cast<const float*>(f_a),
      static_cast<const float*>(g_a), static_cast<const float*>(z_trial), n_live, d, m, (float)c1,
      (long long)max_ls);
  return (int)cudaGetLastError();
}
