// The cross-block sum of one launch, shared by matern.cu's backward and
// matern_bwd2.cu (with the host's raise of a kernel's shared-memory limit):
// every block writes its partial sums to scratch, and the
// last block to arrive adds them up in a fixed order. No floating-point
// atomics, so repeated calls are bit-identical.
//
// The arrival count lives in a small buffer of device memory that the caller
// keeps per (device, stream) and zeroes once; the last block resets it to 0,
// so it is 0 again when the next launch on that stream starts.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <set>
#include <utility>

namespace {

// Let `kernel` take `bytes` of dynamic shared memory (above the default 48
// KB), once per kernel and device. Returns a cudaError_t.
int allow_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  const std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, dev})) return 0;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == 0) done.insert({kernel, dev});
  return err;
}

// Whether this block is the last of `arrivals` (by default every block of
// its grid) to arrive at `counter`. The
// block's threads meet at a barrier, then one fence (cumulative over the
// writes the barrier ordered before it, as a grid-wide sync has it) comes
// before the count, so the last block sees every other block's partials
// (read them with __ldcg: L1 is not coherent across SMs). The last block
// resets the counter. A block-wide call: every thread must reach it.
__device__ __forceinline__ bool arrive_last(unsigned int* counter, unsigned int arrivals) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // release: the block's partials before the count
    last = atomicAdd(counter, 1u) == arrivals - 1;
    if (last) {
      *counter = 0;     // every block has arrived: ready for the next launch
      __threadfence();  // acquire, before the partials are read
    }
  }
  __syncthreads();
  return last;
}

__device__ __forceinline__ bool arrive_last(unsigned int* counter) {
  return arrive_last(counter, gridDim.x * gridDim.y * gridDim.z);
}

// out(o, sum over e < count of term(o, e)) for every o < n_out, in a fixed
// order whatever the timing: a group of gs lanes per output (a power of two,
// as many as the block can give each output in one pass, at most 32 and at
// most count), lane g of the group adding e = g, g + gs, ... in turn (eight
// loads in flight at a time), then the group's lanes added by a butterfly.
// A block-wide call: every thread must reach it.
template <typename Term, typename Out>
__device__ __forceinline__ void reduce_outputs(long long n_out, long long count, Term term,
                                               Out out) {
  int gs = 32;
  while (gs > 1 && ((long long)gs * n_out > blockDim.x || gs > count)) gs >>= 1;
  const int g = threadIdx.x & (gs - 1);
  const int per_pass = blockDim.x / gs;
  for (long long o0 = 0; o0 < n_out; o0 += per_pass) {
    const long long o = o0 + threadIdx.x / gs;
    float s = 0.0f;
    if (o < n_out) {
      // the last pass's loads are masked, not a serial tail: a tail of k
      // loads would cost k round trips to L2 instead of one
      for (long long e = g; e < count; e += 8LL * gs) {
        float a[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const long long eu = e + u * (long long)gs;
          a[u] = eu < count ? term(o, eu) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) s += a[u];
      }
    }
    for (int m = gs >> 1; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (g == 0 && o < n_out) out(o, s);
  }
}

}  // namespace
