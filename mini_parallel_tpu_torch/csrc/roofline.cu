// The int32 add+max dependency chain on Hopper (sm_90a): the ceiling that
// the integer DP kernels' "share of peak" is held against.
//
// Replaces the TPU kernel
//   mini_parallel_tpu/tools/roofline.py:72  measure_peak_chain's kernel
//   (the pl.pallas_call at roofline.py:83)
//
// Contract: a, b (n,) int32, contiguous -> y (n,) int32 with
//   y = a; repeat `chain` times: y = max(y + a, b)
// (int32 wraps on overflow, as torch's and XLA's int32 adds do).
//
// What bounds it: integer operations, by construction. Each element is
// read twice and written once, and costs 2 * chain operations (an add and
// a max a step, counted as the TPU tool counts them); at chain = 2048 that
// is about 340 operations per byte. The step is the DPX instruction the SW
// kernels' cells use, __viaddmax_s32(y, a, b) = max(y + a, b), so the chain
// measures the rate those kernels can reach. Each thread carries kIlp
// independent chains, interleaved, so that the pipe is fed while each
// chain waits on its previous step; the serial dependency keeps the
// compiler from collapsing a chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 4;  // independent chains per thread

__global__ void __launch_bounds__(kThreads)
chain_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
             int32_t* __restrict__ y, long long n, int chain) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  int av[kIlp], bv[kIlp], yv[kIlp];
#pragma unroll
  for (int k = 0; k < kIlp; ++k) {
    const long long i = i0 + k * stride;
    av[k] = i < n ? a[i] : 0;
    bv[k] = i < n ? b[i] : 0;
    yv[k] = av[k];
  }
#pragma unroll 8
  for (int s = 0; s < chain; ++s) {
#pragma unroll
    for (int k = 0; k < kIlp; ++k) yv[k] = __viaddmax_s32(yv[k], av[k], bv[k]);
  }
#pragma unroll
  for (int k = 0; k < kIlp; ++k) {
    const long long i = i0 + k * stride;
    if (i < n) y[i] = yv[k];
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int roofline_chain_launch(const void* a, const void* b, void* y, long long n,
                          int chain, void* stream) {
  if (n <= 0 || chain < 0) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kThreads * kIlp;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  chain_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(y), n, chain);
  return (int)cudaGetLastError();
}

}  // extern "C"
