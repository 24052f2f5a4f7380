// Batched linear-gap Smith-Waterman scores on Hopper (sm_90a).
//
// Replaces the two TPU kernels of the JAX package's main path, which share
// one contract:
//   mini_parallel_tpu/ops/sw_pallas.py:106  _sw_kernel_body (sw_score_batch_pallas)
//   mini_parallel_tpu/ops/sw_pallas.py:317  _sw_chain_kernel_factory (sw_score_batch_chained)
// The chained TPU layout existed only to recover the TPU wavefront's ramp
// waste; it has no counterpart here.
//
// Contract: a (B, M) uint8 padded with PAD_A, b (B, N) uint8 padded with
// PAD_B, row-major and contiguous -> out (B,) int32 with
//   out[p] = max(0, max_{i,j} H[i,j]),
//   H[i,j] = max(0, H[i-1,j-1] + s(a_i, b_j), H[i-1,j] - 2, H[i,j-1] - 2),
//   s = +2 on equal bytes, -1 otherwise; H[-1,*] = H[*,-1] = 0.
// The whole padded matrix is swept: pads mismatch everything, so they can
// only lower H and never raise the maximum.
//
// What bounds it on this card: integer operations, not bytes. A 150 bp
// pair moves about 300 B (its two rows in, 4 B out) for about 22.5k cells,
// and each cell costs a handful of int32 ops. So the design spends nothing
// on memory tricks and everything on keeping the integer pipes busy:
//   * one warp per pair (10,000 pairs per chunk fill the card's 132 SMs;
//     one thread per pair would leave ~76 threads per SM, latency-bound);
//   * lane l owns a band of R consecutive rows of the pair and keeps its
//     R bases of a and R DP values in registers; the wavefront is staggered
//     by lane: at step t lane l computes column j = t - l of its band, and
//     hands its band's bottom value to lane l+1 with __shfl_up_sync;
//   * b enters through lane 0 (32 bytes loaded per 32 steps, broadcast
//     with __shfl_sync) and travels down the lanes with the wavefront;
//   * state is int32 and exact; it is kept as G = H - 2, so the one
//     subtraction per cell serves both the cell below (up) and the cell to
//     the right (left), and the cell update is a single DPX instruction,
//     __vimax3_s32_relu(diag + s + 2, G_up, G_left);
//   * rows beyond 32*R (M > 256) are swept in stripes of 32*R rows; the
//     stripe's bottom row (N values per pair) goes to a scratch row in
//     device memory that the caller allocates, and is the next stripe's top.
// Simple first: no 16-bit packing (__vimax3_s16x2_relu), no tensor cores.

#include "warp_pair.cuh"

namespace {

using namespace warp_pair;

constexpr int kGap = -2;
// diagonal term in G form: H_diag + s = G_diag + (s - kGap)
constexpr int kDiagMatch = 2 - kGap;
constexpr int kDiagMismatch = -1 - kGap;
constexpr int kGZero = 0 + kGap;  // G of a cell with H = 0

template <int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sw_score_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                int32_t* __restrict__ out, int32_t* bound, long long B, int M,
                int N) {
  const int lane = threadIdx.x & 31;
  const long long pair =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= B) return;  // the same for every lane of the warp
  const uint8_t* a_row = a + pair * M;
  const uint8_t* b_row = b + pair * N;
  int32_t* bound_row = bound ? bound + pair * N : nullptr;
  const int stripe_rows = 32 * R;
  const int n_stripes = (M + stripe_rows - 1) / stripe_rows;
  int best = 0;

  for (int stripe = 0; stripe < n_stripes; ++stripe) {
    int ai[R];
    int g[R];  // G of this lane's rows at its previous column
    const int row0 = stripe * stripe_rows + lane * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ai[r] = row0 + r < M ? (int)a_row[row0 + r] : kNoA;
      g[r] = kGZero;
    }
    const bool top = stripe == 0;
    const bool write_bound = stripe + 1 < n_stripes;
    int bj = kNoB;         // b at this lane's current column
    int b_chunk = kNoB;    // b[t0 + lane] for the current 32-step chunk
    int g_up_prev = kGZero;  // G above the band, previous column
    int g_last = kGZero;     // G of the band's bottom row, previous column

    for (int t = 0; t < N + 31; ++t) {
      if ((t & 31) == 0) {
        const int j = t + lane;
        b_chunk = j < N ? (int)b_row[j] : kNoB;
      }
      const int b_new = __shfl_sync(kFullMask, b_chunk, t & 31);
      const int b_up = __shfl_up_sync(kFullMask, bj, 1);
      int g_up = __shfl_up_sync(kFullMask, g_last, 1);
      if (lane == 0) {
        bj = b_new;
        g_up = (top || t >= N) ? kGZero : bound_row[t];
      } else {
        bj = b_up;
      }
      int g_diag = g_up_prev;
      g_up_prev = g_up;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int h = __vimax3_s32_relu(
            g_diag + (ai[r] == bj ? kDiagMatch : kDiagMismatch), g_up, g[r]);
        best = max(best, h);
        g_diag = g[r];
        g_up = h + kGap;
        g[r] = g_up;
      }
      g_last = g[R - 1];
      if (write_bound && lane == 31 && t >= 31) {
        bound_row[t - 31] = g_last;  // column t - 31 < N
      }
    }
    __syncwarp();  // the bottom row is visible to lane 0 in the next stripe
  }
  best = __reduce_max_sync(kFullMask, best);
  if (lane == 0) out[pair] = best;
}

}  // namespace

extern "C" {

// int32 values of scratch each pair needs: N when M spans more than one
// stripe, else 0 (then `scratch` may be null).
int sw_score_scratch_per_pair(int M, int N) { return striped(M) ? N : 0; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int sw_score_launch(const void* a, const void* b, void* out, void* scratch,
                    long long B, int M, int N, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (sw_score_scratch_per_pair(M, N) && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  int32_t* po = static_cast<int32_t*>(out);
  int32_t* ps = static_cast<int32_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch_rows(M, [&](auto rows) {
    sw_score_kernel<decltype(rows)::value>
        <<<blocks_for(B), 32 * kWarpsPerBlock, 0, s>>>(pa, pb, po, ps, B, M,
                                                       N);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
