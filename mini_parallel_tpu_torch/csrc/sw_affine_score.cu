// Batched affine-gap (Gotoh) Smith-Waterman scores on Hopper (sm_90a).
//
// Replaces the two affine TPU kernels of the JAX package, which share one
// contract:
//   mini_parallel_tpu/ops/sw_pallas.py:585  _sw_affine_kernel_factory
//                                           (sw_affine_batch_pallas, :740)
//   mini_parallel_tpu/ops/sw_pallas.py:637  _sw_affine_chain_kernel_factory
//                                           (sw_affine_batch_chained, :717)
// As for the linear kernel (sw_score.cu), the chained TPU layout only
// recovered the TPU wavefront's ramp waste and has no counterpart here.
//
// Contract: a (B, M) uint8 padded with PAD_A, b (B, N) uint8 padded with
// PAD_B, row-major and contiguous; gap_open (go) and gap_extend (ge) are
// runtime arguments, both <= 0. out (B,) int32 with out[p] = max H, where
//   E[i,j] = max(E[i,j-1], H[i,j-1] + go) + ge    (gap along j)
//   F[i,j] = max(F[i-1,j], H[i-1,j] + go) + ge    (gap along i)
//   H[i,j] = max(0, H[i-1,j-1] + s(a_i, b_j), E[i,j], F[i,j]),
//   s = +2 on equal bytes, -1 otherwise; H = 0 and E = F = NEG outside.
// A gap of length L costs go + L * ge. The whole padded matrix is swept:
// pads mismatch everything and gaps only cost, so they never raise the max.
//
// What bounds it on this card: integer operations, not bytes. A 150 bp
// pair moves about 300 B for about 22.5k cells of some nine int32 ops
// each. The design keeps the integer pipes busy and all state in registers:
//   * one warp per pair, as in sw_score.cu: lane l owns a band of R rows
//     and computes column j = t - l of its band at step t;
//   * E runs along a row, so each row's E stays in the lane's registers;
//   * F runs down a column: it travels down the band and crosses to lane
//     l+1 with H by __shfl_up_sync; lane 0's top boundary is H = 0,
//     F = NEG;
//   * each cell is two __viaddmax_s32 (the gap states) and one
//     __vimax3_s32_relu (H), Hopper's DPX instructions;
//   * state is int32 and exact: |H| <= 2 * min(M, N). The TPU kernel kept
//     f32 state behind a 2^24 guard; int32 needs no guard. NEG = -2^24
//     only ever meets H + go with H >= 0, so it never accumulates;
//   * rows beyond 32 * R run in stripes; the stripe's bottom row carries
//     BOTH H and F (2N values per pair) through a scratch row in device
//     memory that the caller allocates; E restarts at the left edge.
// Simple first: no 16-bit packing, no tensor cores.

#include "warp_pair.cuh"

namespace {

using namespace warp_pair;

constexpr int kMatch = 2;
constexpr int kMismatch = -1;
constexpr int kNeg = -(1 << 24);

template <int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sw_affine_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                 int32_t* __restrict__ out, int32_t* bound, long long B,
                 int M, int N, int go, int ge) {
  const int lane = threadIdx.x & 31;
  const long long pair =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= B) return;  // the same for every lane of the warp
  const uint8_t* a_row = a + pair * M;
  const uint8_t* b_row = b + pair * N;
  // the stripe's bottom row: N values of H, then N values of F
  int32_t* bound_h = bound ? bound + pair * 2 * N : nullptr;
  int32_t* bound_f = bound ? bound_h + N : nullptr;
  const int stripe_rows = 32 * R;
  const int n_stripes = (M + stripe_rows - 1) / stripe_rows;
  int best = 0;

  for (int stripe = 0; stripe < n_stripes; ++stripe) {
    int ai[R];
    int h[R];  // H of this lane's rows at its previous column
    int e[R];  // E of this lane's rows at its previous column
    const int row0 = stripe * stripe_rows + lane * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ai[r] = row0 + r < M ? (int)a_row[row0 + r] : kNoA;
      h[r] = 0;
      e[r] = kNeg;
    }
    const bool top = stripe == 0;
    const bool write_bound = stripe + 1 < n_stripes;
    int bj = kNoB;        // b at this lane's current column
    int b_chunk = kNoB;   // b[t0 + lane] for the current 32-step chunk
    int h_up_prev = 0;    // H above the band, previous column
    int h_last = 0;       // H of the band's bottom row, previous column
    int f_last = kNeg;    // F of the band's bottom row, previous column

    for (int t = 0; t < N + 31; ++t) {
      if ((t & 31) == 0) {
        const int j = t + lane;
        b_chunk = j < N ? (int)b_row[j] : kNoB;
      }
      const int b_new = __shfl_sync(kFullMask, b_chunk, t & 31);
      const int b_up = __shfl_up_sync(kFullMask, bj, 1);
      int h_up = __shfl_up_sync(kFullMask, h_last, 1);
      int f_up = __shfl_up_sync(kFullMask, f_last, 1);
      if (lane == 0) {
        bj = b_new;
        if (top || t >= N) {
          h_up = 0;
          f_up = kNeg;
        } else {
          h_up = bound_h[t];
          f_up = bound_f[t];
        }
      } else {
        bj = b_up;
      }
      int h_diag = h_up_prev;
      h_up_prev = h_up;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e_new = __viaddmax_s32(h[r], go, e[r]) + ge;
        const int f_new = __viaddmax_s32(h_up, go, f_up) + ge;
        const int s = ai[r] == bj ? kMatch : kMismatch;
        const int h_new = __vimax3_s32_relu(h_diag + s, e_new, f_new);
        best = max(best, h_new);
        h_diag = h[r];
        h[r] = h_new;
        e[r] = e_new;
        h_up = h_new;
        f_up = f_new;
      }
      h_last = h_up;
      f_last = f_up;
      if (write_bound && lane == 31 && t >= 31) {
        bound_h[t - 31] = h_last;  // column t - 31 < N
        bound_f[t - 31] = f_last;
      }
    }
    __syncwarp();  // the bottom row is visible to lane 0 in the next stripe
  }
  best = __reduce_max_sync(kFullMask, best);
  if (lane == 0) out[pair] = best;
}

}  // namespace

extern "C" {

// int32 values of scratch each pair needs: 2N (H and F of a stripe's
// bottom row) when M spans more than one stripe, else 0 (then `scratch`
// may be null).
int sw_affine_score_scratch_per_pair(int M, int N) {
  return striped(M) ? 2 * N : 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int sw_affine_score_launch(const void* a, const void* b, void* out,
                           void* scratch, long long B, int M, int N,
                           int gap_open, int gap_extend, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (gap_open > 0 || gap_extend > 0) return (int)cudaErrorInvalidValue;
  if (sw_affine_score_scratch_per_pair(M, N) && scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  int32_t* po = static_cast<int32_t*>(out);
  int32_t* ps = static_cast<int32_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dispatch_rows(M, [&](auto rows) {
    sw_affine_kernel<decltype(rows)::value>
        <<<blocks_for(B), 32 * kWarpsPerBlock, 0, s>>>(
            pa, pb, po, ps, B, M, N, gap_open, gap_extend);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
